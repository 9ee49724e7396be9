"""Batch staging for padded dispatches (bucket shapes, padding repair)."""
