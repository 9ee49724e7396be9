"""Synthetic data for the port (numpy; no device work)."""
