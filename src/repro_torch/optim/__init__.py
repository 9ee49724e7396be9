"""Optimizers of the LM training step."""
