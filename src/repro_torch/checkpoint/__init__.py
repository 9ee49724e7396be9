"""Checkpoints of the LM training state."""
