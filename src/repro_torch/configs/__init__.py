"""Model and input-shape configurations of the port's LM path."""
