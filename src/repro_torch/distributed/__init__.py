"""Checkpointing of the port's training state."""
