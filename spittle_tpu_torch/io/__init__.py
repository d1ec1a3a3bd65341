"""Checkpoint file readers shared by the model families."""
