"""Logging, thread exception barriers and timing spans."""
