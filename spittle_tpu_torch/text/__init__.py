"""Text helpers."""
