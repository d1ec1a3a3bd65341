"""Transcription engines."""
