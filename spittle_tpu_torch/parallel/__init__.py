"""Serving: the batching transcription server and its HTTP front."""
