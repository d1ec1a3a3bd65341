"""Whisper in PyTorch (port of spittle_tpu/models/whisper)."""
