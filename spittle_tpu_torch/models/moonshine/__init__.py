"""Moonshine encoder-decoder in PyTorch."""
