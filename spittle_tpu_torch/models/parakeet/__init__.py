"""Parakeet FastConformer-TDT (and CTC) in PyTorch."""
