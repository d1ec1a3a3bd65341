"""Kernels and their plain PyTorch versions."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run the f32 matmuls and cuDNN convolutions issued inside in full f32
    (TF32 off), restoring the previous settings on exit. The f32 paths (the
    mel projection, f32 models) must match the reference's f32 arithmetic,
    and TF32 keeps only about 3 decimal digits. No effect on the CPU."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
