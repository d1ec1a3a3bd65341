"""Kernels and their plain PyTorch versions."""

from __future__ import annotations

import contextlib
import threading

import torch

_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = (False, True)


@contextlib.contextmanager
def full_f32():
    """Run the f32 matmuls and cuDNN convolutions and RNNs issued inside in
    full f32 (TF32 off), restoring the previous settings when the last
    holder leaves. The f32 paths (the mel projection, f32 models, Silero,
    the resampler) must match the reference's f32 arithmetic, and TF32
    keeps only about 3 decimal digits. The settings are process-wide, so
    holders are counted: a server's threads may hold it at once, and while
    one does, every thread's f32 work runs in full f32. No effect on the
    CPU."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _f32_saved
