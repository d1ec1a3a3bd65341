"""8-bit mu-law companding for the host->device audio wire (port of
spittle_tpu/audio/mulaw.py).

    encode: y = sign(x) * ln(1 + mu*|x|) / ln(1 + mu),  code = round((y+1)*127.5)
    decode: y = code/127.5 - 1,  x = sign(y) * ((1+mu)^|y| - 1) / mu

Encode runs on the host over numpy (the reference's numpy expression, which
its native encoder is bit-identical to); decode is a few elementwise torch
ops on the device, ahead of the mel frontend, or numpy on the host
(mulaw_decode_np, for the HTTP front's mu-law bodies).
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0


def mulaw_encode(audio: np.ndarray) -> np.ndarray:
    """f32 [-1,1] or int16 PCM -> uint8 mu-law codes."""
    x = np.asarray(audio)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / np.float32(32768.0)
    else:
        x = np.clip(x.astype(np.float32), -1.0, 1.0)
    # Promotions spelled out so the result is identical under numpy 1
    # (value-based casting) and numpy 2 (NEP 50): log1p in f32, then a
    # f64 divide/round — the reference's exact chain.
    num = np.log1p(np.float32(MU) * np.abs(x)).astype(np.float64)
    y = np.sign(x).astype(np.float64) * (num / np.log1p(MU))
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def mulaw_decode_np(codes: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> f32 [-1,1] on the host (the HTTP front's
    mu-law bodies and tests)."""
    y = codes.astype(np.float32) / 127.5 - 1.0
    return np.sign(y) * (np.power(1.0 + MU, np.abs(y)) - 1.0) / MU


def mulaw_decode(codes: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law codes -> f32 [-1,1], on the codes' device."""
    c = codes.to(torch.float32)
    # Divisors are device tensors: CUDA turns division by a Python scalar
    # into a multiply by its reciprocal, which is not the reference's
    # IEEE division.
    y = c / c.new_full((), 127.5) - 1.0
    # (1+mu)^|y| is taken in f64 and rounded once to f32: the correctly
    # rounded power the reference's f32 power yields (a pure-f32 pow
    # lands up to 4 ULP away on some codes).
    p = torch.pow(1.0 + MU, torch.abs(y).to(torch.float64)).to(torch.float32)
    return torch.sign(y) * (p - 1.0) / c.new_full((), MU)
