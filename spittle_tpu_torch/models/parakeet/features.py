"""Parakeet/NeMo-style audio features in PyTorch (port of
spittle_tpu/models/parakeet/features.py).

NeMo AudioToMelSpectrogramPreprocessor semantics: a 25 ms periodic Hann
window (400 samples, zero-padded to a 512-point FFT), 10 ms hop, frames
centred with a reflect pad of n_fft // 2 and only T // hop of them (the
last frame torch.stft(center=True) returns is dropped, as the reference's
framing never makes it), the Slaney mel filterbank, log with a 2^-24 zero
guard, and per-feature mean / population-std normalization over the
utterance. The mel projection runs in full f32 (ops.full_f32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spittle_tpu_torch.audio.mel import mel_filterbank
from spittle_tpu_torch.ops import full_f32

N_FFT = 512
WIN_LENGTH = 400
HOP = 160
LOG_GUARD = 2.0**-24


@functools.lru_cache(maxsize=None)
def _window() -> np.ndarray:
    # Periodic Hann over win_length, zero-padded symmetrically to n_fft.
    n = np.arange(WIN_LENGTH)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / WIN_LENGTH))
    pad = (N_FFT - WIN_LENGTH) // 2
    return np.pad(win, (pad, pad)).astype(np.float32)


def parakeet_features(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, T] 16 kHz PCM -> [B, n_mels, T // HOP] normalized log-mel, f32,
    on the audio's device."""
    audio = audio.to(torch.float32)
    dev = audio.device
    spec = torch.stft(
        audio, n_fft=N_FFT, hop_length=HOP,
        window=torch.from_numpy(_window()).to(dev), center=True,
        pad_mode="reflect", return_complex=True,
    )[..., : audio.shape[-1] // HOP]  # [B, bins, F]
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(n_mels, N_FFT)).to(dev)
    with full_f32():
        mel = torch.matmul(fb, power)  # [B, n_mels, F]
    logmel = torch.log(mel + LOG_GUARD)
    mean = logmel.mean(dim=-1, keepdim=True)
    std = logmel.std(dim=-1, keepdim=True, correction=0) + 1e-5
    return (logmel - mean) / std
