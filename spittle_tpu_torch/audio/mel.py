"""Whisper log-mel frontend in PyTorch (port of spittle_tpu/audio/mel.py).

Numerics follow OpenAI Whisper's `log_mel_spectrogram`: n_fft=400,
hop=160, periodic Hann, center reflect padding, power spectrum with the
final frame dropped, Slaney-scale/Slaney-normalized mel filterbank, log10
clamped at 1e-10, 8-dB dynamic-range floor, (x+4)/4.

The reference computes the STFT as a factored DFT because XLA's
length-400 rFFT was slow on its chip; here `torch.stft` (cuFFT on the
card) computes the same power spectrum. The mel projection is an f32
matmul that must run in full f32 on the card, so it runs under
`spittle_tpu_torch.ops.full_f32` (TF32 off).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from spittle_tpu_torch.ops import full_f32

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    mels = np.where(
        above,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    freqs = np.where(
        above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int = 80, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [n_mels, n_fft//2+1]
    (librosa.filters.mel(sr, n_fft, n_mels), the filterbank Whisper ships)."""
    fmax = sample_rate / 2
    fftfreqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(
        np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hann(n_fft: int) -> np.ndarray:
    """Periodic Hann window, computed in f64 and stored f32 (as the
    reference builds it)."""
    n = np.arange(n_fft)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)


def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 80,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
    filters: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched Whisper log-mel: [..., T] float PCM -> [..., n_mels, T//hop]
    float32, on the audio's device. filters: the mel filterbank [n_mels,
    n_fft // 2 + 1] to project with (a GGML file's own); by default
    mel_filterbank(n_mels, n_fft)."""
    audio = audio.to(torch.float32)
    lead, t = audio.shape[:-1], audio.shape[-1]
    dev = audio.device
    window = torch.from_numpy(_hann(n_fft)).to(dev)
    spec = torch.stft(
        audio.reshape(-1, t), n_fft=n_fft, hop_length=hop, window=window,
        center=True, pad_mode="reflect", return_complex=True,
    )  # [N, bins, 1 + t // hop]
    spec = spec[..., : t // hop]  # Whisper drops the final frame
    power = spec.real.square() + spec.imag.square()
    if filters is None:
        filters = torch.from_numpy(mel_filterbank(n_mels, n_fft))
    mel_w = filters.to(device=dev, dtype=torch.float32)
    with full_f32():
        mel = torch.matmul(mel_w, power)  # [N, n_mels, F]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    # Dynamic-range floor: per-item max over (mels, frames), minus 8.
    flat_max = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, flat_max - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.reshape(*lead, mel_w.shape[0], -1)


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Pad with zeros or trim to exactly `length` samples on the last axis."""
    t = audio.shape[-1]
    if t > length:
        return audio[..., :length]
    if t < length:
        return torch.nn.functional.pad(audio, (0, length - t))
    return audio
