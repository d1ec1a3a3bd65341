"""Polyphase resampling as one strided convolution + streaming frame
emission (port of spittle_tpu/audio/resample.py).

Any input rate -> 16 kHz. Rational L/M resampling is a strided read of
input blocks against a per-phase windowed-sinc filter bank: one `F.conv1d`
with an [L, 1, F] weight at stride M, on the input tensor's device, batched
over any leading dimensions. The kaiser-windowed design matches
scipy.signal.resample_poly's default.

`FrameResampler` is the host-side (numpy) streaming form: one microphone at
30 ms granularity, bit-identical to `resample()` of the concatenated input.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spittle_tpu_torch.ops import full_f32

TARGET_SAMPLE_RATE = 16_000
FRAME_SAMPLES = 480  # 30 ms at 16 kHz
CHUNK_IN = 1024  # streaming input chunk


@functools.lru_cache(maxsize=None)
def _design(in_hz: int, out_hz: int) -> Tuple[int, int, np.ndarray, int]:
    """Kaiser-windowed sinc low-pass for rational L/M resampling.

    Returns (L, M, h, half) with h scaled by L, identical to
    scipy.signal.resample_poly's default filter (window=('kaiser', 5.0),
    half_len = 10 * max(L, M)).
    """
    g = math.gcd(in_hz, out_hz)
    L, M = out_hz // g, in_hz // g
    max_rate = max(L, M)
    half = 10 * max_rate
    numtaps = 2 * half + 1
    # firwin(numtaps, 1/max_rate, window=('kaiser', 5.0)) without scipy:
    n = np.arange(numtaps) - half
    fc = 1.0 / max_rate  # cutoff as fraction of Nyquist
    sinc = np.sinc(n * fc) * fc
    beta = 5.0
    x = n / half
    win = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta)
    h = sinc * win
    h /= h.sum()  # unity DC gain
    return L, M, (h * L).astype(np.float64), half


@functools.lru_cache(maxsize=None)
def _block_plan(in_hz: int, out_hz: int) -> Tuple[int, int, int, int, np.ndarray]:
    """Precompute the strided-read + filter-bank plan.

    Output j consumes input samples i0(j)..i0(j)+K-1 where
    i0(j) = ceil((j*M - half)/L). Splitting j = b*L + p, i0 = b*M + d(p), so
    every block of L consecutive outputs reads a fixed-length window of the
    input at stride M. The per-phase taps embed into one [F, L] matrix so a
    whole block is one product.
    """
    L, M, h, half = _design(in_hz, out_hz)
    K = (2 * half) // L + 1  # taps contributing per output sample
    p = np.arange(L)
    d = np.ceil((p * M - half) / L).astype(np.int64)  # per-phase input offset
    dmin = int(d.min())
    F_ = int((d.max() + K) - dmin)  # window length per block
    # weights[f, p] = h[p*M + half - (dmin + f)*L] within tap range else 0
    f = np.arange(F_)
    tap = p[None, :] * M + half - (dmin + f[:, None]) * L
    valid = (tap >= 0) & (tap < len(h))
    weights = np.where(valid, h[np.clip(tap, 0, len(h) - 1)], 0.0)
    return L, M, dmin, F_, weights.astype(np.float32)


def resampled_length(n: int, in_hz: int, out_hz: int) -> int:
    g = math.gcd(in_hz, out_hz)
    L, M = out_hz // g, in_hz // g
    return -(-n * L // M)  # ceil


def resample(x: torch.Tensor, in_hz: int,
             out_hz: int = TARGET_SAMPLE_RATE) -> torch.Tensor:
    """Band-limited rational resampling of [..., T] PCM on x's device; zero
    end extension. Numerically matches scipy.signal.resample_poly(x, L, M)
    with its default kaiser design. Identity when the rates are equal.

    Every output block of L samples is one correlation of an F-long input
    window (stride M) with the [L, 1, F] filter bank: one strided conv,
    run in full f32 (TF32 off)."""
    if in_hz == out_hz:
        return x
    L, M, dmin, F_, weights = _block_plan(in_hz, out_hz)
    n_in = x.shape[-1]
    out_len = resampled_length(n_in, in_hz, out_hz)
    num_blocks = -(-out_len // L)
    # Zero-extension semantics (scipy 'constant' padding).
    left = max(0, -dmin)
    right = max(0, (num_blocks - 1) * M + dmin + F_ - n_in + left)
    lead_shape = x.shape[:-1]
    xp = F.pad(x.to(torch.float32).reshape(-1, 1, n_in), (left, right))
    kernel = torch.from_numpy(np.ascontiguousarray(weights.T)[:, None, :]).to(
        x.device)  # [L, 1, F]
    with full_f32():
        out = F.conv1d(xp, kernel, stride=M)  # [N, L, num_blocks']
    out = out[:, :, :num_blocks]
    out = out.transpose(1, 2).reshape(*lead_shape, num_blocks * L)
    return out[..., :out_len]


@functools.lru_cache(maxsize=None)
def _phase_plan(in_hz: int, out_hz: int):
    """Per-output-phase taps for streaming: output j = b*L + p reads input
    window [b*M + d[p], b*M + d[p] + K) against filter row Hp[p]."""
    L, M, h, half = _design(in_hz, out_hz)
    K = (2 * half) // L + 1
    p = np.arange(L)
    d = np.ceil((p * M - half) / L).astype(np.int64)
    k = np.arange(K)
    tap = p[:, None] * M + half - (d[:, None] + k[None, :]) * L
    valid = (tap >= 0) & (tap < len(h))
    hp = np.where(valid, h[np.clip(tap, 0, len(h) - 1)], 0.0).astype(np.float32)
    return L, M, d, K, hp


class FrameResampler:
    """Streaming resample-to-16kHz + exact 30 ms frame emission.

    `push(samples, emit)` / `finish(emit)` with FRAME_SAMPLES-sample frames
    and a zero-padded trailing frame. Polyphase filter state is kept across
    pushes, so the streamed output is the offline `resample()` of the
    concatenated input (no chunk-boundary artifacts or phase drift).
    Host-side numpy: one microphone at 30 ms granularity; batch and
    offline paths use `resample()` on the device.
    """

    def __init__(
        self,
        in_hz: int,
        out_hz: int = TARGET_SAMPLE_RATE,
        frame_samples: int = FRAME_SAMPLES,
    ):
        self.in_hz = in_hz
        self.out_hz = out_hz
        self.frame_samples = frame_samples
        self._identity = in_hz == out_hz
        if not self._identity:
            self._L, self._M, self._d, self._K, self._hp = _phase_plan(in_hz, out_hz)
            self._pad0 = int(max(0, -self._d.min()))
            # Buffer holds input from absolute index `-pad0` (virtual zeros
            # before the stream start keep early filter windows in range).
            self._buf = np.zeros(self._pad0, dtype=np.float32)
            self._buf_base = -self._pad0
            self._received = 0
            self._next_out = 0
        self._pending = np.zeros(0, dtype=np.float32)

    def _ready_outputs(self, total_in: int) -> np.ndarray:
        """Emit all outputs whose filter window lies inside [.., total_in)."""
        L, M, d, K = self._L, self._M, self._d, self._K
        if total_in <= 0:
            return np.zeros(0, dtype=np.float32)
        j_cand_hi = ((total_in - K - int(d.min())) * L) // M + L + 1
        if j_cand_hi <= self._next_out:
            return np.zeros(0, dtype=np.float32)
        js = np.arange(self._next_out, j_cand_hi)
        starts = (js // L) * M + d[js % L]
        js = js[starts + K <= total_in]
        if len(js) == 0:
            return np.zeros(0, dtype=np.float32)
        starts = (js // L) * M + d[js % L] - self._buf_base
        idx = starts[:, None] + np.arange(K)[None, :]
        y = np.einsum("jk,jk->j", self._buf[idx], self._hp[js % L])
        self._next_out = int(js[-1]) + 1
        # Drop input no longer reachable by any future window.
        min_start = (self._next_out // L) * M + int(d.min()) - self._buf_base
        if min_start > 0:
            self._buf = self._buf[min_start:]
            self._buf_base += min_start
        return y.astype(np.float32)

    def push(self, src: np.ndarray, emit: Callable[[np.ndarray], None]) -> None:
        src = np.asarray(src, dtype=np.float32)
        if self._identity:
            self._emit_frames(src, emit)
            return
        self._buf = np.concatenate([self._buf, src])
        self._received += len(src)
        self._emit_frames(self._ready_outputs(self._received), emit)

    def finish(self, emit: Callable[[np.ndarray], None]) -> None:
        if not self._identity:
            out_len = resampled_length(self._received, self.in_hz, self.out_hz)
            if self._next_out < out_len:
                # Zero-extend so every remaining window is computable, then
                # keep only the outputs the true input length defines.
                tail = self._K + self._M
                self._buf = np.concatenate(
                    [self._buf, np.zeros(tail, dtype=np.float32)]
                )
                y = self._ready_outputs(self._received + tail)
                self._emit_frames(y[: out_len - (self._next_out - len(y))], emit)
        if len(self._pending):
            frame = np.pad(self._pending, (0, self.frame_samples - len(self._pending)))
            emit(frame)
            self._pending = np.zeros(0, dtype=np.float32)

    def _emit_frames(
        self, data: np.ndarray, emit: Callable[[np.ndarray], None]
    ) -> None:
        if len(self._pending):
            data = np.concatenate([self._pending, data])
        n_full = len(data) // self.frame_samples
        for i in range(n_full):
            emit(data[i * self.frame_samples : (i + 1) * self.frame_samples])
        self._pending = data[n_full * self.frame_samples :]
