"""Mic-level spectrum visualizer (port of spittle_tpu/audio/visualizer.py).

Behavior-parity port of `src-tauri/src/audio_toolkit/audio/
visualizer.rs`: 512-pt Hann-windowed power spectrum bucketed into 16
log-spaced bands over 400-4000 Hz, dB-mapped (-55..-8 dB) with gain 1.3 and
curve 0.7, slow adaptive noise floor, neighbor smoothing. Feeds the
`mic-level` UI event stream. Host-side numpy (one FFT per 512 samples is
not a device problem)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

DB_MIN = -55.0
DB_MAX = -8.0
GAIN = 1.3
CURVE_POWER = 0.7
NOISE_ALPHA = 0.001


class AudioVisualizer:
    def __init__(
        self,
        sample_rate: int = 16000,
        window_size: int = 512,
        buckets: int = 16,
        freq_min: float = 400.0,
        freq_max: float = 4000.0,
    ):
        self.window_size = window_size
        self.buckets = buckets
        n = np.arange(window_size)
        self.window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / window_size))
        nyquist = sample_rate / 2.0
        freq_min = min(freq_min, nyquist)
        freq_max = min(freq_max, nyquist)

        self.bucket_ranges = []
        for b in range(buckets):
            log_start = (b / buckets) ** 2
            log_end = ((b + 1) / buckets) ** 2
            start_hz = freq_min + (freq_max - freq_min) * log_start
            end_hz = freq_min + (freq_max - freq_min) * log_end
            start_bin = int(start_hz * window_size / sample_rate)
            end_bin = int(end_hz * window_size / sample_rate)
            if end_bin <= start_bin:
                end_bin = start_bin + 1
            self.bucket_ranges.append(
                (min(start_bin, window_size // 2), min(end_bin, window_size // 2))
            )

        self.noise_floor = np.full(buckets, -40.0, np.float64)
        self._buffer = np.zeros(0, np.float32)

    def feed(self, samples: np.ndarray) -> Optional[List[float]]:
        self._buffer = np.concatenate([self._buffer, np.asarray(samples, np.float32)])
        if len(self._buffer) < self.window_size:
            return None
        window_samples = self._buffer[: self.window_size]
        mean = window_samples.mean()
        spec = np.fft.fft((window_samples - mean) * self.window)

        out = [0.0] * self.buckets
        for bi, (start_bin, end_bin) in enumerate(self.bucket_ranges):
            if start_bin >= end_bin or end_bin > self.window_size // 2:
                continue
            mags2 = np.abs(spec[start_bin:end_bin]) ** 2
            avg_power = float(mags2.mean())
            if avg_power > 1e-12:
                db = 20.0 * np.log10(np.sqrt(avg_power) / self.window_size)
            else:
                db = -80.0
            if db < self.noise_floor[bi] + 10.0:
                self.noise_floor[bi] = (
                    NOISE_ALPHA * db + (1.0 - NOISE_ALPHA) * self.noise_floor[bi]
                )
            normalized = float(np.clip((db - DB_MIN) / (DB_MAX - DB_MIN), 0.0, 1.0))
            out[bi] = float(np.clip((normalized * GAIN) ** CURVE_POWER, 0.0, 1.0))

        # In-place sequential smoothing (left neighbor already smoothed),
        # matching the reference loop exactly (visualizer.rs:141-143).
        for i in range(1, self.buckets - 1):
            out[i] = out[i] * 0.7 + out[i - 1] * 0.15 + out[i + 1] * 0.15

        self._buffer = np.zeros(0, np.float32)
        return out

    def reset(self) -> None:
        self._buffer = np.zeros(0, np.float32)
        self.noise_floor.fill(-40.0)
