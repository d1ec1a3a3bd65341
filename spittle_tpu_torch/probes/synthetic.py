"""Seeded synthetic speech for the probes and chip_smoke.py: voiced
bursts that Silero takes for speech, in low noise, made on any device."""

from __future__ import annotations

import numpy as np
import torch


def speech_bursts(seconds: float, sr: int, seed: int, dev):
    """Seeded synthetic speech on `dev`: voiced bursts of 1-8 s (a gliding
    pitch of 90-230 Hz, its harmonics shaped by three moving formants,
    3-5 syllables a second) 0.6-5 s apart in low noise. Returns (f32 audio
    [seconds * sr], [(start, end)] samples of the bursts)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    audio = 0.003 * torch.randn(n, generator=gen, device=dev)
    bursts = []
    pos = int(rng.uniform(0.5, 3.0) * sr)
    while True:
        dur = int(rng.uniform(1.0, 8.0) * sr)
        if pos + dur > n:
            return audio, bursts
        bursts.append((pos, pos + dur))
        t = torch.arange(dur, device=dev, dtype=torch.float64) / sr
        f0 = rng.uniform(90.0, 230.0)
        inst = f0 * (1.0 + 0.08 * torch.sin(
            2 * np.pi * rng.uniform(0.3, 1.2) * t + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * torch.cumsum(inst, 0) / sr
        syl = rng.uniform(3.0, 5.0)
        k = torch.arange(1, int(5000 // f0) + 1, device=dev, dtype=torch.float64)
        f = k[:, None] * inst[None, :]
        amp = 0
        for (lo, hi), bw, g in zip(((300, 900), (900, 2200), (2200, 3200)),
                                   (80, 100, 140), (1.0, 0.6, 0.3)):
            F = lo + (hi - lo) * (0.5 + 0.5 * torch.sin(
                np.pi * syl * t + rng.uniform(0, 6.3)))
            amp = amp + g * F * F / torch.sqrt((F * F - f * f) ** 2 + (bw * f) ** 2)
        sig = (amp * torch.sin(k[:, None] * phase[None, :])).sum(0)
        sig = sig * torch.clamp(torch.sin(2 * np.pi * syl * t), min=0.0) ** 0.5
        sig = sig * torch.clamp(torch.minimum(t, t[-1] - t) / 0.02, max=1.0)
        audio[pos:pos + dur] += (0.3 * sig / sig.abs().max()).to(torch.float32)
        pos += dur + int(rng.uniform(0.6, 5.0) * sr)
