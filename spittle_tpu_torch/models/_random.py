"""Seeded random weights for the families' `random:<config>` models."""

from __future__ import annotations

import torch


class RandomDraw:
    """Leaves drawn in call order from one torch.Generator on `device`,
    seeded with `seed`: normal leaves are standard normals times `scale`,
    drawn in f32 and cast to `dtype`. On the card the draw of a 0.6B-weight
    model takes well under a second (numpy's generator, which the Whisper
    port's random_params uses, takes about 20 ns a value on the host). The
    same seed gives the same leaves on one device type, other leaves on
    another."""

    def __init__(self, seed: int, device="cpu", dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, scale: float, dtype=None) -> torch.Tensor:
        a = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return a.mul_(scale).to(dtype or self.dtype)

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=torch.float32,
                          device=self.device)
