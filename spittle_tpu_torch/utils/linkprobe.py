"""Host->device link-speed probe: the bench covariate.

Port of spittle_tpu/utils/linkprobe.py: the same buffer, a batch-48 x
30 s int16 window batch (~46 MB, the exact tensor the serving path ships
per group), copied from pinned host memory to the card. A lower headline
with a slower link is the link, not a regression, so a benchmark record
can carry the measured h2d MB/s beside its numbers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from spittle_tpu_torch.device import resolve_device


def measure_link_mbps(size_mb: float = 46.0, reps: int = 3,
                      device="cuda") -> float:
    """Median h2d bandwidth (MB/s) for one serving-group-sized transfer:
    each timed copy is the pinned host tensor `.to(device)`, then a
    synchronize, after one warm copy. On device="cpu" the host tensor is
    not pinned and the copy is a clone (a check of the probe, not a
    link). Raises without a card unless device is "cpu"."""
    dev = resolve_device(device)
    n = int(size_mb * 1e6 / 2)  # int16 elements
    rng = np.random.default_rng(0)
    buf = (rng.standard_normal(n) * 3000).astype(np.int16)
    mb = buf.nbytes / 1e6
    host = torch.from_numpy(buf)
    if dev.type == "cuda":
        host = host.pin_memory()

    def copy():
        out = host.to(dev, copy=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    copy()  # warm path / page-in
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        copy()
        ts.append(time.perf_counter() - t0)
    return round(mb / float(np.median(ts)), 1)
