"""Probe: where a train step's device time goes, from torch.profiler, on
the card.

It makes large-v3-turbo's weights at full width from a seed (bf16 on the
card; layer norms f32), a batch of B 4 windows of 30 s (seeded log-mel
noise) and 224 target tokens, runs make_train_step(remat=True) twice to
warm up, times a third step on the host clock and profiles a fourth
(host and CUDA activity): the step's device ms by kernel group (GROUPS:
K1's forward, K15, the matmuls, the optimizer, the rest), their sum and
its share of the profiled step's wall time (the device's busy share; the
profiler's host cost is in that wall time), and the five kernels with the
most time outside the groups. One JSON line, with the card's name and
power limit. chip_smoke's train phase profiles its own step with
profile_step.

    python -m spittle_tpu_torch.probes.train_profile

To profile another tree's train step (the parent's, say), run it by path
with that tree on PYTHONPATH:

    PYTHONPATH=<tree> python spittle_tpu_torch/probes/train_profile.py

Runs only on a card (it raises without one).
"""

from __future__ import annotations

import json
import re
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from spittle_tpu_torch.models.whisper.config import CONFIGS
from spittle_tpu_torch.models.whisper.weights import random_params
from spittle_tpu_torch.probes._timing import device_label
from spittle_tpu_torch.train import make_train_step

MODEL, SEED, BATCH, TOKENS = "large-v3-turbo", 0, 4, 224
# Device kernels by group, from their names: K1's forward (the attention
# core's instances), K15 (its two passes), the matmuls (cuBLAS and CUTLASS
# GEMMs, cuDNN's convolutions), the optimizer (AdamW's foreach updates);
# the rest (elementwise, reductions, copies) is "other".
GROUPS = (
    ("K1", re.compile(r"attention_sm90")),
    ("K15", re.compile(r"bwd_rows_kernel|bwd_cols_kernel")),
    ("matmuls", re.compile(r"gemm|xmma|nvjet|cutlass|cublas|conv|fprop|dgrad|wgrad",
                           re.IGNORECASE)),
    ("optimizer", re.compile(r"multi_tensor_apply|adam", re.IGNORECASE)),
)


def profile_step(step, params, state, batch) -> dict:
    """One call of step(params, state, batch) under torch.profiler: its
    wall ms (host clock to torch.cuda.synchronize()), device ms by group
    and in all, the busy share and the top five kernels of "other"."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group = {name: 0.0 for name, _ in GROUPS}
    by_group["other"] = 0.0
    other: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        group = next((name for name, pat in GROUPS if pat.search(e.name)), "other")
        by_group[group] += ms
        if group == "other":
            other[e.name[:80]] = other.get(e.name[:80], 0.0) + ms
    device_ms = sum(by_group.values())
    if not device_ms > 0:
        raise RuntimeError("train_profile: the profiler saw no device time")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "device_ms_by_group": by_group,
            "share_of_device_ms": {k: v / device_ms for k, v in by_group.items()},
            "other_top_ms": sorted(other.items(), key=lambda kv: -kv[1])[:5]}


def main(out=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile: needs a CUDA card")
    cfg = CONFIGS[MODEL]
    params = random_params(cfg, seed=SEED, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    mel = torch.from_numpy(rng.standard_normal(
        (BATCH, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)).cuda()
    toks = rng.integers(0, cfg.n_vocab, (BATCH, TOKENS + 1))
    batch = dict(mel=mel, tokens=torch.from_numpy(toks[:, :-1]).cuda(),
                 targets=torch.from_numpy(toks[:, 1:]).cuda(),
                 mask=torch.ones((BATCH, TOKENS), device="cuda"))
    init, step = make_train_step(cfg, learning_rate=1e-5, remat=True)
    state = init(params)
    for _ in range(2):
        step(params, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, batch)
    torch.cuda.synchronize()
    rec = {"model": MODEL, "batch": BATCH, "tokens": TOKENS, "remat": True,
           "step_ms": (time.perf_counter() - t0) * 1e3,
           **profile_step(step, params, state, batch),
           "device": device_label(torch.device("cuda"))}
    out(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
