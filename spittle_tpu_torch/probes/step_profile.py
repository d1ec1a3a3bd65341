"""Probe: where the turbo leg's wall time goes, from torch.profiler, on
the card.

It loads chip_smoke's turbo leg (random:large-v3-turbo at full width,
seed 0, W8A8 encoder, mu-law wire, bf16), warms it up with one batch, then
runs N_BATCHES batches of 8 x 30 s through transcribe_stream(
overlap_fetch=True) twice: once plain, for the wall time, and once under
torch.profiler (host and device activity). K4's wrapper is wrapped in a
record_function span ("K4 wrapper") for the profiled run, so its host
time shows on its own. One JSON line: the plain and profiled wall
seconds; the device time of every kernel, copy and set summed and its
share of the profiled wall (one minus the device's idle share, if they
do not overlap); the host time of the K4 spans and their count; the host time
of the per-step syncs (aten::_local_scalar_dense, where the loop waits
for the card); the kernel launches; and the ops with the most host time.
With the card's name and power limit.

    python -m spittle_tpu_torch.probes.step_profile

To compare two trees, run it by path with each tree on PYTHONPATH:

    PYTHONPATH=<tree> python spittle_tpu_torch/probes/step_profile.py

Runs only on a card (it raises without one).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import model as whisper_model
from spittle_tpu_torch.probes._timing import device_label

MODEL = "random:large-v3-turbo"
SEED, N_BATCHES, BATCH, SECONDS = 0, 2, 8, 30.0
TOP = 15


def make_batches(n: int, rng) -> list:
    """n batches of BATCH int16 utterances: three tones under a slow
    envelope and a little noise, as chip_smoke's end-to-end phase."""
    sr, samples = 16000, int(SECONDS * 16000)
    tt = np.arange(samples) / sr
    out = []
    for _ in range(n):
        batch = []
        for _ in range(BATCH):
            f = rng.uniform(120.0, 400.0, size=3)
            sig = sum(np.sin(2 * np.pi * fi * tt) for fi in f) / 3.0
            sig = 0.3 * sig * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * tt))
            sig += 0.02 * rng.standard_normal(samples)
            batch.append((np.clip(sig, -1, 1) * 32767).astype(np.int16))
        out.append(batch)
    return out


def main(out=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("step_profile: needs a CUDA card")
    label = device_label(torch.device("cuda"))
    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw")
    eng.load_model(MODEL, seed=SEED)
    params = TranscribeParams(language="en", condition_on_previous_text=False,
                              parallel_windows=True, temperatures=(0.0,),
                              max_tokens=96)
    rng = np.random.default_rng(SEED + 1)
    list(eng.transcribe_stream(make_batches(1, rng), params, overlap_fetch=True))
    batches = make_batches(N_BATCHES, rng)

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        list(eng.transcribe_stream(batches, params, overlap_fetch=True))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = run()
    k4 = whisper_model.decode_cross_attention

    def k4_spanned(*args, **kwargs):
        with record_function("K4 wrapper"):
            return k4(*args, **kwargs)

    whisper_model.decode_cross_attention = k4_spanned
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = run()
    finally:
        whisper_model.decode_cross_attention = k4
    events = prof.key_averages()
    # A record_function span also shows as a device-side annotation of
    # the same name, with no host time: keep the host's.
    by_name = {e.key: e for e in events
               if getattr(e, "device_type", DeviceType.CPU) == DeviceType.CPU}
    # Device activity: every kernel, copy and set on the card, each once.
    kernels_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))

    def host(name):
        e = by_name.get(name)
        return None if e is None else {"count": e.count,
                                       "cpu_ms": e.cpu_time_total / 1e3}

    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]
    rec = {
        "model": MODEL, "batches": N_BATCHES, "batch": BATCH,
        "wall_s": wall, "wall_profiled_s": wall_prof,
        "device_kernels_ms": kernels_us / 1e3,
        "device_busy_share": kernels_us / 1e6 / wall_prof,
        "k4_wrapper": host("K4 wrapper"),
        "sync": host("aten::_local_scalar_dense"),
        "kernel_launches": launches,
        "top_self_cpu_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top],
        "device": label,
    }
    out(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
