"""Timing shared by the probes: CUDA events on the card, the host clock
on the CPU (never reported as a device time)."""

from __future__ import annotations

import subprocess
import time

import torch


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(dev)


def timed_ms(fn, dev: torch.device, iters: int, reps: int = 1) -> float:
    """Least mean milliseconds per call of `fn` over `reps` runs of `iters`
    calls, after one settling run."""
    def one_run() -> float:
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    one_run()
    return min(one_run() for _ in range(reps))


def time_key(dev: torch.device) -> str:
    """Device times go under "ms"; a CPU run's host clock under "host_ms"."""
    return "ms" if dev.type == "cuda" else "host_ms"


def graph_ms(fns, iters: int) -> float:
    """Mean device ms per call of `fns` (callables on separate input sets,
    taken in turn) from `iters` calls captured in one CUDA graph and
    replayed between CUDA events: no host cost per call in the number."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
