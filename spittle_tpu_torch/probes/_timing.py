"""Timing shared by the probes: CUDA events on the card, the host clock
on the CPU (never reported as a device time); and the builds of a
source's edited copies that the probes time."""

from __future__ import annotations

import ctypes
import subprocess
import time
from pathlib import Path

import torch

from spittle_tpu_torch.ops import _build


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


def edited(text: str, edits, where: str, count: int = -1) -> str:
    """`text` with each (old, new) of `edits` replaced, `count` times each
    (every occurrence by default); raises if an old text is not there."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{where}: {old!r} is not in the source")
        text = text.replace(old, new, count)
    return text


def build_variants(sources: dict, entries, tmp: str) -> dict:
    """key -> a copy's source text. Builds each copy into a library of its
    own in `tmp` (one nvcc per copy, all started together, the build's
    flags) and returns key -> the tuple of its `entries` (C names, typed
    from _build.SIGNATURES), loaded with ctypes."""
    procs = {}
    for i, (key, text) in enumerate(sources.items()):
        src = Path(tmp) / f"variant_{i}.cu"
        src.write_text(text)
        so = f"{tmp}/libvariant_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-shared", str(src), "-o", so]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed at {key}:\n{out}")
        lib = ctypes.CDLL(so)
        fns = []
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[key] = tuple(fns)
    return libs
