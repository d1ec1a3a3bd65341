"""Probe: the depth of K1's K/V ring (csrc/fullkv_attention.cu, kStages).

This builds copies of that one source with kStages set to 3, 4 and 5,
each into a small library of its own (one nvcc per depth, all started
together), loads the three with ctypes, and times K1 through each at the
encoder's shapes, [8, 20, 1500, 64] and the reduced context's [8, 20,
256, 64] (heads as strided views of packed projections), in turns 3, 4,
5, 5, 4, 3, as device time per launch from a CUDA graph of launches. The depth changes no arithmetic, so the
three outputs must be equal bit for bit. Prints one JSON line per depth
and shape, each with the card's name and power limit.

    python -m spittle_tpu_torch.probes.fullkv_stages

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import json
import tempfile
from typing import List

import torch

from spittle_tpu_torch.ops import _build

from ._timing import build_variants, device_label

DEPTHS = (3, 4, 5)
SHAPES = ((8, 20, 1500, 64), (8, 20, 256, 64))
ITERS = 20
SEED = 0
STAGES_LINE = "constexpr int kStages = {};"


def build(tmp: str) -> dict:
    """depth -> the spt_fullkv_attention entry of its own library."""
    text = (_build.CSRC / "fullkv_attention.cu").read_text()
    line = next(STAGES_LINE.format(n) for n in DEPTHS
                if STAGES_LINE.format(n) in text)
    sources = {n: text.replace(line, STAGES_LINE.format(n)) for n in DEPTHS}
    libs = build_variants(sources, ("spt_fullkv_attention",), tmp)
    return {n: fns[0] for n, fns in libs.items()}


def launcher(fn, q, k, v, out):
    """K1's wrapper's launch through `fn`, without its checks."""
    b, h, tq, _ = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, tq, k.shape[2], k.shape[2], 0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            out.stride(0), out.stride(2), out.stride(1))

    def run():
        _build.check(fn(*args, _build.stream_ptr(q.device)), "spt_fullkv_attention")
    return run


def graph_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per launch: `iters` launches in one CUDA graph,
    replayed between CUDA events after a settling replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("fullkv_stages: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for b, h, t, d in SHAPES:
            packed = [(torch.randn((b, t, h * d), generator=gen, device=dev)
                       * d ** -0.25).to(torch.bfloat16) for _ in range(3)]
            q, k, v = (x.view(b, t, h, d).permute(0, 2, 1, 3) for x in packed)
            outs = {n: torch.empty((b, t, h, d), dtype=torch.bfloat16, device=dev)
                    for n in DEPTHS}
            runs = {n: launcher(fn, q, k, v, outs[n]) for n, fn in entries.items()}
            for run in runs.values():
                run()
            torch.cuda.synchronize()
            same = all(torch.equal(outs[n], outs[DEPTHS[0]]) for n in DEPTHS)
            if not same:
                raise AssertionError("fullkv_stages: the depths disagree")
            order = list(DEPTHS) + list(reversed(DEPTHS))
            turns = {n: [] for n in DEPTHS}
            for n in order:
                turns[n].append(graph_ms(runs[n]))
            flops = 4.0 * b * h * t * t * d
            for n in DEPTHS:
                ms = sum(turns[n]) / len(turns[n])
                rec = {"stages": n, "shape": [b, h, t, d], "ms": ms,
                       "turns_ms": turns[n], "tflops": flops / ms / 1e9,
                       "bit_identical_across_depths": same, "device": label}
                results.append(rec)
                out(json.dumps(rec))
            del packed, q, k, v, outs
    return results


if __name__ == "__main__":
    main()
