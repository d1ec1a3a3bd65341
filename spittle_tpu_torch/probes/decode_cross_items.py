"""Probe: the work item and the combine pass of K3/K4/K11
(csrc/decode_cross_attention_mh.cu: kHeads heads of one 128-byte row slice
per item, 128 int8 or 64 bf16 positions, a ring of one stage per team of
consumer warps, then the combine launch).

This builds the source as it is, a copy of it with kHeads set to each of
HEADS (the ring's depth follows: 8 / kHeads stages), each into a small
library of its own (one nvcc per copy, all started together), and one more
of the source's own configuration without the combine launch
("main_only", its outputs not compared); it loads them with ctypes and
times the kernel through each, in turns forward then backward, as device
time per launch from a CUDA graph of launches over input sets whose sum
exceeds the 50 MB L2 twice. The shapes (SHAPES) are K3's on the main path
over int8 K/V, B 8 and bench.py's large-v3 B 56 on the decoder's padded
rows (Tk 1500 at a pitch of 1504 positions, the TMA path), the decode
cross-attention probe's B 16 on both load paths (Tk 1536 contiguous: TMA;
Tk 1500 contiguous: cp.async), and K4's over bf16 K/V, B 8 and bench.py's
turbo B 48 on the decoder's padded rows; each at R 1 (a decode step) and 3
(the prefill). An item is (batch item, kHeads heads, one row slice)
whatever kHeads is, and each head's sums run in the same order, so all
outputs must be equal bit for bit. The source's own configuration less
"main_only" is the combine launch's time. Prints one JSON line per
configuration, shape and R, each with the card's name and power limit.
(Rings of more stages than teams race: the source's note on the ring's phases.)

    python -m spittle_tpu_torch.probes.decode_cross_items [index ...] [-R ...]

(the indices into SHAPES to run and, negated, the query rows; all when
none are given). Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops.attention import _num_sms, _slice_positions

from ._timing import device_label

H, DH = 20, 64
# Heads per item: the stage is kHeads x 16 KB (TMA rows; 18 KB on the
# cp.async path), and the ring has 8 / kHeads stages, one per team of
# consumer warps.
HEADS = (2, 1)
MAIN_ONLY = "main_only"
# (K/V type, B, Tk, row pitch in elements), kv_len = Tk.
SHAPES = (("int8", 8, 1500, 1504), ("int8", 56, 1500, 1504),
          ("int8", 16, 1536, 1536), ("int8", 16, 1500, 1500),
          ("bf16", 8, 1500, 1504), ("bf16", 48, 1500, 1504))
ROWS = (1, 3)
ITERS, SEED = 60, 0
ENTRIES = {"int8": "spt_decode_cross_attention_q8",
           "bf16": "spt_decode_cross_attention"}
_COMBINE = "decode_cross_q_combine<<<B * H, kMaxR * kD, 0, st>>>("


def chosen() -> int:
    """kHeads as the source sets it."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    return int(re.search(r"constexpr int kHeads = (\d+);", text).group(1))


def build(tmp: str) -> dict:
    """The source's kHeads, each of HEADS and MAIN_ONLY -> {K/V type: its
    entry} of its own library."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    if _COMBINE not in text:
        raise RuntimeError("decode_cross_items: the combine launch moved")
    variants = {chosen(): text}
    for heads in HEADS:
        variants[heads] = re.sub(r"constexpr int kHeads = \d+;",
                                 f"constexpr int kHeads = {heads};", text, count=1)
    variants[MAIN_ONLY] = text.replace(_COMBINE, "if (false) " + _COMBINE)
    procs = {}
    for i, (key, body) in enumerate(variants.items()):
        src = Path(tmp) / f"mh_{i}.cu"
        src.write_text(body)
        so = f"{tmp}/libmh_{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-shared", str(src), "-o", so]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for key, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed at {key}:\n{out}")
        lib = ctypes.CDLL(so)
        entries[key] = {}
        for kind, name in ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
            entries[key][kind] = fn
    return entries


def launcher(fn, q, kv):
    """The wrapper's launch through `fn` on one input set, without its
    checks (the load path as decode_cross_load_path chooses it): a callable
    that allocates the scratch and the output, as the wrapper does, and
    returns the output. kv: (qK, ks, qV, vs) for K3's entry, (K, V) for
    K4's."""
    from spittle_tpu_torch.ops.attention import decode_cross_load_path

    k, v = kv[0], kv[-2]
    b, h, r, d = q.shape
    tk, ld = k.shape[3], k.stride(2)
    tma = decode_cross_load_path(ld * k.element_size(), k.data_ptr(),
                                 v.data_ptr()) == "tma"
    chunks = -(-tk // _slice_positions(k.element_size()))

    def run():
        part = torch.empty((b * h, chunks, r, d + 2), dtype=torch.float32,
                           device=q.device)
        out = torch.empty((b, r, h, d), dtype=torch.bfloat16, device=q.device)
        _build.check(fn(q.data_ptr(), *(t.data_ptr() for t in kv), part.data_ptr(),
                        out.data_ptr(), b, h, r, tk, tk, _num_sms(q.device.index),
                        int(tma), *q.stride()[:3], ld, out.stride(0),
                        out.stride(2), out.stride(1), _build.stream_ptr(q.device)),
                     "decode_cross_items")
        return out
    return run


def graph_ms(runs, iters: int = ITERS) -> float:
    """Mean device ms per launch: `iters` launches taking the input sets in
    turn, in one CUDA graph replayed between CUDA events after a settling
    replay."""
    for run in runs:
        run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            runs[i % len(runs)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_set(gen, dev, kind, b, tk, pitch):
    """int8: (qK, ks, qV, vs), codes in rows `pitch` positions apart
    (views of the logical [b, H, 64, tk]) and f32 scales; bf16: (K, V) in
    such rows."""
    def rows():
        if kind == "int8":
            buf = torch.randint(-127, 128, (b, H, DH, pitch), generator=gen,
                                device=dev, dtype=torch.int8)
        else:
            buf = torch.randn((b, H, DH, pitch), generator=gen,
                              device=dev).to(torch.bfloat16)
        return buf[..., :tk]
    if kind == "bf16":
        return rows(), rows()
    return (rows(), torch.rand((b, H, tk), generator=gen, device=dev) * 0.02,
            rows(), torch.rand((b, H, tk), generator=gen, device=dev) * 0.02)


def main(shapes=SHAPES, rows=ROWS, out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("decode_cross_items: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        own = chosen()
        keys = [own, MAIN_ONLY] + [h for h in HEADS if h != own]
        for kind, b, tk, pitch in shapes:
            es = 1 if kind == "int8" else 2
            set_bytes = 2 * b * H * DH * pitch * es + (2 * b * H * tk * 4 if es == 1 else 0)
            sets = [make_set(gen, dev, kind, b, tk, pitch)
                    for _ in range(1 + int(100e6 // set_bytes))]
            for r in rows:
                q = (torch.randn((b, H, r, DH), generator=gen, device=dev)
                     * DH ** -0.5).to(torch.bfloat16)
                runs = {c: [launcher(fns[kind], q, kv) for kv in sets]
                        for c, fns in entries.items()}
                outs = {c: runs[c][0]() for c in keys}
                torch.cuda.synchronize()
                same = all(torch.equal(outs[c], outs[own])
                           for c in keys if c != MAIN_ONLY)
                if not same:
                    raise AssertionError("decode_cross_items: the configurations disagree")
                turns = {c: [] for c in keys}
                for c in keys + keys[::-1]:
                    turns[c].append(graph_ms(runs[c]))
                for c in keys:
                    t = turns[c]
                    variant = c if isinstance(c, str) else "two_launches"
                    heads = own if isinstance(c, str) else c
                    rec = {"heads_per_item": heads, "stages": 8 // heads,
                           "as_built": c == own or isinstance(c, str),
                           "variant": variant, "kv": kind, "b": b, "tk": tk,
                           "pitch": pitch,
                           "path": "tma" if pitch * es % 16 == 0 else "cp.async",
                           "rows": r, "ms": sum(t) / len(t), "turns_ms": t,
                           "bit_identical_across_configs": same,
                           "device": label}
                    results.append(rec)
                    out(json.dumps(rec))
            del sets
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main([SHAPES[i] for i in args if i >= 0] or SHAPES,
         tuple(-i for i in args if i < 0) or ROWS)
