"""Probe: the work item, the ring depth and the combine pass of K3/K11
(csrc/decode_cross_attention_mh.cu: kHeads heads of 128 positions per
item, a ring of kStages1 stages at one query row on the TMA path and
kStagesN otherwise, then the combine launch).

This builds the source as it is, copies of it with kHeads and both ring
depths set to each (heads, stages) of CONFIGS, each into a small library
of its own (one nvcc per copy, all started together), and one more of
the source's own configuration without the combine launch ("main_only",
its outputs not compared); it loads them with ctypes and times the
kernel through each, in turns forward then backward, as device time per
launch from a CUDA graph of launches over input sets whose sum exceeds
the 50 MB L2 twice. The shapes (SHAPES) are K3's on the main path, B 8 and bench.py's
B 56 on the decoder's padded rows (Tk 1500 at a pitch of 1504 bytes, the
TMA path), and the decode cross-attention probe's B 16 on both load paths
(Tk 1536 contiguous: TMA; Tk 1500 contiguous: cp.async), each at R 1 (a
decode step) and 3 (the prefill). An item is (batch item, kHeads heads,
128 positions) whatever kHeads is, and each head's sums run in the same
order, so all outputs must be equal bit for bit. The source's own
configuration less "main_only" is the combine launch's time. Prints
one JSON line per configuration, shape and R, each with the card's name
and power limit.

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
from spittle_tpu_torch.ops.attention import _MH_CHUNK, _num_sms

from ._timing import device_label

H, DH = 20, 64
# (heads per item, ring depth): the stage is kHeads x 32 KB (TMA rows; 36
# KB on the cp.async path), and the ring needs at least 8 / kHeads stages,
# one per team of consumer warps.
CONFIGS = ((2, 4), (2, 5), (1, 8), (1, 10))
MAIN_ONLY = "main_only"
# (B, Tk, row pitch in bytes), kv_len = Tk.
SHAPES = ((8, 1500, 1504), (56, 1500, 1504), (16, 1536, 1536), (16, 1500, 1500))
ROWS = (1, 3)
ITERS, SEED = 60, 0
ENTRY = "spt_decode_cross_attention_q8"
_COMBINE = "decode_cross_q_combine<<<B * H, kMaxR * kD, 0, st>>>("


def chosen() -> tuple:
    """(kHeads, kStages1, kStagesN) as the source sets them."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
                 for name in ("kHeads", "kStages1", "kStagesN"))


def build(tmp: str) -> dict:
    """The source's (kHeads, kStages1, kStagesN), each (kHeads, stages) of
    CONFIGS and MAIN_ONLY -> the K3 entry of its own library."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    if _COMBINE not in text:
        raise RuntimeError("decode_cross_items: the combine launch moved")
    variants = {chosen(): text}
    for heads, stages in CONFIGS:
        body = re.sub(r"constexpr int kHeads = \d+;", f"constexpr int kHeads = {heads};",
                      text, count=1)
        for name in ("kStages1", "kStagesN"):
            body = re.sub(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {stages};", body, count=1)
        variants[(heads, stages)] = body
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
        fn = getattr(ctypes.CDLL(so), ENTRY)
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        entries[key] = fn
    return entries


def launcher(fn, q, kv):
    """K3's wrapper's launch through `fn` on one input set, without its
    checks (the load path as decode_cross_load_path chooses it): a callable
    that allocates the scratch and the output, as the wrapper does, and
    returns the output."""
    from spittle_tpu_torch.ops.attention import decode_cross_load_path

    qk, ks, qv, vs = kv
    b, h, r, d = q.shape
    tk, ld = qk.shape[3], qk.stride(2)
    tma = decode_cross_load_path(ld, qk.data_ptr(), qv.data_ptr()) == "tma"

    def run():
        part = torch.empty((b * h, -(-tk // _MH_CHUNK), r, d + 2),
                           dtype=torch.float32, device=q.device)
        out = torch.empty((b, r, h, d), dtype=torch.bfloat16, device=q.device)
        _build.check(fn(q.data_ptr(), qk.data_ptr(), ks.data_ptr(), qv.data_ptr(),
                        vs.data_ptr(), part.data_ptr(), out.data_ptr(), b, h,
                        r, tk, tk, _num_sms(q.device.index),
                        int(tma), *q.stride()[:3], ld, out.stride(0),
                        out.stride(2), out.stride(1), _build.stream_ptr(q.device)),
                     ENTRY)
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


def make_set(gen, dev, b, tk, pitch):
    """(qK, ks, qV, vs): int8 codes in rows `pitch` bytes apart (views of
    the logical [b, H, 64, tk]) and f32 scales."""
    def codes():
        buf = torch.randint(-127, 128, (b, H, DH, pitch), generator=gen,
                            device=dev, dtype=torch.int8)
        return buf[..., :tk]
    return (codes(), torch.rand((b, H, tk), generator=gen, device=dev) * 0.02,
            codes(), torch.rand((b, H, tk), generator=gen, device=dev) * 0.02)


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
        keys = [own, MAIN_ONLY] + list(CONFIGS)
        for b, tk, pitch in shapes:
            set_bytes = 2 * b * H * DH * pitch + 2 * b * H * tk * 4
            sets = [make_set(gen, dev, b, tk, pitch)
                    for _ in range(1 + int(100e6 // set_bytes))]
            for r in rows:
                q = (torch.randn((b, H, r, DH), generator=gen, device=dev)
                     * DH ** -0.5).to(torch.bfloat16)
                runs = {c: [launcher(fn, q, kv) for kv in sets]
                        for c, fn in entries.items()}
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
                    heads, *stages = own if isinstance(c, str) else c
                    rec = {"heads_per_item": heads, "stages": stages,
                           "as_built": c == own or isinstance(c, str),
                           "variant": variant, "b": b, "tk": tk,
                           "pitch": pitch,
                           "path": "tma" if pitch % 16 == 0 else "cp.async",
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
