"""Probe: the work item and the combine pass of K3/K4/K6/K11
(csrc/decode_cross_attention_mh.cu: kHeads heads of one row slice per
item, 128 bytes of int8 or bf16 (128 or 64 positions) or kInt4Slice bytes
of packed int4, a ring of one stage per team of consumer warps, then the
combine launch).

This builds the source as it is, a copy of it with kHeads set to each of
HEADS (the ring's depth follows: 8 / kHeads stages), a copy with
kInt4Slice set to each of INT4_SLICES, each into a small library of its
own (one nvcc per copy, all started together), and one more of the
source's own configuration without the combine launch ("main_only", its
outputs not compared); it loads them with ctypes and times the kernel
through each, in turns forward then backward, as device time per launch
from a CUDA graph of launches over input sets whose sum exceeds the 50 MB
L2 twice. The shapes (SHAPES) are K3's on the main path over int8 K/V, B 8
and bench.py's large-v3 B 56 on the decoder's padded rows (Tk 1500 at a
pitch of 1504 positions, the TMA path), the decode cross-attention probe's
B 16 on both load paths (Tk 1536 contiguous: TMA; Tk 1500 contiguous:
cp.async), K4's over bf16 K/V, B 8 and bench.py's turbo B 48 on the
decoder's padded rows, and K6's over packed int4 K/V, B 8 and 56 on the
decoder's padded rows and B 8 on contiguous rows (cp.async); each at R 1
(a decode step) and 3 (the prefill). An item is (batch item, kHeads
heads, one row slice) whatever kHeads is, and each head's sums run in the
same order, so the kHeads configurations must be equal bit for bit. The
int4 slice sizes round P against other chunk maxima, so each is held to
K6's plain version at K6's tolerance instead (and timed on the int4
shapes only). The source's own configuration less "main_only" is the
combine launch's time. Prints one JSON line per configuration, shape and
R, each with the card's name and power limit. (Rings of more stages than
teams race: the source's note on the ring's phases.)

    python -m spittle_tpu_torch.probes.decode_cross_items [index ...] [-R ...]

(the indices into SHAPES to run and, negated, the query rows; all when
none are given). Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import json
import re
import sys
import tempfile
from typing import List

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops.attention import (
    _num_sms,
    decode_cross_attention_q4_plain,
)

from ._timing import build_variants, device_label

H, DH = 20, 64
# Heads per item: the stage is kHeads x 16 KB (TMA rows; 18 KB on the
# cp.async path), and the ring has 8 / kHeads stages, one per team of
# consumer warps.
HEADS = (2, 1)
# Bytes (positions) of a packed int4 row per item: a stage of 2 x 64 rows
# of 128 bytes (16 KB) or of 256 (32 KB, half the partial records).
INT4_SLICES = (128, 256)
MAIN_ONLY = "main_only"
# (K/V type, B, Tk, row pitch in elements), kv_len = Tk.
SHAPES = (("int8", 8, 1500, 1504), ("int8", 56, 1500, 1504),
          ("int8", 16, 1536, 1536), ("int8", 16, 1500, 1500),
          ("bf16", 8, 1500, 1504), ("bf16", 48, 1500, 1504),
          ("int4", 8, 1500, 1504), ("int4", 56, 1500, 1504),
          ("int4", 8, 1500, 1500))
ROWS = (1, 3)
ITERS, SEED = 60, 0
ENTRIES = {"int8": "spt_decode_cross_attention_q8",
           "bf16": "spt_decode_cross_attention",
           "int4": "spt_decode_cross_attention_q4"}
_COMBINE = "decode_cross_q_combine<<<B * H, kMaxR * kD, 0, st>>>("
_HEADS = r"constexpr int kHeads = (\d+);"
_SLICE = r"constexpr int kInt4Slice = (\d+);"


def chosen(pattern: str = _HEADS) -> int:
    """kHeads (or, with _SLICE, kInt4Slice) as the source sets it."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    return int(re.search(pattern, text).group(1))


def _slice_key(n: int) -> str:
    return f"int4_slice_{n}"


def build(tmp: str) -> dict:
    """The source's kHeads, each of HEADS, each int4 slice but the
    source's, and MAIN_ONLY -> {K/V type: its entry} of its own library."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    if _COMBINE not in text:
        raise RuntimeError("decode_cross_items: the combine launch moved")
    variants = {chosen(): text}
    for heads in HEADS:
        variants[heads] = re.sub(_HEADS, f"constexpr int kHeads = {heads};",
                                 text, count=1)
    for n in INT4_SLICES:
        if n != chosen(_SLICE):
            variants[_slice_key(n)] = re.sub(
                _SLICE, f"constexpr int kInt4Slice = {n};", text, count=1)
    variants[MAIN_ONLY] = text.replace(_COMBINE, "if (false) " + _COMBINE)
    libs = build_variants(variants, tuple(ENTRIES.values()), tmp)
    return {key: dict(zip(ENTRIES, fns)) for key, fns in libs.items()}


def launcher(fn, q, kv):
    """The wrapper's launch through `fn` on one input set, without its
    checks (the load path as decode_cross_load_path chooses it): a callable
    that allocates the scratch and the output, as the wrapper does, and
    returns the output. kv: (qK, ks, qV, vs) for K3's and K6's entries,
    (K, V) for K4's. The scratch holds a record per 64 positions, the
    fewest positions any configuration puts in an item."""
    from spittle_tpu_torch.ops.attention import decode_cross_load_path

    k, v = kv[0], kv[-2]
    b, h, r, d = q.shape
    tk, ld = k.shape[3], k.stride(2)
    tma = decode_cross_load_path(ld * k.element_size(), k.data_ptr(),
                                 v.data_ptr()) == "tma"
    chunks = -(-tk // 64)

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
    """int8 and int4: (qK, ks, qV, vs), codes in rows `pitch` positions
    apart (views of the logical [b, H, 64 or 32, tk]) and f32 scales;
    bf16: (K, V) in such rows."""
    rows_per_head = DH // 2 if kind == "int4" else DH

    def rows():
        if kind == "bf16":
            buf = torch.randn((b, H, DH, pitch), generator=gen,
                              device=dev).to(torch.bfloat16)
        else:
            buf = torch.randint(-128 if kind == "int4" else -127, 128,
                                (b, H, rows_per_head, pitch), generator=gen,
                                device=dev, dtype=torch.int8)
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
        own, own_slice = chosen(), chosen(_SLICE)
        slices = [_slice_key(n) for n in INT4_SLICES if n != own_slice]
        for kind, b, tk, pitch in shapes:
            keys = [own, MAIN_ONLY] + [h for h in HEADS if h != own]
            if kind == "int4":
                keys += slices
            es = 2 if kind == "bf16" else 1
            stored = DH // 2 if kind == "int4" else DH
            set_bytes = 2 * b * H * stored * pitch * es + (2 * b * H * tk * 4 if es == 1 else 0)
            sets = [make_set(gen, dev, kind, b, tk, pitch)
                    for _ in range(1 + int(100e6 // set_bytes))]
            for r in rows:
                q = (torch.randn((b, H, r, DH), generator=gen, device=dev)
                     * DH ** -0.5).to(torch.bfloat16)
                runs = {c: [launcher(entries[c][kind], q, kv) for kv in sets]
                        for c in keys}
                outs = {c: runs[c][0]() for c in keys}
                torch.cuda.synchronize()
                same = all(torch.equal(outs[c], outs[own])
                           for c in keys if c != MAIN_ONLY and c not in slices)
                if not same:
                    raise AssertionError("decode_cross_items: the configurations disagree")
                slice_err = {}
                if kind == "int4":
                    want = decode_cross_attention_q4_plain(q, *sets[0]).float()
                    tol = 2e-3 + 1e-2 * want.abs().max().item()
                    for c in [own] + slices:
                        got = outs[c].permute(0, 2, 1, 3).float()
                        slice_err[c] = (got - want).abs().max().item()
                        if not slice_err[c] <= tol:
                            raise AssertionError(
                                f"decode_cross_items: {c} off K6's plain version "
                                f"by {slice_err[c]} > {tol}")
                turns = {c: [] for c in keys}
                for c in keys + keys[::-1]:
                    turns[c].append(graph_ms(runs[c]))
                for c in keys:
                    t = turns[c]
                    variant = c if isinstance(c, str) else "two_launches"
                    heads = own if isinstance(c, str) else c
                    rec = {"heads_per_item": heads, "stages": 8 // heads,
                           "as_built": c == own or c == MAIN_ONLY,
                           "variant": variant, "kv": kind, "b": b, "tk": tk,
                           "pitch": pitch,
                           "path": "tma" if pitch * es % 16 == 0 else "cp.async",
                           "rows": r, "ms": sum(t) / len(t), "turns_ms": t,
                           "bit_identical_across_configs": same,
                           "device": label}
                    if kind == "int4":
                        rec["int4_slice"] = (int(c.rsplit("_", 1)[1]) if c in slices
                                             else own_slice)
                        rec["max_abs_err_vs_plain"] = slice_err.get(c)
                    results.append(rec)
                    out(json.dumps(rec))
            del sets
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main([SHAPES[i] for i in args if i >= 0] or SHAPES,
         tuple(-i for i in args if i < 0) or ROWS)
