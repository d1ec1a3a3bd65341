"""Probe: the work item and ring depth of K11
(csrc/decode_cross_attention_mh.cu: kHeads heads of 128 positions per
item, kStages stages).

This builds copies of that one source with (kHeads, kStages) set to each
of CONFIGS, each into a small library of its own (one nvcc per copy, all
started together), loads them with ctypes, and times K11 through each at
the decode cross-attention probe's shape (B 16, H 20, kv_len 1500, R 1
and 3) on both load paths, Tk 1536 (TMA) and Tk 1500 (cp.async), in turns
forward then backward, as device time per launch from a CUDA graph of
launches over three input sets (195 MB, past the 50 MB L2). An item is
(batch item, kHeads heads, 128 positions) whatever kHeads is, and each
head's sums run in the same order, so all outputs must be equal bit for
bit. Prints one JSON line per configuration, path and R, each with the
card's name and power limit.

    python -m spittle_tpu_torch.probes.decode_cross_items

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path
from typing import List

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops.attention import _MH_CHUNK, _num_sms

from ._timing import device_label
from .decode_cross import B, DH, H, KV_LEN

# (heads per item, ring depth): the stage is kHeads x 32 KB (TMA rows; 36
# KB on the cp.async path), and the ring needs at least 8 / kHeads stages,
# one per team of consumer warps.
CONFIGS = ((2, 4), (2, 5), (1, 8), (1, 10))
TKS = (1536, 1500)
ROWS = (1, 3)
ITERS, N_SETS, SEED = 60, 3, 0
ENTRY = "spt_decode_cross_attention_q8_mh"


def build(tmp: str) -> dict:
    """(kHeads, kStages) -> the K11 entry of its own library."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    procs = {}
    for heads, stages in CONFIGS:
        src = Path(tmp) / f"mh_h{heads}_s{stages}.cu"
        body = re.sub(r"constexpr int kHeads = \d+;", f"constexpr int kHeads = {heads};",
                      text, count=1)
        body = re.sub(r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};",
                      body, count=1)
        src.write_text(body)
        so = f"{tmp}/libmh_h{heads}_s{stages}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-shared", str(src), "-o", so]
        procs[(heads, stages)] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for cfg, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed at {cfg}:\n{out}")
        fn = getattr(ctypes.CDLL(so), ENTRY)
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        entries[cfg] = fn
    return entries


def launcher(fn, q, kv, out):
    """K11's wrapper's launch through `fn` on one input set, without its
    checks."""
    qk, ks, qv, vs = kv
    b, h, r, d = q.shape
    part = torch.empty((b * h, -(-KV_LEN // _MH_CHUNK), r, d + 2),
                       dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), qk.data_ptr(), ks.data_ptr(), qv.data_ptr(),
            vs.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, r,
            qk.shape[3], KV_LEN, _num_sms(q.device.index), *q.stride()[:3],
            out.stride(0), out.stride(2), out.stride(1))

    def run():
        _build.check(fn(*args, _build.stream_ptr(q.device)), ENTRY)
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


def main(out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("decode_cross_items: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for tk in TKS:
            sets = [(torch.randint(-127, 128, (B, H, DH, tk), generator=gen,
                                   device=dev, dtype=torch.int8),
                     torch.rand((B, H, tk), generator=gen, device=dev) * 0.02,
                     torch.randint(-127, 128, (B, H, DH, tk), generator=gen,
                                   device=dev, dtype=torch.int8),
                     torch.rand((B, H, tk), generator=gen, device=dev) * 0.02)
                    for _ in range(N_SETS)]
            for r in ROWS:
                q = (torch.randn((B, H, r, DH), generator=gen, device=dev)
                     * DH ** -0.5).to(torch.bfloat16)
                outs = {c: torch.empty((B, r, H, DH), dtype=torch.bfloat16,
                                       device=dev) for c in CONFIGS}
                runs = {c: [launcher(fn, q, kv, outs[c]) for kv in sets]
                        for c, fn in entries.items()}
                for c in CONFIGS:
                    runs[c][0]()
                torch.cuda.synchronize()
                same = all(torch.equal(outs[c], outs[CONFIGS[0]]) for c in CONFIGS)
                if not same:
                    raise AssertionError("decode_cross_items: the configurations disagree")
                turns = {c: [] for c in CONFIGS}
                for c in list(CONFIGS) + list(reversed(CONFIGS)):
                    turns[c].append(graph_ms(runs[c]))
                for heads, stages in CONFIGS:
                    t = turns[(heads, stages)]
                    rec = {"heads_per_item": heads, "stages": stages,
                           "path": "tma" if tk % 16 == 0 else "cp.async",
                           "tk": tk, "rows": r, "ms": sum(t) / len(t),
                           "turns_ms": t, "bit_identical_across_configs": same,
                           "device": label}
                    results.append(rec)
                    out(json.dumps(rec))
            del sets
    return results


if __name__ == "__main__":
    main()
