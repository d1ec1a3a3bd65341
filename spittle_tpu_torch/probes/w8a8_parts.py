"""Probe: K2 (csrc/w8a8_gemm.cu) by parts and by variant, on the card.

This builds copies of that source, each with a few lines of its epilogue
replaced (VARIANTS; "built" is the source as it is), one nvcc per copy,
all started together, and loads each copy's two entries with ctypes. For
one encoder layer's six GEMMs at M = 8 * 1500 (bf16) it times, as device
ms per launch from a CUDA graph of 20 launches, the row quantizer alone
and each variant's GEMM alone at both tile widths (128 and 256 columns),
in turns forward then backward. "stores_only" keeps the loads, products
and stores and drops the epilogue's arithmetic (y = float(acc)): the
GEMM's time less its time is the epilogue arithmetic's share. One JSON
line per GEMM, each with the card's name and power limit. K2's output
bits are probes/kernel_digest.py's.

    python -m spittle_tpu_torch.probes.w8a8_parts

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import json
import tempfile
from typing import List

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops.attention import _num_sms
from spittle_tpu_torch.ops.w8a8_gemm import _DTYPES

from . import kernel_digest
from ._timing import build_variants, device_label, edited

M, SEED, ITERS = 12000, 0, 20
_SCALED = "float v = __fmaf_rn(__fmul_rn(static_cast<float>(acc), s_x), s_w, b);"
_GELU = "if constexpr (kGelu) v = v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));"
# name -> [(text of the source, its replacement)]
VARIANTS = {
    "built": [],
    "stores_only": [(_SCALED, "float v = static_cast<float>(acc);"), (_GELU, "")],
}
# One encoder layer: (label, K, N, bias, act, out_scale).
LAYER = (("q", 1280, 1280, True, "none", 64 ** -0.25),
         ("k", 1280, 1280, False, "none", 64 ** -0.25),
         ("v", 1280, 1280, True, "none", 1.0), ("out", 1280, 1280, True, "none", 1.0),
         ("fc1", 1280, 5120, True, "gelu", 1.0), ("fc2", 5120, 1280, True, "none", 1.0))


def build(tmp: str) -> dict:
    """variant -> (quantize entry, GEMM entry) of its own library."""
    text = (_build.CSRC / "w8a8_gemm.cu").read_text()
    sources = {name: edited(text, edits, "w8a8_parts: w8a8_gemm.cu")
               for name, edits in VARIANTS.items()}
    return build_variants(sources, ("spt_w8a8_quantize_rows", "spt_w8a8_gemm"), tmp)


def quantize(fn, x):
    m, k = x.shape
    qx = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    _build.check(fn(x.data_ptr(), qx.data_ptr(), sx.data_ptr(), m, k,
                    _DTYPES[x.dtype], _build.stream_ptr(x.device)), "quantize")
    return qx, sx


def gemm(fn, qx, sx, qw, sw, bias, scale, gelu, dtype, bn, out):
    m, k = qx.shape
    n = qw.shape[1]
    _build.check(fn(qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                    None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
                    int(gelu), _DTYPES[dtype],
                    int(bias is not None and bias.dtype == torch.bfloat16), bn,
                    _num_sms(qx.device.index), scale, _build.stream_ptr(qx.device)),
                 "gemm")
    return out


def graph_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per call of fn from a CUDA graph of `iters` calls."""
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
        raise RuntimeError("w8a8_parts: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for lab, k, n, bias, act, scale in LAYER:
            gen.manual_seed(SEED)
            x, qw, b = kernel_digest.k2_inputs(gen, dev, M, k, n, "bf16", bias)
            qfn = entries["built"][0]
            qx, sx = quantize(qfn, x)
            y = torch.empty((M, n), dtype=x.dtype, device=dev)
            rec = {"gemm": lab, "m": M, "k": k, "n": n, "bias": bias, "act": act,
                   "quant_ms": graph_ms(lambda: quantize(qfn, x)),
                   "device": label}
            runs = {(v, bn): (lambda v=v, bn=bn: gemm(
                entries[v][1], qx, sx, qw["qw8"], qw["scale"], b, scale,
                act == "gelu", x.dtype, bn, y))
                for v in ("built", "stores_only") for bn in (256, 128)
                if n % bn == 0 and not (bn == 256 and act == "gelu")}
            turns = {key: [] for key in runs}
            for key in list(runs) + list(runs)[::-1]:
                turns[key].append(graph_ms(runs[key]))
            rec["gemm_ms"] = {f"{v} bn{bn}": sum(t) / len(t) for (v, bn), t in turns.items()}
            results.append(rec)
            out(json.dumps(rec))
            del x, qx, sx, y
    return results


if __name__ == "__main__":
    main()
