"""Probe: where K15's time goes (csrc/fullkv_attention_bwd.cu).

This builds copies of that one source, each into a small library of its
own (one nvcc per copy, all started together): the source as built; its
rows pass alone (dQ, D) and its columns pass alone (dK, dV); the ring at
other depths (kStages 2, 3 and 6, which change no arithmetic, so their
outputs must be the built copy's bits); both kernels capped at 128
registers a thread (__maxnreg__ for the launch bounds' 168, and no
setmaxnreg, which faults under that cap), so that ptxas spills and
serialises the wgmma products: the same arithmetic in the same order, so
its outputs must be the built copy's bits too, which shows that the
wgmma fences and waits do not depend on how ptxas allocates registers;
and both passes with the
exponentials dropped (P = the exponent itself, wrong values, the same
products, loads and stores), which shows what the special-function units
cost, and with the exponentials and the masks dropped (the products, the
dS arithmetic, the loads and stores: what is left when the softmax's own
work goes). Each is timed at the encoder's [8, 20, 1500, 64] and the decoder's
causal [4, 20, 224, 64] (heads as strided views of packed projections, o
and lse from K1's lse instance) in turns, forward then backward over the
copies, as device time per call from a CUDA graph of calls. Prints one
JSON line per copy and shape, with the card's name and power limit.

    python -m spittle_tpu_torch.probes.fullkv_bwd_parts

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import json
import tempfile
from typing import List

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att

from ._timing import build_variants, device_label, edited
from .fullkv_stages import graph_ms

SOURCE = "fullkv_attention_bwd.cu"
ENTRY = "spt_fullkv_attention_bwd"
SHAPES = ((8, 1500, False), (4, 224, True))  # (B, T, causal) at H 20, Dh 64
SEED = 0
_ROWS = """  bwd_rows_kernel<<<dim3((tq + kBlock - 1) / kBlock, b * h), kThreads,
                    BwdLayout::kAlloc, s>>>(mq, mk, mv, mdo, a);
"""
_COLS = """  bwd_cols_kernel<<<dim3((tk + kBlock - 1) / kBlock, b * h), kThreads,
                    BwdLayout::kAlloc, s>>>(mq, mk, mv, mdo, a);
"""
_STAGES = "constexpr int kStages = 4;"
_BOUNDS = "__launch_bounds__(kThreads, 1)"
_DEALLOC, _ALLOC = "reg_dealloc<kProducerRegs>();", "reg_alloc<kConsumerRegs>();"
# copy -> [(text, replacement)], every text present in the source.
VARIANTS = {
    "built": [],
    "rows_pass": [(_COLS, "")],
    "cols_pass": [(_ROWS, "")],
    "stages_2": [(_STAGES, "constexpr int kStages = 2;")],
    "stages_3": [(_STAGES, "constexpr int kStages = 3;")],
    "stages_6": [(_STAGES, "constexpr int kStages = 6;")],
    "regs_128": [(_BOUNDS, "__maxnreg__(128)"), (_DEALLOC, ""), (_ALLOC, "")] * 2,
    "no_exp": [("float p = ex2(", "float p = ("), ("p[e] = ex2(", "p[e] = (")],
    "products_only": [("float p = ex2(fmaf(s[i], kLog2e, -lse2[hr]));", "float p = s[i];"),
                      ("p[e] = ex2(fmaf(st[i + e], kLog2e, -(e ? l2.y : l2.x)));",
                       "p[e] = st[i + e];"),
                      ("if (edge) {", "if (false) {"), ("if (edge) {", "if (false) {")],
}
# Copies whose outputs must equal the built copy's bit for bit.
SAME_BITS = ("stages_2", "stages_3", "stages_6", "regs_128")


def build(tmp: str) -> dict:
    """copy -> the K15 entry of its own library."""
    text = (_build.CSRC / SOURCE).read_text()
    sources = {name: edited(text, edits, f"fullkv_bwd_parts: {name}", count=1)
               for name, edits in VARIANTS.items()}
    return {name: fns[0] for name, fns in build_variants(sources, (ENTRY,), tmp).items()}


def launcher(fn, q, k, v, o, do, lse, dd, grads, causal):
    """The K15 wrapper's launch through `fn`, without its checks, into
    `grads` (dq, dk, dv as [B, T, H, 64] buffers) and the scratch dd."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    views = [g.permute(0, 2, 1, 3) for g in grads]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            *(g.data_ptr() for g in grads), lse.data_ptr(), dd.data_ptr(),
            b, h, tq, tk, tk, int(causal),
            *(s for t in (q, k, v, o, do, *views) for s in t.stride()[:3]))

    def run():
        _build.check(fn(*args, _build.stream_ptr(q.device)), ENTRY)
    return run


def main(out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("fullkv_bwd_parts: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = []
    h, d = 20, 64
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for b, t, causal in SHAPES:
            packed = [(torch.randn((b, t, h * d), generator=gen, device=dev)
                       * d ** -0.25).to(torch.bfloat16) for _ in range(3)]
            q, k, v = (x.view(b, t, h, d).permute(0, 2, 1, 3) for x in packed)
            do = torch.randn((b, t, h, d), generator=gen, device=dev).to(
                torch.bfloat16).permute(0, 2, 1, 3)
            o, lse = att.flash_attention_fullkv_lse(q, k, v, causal=causal)
            dd = torch.empty((b * h, t), dtype=torch.float32, device=dev)
            grads = {n: [torch.zeros((b, t, h, d), dtype=torch.bfloat16, device=dev)
                         for _ in range(3)] for n in entries}
            runs = {n: launcher(fn, q, k, v, o, do, lse, dd, grads[n], causal)
                    for n, fn in entries.items()}
            # The built copy first, so that the columns pass alone reads a
            # filled D.
            for n in entries:
                runs[n]()
            torch.cuda.synchronize()
            same = {n: all(torch.equal(a, b2) for a, b2 in zip(grads[n], grads["built"]))
                    for n in SAME_BITS}
            if not all(same.values()):
                raise AssertionError(f"fullkv_bwd_parts: copies disagree with the built one: {same}")
            order = list(entries) + list(reversed(list(entries)))
            turns = {n: [] for n in entries}
            for n in order:
                turns[n].append(graph_ms(runs[n], 10))
            pairs = t * (t + 1) // 2 if causal else t * t
            flops = 10.0 * b * h * d * pairs
            for n in entries:
                ms = sum(turns[n]) / len(turns[n])
                rec = {"copy": n, "shape": [b, h, t, d], "causal": causal, "ms": ms,
                       "turns_ms": turns[n], "tflops_of_the_whole": flops / ms / 1e9,
                       "device": label}
                if n in same:
                    rec["bits_equal_built"] = same[n]
                results.append(rec)
                out(json.dumps(rec))
            del packed, q, k, v, do, o, lse, dd, grads, runs
    return results


if __name__ == "__main__":
    main()
