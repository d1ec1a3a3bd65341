"""Probe: K7 (csrc/fullkv_attention_q8.cu) by parts and by variant, on the
card.

This builds copies of that source, each with a few lines replaced
(VARIANTS; "built" is the source as it is), one nvcc per copy, all
started together, and loads each copy's two entries with ctypes. At the
encoder's [8, 20, 1500, 64] (the resident form) and at a long window's
[1, 20, 4096, 64] (the streamed form) it times, as device ms per launch
from a CUDA graph of ITERS launches, the three row-quantizer launches
alone (the built ones and ieee_div's) and each variant's attention
launch alone, in turns forward then backward, through the wrapper's own
helpers (ops/attention.py: _q8_buffers, _q8_quantize, _q8_attend) with
each copy's entries. The
variants change one piece of the score work: "ieee_div" divides with
__fdiv_rn throughout (its fallback), which must give the built kernel's
bits; the others drop or cheapen a piece, so that the built kernel's time
less theirs is its share: "no_div" pass 3's division (a multiply by the
reciprocal in its place), "fast_exp" expf (ex2.approx in its place),
"products_only" every pass's f32 work (the products, loads and waits
alone). Each variant's output is compared with the built kernel's
("equal_to_built"). One JSON line per shape, with the card's name and
power limit.

    python -m spittle_tpu_torch.probes.q8_parts

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

SOURCE = "fullkv_attention_q8.cu"
SEED, ITERS = 0, 20
_DIV = "div_fma(pv, sp[hr], rsp[hr])"
_FMA = "fma = __all_sync(0xffffffffu, sp[0] >= kMinFmaDiv && sp[1] >= kMinFmaDiv);"
_QFMA = "if (s >= kMinFmaDiv) {"
_EXP = "expf(s - m[hr])"
_PASS = "  const int end = kPass == 0 ? p.Tk : p.kv_len;"
# name -> [(text of the source, its replacement)]
VARIANTS = {
    "built": [],
    "ieee_div": [(_FMA, "fma = false;"), (_QFMA, "if (false) {")],
    "no_div": [(_DIV, "__fmul_rn(pv, rsp[hr])")],
    "fast_exp": [(_EXP, "__expf(s - m[hr])")],
    "products_only": [(_PASS, "  return;\n" + _PASS)],
}
# (B, H, T): the encoder's batch of 8 windows, and a long window's K/V.
SHAPES = ((8, 20, 1500), (1, 20, 4096))
ENTRIES = ("spt_fullkv_q8_quantize", "spt_fullkv_attention_q8")


def build(tmp: str) -> dict:
    """variant -> (quantize entry, attention entry) of its own library."""
    text = (_build.CSRC / SOURCE).read_text()
    sources = {name: edited(text, edits, f"q8_parts: {SOURCE}")
               for name, edits in VARIANTS.items()}
    return build_variants(sources, ENTRIES, tmp)


def graph_ms(fn, iters: int = ITERS) -> float:
    """Mean device ms per call: `iters` calls in one CUDA graph replayed
    between CUDA events after a settling replay."""
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


def main(shapes=SHAPES, out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("q8_parts: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        names = list(libs)
        for b, h, t in shapes:
            q, k, v = ((torch.randn((b, h, t, 64), generator=gen, device=dev)
                        * 64 ** -0.25).to(torch.bfloat16) for _ in range(3))
            bufs = att._q8_buffers(q, k)

            def quantize(n):
                att._q8_quantize(libs[n][0], q, k, v, bufs)

            def attend(n):
                att._q8_attend(libs[n][1], bufs, t)

            # Each variant's output from its own quantizer and attention.
            outs = {}
            for n in names:
                quantize(n)
                attend(n)
                outs[n] = bufs["out"].clone()
            torch.cuda.synchronize()
            quantize("built")
            turns = {n: [] for n in names}
            quant = {n: [] for n in ("built", "ieee_div")}
            for n in names + names[::-1]:
                turns[n].append(graph_ms(lambda n=n: attend(n)))
                if n in quant:
                    quant[n].append(graph_ms(lambda n=n: quantize(n)))
            rec = {"shape": [b, h, t, 64], "form": att.q8_form(t),
                   "quantizers_ms": {n: sum(x) / len(x) for n, x in quant.items()},
                   "attention_ms": {n: sum(x) / len(x) for n, x in turns.items()},
                   "equal_to_built": {n: bool(torch.equal(outs[n], outs["built"]))
                                      for n in names},
                   "turns_ms": turns, "device": label}
            results.append(rec)
            out(json.dumps(rec))
            del q, k, v, bufs, outs
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
