"""Probe: K14 (csrc/decode_cross_attention_w8a8.cu) by parts, on the card.

This builds copies of that source, each with a few lines replaced
(VARIANTS; "built" is the source as it is), one nvcc per copy, all
started together, loads each copy's entry with ctypes and times it under
K14's own plan (ops/attention.py:w8a8_plan) at large-v3's decoder shapes
(H 20, Dh 64, T 1500 on rows of 1504 bytes, bf16 q): B 8 at R 1, 8 and
228, B 56 at R 1 and B 1 (a CTA or two per SM) at R 1 and 228, as device ms per launch from a CUDA graph of
launches over input sets whose sum exceeds the 50 MB L2 twice, in turns
forward then backward. Each variant drops or cheapens one piece, so that
the built kernel's time less its time is that piece's share (their
outputs are not compared): "fast_math" takes __expf and __fdividef in the row passes (the special
functions' and IEEE divisions' cost), "no_scores" skips the products of
the score pass (scores 0), "no_quant" q's quantization (codes and scales
1, no load of q), "no_passes" the row passes' loops over the slice (the
reductions and barriers stay), "no_pv" the P . V products, "loads_only"
returns once K and V have landed. "timeline" keeps the arithmetic and
stores each CTA's clock64() at the phases' bounds (STAMPS) past the
output; one launch of it gives each phase's mean SM cycles over the CTAs.
One JSON line per shape and variant, with the card's name and power
limit.

    python -m spittle_tpu_torch.probes.w8a8_cross_parts

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import json
import tempfile

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import quantize_kv_w8a8

from ._timing import build_variants, device_label, edited, graph_ms

SOURCE = "decode_cross_attention_w8a8.cu"
ENTRY = "spt_decode_cross_attention_w8a8"
H, DH, T, PITCH, SEED, ITERS = 20, 64, 1500, 1504, 0, 40
SHAPES = ((8, 1), (8, 8), (8, 228), (56, 1), (1, 1), (1, 228))
_LOADED = "  // 2. q's rows"
# The timeline copy: thread 0 of every CTA stores clock64() at each phase's
# start and at its end (STAMPS) past the output's own bytes.
_STAMP = ("if (threadIdx.x == 0) reinterpret_cast<long long*>(static_cast<char*>(p.out) + "
          "((static_cast<long long>(gridDim.z) * p.R * p.Dh * sizeof(T) + 7) & ~7ll))"
          "[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 8 + {k}] "
          "= clock64();\n")
STAMPS = ("start", "loads started", "q quantized, K landed", "scores made",
          "row passes, V landed", "P . V made", "partials pushed", "combined")
_ANCHORS = ("  // 1. Loads", "  // 2. q's rows", "  // 3. Scores", "  // 4. Row passes",
            "  // 5. This rank's", "  //    Each row's partials", "  // 6. Combine")
_END = "    store(o + 3, static_cast<float>(sum.w) * scale);\n  }\n}\n"
TIMELINE = [(a, "  " + _STAMP.format(k=k) + a) for k, a in enumerate(_ANCHORS)] + [
    (_END, "    store(o + 3, static_cast<float>(sum.w) * scale);\n  }\n  "
     + _STAMP.format(k=7) + "}\n")]
# name -> [(text of the source, its replacement)], applied in order
VARIANTS = {
    "built": [],
    "fast_math": [("= expf(x.", "= __expf(x."),
                  ("e >= kMinFmaDiv ? div_fma(e, l, yl) : __fdiv_rn(e, l)", "__fdividef(e, l)"),
                  ("fast ? div_fma(pv, sp, ysp) : __fdiv_rn(pv, sp)", "__fdividef(pv, sp)")],
    "no_scores": [("spt::mma_s8_16832(acc, a[kk], bf);", ""),
                  ("acc[r][j] = __dp4a(qa, static_cast<int>(kc[j]), acc[r][j]);", ";")],
    "no_quant": [("amax = fmaxf(amax, fabsf(to_f32(qr[d])));", "amax = 1.f;"),
                 ("c = fminf(fmaxf(rintf(to_f32(qr[d]) / scale), -127.f), 127.f);",
                  "c = 1.f;")],
    "no_passes": [("c < nc; c += G)", "c < 0; c += G)"), ("c < lc; c += G)", "c < 0; c += G)"),
                  ("c < (w.S >> 2); c += G)", "c < 0; c += G)")],
    "no_pv": [("spt::mma_s8_16832(acc, af, bf);", ""),
              ("const int vw = ld_word(vr + 4 * w, bytes, live - 4 * w);",
               "const int vw = 0;")],
    "timeline": TIMELINE,
    "loads_only": [(_LOADED, "  cp_async_wait<0>();\n  cluster_wait();\n"
                              "  if (p.R > 0) return;\n  // 2. q's rows")],
}


def build(tmp: str) -> dict:
    """variant -> its entry, from a library of its own."""
    text = (_build.CSRC / SOURCE).read_text()
    sources = {name: edited(text, edits, f"w8a8_cross_parts: {SOURCE}")
               for name, edits in VARIANTS.items()}
    return {name: fns[0] for name, fns in build_variants(sources, (ENTRY,), tmp).items()}


def _inputs(gen, b, r, dev):
    def padded(x):
        out = torch.empty(x.shape[:-1] + (PITCH,), dtype=x.dtype, device=dev)
        out[..., :T] = x
        return out[..., :T]

    kv = [quantize_kv_w8a8(torch.randn((b, H, DH, T), generator=gen, device=dev))
          for _ in range(2)]
    q = (torch.randn((b, H, r, DH), generator=gen, device=dev) * DH ** -0.5).to(
        torch.bfloat16)
    return q, padded(kv[0]["qw8"]), kv[0]["scale"], padded(kv[1]["qw8"]), kv[1]["scale"]


def _launch(fn, args, out, plan):
    q, qk, ks, qv, vs = args
    b, h, r, d = q.shape
    _build.check(fn(
        q.data_ptr(), qk.data_ptr(), ks.data_ptr(), qv.data_ptr(), vs.data_ptr(),
        out.data_ptr(), b, h, r, d, T, T, int(plan.mma), plan.cluster, plan.slice,
        plan.row_tile, int(plan.stream), 1, *q.stride()[:3], *qk.stride()[:3],
        *qv.stride()[:3], torch.cuda.current_stream().cuda_stream), ENTRY)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("w8a8_cross_parts: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        names = list(libs)
        for b, r in SHAPES:
            plan = att.w8a8_plan(T, r, DH)
            sets = [_inputs(gen, b, r, dev)
                    for _ in range(1 + int(100e6 // (2 * b * H * DH * T)))]
            out = torch.empty((b, H, r, DH), dtype=torch.bfloat16, device=dev)
            ms = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    ms[n].append(graph_ms(
                        [lambda a=a, n=n: _launch(libs[n], a, out, plan) for a in sets],
                        ITERS))
            stamps = torch.zeros(out.numel() * 2 // 8 + 8 + 8 * plan.cluster * plan.row_tiles(r)
                                 * b * H, dtype=torch.int64, device=dev)
            _launch(libs["timeline"], sets[0], stamps, plan)
            torch.cuda.synchronize()
            at = (out.numel() * 2 + 7) // 8
            t = stamps[at:].view(-1, 8).double()
            phases = {f"{STAMPS[k]} -> {STAMPS[k + 1]}": (t[:, k + 1] - t[:, k]).mean().item()
                      for k in range(7)}
            print(json.dumps(dict(probe="w8a8_cross_parts", device=label, B=b, R=r,
                                  variant="timeline", ctas=t.shape[0],
                                  mean_cycles=phases)))
            for n in names:
                if n == "timeline":
                    continue
                print(json.dumps(dict(
                    probe="w8a8_cross_parts", device=label, B=b, R=r, T=T, pitch=PITCH,
                    regime=plan.regime, cluster=plan.cluster, row_tile=plan.row_tile,
                    variant=n, ms=sum(ms[n]) / 2, ms_turns=ms[n])))
            del sets
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
