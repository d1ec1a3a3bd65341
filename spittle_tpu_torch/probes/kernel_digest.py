"""Probe: digests of the outputs of K1, K2, K3, K4, K5, K6, K8 and K11 at
the shapes chip_smoke.py and the card tests hold them at, so that two
trees of the port can be compared bit for bit on one card (K3 and K11
call one entry since K3 moved onto K11's kernel, so K3 is compared with
an older tree's K11). K6's cases (contiguous packed int4 rows) record the
bits of its instance of that kernel, whose 128-position items round P
against other chunk maxima than the split-T kernel's 256-position blocks
did in older trees.

Inputs come from a seeded generator on the card, re-seeded per shape, so
every tree draws the same ones. Prints one JSON line per kernel and shape
with the sha256 of the output's bytes. To compare a tree with another
checkout of the port at <tree>, run this file by path (not with -m), so
that the package comes from PYTHONPATH:

    PYTHONPATH=<tree> python spittle_tpu_torch/probes/kernel_digest.py

It calls only wrappers whose names and arguments have not changed since
the port's first slices, so it runs against older trees too. Runs only on
a card (it raises without one).
"""

from __future__ import annotations

import hashlib
import json

import torch

from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import (
    quantize_kv,
    quantize_kv_int4,
    quantize_weight_w8a8,
)
from spittle_tpu_torch.ops.w8a8_gemm import w8a8_gemm

H, D, SEED = 20, 64, 0
# K4 (B, R, Tk, kv_len): the main path's decode step and prefills, the
# reduced context's Tk 256, an odd Tk, and the long window's Tk 6000.
K4_SHAPES = ((8, 1, 1500, 1500), (8, 3, 1500, 1500), (8, 4, 1500, 1500),
             (8, 1, 256, 256), (8, 3, 256, 256), (8, 1, 255, 255),
             (8, 3, 255, 201), (2, 1, 6000, 6000), (2, 3, 6000, 6000),
             (2, 8, 6000, 6000))
# K3 and K6 (B, R, Tk, kv_len): the decode step, the prefills, bench.py's
# large-v3 batch.
QUANT_SHAPES = ((8, 1, 1500, 1500), (8, 3, 1500, 1500), (8, 4, 1500, 1500),
                (56, 1, 1500, 1500))
# K1 (heads as views of packed projections) and K8 (packed) (B, T,
# kv_len, causal); K5 (B, T, kv_len, causal) on contiguous heads.
FULLKV_SHAPES = ((8, 1500, 1500, False), (8, 1500, 1300, False),
                 (8, 1500, 1500, True), (8, 256, 256, False))
FLASH_SHAPES = ((2, 6000, 6000, False), (2, 6000, 5000, False),
                (2, 6000, 6000, True))
# K2 (M, K, N, bias, act, out_scale, dtype): one encoder layer's six GEMMs
# at chip_smoke's M = 8 * 1500 and the reduced context's 8 * 256, then the
# card tests' ragged shapes in both dtypes.
_LAYER = ((1280, 1280, True, "none", D ** -0.25), (1280, 1280, False, "none", D ** -0.25),
          (1280, 1280, True, "none", 1.0), (1280, 1280, True, "none", 1.0),
          (1280, 5120, True, "gelu", 1.0), (5120, 1280, True, "none", 1.0))
GEMM_SHAPES = tuple((m, *g, "bf16") for m in (12000, 2048) for g in _LAYER) + tuple(
    (m, k, n, bias, act, 0.125 ** 0.5 if bias else 1.0, dt)
    for m in (1, 127, 129) for (k, n, bias, act) in (
        (1280, 384, True, "gelu"), (1280, 1280, False, "none"),
        (1280, 5120, True, "gelu"), (5120, 1280, True, "none"))
    for dt in ("bf16", "f32"))


def _digest(x: torch.Tensor) -> str:
    x = x.contiguous()
    torch.cuda.synchronize()
    return hashlib.sha256(x.view(torch.int16).cpu().numpy().tobytes()).hexdigest()


def _cases(dev, gen):
    """(kernel, shape, thunk) for every case, inputs drawn on call."""
    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    for b, r, tk, kv_len in K4_SHAPES:
        def k4(b=b, r=r, tk=tk, kv_len=kv_len):
            q = randn((b, H, r, D), D ** -0.5)
            k, v = randn((b, H, D, tk)), randn((b, H, D, tk))
            return att.decode_cross_attention(q, k, v, kv_len=kv_len)
        yield "K4", [b, r, tk, kv_len], k4
    for name, quant, fn in (("K3", quantize_kv, att.decode_cross_attention_q8),
                            ("K11", quantize_kv, att.decode_cross_attention_q8_mh),
                            ("K6", quantize_kv_int4, att.decode_cross_attention_q4)):
        for b, r, tk, kv_len in QUANT_SHAPES:
            def kq(b=b, r=r, tk=tk, kv_len=kv_len, quant=quant, fn=fn):
                q = randn((b, H, r, D), D ** -0.5)
                qk, qv = (quant(torch.randn((b, H, D, tk), generator=gen, device=dev))
                          for _ in range(2))
                key = "qw" if "qw" in qk else "qw4"
                return fn(q, qk[key], qk["scale"], qv[key], qv["scale"], kv_len=kv_len)
            yield name, [b, r, tk, kv_len], kq
    for b, t, kv_len, causal in FULLKV_SHAPES:
        def k1(b=b, t=t, kv_len=kv_len, causal=causal):
            qkv = [randn((b, t, H * D), D ** -0.25) for _ in range(3)]
            return att.flash_attention_fullkv(
                *(x.view(b, t, H, D).permute(0, 2, 1, 3) for x in qkv),
                causal=causal, kv_len=kv_len)

        def k8(b=b, t=t, kv_len=kv_len, causal=causal):
            qkv = [randn((b, t, H * D), D ** -0.25) for _ in range(3)]
            return att.flash_attention_fullkv_packed(*qkv, H, causal=causal,
                                                     kv_len=kv_len)
        yield "K1", [b, t, kv_len, causal], k1
        yield "K8", [b, t, kv_len, causal], k8
    for b, t, kv_len, causal in FLASH_SHAPES:
        def k5(b=b, t=t, kv_len=kv_len, causal=causal):
            q, k, v = (randn((b, H, t, D), D ** -0.25) for _ in range(3))
            return att.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        yield "K5", [b, t, kv_len, causal], k5
    for m, k, n, bias, act, scale, dt in GEMM_SHAPES:
        def k2(m=m, k=k, n=n, bias=bias, act=act, scale=scale, dt=dt):
            x, qw, b = k2_inputs(gen, dev, m, k, n, dt, bias)
            return w8a8_gemm(x, qw["qw8"], qw["scale"], bias=b, act=act,
                             out_scale=scale)
        yield "K2", [m, k, n, bias, act, round(scale, 4), dt], k2


def k2_inputs(gen, dev, m, k, n, dt, bias):
    """K2's operands of a digest case: x [m, k] of dt ("bf16" or "f32"),
    the weight quantized as the encoder's, the bias of dt or None."""
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    qw = quantize_weight_w8a8(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
    b = (torch.randn((n,), generator=gen, device=dev) * 0.1).to(dtype)
    return x, qw, b if bias else None


def main(out=print):
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_digest: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    records = []
    for kernel, shape, run in _cases(dev, gen):
        gen.manual_seed(SEED)
        rec = {"kernel": kernel, "shape": shape, "sha256": _digest(run())}
        records.append(rec)
        out(json.dumps(rec))
        torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
