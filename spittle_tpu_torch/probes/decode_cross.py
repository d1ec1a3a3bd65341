"""Probe: one layer's decode-time cross-attention at large-v3 shape, over
its variants (the port's counterpart of scripts/bench_decode_cross.py).

Per decode step the decoder reads every layer's [B, H, Dh, T] cross K and
V, the step's dominant memory traffic. This times one layer (B 16, H 20,
Dh 64, T 1536 with kv_len 1500, one query row) across:

  plain-bf16   the model's plain path (ops.attention
               decode_cross_attention_plain)
  k4-bf16      decode_cross_attention (K4): the bf16 instance of K11's
               kernel, items of (batch item, head pair, 64 positions)
  plain-int8   the plain path over int8 K/V (decode_cross_attention_q8_plain)
  k3-int8      decode_cross_attention_q8 (K3): K11's kernel and entry
  k11-int8-mh  decode_cross_attention_q8_mh (K11): K3's function over a
               batch item's K/V as one [H*64, T] slab, a persistent grid
               of one block per SM over (batch item, head pair, 128
               positions), each pair's K and V rows one TMA box each (T
               1536 is a multiple of 16) into a ring fed by a producer warp

Every variant runs N_ITER calls between CUDA events; the K/V of one call
(126 MB bf16, 63 MB int8) exceed the 50 MB L2, so each call reads device
memory. Prints one JSON line per variant, with the time and the K/V
bytes over it, then K11's largest difference from K3's plain version
beside that version's largest output.

    python -m spittle_tpu_torch.probes.decode_cross

runs on the card and raises without one; main(device="cpu", ...) at a
small shape exercises the same code through the plain versions and
reports a host clock under "host_ms".
"""

from __future__ import annotations

import json
from typing import List

import torch

from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import quantize_kv

from ._timing import device_label, time_key, timed_ms

B, H, DH, T, KV_LEN = 16, 20, 64, 1536, 1500
ROWS = 1
N_ITER = 30
SEED = 0


def make_inputs(dev, b=B, h=H, t=T, rows=ROWS, seed=SEED):
    """q [b, h, rows, 64] pre-scaled by Dh^-0.5, bf16 K/V [b, h, 64, t] and
    their int8 forms, from a seeded generator on `dev`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = torch.bfloat16
    q = (torch.randn((b, h, rows, DH), generator=gen, device=dev)
         * DH ** -0.5).to(dtype)
    k = torch.randn((b, h, DH, t), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, h, DH, t), generator=gen, device=dev).to(dtype)
    return q, k, v, quantize_kv(k), quantize_kv(v)


def variants(q, k, v, qk, qv, kv_len):
    """name -> (callable, K/V bytes one call reads)."""
    b, h, d, t = k.shape
    bytes_bf16 = 2 * b * h * d * t * 2
    bytes_int8 = 2 * b * h * d * t
    q8 = (q, qk["qw"], qk["scale"], qv["qw"], qv["scale"])
    return {
        "plain-bf16": (lambda: att.decode_cross_attention_plain(
            q, k, v, kv_len), bytes_bf16),
        "k4-bf16": (lambda: att.decode_cross_attention(q, k, v, kv_len),
                    bytes_bf16),
        "plain-int8": (lambda: att.decode_cross_attention_q8_plain(
            *q8, kv_len), bytes_int8),
        "k3-int8": (lambda: att.decode_cross_attention_q8(*q8, kv_len),
                    bytes_int8),
        "k11-int8-mh": (lambda: att.decode_cross_attention_q8_mh(
            *q8, kv_len), bytes_int8),
    }


def main(device="cuda", b=B, h=H, t=T, kv_len=KV_LEN, rows=ROWS,
         n_iter=N_ITER, out=print) -> List[dict]:
    dev = resolve_device(device)
    label = device_label(dev)
    q, k, v, qk, qv = make_inputs(dev, b, h, t, rows)
    results = []
    with torch.inference_mode():
        runs = variants(q, k, v, qk, qv, kv_len)
        for name, (fn, nbytes) in runs.items():
            ms = timed_ms(fn, dev, n_iter)
            rec = {"variant": name, time_key(dev): ms, "device": label}
            if dev.type == "cuda":
                rec["eff_GBps"] = nbytes / ms / 1e6
            results.append(rec)
            out(json.dumps(rec))
        got = runs["k11-int8-mh"][0]().float()
        want = runs["plain-int8"][0]().float()
        rec = {"k11_vs_plain_int8_maxerr": (got - want).abs().max().item(),
               "plain_int8_max": want.abs().max().item(), "device": label}
    results.append(rec)
    out(json.dumps(rec))
    return results


if __name__ == "__main__":
    main()
