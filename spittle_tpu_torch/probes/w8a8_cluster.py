"""Probe: K14's plan (csrc/decode_cross_attention_w8a8.cu, ops/attention.py:
w8a8_plan) against other cluster sizes and row tiles, on the card.

At large-v3's decoder shapes (H 20, Dh 64, T 1500 on rows of 1504 bytes,
bf16 q): B 8 at R 1, 4, 8 and 228 and B 56 at R 1 and 228, it runs K14
under its own plan and under every other cluster size (1, 2, 4, 8; the
slice follows) and, on the tensor-core regime, every row tile (16, 32,
64); at up to 8 rows also on the tensor-core regime in a tile of 16 rows,
and past 8 rows also on __dp4a in row tiles of 8 (the regime Dh 8 takes);
and at B 1, T 45000 (rows of 45008 bytes) at R 1 and 228, where K and V
are streamed from global memory, under its plan and the other clusters
that fit. It holds each output to the plain version on CPU copies at K14's tolerance
(one bf16 ulp plus one P code per row, at most 1% of rows past one ulp),
and times each as device ms per launch from a CUDA graph of launches
over input sets whose sum exceeds the 50 MB L2 twice, in turns forward
then backward (the mean of the two). Prints one JSON line per shape and
plan, with the card's name and power limit.

    python -m spittle_tpu_torch.probes.w8a8_cluster [BxR[xT] ...]

(arguments such as 8x228 56x228 1x1x45000 take those shapes alone; T
1500 where it is not given, the rows padded to a multiple of 16 bytes).

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import json
import sys

import torch

from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import quantize_kv_w8a8

from ._timing import device_label, graph_ms

H, DH, SEED, ITERS = 20, 64, 0, 40
SHAPES = ((8, 1, 1500), (8, 4, 1500), (8, 8, 1500), (8, 228, 1500), (56, 1, 1500),
          (56, 228, 1500), (1, 1, 45000), (1, 228, 45000))


def _pitch(t: int) -> int:
    return -(-t // 16) * 16


def _inputs(gen, b, r, t, dev):
    def padded(x):
        out = torch.empty(x.shape[:-1] + (_pitch(t),), dtype=x.dtype, device=dev)
        out[..., :t] = x
        return out[..., :t]

    kv = [quantize_kv_w8a8(torch.randn((b, H, DH, t), generator=gen, device=dev))
          for _ in range(2)]
    q = (torch.randn((b, H, r, DH), generator=gen, device=dev) * DH ** -0.5).to(
        torch.bfloat16)
    return q, padded(kv[0]["qw8"]), kv[0]["scale"], padded(kv[1]["qw8"]), kv[1]["scale"]


def plans(r: int, t: int):
    """K14's own plan first, then the others of its regime."""
    own = att.w8a8_plan(t, r, DH)
    out = [own]
    tiles = (16, 32, 64) if own.mma else (own.row_tile,)
    for cluster in (1, 2, 4, 8):
        for rt in tiles:
            gran = 32 if own.mma else 16
            slice_ = -(-(-(-t // cluster)) // gran) * gran
            smem = att.w8a8_smem_bytes(own.mma, slice_, rt, DH, cluster, own.stream)
            p = att.W8A8Plan(own.mma, cluster, slice_, rt, smem, own.stream)
            if p not in out and smem <= att.W8A8_SMEM_BUDGET:
                out.append(p)
    if own.stream:
        return out
    if not own.mma:  # the tensor-core regime at a step's rows: a tile of 16
        for cluster in (4, 8):
            slice_ = -(-(-(-t // cluster)) // 32) * 32
            out.append(att.W8A8Plan(True, cluster, slice_, 16, att.w8a8_smem_bytes(
                True, slice_, 16, DH, cluster)))
    else:  # __dp4a past 8 rows: row tiles of 8
        for cluster in (4, 8):
            slice_ = -(-(-(-t // cluster)) // 16) * 16
            out.append(att.W8A8Plan(False, cluster, slice_, 8, att.w8a8_smem_bytes(
                False, slice_, 8, DH, cluster)))
    return out


def _close(got, args) -> bool:
    cpu = [a.cpu() for a in args]
    want = att.decode_cross_attention_w8a8_plain(*cpu)
    step = att.w8a8_code_step(*cpu)
    err = (got.cpu().float() - want.float()).abs()
    excess = (err - (2.0 ** -7 * want.float().abs() + 1e-5)).amax(dim=-1)
    return (excess - 1.001 * step).max().item() <= 0 and (excess > 0).float().mean() <= 0.01


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("w8a8_cluster: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    shapes = tuple((tuple(map(int, a.split("x"))) + (1500,))[:3] for a in sys.argv[1:])
    for b, r, t in shapes or SHAPES:
        set_bytes = 2 * b * H * DH * t
        sets = [_inputs(gen, b, r, t, dev) for _ in range(1 + int(100e6 // set_bytes))]
        ps = plans(r, t)
        fns = {p: [lambda a=a, p=p: att._launch_w8a8(*a, t, p) for a in sets] for p in ps}
        ok = {p: _close(att._launch_w8a8(*sets[0], t, p), sets[0]) for p in ps}
        ms = {p: [] for p in ps}
        for order in (ps, ps[::-1]):
            for p in order:
                ms[p].append(graph_ms(fns[p], ITERS))
        for i, p in enumerate(ps):
            print(json.dumps(dict(
                probe="w8a8_cluster", device=label, B=b, R=r, T=t, pitch=_pitch(t),
                own_plan=i == 0, regime=p.regime, cluster=p.cluster, slice=p.slice,
                row_tile=p.row_tile, smem=p.smem, close_to_plain=bool(ok[p]),
                ms=sum(ms[p]) / 2, ms_turns=ms[p])))
        del sets, fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
