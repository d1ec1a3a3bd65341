"""Probe: a digest of K4's outputs (decode_cross_attention) at the shapes
chip_smoke.py holds it at, so that two trees of the port can be compared
bit for bit on one card.

Inputs come from a seeded generator on the card, so every tree draws the
same ones. Prints one JSON line per shape with the sha256 of the output's
bytes. To compare a tree with another checkout of the port at <tree>, run
this file by path (not with -m), so that the package comes from PYTHONPATH:

    PYTHONPATH=<tree> python spittle_tpu_torch/probes/k4_digest.py

Runs only on a card (it raises without one).
"""

from __future__ import annotations

import hashlib
import json

import torch

from spittle_tpu_torch.ops import attention as att

H, D, SEED = 20, 64, 0
# (B, R, Tk, kv_len): the main path's decode step and prefills, the
# reduced context's Tk 256, an odd Tk, and the long window's Tk 6000.
SHAPES = ((8, 1, 1500, 1500), (8, 3, 1500, 1500), (8, 4, 1500, 1500),
          (8, 1, 256, 256), (8, 3, 256, 256), (8, 1, 255, 255),
          (8, 3, 255, 201), (2, 1, 6000, 6000), (2, 3, 6000, 6000),
          (2, 8, 6000, 6000))


def main(out=print):
    if not torch.cuda.is_available():
        raise RuntimeError("k4_digest: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    records = []
    for b, r, tk, kv_len in SHAPES:
        gen.manual_seed(SEED)
        q = (torch.randn((b, H, r, D), generator=gen, device=dev)
             * D ** -0.5).to(torch.bfloat16)
        k, v = (torch.randn((b, H, D, tk), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        got = att.decode_cross_attention(q, k, v, kv_len=kv_len).contiguous()
        torch.cuda.synchronize()
        digest = hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes())
        rec = {"shape": [b, r, tk, kv_len], "sha256": digest.hexdigest()}
        records.append(rec)
        out(json.dumps(rec))
    return records


if __name__ == "__main__":
    main()
