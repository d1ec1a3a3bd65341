"""Whisper parameters for the port: conversion from the reference's
parameter tree, the .npz checkpoint loader, and seeded random weights.

The tree is the reference's (spittle_tpu/models/whisper/model.py module
docstring): {"encoder": {conv1_w [D, n_mels, 3], conv1_b, conv2_w,
conv2_b, blocks {stacked [L, ...] leaves}, ln_g, ln_b}, "decoder":
{tok_emb [V, D], pos_emb [n_ctx, D], blocks {...}, ln_g, ln_b}}, with
torch tensors as leaves.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from spittle_tpu_torch.ops.quant import out_major

from .config import WhisperConfig

Params = Dict[str, Any]


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: exact via f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16
        )
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_jax(tree: Any, device="cpu") -> Params:
    """The reference's parameter tree (numpy or jax arrays as leaves) ->
    the port's tensors, same nesting and dtypes. W8A8 dicts {"qw8",
    "scale"} keep their values; the int8 tensor is stored out-major, the
    operand order the W8A8 kernel reads."""
    if isinstance(tree, dict):
        out = {k: params_from_jax(v, device) for k, v in tree.items()}
        if "qw8" in out:
            out["qw8"] = out_major(out["qw8"])
        return out
    return _to_tensor(tree, device)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """The engine's cast rule: layer-norm gains and biases (keys ending in
    ln_g / ln_b) stay f32; every other f32 leaf goes to `dtype`."""
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key.endswith(("ln_g", "ln_b")) or node.dtype != torch.float32:
            return node
        return node.to(dtype)

    return walk(params)


def load_npz_checkpoint(path: str, dtype=np.float32):
    """spittle-native .npz (the reference's save_npz_checkpoint format) ->
    (cfg, params as numpy arrays, extras). Float leaves are cast to
    `dtype`; extras holds the "vocab" byte strings when present."""
    with np.load(path) as z:
        cfg = WhisperConfig(**json.loads(bytes(z["__config__"]).decode()))
        params: Params = {}
        for key in z.files:
            if not key.startswith("param:"):
                continue
            node = params
            parts = key[len("param:"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = z[key]
            node[parts[-1]] = arr.astype(dtype) if arr.dtype.kind == "f" else arr
        extras: Dict[str, Any] = {}
        if "__vocab__" in z.files:
            table = json.loads(bytes(z["__vocab__"]).decode())
            extras["vocab"] = [t.encode("latin1") for t in table]
    return cfg, params, extras


def random_params(cfg: WhisperConfig, seed: int = 0, dtype=torch.float32,
                  device="cpu") -> Params:
    """Random-normal weights at the reference's init_params scales, drawn
    from numpy's default_rng(seed) leaf by leaf (the reference draws from
    jax.random, which numpy cannot reproduce: the same seed gives other
    numbers). Layer norms are ones/zeros in f32, biases and pos_emb zeros,
    everything else `dtype` on `device`."""
    rng = np.random.default_rng(seed)
    d = cfg.n_audio_state

    def w(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones32(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def stack(layers, cross):
        mlp_d = 4 * d
        scale = d ** -0.5
        blocks = {
            "attn_ln_g": ones32((layers, d)),
            "attn_ln_b": zeros((layers, d), torch.float32),
            "wq": w((layers, d, d), scale),
            "wk": w((layers, d, d), scale),
            "wv": w((layers, d, d), scale),
            "wo": w((layers, d, d), scale),
            "bq": zeros((layers, d)),
            "bv": zeros((layers, d)),
            "bo": zeros((layers, d)),
            "mlp_ln_g": ones32((layers, d)),
            "mlp_ln_b": zeros((layers, d), torch.float32),
            "fc1_w": w((layers, d, mlp_d), scale),
            "fc1_b": zeros((layers, mlp_d)),
            "fc2_w": w((layers, mlp_d, d), (2 * mlp_d) ** -0.5),
            "fc2_b": zeros((layers, d)),
        }
        if cross:
            blocks.update({
                "cross_ln_g": ones32((layers, d)),
                "cross_ln_b": zeros((layers, d), torch.float32),
                "cross_wq": w((layers, d, d), scale),
                "cross_wk": w((layers, d, d), scale),
                "cross_wv": w((layers, d, d), scale),
                "cross_wo": w((layers, d, d), scale),
                "cross_bq": zeros((layers, d)),
                "cross_bv": zeros((layers, d)),
                "cross_bo": zeros((layers, d)),
            })
        return blocks

    encoder = {
        "conv1_w": w((d, cfg.n_mels, 3), (3 * cfg.n_mels) ** -0.5),
        "conv1_b": zeros((d,)),
        "conv2_w": w((d, d, 3), (3 * d) ** -0.5),
        "conv2_b": zeros((d,)),
        "blocks": stack(cfg.n_audio_layer, False),
        "ln_g": ones32((d,)),
        "ln_b": zeros((d,), torch.float32),
    }
    decoder = {
        "tok_emb": w((cfg.n_vocab, d), d ** -0.5),
        "pos_emb": zeros((cfg.n_text_ctx, d)),
        "blocks": stack(cfg.n_text_layer, True),
        "ln_g": ones32((d,)),
        "ln_b": zeros((d,), torch.float32),
    }
    return {"encoder": encoder, "decoder": decoder}
