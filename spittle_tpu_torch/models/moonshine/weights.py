"""Moonshine HF-checkpoint loading (the port's copy of
spittle_tpu/models/moonshine/weights.py, numpy only).

Maps the HF MoonshineForConditionalGeneration state_dict
(UsefulSensors/moonshine-{tiny,base} safetensors) into the stacked-layer
tree: linear weights transpose from torch's [out, in] to [in, out],
per-layer tensors stack along a leading [L] axis.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .model import MoonshineConfig

Params = Dict[str, Any]

_ATTN = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}


def _stack(tensors: Mapping[str, np.ndarray], fmt: str, n: int,
           transpose: bool = False) -> np.ndarray:
    arrs = []
    for i in range(n):
        a = np.asarray(tensors[fmt.format(i)])
        arrs.append(a.T if transpose else a)
    return np.stack(arrs)


def params_from_hf_tensors(
    tensors: Mapping[str, np.ndarray], cfg: MoonshineConfig
) -> Params:
    """HF MoonshineForConditionalGeneration state_dict -> our tree."""
    t = tensors

    def enc_blocks() -> Params:
        n = cfg.enc_layers
        p = "model.encoder.layers.{}."
        blocks = {
            "ln1_g": _stack(t, p + "input_layernorm.weight", n),
            "ln2_g": _stack(t, p + "post_attention_layernorm.weight", n),
            "fc1_w": _stack(t, p + "mlp.fc1.weight", n, transpose=True),
            "fc1_b": _stack(t, p + "mlp.fc1.bias", n),
            "fc2_w": _stack(t, p + "mlp.fc2.weight", n, transpose=True),
            "fc2_b": _stack(t, p + "mlp.fc2.bias", n),
        }
        for ours, hf in _ATTN.items():
            blocks[ours] = _stack(
                t, p + f"self_attn.{hf}.weight", n, transpose=True
            )
        return blocks

    def dec_blocks() -> Params:
        n = cfg.dec_layers
        p = "model.decoder.layers.{}."
        blocks = {
            "ln1_g": _stack(t, p + "input_layernorm.weight", n),
            "ln2_g": _stack(t, p + "post_attention_layernorm.weight", n),
            "ln3_g": _stack(t, p + "final_layernorm.weight", n),
            "fc1_w": _stack(t, p + "mlp.fc1.weight", n, transpose=True),
            "fc1_b": _stack(t, p + "mlp.fc1.bias", n),
            "fc2_w": _stack(t, p + "mlp.fc2.weight", n, transpose=True),
            "fc2_b": _stack(t, p + "mlp.fc2.bias", n),
        }
        for ours, hf in _ATTN.items():
            blocks[ours] = _stack(
                t, p + f"self_attn.{hf}.weight", n, transpose=True
            )
            blocks["x" + ours] = _stack(
                t, p + f"encoder_attn.{hf}.weight", n, transpose=True
            )
        return blocks

    enc = {
        "conv1_w": np.asarray(t["model.encoder.conv1.weight"]),
        "conv2_w": np.asarray(t["model.encoder.conv2.weight"]),
        "conv2_b": np.asarray(t["model.encoder.conv2.bias"]),
        "conv3_w": np.asarray(t["model.encoder.conv3.weight"]),
        "conv3_b": np.asarray(t["model.encoder.conv3.bias"]),
        "gn_g": np.asarray(t["model.encoder.groupnorm.weight"]),
        "gn_b": np.asarray(t["model.encoder.groupnorm.bias"]),
        "blocks": enc_blocks(),
        "lnf_g": np.asarray(t["model.encoder.layer_norm.weight"]),
    }
    dec = {
        # Output projection is tied to the embedding in the pretrained
        # checkpoints; prefer proj_out if present (it defines the logits).
        "tok_emb": np.asarray(
            t.get("proj_out.weight", t["model.decoder.embed_tokens.weight"])
        ),
        "blocks": dec_blocks(),
        "norm_g": np.asarray(t["model.decoder.norm.weight"]),
    }
    return {"encoder": enc, "decoder": dec}


def config_from_hf_tensors(
    tensors: Mapping[str, np.ndarray], n_heads: int = 8
) -> MoonshineConfig:
    """Infer a MoonshineConfig from checkpoint shapes.

    n_heads can't be recovered from weight shapes; both published
    checkpoints (tiny, base) use 8.
    """
    d = int(np.asarray(tensors["model.encoder.conv1.weight"]).shape[0])
    vocab, _ = np.asarray(tensors["model.decoder.embed_tokens.weight"]).shape
    inter = int(
        np.asarray(tensors["model.encoder.layers.0.mlp.fc1.weight"]).shape[0]
    )
    enc_layers = sum(
        1 for k in tensors
        if k.startswith("model.encoder.layers.")
        and k.endswith(".input_layernorm.weight")
    )
    dec_layers = sum(
        1 for k in tensors
        if k.startswith("model.decoder.layers.")
        and k.endswith(".input_layernorm.weight")
    )
    name = "moonshine-tiny" if d == 288 else "moonshine-base"
    return MoonshineConfig(
        name=name, dim=d, enc_layers=enc_layers, dec_layers=dec_layers,
        n_heads=n_heads, intermediate=inter, vocab_size=int(vocab),
    )
