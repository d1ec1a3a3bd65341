"""HF flan-t5 tensors -> the stacked parameter tree (port of
spittle_tpu/models/t5/weights.py).

Maps a T5ForConditionalGeneration state_dict's names (as numpy arrays, or
a safetensors checkpoint directory read by the port's own reader, with no
safetensors package) into model.py's layout: per-layer weights stacked on
a leading [L] axis, [out, in] Linear weights transposed to [in, out], all
f32 on `device` (the card by default).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.models.whisper.weights import load_safetensors_dir

from .model import Params, T5Config


def params_from_hf_tensors(tensors: Dict[str, np.ndarray], cfg: T5Config,
                           device="cuda") -> Params:
    dev = resolve_device(device)
    t = {k: np.asarray(v, np.float32) for k, v in tensors.items()}
    n = cfg.num_layers

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        mats = [t[fmt.format(i)] for i in range(n)]
        return put(np.stack([m.T for m in mats] if transpose else mats))

    def blocks(side: str, cross: bool):
        attn = f"{side}.block.{{}}.layer.0.SelfAttention"
        ff_idx = 2 if cross else 1
        ff = f"{side}.block.{{}}.layer.{ff_idx}.DenseReluDense"
        out = {
            "attn_ln": stack(f"{side}.block.{{}}.layer.0.layer_norm.weight", False),
            "wq": stack(attn + ".q.weight"),
            "wk": stack(attn + ".k.weight"),
            "wv": stack(attn + ".v.weight"),
            "wo": stack(attn + ".o.weight"),
            "mlp_ln": stack(f"{side}.block.{{}}.layer.{ff_idx}.layer_norm.weight",
                            False),
            "wi0": stack(ff + ".wi_0.weight"),
            "wi1": stack(ff + ".wi_1.weight"),
            "wo_ff": stack(ff + ".wo.weight"),
        }
        if cross:
            cattn = f"{side}.block.{{}}.layer.1.EncDecAttention"
            out.update({
                "cross_ln": stack(f"{side}.block.{{}}.layer.1.layer_norm.weight",
                                  False),
                "cross_wq": stack(cattn + ".q.weight"),
                "cross_wk": stack(cattn + ".k.weight"),
                "cross_wv": stack(cattn + ".v.weight"),
                "cross_wo": stack(cattn + ".o.weight"),
            })
        return out

    shared = t["shared.weight"]
    # A tied-embedding checkpoint (the original T5) scales the shared table.
    lm_head = (t["lm_head.weight"].T if "lm_head.weight" in t
               else shared.T * np.float32(cfg.d_model ** -0.5))
    rel = ".block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    return {
        "shared_emb": put(shared),
        "lm_head": put(lm_head),
        "encoder": {
            "rel_bias": put(t["encoder" + rel]),
            "blocks": blocks("encoder", False),
            "ln": put(t["encoder.final_layer_norm.weight"]),
        },
        "decoder": {
            "rel_bias": put(t["decoder" + rel]),
            "blocks": blocks("decoder", True),
            "ln": put(t["decoder.final_layer_norm.weight"]),
        },
    }


def load_t5_dir(model_dir: str, cfg: Optional[T5Config] = None,
                device="cuda") -> Tuple[T5Config, Params]:
    """(cfg, params) from an HF checkpoint directory (*.safetensors and
    config.json; cfg, when given, takes the place of config.json)."""
    cfg_path = os.path.join(model_dir, "config.json")
    if cfg is None and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
        cfg = T5Config(
            vocab_size=hf["vocab_size"], d_model=hf["d_model"],
            d_kv=hf["d_kv"], d_ff=hf["d_ff"], num_layers=hf["num_layers"],
            num_heads=hf["num_heads"],
            rel_buckets=hf.get("relative_attention_num_buckets", 32),
            rel_max_distance=hf.get("relative_attention_max_distance", 128),
            eos_id=hf.get("eos_token_id", 1),
            pad_id=hf.get("pad_token_id", 0),
        )
    if cfg is None:
        raise FileNotFoundError(f"no config.json in {model_dir} and no cfg given")
    return cfg, params_from_hf_tensors(load_safetensors_dir(model_dir), cfg, device)
