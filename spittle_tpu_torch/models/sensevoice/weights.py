"""FunASR SenseVoiceSmall state_dict -> the stacked-layer tree (the port's
copy of spittle_tpu/models/sensevoice/weights.py, numpy only).

Maps the released checkpoint names (model.pt / model.safetensors from
iic/SenseVoiceSmall; the same graph transcribe-rs runs as int8 ONNX,
`transcription.rs:321-339`):

  embed.weight                               -> embed  [16, 560]
  encoder.encoders0.0.*                      -> enc0 (560 -> 512 block)
  encoder.encoders.{i}.*                     -> blocks (stacked)
  encoder.tp_encoders.{i}.*                  -> tp_blocks (stacked)
  encoder.after_norm / encoder.tp_norm       -> after_ln / tp_ln
  ctc.ctc_lo.*                               -> ctc head

Per-layer names: self_attn.linear_q_k_v (fused), self_attn.fsmn_block
(depthwise conv, no bias), self_attn.linear_out, feed_forward.w_1/w_2,
norm1/norm2. Linear weights transpose [out,in] -> [in,out]; stacked
layers gain a leading [L] axis.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .model import SenseVoiceConfig

Params = Dict[str, Any]


def config_from_funasr_tensors(
    tensors: Mapping[str, np.ndarray]
) -> SenseVoiceConfig:
    t = tensors
    in_dim = int(np.asarray(
        t["encoder.encoders0.0.self_attn.linear_q_k_v.weight"]).shape[1])
    d = int(np.asarray(
        t["encoder.encoders0.0.self_attn.linear_out.weight"]).shape[0])
    ff = int(np.asarray(
        t["encoder.encoders0.0.feed_forward.w_1.weight"]).shape[0])
    kernel = int(np.asarray(
        t["encoder.encoders0.0.self_attn.fsmn_block.weight"]).shape[-1])
    n_rest = sum(
        1 for k in t
        if k.startswith("encoder.encoders.") and k.endswith(".norm1.weight")
    )
    tp = sum(
        1 for k in t
        if k.startswith("encoder.tp_encoders.") and k.endswith(".norm1.weight")
    )
    vocab = int(np.asarray(t["ctc.ctc_lo.weight"]).shape[0])
    # LFR width / mel split: FunASR small is 80 mel x 7 stacked = 560.
    lfr_m = 7
    n_mels = in_dim // lfr_m
    return SenseVoiceConfig(
        name="sense-voice-small", n_mels=n_mels, lfr_m=lfr_m,
        d_model=d, ff_dim=ff, n_blocks=n_rest + 1, tp_blocks=tp,
        fsmn_kernel=kernel, vocab_size=vocab,
    )


def _layer(t: Mapping[str, np.ndarray], prefix: str) -> Params:
    def a(name):
        return np.asarray(t[prefix + name])

    return {
        "ln1_g": a("norm1.weight"), "ln1_b": a("norm1.bias"),
        "wqkv": a("self_attn.linear_q_k_v.weight").T,
        "bqkv": a("self_attn.linear_q_k_v.bias"),
        "fsmn_w": np.squeeze(a("self_attn.fsmn_block.weight"), 1),
        "wo": a("self_attn.linear_out.weight").T,
        "bo": a("self_attn.linear_out.bias"),
        "ln2_g": a("norm2.weight"), "ln2_b": a("norm2.bias"),
        "ff_w1": a("feed_forward.w_1.weight").T,
        "ff_b1": a("feed_forward.w_1.bias"),
        "ff_w2": a("feed_forward.w_2.weight").T,
        "ff_b2": a("feed_forward.w_2.bias"),
    }


def _stack_layers(t, fmt: str, n: int) -> Params:
    layers = [_layer(t, fmt.format(i)) for i in range(n)]
    return {k: np.stack([lay[k] for lay in layers]) for k in layers[0]}


def params_from_funasr_tensors(
    tensors: Mapping[str, np.ndarray], cfg: SenseVoiceConfig
) -> Params:
    t = tensors
    return {
        "embed": np.asarray(t["embed.weight"]),
        "enc0": _layer(t, "encoder.encoders0.0."),
        "blocks": _stack_layers(t, "encoder.encoders.{}.", cfg.n_blocks - 1),
        "after_ln_g": np.asarray(t["encoder.after_norm.weight"]),
        "after_ln_b": np.asarray(t["encoder.after_norm.bias"]),
        "tp_blocks": _stack_layers(
            t, "encoder.tp_encoders.{}.", cfg.tp_blocks),
        "tp_ln_g": np.asarray(t["encoder.tp_norm.weight"]),
        "tp_ln_b": np.asarray(t["encoder.tp_norm.bias"]),
        "ctc_w": np.asarray(t["ctc.ctc_lo.weight"]).T,
        "ctc_b": np.asarray(t["ctc.ctc_lo.bias"]),
    }
