"""Parakeet FastConformer encoder weight loading (HF name map; the port's
copy of spittle_tpu/models/parakeet/weights.py, numpy only).

Maps a torch ParakeetEncoder / ParakeetForCTC state_dict (the names
transformers uses for NVIDIA's NeMo checkpoints) into the stacked-layer
tree: linear weights transpose [out, in] -> [in, out]; per-layer tensors
stack on a leading [L] axis; the conv module's BatchNorm running stats
come along for eval-mode parity. The engine turns the numpy tree into
tensors (models.whisper.weights.params_from_jax).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .config import ParakeetConfig

Params = Dict[str, Any]


def _stack(t: Mapping[str, np.ndarray], fmt: str, n: int,
           transpose: bool = False, squeeze: int | None = None) -> np.ndarray:
    arrs = []
    for i in range(n):
        a = np.asarray(t[fmt.format(i)])
        if squeeze is not None:
            a = np.squeeze(a, axis=squeeze)
        arrs.append(a.T if transpose else a)
    return np.stack(arrs)


def config_from_hf_ctc_tensors(tensors: Mapping[str, np.ndarray]) -> ParakeetConfig:
    """Infer a ParakeetConfig from a ParakeetForCTC state_dict's shapes.

    Every dimension is recoverable: n_heads from bias_u's shape, n_mels
    from the subsampling linear's input width, conv kernel from the
    depthwise conv. vocab_size excludes the blank (NeMo convention:
    blank = last CTC id)."""
    t = tensors
    d = int(np.asarray(t["encoder.layers.0.self_attn.q_proj.weight"]).shape[0])
    n_heads = int(np.asarray(t["encoder.layers.0.self_attn.bias_u"]).shape[0])
    ff = int(np.asarray(
        t["encoder.layers.0.feed_forward1.linear1.weight"]).shape[0])
    ch = int(np.asarray(t["encoder.subsampling.layers.0.weight"]).shape[0])
    lin_in = int(np.asarray(t["encoder.subsampling.linear.weight"]).shape[1])
    n_mels = lin_in // ch * 8
    kernel = int(np.asarray(
        t["encoder.layers.0.conv.depthwise_conv.weight"]).shape[-1])
    n_layers = sum(
        1 for k in t
        if k.startswith("encoder.layers.") and k.endswith(".norm_out.weight")
    )
    vocab_with_blank = int(np.asarray(t["ctc_head.weight"]).shape[0])
    return ParakeetConfig(
        name="parakeet-ctc", n_mels=n_mels, d_model=d, n_layers=n_layers,
        n_heads=n_heads, ff_mult=max(ff // d, 1), conv_kernel=kernel,
        subsampling_channels=ch, vocab_size=vocab_with_blank - 1,
    )


def params_from_hf_ctc_tensors(
    tensors: Mapping[str, np.ndarray], cfg: ParakeetConfig
) -> Params:
    """ParakeetForCTC state_dict -> {subsampling, blocks, ctc_w, ctc_b}."""
    tree = encoder_params_from_hf_tensors(tensors, cfg, prefix="encoder.")
    # ctc_head is Conv1d(d, vocab, k=1): weight [vocab, d, 1] -> [d, vocab].
    tree["ctc_w"] = np.squeeze(np.asarray(tensors["ctc_head.weight"]), -1).T
    tree["ctc_b"] = np.asarray(tensors["ctc_head.bias"])
    return tree


def encoder_params_from_hf_tensors(
    tensors: Mapping[str, np.ndarray],
    cfg: ParakeetConfig,
    prefix: str = "",
) -> Params:
    """HF ParakeetEncoder state_dict -> our {subsampling, blocks} subtree.

    prefix: "" for a bare ParakeetEncoder, "encoder." for ParakeetForCTC.
    """
    t = {k[len(prefix):]: v for k, v in tensors.items() if k.startswith(prefix)}
    n = cfg.n_layers
    sub = {
        "conv0_w": np.asarray(t["subsampling.layers.0.weight"]),
        "conv0_b": np.asarray(t["subsampling.layers.0.bias"]),
        "dw1_w": np.asarray(t["subsampling.layers.2.weight"]),
        "dw1_b": np.asarray(t["subsampling.layers.2.bias"]),
        "pw1_w": np.asarray(t["subsampling.layers.3.weight"]),
        "pw1_b": np.asarray(t["subsampling.layers.3.bias"]),
        "dw2_w": np.asarray(t["subsampling.layers.5.weight"]),
        "dw2_b": np.asarray(t["subsampling.layers.5.bias"]),
        "pw2_w": np.asarray(t["subsampling.layers.6.weight"]),
        "pw2_b": np.asarray(t["subsampling.layers.6.bias"]),
        "proj_w": np.asarray(t["subsampling.linear.weight"]).T,
        "proj_b": np.asarray(t["subsampling.linear.bias"]),
    }
    p = "layers.{}."
    blocks = {
        "ff1_ln_g": _stack(t, p + "norm_feed_forward1.weight", n),
        "ff1_ln_b": _stack(t, p + "norm_feed_forward1.bias", n),
        "ff1_w1": _stack(t, p + "feed_forward1.linear1.weight", n, transpose=True),
        "ff1_b1": _stack(t, p + "feed_forward1.linear1.bias", n),
        "ff1_w2": _stack(t, p + "feed_forward1.linear2.weight", n, transpose=True),
        "ff1_b2": _stack(t, p + "feed_forward1.linear2.bias", n),
        "attn_ln_g": _stack(t, p + "norm_self_att.weight", n),
        "attn_ln_b": _stack(t, p + "norm_self_att.bias", n),
        "wq": _stack(t, p + "self_attn.q_proj.weight", n, transpose=True),
        "bq": _stack(t, p + "self_attn.q_proj.bias", n),
        "wk": _stack(t, p + "self_attn.k_proj.weight", n, transpose=True),
        "bk": _stack(t, p + "self_attn.k_proj.bias", n),
        "wv": _stack(t, p + "self_attn.v_proj.weight", n, transpose=True),
        "bv": _stack(t, p + "self_attn.v_proj.bias", n),
        "wo": _stack(t, p + "self_attn.o_proj.weight", n, transpose=True),
        "bo": _stack(t, p + "self_attn.o_proj.bias", n),
        "wpos": _stack(t, p + "self_attn.relative_k_proj.weight", n, transpose=True),
        "pos_bias_u": _stack(t, p + "self_attn.bias_u", n),
        "pos_bias_v": _stack(t, p + "self_attn.bias_v", n),
        "conv_ln_g": _stack(t, p + "norm_conv.weight", n),
        "conv_ln_b": _stack(t, p + "norm_conv.bias", n),
        "conv_pw1_w": _stack(t, p + "conv.pointwise_conv1.weight", n,
                             transpose=True, squeeze=-1),
        "conv_pw1_b": _stack(t, p + "conv.pointwise_conv1.bias", n),
        "conv_dw_w": _stack(t, p + "conv.depthwise_conv.weight", n, squeeze=1),
        "conv_dw_b": _stack(t, p + "conv.depthwise_conv.bias", n),
        "conv_bn_g": _stack(t, p + "conv.norm.weight", n),
        "conv_bn_b": _stack(t, p + "conv.norm.bias", n),
        "conv_bn_mean": _stack(t, p + "conv.norm.running_mean", n),
        "conv_bn_var": _stack(t, p + "conv.norm.running_var", n),
        "conv_pw2_w": _stack(t, p + "conv.pointwise_conv2.weight", n,
                             transpose=True, squeeze=-1),
        "conv_pw2_b": _stack(t, p + "conv.pointwise_conv2.bias", n),
        "ff2_ln_g": _stack(t, p + "norm_feed_forward2.weight", n),
        "ff2_ln_b": _stack(t, p + "norm_feed_forward2.bias", n),
        "ff2_w1": _stack(t, p + "feed_forward2.linear1.weight", n, transpose=True),
        "ff2_b1": _stack(t, p + "feed_forward2.linear1.bias", n),
        "ff2_w2": _stack(t, p + "feed_forward2.linear2.weight", n, transpose=True),
        "ff2_b2": _stack(t, p + "feed_forward2.linear2.bias", n),
        "final_ln_g": _stack(t, p + "norm_out.weight", n),
        "final_ln_b": _stack(t, p + "norm_out.bias", n),
    }
    return {"subsampling": sub, "blocks": blocks}


def unflatten(tensors: Mapping[str, np.ndarray], sep: str = "/") -> Params:
    """Flat {"a/b/c": array} -> nested {"a": {"b": {"c": array}}}."""
    tree: Params = {}
    for name, arr in tensors.items():
        node = tree
        parts = name.split(sep)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arr)
    return tree


def config_from_tree(tree: Params, name: str) -> ParakeetConfig:
    """A ParakeetConfig from the shapes of a full TDT tree in the stacked
    layout (init_params' keys)."""
    sub, blk = tree["subsampling"], tree["blocks"]
    n_layers, d, ff = np.shape(blk["ff1_w1"])
    ch = np.shape(sub["conv0_w"])[0]
    ph = np.shape(tree["decoder"]["lstm_w"])[0]
    return ParakeetConfig(
        name=name, n_mels=np.shape(sub["proj_w"])[0] // ch * 8, d_model=d,
        n_layers=n_layers, n_heads=np.shape(blk["pos_bias_u"])[1],
        ff_mult=max(ff // d, 1), conv_kernel=np.shape(blk["conv_dw_w"])[-1],
        subsampling_channels=ch, pred_hidden=ph,
        joint_hidden=np.shape(tree["joint"]["enc_w"])[1],
        vocab_size=np.shape(tree["decoder"]["embed"])[0] - 1,
        durations=np.shape(tree["joint"]["dur_w"])[1],
    )
