"""FastConformer encoder and TDT prediction / joint networks in PyTorch (port
of spittle_tpu/models/parakeet/model.py), plain ops in f32.

Encoder (FastConformer): three stride-2 convolutions (a full one, then
two depthwise-separable ones; 8x time reduction) -> linear to d_model ->
sqrt(d) xscaling -> N conformer blocks (half-FF -> relative-position MHSA
-> conv module (GLU, depthwise conv, eval-mode BatchNorm, swish) ->
half-FF -> the block's own LayerNorm). Relative positions follow
Transformer-XL (a shared position projection and the shift trick).
Attention is a plain product and an f32 softmax in the reference's order.

Decoder (TDT): an LSTM prediction network over emitted tokens; the joint
f(enc) + g(pred) -> relu -> vocab+blank logits and a duration head.

The parameter tree is the reference's (init_params), with torch tensors
as leaves; per-layer leaves are stacked on a leading [L] axis.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from spittle_tpu_torch.models._random import RandomDraw

from .config import ParakeetConfig

Params = Dict[str, Any]


def _norm(x, g, b):
    # Population variance, as jnp.var.
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * g + b


def random_params(cfg: ParakeetConfig, seed: int = 0, dtype=torch.float32,
                  device="cpu") -> Params:
    """Random weights at the reference's init_params scales and shapes
    (RandomDraw: a torch.Generator on `device`, seeded)."""
    r = RandomDraw(seed, device, dtype)
    d, L = cfg.d_model, cfg.n_layers
    ff = cfg.ff_mult * d
    ch = cfg.subsampling_channels
    dw_scale = 0.1

    def stack(shape, scale):
        return r.normal((L, *shape), scale)

    sub = {
        "conv0_w": r.normal((ch, 1, 3, 3), 0.2),
        "conv0_b": r.zeros((ch,)),
        "dw1_w": r.normal((ch, 1, 3, 3), dw_scale),
        "dw1_b": r.zeros((ch,)),
        "pw1_w": r.normal((ch, ch, 1, 1), ch**-0.5),
        "pw1_b": r.zeros((ch,)),
        "dw2_w": r.normal((ch, 1, 3, 3), dw_scale),
        "dw2_b": r.zeros((ch,)),
        "pw2_w": r.normal((ch, ch, 1, 1), ch**-0.5),
        "pw2_b": r.zeros((ch,)),
        "proj_w": r.normal((ch * (cfg.n_mels // 8), d), 0.02),
        "proj_b": r.zeros((d,)),
    }
    f32 = torch.float32
    blocks = {}
    for ff_name in ("ff1", "ff2"):
        blocks.update({
            f"{ff_name}_ln_g": r.ones((L, d)),
            f"{ff_name}_ln_b": r.zeros((L, d), f32),
            f"{ff_name}_w1": stack((d, ff), d**-0.5),
            f"{ff_name}_b1": r.zeros((L, ff)),
            f"{ff_name}_w2": stack((ff, d), ff**-0.5),
            f"{ff_name}_b2": r.zeros((L, d)),
        })
    blocks.update({
        "attn_ln_g": r.ones((L, d)),
        "attn_ln_b": r.zeros((L, d), f32),
        "wq": stack((d, d), d**-0.5),
        "wk": stack((d, d), d**-0.5),
        "wv": stack((d, d), d**-0.5),
        "wo": stack((d, d), d**-0.5),
        "bq": r.zeros((L, d)),
        "bk": r.zeros((L, d)),
        "bv": r.zeros((L, d)),
        "bo": r.zeros((L, d)),
        "wpos": stack((d, d), d**-0.5),
        "pos_bias_u": r.zeros((L, cfg.n_heads, cfg.head_dim)),
        "pos_bias_v": r.zeros((L, cfg.n_heads, cfg.head_dim)),
        "conv_ln_g": r.ones((L, d)),
        "conv_ln_b": r.zeros((L, d), f32),
        "conv_pw1_w": stack((d, 2 * d), d**-0.5),
        "conv_pw1_b": r.zeros((L, 2 * d)),
        "conv_dw_w": stack((d, cfg.conv_kernel), dw_scale),
        "conv_dw_b": r.zeros((L, d)),
        "conv_bn_g": r.ones((L, d)),
        "conv_bn_b": r.zeros((L, d), f32),
        "conv_bn_mean": r.zeros((L, d), f32),
        "conv_bn_var": r.ones((L, d)),
        "conv_pw2_w": stack((d, d), d**-0.5),
        "conv_pw2_b": r.zeros((L, d)),
        "final_ln_g": r.ones((L, d)),
        "final_ln_b": r.zeros((L, d), f32),
    })
    ph, jh, vb = cfg.pred_hidden, cfg.joint_hidden, cfg.vocab_size + 1
    decoder = {
        "embed": r.normal((vb, ph), 0.02),
        "lstm_w": r.normal((ph, 4 * ph), ph**-0.5),
        "lstm_r": r.normal((ph, 4 * ph), ph**-0.5),
        "lstm_b": r.zeros((4 * ph,)),
    }
    joint = {
        "enc_w": r.normal((d, jh), d**-0.5),
        "enc_b": r.zeros((jh,)),
        "pred_w": r.normal((ph, jh), ph**-0.5),
        "pred_b": r.zeros((jh,)),
        "out_w": r.normal((jh, vb), jh**-0.5),
        "out_b": r.zeros((vb,)),
        "dur_w": r.normal((jh, cfg.durations), jh**-0.5),
        "dur_b": r.zeros((cfg.durations,)),
    }
    return {"subsampling": sub, "blocks": blocks, "decoder": decoder,
            "joint": joint}


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _subsample(sub, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, T] -> [B, T // 8, d_model] via three stride-2 convs;
    the last two are depthwise then pointwise. The output is flattened
    channel-major (c * f)."""
    x = mel[:, None].transpose(2, 3)  # [B, 1, T, n_mels]
    x = F.relu(F.conv2d(x, sub["conv0_w"], sub["conv0_b"], 2, 1))
    ch = x.shape[1]
    for i in (1, 2):
        x = F.conv2d(x, sub[f"dw{i}_w"], sub[f"dw{i}_b"], 2, 1, groups=ch)
        x = F.relu(F.conv2d(x, sub[f"pw{i}_w"], sub[f"pw{i}_b"]))
    b, c, t, f = x.shape
    x = x.transpose(1, 2).reshape(b, t, c * f)
    return x @ sub["proj_w"] + sub["proj_b"]


def _rel_pos_encoding(t: int, d: int) -> np.ndarray:
    """Transformer-XL sinusoids for positions t-1 .. -(t-1), interleaved
    sin / cos."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float32)  # [2t-1]
    inv = np.exp(-np.log(10000.0) * np.arange(0, d, 2) / d)
    angles = pos[:, None] * inv[None, :]
    enc = np.zeros((len(pos), d), np.float32)
    enc[:, 0::2] = np.sin(angles)
    enc[:, 1::2] = np.cos(angles)
    return enc


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[q, k] = x[q, (T-1) + (k-q)],
    by the pad / reshape shift."""
    b, h, t, p = x.shape
    x = F.pad(x, (1, 0))  # [B, H, T, P+1]
    x = x.reshape(b, h, t * (p + 1))[:, :, t:]
    return x.reshape(b, h, t, p)[..., :t]


def _rel_attention(x, pos_emb, blk, n_heads: int):
    b, t, d = x.shape
    dh = d // n_heads
    q = (x @ blk["wq"] + blk["bq"]).reshape(b, t, n_heads, dh)
    k = (x @ blk["wk"] + blk["bk"]).reshape(b, t, n_heads, dh)
    v = (x @ blk["wv"] + blk["bv"]).reshape(b, t, n_heads, dh)
    p = (pos_emb @ blk["wpos"]).reshape(-1, n_heads, dh)  # [2T-1, H, dh]
    q_u = (q + blk["pos_bias_u"]).transpose(1, 2)
    q_v = (q + blk["pos_bias_v"]).transpose(1, 2)
    ac = q_u @ k.permute(0, 2, 3, 1)  # [B, H, T, T]
    bd = _rel_shift(q_v @ p.permute(1, 2, 0))  # [B, H, T, 2T-1] -> T
    scores = (ac + bd) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1)
    o = (probs @ v.transpose(1, 2)).transpose(1, 2).reshape(b, t, d)
    return o @ blk["wo"] + blk["bo"]


def _conv_module(x, blk):
    """Pointwise -> GLU -> depthwise -> BatchNorm (eval) -> swish ->
    pointwise."""
    h = x @ blk["conv_pw1_w"] + blk["conv_pw1_b"]  # [B, T, 2D]
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)  # GLU
    d, k = h.shape[-1], blk["conv_dw_w"].shape[-1]
    h = F.conv1d(h.transpose(1, 2), blk["conv_dw_w"][:, None, :],
                 blk["conv_dw_b"], padding=k // 2, groups=d).transpose(1, 2)
    # BatchNorm1d in eval mode: a per-channel affine from running stats.
    scale = blk["conv_bn_g"] * torch.rsqrt(blk["conv_bn_var"] + 1e-5)
    h = h * scale + (blk["conv_bn_b"] - blk["conv_bn_mean"] * scale)
    h = h * torch.sigmoid(h)  # swish
    return h @ blk["conv_pw2_w"] + blk["conv_pw2_b"]


def _ff(x, blk, name: str):
    h = _norm(x, blk[f"{name}_ln_g"], blk[f"{name}_ln_b"])
    h = F.silu(h @ blk[f"{name}_w1"] + blk[f"{name}_b1"])
    return h @ blk[f"{name}_w2"] + blk[f"{name}_b2"]


def layer(params: Params, i: int) -> Params:
    """Layer i's leaves of the stacked blocks."""
    return {k: v[i] for k, v in params["blocks"].items()}


def encode(params: Params, mel: torch.Tensor, cfg: ParakeetConfig) -> torch.Tensor:
    """mel [B, n_mels, T] -> encoder states [B, T', d_model] (T' the
    subsampled length, about T / 8)."""
    x = _subsample(params["subsampling"], mel)
    # xscaling: FastConformer multiplies the subsampled features by sqrt(d).
    x = x * float(np.sqrt(cfg.d_model))
    pos_emb = torch.from_numpy(
        _rel_pos_encoding(x.shape[1], cfg.d_model)).to(x.device, x.dtype)
    for i in range(cfg.n_layers):
        blk = layer(params, i)
        x = x + 0.5 * _ff(x, blk, "ff1")
        x = x + _rel_attention(_norm(x, blk["attn_ln_g"], blk["attn_ln_b"]),
                               pos_emb, blk, cfg.n_heads)
        x = x + _conv_module(_norm(x, blk["conv_ln_g"], blk["conv_ln_b"]), blk)
        x = x + 0.5 * _ff(x, blk, "ff2")
        # No encoder-level final norm: each block ends with its own.
        x = _norm(x, blk["final_ln_g"], blk["final_ln_b"])
    return x


# ---------------------------------------------------------------------------
# Prediction network + joint
# ---------------------------------------------------------------------------


def pred_init_state(cfg: ParakeetConfig, batch: int, dtype=torch.float32,
                    device="cpu"):
    z = torch.zeros((batch, cfg.pred_hidden), dtype=dtype, device=device)
    return z, z.clone()


def pred_step(params: Params, token: torch.Tensor, state, cfg: ParakeetConfig):
    """One prediction-network step. token [B] (blank_id = start)."""
    dec = params["decoder"]
    x = dec["embed"][token]  # [B, ph]
    h, c = state
    gates = x @ dec["lstm_w"] + h @ dec["lstm_r"] + dec["lstm_b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def joint(params: Params, enc_t: torch.Tensor, pred: torch.Tensor):
    """Joint network: (token_logits [B, V+1], dur_logits [B, D])."""
    j = params["joint"]
    h = F.relu(enc_t @ j["enc_w"] + j["enc_b"] + pred @ j["pred_w"]
               + j["pred_b"])
    return h @ j["out_w"] + j["out_b"], h @ j["dur_w"] + j["dur_b"]
