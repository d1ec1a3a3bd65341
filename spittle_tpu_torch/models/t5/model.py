"""T5 (flan-t5) encoder-decoder forward passes in PyTorch (port of
spittle_tpu/models/t5/model.py).

A T5 v1.1/flan forward pass in plain ops in f32: RMSNorm, unscaled
attention (T5 folds 1/sqrt(dk) into its initialisation), one
relative-position bias per stack shared by every layer, gated-GELU
feed-forward, an untied LM head, and a static-shape KV cache written in
place for incremental decode. No kernel of the port runs here.

Parameter tree (nested dicts of tensors, the reference's):
  shared_emb [V, D]
  encoder: rel_bias [num_buckets, H],
           blocks {attn_ln [L,D], wq/wk/wv [L,D,I], wo [L,I,D],
                   mlp_ln [L,D], wi0/wi1 [L,D,F], wo_ff [L,F,D]},
           ln [D]
  decoder: rel_bias, blocks {+ cross_ln, cross_wq/wk/wv/wo}, ln
  lm_head [D, V]
(I = num_heads * d_kv.) The device is the parameters': weights go where
params_from_hf_tensors / load_t5_dir put them (the card by default).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]
_MASKED = -1e9


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_heads: int = 6
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eos_id: int = 1
    pad_id: int = 0  # doubles as the decoder start token

    @property
    def inner(self) -> int:
        return self.num_heads * self.d_kv


FLAN_T5_SMALL = T5Config()


def rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * g.to(x.dtype)


def _relative_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """HF T5's _relative_position_bucket, vectorized (int64 in and out).
    The divisors are device tensors: on CUDA, PyTorch turns division by a
    Python scalar into a reciprocal multiply, which may move a bucket
    edge."""
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).long() * num_buckets
        n = rel.abs()
    else:
        n = torch.clamp_min(-rel, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=rel.device)

    # Log-spaced buckets up to max_distance.
    large = max_exact + (
        torch.log(torch.clamp_min(n, 1).to(torch.float32) / f32(max_exact))
        / f32(np.log(max_distance / max_exact))
        * (num_buckets - max_exact)
    ).long()
    large = torch.clamp_max(large, num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def relative_bias(rel_table: torch.Tensor, q_len: int, k_len: int,
                  bidirectional: bool, cfg: T5Config,
                  q_offset: int = 0) -> torch.Tensor:
    """[1, H, q_len, k_len] position bias (query positions offset by
    q_offset for incremental decode)."""
    dev = rel_table.device
    ctx = torch.arange(q_len, device=dev)[:, None] + q_offset
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = _relative_bucket(mem - ctx, bidirectional, cfg.rel_buckets,
                               cfg.rel_max_distance)
    return rel_table[buckets].permute(2, 0, 1)[None]


def _split(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attn(q, k, v, bias) -> torch.Tensor:
    """T5 attention: no 1/sqrt(dk) scaling; additive bias. k, v [B, H, T,
    Dh]."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _ff(x, blk):
    h = F.gelu(x @ blk["wi0"], approximate="tanh") * (x @ blk["wi1"])
    return h @ blk["wo_ff"]


def _layer(blocks, i: int):
    return {k: v[i] for k, v in blocks.items()}


def _pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool (True: a real token) -> additive [B, 1, 1, T]."""
    return torch.where(mask, 0.0, _MASKED)[:, None, None, :]


@torch.inference_mode()
def t5_encode(params: Params, tokens: torch.Tensor, mask: torch.Tensor,
              cfg: T5Config) -> torch.Tensor:
    """tokens [B, T] int, mask [B, T] bool -> [B, T, D]."""
    enc = params["encoder"]
    h = cfg.num_heads
    x = params["shared_emb"][tokens]
    t = tokens.shape[1]
    bias = relative_bias(enc["rel_bias"], t, t, True, cfg) + _pad_bias(mask)
    blocks = enc["blocks"]
    for i in range(cfg.num_layers):
        blk = _layer(blocks, i)
        xn = rms_norm(x, blk["attn_ln"])
        o = _attn(_split(xn @ blk["wq"], h), _split(xn @ blk["wk"], h),
                  _split(xn @ blk["wv"], h), bias)
        x = x + _merge(o) @ blk["wo"]
        x = x + _ff(rms_norm(x, blk["mlp_ln"]), blk)
    return rms_norm(x, enc["ln"])


@torch.inference_mode()
def t5_decoder_forward(params: Params, tokens: torch.Tensor,
                       enc_out: torch.Tensor, enc_mask: torch.Tensor,
                       cfg: T5Config) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B, T] -> logits [B, T, V] (f32)."""
    dec = params["decoder"]
    h = cfg.num_heads
    t = tokens.shape[1]
    x = params["shared_emb"][tokens]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    bias = relative_bias(dec["rel_bias"], t, t, False, cfg) + torch.where(
        causal, 0.0, _MASKED)[None, None]
    cbias = _pad_bias(enc_mask)
    blocks = dec["blocks"]
    for i in range(cfg.num_layers):
        blk = _layer(blocks, i)
        xn = rms_norm(x, blk["attn_ln"])
        o = _attn(_split(xn @ blk["wq"], h), _split(xn @ blk["wk"], h),
                  _split(xn @ blk["wv"], h), bias)
        x = x + _merge(o) @ blk["wo"]
        xn = rms_norm(x, blk["cross_ln"])
        o = _attn(_split(xn @ blk["cross_wq"], h),
                  _split(enc_out @ blk["cross_wk"], h),
                  _split(enc_out @ blk["cross_wv"], h), cbias)
        x = x + _merge(o) @ blk["cross_wo"]
        x = x + _ff(rms_norm(x, blk["mlp_ln"]), blk)
    x = rms_norm(x, dec["ln"])
    return (x @ params["lm_head"]).to(torch.float32)


@torch.inference_mode()
def precompute_cross_kv(params: Params, enc_out: torch.Tensor,
                        cfg: T5Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, B, H, T, Dh] cross K and V, computed once per input."""
    h = cfg.num_heads
    blocks = params["decoder"]["blocks"]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        blk = _layer(blocks, i)
        ks.append(_split(enc_out @ blk["cross_wk"], h))
        vs.append(_split(enc_out @ blk["cross_wv"], h))
    return torch.stack(ks), torch.stack(vs)


def init_kv_cache(cfg: T5Config, batch: int, ctx: int, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """Self-attention cache [L, 2, B, H, ctx, Dh], zeros."""
    return torch.zeros((cfg.num_layers, 2, batch, cfg.num_heads, ctx, cfg.d_kv),
                       dtype=dtype, device=device)


@torch.inference_mode()
def t5_decode_step(params: Params, tokens: torch.Tensor, pos: int,
                   kv_cache: torch.Tensor, cross_kv, enc_mask: torch.Tensor,
                   cfg: T5Config) -> torch.Tensor:
    """One incremental step: tokens [B] at position pos -> logits [B, V]
    (f32); each layer's K/V column is written into kv_cache IN PLACE (the
    reference returns a new cache)."""
    dec = params["decoder"]
    h = cfg.num_heads
    n_ctx = kv_cache.shape[4]
    x = params["shared_emb"][tokens][:, None, :]
    col = torch.arange(n_ctx, device=x.device)
    bias = relative_bias(dec["rel_bias"], 1, n_ctx, False, cfg, q_offset=pos) \
        + torch.where(col <= pos, 0.0, _MASKED)[None, None, None]
    cbias = _pad_bias(enc_mask)
    blocks = dec["blocks"]
    # JAX's dynamic_update_slice start: clamped so the column fits.
    at = min(max(pos, 0), n_ctx - 1)
    for i in range(cfg.num_layers):
        blk = _layer(blocks, i)
        xn = rms_norm(x, blk["attn_ln"])
        q = _split(xn @ blk["wq"], h)
        kv_cache[i, 0, :, :, at:at + 1] = _split(xn @ blk["wk"], h)
        kv_cache[i, 1, :, :, at:at + 1] = _split(xn @ blk["wv"], h)
        o = _attn(q, kv_cache[i, 0], kv_cache[i, 1], bias)
        x = x + _merge(o) @ blk["wo"]
        xn = rms_norm(x, blk["cross_ln"])
        o = _attn(_split(xn @ blk["cross_wq"], h), cross_kv[0][i], cross_kv[1][i],
                  cbias)
        x = x + _merge(o) @ blk["cross_wo"]
        x = x + _ff(rms_norm(x, blk["mlp_ln"]), blk)
    x = rms_norm(x, dec["ln"])
    return (x[:, 0] @ params["lm_head"]).to(torch.float32)


@torch.inference_mode()
def greedy_generate(params: Params, tokens: np.ndarray, cfg: T5Config,
                    max_tokens: int = 512) -> np.ndarray:
    """Greedy decode from the pad token until EOS or max_tokens, on the
    parameters' device. tokens [B, T] padded with pad_id. Returns [B, <=
    max_tokens] generated ids (pad after each row's EOS)."""
    dev = params["shared_emb"].device
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64, device=dev)
    mask = tok != cfg.pad_id
    enc_out = t5_encode(params, tok, mask, cfg)
    cross_kv = precompute_cross_kv(params, enc_out, cfg)
    b = tok.shape[0]
    cache = init_kv_cache(cfg, b, max_tokens, enc_out.dtype, dev)
    cur = torch.full((b,), cfg.pad_id, dtype=torch.int64, device=dev)
    done = np.zeros(b, bool)
    out = np.full((b, max_tokens), cfg.pad_id, np.int32)
    for step in range(max_tokens):
        logits = t5_decode_step(params, cur, step, cache, cross_kv, mask, cfg)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        nxt = np.where(done, cfg.pad_id, nxt)
        out[:, step] = nxt
        done |= nxt == cfg.eos_id
        if done.all():
            out = out[:, : step + 1]
            break
        cur = torch.as_tensor(nxt, dtype=torch.int64, device=dev)
    return out
