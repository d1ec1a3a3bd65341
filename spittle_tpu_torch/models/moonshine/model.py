"""Moonshine encoder-decoder in PyTorch (port of
spittle_tpu/models/moonshine/model.py), plain ops in f32.

- raw-waveform conv stem: conv(1->D, k127 s64, no bias) -> tanh ->
  GroupNorm(1 group) -> conv(D->2D, k7 s3) erf-GELU -> conv(2D->D, k3 s2)
  erf-GELU, no padding (about 384x time reduction, no mel frontend);
- pre-LN transformer layers with bias-free LayerNorms and bias-free
  q/k/v/o projections; attention scaled by head_dim**-0.5;
- partial interleaved rotary embeddings (rotary_dim the even floor of
  0.9 * head_dim, even/odd pairing) on encoder and decoder
  self-attention; none on cross-attention;
- decoder MLP SwiGLU (fc1 -> [hidden | gate], silu(gate) * hidden ->
  fc2); encoder MLP plain GELU; tied output embedding.

greedy_decode keeps the reference's static shapes: a [layers, 2, B, H, L,
Dh] self-attention cache and a softmax over all L positions, those past
the current one masked at -1e30.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from spittle_tpu_torch.models._random import RandomDraw

Params = Dict[str, Any]


@dataclass(frozen=True)
class MoonshineConfig:
    name: str = "moonshine-base"
    dim: int = 416
    enc_layers: int = 8
    dec_layers: int = 8
    n_heads: int = 8
    intermediate: int = 1664  # 4x dim (base); tiny uses 1152
    vocab_size: int = 32768
    max_tokens: int = 224
    sot: int = 1
    eot: int = 2
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.9

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def rotary_dim(self) -> int:
        d = int(self.head_dim * self.partial_rotary_factor)
        return d - (d % 2)


CONFIGS = {
    "moonshine-tiny": MoonshineConfig("moonshine-tiny", dim=288, enc_layers=6,
                                      dec_layers=6, intermediate=1152),
    "moonshine-base": MoonshineConfig("moonshine-base"),
    "moonshine-test": MoonshineConfig("moonshine-test", dim=64, enc_layers=2,
                                      dec_layers=2, n_heads=4,
                                      intermediate=128, vocab_size=128,
                                      max_tokens=16),
}


def _ln(x, g):
    """LayerNorm without bias; population variance, as jnp.var."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * g


def _group_norm(x, g, b):
    """GroupNorm(num_groups=1) over (C, T) per sample. x: [B, C, T]."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + 1e-5)
    return out * g[None, :, None] + b[None, :, None]


def random_params(cfg: MoonshineConfig, seed: int = 0, dtype=torch.float32,
                  device="cpu") -> Params:
    """Random weights at the reference's init_params scales and shapes
    (RandomDraw: a torch.Generator on `device`, seeded)."""
    r = RandomDraw(seed, device, dtype)
    d, inter = cfg.dim, cfg.intermediate

    def attn(L, prefix=""):
        return {f"{prefix}w{n}": r.normal((L, d, d), d**-0.5) for n in "qkvo"}

    def layers(L):
        return {"ln1_g": r.ones((L, d)), **attn(L), "ln2_g": r.ones((L, d))}

    enc_blocks = layers(cfg.enc_layers)
    enc_blocks.update({
        "fc1_w": r.normal((cfg.enc_layers, d, inter), d**-0.5),
        "fc1_b": r.zeros((cfg.enc_layers, inter)),
        "fc2_w": r.normal((cfg.enc_layers, inter, d), inter**-0.5),
        "fc2_b": r.zeros((cfg.enc_layers, d)),
    })
    enc = {
        "conv1_w": r.normal((d, 1, 127), 0.05),
        "conv2_w": r.normal((2 * d, d, 7), (7 * d) ** -0.5),
        "conv2_b": r.zeros((2 * d,)),
        "conv3_w": r.normal((d, 2 * d, 3), (6 * d) ** -0.5),
        "conv3_b": r.zeros((d,)),
        "gn_g": r.ones((d,)),
        "gn_b": r.zeros((d,), torch.float32),
        "blocks": enc_blocks,
        "lnf_g": r.ones((d,)),
    }
    L = cfg.dec_layers
    dec_blocks = layers(L)
    dec_blocks.update({
        **attn(L, "x"),
        "ln3_g": r.ones((L, d)),
        "fc1_w": r.normal((L, d, 2 * inter), d**-0.5),
        "fc1_b": r.zeros((L, 2 * inter)),
        "fc2_w": r.normal((L, inter, d), inter**-0.5),
        "fc2_b": r.zeros((L, d)),
    })
    dec = {
        "tok_emb": r.normal((cfg.vocab_size, d), 0.02),
        "blocks": dec_blocks,
        "norm_g": r.ones((d,)),
    }
    return {"encoder": enc, "decoder": dec}


# -- rotary (interleaved, partial) --------------------------------------------


def _rope_cos_sin(positions: torch.Tensor, cfg: MoonshineConfig):
    """cos / sin [T, rotary_dim] with interleaved pairing."""
    rd = cfg.rotary_dim
    exps = -torch.arange(0, rd, 2, dtype=torch.float32,
                         device=positions.device) / rd
    inv = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                 device=positions.device), exps)
    freqs = positions.float()[:, None] * inv[None, :]  # [T, rd/2]
    return (freqs.cos().repeat_interleave(2, dim=-1),
            freqs.sin().repeat_interleave(2, dim=-1))


def _rotate_half_interleaved(x):
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def _apply_rope(x, cos, sin, cfg):
    """x: [B, H, T, Dh]; cos / sin [T, rotary_dim]."""
    rd = cfg.rotary_dim
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x_emb = x_rot * cos + _rotate_half_interleaved(x_rot) * sin
    return torch.cat([x_emb, x_pass], dim=-1)


def _heads(x, n):
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def _merge(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attn(q, k, v):
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(scores, dim=-1) @ v


def _enc_mlp(x, blk):
    h = F.gelu(x @ blk["fc1_w"] + blk["fc1_b"], approximate="none")
    return h @ blk["fc2_w"] + blk["fc2_b"]


def _dec_mlp(x, blk):
    hidden, gate = (x @ blk["fc1_w"] + blk["fc1_b"]).chunk(2, dim=-1)
    return (F.silu(gate) * hidden) @ blk["fc2_w"] + blk["fc2_b"]


def _layer(blocks: Params, i: int) -> Params:
    return {k: v[i] for k, v in blocks.items()}


# -- encoder -----------------------------------------------------------------


def encode(params: Params, audio: torch.Tensor, cfg: MoonshineConfig) -> torch.Tensor:
    """Raw 16 kHz PCM [B, T] -> encoder states [B, ~T/384, dim]."""
    enc = params["encoder"]
    x = torch.tanh(F.conv1d(audio[:, None, :].float(), enc["conv1_w"],
                            stride=64))
    x = _group_norm(x, enc["gn_g"], enc["gn_b"])
    x = F.gelu(F.conv1d(x, enc["conv2_w"], enc["conv2_b"], stride=3),
               approximate="none")
    x = F.gelu(F.conv1d(x, enc["conv3_w"], enc["conv3_b"], stride=2),
               approximate="none")
    x = x.transpose(1, 2)  # [B, T', D]
    cos, sin = _rope_cos_sin(torch.arange(x.shape[1], device=x.device), cfg)
    for i in range(cfg.enc_layers):
        blk = _layer(enc["blocks"], i)
        hn = _ln(x, blk["ln1_g"])
        q = _apply_rope(_heads(hn @ blk["wq"], cfg.n_heads), cos, sin, cfg)
        k = _apply_rope(_heads(hn @ blk["wk"], cfg.n_heads), cos, sin, cfg)
        v = _heads(hn @ blk["wv"], cfg.n_heads)
        x = x + _merge(_attn(q, k, v)) @ blk["wo"]
        x = x + _enc_mlp(_ln(x, blk["ln2_g"]), blk)
    return _ln(x, enc["lnf_g"])


# -- greedy decode with KV cache ----------------------------------------------


def greedy_decode(
    params: Params, xa: torch.Tensor, cfg: MoonshineConfig, max_tokens: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """-> (tokens [B, L] EOT-padded, lengths [B], steps taken). lengths
    counts the non-EOT tokens before the item finishes; the loop stops at
    L steps or when every item has emitted EOT."""
    dec = params["decoder"]
    b, dev = xa.shape[0], xa.device
    L = max_tokens or cfg.max_tokens
    heads, dh = cfg.n_heads, cfg.head_dim
    blocks = [_layer(dec["blocks"], i) for i in range(cfg.dec_layers)]
    cache = torch.zeros((cfg.dec_layers, 2, b, heads, L, dh), dtype=xa.dtype,
                        device=dev)
    cos_all, sin_all = _rope_cos_sin(torch.arange(L, device=dev), cfg)
    cross = [(_heads(xa @ blk["xwk"], heads), _heads(xa @ blk["xwv"], heads))
             for blk in blocks]
    positions = torch.arange(L, device=dev)
    emb_t = dec["tok_emb"].T

    tokens = torch.full((b, L), cfg.eot, dtype=torch.int64, device=dev)
    cur = torch.full((b,), cfg.sot, dtype=torch.int64, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    length = torch.zeros(b, dtype=torch.int64, device=dev)
    pos = 0
    while pos < L and not bool(finished.all()):
        x = dec["tok_emb"][cur][:, None, :]  # [B, 1, D]
        cos, sin = cos_all[pos:pos + 1], sin_all[pos:pos + 1]
        mask = positions <= pos
        for li, blk in enumerate(blocks):
            hn = _ln(x, blk["ln1_g"])
            q = _apply_rope(_heads(hn @ blk["wq"], heads), cos, sin, cfg)
            cache[li, 0, :, :, pos] = _apply_rope(
                _heads(hn @ blk["wk"], heads), cos, sin, cfg)[:, :, 0]
            cache[li, 1, :, :, pos] = _heads(hn @ blk["wv"], heads)[:, :, 0]
            scores = (q @ cache[li, 0].transpose(-1, -2)) / math.sqrt(dh)
            scores = torch.where(mask, scores, -1e30)
            probs = torch.softmax(scores, dim=-1)
            x = x + _merge(probs @ cache[li, 1]) @ blk["wo"]
            q = _heads(_ln(x, blk["ln2_g"]) @ blk["xwq"], heads)
            x = x + _merge(_attn(q, *cross[li])) @ blk["xwo"]
            x = x + _dec_mlp(_ln(x, blk["ln3_g"]), blk)
        logits = (_ln(x, dec["norm_g"])[:, 0] @ emb_t).float()
        nxt = torch.where(finished, cfg.eot, logits.argmax(dim=-1))
        tokens[:, pos] = nxt
        length += ~finished & (nxt != cfg.eot)
        finished |= nxt == cfg.eot
        cur = nxt
        pos += 1
    return tokens, length, pos
