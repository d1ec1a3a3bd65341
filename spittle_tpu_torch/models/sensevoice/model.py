"""SenseVoice-Small in PyTorch: SAN-M encoder + CTC, non-autoregressive
(port of spittle_tpu/models/sensevoice/model.py), plain ops in f32.

- LFR-stacked features (7 stacked / stride 6 -> 560-dim frames; the first
  frame repeated (m - 1) // 2 times on the left, indices clamped at the
  end), optional Kaldi-style CMVN (shift, then rescale);
- 4 prompt frames from a 16-entry `embed` table of input width (language
  id, event, emotion, text normalization), put before the features;
- input scaled by sqrt(d_model) plus 1-based sinusoidal positions;
- SAN-M blocks: a fused q/k/v linear, attention out-projection plus an
  FSMN memory branch (a depthwise convolution over V, padded (k-1)//2 on
  the left and the rest on the right, plus V); the first block projects
  560 -> 512 and has no attention residual;
- after_norm -> tp blocks -> tp_norm -> CTC head, decoded greedily.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from spittle_tpu_torch.models._random import RandomDraw

Params = Dict[str, Any]

LANGUAGES = ("auto", "zh", "en", "yue", "ja", "ko", "nospeech")
# FunASR SenseVoiceSmall prompt ids: lid_dict + event(1)/emo(2) queries +
# textnorm_dict {withitn: 14, woitn: 15}.
LID_IDS = {"auto": 0, "zh": 3, "en": 4, "yue": 7, "ja": 11, "ko": 12,
           "nospeech": 13}
EVENT_ID = 1
EMO_ID = 2
WITHITN_ID = 14
WOITN_ID = 15


@dataclass(frozen=True)
class SenseVoiceConfig:
    name: str = "sense-voice-small"
    n_mels: int = 80
    lfr_m: int = 7  # frames stacked
    lfr_n: int = 6  # stride
    d_model: int = 512
    n_heads: int = 4
    ff_dim: int = 2048
    n_blocks: int = 50  # encoders0 (1) + encoders (n_blocks - 1)
    tp_blocks: int = 20  # timestamp-predictor blocks feeding the CTC head
    fsmn_kernel: int = 11
    vocab_size: int = 25055
    blank_id: int = 0
    n_prompt: int = 4  # lid, event, emotion, textnorm frames

    @property
    def input_dim(self) -> int:
        return self.n_mels * self.lfr_m


CONFIGS = {
    "sense-voice-small": SenseVoiceConfig(),
    "sense-voice-test": SenseVoiceConfig(
        name="sense-voice-test", d_model=64, n_heads=4, ff_dim=128,
        n_blocks=2, tp_blocks=1, vocab_size=64,
    ),
}


def lfr_stack(mel: torch.Tensor, m: int = 7, n: int = 6) -> torch.Tensor:
    """[B, n_mels, T] -> [B, T // n, n_mels * m] low-frame-rate stacking."""
    b, d, t = mel.shape
    x = mel.transpose(1, 2)  # [B, T, D]
    pad = (m - 1) // 2
    x = torch.cat([x[:, :1].expand(b, pad, d), x], dim=1)
    t_out = t // n
    idx = np.arange(t_out)[:, None] * n + np.arange(m)[None, :]
    idx = torch.from_numpy(np.minimum(idx, x.shape[1] - 1)).to(x.device)
    return x[:, idx].reshape(b, t_out, d * m)


def sinusoidal_positions(t: int, depth: int) -> np.ndarray:
    """FunASR SinusoidalPositionEncoder: 1-based positions, [sin | cos]
    split at depth / 2, log(10000) / (half - 1) per step."""
    positions = np.arange(1, t + 1, dtype=np.float32)
    half = depth // 2
    log_inc = np.log(10000.0) / (half - 1)
    inv = np.exp(np.arange(half, dtype=np.float32) * -log_inc)
    scaled = positions[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


def _norm(x, g, b):
    # Population variance, as jnp.var; torch LayerNorm's default eps.
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5) * g + b


def _layer_params(r: RandomDraw, in_dim: int, d: int, ff: int, k: int,
                  stacked: Optional[int] = None) -> Params:
    def shape(*s):
        return (stacked, *s) if stacked else s

    f32 = torch.float32
    return {
        "ln1_g": r.ones(shape(in_dim)), "ln1_b": r.zeros(shape(in_dim), f32),
        "wqkv": r.normal(shape(in_dim, 3 * d), in_dim**-0.5),
        "bqkv": r.zeros(shape(3 * d)),
        "fsmn_w": r.normal(shape(d, k), 0.1),
        "wo": r.normal(shape(d, d), d**-0.5),
        "bo": r.zeros(shape(d)),
        "ln2_g": r.ones(shape(d)), "ln2_b": r.zeros(shape(d), f32),
        "ff_w1": r.normal(shape(d, ff), d**-0.5),
        "ff_b1": r.zeros(shape(ff)),
        "ff_w2": r.normal(shape(ff, d), ff**-0.5),
        "ff_b2": r.zeros(shape(d)),
    }


def random_params(cfg: SenseVoiceConfig, seed: int = 0, dtype=torch.float32,
                  device="cpu") -> Params:
    """Random weights at the reference's init_params scales and shapes
    (RandomDraw: a torch.Generator on `device`, seeded)."""
    r = RandomDraw(seed, device, dtype)
    d, ff, k = cfg.d_model, cfg.ff_dim, cfg.fsmn_kernel
    return {
        "embed": r.normal((16, cfg.input_dim), 0.02),
        "enc0": _layer_params(r, cfg.input_dim, d, ff, k),
        "blocks": _layer_params(r, d, d, ff, k, stacked=cfg.n_blocks - 1),
        "after_ln_g": r.ones((d,)),
        "after_ln_b": r.zeros((d,), torch.float32),
        "tp_blocks": _layer_params(r, d, d, ff, k, stacked=cfg.tp_blocks),
        "tp_ln_g": r.ones((d,)),
        "tp_ln_b": r.zeros((d,), torch.float32),
        "ctc_w": r.normal((d, cfg.vocab_size), d**-0.5),
        "ctc_b": r.zeros((cfg.vocab_size,)),
    }


def _sanm_layer(x, blk, n_heads: int, d: int, residual_attn: bool):
    """One SAN-M encoder layer (FunASR EncoderLayerSANM semantics)."""
    k_size = blk["fsmn_w"].shape[-1]
    res = x
    xn = _norm(x, blk["ln1_g"], blk["ln1_b"])
    q, kk, v = (xn @ blk["wqkv"] + blk["bqkv"]).chunk(3, dim=-1)
    b, t, _ = q.shape
    dh = d // n_heads
    qh = q.reshape(b, t, n_heads, dh).transpose(1, 2) * dh**-0.5
    kh = kk.reshape(b, t, n_heads, dh).transpose(1, 2)
    vh = v.reshape(b, t, n_heads, dh).transpose(1, 2)
    probs = torch.softmax(qh @ kh.transpose(-1, -2), dim=-1)
    attn = (probs @ vh).transpose(1, 2).reshape(b, t, d)
    # FSMN memory: a depthwise convolution over V plus V, added after the
    # attention out-projection. Its padding is asymmetric.
    pad_l = (k_size - 1) // 2
    mem = F.conv1d(F.pad(v.transpose(1, 2), (pad_l, k_size - 1 - pad_l)),
                   blk["fsmn_w"][:, None, :], groups=d).transpose(1, 2) + v
    x = attn @ blk["wo"] + blk["bo"] + mem
    if residual_attn:
        x = x + res
    res = x
    xn = _norm(x, blk["ln2_g"], blk["ln2_b"])
    x = F.relu(xn @ blk["ff_w1"] + blk["ff_b1"]) @ blk["ff_w2"] + blk["ff_b2"]
    return x + res


def encode(
    params: Params,
    features: torch.Tensor,  # [B, T', input_dim] LFR-stacked
    prompt_ids: torch.Tensor,  # [B, n_prompt] into the 16-entry embed table
    cfg: SenseVoiceConfig,
) -> torch.Tensor:
    """-> CTC logits [B, n_prompt + T', vocab], f32."""
    d = cfg.d_model
    if "cmvn_shift" in params:
        features = (features + params["cmvn_shift"]) * params["cmvn_scale"]
    x = torch.cat([params["embed"][prompt_ids], features], dim=1)
    x = x * (d**0.5)
    pe = torch.from_numpy(sinusoidal_positions(x.shape[1], cfg.input_dim))
    x = x + pe.to(x.device, x.dtype)
    x = _sanm_layer(x, params["enc0"], cfg.n_heads, d, residual_attn=False)
    for stack, ln in (("blocks", "after_ln"), ("tp_blocks", "tp_ln")):
        blocks = params[stack]
        for i in range(next(iter(blocks.values())).shape[0]):
            x = _sanm_layer(x, {k: v[i] for k, v in blocks.items()},
                            cfg.n_heads, d, residual_attn=True)
        x = _norm(x, params[f"{ln}_g"], params[f"{ln}_b"])
    return (x @ params["ctc_w"] + params["ctc_b"]).float()


def ctc_collapse_ids(
    ids: np.ndarray, blank_id: int = 0, skip: int = 4
) -> List[List[int]]:
    """Collapse repeats -> drop blanks on per-frame argmax ids [B, T].
    `skip` drops the prompt frames at the front."""
    out = []
    for row in np.asarray(ids).tolist():
        prev, toks = -1, []
        for t in row[skip:]:
            if t != prev and t != blank_id:
                toks.append(t)
            prev = t
        out.append(toks)
    return out


def prompt_ids_for(
    cfg: SenseVoiceConfig, language: str = "auto", use_itn: bool = True
) -> np.ndarray:
    """[lid, event, emotion, textnorm] FunASR prompt-table indices."""
    lid = LID_IDS.get(language, 0)
    textnorm = WITHITN_ID if use_itn else WOITN_ID
    return np.asarray([lid, EVENT_ID, EMO_ID, textnorm], np.int64)


# -- Kaldi-style CMVN (am.mvn) -------------------------------------------------

def parse_kaldi_cmvn(path: str) -> Optional[Dict[str, np.ndarray]]:
    """FunASR am.mvn: <AddShift> means + <Rescale> inverse stddevs over the
    LFR-stacked feature width."""
    with open(path, encoding="utf-8") as f:
        text = f.read()

    def section_vector(tag: str) -> Optional[np.ndarray]:
        m = re.search(tag + r".*?\[([^\]]*)\]", text, re.DOTALL)
        if not m or not m.group(1).strip():
            return None
        return np.asarray([float(v) for v in m.group(1).split()], np.float32)

    shift = section_vector(r"<AddShift>")
    scale = section_vector(r"<Rescale>")
    if shift is None or scale is None:
        return None
    return {"cmvn_shift": shift, "cmvn_scale": scale}
