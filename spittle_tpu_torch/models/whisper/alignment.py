"""Word-level timestamps from cross-attention DTW (port of
spittle_tpu/models/whisper/alignment.py).

A teacher-forced decoder pass over the decoded tokens captures the
cross-attention probabilities (plain torch ops on every device, as the
reference leaves the pass to XLA); the alignment heads (the upper half of
the decoder layers unless an alignment_heads.json sidecar names others)
are normalised, median-filtered over audio time and averaged, and a
monotonic DTW path maps each token to the frame where it is emitted, at
0.02 s per audio position. Tokens merge into words at space boundaries.
The numpy half is the reference's, line for line.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spittle_tpu_torch.ops.attention import attention_reference, merge_heads, split_heads

from .config import WhisperConfig
from .model import _mlp, layer_norm, layer_params, n_layers, precompute_cross_kv

TIME_PER_FRAME = 0.02


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float


@torch.inference_mode()
def decoder_cross_attention(params, tokens: torch.Tensor, xa: torch.Tensor,
                            cfg: WhisperConfig) -> torch.Tensor:
    """Teacher-forced pass over tokens [B, T] against the encoder output
    xa [B, Tk, D] -> the cross-attention probabilities [L, B, H, T, Tk]
    (f32). Causal self-attention over the whole sequence; scores in f32,
    the probabilities in the weights' dtype for the PV product. Decoder
    weights must be plain tensors: a quantized decoder's dicts raise
    TypeError, as they do in the reference."""
    dec = params["decoder"]
    t = tokens.shape[1]
    h = cfg.n_text_head
    x = (dec["tok_emb"][tokens] + dec["pos_emb"][None, :t]).to(dec["tok_emb"].dtype)
    cross_k, cross_v = precompute_cross_kv(params, xa, cfg)
    blocks = dec["blocks"]
    probs_by_layer = []
    for layer in range(n_layers(blocks)):
        blk = layer_params(blocks, layer)
        xn = layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"])
        scale = (xn.shape[-1] // h) ** -0.25
        q = split_heads(xn @ blk["wq"] + blk["bq"], h) * scale
        k = split_heads(xn @ blk["wk"], h) * scale
        v = split_heads(xn @ blk["wv"] + blk["bv"], h)
        o = attention_reference(q, k, v, causal=True)
        x = x + merge_heads(o) @ blk["wo"] + blk["bo"]

        xn = layer_norm(x, blk["cross_ln_g"], blk["cross_ln_b"])
        dh = xn.shape[-1] // h
        cq = split_heads(xn @ blk["cross_wq"] + blk["cross_bq"], h) * dh ** -0.25
        ck, cv = cross_k[layer], cross_v[layer]  # [B, H, Dh, Tk]
        scores = torch.matmul(cq.float(), (ck * dh ** -0.25).float())
        probs = torch.softmax(scores, dim=-1)
        co = torch.matmul(probs.to(cv.dtype), cv.transpose(-1, -2))
        x = x + merge_heads(co) @ blk["cross_wo"] + blk["cross_bo"]
        x = x + _mlp(layer_norm(x, blk["mlp_ln_g"], blk["mlp_ln_b"]), blk)
        probs_by_layer.append(probs)
    return torch.stack(probs_by_layer)


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (audio time), reflect-padded, as
    OpenAI's timing.py median_filter pads."""
    if width <= 1 or x.shape[-1] <= 1:
        return x
    pad = min(width // 2, x.shape[-1] - 1)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.stack(
        [xp[..., i : i + x.shape[-1]] for i in range(2 * pad + 1)], axis=-1
    )
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over cost [N_text, M_audio] -> (text_idx, audio_idx).

    Ties break as OpenAI timing.py's dtw_cpu breaks them: the diagonal
    only when strictly smaller than both others, then up, else left."""
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), np.int8)
    for i in range(1, n + 1):
        c_row = cost[i - 1]
        for j in range(1, m + 1):
            c0, c1, c2 = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
            if c0 < c1 and c0 < c2:
                D[i, j] = c0 + c_row[j - 1]
                trace[i, j] = 0
            elif c1 < c0 and c1 < c2:
                D[i, j] = c1 + c_row[j - 1]
                trace[i, j] = 1
            else:
                D[i, j] = c2 + c_row[j - 1]
                trace[i, j] = 2
    ti, ai = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ti.append(i - 1)
        ai.append(j - 1)
        step = trace[i, j]
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(ai[::-1])


def alignment_heads(cfg: WhisperConfig) -> List[Tuple[int, int]]:
    """(layer, head) pairs: every head of the upper half of the decoder
    layers (OpenAI's fallback when no per-model set is known)."""
    start = cfg.n_text_layer // 2
    return [(l, h) for l in range(start, cfg.n_text_layer)
            for h in range(cfg.n_text_head)]


def load_alignment_heads(model_path: str) -> Optional[List[Tuple[int, int]]]:
    """A model's DTW heads from the `alignment_heads.json` sidecar
    (`[[layer, head], ...]`) beside the weights (model_path a file or a
    directory); None when there is none."""
    base = model_path if os.path.isdir(model_path) else os.path.dirname(model_path)
    path = os.path.join(base, "alignment_heads.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return [(int(l), int(h)) for l, h in data]


def token_emission_times(
    attn: np.ndarray,  # [L, 1, H, T, Tk] for one item
    n_prefix: int,
    n_frames: int,
    cfg: WhisperConfig,
    heads: Optional[Sequence[Tuple[int, int]]] = None,
) -> np.ndarray:
    """Emission times (seconds) of the generated tokens and the EOT, by
    OpenAI timing.py's find_alignment: the alignment heads' probabilities
    cut to the valid frames and renormalised, z-normalised over the token
    axis per (head, frame) with the population std, median-filtered over
    time, averaged over heads; the rows n_prefix-1 .. T-2 (row i attends
    while predicting token i+1) go through DTW, and each row's first path
    position is its emission time. attn covers prefix + text + [eot] (T
    rows); returns T - n_prefix times."""
    heads = heads or alignment_heads(cfg)
    w = np.stack([attn[l, 0, h] for l, h in heads])  # [NH, T, Tk]
    w = w[:, :, : max(n_frames, 1)].astype(np.float64)
    w = w / (w.sum(-1, keepdims=True) + 1e-10)
    mean = w.mean(-2, keepdims=True)
    std = w.std(-2, keepdims=True)
    w = (w - mean) / (std + 1e-10)
    w = _median_filter(w)
    matrix = w.mean(0)  # [T, frames]
    matrix = matrix[max(n_prefix, 1) - 1 : -1]
    text_idx, audio_idx = dtw_path(-matrix)
    jumps = np.pad(np.diff(text_idx), (1, 0), constant_values=1).astype(bool)
    return audio_idx[jumps] * TIME_PER_FRAME


def word_timestamps(
    params,
    tokens: Sequence[int],
    xa: torch.Tensor,  # [1, Tk, D]
    n_frames: int,
    cfg: WhisperConfig,
    tokenizer,
    prefix: Sequence[int] = (),
    heads: Optional[Sequence[Tuple[int, int]]] = None,
) -> List[WordTiming]:
    """Word timings of one decoded window. tokens: the generated ids (no
    prefix, no EOT); prefix: the decode's prompt and SOT sequence, which
    the teacher-forced pass replays; n_frames: the window's encoder
    positions that hold audio."""
    text_toks = [t for t in tokens if t < cfg.eot]
    if not text_toks or not prefix:
        return []
    full = list(prefix) + text_toks + [cfg.eot]
    # A 64-token length bucket, as the reference compiles once per bucket
    # (causal attention: the padding after the real tokens changes none of
    # their rows); a sequence past n_text_ctx is cut to it.
    bucket = min(-(-len(full) // 64) * 64, cfg.n_text_ctx)
    padded = full[:bucket] + [cfg.eot] * (bucket - len(full))
    arr = torch.tensor([padded], dtype=torch.int64, device=xa.device)
    attn = decoder_cross_attention(params, arr, xa, cfg).cpu().numpy()
    attn = attn[:, :, :, : len(full)]
    # jump_times[i]: the emission time of text_toks[i]; [-1] the EOT's. A
    # word starts at its first token's time and ends at the next word's.
    jump_times = token_emission_times(attn, len(prefix), n_frames, cfg, heads=heads)
    n_text = len(text_toks)
    if len(jump_times) != n_text + 1:  # the bucket's cut dropped tokens
        n_text = max(len(jump_times) - 1, 0)
        text_toks = text_toks[:n_text]

    groups: List[List[int]] = []  # token indices, one list per word
    for i, tok in enumerate(text_toks):
        piece = tokenizer.decode([tok])
        if groups and not piece.startswith(" "):
            groups[-1].append(i)
        else:
            groups.append([i])

    words: List[WordTiming] = []
    for g, group in enumerate(groups):
        text = tokenizer.decode([text_toks[i] for i in group]).strip()
        if not text:
            continue
        start = float(jump_times[group[0]])
        next_idx = groups[g + 1][0] if g + 1 < len(groups) else n_text
        end = float(jump_times[next_idx])
        words.append(WordTiming(text, start, end))
    return words
