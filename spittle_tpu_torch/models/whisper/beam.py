"""Batched beam-search decoding for Whisper (port of
spittle_tpu/models/whisper/beam.py).

Every batch item carries `beam_size` hypotheses; one loop steps all B*K
beams through the self-attention cache, the logits pass through the same
suppression and timestamp rules as greedy, and reselection gathers the
cache along the beam axis. Finished beams are frozen (score kept, EOT
re-emitted), and the search stops when every beam of every item has
finished or the context is full. Scoring is the sum log-prob
(whisper.cpp's default, patience 1.0); the best beam per item is picked by
its length-normalised score.

The cross-K/V is computed once per item: the cross-attention folds an
item's beams into its query rows (model.py:_cross_attention), so on the
card a step reads each item's K/V once, in K4 (bf16), K3 (int8, the
"w8a8" decoder's too: the reference's beam search quantizes to plain int8
whatever quant_kv_w8a8 says) or K6 (int4) at beam_size rows per item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from spittle_tpu_torch.ops.quant import quantize_kv, quantize_kv_int4
from spittle_tpu_torch.parallel.mesh import local_params

from .config import WhisperConfig
from .decode import (
    NEG_INF,
    DecodeOptions,
    _prefix,
    _process_logits,
    _static_suppress_mask,
)
from .model import decode_step, decoder_prefill, precompute_cross_kv, precompute_cross_kv_quant


def _expand_beams(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, ...] -> [B*K, ...], each item repeated K times in a row."""
    return torch.repeat_interleave(x, k, dim=0)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, equal values in ascending index order: the order
    jax.lax.top_k gives (torch.topk leaves the order of ties open)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_cache(cache, src: torch.Tensor):
    """The self-attention cache's beams reordered by src along axis 2
    (B*K of [L, 2, B*K, H, ctx, Dh], and of the int8 dict's qw and
    scale [L, 2, B*K, H, ctx])."""
    if isinstance(cache, dict):
        return {key: a.index_select(2, src) for key, a in cache.items()}
    return cache.index_select(2, src)


@torch.inference_mode()
def beam_decode(
    params,
    xa: torch.Tensor,
    cfg: WhisperConfig,
    opts: DecodeOptions = DecodeOptions(),
    beam_size: int = 5,
    lang_tokens: Optional[torch.Tensor] = None,
    prompt_tokens: Sequence[int] = (),
) -> Dict[str, Any]:
    """Beam-search decode of encoded windows xa [B, T, D]; greedy_decode's
    surface plus beam_size (opts.temperature is not read). Returns
    "tokens" [B, L] (the best beam's prefix + generated tokens,
    EOT-padded), "sample_begin", "avg_logprob" [B] (its sum log-prob over
    its length), "no_speech_prob" [B] (from the prefill's logits at the
    SOT position) and "steps" (decode steps run after the prefill)."""
    params = local_params(params)
    b, dev = xa.shape[0], xa.device
    k = beam_size
    bk = b * k
    prefix, sot_pos = _prefix(cfg, opts, b, lang_tokens, prompt_tokens, dev)
    prefix_len = prefix.shape[1]
    # opts.max_tokens is the decode budget: the buffer holds prefix +
    # budget, clamped to the model's text context.
    max_len = min(cfg.n_text_ctx, prefix_len + (opts.max_tokens or cfg.n_text_ctx))
    ctx = min(cfg.n_text_ctx, -(-max_len // 32) * 32)
    audio_ctx = xa.shape[1]
    static_mask = torch.from_numpy(
        _static_suppress_mask(cfg, opts, audio_ctx=audio_ctx)).to(dev)
    # One cross-K/V per item, shared by its beams. Under quant_kv_w8a8
    # too the int8 K/V is plain "qw" (K3), as the reference routes it.
    if opts.quant_kv:
        quant = quantize_kv if opts.quant_kv_bits == 8 else quantize_kv_int4
        cross_kv = precompute_cross_kv_quant(params, xa, cfg, quant)
    else:
        cross_kv = precompute_cross_kv(params, xa, cfg)
    prefix_k = _expand_beams(prefix, k)
    all_logits, cache = decoder_prefill(params, prefix_k, cross_kv, cfg, ctx,
                                        quant_cache=opts.quant_cache)

    ts_begin = cfg.timestamp_begin
    tokens = torch.full((bk, max_len), cfg.eot, dtype=torch.int64, device=dev)
    tokens[:, :prefix_len] = prefix_k
    cur_logits = all_logits[:, -1].to(torch.float32)
    # Beam 0 of each item starts live, the others at NEG_INF, so that the
    # first expansion seeds K distinct hypotheses from beam 0's top K.
    scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    scores = scores.reshape(bk)
    finished = torch.zeros(bk, dtype=torch.bool, device=dev)
    # ts_begin - 1: "no timestamp sampled yet" (bans nothing).
    ts_floor = torch.full((bk,), ts_begin - 1, dtype=torch.int64, device=dev)
    length = torch.zeros(bk, dtype=torch.int64, device=dev)
    item_base = torch.arange(b, device=dev)[:, None] * k
    not_first = torch.arange(k, device=dev)[None, :] > 0
    steps = 0
    pos = prefix_len
    while pos < max_len:
        last = tokens[:, pos - 1]
        penult = tokens[:, max(pos - 2, 0)]
        logits = _process_logits(
            cur_logits, cfg=cfg, opts=opts, static_mask=static_mask, pos=pos,
            sample_begin=prefix_len, last_tok=last, penult_tok=penult,
            ts_floor=ts_floor,
        )
        logprobs = torch.log_softmax(logits, dim=-1)  # [B*K, V]
        # Candidates: a live beam expands over its top K tokens; a
        # finished beam offers one frozen EOT candidate at its score.
        top_lp, top_tok = top_k(logprobs, k)  # [B*K, K]
        fin = finished[:, None]
        cand_scores = scores[:, None] + torch.where(fin, 0.0, top_lp)
        cand_scores = torch.where(fin & not_first, NEG_INF, cand_scores)
        cand_tok = torch.where(fin, cfg.eot, top_tok)
        # Per item, the best K of its K*K candidates.
        sel_scores, sel_idx = top_k(cand_scores.reshape(b, k * k), k)
        new_tok = cand_tok.reshape(b, k * k).gather(1, sel_idx).reshape(bk)
        src = (item_base + sel_idx // k).reshape(bk)

        tokens = tokens.index_select(0, src)
        tokens[:, pos] = new_tok
        cache = _gather_cache(cache, src)
        finished = finished.index_select(0, src)
        ts_floor = ts_floor.index_select(0, src)
        length = length.index_select(0, src)
        scores = sel_scores.reshape(bk)

        newly = ~finished
        length = length + newly.to(torch.int64)
        # A pair-closing timestamp may be equalled by the next opener
        # (floor = ts); an opening one must be strictly exceeded (ts + 1).
        is_ts = new_tok >= ts_begin
        last_is_ts = last.index_select(0, src) >= ts_begin
        first_ts = ts_floor < ts_begin
        new_floor = torch.where(last_is_ts | first_ts, new_tok + 1, new_tok)
        ts_floor = torch.where(is_ts & newly, new_floor, ts_floor)
        finished = finished | (new_tok == cfg.eot)
        pos += 1
        if pos >= max_len or bool(finished.all()):
            break
        cur_logits = decode_step(params, new_tok, pos - 1, cache, cross_kv,
                                 cfg, audio_ctx=audio_ctx)
        steps += 1

    avg = scores.reshape(b, k) / torch.clamp(length.reshape(b, k), min=1).to(
        torch.float32)
    best = torch.argmax(avg, dim=1)  # the first of equal maxima, as jnp's
    rows = torch.arange(b, device=dev)
    no_speech_prob = torch.softmax(all_logits[::k, sot_pos].to(torch.float32),
                                   dim=-1)[:, cfg.no_speech]
    return {
        "tokens": tokens[rows * k + best],
        "sample_begin": prefix_len,
        "avg_logprob": avg[rows, best],
        "no_speech_prob": no_speech_prob,
        "steps": steps,
    }
