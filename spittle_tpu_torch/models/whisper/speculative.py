"""Speculative greedy decoding: a draft model proposes, the main model
verifies (port of spittle_tpu/models/whisper/speculative.py).

A draft Whisper with the main model's token table (a smaller checkpoint,
or the main decoder's own layer subset: WhisperEngine.load_self_draft)
proposes draft_k tokens with cheap K = 1 steps; the main model scores all
of them in one decode_block pass, which reads its weights and cross-K/V
once, as one step does. On the card that pass runs the cross-attention
kernel at draft_k rows per item (K4 bf16, K3 int8, K6 int4, K14 "w8a8").
The output is exactly the main model's greedy transcript.

Batched semantics, as the reference's: acceptance is per row, cache
positions are global, so each round advances 1 + the least acceptance
over unfinished rows; rows that accepted more re-derive those tokens in
later rounds. Cache columns above the advance point hold stale draft K/V,
never read (causal mask) and overwritten by the next block.

The loop is eager Python over device tensors; each round reads the
advance on the host, as the greedy loop reads its stop condition per
step. Temperature 0 only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from spittle_tpu_torch.parallel.mesh import local_params

from .config import WhisperConfig
from .decode import (
    DecodeOptions,
    _prefix,
    _process_logits,
    _static_suppress_mask,
    precompute_cross_kv_for,
)
from .model import decode_block, decode_step, decoder_prefill

# The config attributes a draft must share with the main model.
TOKEN_TABLE = ("n_vocab", "sot", "eot", "timestamp_begin", "lang_begin")


def _gather(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return x.gather(1, tok[:, None])[:, 0]


def _next_floor(prev, ts_floor, tok, ts_begin: int):
    """The timestamp floor after `tok`: a pair-closing timestamp may be
    equalled by the next opener (floor = tok), an opening one must be
    exceeded (tok + 1)."""
    return torch.where((prev >= ts_begin) | (ts_floor < ts_begin), tok + 1, tok)


def _speculative_loop(params, draft_params, xa, draft_xa, prefix,
                      cfg: WhisperConfig, draft_cfg: WhisperConfig,
                      opts: DecodeOptions, draft_k: int) -> Dict[str, Any]:
    b, dev = xa.shape[0], xa.device
    kk = draft_k
    prefix_len = prefix.shape[1]
    eot, ts_begin = cfg.eot, cfg.timestamp_begin
    # opts.max_tokens is the decode budget: the buffer holds prefix +
    # budget, clamped to the model's text context. A block may write up to
    # pos + K - 1 < max_len + K: the caches are sized for it, up to
    # n_text_ctx (past that, decode_block's clamps apply).
    max_len = min(cfg.n_text_ctx, prefix_len + (opts.max_tokens or cfg.n_text_ctx))
    ctx = min(cfg.n_text_ctx, -(-(max_len + kk) // 32) * 32)
    buf_len = max_len + kk
    static_mask = torch.from_numpy(
        _static_suppress_mask(cfg, opts, audio_ctx=xa.shape[1])).to(dev)
    # The draft takes the main model's quantization, so that acceptance
    # never compares mixed precisions.
    cross_kv = precompute_cross_kv_for(params, xa, cfg, opts)
    d_cross_kv = precompute_cross_kv_for(draft_params, draft_xa, draft_cfg, opts)
    pre_logits, cache = decoder_prefill(params, prefix, cross_kv, cfg, ctx,
                                        quant_cache=opts.quant_cache)
    _, d_cache = decoder_prefill(draft_params, prefix, d_cross_kv, draft_cfg, ctx,
                                 quant_cache=opts.quant_cache)

    def proc(logits, pos, last, penult, ts_floor):
        return _process_logits(
            logits, cfg=cfg, opts=opts, static_mask=static_mask, pos=pos,
            sample_begin=prefix_len, last_tok=last, penult_tok=penult,
            ts_floor=ts_floor)

    tokens = torch.full((b, buf_len), eot, dtype=torch.int64, device=dev)
    tokens[:, :prefix_len] = prefix
    pos = prefix_len
    cur_logits = pre_logits[:, -1].to(torch.float32)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    # ts_begin - 1: "no timestamp sampled yet" (bans nothing).
    ts_floor = torch.full((b,), ts_begin - 1, dtype=torch.int64, device=dev)
    sum_logprob = torch.zeros(b, dtype=torch.float32, device=dev)
    length = torch.zeros(b, dtype=torch.int64, device=dev)
    rounds = accepted_total = 0
    while pos < max_len and not bool(finished.all()):
        last0 = tokens[:, max(pos - 1, 0)]
        penult0 = tokens[:, max(pos - 2, 0)]
        # Token 0 is free: the main model's logits for `pos` are in hand.
        logits0 = proc(cur_logits, pos, last0, penult0, ts_floor)
        lsm0 = torch.log_softmax(logits0, dim=-1)
        t0 = torch.where(finished, eot, torch.argmax(logits0, dim=-1))

        # The draft chain: [t0, d1..d_{K-1}] fed at pos..pos+K-1, so the
        # draft cache stays valid under full acceptance; the same logits
        # rules, with the draft's own rolling last/penult/ts_floor.
        tok, penult, ts_d = t0, last0, ts_floor
        block = [t0]
        for j in range(kk):
            d_logits = decode_step(draft_params, tok, pos + j, d_cache, d_cross_kv,
                                   draft_cfg, audio_ctx=draft_xa.shape[1])
            ts_d = torch.where((tok >= ts_begin) & ~finished,
                               _next_floor(penult, ts_d, tok, ts_begin), ts_d)
            pl = proc(d_logits.to(torch.float32), pos + j + 1, tok, penult, ts_d)
            nxt = torch.where(finished, eot, torch.argmax(pl, dim=-1))
            tok, penult = nxt, tok
            if j < kk - 1:
                block.append(nxt)
        block = torch.stack(block, dim=1)  # [B, K]: block[:, j] at pos + j

        # The main model verifies the whole block in one pass.
        logits_blk = decode_block(params, block, pos, cache, cross_kv, cfg,
                                  audio_ctx=xa.shape[1]).to(torch.float32)

        # Rules-processed argmax at each block position, as if the block
        # before it were accepted: m_all[j] is the greedy token for
        # pos + j + 1.
        last, penult, tsf = last0, penult0, ts_floor
        m_all, lsm_all = [], []
        for j in range(kk):
            tok_j = block[:, j]
            tsf = torch.where((tok_j >= ts_begin) & ~finished,
                              _next_floor(last, tsf, tok_j, ts_begin), tsf)
            pl = proc(logits_blk[:, j], pos + j + 1, tok_j, last, tsf)
            m_all.append(torch.argmax(pl, dim=-1))
            lsm_all.append(torch.log_softmax(pl, dim=-1))
            last, penult = tok_j, last

        # Per-row acceptance of the drafts block[:, j] (j >= 1) and the
        # uniform advance over the unfinished rows (1..K).
        acc = torch.zeros(b, dtype=torch.int64, device=dev)
        if kk > 1:
            match = (block[:, 1:] == torch.stack(m_all[:kk - 1], dim=1)).long()
            acc = torch.cumprod(match, dim=1).sum(dim=1)
        acc = torch.where(finished, kk - 1, acc)
        advance = 1 + int(acc.min())
        if opts.rig_advance:
            advance = min(opts.rig_advance, kk)

        # Emit block[:, :advance] (and nothing at or past max_len).
        for j in range(min(advance, max_len - pos)):
            tok_j = block[:, j]
            lp_j = _gather(lsm0 if j == 0 else lsm_all[j - 1], tok_j)
            newly = ~finished
            sum_logprob = sum_logprob + torch.where(newly, lp_j, 0.0)
            length = length + newly.long()
            prev_j = last0 if j == 0 else block[:, j - 1]
            ts_floor = torch.where((tok_j >= ts_begin) & newly,
                                   _next_floor(prev_j, ts_floor, tok_j, ts_begin),
                                   ts_floor)
            finished = finished | (tok_j == eot)

        tokens[:, pos:pos + kk] = block
        # The raw main-model logits of the last accepted slot: the next
        # round applies the rules once, as the greedy loop does.
        cur_logits = logits_blk[:, advance - 1]
        pos += advance
        rounds += 1
        accepted_total += advance

    # Discard the overshoot and the stale drafts past the final position.
    tokens[:, min(pos, max_len):] = eot
    return dict(tokens=tokens[:, :max_len], pre_logits=pre_logits,
                sum_logprob=sum_logprob, length=length, rounds=rounds,
                accepted_total=accepted_total)


@torch.inference_mode()
def speculative_greedy_decode(
    params,
    draft_params,
    xa: torch.Tensor,
    draft_xa: torch.Tensor,
    cfg: WhisperConfig,
    draft_cfg: WhisperConfig,
    opts: DecodeOptions = DecodeOptions(),
    draft_k: int = 4,
    lang_tokens: Optional[torch.Tensor] = None,
    prompt_tokens: Sequence[int] = (),
) -> Dict[str, Any]:
    """greedy_decode's surface, with a draft model (draft_params over its
    own encoder output draft_xa [B, T', D']) proposing draft_k tokens per
    main-model pass. The tokens are greedy_decode's at temperature 0 (the
    timing rig, opts.rig_advance, aside).

    Returns "tokens" [B, L], "sample_begin", "avg_logprob" [B],
    "no_speech_prob" [B], "length" [B] (tokens emitted), "rounds" and
    "accepted_total" (main-model passes and positions advanced, ints) and
    "steps" (= rounds, the main-model passes after the prefill). Raises
    ValueError at a temperature other than 0 and where the draft's token
    table differs from the main model's."""
    if opts.temperature != 0.0:
        raise ValueError("speculative decoding is temperature-0 only")
    for attr in TOKEN_TABLE:
        if getattr(cfg, attr) != getattr(draft_cfg, attr):
            raise ValueError(
                f"draft/main token layout mismatch on {attr}: "
                f"{getattr(draft_cfg, attr)} vs {getattr(cfg, attr)}")
    prefix, sot_pos = _prefix(cfg, opts, xa.shape[0], lang_tokens, prompt_tokens,
                              xa.device)
    out = _speculative_loop(local_params(params), local_params(draft_params),
                            xa, draft_xa, prefix, cfg, draft_cfg, opts, draft_k)
    pre_logits = out["pre_logits"]
    no_speech_prob = torch.softmax(
        pre_logits[:, min(sot_pos, pre_logits.shape[1] - 1)].to(torch.float32),
        dim=-1)[:, cfg.no_speech]
    avg_logprob = out["sum_logprob"] / torch.clamp(out["length"], min=1).to(
        torch.float32)
    return {
        "tokens": out["tokens"],
        "sample_begin": prefix.shape[1],
        "avg_logprob": avg_logprob,
        "no_speech_prob": no_speech_prob,
        "length": out["length"],
        "rounds": out["rounds"],
        "accepted_total": out["accepted_total"],
        "steps": out["rounds"],
    }
