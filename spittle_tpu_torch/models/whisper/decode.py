"""Whisper decoding with whisper.cpp's logits rules (port of
spittle_tpu/models/whisper/decode.py: DecodeOptions, sot_sequence,
_static_suppress_mask, _process_logits, the greedy loop at temperature 0
and its sampling form above it, the no_speech_prob / avg_logprob
summaries, and detect_language).

The loop is eager Python over device tensors of static shape (the token
buffer, the KV cache and the per-row state never change shape), so a later
change can capture one step in a CUDA graph. It stops when every row has
finished or the budget is spent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spittle_tpu_torch.ops.quant import (
    quantize_kv,
    quantize_kv_int4,
    quantize_kv_w8a8,
)
from spittle_tpu_torch.parallel.mesh import local_params

from .config import WhisperConfig
from .model import (
    decode_step,
    decoder_prefill,
    init_kv_cache,
    precompute_cross_kv,
    precompute_cross_kv_quant,
    self_heads,
)
from .tokenizer import LANGUAGES, LANGUAGES_V3

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    task: str = "transcribe"  # or "translate"
    language: Optional[str] = None  # None -> auto-detect
    timestamps: bool = True
    max_initial_timestamp: float = 1.0  # seconds
    suppress_blank: bool = True
    suppress_tokens: Tuple[int, ...] = ()  # always-suppressed token ids
    space_token: Optional[int] = None  # id of " " for blank suppression
    max_tokens: int = 0  # decode budget; 0 -> n_text_ctx
    temperature: float = 0.0  # 0 = argmax; > 0 = categorical sampling
    seed: int = 0  # seed of the sampling noise, drawn afresh per decode call
    # Quantized cross-attention K/V, int8 (K3 on the card) or int4 packed
    # two per byte (K6); quant_kv_bits is read only when quant_kv is set.
    quant_kv: bool = False
    quant_kv_bits: int = 8
    # int8 cross-attention with both products int8 x int8, q and P
    # quantized per row (K14 on the card); read only when quant_kv is set
    # and quant_kv_bits is 8. Beam search ignores it (the reference's
    # route: plain int8 K/V, K3).
    quant_kv_w8a8: bool = False
    # int8 self-attention cache, one scale per position.
    quant_cache: bool = False
    # Speculative decoding's timing rig: when non-zero, every round
    # advances min(rig_advance, draft_k) positions whatever the draft and
    # the main model agree on, so the tokens are NOT the main model's
    # greedy transcript. Never set by the engine (the reference's engine
    # reads it from SPITTLE_SPEC_RIG; the port reads no environment).
    rig_advance: int = 0

    def __post_init__(self):
        # Only 4 or 8: the reference reads any other width as int4.
        if self.quant_kv_bits not in (4, 8):
            raise ValueError(
                f"quant_kv_bits must be 4 or 8, got {self.quant_kv_bits!r}")


def sot_sequence(
    cfg: WhisperConfig,
    lang_token: Optional[int] = None,
    task: str = "transcribe",
    timestamps: bool = True,
) -> Tuple[int, ...]:
    """[sot, language, task, (notimestamps)] for multilingual models,
    [sot, (notimestamps)] for English-only."""
    seq = [cfg.sot]
    if cfg.multilingual:
        seq.append(lang_token if lang_token is not None else cfg.lang_begin)
        seq.append(cfg.translate if task == "translate" else cfg.transcribe)
    if not timestamps:
        seq.append(cfg.no_timestamps)
    return tuple(seq)


def _static_suppress_mask(
    cfg: WhisperConfig, opts: DecodeOptions, audio_ctx: int = 0
) -> np.ndarray:
    """Additive [V] mask of always-suppressed tokens. audio_ctx: encoder
    positions present; timestamps past the encoded audio are suppressed."""
    mask = np.zeros(cfg.n_vocab, np.float32)
    always = [cfg.sot, cfg.sot_prev, cfg.sot_lm, cfg.no_speech,
              cfg.translate, cfg.transcribe]
    always.extend(range(cfg.lang_begin, cfg.lang_begin + cfg.n_langs))
    for t in always:
        mask[t] = NEG_INF
    for t in opts.suppress_tokens:
        mask[t] = NEG_INF
    if opts.timestamps:
        mask[cfg.no_timestamps] = NEG_INF
        if audio_ctx:
            mask[cfg.timestamp_begin + audio_ctx + 1:] = NEG_INF
    else:
        mask[cfg.timestamp_begin:] = NEG_INF
    return mask


def _process_logits(
    logits: torch.Tensor,  # [B, V] float32
    *,
    cfg: WhisperConfig,
    opts: DecodeOptions,
    static_mask: torch.Tensor,  # [V]
    pos: int,  # index being sampled
    sample_begin: int,
    last_tok: torch.Tensor,  # [B]
    penult_tok: torch.Tensor,  # [B]
    ts_floor: torch.Tensor,  # [B] minimum allowed timestamp token
) -> torch.Tensor:
    ts_begin = cfg.timestamp_begin
    vocab_idx = torch.arange(cfg.n_vocab, device=logits.device)
    is_ts = vocab_idx >= ts_begin

    logits = logits + static_mask[None]

    at_begin = pos == sample_begin
    if at_begin and opts.suppress_blank and opts.space_token is not None:
        blank = (vocab_idx == opts.space_token) | (vocab_idx == cfg.eot)
        logits = torch.where(blank[None], NEG_INF, logits)

    if opts.timestamps:
        last_is_ts = last_tok >= ts_begin
        # penultimate_was_timestamp is True while fewer than two tokens
        # have been sampled (OpenAI ApplyTimestampRules).
        penult_is_ts = (penult_tok >= ts_begin) | (pos - sample_begin < 2)
        started = pos > sample_begin
        no_ts_now = last_is_ts & penult_is_ts & started
        force_ts = last_is_ts & ~penult_is_ts & started
        logits = torch.where(no_ts_now[:, None] & is_ts[None], NEG_INF, logits)
        text_not_eot = (~is_ts) & (vocab_idx != cfg.eot)
        logits = torch.where(force_ts[:, None] & text_not_eot[None], NEG_INF,
                             logits)
        # Non-decreasing timestamps.
        below_floor = is_ts[None] & (vocab_idx[None] < ts_floor[:, None])
        logits = torch.where(below_floor, NEG_INF, logits)
        if at_begin:
            # The first sampled token must be a timestamp, within the
            # initial-timestamp bound.
            logits = torch.where(~is_ts[None], NEG_INF, logits)
            if opts.max_initial_timestamp is not None:
                max_init = ts_begin + int(round(opts.max_initial_timestamp / 0.02))
                logits = torch.where((vocab_idx > max_init)[None] & is_ts[None],
                                     NEG_INF, logits)
        # Sample a timestamp when the total timestamp probability beats the
        # best text token (the sum-probability rule).
        lsm = torch.log_softmax(logits, dim=-1)
        ts_logprob = torch.logsumexp(torch.where(is_ts[None], lsm, NEG_INF),
                                     dim=-1)
        max_text = torch.where(is_ts[None], NEG_INF, lsm).amax(dim=-1)
        force = ts_logprob > max_text
        logits = torch.where(force[:, None] & ~is_ts[None], NEG_INF, logits)
    return logits


def _prefix(cfg: WhisperConfig, opts: DecodeOptions, b: int,
            lang_tokens: Optional[torch.Tensor],
            prompt_tokens: Sequence[int], device) -> Tuple[torch.Tensor, int]:
    """[B, P] prompt + SOT sequence (int64, on `device`) and the SOT's
    position. lang_tokens [B] (from detect_language, on any device) fill
    the language column; no device->host copy is made."""
    sot_seq = list(sot_sequence(cfg, lang_token=0, task=opts.task,
                                timestamps=opts.timestamps))
    prompt_prefix = [cfg.sot_prev, *prompt_tokens] if prompt_tokens else []
    sot_pos = len(prompt_prefix)
    prefix = torch.tensor(prompt_prefix + sot_seq, dtype=torch.int64,
                          device=device)[None].repeat(b, 1)
    if cfg.multilingual:
        if lang_tokens is None:
            lang = cfg.lang_begin
            if opts.language is not None:
                langs = LANGUAGES_V3 if cfg.n_langs == 100 else LANGUAGES
                lang += langs.index(opts.language)
            prefix[:, sot_pos + 1] = lang
        else:
            prefix[:, sot_pos + 1] = lang_tokens.to(device=device,
                                                    dtype=torch.int64)
    return prefix, sot_pos


def precompute_cross_kv_for(params, xa: torch.Tensor, cfg: WhisperConfig,
                            opts: DecodeOptions):
    """The cross-K/V greedy and speculative decoding read under opts: the
    model's dtype, or quantized one layer at a time (the full bf16 pair
    never exists) to int8 ("qw"), int8 for the int8 x int8 products
    ("qw8", quant_kv_w8a8) or packed int4 ("qw4")."""
    if not opts.quant_kv:
        return precompute_cross_kv(params, xa, cfg)
    quant = (quantize_kv_int4 if opts.quant_kv_bits == 4
             else quantize_kv_w8a8 if opts.quant_kv_w8a8 else quantize_kv)
    return precompute_cross_kv_quant(params, xa, cfg, quant)


def gumbel_noise(shape, seed: int, device) -> Callable[[int], torch.Tensor]:
    """The sampling noise of one decode call: for each sampled position,
    in loop order, a fresh f32 tensor -log(-log(u)) with u uniform on
    [finfo(f32).tiny, 1), drawn from a torch.Generator on `device` seeded
    with `seed` (the form of jax.random.categorical's Gumbel noise; its
    values are torch's, not JAX's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tiny = torch.finfo(torch.float32).tiny

    def draw(step: int) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=device).clamp_min_(tiny)
        return -torch.log(-torch.log(u))

    return draw


@torch.inference_mode()
def greedy_decode(
    params,
    xa: torch.Tensor,
    cfg: WhisperConfig,
    opts: DecodeOptions = DecodeOptions(),
    lang_tokens: Optional[torch.Tensor] = None,
    prompt_tokens: Sequence[int] = (),
    noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Decode a batch of encoded windows xa [B, T, D]: argmax at
    temperature 0; above it, argmax(noise + logits / T) per position, a
    categorical draw from softmax(logits / T), the step's log-prob still
    taken from the unscaled logits.

    noise: the sampled positions' [B, V] Gumbel noise, called with the
    position's index from 0 in loop order; by default gumbel_noise seeded
    with opts.seed on xa's device (a test passes the reference's noise).
    Unused at temperature 0, which draws none.

    Returns "tokens" [B, L] (prefix + generated, EOT-padded, on xa's
    device), "sample_begin", "avg_logprob" [B], "no_speech_prob" [B] and
    "steps" (decode steps run after the prefill). params may be a sharded
    tree (parallel/mesh.py): localized once, here."""
    params = local_params(params)
    b, dev = xa.shape[0], xa.device
    sample = opts.temperature > 0
    if sample:
        # A device tensor: division by a Python scalar on CUDA is a
        # reciprocal multiply, not the reference's division.
        temperature = torch.tensor(max(opts.temperature, 1e-6),
                                   dtype=torch.float32, device=dev)
        if noise is None:
            noise = gumbel_noise((b, cfg.n_vocab), opts.seed, dev)
    prefix, sot_pos = _prefix(cfg, opts, b, lang_tokens, prompt_tokens, dev)
    prefix_len = prefix.shape[1]
    # opts.max_tokens is the decode budget: the buffer holds prefix +
    # budget, clamped to the model's text context.
    max_len = min(cfg.n_text_ctx, prefix_len + (opts.max_tokens or cfg.n_text_ctx))
    ctx = min(cfg.n_text_ctx, -(-max_len // 32) * 32)
    audio_ctx = xa.shape[1]
    cross_kv = precompute_cross_kv_for(params, xa, cfg, opts)
    static_mask = torch.from_numpy(
        _static_suppress_mask(cfg, opts, audio_ctx=audio_ctx)
    ).to(dev)
    all_logits, cache = decoder_prefill(params, prefix, cross_kv, cfg, ctx,
                                        quant_cache=opts.quant_cache)

    ts_begin = cfg.timestamp_begin
    tokens = torch.full((b, max_len), cfg.eot, dtype=torch.int64, device=dev)
    tokens[:, :prefix_len] = prefix
    cur_logits = all_logits[:, -1].to(torch.float32)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    # ts_begin - 1: "no timestamp sampled yet" (bans nothing).
    ts_floor = torch.full((b,), ts_begin - 1, dtype=torch.int64, device=dev)
    sum_logprob = torch.zeros(b, dtype=torch.float32, device=dev)
    length = torch.zeros(b, dtype=torch.int64, device=dev)
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
        if sample:
            next_tok = torch.argmax(noise(pos - prefix_len) + logits / temperature,
                                    dim=-1)
        else:
            next_tok = torch.argmax(logits, dim=-1)
        step_lp = torch.log_softmax(logits, dim=-1).gather(
            1, next_tok[:, None])[:, 0]
        next_tok = torch.where(finished, cfg.eot, next_tok)
        newly = ~finished
        sum_logprob = sum_logprob + torch.where(newly, step_lp, 0.0)
        length = length + newly.to(torch.int64)
        tokens[:, pos] = next_tok
        # A pair-closing timestamp may be equalled by the next opener
        # (floor = ts); an opening one must be strictly exceeded (ts + 1).
        is_ts = next_tok >= ts_begin
        last_is_ts = last >= ts_begin
        first_ts = ts_floor < ts_begin
        new_floor = torch.where(last_is_ts | first_ts, next_tok + 1, next_tok)
        ts_floor = torch.where(is_ts & newly, new_floor, ts_floor)
        finished = finished | (next_tok == cfg.eot)
        pos += 1
        if pos >= max_len or bool(finished.all()):
            break
        cur_logits = decode_step(params, next_tok, pos - 1, cache, cross_kv,
                                 cfg, audio_ctx=audio_ctx)
        steps += 1

    no_speech_prob = torch.softmax(all_logits[:, sot_pos].to(torch.float32),
                                   dim=-1)[:, cfg.no_speech]
    avg_logprob = sum_logprob / torch.clamp(length, min=1).to(torch.float32)
    return {
        "tokens": tokens,
        "sample_begin": prefix_len,
        "avg_logprob": avg_logprob,
        "no_speech_prob": no_speech_prob,
        "length": length,
        "steps": steps,
    }


@torch.inference_mode()
def detect_language(params, xa: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """Language probabilities [B, n_langs] (f32) from one decode step of
    [sot] at position 0. As in the reference, the cross-K/V and the
    one-step cache (ctx 32) are unquantized whatever the decoder's
    quantization, so on the card the step's cross-attention is K4 at
    R = 1."""
    params = local_params(params)
    b = xa.shape[0]
    cross_kv = precompute_cross_kv(params, xa, cfg)
    cache = init_kv_cache(cfg, b, dtype=xa.dtype, ctx=32, device=xa.device,
                          heads=self_heads(params, cfg))
    sot = torch.full((b,), cfg.sot, dtype=torch.int64, device=xa.device)
    logits = decode_step(params, sot, 0, cache, cross_kv, cfg,
                         audio_ctx=xa.shape[1])
    lang = logits[:, cfg.lang_begin : cfg.lang_begin + cfg.n_langs]
    return torch.softmax(lang.to(torch.float32), dim=-1)
