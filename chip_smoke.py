#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spittle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), and the build time of the kernels (built from
   spittle_tpu_torch/csrc on first use).
2. Kernels against their plain PyTorch versions at the main-path
   shapes with B=8 windows: K1 encoder attention (an instance of the TMA
   + wgmma attention core), K2 W8A8 GEMM (the six
   GEMMs of one encoder layer, its row quantizer and its persistent wgmma
   GEMM also timed apart), K4 decode cross-attention (bf16 K/V, the bf16
   instance of K3's kernel, on the decoder's rows padded to a 1504-position
   pitch; R = 1, 3, 4 and 5 (a beam step: five beams folded into an
   item's rows), once at B=48, bench.py's turbo batch, and at
   B=1, the app path's one window, with R = 1, 3 and 8), K3
   and K6 decode cross-attention over int8 and packed int4 K/V, the int8
   and int4 instances of the same kernel (R = 1, 3, 4, 5, and once at B=56,
   bench.py's large-v3 batch; on the decoder's rows padded to a 1504-byte
   pitch, K6 also on contiguous rows), and the
   encoder-attention forms K7 (int8 products on wgmma, its quantizers and
   attention also timed apart), K8 (packed heads, K1's
   instance of the core on the packed strides), K9 (head pairs, the
   core's other policy) and K10 (the core's persistent kernel, timed
   beside K1) at [8, 20, 1500, 64], each also with kv_len 1300 and K8/K9
   causal (K8 and K10 bit for bit against K1, K9 to K1's tolerance); K5
   tiled flash attention
   (K1's policy and tile) at [2, 20, 6000, 64] (kv_len 6000 and 5000,
   causal once, ragged shapes, once on contiguous [B, H, T, 64] tensors)
   and bit for bit against K1 on K1's inputs; K4 at an odd Tk, at
   Tk = 6000 with 8 rows and at Tk = 6500 with 8 rows; K1, K2 and K4
   again at the shapes the reduced-context path gives them (256
   positions: [8, 20, 256, 64], M = 2048, Tk = 256) and the app path
   gives them (one window: [1, 20, 1500, 64], M = 1500, Tk = 1500), K1
   timed and K10 bit for bit against it and timed, and K4 at the long
   window's prefill; K11 (K3's function over a
   batch item's K/V slab, a persistent grid fed by producer warps) at the
   decode cross-attention probe's shape on its TMA path (T 1536) and with
   T 1500 on its cp.async path, R = 1 and 3, each beside K3;
   K12 and K13 (in-place cache column writes) at the cache probe's shape,
   bit for bit against a slice assignment on a clone at the edges of a
   row's 32-byte sectors (K13 beside the floor of a sector in and out per
   row); K14 (the "w8a8" decoder's cross-attention, both products int8
   x int8; hand-written for an XLA product, not a TPU kernel) against
   its plain version on CPU copies at large-v3's decoder shapes (B 8, H
   20, T 1500 at a 1504-byte pitch; R = 1, 4, 8 and 228, R 4 with
   kv_len 1300 and 100, and R 1 at B 56), with its plan (regime, cluster
   size) per shape; K15 (K1's backward, hand-written for XLA's transpose
   of the attention, not a TPU kernel) at [8, 20, 1500, 64], [4, 20, 224,
   64] causal and kv_len 1300 of 1504, two calls and 50 calls
   bit-equal, its o and lse from K1's lse instance (o bit for bit K1's,
   lse within 1e-4 of the plain version's), beside SDPA's backward. Each
   prints its max
   error and tolerance, its time (`ms`: device time per launch from a
   CUDA graph of launches replayed between CUDA events; `call_ms`: eager
   calls between CUDA events, the host's per-call cost included), the
   plain version's time, a library yardstick the port never calls, and
   the bound from the H100 data-sheet peaks (K1, K5, K8 and K9 also their
   TFLOP/s and the floor of their exponentials on the special-function
   units).
   Then the weight-only int8
   decoder products of one decode step (plain matmuls, no kernel of
   their own), beside the same products on bf16 weights. Then K1 at
   [8, 10, 1500, 64] and [8, 5, 1500, 64], and K4 and K3 at 10 and 5 heads
   (B 8, R 1, rows of 1504): the heads one rank holds when tensor
   parallelism splits 20 over 2 or 4 ranks, each against its plain
   version, ms beside the 20-head ms (each row's "by_heads").
3. The trained tiny checkpoint (tests/data/trained_tiny) through the
   engine on the card must reproduce its golden greedy tokens, through
   transcribe_batch's parallel windows and through transcribe_samples
   with TranscribeParams() (its detected language must be the goldens'
   "en"; the rungs each case took are printed), and through
   transcribe_samples with beam_size=5 (the beam_tokens goldens of the
   first three cases) and word_timestamps=True (case 0's words), exact.
   Then the same checkpoint behind BatchingTranscriptionServer and
   TranscriptionHTTPServer (127.0.0.1, a free port): every case POSTed at
   once as raw f32 with no headers; texts, the detected language and the
   segments must equal the goldens.
   Then the same checkpoint with speculative decoding (a self-draft, then
   the checkpoint loaded again as a draft): every case's greedy goldens,
   with the mean last_spec_stats; and under quantize_decoder="w8a8" (K14
   in f32 at Dh 8), token for token equal to the port's CPU run.
   Then the trained_families checkpoints (tests/data/trained_families:
   Parakeet-TDT, SenseVoice, Moonshine; f32) through the port's three
   other engines: all 10 cases' texts exact in each, and each Parakeet
   case's detected language the case's.
4. End to end, each path with the launch counters set to 0 just before
   and read just after, and checked against the counts the path
   predicts; numpy-seeded weights (seed 0), W8A8 encoder and mu-law wire.
   Paths a-f run a warm-up batch first, then
   transcribe_stream(overlap_fetch=True) over batches of 8 30 s int16
   windows (max_tokens 96, temperature 0, language "en"):
   a. turbo leg: random:large-v3-turbo, bf16 decoder, 2 batches (K1, K2,
      K4);
   s. turbo MoE (after a, the same engine): the encoder's MLP replaced by
      a routed MoE FFN of 8 experts (MOE_MODEL, ~6.25 GiB of experts drawn
      on the card), 1 batch (K1 32, K2 4 per layer: fc1/fc2 are gone, K4
      per step); the encoder seconds beside a's, each layer's expert
      counts and dropped tokens, peak memory; then one layer's moe_ffn on
      the card against CPU f32 copies at 1,500 and 12,000 tokens (routing
      exact, outputs within 2e-2 of the largest);
   t. mesh (after s, the same engine): a one-rank NCCL process group and
      make_mesh(1, tp=1): shard_params, then sharded encode and greedy
      decode of 8 windows must give the unsharded tokens; the server with
      mesh= the engine's tokens; moe_ffn under the ep mesh the
      single-device call's output; pipeline_apply with one stage over 4
      encoder blocks the sequential loop's; the unsharded references run
      first, and the sharded runs' launches are held to their prediction;
      then one train step (remat, sequence parallel) on the
      sharded tree of the engine's first 2 + 2 blocks, bit-equal to the
      unsharded step;
   u. train (after t, the same engine's weights, its W8A8 encoder weights
      dequantized to bf16): large-v3-turbo at full width, B 4 x 30 s
      (log-mels and SpecAugment made on the card), 224 target tokens; one
      AdamW step without remat on a copy, then 3 with remat=True: the
      first step's loss and gradients bit-equal, every leaf a finite
      gradient, K1 36 a step (72 under remat) and K15 36, every other
      kernel 0; loss, ms and peak memory per step; then one more remat
      step under torch.profiler: its device ms by group (K1, K15,
      matmuls, optimizer, other) and the device's busy share;
   v. gradient check (after u): the engine's first 2 + 2 blocks at
      turbo's widths, B 2, 224 tokens: the card's bf16 gradient against
      the CPU's f32 autograd on the same bf16-rounded weights, every leaf
      within 5e-2 of its largest |g|, the encoder's wq/wk/wv nonzero;
   b. large-v3 leg: random:large-v3, int8 decoder, int8 cross-K/V and
      int8 self-cache, 1 batch (K1, K2, K3);
   c. the encoder-attention forms: the turbo leg's engine (its weights
      drawn once) with encoder_attention set to "q8", "packed", "pair"
      and "pipe" in turn, 1 batch each (K7, K8, K9, K10 in place of K1);
   d. int4 variant: random:large-v3-turbo with quantize_decoder="int4"
      and the int8 self-cache, 1 batch (K1, K2, K6);
   e. reduced context: the turbo leg's engine with
      TranscribeParams(audio_ctx=256), 2 batches of 8 x 5 s utterances
      (K1, K2 and K4 at Tk = 256; K5 0);
   f. long window: large-v3-turbo with n_audio_ctx = 6000 (120 s
      windows), 2 batches of 2 x 120 s (K5 in place of K1, K2, K4 at
      Tk = 6000);
   g. app path: the turbo leg's engine through transcribe_samples with
      TranscribeParams() (the sequential seek loop, language detection,
      the six-rung temperature ladder, the prompt carry; 224-token
      budget) on a 5 s utterance and a 65 s item with an initial prompt
      (three or more windows), no warm-up (K1, K2,
      K4 in every rung's steps, in the prefill at up to 8 prefix rows and
      in each call's detection step). Random weights fail every rung's
      avg_logprob gate, so each window is expected to take all six rungs
      at the full budget; the wall seconds, windows, rungs and steps of
      each call are printed;
   h. turbo beam: the turbo leg's engine, one batch of 8 x 30 s windows
      through transcribe_batch with beam_size=5 (parallel windows, 96-token
      budget): K4 at 5 rows per item in every step, the prefill's 15 rows
      on plain ops; then the same windows greedy (not counted) for the ms
      per step beside the beam's, and the beam step's cache gather and
      top-k sort timed alone;
   i. turbo word timestamps: the turbo leg's engine through
      transcribe_samples on a 5 s utterance with word_timestamps=True (a
      tokenizer in which every text id is a word); the alignment pass's
      time is printed, and its words must be found, in order and inside
      the utterance;
   j. large-v3 beam: the large-v3 leg's engine, one batch of 2 windows
      with beam_size=5 (K3 at 5 rows per item).
   n. VAD (run after i, on the turbo leg's engine): 10 minutes of seeded
      synthetic speech bursts in low noise at 44.1 kHz, made on the card;
      resample to 16 kHz, Silero over all 20,000 frames and segment_speech
      on the card, each held against the same function on CPU copies of
      its inputs (resample within 1e-5 of the peak, probabilities within
      1e-4, equal spans), every burst inside a span; then
      transcribe_vad_segments (every span one window of one batch, greedy,
      48 tokens): K1, K2 and K4 as the decode traces predict. Prints the
      resample, Silero, segment_speech and whole-call ms and the spans;
   o. serving (after n, the same engine): BatchingTranscriptionServer
      (max_batch 32, overlap_transfers) behind TranscriptionHTTPServer;
      its 5 s bucket's ladder warmed; 32 client threads POST 1-10 s
      utterances at once as 48 kHz WAV, 16 kHz s16le and mu-law (the
      front's params: the sequential seek loop, the six-rung ladder), then
      the same utterances are submitted at once with parallel-window
      params (24 tokens), which go through stage_batch on the stager
      thread and transcribe_staged on the runner. Every request must
      resolve; p50/p95 latency, requests/s and the batch sizes of each
      round are printed; K1, K2 and K4 as the decode traces predict.
   p. turbo speculative (after o, the same engine): the turbo decoder in
      f32 (TF32 off; the cross-attention in the "w8a8" form, since K1 and
      K4 take bf16 only) greedy against speculative with its
      load_self_draft(2) layers over 8 windows' encoder output: tokens
      equal; then the bf16 engine greedy and with load_self_draft(2) on
      the same 8 windows: agreement, last_spec_stats, ms per main-model
      pass against ms per step, K4's launches as predicted (4 rows per
      item in each verify);
   q. large-v3 w8a8 (after j, the large-v3 leg's engine and weights,
      switched to quantize_decoder="w8a8"): 1 batch as b (K14 32 x (1 +
      steps) per batch), then one batch with load_self_draft(2) and a
      budget of SPEC_TOKENS (K14 at 4 rows per item in every verify);
   k-m. the other engine families at full width, f32, seeded random
      weights: random:parakeet-tdt-0.6b-v3 (TDT greedy loop),
      random:sense-voice-small (CTC) and random:moonshine-base (KV-cache
      greedy loop), each through transcribe_batch over 8 int16
      utterances of 5 to 30 s after a warm-up, then transcribe_samples
      on one 65 s item; wall, encoder and decode seconds, decode steps,
      ms per step and peak memory printed. Plain PyTorch ops: every
      kernel's launch count must read 0.
   r. T5 (after k-m): flan-t5-small at full width on numpy-seeded
      weights, f32, 8 ragged prompts: encoder states and logits within
      1e-4 of a CPU copy, greedy_generate's tokens equal, ms per step;
      plain ops, every kernel's count 0.
5. The probes (spittle_tpu_torch.probes.decode_cross and .cache_dus):
   both main()s, their JSON lines printed; K11, K12 and K13 take their
   launch counts from here.

The last two lines are a JSON object of per-kernel numbers and
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense), at its 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# Special-function results per second (132 SMs x 16 per clock at ~1.85
# GHz): the floor of an attention kernel's exponentials.
PEAK_EXP = 3.9e12

SEED, N_BATCHES, BATCH = 0, 2, 8
BEAM = 5  # beam_size of the beam paths: BEAM query rows per item in K3/K4
LV3_BATCH = 56  # bench.py's large-v3 batch, for the K3/K6 timing
# The app path's initial prompt (the app's TranscribeParams.initial_prompt).
APP_PROMPT = "Meeting notes, Tuesday."
# The long-window model: large-v3-turbo with 6000 encoder positions.
LONG_MODEL, LONG_CTX = "large-v3-turbo-ctx6000", 6000
# The VAD path (the long-form configuration: Silero + resample on 10
# minutes): the recording's length and rate, and its decode budget.
VAD_SECONDS, VAD_RATE, VAD_TOKENS = 600.0, 44100, 48
# The serving path (32 concurrent push-to-talk sessions): clients, their
# utterances' lengths (seconds) and the staged round's decode budget
# (24 tokens at temperature 0, as the reference's serving bench sends).
SERVE_CLIENTS, SERVE_SECONDS, SERVE_TOKENS = 32, (1.0, 10.0), 24
# The "turbo MoE" path: large-v3-turbo with a routed MoE encoder FFN of
# this many experts (a CONFIGS entry, as LONG_MODEL is).
MOE_MODEL = "large-v3-turbo-moe8"
MOE_EXPERTS = 8
# The "large-v3 w8a8" path's speculative batch: its decode budget (the
# draft's and verify's rounds are host-bound at ~0.2 s each).
SPEC_TOKENS = 48
# e2e_phase's stage seconds and batches by path label; one MoE layer's
# tree and input for the mesh phase.
STAGE_SECONDS: dict = {}
MOE_LAYER: dict = {}
# Kernels whose launch counts come from the probes phase.
PROBE_KERNELS = ("decode_cross_attention_q8_mh", "alias_col_write_sub",
                 "alias_col_write")
# The train path: large-v3-turbo at full width, B 4 windows of 30 s and
# 224 target tokens (so the decoder's self-attention takes K1 causal), 3
# AdamW steps under remat and one without; the gradient check at turbo's
# widths and 2 + 2 layers, B 2.
TRAIN_BATCH, TRAIN_TOKENS, TRAIN_STEPS, TRAIN_LR = 4, 224, 3, 1e-5
GRAD_LAYERS, GRAD_BATCH = 2, 2
# The gradient check's tolerance, a share of each leaf's largest |g|: the
# card runs the model in bf16 (weights, activations and both attention
# kernels; P and dS rounded to bf16 in K15), the CPU in f32 on the same
# bf16-rounded weights: ~2^-9 relative per rounding, through four
# layers forward and back.
GRAD_TOL = 5e-2
# K15's calls at the encoder's shape that must all give the first's bits.
K15_CALLS = 50
REPO = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(REPO, "tests", "data", "trained_tiny")
FAMILIES = os.path.join(REPO, "tests", "data", "trained_families")
# The other engine families' full-width models.
FAMILY_MODELS = {"parakeet": "random:parakeet-tdt-0.6b-v3",
                 "sensevoice": "random:sense-voice-small",
                 "moonshine": "random:moonshine-base"}
# Their batch: 8 utterances of mixed length (seconds), then one long item.
FAMILY_SECONDS = (5.0, 30.0, 12.5, 20.0, 8.0, 25.0, 16.0, 27.5)
FAMILY_LONG_S = 65.0


def _kernels():
    """Every kernel wrapper with a launch counter."""
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops import cache_write as cw
    from spittle_tpu_torch.ops.w8a8_gemm import w8a8_gemm

    return (att.flash_attention_fullkv, w8a8_gemm, att.decode_cross_attention,
            att.decode_cross_attention_q8, att.decode_cross_attention_q4,
            *_form_kernels().values(), att.flash_attention,
            att.decode_cross_attention_q8_mh, cw.alias_col_write_sub,
            cw.alias_col_write, att.decode_cross_attention_w8a8,
            att.flash_attention_fullkv_bwd)


def _form_kernels():
    """encoder_attention form -> the wrapper of the kernel it runs."""
    from spittle_tpu_torch.ops import attention as att

    return {"q8": att.flash_attention_fullkv_q8,
            "packed": att.flash_attention_fullkv_packed,
            "pair": att.flash_attention_fullkv_packed_pair,
            "pipe": att.flash_attention_fullkv_pipe}


def _cycle(fn):
    return list(fn) if isinstance(fn, (list, tuple)) else [fn]


def call_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per eager call from CUDA events around `iters` calls: the
    device time, or the host's per-call cost where that is longer. `fn`
    is a callable, or a list of callables taken in turn."""
    fns = _cycle(fn)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int, warmup: int = 2, stream=None) -> float:
    """Mean device ms per call: `iters` calls captured in one CUDA graph
    and replayed between CUDA events, so the host's per-call cost (Python
    checks, allocation, the ctypes launch) is not in the number. `fn` is a
    callable, or a list of callables on separate input sets taken in turn,
    so that the sets together exceed the 50 MB L2 and every call reads
    cold data, as a decode step does. `stream`: the stream to capture on
    (an autograd backward runs on its forward's stream, so a backward is
    captured on the stream its forward ran on)."""
    fns = _cycle(fn)
    for i in range(max(warmup, len(fns))):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def n_cold_sets(set_bytes: float) -> int:
    """Input sets whose sum exceeds the 50 MB L2 at least twice over."""
    return 1 + int(100e6 // set_bytes)


def bound(flops: float, flop_rate: float, nbytes: float):
    """(bound ms, "operations" | "bytes") from the data-sheet peaks."""
    t_ops = flops / flop_rate * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def randn(rng, shape, dev, dtype=torch.bfloat16, scale=1.0):
    a = rng.standard_normal(shape, dtype=np.float32)
    a *= np.float32(scale)
    return torch.from_numpy(a).to(dev, dtype)


def check(name, err, tol):
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max_abs_err {err} > {tol})")


def kernel_phase(dev, rng):
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.quant import quantize_weight_w8a8
    from spittle_tpu_torch.ops.w8a8_gemm import (
        launch_gemm, launch_quantize, quantize_for_gemm, quantize_rows, w8a8_gemm,
        w8a8_gemm_plain,
    )

    rows = []
    b, h, t, d = 8, 20, 1500, 64
    F = torch.nn.functional

    # K1: encoder self-attention, heads as views of packed projections.
    packed = [randn(rng, (b, t, h * d), dev, scale=d ** -0.25) for _ in range(3)]
    q, k, v = (p.view(b, t, h, d).permute(0, 2, 1, 3) for p in packed)
    got = att.flash_attention_fullkv(q, k, v, kv_len=t)
    want = att.flash_attention_fullkv_plain(q, k, v, kv_len=t)
    err = (got.float() - want.float()).abs().max().item()
    print("K1 flash_attention_fullkv q,k,v [8,20,1500,64] bf16:")
    # Two bf16 ulps of the largest output (~0.1): the outputs differ by
    # P's rounding against the running max and one output rounding; a
    # wrong rescale or ragged-tile mask moves them by far more.
    check("K1", err, 1e-2 * want.float().abs().max().item())
    kernel = lambda: att.flash_attention_fullkv(q, k, v, kv_len=t)  # noqa: E731
    ms, eager_ms = time_ms(kernel, 20), call_ms(kernel, 20)
    plain_ms = time_ms(
        lambda: att.flash_attention_fullkv_plain(q, k, v, kv_len=t), 3, 1)
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 20)
    flops = 4.0 * b * h * t * t * d
    bms, by = bound(flops, PEAK_BF16_FLOPS, 4 * b * h * t * d * 2)
    print(f"  ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s; eager call_ms "
          f"{eager_ms:.4f})  plain_ms {plain_ms:.4f}  "
          f"library_ms (F.scaled_dot_product_attention) {lib_ms:.4f}  "
          f"bound_ms {bms:.4f} ({by})  exponentials' floor "
          f"{b * h * t * t / PEAK_EXP * 1e3:.4f} ms")
    rows.append(dict(name="flash_attention_fullkv", route="cuda",
                     source="spittle_tpu_torch/csrc/fullkv_attention.cu",
                     replaces="spittle_tpu/ops/attention.py:206",
                     max_abs_err=err, ms=ms, tflops=flops / ms / 1e9,
                     call_ms=eager_ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms,
                     library="F.scaled_dot_product_attention"))
    del packed, q, k, v, got, want
    rows.append(k15_phase(dev, rng))
    rows += encoder_forms_phase(dev, rng)

    # K2: the six W8A8 GEMMs of one encoder layer at M = 8 * 1500.
    m = b * t
    x1 = randn(rng, (m, 1280), dev)
    x4 = randn(rng, (m, 5120), dev)
    ws = {shape: quantize_weight_w8a8(
        randn(rng, shape, dev, torch.float32, shape[0] ** -0.5))
        for shape in ((1280, 1280), (1280, 5120), (5120, 1280))}
    bias = {n: randn(rng, (n,), dev, scale=0.1) for n in (1280, 5120)}
    sc = d ** -0.25
    # k and v take q's quantized rows, as the encoder's attention does
    # (model.py:_attn_full): the layer runs four row quantizers.
    xq1 = quantize_for_gemm(x1)
    calls = [  # (label, x, weight shape, bias, act, out_scale)
        ("q 1280x1280 +bias *scale", x1, (1280, 1280), 1280, "none", sc),
        ("k 1280x1280 *scale (q's rows)", xq1, (1280, 1280), None, "none", sc),
        ("v 1280x1280 +bias (q's rows)", xq1, (1280, 1280), 1280, "none", 1.0),
        ("out 1280x1280 +bias", x1, (1280, 1280), 1280, "none", 1.0),
        ("fc1 1280x5120 +bias gelu", x1, (1280, 5120), 5120, "gelu", 1.0),
        ("fc2 5120x1280 +bias", x4, (5120, 1280), 1280, "none", 1.0),
    ]
    print("K2 w8a8_gemm, one encoder layer's six GEMMs at M=12000, bf16 "
          "(quantizer and GEMM also timed apart):")
    keys = ("err", "ms", "eager", "plain", "lib", "ops", "nbytes", "quant_ms",
            "gemm_ms", "quant_bound", "gemm_bound")
    tot = dict.fromkeys(keys, 0.0)
    parts = {}
    lib_ok = True
    for label, x, shape, bn, act, s in calls:
        qw = ws[shape]
        bb = None if bn is None else bias[bn]
        shared = not torch.is_tensor(x)
        xt = x1 if shared else x  # the plain version quantizes on its own
        run = lambda: w8a8_gemm(x, qw["qw8"], qw["scale"], bias=bb, act=act,  # noqa: E731
                                out_scale=s)
        got = run()
        want = w8a8_gemm_plain(xt, qw["qw8"], qw["scale"], bias=bb, act=act,
                               out_scale=s)
        # One bf16 output ulp: same int8 bytes and int32 sums on both sides.
        err = ((got.float() - want.float()).abs()
               - 2.0 ** -7 * want.float().abs()).max().item()
        check(f"K2 {label} (excess over 1 bf16 ulp)", max(err, 0.0), 1e-5)
        ms, eager_ms = time_ms(run, 20), call_ms(run, 20)
        # The two launches apart: the row quantizer (none for k and v),
        # then the GEMM on its output.
        qx, sx = (x.qx, x.sx) if shared else launch_quantize(x)
        quant_ms = 0.0 if shared else time_ms(lambda: launch_quantize(x), 20)
        gemm_ms = time_ms(lambda: launch_gemm(qx, sx, qw["qw8"], qw["scale"], bb, s,
                                              act == "gelu", torch.bfloat16), 20)
        plain_ms = time_ms(lambda: w8a8_gemm_plain(
            xt, qw["qw8"], qw["scale"], bias=bb, act=act, out_scale=s), 2, 1)
        kk, n = shape
        lib_ms = None
        if lib_ok:
            try:
                lib_ms = time_ms(lambda: torch._int_mm(qx, qw["qw8"]), 20)
            except RuntimeError as e:  # yardstick only; the port never calls it
                print(f"  torch._int_mm unavailable here: {e}")
                lib_ok = False
        ops = 2.0 * m * kk * n
        nbytes = m * kk * 2 + kk * n + n * 4 + (0 if bn is None else n * 2) + m * n * 2
        bms, by = bound(ops, PEAK_INT8_OPS, nbytes)
        # The parts' own bounds: the quantizer reads x and writes qx and
        # sx; the GEMM reads qx, sx and the weight, writes the output. The
        # layer's bound counts x once per quantizer.
        q_bound = 0.0 if shared else (m * kk * 3 + m * 4) / PEAK_BYTES * 1e3
        g_bound, _ = bound(ops, PEAK_INT8_OPS, nbytes - m * kk * 2 + m * kk + m * 4)
        if shared:
            nbytes -= m * kk * 2
        print(f"  {label}: ms {ms:.4f} (quantizer {quant_ms:.4f}, bound "
              f"{q_bound:.4f}; GEMM {gemm_ms:.4f}, bound {g_bound:.4f}, "
              f"{ops / gemm_ms / 1e9:.0f} TOP/s; eager call_ms {eager_ms:.4f})  "
              f"plain_ms {plain_ms:.4f}  "
              f"library_ms (torch._int_mm, dot alone) "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}  "
              f"bound_ms {bms:.4f} ({by})")
        parts[label.split()[0]] = dict(ms=ms, quant_ms=quant_ms, gemm_ms=gemm_ms,
                                       library_ms=lib_ms, bound_ms=bms)
        tot["err"] = max(tot["err"], (got.float() - want.float()).abs().max().item())
        for key, val in (("ms", ms), ("eager", eager_ms), ("plain", plain_ms),
                         ("ops", ops), ("nbytes", nbytes), ("quant_ms", quant_ms),
                         ("gemm_ms", gemm_ms), ("quant_bound", q_bound),
                         ("gemm_bound", g_bound)):
            tot[key] += val
        tot["lib"] = None if (lib_ms is None or tot["lib"] is None) else tot["lib"] + lib_ms
        del qx, sx, got, want
    bms, by = bound(tot["ops"], PEAK_INT8_OPS, tot["nbytes"])
    lib_txt = "n/a" if tot["lib"] is None else f"{tot['lib']:.4f}"
    print(f"  layer total: ms {tot['ms']:.4f} (quantizers {tot['quant_ms']:.4f}, "
          f"bound {tot['quant_bound']:.4f}; GEMMs {tot['gemm_ms']:.4f}, bound "
          f"{tot['gemm_bound']:.4f}; eager call_ms {tot['eager']:.4f})  "
          f"library_ms (torch._int_mm, the six dots alone) "
          f"{lib_txt}  "
          f"bound_ms {bms:.4f} ({by})")
    rows.append(dict(name="w8a8_gemm", route="cuda",
                     source="spittle_tpu_torch/csrc/w8a8_gemm.cu",
                     replaces="spittle_tpu/ops/w8a8_gemm.py:84",
                     work="one encoder layer: 4 x (1280x1280), fc1, fc2 at M=12000",
                     max_abs_err=tot["err"], ms=tot["ms"], call_ms=tot["eager"],
                     quant_ms=tot["quant_ms"], gemm_ms=tot["gemm_ms"],
                     quant_bound_ms=tot["quant_bound"],
                     gemm_bound_ms=tot["gemm_bound"], per_gemm=parts,
                     plain_ms=tot["plain"],
                     bound_ms=bms, bound_by=by, library_ms=tot["lib"],
                     library="torch._int_mm, the int8 dot alone"))
    del x1, x4, ws

    rows.append(k4_phase(dev, rng))
    rows[-1]["by_shape"].update(k4_shapes_phase(dev, rng))
    path_shapes_phase(dev, rng, "reduced context", 8, 256)
    path_shapes_phase(dev, rng, "app path", 1, 1500)
    rows += quant_cross_phase(dev)
    rows.append(w8a8_phase(dev))
    rows += flash_phase(dev, rng)
    rows.append(mh_phase(dev))
    rows += cache_write_phase(dev)
    weight_only_phase(dev, rng)
    return rows


def k4_phase(dev, rng):
    """K4 against its plain version on the decoder's bf16 rows, padded to
    tma_pitch (1504 positions for Tk 1500: the TMA path), at B=8 with R =
    1 (a decode step), 3 (the main path's prefill: sot, language, task), 4
    (a prefill without timestamps) and 5 (a beam step: five beams folded
    into each item's query rows), at B=48, bench.py's turbo batch,
    with R = 1, and at B=1, the app path's one window, with R = 1 (a step
    or the language detection), 3 and 8 (prefills; 8 is the most rows K4
    takes); each timed over enough K/V sets that every call reads cold
    data. The row's numbers are B=8, R=1's; every case's go under
    "by_shape"."""
    from spittle_tpu_torch.ops import attention as att

    F = torch.nn.functional
    h, t, d = 20, 1500, 64
    print("K4 decode_cross_attention k,v [B,20,64,1500] bf16 in rows of 1504 "
          "positions:")
    row = None
    for b, rs in ((8, (1, 3, 4, BEAM)), (48, (1,)), (1, (1, 3, 8))):
        kvs = [(padded_rows(randn(rng, (b, h, d, t), dev)),
                padded_rows(randn(rng, (b, h, d, t), dev)))
               for _ in range(n_cold_sets(2 * b * h * d * t * 2))]
        for r in rs:
            qd = randn(rng, (b, h, r, d), dev, scale=d ** -0.5)
            kt, vt = kvs[0]
            got = att.decode_cross_attention(qd, kt, vt, kv_len=t)
            want = att.decode_cross_attention_plain(qd, kt, vt, kv_len=t)
            err = (got.float() - want.float()).abs().max().item()
            check(f"K4 B={b} R={r}", err, 2e-3 + 1e-2 * want.float().abs().max().item())
            kernel = [lambda kt=kt, vt=vt: att.decode_cross_attention(
                qd, kt, vt, kv_len=t) for kt, vt in kvs]
            ms, eager_ms = time_ms(kernel, 100), call_ms(kernel, 100)
            plain_ms = time_ms([lambda kt=kt, vt=vt: att.decode_cross_attention_plain(
                qd, kt, vt, kv_len=t) for kt, vt in kvs], 10)
            lib_ms = time_ms([lambda kt=kt, vt=vt: F.scaled_dot_product_attention(
                qd, kt.transpose(-1, -2), vt.transpose(-1, -2), scale=1.0)
                for kt, vt in kvs], 100)
            bms, by = bound(4.0 * b * h * r * t * d, PEAK_BF16_FLOPS,
                            2 * b * h * d * t * 2 + 2 * b * h * r * d * 2)
            print(f"  B={b} R={r} ({len(kvs)} input sets): ms {ms:.4f} (eager "
                  f"call_ms {eager_ms:.4f})  plain_ms {plain_ms:.4f}  "
                  f"library_ms (F.scaled_dot_product_attention) {lib_ms:.4f}  "
                  f"bound_ms {bms:.4f} ({by})")
            nums = dict(ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bms, max_abs_err=err)
            if row is None:
                row = dict(name="decode_cross_attention", route="cuda",
                           source="spittle_tpu_torch/csrc/decode_cross_attention_mh.cu",
                           replaces="spittle_tpu/ops/attention.py:723",
                           work="q [8,20,1,64] (a decode step), K/V rows of 1504",
                           max_abs_err=err, ms=ms, call_ms=eager_ms,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           library_ms=lib_ms,
                           library="F.scaled_dot_product_attention", by_shape={})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["by_shape"][f"B{b}R{r}"] = nums
        del kvs
        torch.cuda.empty_cache()
    return row


def k4_shapes_phase(dev, rng):
    """K4 away from Tk = 1500: an odd Tk (a reduced audio context; K/V
    rows only 2-byte aligned: the cp.async path), the long window's Tk =
    6000 with 1, 3 and 8 query rows, and Tk = 6500 with 8 rows (past the
    200 KB of score rows that bounded K4's first kernel). Returns each
    case's numbers by "B{b}R{r}Tk{tk}kv{kv_len}"."""
    from spittle_tpu_torch.ops import attention as att

    h, d = 20, 64
    cases = {}
    print("K4 decode_cross_attention at other K/V lengths:")
    for b, r, tk, kv_len in ((8, 1, 255, 255), (8, 3, 255, 201),
                             (2, 1, 6000, 6000), (2, 3, 6000, 6000),
                             (2, 8, 6000, 6000), (2, 8, 6500, 6500),
                             (2, 3, 6500, 6401)):
        qd = randn(rng, (b, h, r, d), dev, scale=d ** -0.5)
        kt, vt = randn(rng, (b, h, d, tk), dev), randn(rng, (b, h, d, tk), dev)
        got = att.decode_cross_attention(qd, kt, vt, kv_len=kv_len)
        want = att.decode_cross_attention_plain(qd, kt, vt, kv_len=kv_len)
        err = (got.float() - want.float()).abs().max().item()
        check(f"K4 B={b} R={r} Tk={tk} kv_len={kv_len}", err,
              2e-3 + 1e-2 * want.float().abs().max().item())
        ms = time_ms(lambda: att.decode_cross_attention(qd, kt, vt, kv_len=kv_len), 20)
        bms, by = bound(4.0 * b * h * r * kv_len * d, PEAK_BF16_FLOPS,
                        2 * b * h * d * kv_len * 2 + 2 * b * h * r * d * 2)
        print(f"    ms {ms:.4f} (one input set, {2 * b * h * d * tk * 2 / 1e6:.1f} MB "
              f"of K/V)  bound_ms {bms:.4f} ({by})")
        cases[f"B{b}R{r}Tk{tk}kv{kv_len}"] = dict(ms=ms, bound_ms=bms, max_abs_err=err)
    return cases


def path_shapes_phase(dev, rng, label: str, b: int, t: int):
    """K1, K2 and K4 against their plain versions at the shapes of a path
    that runs b windows of t encoder positions: the reduced context's (b
    8, t 256) and the app path's (one window of 1500). K1 (and K10, bit
    for bit) at [b, 20, t, 64], timed; K2's six GEMMs at M = b * t rows;
    K4 at Tk = t on contiguous rows with the decode step's one row and the
    prefill's three. Checks with the tolerances of the kernels phase."""
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.quant import quantize_weight_w8a8
    from spittle_tpu_torch.ops.w8a8_gemm import w8a8_gemm, w8a8_gemm_plain

    h, d = 20, 64
    shape = f"[{b},{h},{t},{d}]"
    print(f"K1, K2, K4 at the {label}'s shapes ({t} positions, B={b}):")
    packed = [randn(rng, (b, t, h * d), dev, scale=d ** -0.25) for _ in range(3)]
    q, k, v = (att.split_heads(x, h) for x in packed)
    got = att.flash_attention_fullkv(q, k, v, kv_len=t)
    want = att.flash_attention_fullkv_plain(q, k, v, kv_len=t)
    check(f"K1 {shape}", (got.float() - want.float()).abs().max().item(),
          1e-2 * want.float().abs().max().item())
    kernel = lambda: att.flash_attention_fullkv(q, k, v, kv_len=t)  # noqa: E731
    ms, eager_ms = time_ms(kernel, 50), call_ms(kernel, 50)
    flops = 4.0 * b * h * t * t * d
    bms, by = bound(flops, PEAK_BF16_FLOPS, 4 * b * h * t * d * 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=1.0), 50)
    print(f"    ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s; eager call_ms "
          f"{eager_ms:.4f})  library_ms (F.scaled_dot_product_attention) "
          f"{lib_ms:.4f}  bound_ms {bms:.4f} ({by})")
    # K10 (the "pipe" form) on the same inputs.
    pipe = att.flash_attention_fullkv_pipe(q, k, v, kv_len=t)
    same = torch.equal(pipe, got)
    print(f"  K10 {shape}: bit-identical to K1: {same}")
    if not same:
        raise AssertionError(f"K10 {shape} differs from K1's output")
    kernel = lambda: att.flash_attention_fullkv_pipe(q, k, v, kv_len=t)  # noqa: E731
    ms, eager_ms = time_ms(kernel, 50), call_ms(kernel, 50)
    print(f"    ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s; eager call_ms "
          f"{eager_ms:.4f})")
    m = b * t
    x = {kk: randn(rng, (m, kk), dev) for kk in (1280, 5120)}
    sc = d ** -0.25
    for label, shape, has_bias, act, s in (
            ("q 1280x1280 +bias *scale", (1280, 1280), True, "none", sc),
            ("k 1280x1280 *scale", (1280, 1280), False, "none", sc),
            ("v 1280x1280 +bias", (1280, 1280), True, "none", 1.0),
            ("out 1280x1280 +bias", (1280, 1280), True, "none", 1.0),
            ("fc1 1280x5120 +bias gelu", (1280, 5120), True, "gelu", 1.0),
            ("fc2 5120x1280 +bias", (5120, 1280), True, "none", 1.0)):
        qw = quantize_weight_w8a8(
            randn(rng, shape, dev, torch.float32, shape[0] ** -0.5))
        bias = randn(rng, (shape[1],), dev, scale=0.1) if has_bias else None
        kw = dict(bias=bias, act=act, out_scale=s)
        got = w8a8_gemm(x[shape[0]], qw["qw8"], qw["scale"], **kw)
        want = w8a8_gemm_plain(x[shape[0]], qw["qw8"], qw["scale"], **kw)
        err = ((got.float() - want.float()).abs()
               - 2.0 ** -7 * want.float().abs()).max().item()
        check(f"K2 M={m} {label} (excess over 1 bf16 ulp)", max(err, 0.0), 1e-5)
    kt, vt = randn(rng, (b, h, d, t), dev), randn(rng, (b, h, d, t), dev)
    for r in (1, 3):
        qd = randn(rng, (b, h, r, d), dev, scale=d ** -0.5)
        got = att.decode_cross_attention(qd, kt, vt, kv_len=t)
        want = att.decode_cross_attention_plain(qd, kt, vt, kv_len=t)
        check(f"K4 B={b} R={r} Tk={t}", (got.float() - want.float()).abs().max().item(),
              2e-3 + 1e-2 * want.float().abs().max().item())


def flash_phase(dev, rng):
    """K5 against its plain version at the long window's shape [2, 20,
    6000, 64] bf16 (heads as strided views of packed projections):
    kv_len 6000 and 5000, causal once, a ragged shape with Tq != Tk under
    the causal rule (row >= col on absolute indices), and the same shape
    on contiguous [B, H, T, 64] tensors (the other tensor-map layout)."""
    from spittle_tpu_torch.ops import attention as att

    F = torch.nn.functional
    b, h, t, d = 2, 20, 6000, 64
    packed = [randn(rng, (b, t, h * d), dev, scale=d ** -0.25) for _ in range(3)]
    q, k, v = (att.split_heads(x, h) for x in packed)
    print("K5 flash_attention q,k,v [2,20,6000,64] bf16:")
    err_max = 0.0
    for kv_len, causal in ((6000, False), (5000, False), (6000, True)):
        got = att.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        want = att.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
        err = (got.float() - want.float()).abs().max().item()
        # K1's tolerance: two bf16 ulps of the largest output.
        check(f"K5 kv_len={kv_len}{' causal' if causal else ''}", err,
              1e-2 * want.float().abs().max().item())
        err_max = max(err_max, err)
        del got, want
    qr, kr, vr = q[:, :, :333], k[:, :, :4301], v[:, :, :4301]
    for kv_len, causal in ((4301, False), (4200, True)):
        got = att.flash_attention(qr, kr, vr, causal=causal, kv_len=kv_len)
        want = att.flash_attention_plain(qr, kr, vr, causal=causal, kv_len=kv_len)
        err = (got.float() - want.float()).abs().max().item()
        check(f"K5 Tq=333 Tk=4301 kv_len={kv_len}{' causal' if causal else ''}",
              err, 1e-2 * want.float().abs().max().item())
        err_max = max(err_max, err)
    qc, kc, vc = (x.contiguous() for x in (qr, kr, vr))
    got = att.flash_attention(qc, kc, vc, kv_len=4301)
    want = att.flash_attention_plain(qc, kc, vc, kv_len=4301)
    err = (got.float() - want.float()).abs().max().item()
    check("K5 Tq=333 Tk=4301 contiguous [B,H,T,64]", err,
          1e-2 * want.float().abs().max().item())
    err_max = max(err_max, err)
    del qc, kc, vc, got, want
    kernel = lambda: att.flash_attention(q, k, v, kv_len=t)  # noqa: E731
    ms, eager_ms = time_ms(kernel, 10), call_ms(kernel, 10)
    causal_ms = time_ms(lambda: att.flash_attention(q, k, v, causal=True), 10)
    plain_ms = time_ms(lambda: att.flash_attention_plain(q, k, v, kv_len=t), 2, 1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 10)
    flops = 4.0 * b * h * t * t * d
    bms, by = bound(flops, PEAK_BF16_FLOPS, 4 * b * h * t * d * 2)
    exp_ms = b * h * t * t / PEAK_EXP * 1e3
    print(f"  ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s; eager call_ms "
          f"{eager_ms:.4f}; causal {causal_ms:.4f})  plain_ms {plain_ms:.4f}  "
          f"library_ms (F.scaled_dot_product_attention) {lib_ms:.4f}  "
          f"bound_ms {bms:.4f} ({by})  exponentials' floor {exp_ms:.4f} ms")
    del packed, q, k, v, qr, kr, vr
    torch.cuda.empty_cache()
    # K5 against K1 at equal work: both on K1's shape [8, 20, 1500, 64],
    # in turns (K1, K5, K5, K1).
    b1, t1 = 8, 1500
    packed = [randn(rng, (b1, t1, h * d), dev, scale=d ** -0.25) for _ in range(3)]
    q, k, v = (att.split_heads(x, h) for x in packed)
    k1 = lambda: att.flash_attention_fullkv(q, k, v, kv_len=t1)  # noqa: E731
    k5 = lambda: att.flash_attention(q, k, v, kv_len=t1)  # noqa: E731
    # One instance of the core (SplitRows, 128-key tiles) behind two
    # entries: the same bits on the same inputs.
    same = torch.equal(k5(), k1())
    print(f"  at K1's shape [8,20,1500,64]: K5 bit-identical to K1: {same}")
    if not same:
        raise AssertionError("K5 differs from K1 on K1's inputs")
    turns = [time_ms(fn, 20) for fn in (k1, k5, k5, k1)]
    k1_ms, k5_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"  at K1's shape [8,20,1500,64]: K5 ms {k5_ms:.4f}, K1 ms {k1_ms:.4f} "
          f"(K1, K5, K5, K1: {', '.join(f'{x:.4f}' for x in turns)}); per key "
          f"and row K5 {k5_ms / (b1 * h * t1 * t1) * 1e9:.5f} ps, "
          f"K1 {k1_ms / (b1 * h * t1 * t1) * 1e9:.5f} ps")
    del packed, q, k, v
    torch.cuda.empty_cache()
    return [dict(name="flash_attention", route="cuda",
                 source="spittle_tpu_torch/csrc/flash_attention.cu",
                 replaces="spittle_tpu/ops/attention.py:105",
                 work="q,k,v [2,20,6000,64] (a long-window encoder layer)",
                 max_abs_err=err_max, ms=ms, tflops=flops / ms / 1e9,
                 call_ms=eager_ms, causal_ms=causal_ms,
                 ms_at_k1_shape=k5_ms, k1_ms_at_k1_shape=k1_ms,
                 plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 library_ms=lib_ms, library="F.scaled_dot_product_attention")]


def mh_phase(dev):
    """K11 against K3's plain version on both of its load paths: the
    decode cross-attention probe's shape (B 16, H 20, T 1536, kv_len 1500:
    TMA boxes) and the same with T 1500 (rows at no 16-byte boundary:
    cp.async covers), R = 1 and 3, each timed beside K3 on the same
    inputs. The row's numbers are the probe shape's at R = 1; the T 1500
    path's go under "tk1500"."""
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.quant import dequantize_kv
    from spittle_tpu_torch.probes import decode_cross as probe

    F = torch.nn.functional
    b, h, d, kv_len = probe.B, probe.H, probe.DH, probe.KV_LEN
    row = None
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    for t, path in ((probe.T, "TMA"), (kv_len, "cp.async")):
        kv_bytes = 2 * b * h * d * t + 2 * b * h * t * 4
        sets = []
        for i in range(n_cold_sets(kv_bytes)):
            q, k, v, qk, qv = probe.make_inputs(dev, t=t, seed=SEED + 10 + i)
            deq = tuple(dequantize_kv(x)[..., :kv_len].transpose(-1, -2).contiguous()
                        for x in (qk, qv))
            sets.append(((qk["qw"], qk["scale"], qv["qw"], qv["scale"]), deq))
            del k, v
        print(f"K11 decode_cross_attention_q8_mh K/V int8 [16,20,64,{t}] + f32 "
              f"scales, kv_len 1500, {path} path ({len(sets)} input sets):")
        for r in (1, 3):
            qd = (torch.randn((b, h, r, d), generator=gen, device=dev)
                  * d ** -0.5).to(torch.bfloat16)
            got = att.decode_cross_attention_q8_mh(qd, *sets[0][0], kv_len=kv_len)
            want = att.decode_cross_attention_q8_plain(qd, *sets[0][0], kv_len=kv_len)
            err = (got.float() - want.float()).abs().max().item()
            # K3's tolerance, for K3's reasons (chunk max against row max).
            check(f"K11 T={t} R={r}", err,
                  2e-3 + 1e-2 * want.float().abs().max().item())
            ms = time_ms([lambda kv=kv: att.decode_cross_attention_q8_mh(
                qd, *kv, kv_len=kv_len) for kv, _ in sets], 100)
            eager_ms = call_ms([lambda kv=kv: att.decode_cross_attention_q8_mh(
                qd, *kv, kv_len=kv_len) for kv, _ in sets], 100)
            k3_ms = time_ms([lambda kv=kv: att.decode_cross_attention_q8(
                qd, *kv, kv_len=kv_len) for kv, _ in sets], 100)
            plain_ms = time_ms([lambda kv=kv: att.decode_cross_attention_q8_plain(
                qd, *kv, kv_len=kv_len) for kv, _ in sets], 5, 1)
            lib_ms = time_ms([lambda kd=kd, vd=vd: F.scaled_dot_product_attention(
                qd, kd, vd, scale=1.0) for _, (kd, vd) in sets], 100)
            # The bytes this run needs: kv_len of the T stored positions.
            nbytes = (2 * b * h * d * kv_len + 2 * b * h * kv_len * 4
                      + 2 * b * h * r * d * 2)
            bms, by = bound(4.0 * b * h * r * kv_len * d, PEAK_BF16_FLOPS, nbytes)
            print(f"  R={r}: ms {ms:.4f} (eager call_ms {eager_ms:.4f}; K3 on the "
                  f"same inputs {k3_ms:.4f})  plain_ms {plain_ms:.4f}  library_ms "
                  f"(F.scaled_dot_product_attention on bf16 K/V dequantized "
                  f"beforehand) {lib_ms:.4f}  bound_ms {bms:.4f} ({by})")
            nums = dict(ms=ms, call_ms=eager_ms, k3_ms=k3_ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=lib_ms)
            if row is None:
                row = dict(name="decode_cross_attention_q8_mh", route="cuda",
                           source="spittle_tpu_torch/csrc/decode_cross_attention_mh.cu",
                           replaces="scripts/bench_decode_cross.py:70",
                           work="q [16,20,1,64], K/V int8 [16,1280,1536], kv_len 1500",
                           max_abs_err=err, **nums,
                           library="F.scaled_dot_product_attention on bf16 K/V "
                                   "dequantized beforehand")
            elif path == "cp.async" and r == 1:
                row["tk1500"] = nums
            row["max_abs_err"] = max(row["max_abs_err"], err)
        del sets
        torch.cuda.empty_cache()
    return row


def cache_write_phase(dev):
    """K13 and K12 against a slice assignment on a clone, at the cache
    probe's shape: the written cache bit for bit (so every other byte
    unchanged), in place (data_ptr unchanged, the argument returned), at
    the edges of a row's 32-byte sectors (positions 0, 5, 15, 16 and the
    last). K13's row adds the sector floor: one 32-byte sector read and
    one written per row."""
    from spittle_tpu_torch.ops import cache_write as cw
    from spittle_tpu_torch.probes import cache_dus as probe

    cache, cache_sub = probe.make_cache(dev)
    l, _, b, h, dh, ctx = cache.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    specs = (  # (K#, wrapper, line, tensor, cols shape, plain slice write)
        ("K13", cw.alias_col_write, 159, cache, cache.shape[:-1],
         lambda c, cols, p: c.__setitem__((..., p), cols)),
        ("K12", cw.alias_col_write_sub, 132, cache_sub,
         (cache_sub.shape[0], cache_sub.shape[2]),
         lambda c, cols, p: c.__setitem__((slice(None), p), cols)),
    )
    rows = []
    for kname, fn, line, tensor, cshape, assign in specs:
        print(f"{kname} {fn.__name__} cache {list(tensor.shape)} bf16 "
              f"({tensor.numel() * 2 / 1e6:.0f} MB), cols {list(cshape)}:")
        for p in (0, 5, 15, 16, ctx - 1):
            cols = torch.randn(cshape, generator=gen, device=dev).to(torch.bfloat16)
            want = tensor.clone()
            assign(want, cols, p)
            ptr = tensor.data_ptr()
            got = fn(tensor, cols, torch.tensor(p, dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            in_place = got is tensor and tensor.data_ptr() == ptr
            print(f"  {kname} pos={p}: bit-identical to the slice assignment "
                  f"(whole cache): {same}; in place: {in_place}")
            if not (same and in_place):
                raise AssertionError(f"{kname} pos={p}: wrong bytes or not in place")
            del want
        pos_dev = torch.tensor(7, dtype=torch.int32, device=dev)
        # Enough cols tensors in turn that every launch reads cold data;
        # the sectors it dirties are one position of a 671 MB cache.
        cols2 = [torch.randn(cshape, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(n_cold_sets(cols.numel() * 2))]
        ms = time_ms([lambda c=c: fn(tensor, c, pos_dev) for c in cols2], 48)
        eager_ms = call_ms([lambda c=c: fn(tensor, c, pos_dev) for c in cols2], 48)
        plain_ms = time_ms([lambda c=c: assign(tensor, c, 7) for c in cols2], 48)
        # The yardstick: index_copy_ along ctx, on [rows, ctx] (K13) or
        # [rows, ctx, hd] (K12) views of the same tensors.
        index = torch.tensor([7], device=dev)
        lib = "Tensor.index_copy_ along ctx"
        dst = tensor.view(-1, ctx) if kname == "K13" else tensor
        lib_ms = time_ms([lambda c=c: dst.index_copy_(
            1, index, c.view(dst.shape[0], 1, *dst.shape[2:])) for c in cols2], 48)
        nbytes = 2 * cols.numel() * 2
        bms, by = bound(0.0, PEAK_BF16_FLOPS, nbytes)
        row = dict(name=fn.__name__, route="cuda",
                   source="spittle_tpu_torch/csrc/cache_col_write.cu",
                   replaces=f"scripts/bench_cache_dus.py:{line}",
                   work=f"cache {list(tensor.shape)} bf16, one position",
                   max_abs_err=0.0, ms=ms, call_ms=eager_ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms, library=lib)
        extra = ""
        if kname == "K13":
            # The floor the layout sets: a 32-byte sector in and out per row.
            floor = cols.numel() * 64 / PEAK_BYTES * 1e3
            row.update(sector_floor_ms=floor)
            extra = f"  sector_floor_ms {floor:.4f}"
        print(f"  ms {ms:.4f} (eager call_ms {eager_ms:.4f})  plain_ms (slice "
              f"assignment) {plain_ms:.4f}  library_ms ({lib}) {lib_ms:.4f}  "
              f"bound_ms {bms:.4f} ({by}): {nbytes / 1e6:.1f} MB at "
              f"{nbytes / ms / 1e6:.0f} GB/s{extra}")
        rows.append(row)
        del cols2
    del cache, cache_sub
    torch.cuda.empty_cache()
    return rows


def k15_phase(dev, rng):
    """K15, K1's hand-written backward, against its plain version at the
    train path's shapes: the encoder's [8, 20, 1500, 64], the decoder's
    causal self-attention at 224 tokens ([4, 20, 224, 64]) and kv_len 1300
    of 1504 keys (whose pad keys must get exact zeros). Its o and lse come
    from K1's lse instance (the forward under autograd), whose o must be
    K1's bit for bit and whose lse must be within 1e-4 of the plain
    version's. Two calls must be bit-equal (no atomics), and at the first
    shape K15_CALLS calls; K15 is also held to torch's autograd through
    K1's plain forward. Prints ms with TFLOP/s, the plain version's ms and
    SDPA's backward alone (flash, on the same q, k, v and dO; the port
    never calls it), all three as CUDA-graph replays, the bound: 10 * B *
    H * 64 FLOPs per kept (row, key) pair at the bf16 peak against the
    bytes of q, k, v, o, dO in and dq, dk, dv out, and the floor of one
    exponential per kept pair on the special-function units (K15 takes
    two)."""
    from spittle_tpu_torch.ops import attention as att

    F = torch.nn.functional
    h, d = 20, 64
    print("K15 flash_attention_fullkv_bwd (K1's backward) bf16:")
    by_shape, row = {}, None
    for label, b, tq, tk, kv_len, causal in (
            ("[8,20,1500,64]", 8, 1500, 1500, 1500, False),
            ("[4,20,224,64] causal", 4, 224, 224, 224, True),
            ("[8,20,1500,64] kv_len 1300 of 1504", 8, 1500, 1504, 1300, False)):
        packed = [randn(rng, (b, t, h * d), dev, scale=d ** -0.25)
                  for t in (tq, tk, tk)]
        q, k, v = (x.view(b, -1, h, d).permute(0, 2, 1, 3) for x in packed)
        do = randn(rng, (b, tq, h * d), dev).view(b, tq, h, d).permute(0, 2, 1, 3)
        o, lse = att.flash_attention_fullkv_lse(q, k, v, causal=causal,
                                                kv_len=kv_len)
        o_k1 = att.flash_attention_fullkv(q, k, v, causal=causal, kv_len=kv_len)
        _, lse_plain = att.flash_attention_fullkv_lse_plain(q, k, v, causal=causal,
                                                            kv_len=kv_len)
        torch.cuda.synchronize()
        if not torch.equal(o, o_k1):
            raise AssertionError(f"K1 lse instance {label}: o differs from K1's")
        # f32 sums of ex2.approx terms in another order (~1e-6); one key
        # more or less in a row of 1500 moves its lse by ~7e-4.
        check(f"K1 lse instance {label} lse (o bit-equal to K1's)",
              (lse - lse_plain).abs().max().item(), 1e-4)
        del o_k1, lse_plain

        def run():
            return att.flash_attention_fullkv_bwd(q, k, v, o, do, lse,
                                                  causal=causal, kv_len=kv_len)

        got, again = run(), run()
        if row is None:
            for i in range(K15_CALLS - 2):
                if not all(torch.equal(a, b2) for a, b2 in zip(got, run())):
                    raise AssertionError(f"K15 {label}: call {i + 3} differs "
                                         "from the first")
            print(f"  K15 {label}: {K15_CALLS} calls bit-equal")
        want = att.flash_attention_fullkv_bwd_plain(q, k, v, o, do, lse,
                                                    causal=causal, kv_len=kv_len)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(att.flash_attention_fullkv_plain(
            *leaves, causal=causal, kv_len=kv_len), leaves, do)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b2) for a, b2 in zip(got, again)):
            raise AssertionError(f"K15 {label}: two calls differ")
        err = 0.0
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, auto):
            e = (g.float() - w.float()).abs().max().item()
            scale = w.float().abs().max().item()
            # P and dS rounded to bf16 as the second products' A operands,
            # each gradient once more on output: a few bf16 ulps of the
            # largest entry; a wrong mask, lse or D moves rows by far more.
            check(f"K15 {label} {name}", e, 1e-2 * scale)
            # Autograd through K1's plain forward (torch's own derivative,
            # not the port's formula) also differs by K1's bf16 o in D.
            check(f"K15 {label} {name} vs autograd",
                  (g.float() - a.float()).abs().max().item(), 2e-2 * scale)
            err = max(err, e)
        if kv_len < tk and (got[1][:, :, kv_len:].any() or got[2][:, :, kv_len:].any()):
            raise AssertionError(f"K15 {label}: pad keys got a gradient")
        del got, again, want, auto, leaves
        ms = time_ms(run, 10)
        plain_ms = time_ms(lambda: att.flash_attention_fullkv_bwd_plain(
            q, k, v, o, do, lse, causal=causal, kv_len=kv_len), 2, 1)
        leaves = [t.detach().requires_grad_() for t in (q, k[:, :, :kv_len],
                                                         v[:, :, :kv_len])]
        # SDPA's forward runs on a side stream, so its backward runs there
        # and is captured in a graph and timed as K15's `ms` is.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sdpa = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                  scale=1.0)
        torch.cuda.synchronize()
        lib_ms = time_ms(lambda: torch.autograd.grad(sdpa, leaves, do,
                                                     retain_graph=True), 10,
                         stream=side)
        pairs = (tq * (tq + 1) // 2) if causal else tq * kv_len
        flops = 10.0 * b * h * d * pairs
        # q, o, dO read and dq written (4 Tq rows), k and v read up to
        # kv_len, dk and dv written (2 Tk rows each way), 2 bytes an element.
        bms, by = bound(flops, PEAK_BF16_FLOPS,
                        2 * b * h * d * (4 * tq + 2 * kv_len + 2 * tk))
        exp_ms = b * h * pairs / PEAK_EXP * 1e3
        print(f"  {label}: ms {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s)  "
              f"plain_ms {plain_ms:.4f}  library_ms (SDPA's backward, flash) "
              f"{lib_ms:.4f}  bound_ms {bms:.4f} ({by})  exponentials' floor "
              f"{exp_ms:.4f} ms a walk")
        by_shape[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bms, bound_by=by, max_abs_err=err,
                               tflops=flops / ms / 1e9)
        if row is None:
            row = dict(name="flash_attention_fullkv_bwd", route="cuda",
                       source="spittle_tpu_torch/csrc/fullkv_attention_bwd.cu",
                       replaces="spittle_tpu/ops/attention.py:1034",
                       replaces_note="no TPU kernel: XLA's transpose of "
                       "multihead_attention under jax.value_and_grad "
                       "(spittle_tpu/train/step.py:101)",
                       max_abs_err=err, ms=ms, tflops=flops / ms / 1e9,
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=lib_ms,
                       library="SDPA's backward alone (torch.autograd.grad "
                       "of F.scaled_dot_product_attention, flash; CUDA-graph "
                       "replays)")
        del packed, q, k, v, do, o, lse, leaves, sdpa
    row["max_abs_err"] = max(r["max_abs_err"] for r in by_shape.values())
    row["by_shape"] = by_shape
    return row


def encoder_forms_phase(dev, rng):
    """K7-K10 against their plain versions at [8, 20, 1500, 64] bf16:
    packed [B, T, H*64] projections (K8, K9) and their strided head views
    (K7, K10), kv_len 1500 and 1300, causal for K8 and K9. K8 is K1's
    instance of the wgmma attention core on the packed strides, and K10
    the core's persistent kernel on K1's policy and tiles, so both must
    give K1's output bit for bit; K10 is also timed beside K1 on the same
    inputs. K9 (the core's head-pair instance, whose 64-row causal blocks
    skip other masked tiles) is held to K1's tolerance against K1 too, and
    its largest distance from K1 is printed."""
    from spittle_tpu_torch.ops import attention as att

    F = torch.nn.functional
    b, h, t, d = 8, 20, 1500, 64
    packed = [randn(rng, (b, t, h * d), dev, scale=d ** -0.25) for _ in range(3)]
    heads = [att.split_heads(x, h) for x in packed]
    specs = (  # (K#, form, line of the TPU kernel, plain version, source)
        ("K7", "q8", 407, att.flash_attention_fullkv_q8_plain,
         "fullkv_attention_q8.cu"),
        ("K8", "packed", 478, att.flash_attention_fullkv_packed_plain,
         "fullkv_attention.cu"),
        ("K9", "pair", 573, att.flash_attention_fullkv_packed_plain,
         "fullkv_attention_pair.cu"),
        ("K10", "pipe", 289, att.flash_attention_fullkv_plain,
         "fullkv_attention_pipe.cu"),
    )
    rows = []
    for kname, form, line, plain, src in specs:
        fn = _form_kernels()[form]
        on_packed = form in ("packed", "pair")
        args = tuple(packed) + (h,) if on_packed else tuple(heads)
        print(f"{kname} {fn.__name__} [8,20,1500,64] bf16 "
              f"({'packed [8,1500,1280]' if on_packed else 'strided head views'}):")
        cases = [(1500, False), (1300, False)] + ([(1500, True)] if on_packed else [])
        err_max = 0.0
        for kv_len, causal in cases:
            kw = dict(kv_len=kv_len, causal=causal) if on_packed else dict(kv_len=kv_len)
            got = fn(*args, **kw)
            want = plain(*args, **kw)
            err = (got.float() - want.float()).abs().max().item()
            big = want.float().abs().max().item()
            label = f"{kname} kv_len={kv_len}{' causal' if causal else ''}"
            if form == "q8":
                # One bf16 ulp of the largest output, plus one P code moved
                # by one (where exp's last bit differs): at most mp/l.
                step = att.q8_code_step(*heads, kv_len).max().item()
                check(label, err, 2.0 ** -7 * big + step)
            else:
                # K1's tolerance; and K1's bits for K8 and K10.
                check(label, err, 1e-2 * big)
                k1 = att.flash_attention_fullkv(*heads, causal=causal, kv_len=kv_len)
                k1 = att.merge_heads(k1) if on_packed else k1
                if form == "pair":
                    check(f"{label}: |{kname} - K1|",
                          (got.float() - k1.float()).abs().max().item(), 1e-2 * big)
                else:
                    same = torch.equal(got, k1)
                    print(f"  {label}: bit-identical to K1: {same}")
                    if not same:
                        raise AssertionError(f"{label}: differs from K1's output")
            err_max = max(err_max, err)
            del got, want
        kernel = lambda: fn(*args, kv_len=t)  # noqa: E731
        ms, eager_ms = time_ms(kernel, 20), call_ms(kernel, 20)
        plain_ms = time_ms(lambda: plain(*args, kv_len=t), 3, 1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), 20)
        rate = PEAK_INT8_OPS if form == "q8" else PEAK_BF16_FLOPS
        flops = 4.0 * b * h * t * t * d
        bms, by = bound(flops, rate, 4 * b * h * t * d * 2)
        lib = "F.scaled_dot_product_attention on the same bf16 q, k, v"
        if form == "q8":
            lib += " (no library call computes the int8 function)"
        row = dict(name=fn.__name__, route="cuda",
                   source=f"spittle_tpu_torch/csrc/{src}",
                   replaces=f"spittle_tpu/ops/attention.py:{line}",
                   max_abs_err=err_max, ms=ms, call_ms=eager_ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms, library=lib)
        rate_txt = floor_txt = ""
        if form in ("packed", "pair", "pipe"):
            row.update(tflops=flops / ms / 1e9)
            rate_txt = f" ({row['tflops']:.1f} TFLOP/s)"
            floor_txt = f"  exponentials' floor {b * h * t * t / PEAK_EXP * 1e3:.4f} ms"
        if form == "q8":
            # The three quantizer launches and the attention launch apart,
            # through the wrapper's own helpers and entries.
            from spittle_tpu_torch.ops import _build

            so = _build.load_library()
            bufs = att._q8_buffers(*heads[:2])
            quant_ms = time_ms(lambda: att._q8_quantize(
                so.spt_fullkv_q8_quantize, *heads, bufs), 20)
            attn_ms = time_ms(lambda: att._q8_attend(
                so.spt_fullkv_attention_q8, bufs, t), 20)
            row.update(quant_ms=quant_ms, attention_ms=attn_ms,
                       exp_floor_ms=b * h * t * t / PEAK_EXP * 1e3)
            floor_txt = (f"  quantizers {quant_ms:.4f} ms + attention {attn_ms:.4f} ms"
                         f"  exponentials' floor {row['exp_floor_ms']:.4f} ms "
                         "(one per score; the kernel takes two)")
            del bufs
        if form == "pipe":
            # K1 on the same inputs in the same call, and the bits checked
            # above at every case.
            k1_ms = time_ms(lambda: att.flash_attention_fullkv(*heads, kv_len=t), 20)
            row.update(k1_ms=k1_ms, equal_to_k1=True)
            floor_txt += f"  K1 on the same inputs ms {k1_ms:.4f}"
        print(f"  ms {ms:.4f}{rate_txt} (eager call_ms {eager_ms:.4f})  plain_ms "
              f"{plain_ms:.4f}  library_ms ({lib}) {lib_ms:.4f}  bound_ms {bms:.4f} "
              f"({by}){floor_txt}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows



def heads_phase(dev, rng, rows):
    """K1, K4 and K3 at the head counts one rank holds when tensor
    parallelism splits turbo's and large-v3's 20 heads (tp 2: 10, tp 4:
    5), the main path's other dims (B 8, T 1500; K4/K3 at R 1 on rows of
    1504 positions), each against its plain version with the tolerance of
    the kernels phase; ms beside the 20-head ms, under each row's
    "by_heads"."""
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.quant import quantize_kv

    by = {r["name"]: r for r in rows}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    b, t, d = 8, 1500, 64
    ref_ms = {"flash_attention_fullkv": by["flash_attention_fullkv"]["ms"],
              "decode_cross_attention":
                  by["decode_cross_attention"]["by_shape"]["B8R1"]["ms"],
              "decode_cross_attention_q8":
                  by["decode_cross_attention_q8"]["by_shape"]["B8R1"]["ms"]}
    print("kernels at per-rank head counts (tp 2: 10 heads, tp 4: 5):")
    for h in (10, 5):
        packed = [randn(rng, (b, t, h * d), dev, scale=d ** -0.25) for _ in range(3)]
        q, k, v = (x.view(b, t, h, d).permute(0, 2, 1, 3) for x in packed)
        cases = [("flash_attention_fullkv", "K1", f"[8,{h},1500,64]",
                  lambda: att.flash_attention_fullkv(q, k, v, kv_len=t),
                  lambda: att.flash_attention_fullkv_plain(q, k, v, kv_len=t),
                  None, 20)]
        kvs = [(padded_rows(randn(rng, (b, h, d, t), dev)),
                padded_rows(randn(rng, (b, h, d, t), dev)))
               for _ in range(n_cold_sets(2 * b * h * d * t * 2))]
        qd = randn(rng, (b, h, 1, d), dev, scale=d ** -0.5)
        cases.append(("decode_cross_attention", "K4", f"B 8 H {h} R 1",
                      lambda: att.decode_cross_attention(qd, *kvs[0], kv_len=t),
                      lambda: att.decode_cross_attention_plain(qd, *kvs[0], kv_len=t),
                      [lambda kv=kv: att.decode_cross_attention(qd, *kv, kv_len=t)
                       for kv in kvs], 100))
        q8 = []
        for _ in range(n_cold_sets(2 * b * h * d * t + 2 * b * h * t * 4)):
            kq, vq = (quantize_kv(torch.randn((b, h, d, t), generator=gen,
                                              device=dev)) for _ in range(2))
            q8.append((padded_rows(kq["qw"]), kq["scale"], padded_rows(vq["qw"]),
                       vq["scale"]))
        cases.append(("decode_cross_attention_q8", "K3", f"B 8 H {h} R 1",
                      lambda: att.decode_cross_attention_q8(qd, *q8[0], kv_len=t),
                      lambda: att.decode_cross_attention_q8_plain(qd, *q8[0], kv_len=t),
                      [lambda kv=kv: att.decode_cross_attention_q8(qd, *kv, kv_len=t)
                       for kv in q8], 100))
        for name, label, shape, kernel, plain, timed, iters in cases:
            got, want = kernel(), plain()
            err = (got.float() - want.float()).abs().max().item()
            # K1: two bf16 ulps of the largest output; K4/K3: the kernels
            # phase's 2e-3 + 1e-2 of the largest output.
            tol = (1e-2 * want.float().abs().max().item() if label == "K1"
                   else 2e-3 + 1e-2 * want.float().abs().max().item())
            check(f"{label} {shape}", err, tol)
            ms = time_ms(timed or kernel, iters)
            plain_ms = time_ms(plain, 3, 1)
            print(f"  {label} {shape}: ms {ms:.4f} (20 heads {ref_ms[name]:.4f})  "
                  f"plain_ms {plain_ms:.4f}")
            by[name].setdefault("by_heads", {})[str(h)] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=err)
        del packed, q, k, v, kvs, q8
        torch.cuda.empty_cache()


def _moe_blocks(eng, experts: int, seed: int):
    """The turbo engine's encoder blocks with the dense MLP replaced by a
    routed MoE FFN of `experts` experts at random_params' shapes and
    scales (weights.moe_leaf_init), drawn on the card from a seeded
    generator: a 32 x 8 x 1280 x 5120 expert tree from numpy would take
    about a minute on the host."""
    from spittle_tpu_torch.models.whisper.weights import moe_leaf_init

    cfg = eng.cfg
    blocks = {k: v for k, v in eng.params["encoder"]["blocks"].items()
              if not k.startswith(("fc1_", "fc2_"))}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for name, (shape, scale, f32) in moe_leaf_init(
            cfg.n_audio_state, experts, cfg.n_audio_layer).items():
        out = torch.empty(shape, dtype=torch.float32 if f32 else eng.dtype,
                          device="cuda")
        for i in range(shape[0]):  # one layer's f32 draw at a time
            out[i] = torch.randn(shape[1:], generator=gen, device="cuda") * scale
        blocks[name] = out
    return blocks


def moe_ffn_check(blocks, layer: int, n_tokens: int, seed: int):
    """One layer's moe_ffn on the card (bf16 experts) against the same
    function on CPU f32 copies of its inputs: equal routing (counts and
    drops exact) and outputs within the stated tolerance. Returns the
    card's [n, D] output and its inputs for the mesh phase."""
    from spittle_tpu_torch.parallel.expert_parallel import moe_ffn

    p = {"router_w": blocks["moe_router"][layer], "w_in": blocks["moe_w_in"][layer],
         "w_out": blocks["moe_w_out"][layer]}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((n_tokens, p["w_in"].shape[1]), generator=gen,
                    device="cuda").to(p["w_in"].dtype)
    with torch.inference_mode():
        out, aux = moe_ffn(p, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe_ffn(p, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = {k: v.float().cpu() for k, v in p.items()}
        ref, ref_aux = moe_ffn(cpu, x.float().cpu())
    err = (out.float().cpu() - ref).abs()
    scale = ref.abs().max().item()
    print(f"  moe_ffn layer {layer} at N {n_tokens} (capacity factor 1.25, "
          f"{p['w_in'].shape[0]} experts): card {ms:.2f} ms (wall, one call); "
          f"expert counts {[int(c) for c in aux['expert_counts'].tolist()]}, "
          f"dropped {int(aux['dropped'])} (CPU f32: "
          f"{[int(c) for c in ref_aux['expert_counts'].tolist()]}, "
          f"{int(ref_aux['dropped'])}); max |card - CPU f32| "
          f"{err.max().item():.3e}, mean {err.mean().item():.3e} of a max "
          f"|out| {scale:.3f}")
    if not (torch.equal(aux["expert_counts"].cpu(), ref_aux["expert_counts"])
            and float(aux["dropped"]) == float(ref_aux["dropped"])):
        raise AssertionError("moe_ffn: the card's routing differs from the CPU's")
    # The card runs both expert products and the GELU in bf16 (the
    # weights' dtype, as the reference does), the CPU copy in f32: three
    # bf16 roundings of O(1) activations, 2^-8 each, over 5120-term sums.
    tol = 2e-2 * max(scale, 1.0)
    check(f"moe_ffn N={n_tokens}", err.max().item(), tol)
    return p, x, out


def moe_phase(label: str, eng, seed: int):
    """The turbo engine (W8A8 encoder, bf16 decoder) with a MoE encoder of
    MOE_EXPERTS experts drawn on the card (its CONFIGS entry MOE_MODEL):
    one batch of 8 x 30 s through e2e_phase (warm-up first), K2 at 4
    GEMMs per layer (no fc1/fc2); the encoder seconds beside the dense
    turbo leg's; per layer the expert counts and dropped tokens of the
    timed batch; then one layer's moe_ffn on the card against CPU f32
    copies at 1 window's 1,500 tokens and B 8's 12,000. The dense engine's
    tree and config are restored after. Leaves the layer's tree for the
    mesh phase in MOE_LAYER."""
    from spittle_tpu_torch.models.whisper.config import CONFIGS
    from spittle_tpu_torch.parallel import expert_parallel as ep

    dense_cfg, dense_params = eng.cfg, eng.params
    t0 = time.perf_counter()
    blocks = _moe_blocks(eng, MOE_EXPERTS, seed + 11)
    torch.cuda.synchronize()
    moe_bytes = sum(blocks[k].numel() * blocks[k].element_size()
                    for k in ("moe_w_in", "moe_w_out"))
    print(f"{label}: {MOE_MODEL}: {MOE_EXPERTS} experts x "
          f"{dense_cfg.n_audio_layer} layers drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s ({moe_bytes / 2**30:.2f} GiB of "
          f"experts)")
    params = dict(dense_params)
    params["encoder"] = {**dense_params["encoder"], "blocks": blocks}
    eng.params, eng.cfg = params, CONFIGS[MOE_MODEL]
    calls = []
    real = ep.moe_ffn_local

    def recording(*a, **kw):
        out, aux = real(*a, **kw)
        calls.append(aux)
        return out, aux

    ep.moe_ffn_local = recording
    try:
        counts = e2e_phase(label, eng, 1, BATCH, seed, _predict(k4=1, gemms=4))
    finally:
        ep.moe_ffn_local = real
        eng.params, eng.cfg = dense_params, dense_cfg
    timed = calls[-dense_cfg.n_audio_layer:]
    for layer, aux in enumerate(timed):
        print(f"  layer {layer}: expert counts "
              f"{[int(c) for c in aux['expert_counts'].tolist()]}, dropped "
              f"{int(aux['dropped'])}, aux_loss {float(aux['aux_loss']):.4f}")
    moe_s = STAGE_SECONDS[label][0]["frontend"] / STAGE_SECONDS[label][1]
    dense = STAGE_SECONDS.get("turbo leg")
    dense_s = dense[0]["frontend"] / dense[1] if dense else float("nan")
    print(f"{label}: encoder (frontend) seconds per batch of 8 {moe_s:.4f} "
          f"against the dense turbo leg's {dense_s:.4f}")
    for n_tokens in (1500, BATCH * 1500):
        layer_p, x, out = moe_ffn_check(blocks, 0, n_tokens, seed + 12)
    MOE_LAYER.update(p=layer_p, x=x, out=out)
    del blocks, params, calls, timed
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def mesh_phase(label: str, eng, seed: int):
    """The mesh layer on the card, one rank: an NCCL process group (no
    gloo on the card: a failure to initialize fails the phase) and
    make_mesh(1, tp=1). On the turbo leg's weights and 8 windows,
    shard_params then sharded encode and greedy decode must give the
    unsharded tokens, and BatchingTranscriptionServer(mesh=) those of the
    engine alone; moe_ffn under the ep mesh must equal the single-device
    call on the MoE phase's layer; pipeline_apply with one stage over 4
    encoder blocks must equal the sequential loop. The unsharded
    references run first; every launch counter is set to 0 just before
    the sharded runs and read just after, and held to their prediction:
    the sharded encode and decode as _predict(k4=1) gives, the server's
    batches as _traced_launches gives, and the pipeline's M + S - 1 = 2
    steps of 4 blocks, K1 once and K2 six times per block. Returns the
    counts."""
    import socket

    import torch.distributed as dist

    from spittle_tpu_torch.audio.mel import log_mel_spectrogram
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
    from spittle_tpu_torch.models.whisper.model import (
        encode, encoder_block_body, layer_params, n_layers,
    )
    from spittle_tpu_torch.parallel.expert_parallel import moe_ffn, shard_moe_params
    from spittle_tpu_torch.parallel.mesh import P, make_mesh, shard_leaf, shard_params
    from spittle_tpu_torch.parallel.multihost import (
        global_batch_from_local, initialize_distributed,
    )
    from spittle_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply, stack_to_stages,
    )
    from spittle_tpu_torch.parallel.serving import BatchingTranscriptionServer
    from torch.distributed.device_mesh import DeviceMesh

    cfg = eng.cfg
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        print(f"{label}: process group backend {dist.get_backend()!r}, world "
              f"{dist.get_world_size()}")
        mesh = make_mesh(1, tp=1)
        rng = np.random.default_rng(seed + 13)
        audio = [synth_utterance(rng, 30.0) for _ in range(BATCH)]
        pcm = torch.from_numpy(np.stack(audio).astype(np.float32) / 32768.0).cuda()
        opts = DecodeOptions(language="en", max_tokens=96)
        p = TranscribeParams(language="en", condition_on_previous_text=False,
                             parallel_windows=True, temperatures=(0.0,),
                             max_tokens=96)
        stage_mesh = DeviceMesh("cuda", np.arange(1), mesh_dim_names=("stage",))
        blocks = {k: (v[:4] if torch.is_tensor(v) else {kk: vv[:4] for kk, vv in v.items()})
                  for k, v in eng.params["encoder"]["blocks"].items()}
        xmb = torch.randn((2, 2, cfg.n_audio_ctx, cfg.n_audio_state), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(seed)
                          ).to(eng.dtype)

        def block_fn(stage_blocks, x):
            for layer in range(n_layers(stage_blocks)):
                x = encoder_block_body(x, layer_params(stage_blocks, layer),
                                       cfg.n_audio_head)
            return x

        def place(node):
            if isinstance(node, dict):
                return {k: place(v) for k, v in node.items()}
            return shard_leaf(node, stage_mesh, P("stage"))

        # The unsharded references, before the counted runs.
        with torch.inference_mode():
            mel = log_mel_spectrogram(pcm, n_mels=cfg.n_mels)
            xa = encode(eng.params, mel, cfg)
            ref = greedy_decode(eng.params, xa, cfg, opts)
            single = moe_ffn(MOE_LAYER["p"], MOE_LAYER["x"])[0] if MOE_LAYER else None
            seq = torch.stack([block_fn(blocks, xmb[i]) for i in range(2)])
        want = eng.transcribe_batch(audio, p)

        kernels = _reset_traces(eng)
        torch.cuda.synchronize()
        with torch.inference_mode():
            t0 = time.perf_counter()
            sharded = shard_params(eng.params, mesh)
            xs = encode(sharded, global_batch_from_local(mel, mesh), cfg)
            got = greedy_decode(sharded, xs.to_local(), cfg, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        same = torch.equal(got["tokens"], ref["tokens"])
        print(f"{label}: sharded encode + greedy decode of {BATCH} windows in "
              f"{wall:.2f} s, {got['steps']} steps: tokens equal to the "
              f"unsharded run: {same}; max |xa - unsharded| "
              f"{(xs.to_local().float() - xa.float()).abs().max().item():.3e}")
        if not same:
            raise AssertionError(f"{label}: sharded tokens differ")
        del sharded, xs, xa, mel

        srv = BatchingTranscriptionServer(eng, max_batch=BATCH, max_wait_ms=200.0,
                                          mesh=mesh, overlap_transfers=True)
        try:
            futs = [srv.submit(a, p) for a in audio]
            served = [f.result(timeout=600) for f in futs]
            sizes = list(srv.batch_sizes)
        finally:
            srv.shutdown()
            eng.mesh = None
        same = [r.tokens for r in served] == [r.tokens for r in want]
        print(f"{label}: BatchingTranscriptionServer(mesh=) batch sizes {sizes}: "
              f"tokens equal to the engine's: {same}")
        if not same:
            raise AssertionError(f"{label}: served tokens under the mesh differ")

        if MOE_LAYER:
            with torch.inference_mode():
                out, _ = moe_ffn(shard_moe_params(MOE_LAYER["p"], mesh),
                                 global_batch_from_local(MOE_LAYER["x"], mesh))
            same = torch.equal(out.to_local(), single)
            print(f"{label}: moe_ffn under the ep mesh at N "
                  f"{MOE_LAYER['x'].shape[0]}: equal to the single-device call: "
                  f"{same}")
            if not same:
                raise AssertionError(f"{label}: moe_ffn under the mesh differs")

        with torch.inference_mode():
            out = pipeline_apply(stage_mesh, "stage", block_fn,
                                 place(stack_to_stages(blocks, 1)), xmb)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in kernels}
        same = torch.equal(out, seq)
        print(f"{label}: pipeline_apply, one stage of 4 encoder blocks, 2 "
              f"microbatches of 2 windows: equal to the sequential loop: {same}")
        if not same:
            raise AssertionError(f"{label}: the pipeline differs from the loop")
        predict = _predict(k4=1)(cfg, [got["steps"]])
        for name, n in _traced_launches(eng).items():
            predict[name] += n
        microbatches, stages = xmb.shape[0], 1
        pipe_blocks = (microbatches + stages - 1) * n_layers(blocks)
        predict["flash_attention_fullkv"] += pipe_blocks
        predict["w8a8_gemm"] += 6 * pipe_blocks
        print(f"{label}: launches {json.dumps(launches)}")
        print(f"{label}: predicted launches " + json.dumps(
            {k: v for k, v in predict.items() if v}))
        if launches != predict:
            raise AssertionError(f"{label}: launch counts {launches} != "
                                 f"predicted {predict}")
        mesh_train_step(label, mesh, eng, seed)
    finally:
        dist.destroy_process_group()
    return launches


def mesh_train_step(label: str, mesh, eng, seed: int):
    """One make_train_step step (remat, sequence_parallel_mesh=mesh) on the
    sharded tree of the turbo leg's first GRAD_LAYERS + GRAD_LAYERS blocks
    (_trainable), against the same step on an unsharded copy run first:
    on one rank every collective is a copy, so the loss and every updated
    parameter must be bit-equal."""
    from spittle_tpu_torch.io.npz_checkpoint import named_leaves
    from spittle_tpu_torch.parallel.mesh import shard_params
    from spittle_tpu_torch.parallel.multihost import global_batch_from_local
    from spittle_tpu_torch.train import make_train_step

    cfg = dataclasses.replace(eng.cfg, name="turbo-mesh-train",
                              n_audio_layer=GRAD_LAYERS, n_text_layer=GRAD_LAYERS)
    params = _trainable(eng, GRAD_LAYERS)
    plain = _clone_tree(params)
    batch = _train_batch(cfg, GRAD_BATCH, seed + 43)
    init, step = make_train_step(cfg, learning_rate=TRAIN_LR, remat=True)
    _, _, want = step(plain, init(plain), batch)
    sharded = shard_params(params, mesh)  # its shards alias params' tensors
    init, step = make_train_step(cfg, learning_rate=TRAIN_LR, remat=True,
                                 sequence_parallel_mesh=mesh)
    kernels = _zero_counters()
    t0 = time.perf_counter()
    _, _, loss = step(sharded, init(sharded), {
        k: global_batch_from_local(v, mesh) for k, v in batch.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    same = float(loss) == float(want) and all(
        torch.equal(a, b) for (_, a), (_, b) in
        zip(named_leaves(params), named_leaves(plain)))
    print(f"{label}: train step on the sharded tree ({cfg.n_audio_layer} + "
          f"{cfg.n_text_layer} layers at turbo's widths, B {GRAD_BATCH}, remat, "
          f"sequence parallel) in {wall * 1e3:.1f} ms: loss {float(loss):.6f}, "
          f"loss and updated parameters bit-equal to the unsharded step: {same}; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if not same:
        raise AssertionError(f"{label}: the sharded train step differs")
    layers = cfg.n_audio_layer + cfg.n_text_layer
    if launches["flash_attention_fullkv"] != 2 * layers or \
            launches["flash_attention_fullkv_bwd"] != layers:
        raise AssertionError(f"{label}: train step launches {launches}")


def _train_batch(cfg, b: int, seed: int):
    """b windows of 30 s seeded speech-like audio as log-mels made on the
    card, SpecAugment applied there (a CUDA generator), and random target
    tokens: the batch of the train path."""
    from spittle_tpu_torch.audio.mel import log_mel_spectrogram
    from spittle_tpu_torch.train.augment import spec_augment

    rng = np.random.default_rng(seed)
    pcm = torch.from_numpy(np.stack([synth_utterance(rng, 30.0) for _ in range(b)]
                                    ).astype(np.float32) / 32768.0).cuda()
    mel = log_mel_spectrogram(pcm, n_mels=cfg.n_mels)
    mel = spec_augment(torch.Generator(device="cuda").manual_seed(seed), mel)
    toks = rng.integers(0, cfg.n_vocab, (b, TRAIN_TOKENS + 1))
    return dict(mel=mel, tokens=torch.from_numpy(toks[:, :-1]).cuda(),
                targets=torch.from_numpy(toks[:, 1:]).cuda(),
                mask=torch.ones((b, TRAIN_TOKENS), device="cuda"))


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _trainable(eng, layers: int = 0):
    """The engine's weights as a float tree of its own that the train step
    takes: each W8A8 weight dequantized on the card to the engine's dtype
    (its int8 codes times the per-column scales), every other leaf copied;
    layers > 0 keeps the first `layers` blocks of each stack. The
    engine's tree is left as it is."""
    from spittle_tpu_torch.ops.quant import is_quant_w8a8

    def walk(node, stacked):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and not is_quant_w8a8(v):
                out[k] = walk(v, stacked or k == "blocks")
                continue
            if stacked and layers:
                v = {kk: vv[:layers] for kk, vv in v.items()} if isinstance(v, dict) \
                    else v[:layers]
            if isinstance(v, dict):
                v = (v["qw8"].float() * v["scale"][..., None, :]).to(eng.dtype)
            out[k] = v.detach().clone(memory_format=torch.contiguous_format)
        return out

    return walk(eng.params, False)


def train_phase(label: str, eng, seed: int):
    """The train path: random:large-v3-turbo at full width (d 1280, 20
    heads, 32 + 4 layers, vocab 51866) in bf16, the turbo leg's weights
    (seed 0; its W8A8 encoder weights dequantized, _trainable), B
    TRAIN_BATCH 30 s windows (1500 encoder positions, SpecAugment on the
    card) and TRAIN_TOKENS target tokens. One AdamW step without remat on
    a copy of the weights, then TRAIN_STEPS steps with remat=True from the
    same weights: the first step's loss and every gradient must be
    bit-equal to the copy's, every leaf must have a finite gradient, and
    the launches must be K1 once per layer per forward (36 a step, 72
    under remat) and K15 once per layer per step, every other kernel 0.
    Prints each step's loss, ms and peak memory, then one more remat
    step's device ms by group and busy share (probes/train_profile.py's
    profile_step)."""
    from spittle_tpu_torch.io.npz_checkpoint import named_leaves
    from spittle_tpu_torch.probes.train_profile import profile_step
    from spittle_tpu_torch.train import make_train_step

    cfg = eng.cfg
    t0 = time.perf_counter()
    params = _trainable(eng)
    plain = _clone_tree(params)
    batch = _train_batch(cfg, TRAIN_BATCH, seed + 21)
    torch.cuda.synchronize()
    print(f"{label}: {cfg.name} weights copied and batch made in "
          f"{time.perf_counter() - t0:.1f} s; B {TRAIN_BATCH}, mel "
          f"{tuple(batch['mel'].shape)}, {TRAIN_TOKENS} tokens")
    init_p, step_p = make_train_step(cfg, learning_rate=TRAIN_LR)
    init_r, step_r = make_train_step(cfg, learning_rate=TRAIN_LR, remat=True)
    state_p, state_r = init_p(plain), init_r(params)
    kernels = _zero_counters()
    losses, times, peaks = [], [], []

    def timed(step, tree, state):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, _, loss = step(tree, state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        losses.append(float(loss))

    timed(step_p, plain, state_p)
    for i in range(TRAIN_STEPS):
        timed(step_r, params, state_r)
        if i == 0:
            named = list(named_leaves(params))
            missing = [n for n, t in named if t.grad is None
                       or not torch.isfinite(t.grad).all()]
            if missing:
                raise AssertionError(f"{label}: leaves without a finite "
                                     f"gradient: {missing}")
            same = losses[1] == losses[0] and all(
                torch.equal(a.grad, b.grad)
                for a, b in zip(state_r.leaves(), state_p.leaves()))
            print(f"{label}: first step's loss and gradients with and without "
                  f"remat bit-equal: {same}")
            if not same:
                raise AssertionError(f"{label}: remat changed the gradients")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    for i, (loss, ms, peak) in enumerate(zip(losses, times, peaks)):
        print(f"{label}: step {i} ({'remat' if i else 'no remat'}): loss "
              f"{loss:.6f}  ms {ms:.1f}  peak device memory {peak:.2f} GiB")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses}")
    layers = cfg.n_audio_layer + cfg.n_text_layer
    predict = {fn.__name__: 0 for fn in kernels}
    predict["flash_attention_fullkv"] = layers * (1 + 2 * TRAIN_STEPS)
    predict["flash_attention_fullkv_bwd"] = layers * (1 + TRAIN_STEPS)
    print(f"{label}: launches {json.dumps(launches)}")
    print(f"{label}: predicted launches " + json.dumps(
        {k: v for k, v in predict.items() if v}))
    if launches != predict:
        raise AssertionError(f"{label}: launch counts {launches} != predicted "
                             f"{predict}")
    # One more remat step under torch.profiler, after the counts are read.
    print(f"{label}: profiled remat step " + json.dumps(
        profile_step(step_r, params, state_r, batch)))
    del params, plain, state_p, state_r, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def grad_check_phase(label: str, eng, seed: int):
    """The card's bf16 gradient against the CPU's f32 autograd on the same
    bf16-rounded weights and batch, at turbo's widths and GRAD_LAYERS +
    GRAD_LAYERS layers, B GRAD_BATCH, 30 s windows and TRAIN_TOKENS
    tokens: every leaf must have a gradient on the card, the encoder's
    wq/wk/wv nonzero ones, and each leaf must be within GRAD_TOL of its
    largest CPU |g|. The weights are the turbo leg's first blocks
    (_trainable). Prints each leaf's share. On the CPU, K1's autograd
    Function runs its plain versions, so the reference's attention
    gradient is the port's explicit formula (flash_attention_fullkv_bwd_plain,
    held to jax.vjp in the CPU tests), not torch's autograd; k15_phase
    holds K15 to torch's autograd through K1's plain forward."""
    from spittle_tpu_torch.io.npz_checkpoint import named_leaves
    from spittle_tpu_torch.train import cross_entropy_loss

    cfg = dataclasses.replace(eng.cfg, name="turbo-grad-check",
                              n_audio_layer=GRAD_LAYERS, n_text_layer=GRAD_LAYERS)
    card = _trainable(eng, GRAD_LAYERS)
    host = {n: t.float().cpu() for n, t in named_leaves(card)}
    batch = _train_batch(cfg, GRAD_BATCH, seed + 31)
    kernels = _zero_counters()
    named = list(named_leaves(card))
    for _, t in named:
        t.requires_grad_(True)
    t0 = time.perf_counter()
    loss = cross_entropy_loss(card, *(batch[k] for k in ("mel", "tokens", "targets",
                                                          "mask")), cfg)
    loss.backward()
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in kernels}

    def nest(flat):
        out = {}
        for name, t in flat.items():
            node = out
            *path, leaf = name.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
        return out

    for t in host.values():
        t.requires_grad_(True)
    t0 = time.perf_counter()
    ref = cross_entropy_loss(nest(host), *(batch[k].float().cpu() if k == "mel"
                                           else batch[k].cpu()
                                           for k in ("mel", "tokens", "targets",
                                                     "mask")), cfg)
    ref.backward()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    loss, ref = float(loss.detach()), float(ref.detach())
    print(f"{label}: loss card bf16 {loss:.6f}, CPU f32 {ref:.6f}; "
          f"forward + backward ms card {card_ms:.1f}, CPU {cpu_ms:.1f}; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    shares, worst = {}, 0.0
    for name, t in named:
        if t.grad is None or not torch.isfinite(t.grad).all():
            raise AssertionError(f"{label}: {name} has no finite gradient")
        want = host[name].grad
        scale = want.abs().max().item()
        share = (t.grad.float().cpu() - want).abs().max().item() / max(scale, 1e-30)
        shares[name] = share
        worst = max(worst, share)
    for key in ("wq", "wk", "wv"):
        if not card["encoder"]["blocks"][key].grad.abs().max().item() > 0:
            raise AssertionError(f"{label}: encoder {key} got a zero gradient")
    print(f"{label}: max |g_card - g_cpu| / max |g_cpu| per leaf (tolerance "
          f"{GRAD_TOL}): " + json.dumps({k: float(f"{v:.3e}") for k, v in shares.items()}))
    if not worst <= GRAD_TOL:
        raise AssertionError(f"{label}: a leaf's gradient is off by {worst:.3e} "
                             f"of its largest")
    layers = 2 * GRAD_LAYERS
    if launches["flash_attention_fullkv"] != layers or \
            launches["flash_attention_fullkv_bwd"] != layers:
        raise AssertionError(f"{label}: launches {launches}")
    return launches


def padded_rows(x):
    """x [..., Tk] (int8 or bf16) copied into rows tma_pitch(Tk) elements
    apart, as the decoder stores its cross-K/V (models/whisper/model.py:
    precompute_cross_kv and precompute_cross_kv_quant): a view of the
    logical shape."""
    from spittle_tpu_torch.ops.attention import tma_pitch

    tk = x.shape[-1]
    buf = x.new_empty((*x.shape[:-1], tma_pitch(tk, x.element_size())))
    buf[..., :tk] = x
    return buf[..., :tk]


def quant_cross_phase(dev):
    """K3 and K6 against their plain versions at B=8 (R = 1, 3, 4, and 5:
    a beam step's five beams folded into each item's rows) and
    B=56 (R = 1) on the decoder's padded rows (Tk 1500 at a pitch of 1504
    bytes: int8 codes, or packed int4 bytes), K6 also on contiguous rows
    (Tk 1500 bytes apart: the cp.async covers). Inputs come from a seeded
    generator on the card. The row's numbers are B=8, R=1's on the padded
    rows; every case's go under "by_shape" (contiguous rows' keys end in
    "contiguous")."""
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.quant import (
        dequantize_kv, dequantize_kv_int4, quantize_kv, quantize_kv_int4,
    )

    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    h, t, d = 20, 1500, 64
    rows = []
    layouts = {"padded": padded_rows, "contiguous": lambda x: x}
    specs = (  # (K#, bits, wrapper, plain, quantizer, dequantizer, key, line,
        #          layouts of the stored rows)
        ("K3", 8, att.decode_cross_attention_q8,
         att.decode_cross_attention_q8_plain, quantize_kv, dequantize_kv,
         "qw", 795, ("padded",)),
        ("K6", 4, att.decode_cross_attention_q4,
         att.decode_cross_attention_q4_plain, quantize_kv_int4,
         dequantize_kv_int4, "qw4", 876, ("padded", "contiguous")),
    )
    for kname, bits, fn, plain, quant, dequant, key, line, names in specs:
        stored = d if bits == 8 else d // 2
        row = None
        for name in names:
            layout = layouts[name]
            print(f"{kname} {fn.__name__} K/V {bits}-bit [B,20,{stored},1500] "
                  f"+ f32 scales, {name} rows:")
            for b, rs in ((8, (1, 3, 4, BEAM)), (LV3_BATCH, (1,))):
                kv_bytes = 2 * b * h * stored * t + 2 * b * h * t * 4

                def make_set():
                    """(qK, ks, qV, vs) and the yardstick's bf16 K/V,
                    dequantized and laid out for SDPA beforehand (not
                    timed)."""
                    qkv = [quant(torch.randn((b, h, d, t), generator=gen, device=dev))
                           for _ in range(2)]
                    deq = tuple(dequant(x).transpose(-1, -2).contiguous() for x in qkv)
                    return (layout(qkv[0][key]), qkv[0]["scale"], layout(qkv[1][key]),
                            qkv[1]["scale"]), deq

                sets = [make_set() for _ in range(n_cold_sets(kv_bytes))]
                for r in rs:
                    qd = (torch.randn((b, h, r, d), generator=gen, device=dev)
                          * d ** -0.5).to(torch.bfloat16)
                    got = fn(qd, *sets[0][0], kv_len=t)
                    want = plain(qd, *sets[0][0], kv_len=t)
                    err = (got.float() - want.float()).abs().max().item()
                    # K4's tolerance: the kernel rounds bf16(p * vs) against
                    # its work item's max (128 positions), the plain version
                    # against the row max (a bf16 half-ulp per weight,
                    # averaged), then one bf16 rounding of the output.
                    check(f"{kname} {name} B={b} R={r}", err,
                          2e-3 + 1e-2 * want.float().abs().max().item())
                    kernel = [lambda kv=kv: fn(qd, *kv, kv_len=t) for kv, _ in sets]
                    ms, eager_ms = time_ms(kernel, 100), call_ms(kernel, 100)
                    plain_ms = time_ms([lambda kv=kv: plain(qd, *kv, kv_len=t)
                                        for kv, _ in sets], 5, 1)
                    lib_ms = time_ms([lambda kd=kd, vd=vd: F.scaled_dot_product_attention(
                        qd, kd, vd, scale=1.0) for _, (kd, vd) in sets], 100)
                    nbytes = kv_bytes + 2 * b * h * r * d * 2
                    bms, by = bound(4.0 * b * h * r * t * d, PEAK_BF16_FLOPS, nbytes)
                    row_r = dict(ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bms, max_abs_err=err)
                    print(f"  B={b} R={r} ({len(sets)} input sets): ms {ms:.4f} "
                          f"(eager call_ms {eager_ms:.4f})  plain_ms {plain_ms:.4f}  "
                          f"library_ms (F.scaled_dot_product_attention on bf16 "
                          f"K/V dequantized beforehand) {lib_ms:.4f}  "
                          f"bound_ms {bms:.4f} ({by})")
                    if row is None:
                        row = dict(
                            name=fn.__name__, route="cuda",
                            source="spittle_tpu_torch/csrc/decode_cross_attention_mh.cu",
                            replaces=f"spittle_tpu/ops/attention.py:{line}",
                            work="q [8,20,1,64] (a decode step), K/V rows of 1504 bytes",
                            max_abs_err=err, ms=ms, call_ms=eager_ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=lib_ms,
                            library="F.scaled_dot_product_attention on bf16 K/V "
                                    "dequantized beforehand", by_shape={})
                    elif b == LV3_BATCH and name == "padded":
                        row.update(ms_b56=ms, plain_ms_b56=plain_ms,
                                   bound_ms_b56=bms, library_ms_b56=lib_ms)
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    suffix = "" if name == "padded" else name
                    row["by_shape"][f"B{b}R{r}{suffix}"] = row_r
                del sets, kernel
                torch.cuda.empty_cache()
        rows.append(row)
    return rows


def w8a8_phase(dev):
    """K14 (the "w8a8" decoder's cross-attention, both products int8 x
    int8) against its plain version computed on CPU copies of the same
    inputs, at large-v3's decoder shapes: B 8, H 20, Dh 64, T 1500 on the
    decoder's rows (a 1504-byte pitch), R 1 (a greedy step), 4 (a
    speculative verify), 8 and 228 (a prefill tile with a carried
    prompt), R 4 with kv_len 1300 (the pad's scales large: only a mask
    before the max keeps them out) and with kv_len 100 (ranks 1-7 of each
    cluster hold only pad), and R 1 at bench.py's large-v3 batch of 56.
    Each prints K14's plan (regime, cluster, positions per rank, rows per
    CTA: ops.attention.w8a8_plan) and: device ms (a CUDA graph over
    input sets larger than the L2), eager call ms, the plain version's ms
    on the card (its products in f64, exact), the bound (the int8 K/V and
    the scales once, q and the output once, at 3.35 TB/s; or the int8
    products at 1,979 TOP/s, whichever is longer) and the nearest library
    call, F.scaled_dot_product_attention over the same K/V dequantized to
    bf16 beforehand (a bf16 attention, not the same function). Tolerance:
    one bf16 ulp of each output plus one P code per row (w8a8_code_step),
    at most 1% of the rows past one ulp. The row's numbers are R 1's."""
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.quant import dequantize_kv, quantize_kv_w8a8

    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    h, d, t = 20, 64, 1500

    def make_set(b, kv_len):
        kv = [quantize_kv_w8a8(torch.randn((b, h, d, t), generator=gen, device=dev))
              for _ in range(2)]
        for q in kv:
            if kv_len < t:
                q["qw8"][..., kv_len:] = torch.randint(
                    -127, 128, q["qw8"][..., kv_len:].shape, generator=gen,
                    device=dev, dtype=torch.int8)
                q["scale"][..., kv_len:] = 1e3
        deq = tuple(dequantize_kv(q).transpose(-1, -2).contiguous() for q in kv)
        return (padded_rows(kv[0]["qw8"]), kv[0]["scale"], padded_rows(kv[1]["qw8"]),
                kv[1]["scale"]), deq

    print(f"K14 decode_cross_attention_w8a8 K/V int8 [B,{h},{d},{t}] rows of 1504 "
          f"bytes + f32 scales:")
    row = None
    for b, r, kv_len in ((BATCH, 1, t), (BATCH, 4, t), (BATCH, 8, t), (BATCH, 228, t),
                         (BATCH, 4, 1300), (BATCH, 4, 100), (LV3_BATCH, 1, t)):
        kv_bytes = 2 * b * h * d * t + 2 * b * h * t * 4
        plan = att.w8a8_plan(t, r, d)
        sets = [make_set(b, kv_len) for _ in range(n_cold_sets(kv_bytes))]
        qd = (torch.randn((b, h, r, d), generator=gen, device=dev) * d ** -0.5).to(
            torch.bfloat16)
        args = (qd, *sets[0][0])
        got = att.decode_cross_attention_w8a8(*args, kv_len=kv_len)
        cpu = [a.cpu() for a in args]
        want = att.decode_cross_attention_w8a8_plain(*cpu, kv_len=kv_len)
        step = att.w8a8_code_step(*cpu, kv_len=kv_len)
        diff = (got.cpu().float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - (2.0 ** -7 * want.float().abs() + 1e-5)).amax(dim=-1)
        worst = (excess - 1.001 * step).max().item()
        share = (excess > 0).float().mean().item()
        label = f"K14 B={b} R={r} kv_len={kv_len}"
        print(f"  {label}: plan {plan.regime}, cluster {plan.cluster} x {plan.slice} "
              f"positions, {plan.row_tile} rows per CTA ({plan.row_tiles(r)} tiles), "
              f"{plan.smem} bytes of shared memory")
        print(f"  {label}: max_abs_err {err:.3e}; past one bf16 ulp + one P code "
              f"{worst:.3e} (<= 0), rows past one ulp {share:.2%} (<= 1%)")
        if not (worst <= 0 and share <= 0.01):
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        kernel = [lambda kv=kv: att.decode_cross_attention_w8a8(qd, *kv, kv_len=kv_len)
                  for kv, _ in sets]
        ms, eager_ms = time_ms(kernel, 50), call_ms(kernel, 50)
        plain_ms = time_ms([lambda kv=kv: att.decode_cross_attention_w8a8_plain(
            qd, *kv, kv_len=kv_len) for kv, _ in sets], 3, 1)
        lib_ms = time_ms([lambda kd=kd, vd=vd: F.scaled_dot_product_attention(
            qd, kd, vd, scale=1.0) for _, (kd, vd) in sets], 50)
        nbytes = kv_bytes + 2 * (2 * b * h * r * d)
        bms, by = bound(4.0 * b * h * r * t * d, PEAK_INT8_OPS, nbytes)
        print(f"  {label} ({len(sets)} input sets): ms {ms:.4f} (eager call_ms "
              f"{eager_ms:.4f})  plain_ms {plain_ms:.4f}  library_ms "
              f"(F.scaled_dot_product_attention on bf16 K/V dequantized "
              f"beforehand) {lib_ms:.4f}  bound_ms {bms:.4f} ({by})")
        shape = dict(ms=ms, call_ms=eager_ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bms, max_abs_err=err, regime=plan.regime,
                     cluster=plan.cluster)
        if row is None:
            row = dict(
                name="decode_cross_attention_w8a8", route="cuda",
                source="spittle_tpu_torch/csrc/decode_cross_attention_w8a8.cu",
                replaces="spittle_tpu/models/whisper/model.py:550",
                work="q [8,20,1,64] (a decode step), int8 K/V rows of 1504 bytes; "
                     "hand-written for an XLA product, not a TPU kernel",
                max_abs_err=err, ms=ms, call_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                library="F.scaled_dot_product_attention on bf16 K/V dequantized "
                        "beforehand", by_shape={})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        key = (f"R{r}" + ("" if kv_len == t else f"kv{kv_len}")
               + ("" if b == BATCH else f"B{b}"))
        row["by_shape"][key] = shape
        del sets, kernel
        torch.cuda.empty_cache()
    return row


def weight_only_phase(dev, rng):
    """One decode step's weight-only int8 decoder products at large-v3
    width and B=8 (8 per layer: wq, wk, wv, wo, cross_wq, cross_wo, fc1,
    fc2), beside the same products on bf16 weights. They are plain
    matmuls in the reference's order, as XLA ran them there."""
    from spittle_tpu_torch.ops.quant import WHISPER_DECODER_QUANT_KEYS, mm, quantize_weight

    d = 1280
    shapes = {k: (d, 4 * d) if k == "fc1_w" else (4 * d, d) if k == "fc2_w" else (d, d)
              for k in WHISPER_DECODER_QUANT_KEYS}
    w = {k: randn(rng, s, dev, scale=s[0] ** -0.5) for k, s in shapes.items()}
    qw = {k: quantize_weight(v) for k, v in w.items()}
    x = {k: randn(rng, (BATCH, 1, s[0]), dev) for k, s in shapes.items()}
    int8_ms = time_ms(lambda: [mm(x[k], qw[k]) for k in shapes], 50)
    bf16_ms = time_ms(lambda: [mm(x[k], w[k]) for k in shapes], 50)
    nbytes = sum(a * b for a, b in shapes.values())
    print(f"decoder weight-only int8 products, one layer at B={BATCH} "
          f"({len(shapes)} products, {nbytes / 2**20:.1f} MiB of int8 weights): "
          f"ms {int8_ms:.4f} (x 32 layers = {32 * int8_ms:.3f} ms per step); "
          f"bf16 weights ms {bf16_ms:.4f}; int8 bytes alone bound_ms "
          f"{nbytes / PEAK_BYTES * 1e3:.4f}")


def tone_utterance(word_ids):
    """The trained tiny checkpoint's input: one 0.5 s tone per word
    (scripts/train_committed_checkpoint.py:utterance), in a 30 s window."""
    freqs = [220.0, 330.0, 440.0, 587.0, 784.0, 1047.0, 1397.0, 1865.0]
    sr = 16000
    audio = np.zeros(30 * sr, np.float32)
    pos = int(0.1 * sr)
    for w in word_ids:
        n = int(0.5 * sr)
        tt = np.arange(n) / sr
        tone = 0.4 * np.sin(2 * np.pi * freqs[w] * tt).astype(np.float32)
        ramp = np.minimum(1.0, np.arange(n) / (0.01 * sr))
        tone *= (ramp * ramp[::-1]).astype(np.float32)
        audio[pos : pos + n] = tone
        pos += n + int(0.2 * sr)
    return audio


def golden_phase():
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    with open(os.path.join(TINY, "goldens.json")) as f:
        goldens = json.load(f)
    # f32, as the goldens were made; the checkpoint's Dh is 8, which the
    # dispatch keeps on plain ops (as the reference does).
    eng = WhisperEngine(device="cuda", dtype=torch.float32)
    eng.load_model(os.path.join(TINY, "params.npz"))
    p = TranscribeParams(language="en", condition_on_previous_text=False,
                         temperatures=(0.0,), parallel_windows=True)
    cases = goldens["cases"]
    res = eng.transcribe_batch([tone_utterance(c["word_ids"]) for c in cases], p)
    bad = [c["word_ids"] for r, c in zip(res, cases)
           if r.tokens != c["greedy_tokens"]]
    print(f"trained_tiny goldens on the card: {len(cases) - len(bad)}/"
          f"{len(cases)} token-identical")
    if bad:
        raise AssertionError(f"golden tokens differ for {bad}")
    # The app's call: transcribe_samples with TranscribeParams() (the
    # sequential seek loop, language detection, the six-rung ladder).
    rungs, bad = [], []
    for c in cases:
        eng.last_decode_rungs.clear()
        r = eng.transcribe_samples(tone_utterance(c["word_ids"]),
                                   TranscribeParams())
        rungs.append(list(eng.last_decode_rungs))
        if (r.tokens != c["greedy_tokens"]
                or r.language != goldens["language_detected"]):
            bad.append((c["word_ids"], r.tokens, r.language))
    print(f"trained_tiny goldens through transcribe_samples(TranscribeParams()): "
          f"{len(cases) - len(bad)}/{len(cases)} token-identical with language "
          f"{goldens['language_detected']!r}; rungs per case {rungs}")
    if bad:
        raise AssertionError(f"transcribe_samples differs from the goldens: {bad}")
    # Beam search and word timestamps, as tests/test_trained_checkpoint.py
    # holds the reference to them: exact.
    base = dict(language="en", condition_on_previous_text=False, temperatures=(0.0,))
    bad = [c["word_ids"] for c in cases[:3]
           if eng.transcribe_samples(tone_utterance(c["word_ids"]), TranscribeParams(
               beam_size=BEAM, **base)).tokens != c["beam_tokens"]]
    print(f"trained_tiny beam_tokens goldens (beam_size={BEAM}): "
          f"{3 - len(bad)}/3 token-identical")
    if bad:
        raise AssertionError(f"beam tokens differ from the goldens for {bad}")
    res = eng.transcribe_samples(tone_utterance(cases[0]["word_ids"]),
                                 TranscribeParams(word_timestamps=True, **base))
    words = [{"word": w.word, "start": round(w.start, 4), "end": round(w.end, 4)}
             for w in res.words]
    print(f"trained_tiny word_timestamps golden (case 0): "
          f"{'identical' if words == cases[0]['word_timestamps'] else 'DIFFERENT'}")
    if words != cases[0]["word_timestamps"]:
        raise AssertionError(f"word timestamps differ from the golden: {words}")


def golden_spec_w8a8_phase():
    """The trained tiny checkpoint (f32, Dh 8) on the card: its greedy
    goldens through transcribe_samples with a self-draft (load_self_draft:
    both of its decoder layers) and with a loaded draft (the same
    checkpoint through load_draft_model, which encodes each window itself):
    speculative decoding must give the greedy tokens exactly; then the
    checkpoint under quantize_decoder="w8a8" (K14 at Dh 8 in f32 for every
    cross-attention) through parallel windows, token for token equal to
    the port's run of the same on the CPU."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.ops import attention as att

    with open(os.path.join(TINY, "goldens.json")) as f:
        cases = json.load(f)["cases"]
    npz = os.path.join(TINY, "params.npz")
    base = dict(language="en", condition_on_previous_text=False, temperatures=(0.0,))
    for how in ("load_self_draft", "load_draft_model"):
        eng = WhisperEngine(device="cuda", dtype=torch.float32)
        eng.load_model(npz)
        getattr(eng, how)(*((npz,) if how == "load_draft_model" else ()))
        bad, stats = [], []
        for c in cases:
            r = eng.transcribe_samples(tone_utterance(c["word_ids"]),
                                       TranscribeParams(**base))
            stats.append(eng.last_spec_stats)
            if r.tokens != c["greedy_tokens"]:
                bad.append((c["word_ids"], r.tokens))
        mean = {k: round(float(np.mean([s[k] for s in stats])), 3) for k in stats[0]}
        print(f"trained_tiny goldens with speculative decoding ({how}): "
              f"{len(cases) - len(bad)}/{len(cases)} token-identical to greedy; "
              f"mean last_spec_stats {json.dumps(mean)}")
        if bad:
            raise AssertionError(f"speculative tokens differ from the goldens: {bad}")
    audio = [tone_utterance(c["word_ids"]) for c in cases]
    p = TranscribeParams(parallel_windows=True, **base)
    tokens = {}
    for device in ("cuda", "cpu"):
        eng = WhisperEngine(device=device, dtype=torch.float32, quantize_decoder="w8a8")
        eng.load_model(npz)
        att.decode_cross_attention_w8a8.launches = 0
        tokens[device] = [r.tokens for r in eng.transcribe_batch(audio, p)]
        if device == "cuda":
            k14 = att.decode_cross_attention_w8a8.launches
    same = sum(a == b for a, b in zip(tokens["cuda"], tokens["cpu"]))
    print(f"trained_tiny under quantize_decoder='w8a8' (K14 launches {k14}): "
          f"{same}/{len(cases)} token-identical to the CPU run")
    if same != len(cases) or k14 == 0:
        raise AssertionError("w8a8 on the card differs from the CPU run")


def _spec_launches(eng, k_main: str, k_draft: str, rounds, draft_k=4):
    """Launch counts of speculative decodes on `eng` with its draft: per
    window batch K1 once and K2 six times per encoder layer (the draft
    shares the encoder); per decode call, the main model's cross kernel
    once per main layer for the prefill and each round's verify, the
    draft's once per draft layer for its prefill and each of a round's
    draft_k steps; the rest 0."""
    cfg, dcfg = eng.cfg, eng.draft_cfg
    want = {fn.__name__: 0 for fn in _kernels()}
    want["flash_attention_fullkv"] = len(rounds) * cfg.n_audio_layer
    want["w8a8_gemm"] = len(rounds) * 6 * cfg.n_audio_layer
    want[k_main] += cfg.n_text_layer * sum(1 + r for r in rounds)
    want[k_draft] += dcfg.n_text_layer * sum(1 + draft_k * r for r in rounds)
    return want


def _windows_run(eng, audio, p, label):
    """transcribe_batch of `audio` with every counter set to 0 just before
    and read just after: (results, launches, decode steps or rounds,
    decode seconds, wall seconds)."""
    kernels = _reset_traces(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.transcribe_batch(audio, p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    steps = list(eng.last_decode_steps)
    decode_s = eng.stage_seconds["decode"]
    print(f"e2e {label}: {len(audio)} x 30 s in {wall:.3f} s; decode {decode_s:.4f} s "
          f"over {steps} passes: {1e3 * decode_s / max(sum(steps), 1):.3f} ms per "
          f"pass; launches {json.dumps(launches)}")
    return res, launches, steps, decode_s, wall


def w8a8_leg_phase(label: str, eng, seed: int):
    """The large-v3 leg's engine under quantize_decoder="w8a8": its weights
    are the int8 leg's (the decoder is quantized weight-only as "int8"
    does; only the cross-K/V's form and route differ), so the engine is
    switched in place. One batch of 8 x 30 s through transcribe_stream:
    K14 once per decoder layer per step and per prefill (3 rows), K1/K2
    per batch, nothing else. Then one batch with load_self_draft(2) and a
    budget of SPEC_TOKENS: K14 at 4 rows per item in every verify, 1 row
    in the draft's steps, as _spec_launches predicts. Returns the first
    run's counts."""
    from spittle_tpu_torch.engine.base import TranscribeParams

    eng.quantize_decoder = "w8a8"
    counts = e2e_phase(label, eng, 1, BATCH, seed, _predict(k14=1))
    rng = np.random.default_rng(seed + 5)
    audio = [synth_utterance(rng, 30.0) for _ in range(BATCH)]
    p = TranscribeParams(language="en", parallel_windows=True,
                         max_tokens=SPEC_TOKENS,
                         condition_on_previous_text=False, temperatures=(0.0,))
    eng.load_self_draft(2)
    try:
        res, launches, rounds, _, _ = _windows_run(eng, audio, p,
                                                   f"{label} speculative")
        want = _spec_launches(eng, "decode_cross_attention_w8a8",
                              "decode_cross_attention_w8a8", rounds)
    finally:
        eng.draft_params = eng.draft_cfg = None  # back to greedy decoding
    print(f"e2e {label} speculative: last_spec_stats {json.dumps(eng.last_spec_stats)}")
    if launches != want:
        raise AssertionError(f"{label} speculative: launch counts {launches} != "
                             f"predicted {want}")
    assert len(res) == BATCH and all(
        0 <= tok < eng.cfg.n_vocab for r in res for tok in r.tokens)
    return counts


def turbo_speculative_phase(label: str, eng, seed: int):
    """Speculative decoding on the turbo leg's engine (bf16, K4), 8 x 30 s
    windows, 96-token budget, temperature 0.

    1. Exactness at full width: the turbo decoder cast to f32 with TF32
       off, greedy_decode and speculative_greedy_decode with its
       load_self_draft(2) layers over the same encoder output (the engine's
       bf16 encode, cast to f32). K1 and K4 take bf16 only, so the f32
       decoder runs the cross-attention in the "w8a8" form (the decoder's
       weights int8 weight-only, "qw8" cross-K/V: K14 takes f32 q), the
       one f32 decode cross-attention the port has on the card. The tokens
       must be equal.
    2. The engine in bf16 with load_self_draft(2) against the same windows
       greedy: token agreement (bf16 products over 4 rows and over 1 round
       differently, so near-ties may part), last_spec_stats, ms per
       main-model pass against greedy's ms per step, and the launches
       _spec_launches predicts (K4 at 4 rows per item in every verify)."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
    from spittle_tpu_torch.models.whisper.speculative import speculative_greedy_decode
    from spittle_tpu_torch.ops import full_f32
    from spittle_tpu_torch.ops.quant import quantize_whisper_decoder

    cfg = eng.cfg
    rng = np.random.default_rng(seed + 7)
    audio = [synth_utterance(rng, 30.0) for _ in range(BATCH)]
    p = TranscribeParams(language="en", parallel_windows=True, max_tokens=96,
                         condition_on_previous_text=False, temperatures=(0.0,))
    # 1. f32 at full width.
    windows = torch.from_numpy(eng._assemble_windows(
        [a for a in audio], [(i, 0) for i in range(BATCH)])).to("cuda")
    with torch.inference_mode():
        xa = eng._frontend(windows).float()
    p32 = quantize_whisper_decoder({"decoder": _to_f32(eng.params["decoder"])})
    shim = WhisperEngine(device="cuda")  # the engine's own layer pick
    shim.cfg, shim.params = cfg, p32
    shim.load_self_draft(2)
    d32, dcfg = shim.draft_params, shim.draft_cfg
    opts = DecodeOptions(language="en", max_tokens=96, quant_kv=True, quant_kv_w8a8=True)
    kernels = _reset_traces(eng)
    with full_f32():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy = greedy_decode(p32, xa, cfg, opts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        spec = speculative_greedy_decode(p32, d32, xa, xa, cfg, dcfg, opts)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    k14 = {fn.__name__: fn.launches for fn in kernels}["decode_cross_attention_w8a8"]
    want = (cfg.n_text_layer * (1 + greedy["steps"])
            + cfg.n_text_layer * (1 + spec["rounds"])
            + dcfg.n_text_layer * (1 + 4 * spec["rounds"]))
    same = torch.equal(greedy["tokens"], spec["tokens"])
    print(f"e2e {label} f32 (w8a8 cross-attention, K14 launches {k14}, predicted "
          f"{want}): speculative tokens {'identical' if same else 'DIFFERENT'} to "
          f"greedy's over {BATCH} windows; greedy {greedy['steps']} steps in "
          f"{t1 - t0:.3f} s ({1e3 * (t1 - t0) / max(greedy['steps'], 1):.3f} ms per "
          f"step), speculative {spec['rounds']} passes, {spec['accepted_total']} "
          f"positions in {t2 - t1:.3f} s")
    if not same:
        diff = (greedy["tokens"] != spec["tokens"]).nonzero()[:4].tolist()
        raise AssertionError(f"{label}: f32 speculative tokens differ from greedy at {diff}")
    if k14 != want:
        raise AssertionError(f"{label}: K14 launches {k14} != predicted {want}")
    del p32, d32, shim, xa, greedy, spec
    # 2. The bf16 engine, greedy then with its self-draft.
    g_res, _, g_steps, g_dec, _ = _windows_run(eng, audio, p, f"{label} greedy")
    eng.load_self_draft(2)
    try:
        s_res, launches, rounds, s_dec, _ = _windows_run(eng, audio, p,
                                                         f"{label} speculative")
        want = _spec_launches(eng, "decode_cross_attention", "decode_cross_attention",
                              rounds)
    finally:
        eng.draft_params = eng.draft_cfg = None  # back to greedy decoding
    agree = sum(a.tokens == b.tokens for a, b in zip(g_res, s_res))
    print(f"e2e {label} bf16: {agree}/{BATCH} windows token-identical to greedy; "
          f"last_spec_stats {json.dumps(eng.last_spec_stats)}; ms per main-model "
          f"pass {1e3 * s_dec / max(sum(rounds), 1):.3f} against greedy's ms per "
          f"step {1e3 * g_dec / max(sum(g_steps), 1):.3f}")
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != predicted {want}")
    return launches


def t5_tensors(cfg, seed: int):
    """HF-named flan-T5 tensors drawn from numpy at HF's initialisation
    scales (T5PreTrainedModel._init_weights with factor 1): the embedding
    and LM head N(0, 1) and N(0, d^-0.5), q N(0, (d*d_kv)^-0.5), k/v/o and
    wi N(0, d^-0.5) (o: (H*d_kv)^-0.5), wo N(0, d_ff^-0.5), the position
    tables N(0, d^-0.5), norms 1."""
    rng = np.random.default_rng(seed)
    d, inner, ff = cfg.d_model, cfg.inner, cfg.d_ff

    def w(out, inn, std):
        return (rng.standard_normal((out, inn), dtype=np.float32) * np.float32(std))

    t = {"shared.weight": w(cfg.vocab_size, d, 1.0),
         "lm_head.weight": w(cfg.vocab_size, d, d ** -0.5),
         "encoder.final_layer_norm.weight": np.ones(d, np.float32),
         "decoder.final_layer_norm.weight": np.ones(d, np.float32)}
    for side in ("encoder", "decoder"):
        t[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] =             w(cfg.rel_buckets, cfg.num_heads, d ** -0.5)
        for i in range(cfg.num_layers):
            pre = f"{side}.block.{i}.layer"
            attns = [("0.SelfAttention", 0)] + ([("1.EncDecAttention", 1)]
                                                if side == "decoder" else [])
            for name, idx in attns:
                t[f"{pre}.{name}.q.weight"] = w(inner, d, (d * cfg.d_kv) ** -0.5)
                t[f"{pre}.{name}.k.weight"] = w(inner, d, d ** -0.5)
                t[f"{pre}.{name}.v.weight"] = w(inner, d, d ** -0.5)
                t[f"{pre}.{name}.o.weight"] = w(d, inner, inner ** -0.5)
                t[f"{pre}.{idx}.layer_norm.weight"] = np.ones(d, np.float32)
            f = 2 if side == "decoder" else 1
            t[f"{pre}.{f}.DenseReluDense.wi_0.weight"] = w(ff, d, d ** -0.5)
            t[f"{pre}.{f}.DenseReluDense.wi_1.weight"] = w(ff, d, d ** -0.5)
            t[f"{pre}.{f}.DenseReluDense.wo.weight"] = w(d, ff, ff ** -0.5)
            t[f"{pre}.{f}.layer_norm.weight"] = np.ones(d, np.float32)
    return t


def t5_phase():
    """flan-t5-small at full width (FLAN_T5_SMALL: d 512, 8+8 layers, 6
    heads, 32,128 tokens) on numpy-seeded weights, f32, TF32 off, on a
    batch of 8 ragged prompts (12 to 64 tokens): the encoder states and
    teacher-forced logits within 1e-4 of the same functions on a CPU
    copy, greedy_generate's tokens (32 steps at most) equal to the CPU's,
    and its ms per step on the card. Plain ops: every kernel's count must
    read 0."""
    from spittle_tpu_torch.models import t5
    from spittle_tpu_torch.ops import full_f32

    cfg = t5.FLAN_T5_SMALL
    tensors = t5_tensors(cfg, SEED + 5)
    where = {"card": "cuda", "cpu": "cpu"}
    params = {name: t5.params_from_hf_tensors(tensors, cfg, device=dev)
              for name, dev in where.items()}
    rng = np.random.default_rng(SEED + 6)
    lens = [12, 64, 30, 45, 20, 64, 33, 50]
    tokens = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n - 1] = rng.integers(2, cfg.vocab_size, n - 1)
        tokens[i, n - 1] = cfg.eos_id
    dec = rng.integers(2, cfg.vocab_size, (len(lens), 16))
    kernels = _zero_counters()
    out = {}
    with full_f32():
        for name, prm in params.items():
            dev = where[name]
            tok = torch.from_numpy(tokens).to(dev)
            mask = tok != cfg.pad_id
            enc = t5.t5_encode(prm, tok, mask, cfg)
            logits = t5.t5_decoder_forward(prm, torch.from_numpy(dec).to(dev), enc,
                                           mask, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = t5.greedy_generate(prm, tokens, cfg, max_tokens=32)
            torch.cuda.synchronize()
            out[name] = (enc.cpu(), logits.cpu(), gen, time.perf_counter() - t0)
    enc_err = (out["card"][0] - out["cpu"][0]).abs().max().item()
    log_err = (out["card"][1] - out["cpu"][1]).abs().max().item()
    same = np.array_equal(out["card"][2], out["cpu"][2])
    steps = out["card"][2].shape[1]
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"e2e T5 flan-t5-small (B={len(lens)}, prompts {min(lens)}-{max(lens)} "
          f"tokens): encoder states max |card - CPU| {enc_err:.3e}, logits "
          f"{log_err:.3e} (tolerance 1e-4); greedy_generate {steps} steps "
          f"{'identical' if same else 'DIFFERENT'} to the CPU's, "
          f"{1e3 * out['card'][3] / steps:.3f} ms per step on the card")
    if not (enc_err <= 1e-4 and log_err <= 1e-4 and same):
        raise AssertionError("T5 on the card differs from its CPU run")
    if any(launches.values()):
        raise AssertionError(f"T5: a kernel ran on this path: {launches}")
    return launches


def _to_f32(tree):
    """Every floating tensor of a parameter tree in f32."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def family_utterance(word_ids):
    """The trained_families checkpoints' input: one 0.48 s tone per word on
    a fixed frame grid in a 6 s window (a copy of
    scripts/train_family_checkpoints.py:utterance and its constants)."""
    sr, tone_s, gap_s, lead_s, utt_s = 16000, 0.48, 0.32, 0.16, 6.0
    freqs = [float(f) for f in np.geomspace(210.0, 3500.0, 16).round(1)]
    audio = np.zeros(int(utt_s * sr), np.float32)
    pos = int(lead_s * sr)
    n = int(tone_s * sr)
    t = np.arange(n) / sr
    ramp = np.minimum(1.0, np.arange(n) / (0.01 * sr))
    env = (ramp * ramp[::-1]).astype(np.float32)
    for w in word_ids:
        tone = 0.4 * np.sin(2 * np.pi * freqs[w] * t).astype(np.float32)
        audio[pos: pos + n] = tone * env
        pos += n + int(gap_s * sr)
    return audio


def _family_engines():
    """family -> the port's engine class."""
    from spittle_tpu_torch.engine.moonshine_engine import MoonshineEngine
    from spittle_tpu_torch.engine.parakeet_engine import ParakeetEngine
    from spittle_tpu_torch.engine.sensevoice_engine import SenseVoiceEngine

    return {"parakeet": ParakeetEngine, "sensevoice": SenseVoiceEngine,
            "moonshine": MoonshineEngine}


def family_golden_phase():
    """The committed trained_families checkpoints (Parakeet-TDT, SenseVoice,
    Moonshine) through the port's engines on the card, f32: every case's
    text exact, and each Parakeet case's detected language the case's."""
    from spittle_tpu_torch.engine.base import TranscribeParams

    with open(os.path.join(FAMILIES, "goldens.json")) as f:
        cases = json.load(f)["cases"]
    audios = [family_utterance(c["word_ids"]) for c in cases]
    for family, cls in _family_engines().items():
        eng = cls(device="cuda")
        eng.load_model(os.path.join(FAMILIES, f"{family}.npz"))
        res = eng.transcribe_batch(audios, TranscribeParams(language=None))
        bad = [(c["word_ids"], r.text, r.language) for c, r in zip(cases, res)
               if r.text != c[family]["text"]
               or (family == "parakeet" and r.language != c["language"])]
        print(f"trained_families {family} goldens on the card: "
              f"{len(cases) - len(bad)}/{len(cases)} exact"
              + (" (with the detected language)" if family == "parakeet" else ""))
        if bad:
            raise AssertionError(f"{family} goldens differ: {bad}")


def family_phase(label: str, model: str, seed: int):
    """One of the other families at full width with random weights (f32):
    transcribe_batch over FAMILY_SECONDS (8 utterances of 5 to 30 s, so the
    valid-length masks differ), then transcribe_samples on one 65 s item,
    with every launch counter set to 0 just before each call and read just
    after: no kernel of the port's csrc runs on these paths, so all must
    read 0. Prints wall, stage and per-step seconds and peak memory.
    Returns the counts."""
    t0 = time.perf_counter()
    eng = _family_engines()[label](device="cuda")
    eng.load_model(model, seed=seed)
    torch.cuda.synchronize()
    cfg = eng.cfg
    print(f"engine: {model} ({cfg}) loaded in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed + 3)
    batch = [synth_utterance(rng, s) for s in FAMILY_SECONDS]
    long_item = synth_utterance(rng, FAMILY_LONG_S)
    eng.transcribe_batch(batch[:2])  # warm-up (cuBLAS, cuFFT plans)
    kernels = _kernels()
    launches = {fn.__name__: 0 for fn in kernels}
    for name, call, seconds in (
            (f"{len(batch)} x {min(FAMILY_SECONDS):g}-{max(FAMILY_SECONDS):g} s",
             lambda: eng.transcribe_batch(batch), FAMILY_SECONDS),
            (f"1 x {FAMILY_LONG_S:g} s", lambda: [eng.transcribe_samples(long_item)],
             (FAMILY_LONG_S,))):
        eng.stage_seconds.clear()
        eng.last_decode_steps.clear()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for fn in kernels:
            launches[fn.__name__] += fn.launches
        stages = {k: round(v, 4) for k, v in eng.stage_seconds.items()}
        steps = sum(eng.last_decode_steps)
        per_step = (f"{eng.stage_seconds['decode'] / steps * 1e3:.3f} ms per "
                    f"decode step" if steps else "no decode loop (CTC)")
        print(f"e2e {label} {name}: {wall:.3f} s wall, RTFx {sum(seconds) / wall:.1f}; "
              f"encoder {eng.stage_seconds['encode']:.4f} s; decode steps "
              f"{eng.last_decode_steps}, {per_step}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; stage "
              f"seconds {json.dumps(stages)}")
        print(f"e2e {label} {name}: first texts "
              f"{json.dumps([r.text[:60] for r in results[:2]], ensure_ascii=False)}")
        # Output checks: one result per item, segments inside the audio, a
        # decode loop that ran where the family has one.
        assert len(results) == len(seconds), (len(results), len(seconds))
        for r, dur in zip(results, seconds):
            assert isinstance(r.text, str)
            assert all(0.0 <= seg.start <= seg.end <= dur
                       for seg in r.segments), (dur, r.segments)
        if label != "sensevoice":
            assert steps > 0, eng.last_decode_steps
    print(f"e2e {label}: launches {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"{label}: a kernel ran on this path: {launches}")
    del eng
    return launches


def load_engine(model: str, engine_opts: dict, seed: int):
    """A W8A8-encoder, mu-law, bf16 engine with `model` loaded."""
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    t0 = time.perf_counter()
    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw", **engine_opts)
    eng.load_model(model, seed=seed)
    torch.cuda.synchronize()
    cfg = eng.cfg
    print(f"engine: {model} (d={cfg.n_audio_state}, "
          f"{cfg.n_audio_layer}+{cfg.n_text_layer} layers) {engine_opts} "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    return eng


def synth_utterance(rng, seconds: float) -> np.ndarray:
    """int16 PCM at 16 kHz: three tones at random pitches, amplitude
    modulated at 0.5 Hz, with a little noise."""
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000
    f = rng.uniform(120.0, 400.0, size=3)
    sig = sum(np.sin(2 * np.pi * fi * tt) for fi in f) / 3.0
    sig = 0.3 * sig * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * tt))
    sig += 0.02 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def e2e_phase(label: str, eng, n_batches: int, batch: int, seed: int, predict,
              seconds: float = 30.0, audio_ctx=None):
    """One end-to-end path on a loaded engine: warm up, then n_batches
    batches of `batch` utterances of `seconds` each through
    transcribe_stream(overlap_fetch=True) with every launch counter set
    to 0 just before and read just after. audio_ctx: the reduced encoder
    context (TranscribeParams.audio_ctx). predict(cfg, steps) gives the
    launch count each kernel must show. Returns the counts."""
    from spittle_tpu_torch.engine.base import TranscribeParams

    cfg = eng.cfg
    print(f"e2e {label}: encoder_attention={eng.encoder_attention!r} "
          f"n_audio_ctx={cfg.n_audio_ctx} audio_ctx={audio_ctx}")
    rng = np.random.default_rng(seed + 1)

    def make_batch():
        return [synth_utterance(rng, seconds) for _ in range(batch)]

    p = TranscribeParams(language="en", condition_on_previous_text=False,
                         parallel_windows=True, temperatures=(0.0,),
                         max_tokens=96, audio_ctx=audio_ctx)
    warm = list(eng.transcribe_stream([make_batch()], p, overlap_fetch=True))
    assert len(warm) == 1 and len(warm[0]) == batch
    batches = [make_batch() for _ in range(n_batches)]
    eng.stage_seconds.clear()
    eng.last_decode_steps.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(eng.transcribe_stream(batches, p, overlap_fetch=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    STAGE_SECONDS[label] = (dict(eng.stage_seconds), n_batches)

    audio_s = n_batches * batch * seconds
    steps = list(eng.last_decode_steps)
    print(f"e2e {label}: {n_batches} batches x {batch} x {seconds:g} s in "
          f"{wall:.3f} s: sustained RTFx {audio_s / wall:.1f} (audio seconds "
          f"per wall second)")
    print(f"e2e {label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"e2e {label}: stage seconds " + json.dumps(
        {k: round(v, 4) for k, v in eng.stage_seconds.items()}))
    print(f"e2e {label}: decode steps per batch {steps}; "
          f"launches {json.dumps(launches)}")

    # Output checks: one result per utterance (each fits one window here),
    # tokens inside the vocabulary, one decode per batch.
    assert len(results) == n_batches and len(steps) == n_batches
    for res in results:
        assert len(res) == batch
        for r in res:
            assert all(0 <= tok < cfg.n_vocab for tok in r.tokens)
    want = predict(cfg, steps)
    print(f"e2e {label}: predicted launches " + json.dumps(
        {k: v for k, v in want.items() if v}))
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != predicted {want}")
    del results
    return launches


def _traced_launches(eng, detections: int = 0):
    """The launch counts the engine's decode traces since they were cleared
    give: per window batch (one frontend, one ladder) K1 once and K2 six
    times per encoder layer; per decode call K4 once per decoder layer for
    each step and, where the prefix has at most 8 rows, for the prefill;
    per language detection K4 once per decoder layer; the rest 0."""
    cfg = eng.cfg
    frontends = len(eng.last_decode_rungs)
    dec = sum(s + (rows <= 8) for s, rows in
              zip(eng.last_decode_steps, eng.last_prefix_rows))
    want = {fn.__name__: 0 for fn in _kernels()}
    want.update({
        "flash_attention_fullkv": frontends * cfg.n_audio_layer,
        "w8a8_gemm": frontends * 6 * cfg.n_audio_layer,
        "decode_cross_attention": cfg.n_text_layer * (dec + detections),
    })
    return want


def _zero_counters():
    """Every kernel wrapper's launch count set to 0; returns the wrappers."""
    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    return kernels


def _reset_traces(eng):
    eng.stage_seconds.clear()
    for trace in (eng.last_decode_steps, eng.last_prefix_rows,
                  eng.last_decode_rungs):
        trace.clear()
    return _zero_counters()


def app_phase(label: str, eng, seed: int):
    """The dictation app's path on a loaded engine: transcribe_samples with
    TranscribeParams() (the sequential seek loop, language detection, the
    six-rung ladder, the prompt carry) on a 5 s utterance and a 65 s item
    with an initial prompt (three or more windows, the first conditioned
    on the prompt, each later one on the text before it), with every launch
    counter set to 0 just before and read just after, checked against
    the counts the path's shapes give: per window K1 once and K2 six
    times per encoder layer; per decode call (every rung of every window)
    K4 once per decoder layer for each step and, where the prefix has at
    most 8 rows, for the prefill; per call one detection step, K4 once
    per decoder layer. Returns the counts."""
    from spittle_tpu_torch.engine.base import TranscribeParams

    cfg = eng.cfg
    rng = np.random.default_rng(seed + 2)
    short, long_item = synth_utterance(rng, 5.0), synth_utterance(rng, 65.0)
    calls = (("5 s", short, TranscribeParams()),
             ("65 s, initial_prompt", long_item,
              TranscribeParams(initial_prompt=APP_PROMPT)))
    print(f"e2e {label}: encoder_attention={eng.encoder_attention!r}, "
          f"TranscribeParams() (ladder {eng.FALLBACK_TEMPERATURES}, "
          f"budget {cfg.n_text_ctx // 2} tokens)")
    kernels = _reset_traces(eng)
    torch.cuda.synchronize()
    results = []
    for name, audio, params in calls:
        rungs0, calls0 = len(eng.last_decode_rungs), len(eng.last_decode_steps)
        t0 = time.perf_counter()
        res = eng.transcribe_samples(audio, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rungs = eng.last_decode_rungs[rungs0:]
        steps = eng.last_decode_steps[calls0:]
        print(f"e2e {label} {name}: {wall:.3f} s wall, {len(rungs)} windows, "
              f"rungs per window {rungs}, steps per rung {steps}, language "
              f"{res.language!r}, {len(res.tokens)} tokens kept")
        results.append(res)
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"e2e {label}: stage seconds " + json.dumps(
        {k: round(v, 4) for k, v in eng.stage_seconds.items()}))
    print(f"e2e {label}: prefix rows per rung {eng.last_prefix_rows}; "
          f"launches {json.dumps(launches)}")

    # Output checks: tokens inside the vocabulary, a detected language,
    # the 65 s item in at least three windows, every window through the
    # ladder's first rung at least, and no more rungs than the ladder has.
    for res in results:
        assert all(0 <= tok < cfg.n_vocab for tok in res.tokens)
        assert res.language in eng.tokenizer.languages, res.language
    windows = len(eng.last_decode_rungs)
    assert windows >= 1 + 3, eng.last_decode_rungs
    assert all(1 <= r <= len(eng.FALLBACK_TEMPERATURES)
               for r in eng.last_decode_rungs)
    assert sum(eng.last_decode_rungs) == len(eng.last_decode_steps)
    want = _traced_launches(eng, detections=len(calls))
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != predicted {want}")
    del results
    return launches


def vad_phase(label: str, eng, seed: int):
    """The long-form VAD path on a loaded engine: 10 minutes of seeded
    synthetic speech bursts at 44.1 kHz made on the card, resampled to 16
    kHz there, Silero over every 30 ms frame and the smoothed spans there;
    the resample, the probabilities and the spans held against the same
    functions on CPU copies of their inputs; then the engine's
    transcribe_vad_segments over the 16 kHz audio (every span one window
    of one batch, greedy, VAD_TOKENS tokens), with every launch counter
    set to 0 just before and read just after. Returns the counts."""
    from spittle_tpu_torch.audio.resample import resample
    from spittle_tpu_torch.audio.vad.segmenter import segment_speech
    from spittle_tpu_torch.audio.vad.silero import (
        _conv_features,
        load_silero_params,
        silero_scan_frames,
    )
    from spittle_tpu_torch.audio.vad.smoothed import DEFAULT_THRESHOLD
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.ops import full_f32
    from spittle_tpu_torch.probes.synthetic import speech_bursts

    dev = eng.device
    x, bursts = speech_bursts(VAD_SECONDS, VAD_RATE, seed + 3, dev)
    vad = load_silero_params(device=dev)
    # Not timed: the first calls' cuDNN plans and allocations.
    resample(x[: 2 * VAD_RATE], VAD_RATE)
    segment_speech(torch.zeros(4800, device=dev), params=vad)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a16 = resample(x, VAD_RATE)
    torch.cuda.synchronize()
    resample_ms = (time.perf_counter() - t0) * 1e3
    n = a16.shape[-1] // 480 * 480
    t0 = time.perf_counter()
    probs = silero_scan_frames(vad, a16[None, :n])
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    spans = segment_speech(a16, params=vad)
    vad_ms = (time.perf_counter() - t0) * 1e3
    print(f"e2e {label}: {VAD_SECONDS:g} s at {VAD_RATE} Hz, {len(bursts)} "
          f"bursts: resample to 16 kHz {resample_ms:.3f} ms, Silero over "
          f"{n // 480} frames {scan_ms:.3f} ms, segment_speech (Silero, one "
          f"fetch, smoothing, spans) {vad_ms:.3f} ms: {len(spans)} spans")

    # The same functions on CPU copies of their inputs.
    cpu_vad = load_silero_params(device="cpu")
    a16_cpu = resample(x.cpu(), VAD_RATE)
    res_err = float((a16.cpu() - a16_cpu).abs().max() / a16_cpu.abs().max())
    a16_host = a16.cpu()
    probs_cpu = silero_scan_frames(cpu_vad, a16_host[None, :n])
    p_err = float((probs.cpu() - probs_cpu).abs().max())
    spans_cpu = segment_speech(a16_host, params=cpu_vad)
    edge = float((probs_cpu - DEFAULT_THRESHOLD).abs().min())
    print(f"e2e {label}: card vs CPU: resample max |err| {res_err:.3g} of the "
          f"peak (tol 1e-5), probabilities max |err| {p_err:.3g} (tol 1e-4), "
          f"spans {'equal' if spans == spans_cpu else 'DIFFERENT'}; nearest "
          f"probability to the threshold {edge:.3g} away")
    check(f"{label} resample", res_err, 1e-5)
    check(f"{label} Silero", p_err, 1e-4)
    if spans != spans_cpu:
        raise AssertionError(f"{label}: spans differ between the card and the CPU")
    # Where the card and the CPU part: the frame-local conv features (the
    # STFT and encoder convs) against the whole chain through the LSTM.
    with torch.inference_mode(), full_f32():
        frames = a16[:n].reshape(-1, 480)
        f_err = float((_conv_features(vad, frames, (2, 2, 2, 1)).cpu()
                       - _conv_features(cpu_vad, frames.cpu(), (2, 2, 2, 1)))
                      .abs().max())
    print(f"e2e {label}: Silero's conv features (before the LSTM) card vs CPU "
          f"max |err| {f_err:.3g}")
    # The spans are the speech: each overlaps a burst widened by the
    # pre-roll and hangover (0.5 s), and nine bursts in ten overlap a span
    # (Silero passes over some synthetic bursts, and its probability falls
    # during a long steady voicing, so a span may end before its burst).
    b16 = [(a * 16000 // VAD_RATE, b * 16000 // VAD_RATE) for a, b in bursts]
    found = sum(any(s.start_sample < b and a < s.end_sample for s in spans)
                for a, b in b16)
    stray = [s for s in spans if not any(s.start_sample < b + 8000
                                         and a - 8000 < s.end_sample
                                         for a, b in b16)]
    print(f"e2e {label}: {found} of {len(bursts)} bursts overlap a span; "
          f"{len(stray)} spans outside the bursts")
    if stray or found < 0.9 * len(bursts):
        raise AssertionError(f"{label}: {len(stray)} stray spans, {found} of "
                             f"{len(bursts)} bursts found")

    params = TranscribeParams(language="en", parallel_windows=True,
                              condition_on_previous_text=False,
                              temperatures=(0.0,), max_tokens=VAD_TOKENS)
    audio = a16_host.numpy()
    kernels = _reset_traces(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.transcribe_vad_segments(audio, params)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"e2e {label}: transcribe_vad_segments {call_ms:.3f} ms wall "
          f"({len(spans)} spans as one batch, decode steps "
          f"{eng.last_decode_steps}), {len(res.segments)} segments; stage "
          f"seconds " + json.dumps({k: round(v, 4)
                                    for k, v in eng.stage_seconds.items()}))
    print(f"e2e {label}: launches {json.dumps(launches)}")
    # Output checks: one window batch of every span, English, segment
    # times inside the recording and its last window (random weights
    # place timestamps anywhere in a span's 30 s window).
    assert eng.last_decode_rungs == [1], eng.last_decode_rungs
    assert res.language == "en", res.language
    assert all(0.0 <= t <= VAD_SECONDS + 30.0
               for g in res.segments for t in (g.start, g.end))
    want = _traced_launches(eng)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != predicted {want}")
    return launches


def wav_bytes(x: np.ndarray, rate: int) -> bytes:
    """16-bit mono WAV file bytes of f32 samples in [-1, 1]."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.clip(x * 32767.0, -32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _post_all(host: str, port: int, bodies):
    """POST every (body, headers) to /transcribe from its own thread, all
    released at once. Returns ([(status, payload)], [seconds per request],
    wall seconds)."""
    import http.client

    out = [None] * len(bodies)
    lat = [0.0] * len(bodies)
    go = threading.Barrier(len(bodies) + 1)

    def client(i):
        body, headers = bodies[i]
        conn = http.client.HTTPConnection(host, port, timeout=600)
        go.wait(timeout=60)
        t0 = time.perf_counter()
        conn.request("POST", "/transcribe", body, headers=headers)
        resp = conn.getresponse()
        out[i] = (resp.status, json.loads(resp.read()))
        lat[i] = time.perf_counter() - t0
        conn.close()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    go.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or None in out:
        raise AssertionError("a client did not finish")
    return out, lat, wall


def _latency_line(lat, wall) -> str:
    ms = np.asarray(lat) * 1e3
    return (f"min {ms.min():.1f} ms, p50 {np.percentile(ms, 50):.1f} ms, p95 "
            f"{np.percentile(ms, 95):.1f} ms, max {ms.max():.1f} ms; "
            f"{len(lat) / wall:.2f} requests/s over {wall:.3f} s")


def serving_phase(label: str, eng, seed: int):
    """The serving path on a loaded engine: BatchingTranscriptionServer
    (max_batch 32, overlap_transfers: stager and runner threads) behind
    TranscriptionHTTPServer on 127.0.0.1:0. Round 1: SERVE_CLIENTS client
    threads POST 1-10 s utterances at once, a third each as 48 kHz WAV
    (resampled on the card), 16 kHz s16le and mu-law, with X-Language en
    (the front's params: the sequential seek loop and the six-rung
    ladder). Round 2: the same utterances submitted at once with
    parallel-window params (SERVE_TOKENS tokens, temperature 0), which
    the stager stages (stage_batch) and the runner computes
    (transcribe_staged). The ladder shapes are warmed first; every launch
    counter is set to 0 just before round 1 and read after round 2.
    Returns the counts."""
    from spittle_tpu_torch.audio.mulaw import mulaw_encode
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.parallel.http_server import TranscriptionHTTPServer
    from spittle_tpu_torch.parallel.serving import BatchingTranscriptionServer

    rng = np.random.default_rng(seed + 4)
    seconds = rng.uniform(*SERVE_SECONDS, SERVE_CLIENTS)
    utts16 = [synth_utterance(rng, s) for s in seconds]  # int16, 16 kHz
    bodies = []
    for i, s in enumerate(seconds):
        if i % 3 == 0:
            x48 = synth_utterance(rng, s * 3.0).astype(np.float32) / 32768.0
            bodies.append((wav_bytes(x48, 48000), {"X-Language": "en"}))
        elif i % 3 == 1:
            bodies.append((utts16[i].astype("<i2").tobytes(),
                           {"X-Language": "en", "X-PCM-Format": "s16le"}))
        else:
            bodies.append((mulaw_encode(utts16[i]).tobytes(),
                           {"X-Language": "en", "X-PCM-Format": "mulaw"}))
    staged_params = TranscribeParams(language="en", parallel_windows=True,
                                     condition_on_previous_text=False,
                                     temperatures=(0.0,), max_tokens=SERVE_TOKENS)
    srv = BatchingTranscriptionServer(eng, max_batch=32, max_wait_ms=200.0,
                                      overlap_transfers=True)
    front = TranscriptionHTTPServer(srv)
    front.start()
    staged_calls = []
    orig_staged = eng.transcribe_staged

    def counted_staged(handle):
        staged_calls.append(len(handle[0]))
        return orig_staged(handle)

    try:
        t0 = time.perf_counter()
        srv.warmup(staged_params, bucket_s=5.0, dtypes=(np.int16,))
        torch.cuda.synchronize()
        print(f"e2e {label}: warmup of the 5 s bucket's ladder "
              f"{srv._ladder_sizes()} in {time.perf_counter() - t0:.3f} s")
        host, port = front.address
        kernels = _reset_traces(eng)
        out, lat, wall = _post_all(host, port, bodies)
        sizes1 = list(srv.batch_sizes)
        print(f"e2e {label} HTTP: {SERVE_CLIENTS} requests of "
              f"{seconds.min():.2f}-{seconds.max():.2f} s (WAV 48 kHz, s16le, "
              f"mu-law): {_latency_line(lat, wall)}; batch sizes {sizes1}")
        # Random weights place timestamps anywhere in a window: a segment
        # ends at most a window past the audio's last seek.
        bad = [(st, p) for (st, p), sec in zip(out, seconds)
               if st != 200 or p["language"] != "en"
               or not all(0.0 <= g[k] <= sec + 30.0
                          for g in p["segments"] for k in ("start", "end"))]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} requests failed: {bad[:2]}")

        eng.transcribe_staged = counted_staged
        futs = [None] * SERVE_CLIENTS
        lat2 = [0.0] * SERVE_CLIENTS
        go = threading.Barrier(SERVE_CLIENTS + 1)

        def client(i):
            go.wait(timeout=60)
            t_i = time.perf_counter()
            futs[i] = srv.submit(utts16[i], staged_params)
            futs[i].result(timeout=600)
            lat2[i] = time.perf_counter() - t_i

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        go.wait(timeout=60)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=900)
        wall2 = time.perf_counter() - t0
        results = [f.result(timeout=1) for f in futs]
        torch.cuda.synchronize()
        print(f"e2e {label} staged: {SERVE_CLIENTS} submits of the same audio "
              f"(16 kHz int16): {_latency_line(lat2, wall2)}; batch sizes "
              f"{srv.batch_sizes[len(sizes1):]}, staged engine calls of "
              f"{staged_calls} rows")
    finally:
        eng.transcribe_staged = orig_staged
        front.stop()
        srv.shutdown()
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"e2e {label}: rungs per window batch {eng.last_decode_rungs}; stage "
          f"seconds " + json.dumps({k: round(v, 4)
                                    for k, v in eng.stage_seconds.items()}))
    print(f"e2e {label}: launches {json.dumps(launches)}")
    # Output checks: every request resolved, round 2 through the staged
    # seam only, tokens inside the vocabulary.
    assert sum(srv.batch_sizes) == 2 * SERVE_CLIENTS, srv.batch_sizes
    assert len(srv.batch_sizes) - len(sizes1) == len(staged_calls)
    for r in results:
        assert r.language == "en"
        assert all(0 <= tok < eng.cfg.n_vocab for tok in r.tokens)
    want = _traced_launches(eng)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != predicted {want}")
    return launches


def golden_http_phase():
    """The trained tiny goldens through the HTTP front on the card: the
    checkpoint (f32) behind BatchingTranscriptionServer(overlap_transfers)
    and TranscriptionHTTPServer, every case's 30 s window POSTed at once as
    raw f32 with no headers (the front's defaults: the sequential seek
    loop, language detection, the ladder). Text, language and segments
    must equal the goldens."""
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.parallel.http_server import TranscriptionHTTPServer
    from spittle_tpu_torch.parallel.serving import BatchingTranscriptionServer

    with open(os.path.join(TINY, "goldens.json")) as f:
        goldens = json.load(f)
    cases = goldens["cases"]
    eng = WhisperEngine(device="cuda", dtype=torch.float32)
    eng.load_model(os.path.join(TINY, "params.npz"))
    srv = BatchingTranscriptionServer(eng, max_batch=8, max_wait_ms=200.0,
                                      overlap_transfers=True)
    front = TranscriptionHTTPServer(srv)
    front.start()
    try:
        out, lat, wall = _post_all(*front.address, [
            (tone_utterance(c["word_ids"]).tobytes(), {}) for c in cases])
    finally:
        front.stop()
        srv.shutdown()
    bad = [(c["word_ids"], st, p) for (st, p), c in zip(out, cases)
           if st != 200 or p["text"] != c["greedy_text"]
           or p["language"] != goldens["language_detected"]
           or p["segments"] != c["segments"]]
    print(f"trained_tiny goldens through the HTTP front: {len(cases) - len(bad)}/"
          f"{len(cases)} texts, languages and segments identical; batch sizes "
          f"{srv.batch_sizes}; {_latency_line(lat, wall)}")
    if bad:
        raise AssertionError(f"HTTP results differ from the goldens: {bad}")


def _cross_kernel(eng) -> str:
    """The decode cross-attention kernel the engine's quantization runs."""
    return {False: "decode_cross_attention", "int8": "decode_cross_attention_q8",
            "int4": "decode_cross_attention_q4"}[eng.quantize_decoder]


def beam_phase(label: str, eng, seed: int, n_windows: int = BATCH):
    """Beam search on a loaded engine: one batch of n_windows 30 s windows
    through transcribe_batch with TranscribeParams(language="en",
    beam_size=BEAM, parallel_windows=True, temperatures=(0.0,),
    max_tokens=96), every launch counter set to 0 just before and read
    just after. Each item's BEAM beams share its cross-K/V, folded into
    its query rows: the engine's cross-attention kernel (K4 bf16, K3 int8)
    runs once per decoder layer and step at BEAM rows per item, and for
    the prefill only where its BEAM x 3 rows are <= 8 (never: 15 go to
    the plain math); K1 once and K2 six times per encoder layer; every
    other kernel 0. Then the same windows greedy (not counted), for the
    ms per step beside the beam's, and the beam step's two host-side
    extras timed alone at this path's shapes: the cache gather along the
    beam axis and the top-k sort over the vocabulary. Returns the
    counts."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.models.whisper import beam as tbeam
    from spittle_tpu_torch.models.whisper.model import init_kv_cache

    cfg = eng.cfg
    rng = np.random.default_rng(seed + 3)
    audio = [synth_utterance(rng, 30.0) for _ in range(n_windows)]
    p = TranscribeParams(language="en", beam_size=BEAM, parallel_windows=True,
                         condition_on_previous_text=False, temperatures=(0.0,),
                         max_tokens=96)
    per_step = {}
    for mode in ("beam", "greedy"):
        eng.stage_seconds.clear()
        for trace in (eng.last_decode_steps, eng.last_prefix_rows):
            trace.clear()
        kernels = _kernels()
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.transcribe_batch(
            audio, p if mode == "beam" else dataclasses.replace(p, beam_size=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps, rows = list(eng.last_decode_steps), list(eng.last_prefix_rows)
        decode_s = eng.stage_seconds["decode"]
        per_step[mode] = 1e3 * decode_s / max(steps[0], 1)
        print(f"e2e {label} ({mode}): {n_windows} x 30 s in {wall:.3f} s, decode "
              f"{decode_s:.4f} s for {steps} steps (prefix rows {rows}): "
              f"{per_step[mode]:.3f} ms per step")
        assert len(res) == n_windows and len(steps) == 1
        for r in res:
            assert all(0 <= tok < cfg.n_vocab for tok in r.tokens)
        if mode == "beam":
            launches = {fn.__name__: fn.launches for fn in kernels}
            print(f"e2e {label}: stage seconds " + json.dumps(
                {k: round(v, 4) for k, v in eng.stage_seconds.items()}))
            print(f"e2e {label}: launches {json.dumps(launches)}")
            assert rows == [BEAM * 3], rows
            want = {fn.__name__: 0 for fn in kernels}
            want.update({
                "flash_attention_fullkv": cfg.n_audio_layer,
                "w8a8_gemm": 6 * cfg.n_audio_layer,
                _cross_kernel(eng): cfg.n_text_layer * (steps[0] + (rows[0] <= 8)),
            })
            if launches != want:
                raise AssertionError(
                    f"{label}: launch counts {launches} != predicted {want}")
    print(f"e2e {label}: ms per decode step, beam_size {BEAM} "
          f"{per_step['beam']:.3f} against greedy {per_step['greedy']:.3f}")
    # The beam step's extras at this path's shapes: the cache gather along
    # axis 2 ([L, 2, B*K, H, ctx, Dh], ctx 128 for 3 + 96 positions) and
    # the two top-k sorts' larger one, over [B*K, V] log-probs.
    bk = n_windows * BEAM
    cache = init_kv_cache(cfg, bk, dtype=torch.bfloat16, ctx=128, device="cuda",
                          quant=bool(eng.quantize_cache))
    src = torch.arange(bk, device="cuda").flip(0)
    logprobs = torch.randn((bk, cfg.n_vocab), device="cuda")
    parts = {}
    for name, fn in (("cache gather", lambda: tbeam._gather_cache(cache, src)),
                     ("top-k sort", lambda: tbeam.top_k(logprobs, BEAM))):
        parts[name] = (time_ms(fn, 20), call_ms(fn, 20))
    print(f"e2e {label}: beam step parts at B*K={bk}: " + "; ".join(
        f"{name} ms {d:.4f} (eager call_ms {e:.4f})" for name, (d, e) in parts.items()))
    del cache, logprobs
    return launches


def words_phase(label: str, eng, seed: int):
    """Word timestamps on a loaded engine at full width:
    transcribe_samples(5 s utterance, TranscribeParams(language="en",
    word_timestamps=True, temperatures=(0.0,))) with every launch counter
    set to 0 just before and read just after. The engine's random-weights
    vocabulary decodes most ids to nothing (no words), so for this call
    its tokenizer is one in which every text id is a word of its own. The
    decode runs K1, K2 and K4 (per step and for the 3-row prefill); the
    alignment pass is plain ops and launches nothing. Checks: words found,
    starts in order, each inside the utterance. Returns the counts."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.models.whisper.tokenizer import WhisperTokenizer

    cfg = eng.cfg
    short = synth_utterance(np.random.default_rng(seed + 4), 5.0)
    tokenizer = eng.tokenizer
    eng.tokenizer = WhisperTokenizer(cfg, {f" w{i}".encode(): i for i in range(cfg.eot)})
    eng.stage_seconds.clear()
    for trace in (eng.last_decode_steps, eng.last_prefix_rows):
        trace.clear()
    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.transcribe_samples(short, TranscribeParams(
            language="en", word_timestamps=True, temperatures=(0.0,)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng.tokenizer = tokenizer
    launches = {fn.__name__: fn.launches for fn in kernels}
    steps = list(eng.last_decode_steps)
    print(f"e2e {label}: 5 s in {wall:.3f} s, {len(res.words)} words from "
          f"{len(res.tokens)} tokens ({steps} steps); alignment pass "
          f"{eng.stage_seconds.get('align', 0.0):.4f} s; stage seconds " + json.dumps(
              {k: round(v, 4) for k, v in eng.stage_seconds.items()}))
    print(f"e2e {label}: first words " + json.dumps(
        [(w.word, round(w.start, 2), round(w.end, 2)) for w in res.words[:6]]))
    print(f"e2e {label}: launches {json.dumps(launches)}")
    starts = [w.start for w in res.words]
    assert res.words and starts == sorted(starts), starts
    assert all(0.0 <= w.start <= w.end <= 5.0 and w.word for w in res.words)
    want = {fn.__name__: 0 for fn in kernels}
    want.update({
        "flash_attention_fullkv": cfg.n_audio_layer,
        "w8a8_gemm": 6 * cfg.n_audio_layer,
        "decode_cross_attention": cfg.n_text_layer * (steps[0] + 1),
    })
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != predicted {want}")
    return launches


def _predict(k4=0, k3=0, k6=0, k14=0, form="fullkv", long_kv=False, gemms=6):
    """Launch counts of one path: the encoder-attention form's kernel (K1
    under "fullkv"; K5 under every form when the encoder's K/V is longer
    than 4096, long_kv) once and K2 `gemms` times per encoder layer and
    batch (6; 4 in a MoE encoder, whose experts are torch products);
    each cross-attention kernel once per decoder layer for the prefill and
    for every step; every other kernel 0."""
    def predict(cfg, steps):
        enc = {fn.__name__: 0 for fn in _kernels()}
        attn = ("flash_attention" if long_kv
                else "flash_attention_fullkv" if form == "fullkv"
                else _form_kernels()[form].__name__)
        dec = cfg.n_text_layer * (len(steps) + sum(steps))
        enc.update({
            attn: len(steps) * cfg.n_audio_layer,
            "w8a8_gemm": len(steps) * gemms * cfg.n_audio_layer,
            "decode_cross_attention": dec * k4,
            "decode_cross_attention_q8": dec * k3,
            "decode_cross_attention_q4": dec * k6,
            "decode_cross_attention_w8a8": dec * k14,
        })
        return enc
    return predict


def probes_phase():
    """Both probes' main()s on the card, their JSON lines printed, with
    every launch counter set to 0 just before and read just after. K11,
    K12 and K13 run here (K3 and K4 too, as the probes' other variants).
    Returns the counts."""
    from spittle_tpu_torch.probes import cache_dus, decode_cross

    kernels = _kernels()
    for fn in kernels:
        fn.launches = 0
    print("probe decode_cross:")
    cross = decode_cross.main()
    print("probe cache_dus:")
    dus = cache_dus.main()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"probes: launches {json.dumps(launches)}")
    # Output checks: every variant reported a finite positive device time,
    # and K11 agrees with K3's plain version to K3's tolerance.
    for rec in cross[:-1]:
        assert np.isfinite(rec["ms"]) and rec["ms"] > 0, rec
    for rec in dus[1:]:
        assert np.isfinite(rec["ms_per_step"]) and rec["ms_per_step"] > 0, rec
    assert (cross[-1]["k11_vs_plain_int8_maxerr"]
            <= 2e-3 + 1e-2 * cross[-1]["plain_int8_max"]), cross[-1]
    # Each timed variant makes one settling run and the timed runs.
    want = {fn.__name__: 0 for fn in kernels}
    want.update({
        "decode_cross_attention": 2 * decode_cross.N_ITER,
        "decode_cross_attention_q8": 2 * decode_cross.N_ITER,
        "decode_cross_attention_q8_mh": 2 * decode_cross.N_ITER + 1,
        "alias_col_write": 2 * (1 + cache_dus.REPS) * cache_dus.STEPS,
        "alias_col_write_sub": 2 * (1 + cache_dus.REPS) * cache_dus.STEPS,
    })
    if launches != want:
        raise AssertionError(f"probes: launch counts {launches} != predicted {want}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from spittle_tpu_torch.device import resolve_device
    from spittle_tpu_torch.ops import _build

    start = time.perf_counter()
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    print(smi)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc build {_build.build_seconds or 0.0:.2f} s)")

    t0 = time.perf_counter()
    rows = kernel_phase(dev, np.random.default_rng(SEED))
    heads_phase(dev, np.random.default_rng(SEED + 1), rows)
    torch.cuda.empty_cache()
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    golden_phase()
    golden_spec_w8a8_phase()
    golden_http_phase()
    family_golden_phase()
    print(f"phase goldens: {time.perf_counter() - t0:.1f} s")
    # Each kernel's launches come from the path that runs it: K1, K2 and
    # K4 from the turbo leg, K7-K10 from the turbo engine under each
    # encoder-attention form, K5 from the long window, K3 from the
    # large-v3 leg, K6 from the int4 variant; every path also checks that
    # the others stayed at 0. The form paths reuse the turbo leg's engine
    # and weights.
    # The reduced-context, app, beam and word-timestamp paths reuse the turbo
    # leg's engine too (the large-v3 beam path the large-v3 leg's); the
    # long-window model is the turbo config with 6000 encoder positions
    # (120 s windows; the same weights, drawn from the same seed), whose
    # encoder self-attention goes to K5. K11, K12 and K13 run in the
    # probes.
    from spittle_tpu_torch.models.whisper.config import CONFIGS

    CONFIGS[LONG_MODEL] = dataclasses.replace(
        CONFIGS["large-v3-turbo"], name=LONG_MODEL, n_audio_ctx=LONG_CTX)
    CONFIGS[MOE_MODEL] = dataclasses.replace(
        CONFIGS["large-v3-turbo"], name=MOE_MODEL, moe_experts=MOE_EXPERTS)
    paths = (  # (label, model, engine options, form, batches, predict,
        #          kernels whose launches this path reports, e2e options;
        #          "run": a phase of its own in place of e2e_phase)
        ("turbo leg", "random:large-v3-turbo", {}, "fullkv", N_BATCHES,
         _predict(k4=1), ("flash_attention_fullkv", "w8a8_gemm",
                          "decode_cross_attention"), {}),
        ("turbo MoE", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=moe_phase)),
        ("mesh", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=mesh_phase)),
        ("train", "random:large-v3-turbo", {}, "fullkv", None, None,
         ("flash_attention_fullkv_bwd",), dict(run=train_phase)),
        ("gradient check", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=grad_check_phase)),
        ("reduced context", "random:large-v3-turbo", {}, "fullkv", N_BATCHES,
         _predict(k4=1), (), dict(seconds=5.0, audio_ctx=256)),
        ("app path", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=app_phase)),
        ("turbo beam", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=beam_phase)),
        ("turbo word timestamps", "random:large-v3-turbo", {}, "fullkv", None, None,
         (), dict(run=words_phase)),
        ("VAD", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=vad_phase)),
        ("serving", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=serving_phase)),
        ("turbo speculative", "random:large-v3-turbo", {}, "fullkv", None, None, (),
         dict(run=turbo_speculative_phase)),
        *((f"turbo {form}", "random:large-v3-turbo", {}, form, 1,
           _predict(k4=1, form=form), (fn.__name__,), {})
          for form, fn in _form_kernels().items()),
        ("long window", f"random:{LONG_MODEL}", {}, "fullkv", N_BATCHES,
         _predict(k4=1, long_kv=True), ("flash_attention",),
         dict(seconds=LONG_CTX / 50.0, batch=2)),
        ("large-v3 leg", "random:large-v3",
         dict(quantize_decoder="int8", quantize_cache=True), "fullkv",
         1, _predict(k3=1), ("decode_cross_attention_q8",), {}),
        ("large-v3 beam", "random:large-v3",
         dict(quantize_decoder="int8", quantize_cache=True), "fullkv", None, None,
         (), dict(run=lambda label, eng, seed: beam_phase(label, eng, seed, 2))),
        ("large-v3 w8a8", "random:large-v3",
         dict(quantize_decoder="int8", quantize_cache=True), "fullkv", None, None,
         ("decode_cross_attention_w8a8",), dict(run=w8a8_leg_phase)),
        ("int4 variant", "random:large-v3-turbo",
         dict(quantize_decoder="int4", quantize_cache=True), "fullkv", 1,
         _predict(k6=1), ("decode_cross_attention_q4",), {}),
    )
    launches, by_path = {}, {}
    eng, loaded = None, None
    for label, model, opts, form, n_batches, predict, owned, e2e in paths:
        t0 = time.perf_counter()
        if loaded != (model, opts):
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            eng, loaded = load_engine(model, opts, SEED), (model, opts)
        eng.encoder_attention = form
        e2e = dict(e2e)
        if "run" in e2e:
            counts = e2e.pop("run")(label, eng, SEED)
        else:
            counts = e2e_phase(label, eng, n_batches, e2e.pop("batch", BATCH),
                               SEED, predict, **e2e)
        print(f"phase e2e {label}: {time.perf_counter() - t0:.1f} s")
        by_path[label] = counts
        launches.update({name: counts[name] for name in owned})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    for label, model in FAMILY_MODELS.items():
        t0 = time.perf_counter()
        by_path[label] = family_phase(label, model, SEED)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase e2e {label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["T5"] = t5_phase()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase e2e T5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["probes"] = probes_phase()
    launches.update({name: by_path["probes"][name] for name in PROBE_KERNELS})
    print(f"phase probes: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = {k: v[row["name"]] for k, v in by_path.items()}
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was never launched on its path")
    print(f"chip_smoke total: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
