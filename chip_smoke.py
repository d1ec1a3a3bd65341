#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spittle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), and the build time of the kernels (built from
   spittle_tpu_torch/csrc on first use).
2. Kernels against their plain PyTorch versions at the large-v3-turbo
   main-path shapes with B=8 windows: K1 encoder attention, K2 W8A8 GEMM
   (the six GEMMs of one encoder layer), K4 decode cross-attention. Each
   prints its max error and tolerance, its time from CUDA events, the
   plain version's time, a library yardstick the port never calls, and
   the bound from the H100 data-sheet peaks.
3. The trained tiny checkpoint (tests/data/trained_tiny) through the
   engine on the card must reproduce its golden greedy tokens.
4. End to end: WhisperEngine(device="cuda", bf16, W8A8 encoder, mu-law
   wire) on random:large-v3-turbo (numpy-seeded weights, seed 0) runs a
   warm-up batch, then transcribe_stream(overlap_fetch=True) over 2
   batches of 8 30 s int16 windows (max_tokens 96, temperature 0,
   language "en"), with the launch counters set to 0 just before and read
   just after, and checked against the counts the path predicts.

The last two lines are a JSON object of per-kernel numbers and
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense), at its 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

SEED, N_BATCHES, BATCH = 0, 2, 8
REPO = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(REPO, "tests", "data", "trained_tiny")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        quantize_rows, w8a8_gemm, w8a8_gemm_plain,
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
    ms = time_ms(lambda: att.flash_attention_fullkv(q, k, v, kv_len=t), 20)
    plain_ms = time_ms(
        lambda: att.flash_attention_fullkv_plain(q, k, v, kv_len=t), 3, 1)
    lib_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 20)
    bms, by = bound(4.0 * b * h * t * t * d, PEAK_BF16_FLOPS, 4 * b * h * t * d * 2)
    print(f"  ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
          f"library_ms (F.scaled_dot_product_attention) {lib_ms:.4f}  "
          f"bound_ms {bms:.4f} ({by})")
    rows.append(dict(name="flash_attention_fullkv", route="cuda",
                     source="spittle_tpu_torch/csrc/fullkv_attention.cu",
                     replaces="spittle_tpu/ops/attention.py:206",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms,
                     library="F.scaled_dot_product_attention"))
    del packed, q, k, v, got, want

    # K2: the six W8A8 GEMMs of one encoder layer at M = 8 * 1500.
    m = b * t
    x1 = randn(rng, (m, 1280), dev)
    x4 = randn(rng, (m, 5120), dev)
    ws = {shape: quantize_weight_w8a8(
        randn(rng, shape, dev, torch.float32, shape[0] ** -0.5))
        for shape in ((1280, 1280), (1280, 5120), (5120, 1280))}
    bias = {n: randn(rng, (n,), dev, scale=0.1) for n in (1280, 5120)}
    sc = d ** -0.25
    calls = [  # (label, x, weight shape, bias, act, out_scale)
        ("q 1280x1280 +bias *scale", x1, (1280, 1280), 1280, "none", sc),
        ("k 1280x1280 *scale", x1, (1280, 1280), None, "none", sc),
        ("v 1280x1280 +bias", x1, (1280, 1280), 1280, "none", 1.0),
        ("out 1280x1280 +bias", x1, (1280, 1280), 1280, "none", 1.0),
        ("fc1 1280x5120 +bias gelu", x1, (1280, 5120), 5120, "gelu", 1.0),
        ("fc2 5120x1280 +bias", x4, (5120, 1280), 1280, "none", 1.0),
    ]
    print("K2 w8a8_gemm, one encoder layer's six GEMMs at M=12000, bf16:")
    tot = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, ops=0.0, nbytes=0.0)
    lib_ok = True
    for label, x, shape, bn, act, s in calls:
        qw = ws[shape]
        bb = None if bn is None else bias[bn]
        run = lambda: w8a8_gemm(x, qw["qw8"], qw["scale"], bias=bb, act=act,  # noqa: E731
                                out_scale=s)
        got = run()
        want = w8a8_gemm_plain(x, qw["qw8"], qw["scale"], bias=bb, act=act,
                               out_scale=s)
        # One bf16 output ulp: same int8 bytes and int32 sums on both sides.
        err = ((got.float() - want.float()).abs()
               - 2.0 ** -7 * want.float().abs()).max().item()
        check(f"K2 {label} (excess over 1 bf16 ulp)", max(err, 0.0), 1e-5)
        ms = time_ms(run, 20)
        plain_ms = time_ms(lambda: w8a8_gemm_plain(
            x, qw["qw8"], qw["scale"], bias=bb, act=act, out_scale=s), 2, 1)
        kk, n = shape
        lib_ms = None
        if lib_ok:
            qx, _ = quantize_rows(x)
            try:
                lib_ms = time_ms(lambda: torch._int_mm(qx, qw["qw8"]), 20)
            except RuntimeError as e:  # yardstick only; the port never calls it
                print(f"  torch._int_mm unavailable here: {e}")
                lib_ok = False
        ops = 2.0 * m * kk * n
        nbytes = m * kk * 2 + kk * n + n * 4 + (0 if bn is None else n * 2) + m * n * 2
        bms, by = bound(ops, PEAK_INT8_OPS, nbytes)
        print(f"  {label}: ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
              f"library_ms (torch._int_mm, dot alone) "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'}  "
              f"bound_ms {bms:.4f} ({by})")
        tot["err"] = max(tot["err"], (got.float() - want.float()).abs().max().item())
        tot["ms"] += ms
        tot["plain"] += plain_ms
        tot["lib"] = None if (lib_ms is None or tot["lib"] is None) else tot["lib"] + lib_ms
        tot["ops"] += ops
        tot["nbytes"] += nbytes
    bms, by = bound(tot["ops"], PEAK_INT8_OPS, tot["nbytes"])
    print(f"  layer total: ms {tot['ms']:.4f}  bound_ms {bms:.4f} ({by})")
    rows.append(dict(name="w8a8_gemm", route="cuda",
                     source="spittle_tpu_torch/csrc/w8a8_gemm.cu",
                     replaces="spittle_tpu/ops/w8a8_gemm.py:84",
                     work="one encoder layer: 4 x (1280x1280), fc1, fc2 at M=12000",
                     max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain"],
                     bound_ms=bms, bound_by=by, library_ms=tot["lib"],
                     library="torch._int_mm, the int8 dot alone"))
    del x1, x4, ws

    # K4: decode cross-attention, time-minor K/V.
    kt = randn(rng, (b, h, d, t), dev)
    vt = randn(rng, (b, h, d, t), dev)
    print("K4 decode_cross_attention k,v [8,20,64,1500] bf16:")
    # Query rows: 1 in a decode step, 3 in the main path's prefill
    # ([sot, language, task]), 4 in a prefill without timestamps.
    for r in (1, 3, 4):
        qd = randn(rng, (b, h, r, d), dev, scale=d ** -0.5)
        got = att.decode_cross_attention(qd, kt, vt, kv_len=t)
        want = att.decode_cross_attention_plain(qd, kt, vt, kv_len=t)
        err = (got.float() - want.float()).abs().max().item()
        check(f"K4 R={r}", err, 2e-3 + 1e-2 * want.float().abs().max().item())
        ms = time_ms(lambda: att.decode_cross_attention(qd, kt, vt, kv_len=t), 100)
        plain_ms = time_ms(
            lambda: att.decode_cross_attention_plain(qd, kt, vt, kv_len=t), 10)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kt.transpose(-1, -2), vt.transpose(-1, -2), scale=1.0), 100)
        bms, by = bound(4.0 * b * h * r * t * d, PEAK_BF16_FLOPS,
                        2 * b * h * d * t * 2 + 2 * b * h * r * d * 2)
        print(f"  R={r}: ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
              f"library_ms (F.scaled_dot_product_attention) {lib_ms:.4f}  "
              f"bound_ms {bms:.4f} ({by})")
        if r == 1:
            rows.append(dict(name="decode_cross_attention", route="cuda",
                             source="spittle_tpu_torch/csrc/decode_cross_attention.cu",
                             replaces="spittle_tpu/ops/attention.py:723",
                             work="q [8,20,1,64] (a decode step)",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, library_ms=lib_ms,
                             library="F.scaled_dot_product_attention"))
    return rows


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


def e2e_phase(seed: int, n_batches: int, batch: int):
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.ops import attention as att
    from spittle_tpu_torch.ops.w8a8_gemm import w8a8_gemm

    t0 = time.perf_counter()
    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw")
    eng.load_model("random:large-v3-turbo", seed=seed)
    torch.cuda.synchronize()
    cfg = eng.cfg
    print(f"e2e: random:large-v3-turbo (d={cfg.n_audio_state}, "
          f"{cfg.n_audio_layer}+{cfg.n_text_layer} layers) loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed + 1)
    sr, n = 16000, 30 * 16000
    tt = np.arange(n) / sr

    def make_batch():
        out = []
        for _ in range(batch):
            f = rng.uniform(120.0, 400.0, size=3)
            sig = sum(np.sin(2 * np.pi * fi * tt) for fi in f) / 3.0
            sig = 0.3 * sig * (0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * tt))
            sig += 0.02 * rng.standard_normal(n)
            out.append((np.clip(sig, -1, 1) * 32767).astype(np.int16))
        return out

    p = TranscribeParams(language="en", condition_on_previous_text=False,
                         parallel_windows=True, temperatures=(0.0,),
                         max_tokens=96)
    warm = list(eng.transcribe_stream([make_batch()], p, overlap_fetch=True))
    assert len(warm) == 1 and len(warm[0]) == batch
    batches = [make_batch() for _ in range(n_batches)]
    eng.stage_seconds.clear()
    eng.last_decode_steps.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels = (att.flash_attention_fullkv, w8a8_gemm, att.decode_cross_attention)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(eng.transcribe_stream(batches, p, overlap_fetch=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}

    audio_s = n_batches * batch * 30.0
    steps = list(eng.last_decode_steps)
    print(f"e2e: {n_batches} batches x {batch} x 30 s in {wall:.3f} s: "
          f"sustained RTFx {audio_s / wall:.1f}")
    print(f"e2e: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("e2e: stage seconds " + json.dumps(
        {k: round(v, 4) for k, v in eng.stage_seconds.items()}))
    print(f"e2e: decode steps per batch {steps}; launches {json.dumps(launches)}")

    # Output checks: one result per window, tokens inside the vocabulary.
    assert len(results) == n_batches
    for res in results:
        assert len(res) == batch
        for r in res:
            assert all(0 <= tok < cfg.n_vocab for tok in r.tokens)
    want = {
        "flash_attention_fullkv": n_batches * cfg.n_audio_layer,
        "w8a8_gemm": n_batches * 6 * cfg.n_audio_layer,
        "decode_cross_attention": cfg.n_text_layer * (n_batches + sum(steps)),
    }
    if launches != want:
        raise AssertionError(f"launch counts {launches} != predicted {want}")
    for name, cnt in launches.items():
        if cnt == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from spittle_tpu_torch.device import resolve_device
    from spittle_tpu_torch.ops import _build

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

    rows = kernel_phase(dev, np.random.default_rng(SEED))
    torch.cuda.empty_cache()
    golden_phase()
    launches = e2e_phase(SEED, N_BATCHES, BATCH)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
