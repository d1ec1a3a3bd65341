"""Probe: how far Silero's 2-layer LSTM drifts over a long recording in
each arithmetic it could run in, on the card, and what each costs.

The input is Silero's conv features (computed in f64) of ten minutes of
synthetic speech (probes/synthetic.py) resampled from 44.1 kHz: one
sequence of 20,000 steps. Each variant runs the LSTM over it and the head
after it; its largest difference from the f64 evaluation, in the LSTM's
output and in the speech probability, and its wall milliseconds ("wall_ms", host
clock around a synchronised call) go on one JSON line with the card's
name and power limit:

- "f32, TF32 on": cuDNN with PyTorch's default settings;
- "f32": cuDNN inside ops.full_f32 (TF32 off);
- "f32, cuDNN off": PyTorch's own CUDA LSTM, TF32 off;
- "f64": cuDNN in f64, the port's form (audio/vad/silero.py);
- "CPU f32" and "CPU f64": the CPU's LSTM on the same sequence.

    python -m spittle_tpu_torch.probes.silero_lstm

Runs only on a card (it raises without one).
"""

from __future__ import annotations

import contextlib
import copy
import json
import time

import torch

from spittle_tpu_torch.audio.resample import resample
from spittle_tpu_torch.audio.vad import silero
from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.ops import full_f32
from spittle_tpu_torch.probes._timing import device_label
from spittle_tpu_torch.probes.synthetic import speech_bursts

SECONDS, RATE, SEED = 600.0, 44100, 3


def _f64(params):
    """Silero's conv weights in f64 (the LSTM module is left out)."""
    if isinstance(params, dict):
        return {k: _f64(v) for k, v in params.items() if k != "lstm"}
    if isinstance(params, list):
        return [_f64(v) for v in params]
    return params.double()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(seconds: float = SECONDS, device="cuda"):
    dev = resolve_device(device)
    x, _ = speech_bursts(seconds, RATE, SEED, dev)
    a16 = resample(x, RATE)
    n = a16.shape[-1] // 480 * 480
    params = silero.load_silero_params(device=dev)
    lstm64 = params["lstm"]
    lstm32 = copy.deepcopy(lstm64).float()
    head_w = params["head_w"][:, :, 0].double()
    head_b = params["head_b"].double()
    with torch.inference_mode():
        feats = silero._conv_features(_f64(params), a16[:n].reshape(-1, 480).double(),
                                      (2, 2, 2, 1))
        seq = feats.reshape(1, -1, 64).transpose(0, 1).contiguous()
        ref, _ = lstm64(seq, (torch.zeros(2, 1, 64, dtype=torch.float64, device=dev),) * 2)
        ref_p = torch.sigmoid(torch.relu(ref) @ head_w.T + head_b)

    def no_cudnn():
        stack = contextlib.ExitStack()
        stack.enter_context(full_f32())
        stack.enter_context(torch.backends.cudnn.flags(enabled=False))
        return stack

    variants = (("f32, TF32 on", lstm32, torch.float32, contextlib.nullcontext),
                ("f32", lstm32, torch.float32, full_f32),
                ("f32, cuDNN off", lstm32, torch.float32, no_cudnn),
                ("f64", lstm64, torch.float64, full_f32),
                ("CPU f32", copy.deepcopy(lstm32).cpu(), torch.float32,
                 contextlib.nullcontext),
                ("CPU f64", copy.deepcopy(lstm64).cpu(), torch.float64,
                 contextlib.nullcontext))
    label = device_label(dev)
    records = []
    for name, lstm, dtype, ctx in variants:
        on = next(lstm.parameters()).device
        s = seq.to(on, dtype)
        h0 = torch.zeros(2, 1, 64, dtype=dtype, device=on)
        with torch.inference_mode(), ctx():
            lstm(s, (h0, h0))  # settle: plans and allocations
            _sync(dev)
            t0 = time.perf_counter()
            out, _ = lstm(s, (h0, h0))
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
        out = out.to(dev, torch.float64)
        p = torch.sigmoid(torch.relu(out) @ head_w.T + head_b)
        rec = {"variant": name, "steps": int(seq.shape[0]), "wall_ms": ms,
               "out_vs_f64": float((out - ref).abs().max()),
               "prob_vs_f64": float((p - ref_p).abs().max()), "device": label}
        print(json.dumps(rec))
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
