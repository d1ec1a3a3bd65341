"""Probe: the host's cost of submitting one call of K4
(decode_cross_attention) and of K3 (decode_cross_attention_q8) at the
decoder's shapes, on the card.

The decode loop is host-bound (PERF.md section 5), so what a wrapper
costs the host per call, not its device time, is what it adds to a step.
Before the timed calls the stream is held by a sleep kernel long enough
that none of them can start, so the host's clock over N_CALLS calls counts
their submission alone (checks, allocations, tensor-map encodes, launches)
and never a wait for the device; "held" reports that the device was still
busy when the last call returned. Each case runs on two layouts of K/V
[B, H, 64, Tk]: contiguous, and rows at a 16-byte pitch (the decoder's
since this port stores its cross-K/V padded: views of [B, H, 64, pitch]).
A layout the wrapper refuses reports null. Median of REPS runs per case;
one JSON line per case, with the card's name and power limit.

    python -m spittle_tpu_torch.probes.decode_cross_host

To compare two trees, run it by path with each tree on PYTHONPATH:

    PYTHONPATH=<tree> python spittle_tpu_torch/probes/decode_cross_host.py

Runs only on a card (it raises without one).
"""

from __future__ import annotations

import json
import statistics
import time
from typing import List

import torch

from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import quantize_kv
from spittle_tpu_torch.probes._timing import device_label

# (B, R): the turbo leg's batch of 8 windows, bench.py's turbo batch of 48.
CASES = ((8, 1), (48, 1))
H, DH, TK = 20, 64, 1500
N_CALLS, REPS = 200, 5
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's clocks
SEED = 0


def _pitched(x: torch.Tensor) -> torch.Tensor:
    """x [B, H, 64, Tk] copied into rows padded to a multiple of 16 bytes,
    returned as a view of the logical shape."""
    per = 16 // x.element_size()
    tk = x.shape[3]
    buf = torch.zeros((*x.shape[:3], -(-tk // per) * per), dtype=x.dtype,
                      device=x.device)
    buf[..., :tk] = x
    return buf[..., :tk]


def submit_ms(fn) -> dict:
    """Median host ms per call of fn over N_CALLS calls issued behind a
    sleep kernel, and whether the stream was still held at the end."""
    fn()
    torch.cuda.synchronize()
    runs, held = [], True
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(N_CALLS):
            fn()
        dt = time.perf_counter() - t0
        done = torch.cuda.Event()
        done.record()
        held = held and not done.query()
        torch.cuda.synchronize()
        runs.append(dt * 1e3 / N_CALLS)
    return {"host_ms": statistics.median(runs), "runs_ms": runs, "held": held}


def main(out=print) -> List[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("decode_cross_host: needs a CUDA card")
    dev = torch.device("cuda")
    label = device_label(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results = []
    with torch.inference_mode():
        for b, r in CASES:
            q = (torch.randn((b, H, r, DH), generator=gen, device=dev)
                 * DH ** -0.5).to(torch.bfloat16)
            k, v = (torch.randn((b, H, DH, TK), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            qk, qv = quantize_kv(k), quantize_kv(v)
            layouts = {
                "contiguous": (k, v, qk["qw"], qv["qw"]),
                "pitched": tuple(_pitched(x) for x in (k, v, qk["qw"], qv["qw"])),
            }
            rec = {"B": b, "R": r, "Tk": TK, "device": label}
            for name, (kk, vv, qk8, qv8) in layouts.items():
                calls = {
                    "k4": lambda: att.decode_cross_attention(q, kk, vv, TK),
                    "k3": lambda: att.decode_cross_attention_q8(
                        q, qk8, qk["scale"], qv8, qv["scale"], TK),
                }
                for kernel, fn in calls.items():
                    try:
                        rec[f"{kernel}_{name}"] = submit_ms(fn)
                    except ValueError:
                        rec[f"{kernel}_{name}"] = None
            results.append(rec)
            out(json.dumps(rec))
            del q, k, v, qk, qv, layouts
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
