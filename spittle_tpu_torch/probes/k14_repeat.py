"""Probe: chip_smoke's first K14 check, repeated, to tell a fault of the
kernel from a fault of its reference.

The check is chip_smoke's w8a8 phase at B 8, H 20, Dh 64, T 1500 (rows
of 1504 bytes), R 1, kv_len 1500, on the same inputs (a card generator
seeded 0 + 14, four input sets made first, q after them). Each turn runs
K14 on the card, the plain version on CPU copies of the inputs (torch's
intra-op threads, as chip_smoke ran it) and the plain version on the
card, and holds K14 to each at chip_smoke's tolerance (one bf16 ulp of
each output plus one P code per row, at most 1% of the rows past one
ulp). It prints one JSON line per turn that differs in any bit from the
first turn (K14's output, the CPU plain output, the card plain output)
and a summary line with the counts.

    python -m spittle_tpu_torch.probes.k14_repeat loop [TURNS]
    python -m spittle_tpu_torch.probes.k14_repeat fresh [PROCESSES] [AT_ONCE]

"loop" makes every turn in one process; "fresh" starts that many
processes (so many at once), each making one turn as the first K14 call
of its process, and prints their lines and the counts.

Runs only on a card with nvcc (it raises without one).
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import quantize_kv_w8a8

from ._timing import device_label

B, H, DH, T, R, SEED = 8, 20, 64, 1500, 1, 0


def _inputs(dev):
    """chip_smoke.w8a8_phase's first inputs: its generator, its four input
    sets (their sum past the L2 twice), q after them; the first set."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)

    def padded(x):
        out = x.new_empty((*x.shape[:-1], att.tma_pitch(T, 1)))
        out[..., :T] = x
        return out[..., :T]

    sets = []
    for _ in range(4):
        kv = [quantize_kv_w8a8(torch.randn((B, H, DH, T), generator=gen, device=dev))
              for _ in range(2)]
        sets.append((padded(kv[0]["qw8"]), kv[0]["scale"], padded(kv[1]["qw8"]),
                     kv[1]["scale"]))
    q = (torch.randn((B, H, R, DH), generator=gen, device=dev) * DH ** -0.5).to(
        torch.bfloat16)
    return (q, *sets[0])


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                        .tobytes()).hexdigest()[:16]


def _held(got, want, step):
    """chip_smoke's K14 tolerance: (passes, worst excess, rows past one
    ulp, max_abs_err)."""
    diff = (got.cpu().float() - want.cpu().float()).abs()
    excess = (diff - (2.0 ** -7 * want.cpu().float().abs() + 1e-5)).amax(dim=-1)
    worst = (excess - 1.001 * step.cpu()).max().item()
    share = (excess > 0).float().mean().item()
    return worst <= 0 and share <= 0.01, worst, share, diff.max().item()


def turn(args, cpu_args) -> dict:
    got = att.decode_cross_attention_w8a8(*args, kv_len=T)
    torch.cuda.synchronize()
    want_cpu = att.decode_cross_attention_w8a8_plain(*cpu_args, kv_len=T)
    step = att.w8a8_code_step(*cpu_args, kv_len=T)
    want_card = att.decode_cross_attention_w8a8_plain(*args, kv_len=T)
    ok_cpu, worst_cpu, share_cpu, err_cpu = _held(got, want_cpu, step)
    ok_card, worst_card, share_card, err_card = _held(got, want_card, step)
    return dict(kernel=_digest(got), plain_cpu=_digest(want_cpu),
                plain_card=_digest(want_card), ok_cpu=ok_cpu, worst_cpu=worst_cpu,
                share_cpu=share_cpu, err_cpu=err_cpu, ok_card=ok_card,
                worst_card=worst_card, share_card=share_card, err_card=err_card)


def loop(turns: int) -> dict:
    dev = torch.device("cuda")
    args = _inputs(dev)
    cpu_args = [a.cpu() for a in args]
    first = None
    counts = dict(turns=0, kernel_moved=0, plain_cpu_moved=0, plain_card_moved=0,
                  failed_cpu=0, failed_card=0)
    t0 = time.perf_counter()
    for i in range(turns):
        rec = turn(args, cpu_args)
        first = first or rec
        counts["turns"] += 1
        moved = [k for k in ("kernel", "plain_cpu", "plain_card") if rec[k] != first[k]]
        for k in moved:
            counts[k + "_moved"] += 1
        counts["failed_cpu"] += not rec["ok_cpu"]
        counts["failed_card"] += not rec["ok_card"]
        if i == 0 or moved or not (rec["ok_cpu"] and rec["ok_card"]):
            print(json.dumps(dict(turn=i, moved=moved, **rec)), flush=True)
    counts["seconds"] = time.perf_counter() - t0
    return counts


def fresh(processes: int, at_once: int) -> dict:
    _build.load_library()  # one build, which every process then loads
    cmd = [sys.executable, "-m", "spittle_tpu_torch.probes.k14_repeat", "loop", "1"]
    recs, failures = [], 0
    for start in range(0, processes, at_once):
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
                 for _ in range(min(at_once, processes - start))]
        for p in procs:
            out, _ = p.communicate(timeout=300)
            failures += p.returncode != 0
            lines = [json.loads(x) for x in out.splitlines() if x.startswith('{"turn"')]
            recs += lines
            for x in lines:
                print(json.dumps(dict(process=len(recs) - 1, **x)), flush=True)
    first = recs[0]
    return dict(processes=len(recs), exits_nonzero=failures,
                kernel_moved=sum(r["kernel"] != first["kernel"] for r in recs),
                plain_cpu_moved=sum(r["plain_cpu"] != first["plain_cpu"] for r in recs),
                plain_card_moved=sum(r["plain_card"] != first["plain_card"] for r in recs),
                failed_cpu=sum(not r["ok_cpu"] for r in recs),
                failed_card=sum(not r["ok_card"] for r in recs))


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("k14_repeat needs a CUDA card")
    mode = argv[0] if argv else "loop"
    if mode == "loop":
        summary = loop(int(argv[1]) if len(argv) > 1 else 1000)
    elif mode == "fresh":
        summary = fresh(int(argv[1]) if len(argv) > 1 else 16,
                        int(argv[2]) if len(argv) > 2 else 4)
    else:
        raise SystemExit(f"unknown mode {mode!r}: loop or fresh")
    print(json.dumps(dict(summary=mode, device=device_label(torch.device("cuda")),
                          threads=torch.get_num_threads(), **summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
