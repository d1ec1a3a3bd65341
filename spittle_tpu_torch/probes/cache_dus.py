"""Probe: the cost of landing one fresh column in a large KV cache between
reads of the whole cache, over a run of dependent steps (the port's
counterpart of scripts/bench_cache_dus.py).

A decode step attends over every layer's self-attention cache and then
writes each layer's new K and V column. This runs STEPS dependent steps
over a [L 32, 2, B 32, H 20, Dh 64, ctx 128] bf16 cache (671 MB, large-v3
at batch 32); the carry is (acc, cache, pos), pos a device int32:

  read-only        acc += a reduction over the K half of every layer (the
                   attend's stand-in)
  read+index       the read, then cache[..., pos] = cols by indexed
                   in-place assignment with a host position, the form
                   models/whisper/model.py:_cache_write uses
  read+k13         the read, then ops.cache_write.alias_col_write (K13)
  k13-only         K13 with no read
  read-only-sub    the ctx-on-rows layout [L*2*B, ctx, H*Dh]: the read
  read+index-sub   that layout, indexed assignment
  read+k12-sub     that layout, ops.cache_write.alias_col_write_sub (K12)
  k12-sub-only     K12 with no read

The reference probe's other arms (an optimization barrier between read
and write, the cache as scan xs and ys, the pending ring) ask whether
XLA copies the whole buffer at a dynamic_update_slice inside a
while_loop. PyTorch writes in place by construction, so they have no
counterpart on a GPU and are not ported.

Prints the cache size, then one JSON line per variant: milliseconds per
step (CUDA events over the run, least of REPS) and the cache bytes over
that time.

    python -m spittle_tpu_torch.probes.cache_dus

runs on the card and raises without one; main(device="cpu", ...) at a
small shape exercises the same code through the plain versions and
reports a host clock under "host_ms".
"""

from __future__ import annotations

import json
from typing import List

import torch

from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.ops.cache_write import (
    alias_col_write,
    alias_col_write_sub,
)

from ._timing import device_label, time_key, timed_ms

L, B, H, DH, CTX = 32, 32, 20, 64, 128
STEPS = 96
REPS = 3
SEED = 0


def make_cache(dev, l=L, b=B, h=H, dh=DH, ctx=CTX, seed=SEED):
    """The cache [l, 2, b, h, dh, ctx] bf16 and its ctx-on-rows copy
    [l*2*b, ctx, h*dh], from a seeded generator on `dev`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cache = torch.empty((l, 2, b, h, dh, ctx), dtype=torch.bfloat16, device=dev)
    for layer in range(l):  # one layer's f32 draw at a time
        cache[layer] = torch.randn((2, b, h, dh, ctx), generator=gen,
                                   device=dev)
    cache_sub = (cache.permute(0, 1, 2, 5, 3, 4)
                 .reshape(l * 2 * b, ctx, h * dh).contiguous())
    return cache, cache_sub


def steps_fn(name, cache, cache_sub, steps):
    """A callable that runs `steps` dependent steps of variant `name` and
    returns the final acc."""
    l, _, b, h, dh, ctx = cache.shape
    dev = cache.device
    sub = name.endswith("-sub") or "-sub-" in name
    read = name.startswith("read")

    def read_acc(acc):
        if sub:  # [rows, ctx, hd] -> [hd]
            return acc + cache_sub.sum(dim=(0, 1), dtype=torch.float32).to(acc.dtype)
        r = cache[:, 0].sum(dim=-1, dtype=torch.float32).sum(dim=0)
        return acc + r.to(acc.dtype)

    def cols_of(acc):
        if sub:
            return acc[None, :].expand(cache_sub.shape[0], h * dh).contiguous()
        return acc[None, None].expand(l, 2, b, h, dh).contiguous()

    def run():
        acc = torch.zeros((h * dh,) if sub else (b, h, dh),
                          dtype=torch.bfloat16, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        for step in range(steps):
            if read:
                acc = read_acc(acc)
            if "index" in name:
                if sub:
                    cache_sub[:, step % ctx, :] = cols_of(acc)
                else:
                    cache[..., step % ctx] = cols_of(acc)
            elif "k13" in name:
                alias_col_write(cache, cols_of(acc), pos)
            elif "k12" in name:
                alias_col_write_sub(cache_sub, cols_of(acc), pos)
            if not read:  # keep the steps dependent through the cache
                if sub:
                    acc = acc + cache_sub[0, 0]
                else:
                    acc = acc + cache[0, 0, :, :, :, 0]
            pos += 1
            pos %= ctx
        return acc

    return run


VARIANTS = ("read-only", "read+index", "read+k13", "k13-only",
            "read-only-sub", "read+index-sub", "read+k12-sub", "k12-sub-only")


def main(device="cuda", l=L, b=B, h=H, dh=DH, ctx=CTX, steps=STEPS,
         reps=REPS, out=print) -> List[dict]:
    dev = resolve_device(device)
    label = device_label(dev)
    with torch.inference_mode():
        cache, cache_sub = make_cache(dev, l, b, h, dh, ctx)
        gb = cache.numel() * 2 / 1e9
        head = {"cache_gb": gb, "ctx": ctx, "steps": steps, "device": label}
        out(json.dumps(head))
        results = [head]
        for name in VARIANTS:
            ms = timed_ms(steps_fn(name, cache, cache_sub, steps), dev, 1, reps)
            rec = {"variant": name, time_key(dev) + "_per_step": ms / steps,
                   "device": label}
            if dev.type == "cuda":
                rec["eff_read_GBps"] = gb * steps / (ms / 1e3)
            results.append(rec)
            out(json.dumps(rec))
    return results


if __name__ == "__main__":
    main()
