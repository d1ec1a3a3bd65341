"""The mesh layer's dry run: dp, tp, pp, ep, sharded serving and the train
step over a torch.distributed process group (the counterpart of the
reference's __graft_entry__.py:dryrun_multichip and
scripts/dryrun_multihost.py).

Each task is a function that every rank of the group runs:

- dp_tp: a ("data", "model") mesh; shard_params, then encode,
  greedy_decode and beam_decode on this rank's rows (and greedy on a
  weight-only int8 decoder) against the unsharded run;
- moe: moe_ffn under dp x ep (with drops) against the single-device call,
  and the MoE Whisper encoder with its encoder subtree sharded;
- pp: pipeline_apply over the encoder's blocks, over every rank and over
  stages of 2, against the sequential loop, bit for bit;
- serving: BatchingTranscriptionServer(mesh=) on rank 0 over a data-only
  mesh, follow() on the others, against mesh=None;
- multihost: global_batch_from_local, replicated_to_host and the
  refusal of a vocab that the model dim does not divide;
- train: one make_train_step step (remat, sequence parallelism at tp > 1)
  under a ("data", "model") mesh against the unsharded step.
- checkpoint: save_checkpoint / restore_checkpoint of the sharded tree
  and its AdamW state between train steps, against unbroken steps, bit
  for bit, and a save interrupted after its write.

Rank 0 writes each task's results under --out (<task>.npz / .json);
--inputs may hold the weights and inputs to use (the tests write the
reference's there), else each task makes its own from a seed. Run by hand:

    python -m spittle_tpu_torch.parallel.dryrun --spawn 4 --device cpu \\
        --out /tmp/dryrun

(--spawn N starts N ranks of this module with gloo on 127.0.0.1; on cards,
--device cuda, one rank per card). Importing this module starts no process
group.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

# Small Whisper layouts of the reference's dry run: a real vocabulary size
# (the special tokens derive from it) that splits evenly over tp 2.
DRYRUN_CFG = dict(name="dryrun", n_mels=80, n_audio_ctx=32, n_audio_state=64,
                  n_audio_head=4, n_audio_layer=2, n_vocab=51866,
                  n_text_ctx=16, n_text_state=64, n_text_head=4,
                  n_text_layer=2)


def save_tree(path: str, tree: Dict) -> None:
    """A nested dict of arrays -> an .npz with "a/b/c" keys."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path: str) -> Dict:
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


class _Run:
    """One rank's context: its device, the inputs and the output dir."""

    def __init__(self, rank, world, device, inputs, out):
        self.rank, self.world = rank, world
        self.device = torch.device(
            f"cuda:{torch.cuda.current_device()}" if device == "cuda" else "cpu")
        self.dev_type = device
        self.inputs, self.out = inputs, out

    def input(self, name):
        path = os.path.join(self.inputs, name) if self.inputs else ""
        return path if path and os.path.exists(path) else None

    def save(self, name, **arrays):
        if self.rank == 0:
            np.savez(os.path.join(self.out, name + ".npz"),
                     **{k: np.asarray(v) for k, v in arrays.items()})

    def save_json(self, name, obj):
        with open(os.path.join(self.out, name + ".json"), "w") as f:
            json.dump(obj, f)

    def say(self, line):
        if self.rank == 0:
            print(f"dryrun: {line}", flush=True)


def _cfg(**over):
    from spittle_tpu_torch.models.whisper.config import WhisperConfig

    return WhisperConfig(**{**DRYRUN_CFG, **over})


def _params(run, name, cfg, seed):
    from spittle_tpu_torch.models.whisper.weights import (
        params_from_jax,
        random_params,
    )

    path = run.input(name)
    if path:
        return params_from_jax(load_tree(path), device=run.device)
    return random_params(cfg, seed=seed, device=run.device)


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _rows(run, mesh, b):
    m = mesh.size(0)
    r = mesh.get_local_rank("data")
    return slice(r * b // m, (r + 1) * b // m)


def task_dp_tp(run):
    """dp + tp encode and greedy decode over make_mesh(world, tp=2)."""
    from spittle_tpu_torch.models.whisper.beam import beam_decode
    from spittle_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
    from spittle_tpu_torch.models.whisper.model import encode
    from spittle_tpu_torch.ops.quant import quantize_whisper_decoder

    from .mesh import make_mesh, shard_params
    from .multihost import global_batch_from_local

    tp = 2 if run.world % 2 == 0 else 1
    mesh = make_mesh(run.world, tp=tp, device=run.dev_type)
    cfg = _cfg()
    full = _params(run, "dp_tp_params.npz", cfg, 0)
    path = run.input("dp_tp_mel.npy")
    b = max(run.world // tp, 1) * 2
    mel = (np.load(path) if path else np.random.default_rng(2).standard_normal(
        (b, cfg.n_mels, cfg.n_audio_ctx * 2)).astype(np.float32))
    b = mel.shape[0]
    opts = DecodeOptions(timestamps=False, max_tokens=8)
    sharded = shard_params(full, mesh)
    shapes = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                shapes[prefix + k] = list(v.to_local().shape)

    walk(sharded, "")
    run.save_json(f"dp_tp_shapes_{run.rank}", shapes)
    with torch.inference_mode():
        mel_t = torch.from_numpy(mel).to(run.device)
        xa = encode(sharded, global_batch_from_local(
            mel_t[_rows(run, mesh, b)], mesh), cfg)
        out = greedy_decode(sharded, xa.to_local(), cfg, opts)
        data = mesh.get_group("data")
        tokens = _gather_rows(out["tokens"], data)
        xa_all = _gather_rows(xa.to_local(), data)
        xa_ref = encode(full, mel_t, cfg)
        ref = greedy_decode(full, xa_ref, cfg, opts)
        # Beam search through the same sharded functions, and a
        # weight-only int8 decoder, whose quantized (so replicated) weights
        # run unsharded beside their gathered biases.
        rows = _rows(run, mesh, b)
        beams = _gather_rows(beam_decode(sharded, xa.to_local(), cfg, opts,
                                         beam_size=3)["tokens"], data)
        beams_ref = beam_decode(full, xa_ref, cfg, opts, beam_size=3)["tokens"]
        q8 = quantize_whisper_decoder(full)
        q8_tokens = _gather_rows(greedy_decode(shard_params(q8, mesh),
                                               xa_ref[rows], cfg, opts)["tokens"],
                                 data)
        q8_ref = greedy_decode(q8, xa_ref, cfg, opts)["tokens"]
    same = bool(torch.equal(tokens, ref["tokens"]) and torch.equal(beams, beams_ref)
                and torch.equal(q8_tokens, q8_ref))
    err = float((xa_all - xa_ref).abs().max())
    run.save("dp_tp", tokens=tokens.cpu(), tokens_ref=ref["tokens"].cpu(),
             xa=xa_all.cpu(), xa_ref=xa_ref.cpu(), beams=beams.cpu(),
             beams_ref=beams_ref.cpu(), q8=q8_tokens.cpu(), q8_ref=q8_ref.cpu())
    run.say(f"dp+tp encode, greedy and beam decode, int8 decoder (batch {b} over dp "
            f"{run.world // tp}, tp {tp}): tokens equal to the unsharded "
            f"run: {same}, max |xa - unsharded| {err:.2e}")
    assert same, "sharded tokens differ from the unsharded run"


def task_moe(run):
    """moe_ffn under dp x ep, and the MoE Whisper encoder sharded."""
    from spittle_tpu_torch.models.whisper.model import encode

    from .expert_parallel import init_moe_params, moe_ffn, shard_moe_params
    from .mesh import make_mesh, shard_params
    from .multihost import global_batch_from_local

    tp = 2 if run.world % 2 == 0 else 1
    mesh = make_mesh(run.world, tp=tp, device=run.dev_type)
    path = run.input("moe_params.npz")
    if path:
        p = {k: torch.from_numpy(v).to(run.device)
             for k, v in load_tree(path).items()}
    else:
        p = init_moe_params(32, 64, max(2 * tp, 2), seed=3, device=run.device)
    path = run.input("moe_x.npy")
    x = (np.load(path) if path else np.random.default_rng(4).standard_normal(
        (max(run.world // tp, 1) * 2 * 8, 32)).astype(np.float32))
    xt = torch.from_numpy(x).to(run.device)
    res = {}
    placed = shard_moe_params(p, mesh)
    for cf in (1.25, 2.0):
        out, aux = moe_ffn(placed, global_batch_from_local(
            xt[_rows(run, mesh, x.shape[0])], mesh), capacity_factor=cf)
        ref, ref_aux = moe_ffn(p, xt, capacity_factor=cf)
        tag = str(cf).replace(".", "_")
        res.update({f"out_{tag}": out.full_tensor().cpu(),
                    f"ref_{tag}": ref.cpu(),
                    **{f"{k}_{tag}": v.cpu() for k, v in aux.items()},
                    **{f"ref_{k}_{tag}": v.cpu() for k, v in ref_aux.items()}})
        run.say(f"ep MoE over {p['w_in'].shape[0]} experts, capacity factor "
                f"{cf}: aux_loss {float(aux['aux_loss']):.4f}, dropped "
                f"{float(aux['dropped']):g} (single device "
                f"{float(ref_aux['dropped']):g})")
    cfg = _cfg(name="tiny-moe", n_audio_ctx=1500, n_audio_state=384,
               n_audio_head=6, n_audio_layer=4, n_vocab=51865,
               n_text_ctx=448, n_text_state=384, n_text_head=6, n_text_layer=4,
               moe_experts=max(tp * 2, 2))
    full = _params(run, "moe_enc_params.npz", cfg, 5)
    path = run.input("moe_mel.npy")
    b = max(run.world // tp, 1) * 2
    mel = (np.load(path) if path else np.random.default_rng(6).standard_normal(
        (b, cfg.n_mels, 96)).astype(np.float32))
    mel_t = torch.from_numpy(mel).to(run.device)
    enc = {"encoder": shard_params(full["encoder"], mesh)}
    with torch.inference_mode():
        xa = encode(enc, global_batch_from_local(
            mel_t[_rows(run, mesh, mel.shape[0])], mesh), cfg)
        xa_all = _gather_rows(xa.to_local(), mesh.get_group("data"))
        xa_ref = encode({"encoder": full["encoder"]}, mel_t, cfg)
    res.update(xa=xa_all.cpu(), xa_ref=xa_ref.cpu())
    run.save("moe", **res)
    run.say(f"ep Whisper-MoE encoder (experts {cfg.moe_experts}): max "
            f"|xa - unsharded| {float((xa_all - xa_ref).abs().max()):.2e}")


def task_pp(run):
    """pipeline_apply over the encoder's blocks: every rank one stage, and
    stages of 2 (a (world / 2, 2) mesh), each against the sequential loop
    on each microbatch, bit for bit."""
    from torch.distributed.device_mesh import DeviceMesh

    from spittle_tpu_torch.models.whisper.model import (
        encoder_block_body,
        layer_params,
        n_layers,
    )
    from spittle_tpu_torch.models.whisper.weights import random_params

    from .mesh import P, shard_leaf
    from .pipeline_parallel import pipeline_apply, stack_to_stages

    res = {}
    for s in sorted({run.world, 2}):
        shape = (run.world // s, s)
        mesh = DeviceMesh(run.dev_type, np.arange(run.world).reshape(shape),
                          mesh_dim_names=("data", "stage"))
        cfg = _cfg(name="pp-dryrun", n_audio_layer=2 * s)
        blocks = random_params(cfg, seed=5, device=run.device)["encoder"]["blocks"]
        m, mb = s + 2, 2
        xmb = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (m, mb, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32)
        ).to(run.device)

        def block_fn(stage_blocks, x):
            for layer in range(n_layers(stage_blocks)):
                x = encoder_block_body(x, layer_params(stage_blocks, layer),
                                       cfg.n_audio_head)
            return x

        def place(node):
            if isinstance(node, dict):
                return {k: place(v) for k, v in node.items()}
            return shard_leaf(node, mesh, P("stage"))

        with torch.inference_mode():
            staged = place(stack_to_stages(blocks, s))
            out = pipeline_apply(mesh, "stage", block_fn, staged, xmb)
            ref = torch.stack([block_fn(blocks, xmb[i]) for i in range(m)])
        equal = bool(torch.equal(out, ref))
        res[f"equal_{s}"] = equal
        res[f"err_{s}"] = float((out - ref).abs().max())
        run.say(f"pp over {s} stages of the whisper encoder ({2 * s} "
                f"layers, {m} microbatches): bit-equal to the sequential "
                f"loop: {equal}")
        assert equal, f"pipeline over {s} stages differs from the sequential loop"
    if run.rank == 0:
        run.save_json("pp", res)


def task_serving(run):
    """BatchingTranscriptionServer(mesh=) over a data-only mesh on rank 0,
    follow() on the others; then mesh=None on rank 0 alone."""
    from torch.distributed.device_mesh import DeviceMesh

    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    from .serving import BatchingTranscriptionServer, follow

    mesh = DeviceMesh(run.dev_type, np.arange(run.world),
                      mesh_dim_names=("data",))
    eng = WhisperEngine(device=run.device)
    ckpt = run.input("serving_ckpt.txt")
    if ckpt:
        with open(ckpt) as f:
            eng.load_model(f.read().strip())
    else:
        from spittle_tpu_torch.models.whisper.config import CONFIGS

        CONFIGS.setdefault("dryrun-serve", _cfg(name="dryrun-serve",
                                                n_audio_ctx=1500, n_audio_layer=1,
                                                n_text_layer=1))
        eng.load_model("random:dryrun-serve")
    path = run.input("serving_audio.npy")
    audio = (np.load(path) if path else
             np.zeros((run.world, 16000), np.float32))
    rounds = [TranscribeParams(language=lang, parallel_windows=True,
                               condition_on_previous_text=False, max_tokens=24,
                               temperatures=(0.0,))
              for lang in ("en", None)]
    got = {}
    if run.rank == 0:
        srv = BatchingTranscriptionServer(eng, max_batch=run.world,
                                          max_wait_ms=200.0, mesh=mesh,
                                          overlap_transfers=True)
        try:
            for ri, p in enumerate(rounds):
                futs = [srv.submit(a, p) for a in audio]
                got[f"mesh_{ri}"] = [f.result(timeout=600) for f in futs]
            sizes, ladder = list(srv.batch_sizes), srv._ladder_sizes()
        finally:
            srv.shutdown()
        eng.mesh = None
        srv = BatchingTranscriptionServer(eng, max_batch=run.world,
                                          max_wait_ms=200.0)
        try:
            for ri, p in enumerate(rounds):
                futs = [srv.submit(a, p) for a in audio]
                got[f"plain_{ri}"] = [f.result(timeout=600) for f in futs]
        finally:
            srv.shutdown()
        run.save_json("serving", {
            "tokens": {k: [r.tokens for r in v] for k, v in got.items()},
            "text": {k: [r.text for r in v] for k, v in got.items()},
            "language": {k: [r.language for r in v] for k, v in got.items()},
            "batch_sizes": sizes, "ladder": ladder})
        same = all(got[f"mesh_{i}"][j].tokens == got[f"plain_{i}"][j].tokens
                   for i in range(len(rounds)) for j in range(len(audio)))
        run.say(f"sharded serving (batch {len(audio)} split over data "
                f"{run.world}, batch sizes {sizes}): tokens equal to "
                f"mesh=None: {same}")
        assert same, "served tokens under the mesh differ from mesh=None"
    else:
        follow(eng, mesh)


def task_multihost(run):
    """global_batch_from_local over the data dim, replicated_to_host, and
    the refusal of a dim that its mesh dims do not divide."""
    from torch.distributed.tensor import DTensor, Replicate

    from .mesh import make_mesh, shard_params
    from .multihost import (
        global_batch_from_local,
        mesh_is_multiprocess,
        replicated_to_host,
    )

    tp = 2 if run.world % 2 == 0 else 1
    mesh = make_mesh(run.world, tp=tp, device=run.dev_type)
    d = mesh.get_local_rank("data")
    local = torch.full((2, 3), float(d), device=run.device)
    batch = global_batch_from_local(local, mesh)
    full = batch.full_tensor().cpu()
    refused = False
    try:
        replicated_to_host(batch)
    except ValueError:
        refused = True
    rep = DTensor.from_local(torch.ones(1, device=run.device), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    host = replicated_to_host(rep)
    uneven = {}
    for n_vocab, t in ((51865, 2), (51866, 2), (51866, 4), (51864, 4)):
        if run.world % t:
            continue
        m = make_mesh(run.world, tp=t, device=run.dev_type)
        try:
            shard_params({"decoder": {"tok_emb": torch.zeros(
                (n_vocab, 8), device=run.device)}}, m)
            uneven[f"{n_vocab}@{t}"] = "ok"
        except ValueError as e:
            uneven[f"{n_vocab}@{t}"] = str(e)
    if run.rank == 0:
        run.save_json("multihost", {
            "global_batch": full.tolist(), "multiprocess": mesh_is_multiprocess(mesh),
            "sharded_refused": refused, "replicated": host.tolist(),
            "uneven": uneven})
    run.say(f"multi-process batch assembly OK (global batch "
            f"{tuple(full.shape)} from {run.world} ranks); sharded read "
            f"refused: {refused}")


def task_train(run):
    """One train step of make_train_step under make_mesh(world, tp=2),
    with sequence parallelism over "model" and remat (the counterpart of
    scripts/dryrun_multihost.py's train step), against the same step on
    the unsharded tree: the loss, the gradients and the updated
    parameters."""
    from spittle_tpu_torch.io.npz_checkpoint import named_leaves
    from spittle_tpu_torch.train import make_train_step

    from .mesh import make_mesh, shard_params
    from .multihost import global_batch_from_local

    tp = 2 if run.world % 2 == 0 else 1
    mesh = make_mesh(run.world, tp=tp, device=run.dev_type)
    cfg = _cfg()
    full = _params(run, "dp_tp_params.npz", cfg, 0)
    batch = _train_batch(run, cfg, tp)
    b = batch["mel"].shape[0]
    lr = 1e-3
    ref_tree = _params(run, "dp_tp_params.npz", cfg, 0)  # its own storage
    init, step = make_train_step(cfg, learning_rate=lr, remat=True,
                                 device=run.dev_type)
    _, _, ref_loss = step(ref_tree, init(ref_tree), batch)
    sharded = shard_params(full, mesh)
    init, step = make_train_step(
        cfg, learning_rate=lr, remat=True, device=run.dev_type,
        sequence_parallel_mesh=mesh if tp > 1 else None)
    rows = _rows(run, mesh, b)
    local = {k: global_batch_from_local(torch.from_numpy(np.asarray(v)[rows]), mesh)
             for k, v in batch.items()}
    _, _, loss = step(sharded, init(sharded), local)
    res = {"loss": float(loss), "loss_ref": float(ref_loss)}
    with torch.no_grad():
        _gather_train(res, sharded, ref_tree, mesh)
    run.save("train", **res)
    err = max(float((res["param/" + n] - res["param_ref/" + n]).abs().max())
              for n, _ in named_leaves(ref_tree))
    run.say(f"train step under dp {run.world // tp} x tp {tp} (sequence "
            f"parallel, remat): loss {res['loss']:.6f}, unsharded "
            f"{res['loss_ref']:.6f}, max |params - unsharded| {err:.2e}")
    assert abs(res["loss"] - res["loss_ref"]) <= 1e-5 * abs(res["loss_ref"])
    assert err <= 2 * lr + 1e-6


def _train_batch(run, cfg, tp):
    """The train tasks' batch: the input's, else seeded rows, 2 per data
    rank."""
    path = run.input("train_batch.npz")
    if path:
        return dict(np.load(path))
    b = max(run.world // tp, 1) * 2
    rng = np.random.default_rng(7)
    return dict(
        mel=rng.standard_normal((b, cfg.n_mels, cfg.n_audio_ctx * 2)).astype(np.float32),
        tokens=rng.integers(0, cfg.n_vocab, (b, cfg.n_text_ctx)),
        targets=rng.integers(0, cfg.n_vocab, (b, cfg.n_text_ctx)),
        mask=np.ones((b, cfg.n_text_ctx), np.float32))


class _Interrupted(Exception):
    pass


def task_checkpoint(run):
    """Checkpoints of a sharded tree under make_mesh(world, tp=2), with
    sequence parallelism: 2 train steps, save_checkpoint, a second save
    interrupted after its write (it must leave no step_3), then
    restore_checkpoint into a freshly sharded tree of zeros and its fresh
    AdamW state and 2 more steps, against 4 unbroken steps: every loss,
    parameter and AdamW moment bit-equal."""
    from spittle_tpu_torch.io.npz_checkpoint import named_leaves
    from spittle_tpu_torch.train import checkpoint as ckpt
    from spittle_tpu_torch.train import make_train_step

    from .mesh import make_mesh, shard_params
    from .multihost import global_batch_from_local

    tp = 2 if run.world % 2 == 0 else 1
    mesh = make_mesh(run.world, tp=tp, device=run.dev_type)
    cfg = _cfg()
    batch = _train_batch(run, cfg, tp)
    rows = _rows(run, mesh, batch["mel"].shape[0])
    local = {k: global_batch_from_local(torch.from_numpy(np.asarray(v)[rows]), mesh)
             for k, v in batch.items()}
    init, step = make_train_step(cfg, learning_rate=1e-3, device=run.dev_type,
                                 sequence_parallel_mesh=mesh if tp > 1 else None)

    def sharded(zeros=False):
        tree = _params(run, "dp_tp_params.npz", cfg, 0)
        if zeros:
            tree = _map(torch.zeros_like, tree)
        return shard_params(tree, mesh)

    unbroken = sharded()
    st = init(unbroken)
    want = [float(step(unbroken, st, local)[2]) for _ in range(4)]

    first = sharded()
    st1 = init(first)
    got = [float(step(first, st1, local)[2]) for _ in range(2)]
    directory = os.path.join(run.out, "checkpoint")
    t0 = time.perf_counter()
    ckpt.save_checkpoint(directory, first, st1, 2)
    save_s = time.perf_counter() - t0
    publish = ckpt._publish

    def interrupted(tmp, final):
        raise _Interrupted("interrupted after the write")
    ckpt._publish = interrupted
    try:
        ckpt.save_checkpoint(directory, first, st1, 3)
        raised = None
    except (_Interrupted, RuntimeError) as e:
        raised = type(e).__name__
    finally:
        ckpt._publish = publish
    dist.barrier()
    left = sorted(os.listdir(directory))
    del first, st1

    fresh = sharded(zeros=True)
    st2 = init(fresh)
    t0 = time.perf_counter()
    _, _, n = ckpt.restore_checkpoint(directory, (fresh, st2))
    restore_s = time.perf_counter() - t0
    got += [float(step(fresh, st2, local)[2]) for _ in range(2)]

    same = [torch.equal(a.to_local(), b.to_local()) for (_, a), (_, b) in
            zip(named_leaves(fresh), named_leaves(unbroken))]
    for a, b in zip(st2.leaves(), st.leaves()):
        sa, sb = st2.optimizer.state[a], st.optimizer.state[b]
        same.append(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa))
    flag = torch.tensor([int(all(same))])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(directory) for f in files)
    run.save("checkpoint", losses=np.array(got), losses_ref=np.array(want),
             step=n, equal=int(flag), left=np.array(left), raised=str(raised))
    run.say(f"checkpoint under dp {run.world // tp} x tp {tp}: save {save_s:.3f} s, "
            f"restore {restore_s:.3f} s, {nbytes} bytes; resumed losses {got} vs "
            f"unbroken {want}; parameters and moments bit-equal: {bool(flag)}; "
            f"after an interrupted save: {left}")
    assert got == want and n == 2 and bool(flag), (got, want, n)
    assert left == ["step_2"] and raised is not None, (left, raised)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _gather_train(res, sharded, ref_tree, mesh):
    """The sharded tree's parameters and gradients gathered whole (every
    rank takes part), beside the unsharded tree's, into res."""
    from torch.distributed.tensor import DTensor

    from spittle_tpu_torch.io.npz_checkpoint import named_leaves

    for name, leaf in named_leaves(sharded):  # every leaf is a DTensor
        res["param/" + name] = leaf.full_tensor().cpu()
        res["grad/" + name] = DTensor.from_local(
            leaf._local_tensor.grad, mesh, leaf.placements,
            run_check=False).full_tensor().cpu()
    for name, leaf in named_leaves(ref_tree):
        res["param_ref/" + name] = leaf.detach().cpu()
        res["grad_ref/" + name] = leaf.grad.cpu()


TASKS = {"dp_tp": task_dp_tp, "moe": task_moe, "pp": task_pp,
         "serving": task_serving, "multihost": task_multihost,
         "train": task_train, "checkpoint": task_checkpoint}


def worker(rank: int, world: int, coordinator: str, device: str, tasks,
           inputs: str, out: str) -> None:
    from .multihost import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(coordinator, world, rank, device=device)
    try:
        run = _Run(rank, world, device, inputs, out)
        for name in tasks:
            TASKS[name](run)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n: int, device: str, tasks, inputs: str, out: str,
          timeout: float = 600.0) -> str:
    """Start n ranks of this module (gloo or NCCL on 127.0.0.1), wait for
    them and return rank 0's output; raises if a rank fails."""
    coordinator = f"127.0.0.1:{_free_port()}"
    os.makedirs(out, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spittle_tpu_torch.parallel.dryrun",
         "--rank", str(r), "--world", str(n), "--coordinator", coordinator,
         "--device", device, "--tasks", ",".join(tasks), "--inputs", inputs or "",
         "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=timeout)
            outs.append(text)
            if p.returncode:
                raise RuntimeError(f"dry-run rank {r} failed:\n{text}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks on this host")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tasks", default=",".join(TASKS))
    ap.add_argument("--inputs", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    tasks = [t for t in args.tasks.split(",") if t]
    if args.spawn:
        print(spawn(args.spawn, args.device, tasks, args.inputs, args.out),
              end="")
        return 0
    worker(args.rank, args.world, args.coordinator, args.device, tasks,
           args.inputs, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
