"""Whisper fine-tuning step (port of spittle_tpu/train/step.py).

The encoder, the teacher-forced decoder (models/whisper/model.py:
decoder_forward), the masked cross-entropy and AdamW, on one card or over
a ("data", "model") mesh of parallel/mesh.py. MoE-variant configs
(cfg.moe_experts > 0) train through this step too: the router learns
through the gate probability (Switch semantics), and the objective adds
the Switch load-balancing loss summed over layers, weighted by
moe_aux_weight (Switch Transformer's alpha = 0.01).

On the card the encoder's self-attention and the decoder's at T >= 128
run as K1 with K15, its hand-written backward, as the gradient
(ops/attention.py); the forms without a backward kernel ("q8", "packed",
"pair", "pipe", K/V past 4096) raise under autograd.

The optimizer is torch.optim.AdamW(lr, weight_decay=0.01) with one group
over every leaf, as optax's unmasked adamw: its decoupled decay and its
eps outside the square root are optax's, up to rounding. The step updates
the parameter tensors in place where the reference donates them, and
runs cuDNN's deterministic algorithms (the stem's convolutions), so that
its gradients do not change from run to run.

Under a mesh the forward runs on this rank's shards and calls the
collectives itself (parallel/mesh.py), differentiably: each collective's
backward is its adjoint, so every rank gets the gradient of the sum of all
ranks' objectives with respect to its own tensors. Each rank's objective is
its share of the global loss (its rows' masked NLL over the global mask
sum, plus alpha * aux over the "data" size, all over the "model" size), so
that the shares sum to the reference's loss; a leaf's gradient is then
the sum of its copies' gradients: over "data" for a leaf split over
"model", over the whole mesh for a replicated one. Sequence parallelism
splits the encoder output over "model" along time and gathers it for the
decoder: a placement with no numeric effect, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.io.npz_checkpoint import named_leaves
from spittle_tpu_torch.models.whisper.config import WhisperConfig
from spittle_tpu_torch.models.whisper.model import _encode, decoder_forward
from spittle_tpu_torch.parallel.mesh import (
    LocalParams,
    all_gather_cat,
    local_params,
    local_rows,
    shard_groups,
)

Params = Dict[str, Any]


def _groups(params) -> Tuple[Optional[Any], int, Any]:
    """(the "model" group or None, its size, the mesh or None) of a tree."""
    sh = shard_groups(local_params(params))
    if sh is None:
        return None, 1, None
    return sh.model_group, sh.tp, sh.mesh


class _SumShares(torch.autograd.Function):
    """The global loss from the ranks' shares: forward sums them over the
    groups, backward hands each rank's gradient to its own share (the
    objective is the sum of the shares)."""

    @staticmethod
    def forward(ctx, share, groups):
        total = share.clone()
        for g in groups:
            dist.all_reduce(total, group=g)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _split_time(xa: torch.Tensor, seq_sharding) -> torch.Tensor:
    """Sequence parallelism: this rank's slice of xa [B, T, D] along time
    over seq_sharding's "model" dim, gathered back for the decoder."""
    if seq_sharding is None:
        return xa
    tp = seq_sharding.size(seq_sharding.mesh_dim_names.index("model"))
    if tp == 1:
        return xa
    t = xa.shape[1]
    if t % tp:
        raise ValueError(f"sequence parallelism: T {t} is not divisible by "
                         f"the model dim {tp}")
    r = seq_sharding.get_local_rank("model")
    part = xa.narrow(1, r * (t // tp), t // tp)
    return all_gather_cat(part, seq_sharding.get_group("model"), dim=1)


def cross_entropy_loss(params: Params, mel: torch.Tensor, tokens: torch.Tensor,
                       targets: torch.Tensor, mask: torch.Tensor,
                       cfg: WhisperConfig, seq_sharding=None,
                       remat: bool = False,
                       moe_aux_weight: float = 0.01) -> torch.Tensor:
    """Masked mean next-token NLL of the teacher-forced decoder over the
    encoder's features, + moe_aux_weight * the MoE aux loss for a MoE
    config. mel [B, n_mels, frames], tokens/targets [B, T] (targets the
    next-token labels), mask [B, T] (1 where the label counts; the mean is
    over max(sum(mask), 1)). Log-softmax in f32. remat: recompute the
    encoder's and the decoder's forwards in the backward
    (torch.utils.checkpoint, non-reentrant) instead of keeping their
    activations. seq_sharding: a ("data", "model") mesh whose "model" dim
    splits the encoder output along time (the reference's NamedSharding
    P("data", "model", None)), or None. Under a mesh (a tree from
    shard_params, a batch split over "data"), the global loss on every
    rank; its backward gives each rank the gradient of its share, which
    make_train_step sums over the ranks."""
    params = local_params(params)
    model_group, tp, mesh = _groups(params)
    mel, _, data_group = local_rows(mel)
    tokens, targets, mask = (local_rows(t)[0] for t in (tokens, targets, mask))
    dp = 1 if data_group is None else dist.get_world_size(data_group)
    if mesh is not None and "data" in mesh.mesh_dim_names and data_group is None \
            and mesh.size(mesh.mesh_dim_names.index("data")) > 1:
        raise ValueError("under a mesh with a data dim the batch must be split "
                         "over 'data' (multihost.global_batch_from_local)")

    def enc(p, m):
        return _encode(p, m, cfg, "fullkv", None, data_group=data_group)

    def dec(p, tok, xa):
        return decoder_forward(p, tok, xa, cfg)

    if remat:
        # Only the encoder/decoder boundary is kept; the backward runs each
        # forward again (jax.checkpoint around both in the reference).
        xa, aux = checkpoint(enc, params, mel, use_reentrant=False)
        xa = _split_time(xa, seq_sharding)
        logits = checkpoint(dec, params, tokens, xa, use_reentrant=False)
    else:
        xa, aux = enc(params, mel)
        logits = dec(params, tokens, _split_time(xa, seq_sharding))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = mask.to(torch.float32)
    den = mask.sum()
    groups = [g for g in (data_group, model_group) if g is not None]
    if data_group is not None:
        den = den.clone()
        dist.all_reduce(den, group=data_group)
    share = (nll * mask).sum() / torch.clamp(den, min=1.0)
    if cfg.moe_experts:
        share = share + moe_aux_weight * aux / dp
    if not groups:
        return share
    return _SumShares.apply(share / tp, groups)


class OptState:
    """AdamW's state for one parameter tree: `optimizer`, a
    torch.optim.AdamW over the tree's leaves (a sharded tree's local
    shards), `local`, the tree the forward runs on, and for each leaf the
    groups its gradient is summed over (none on one card)."""

    def __init__(self, optimizer, local, reduce_groups):
        self.optimizer = optimizer
        self.local = local
        self.reduce_groups = reduce_groups

    def leaves(self) -> List[torch.Tensor]:
        return self.optimizer.param_groups[0]["params"]


def _local_leaves(params, dev: torch.device):
    """(the tree the forward runs on, [(leaf, its reduce groups)]): a
    plain tree's own tensors, or a sharded tree's local shards, each of
    which must be the DTensor's own local tensor (every sharded group split
    whole), so that updating it updates the DTensor."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        local = local_params(params)
    model_group, _, mesh = _groups(local)
    data_group = None
    if mesh is not None and "data" in mesh.mesh_dim_names:
        data_group = mesh.get_group("data")
    flat_local = dict(named_leaves(local))
    out = []
    for path, leaf in named_leaves(params):
        loc = flat_local[path]
        if loc.device.type != dev.type:
            raise ValueError(f"{path} lies on {loc.device}, the trainer on {dev}")
        if not loc.is_floating_point():
            raise TypeError(f"{path}: only float leaves train, got {loc.dtype}")
        groups = []
        if isinstance(leaf, DTensor):
            if loc is not leaf._local_tensor:
                raise ValueError(
                    f"{path}: a sharded leaf whose group is not split whole "
                    "(a quantized weight beside it) cannot train")
            split = any(p.is_shard() for p in leaf.placements)
            groups = [g for g in (data_group, None if split else model_group)
                      if g is not None]
        out.append((loc, groups))
    return local, out


def _reduce_grads(state: OptState) -> None:
    """Each leaf's gradient summed over the ranks that hold a copy of it,
    one flat buffer per (groups, dtype)."""
    buckets: dict = {}
    for leaf, groups in zip(state.leaves(), state.reduce_groups):
        if groups and leaf.grad is not None:
            key = (tuple(id(g) for g in groups), leaf.grad.dtype)
            buckets.setdefault(key, (groups, []))[1].append(leaf.grad)
    for groups, grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for g in groups:
            dist.all_reduce(flat, group=g)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _as_tensor(x, dev: torch.device):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(dev)


def make_train_step(cfg: WhisperConfig, learning_rate: float = 1e-5,
                    sequence_parallel_mesh=None, remat: bool = False,
                    moe_aux_weight: float = 0.01, device: str = "cuda"):
    """Returns (init_opt_state, train_step).

    train_step(params, opt_state, batch) -> (params, opt_state, loss),
    batch = dict(mel, tokens, targets, mask) (tensors or numpy arrays;
    under a mesh DTensors split over "data", from
    multihost.global_batch_from_local). params are updated in place and
    returned; loss is the step's loss before the update, detached.
    Passing the mesh as sequence_parallel_mesh also splits the encoder
    output along time over "model". device: the trainer's device, "cuda"
    (the default; raises without a card) or "cpu"; the parameters must
    lie there. init_opt_state(params) marks every leaf as requiring grad
    and returns its OptState."""
    dev = resolve_device(device)

    def init_opt_state(params: Params) -> OptState:
        local, leaves = _local_leaves(params, dev)
        tensors = [t.requires_grad_(True) for t, _ in leaves]
        opt = torch.optim.AdamW(tensors, lr=learning_rate, weight_decay=0.01)
        return OptState(opt, local, [g for _, g in leaves])

    def train_step(params: Params, opt_state: OptState, batch):
        mine = opt_state.local if isinstance(opt_state.local, LocalParams) \
            else params
        if [id(t) for _, t in named_leaves(mine)] != [id(t) for t in opt_state.leaves()]:
            raise ValueError("opt_state was made for another parameter tree")
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            opt_state.optimizer.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(
                mine, *(_as_tensor(batch[k], dev)
                        for k in ("mel", "tokens", "targets", "mask")),
                cfg, sequence_parallel_mesh, remat, moe_aux_weight)
            loss.backward()
            _reduce_grads(opt_state)
            opt_state.optimizer.step()
        finally:
            torch.backends.cudnn.deterministic = det
        return params, opt_state, loss.detach()

    return init_opt_state, train_step
