"""Device mesh and sharding rules over torch.distributed (port of
spittle_tpu/parallel/mesh.py).

A ("data", "model") DeviceMesh: batched windows shard over "data", the
Whisper weights over "model" (tensor parallelism over attention heads and
MLP columns, the vocabulary of the token embedding, and the experts of a
MoE encoder). Placed weights are DTensors, the counterpart of a jax.Array
with a NamedSharding. The JAX package leaves the collectives to GSPMD;
torch has none, so the forward (models/whisper/model.py) calls them itself
on the local shards that local_params hands it:

- column-parallel wq/wk/wv/fc1_w (and cross_*): a rank holds H/tp heads or
  4D/tp columns, and bq/bv/fc1_b alike;
- row-parallel wo/fc2_w/cross_wo: the partial product is summed over
  "model" (all_reduce) before the replicated bias is added;
- the vocab-sharded tok_emb: the lookup is masked and summed, the logits
  gathered;
- the experts of moe_w_in/moe_w_out (parallel/expert_parallel.py).

A group of a block runs sharded only when all its weights are sharded. A
quantized weight is a dict whose children are named qw/qw8/scale, which no
rule names, so it is replicated; its group then runs unsharded on every
rank, with the sharded biases beside it gathered first.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from spittle_tpu_torch.device import resolve_device


class PartitionSpec(tuple):
    """jax.sharding.PartitionSpec's counterpart: one entry per tensor dim,
    the mesh dim it is split over or None."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices=None,
              device: str = "cuda"):
    """("data", "model") DeviceMesh of shape (n / tp, tp) over the first
    n_devices ranks of the process group (or the ranks in `devices`).
    device: "cuda" (default; raises without a card, and unless the group's
    backend is NCCL) or "cpu" (gloo)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not _distributed():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "parallel.multihost.initialize_distributed first")
    backend = str(dist.get_backend()).lower()
    if dev.type == "cuda" and "nccl" not in backend:
        raise RuntimeError(
            f"a CUDA mesh needs the NCCL backend, the group has {backend!r}")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if n_devices is not None:
        ranks = ranks[:n_devices]
    n = len(ranks)
    assert n % tp == 0, (n, tp)
    return DeviceMesh(dev.type, np.asarray(ranks).reshape(n // tp, tp),
                      mesh_dim_names=("data", "model"))


# Sharding rules for the stacked Whisper parameter tree, by the leaf's last
# path name (the reference's _BLOCK_RULES / _TOP_RULES). Leaves not listed
# are replicated.
_BLOCK_RULES: Dict[str, P] = {
    "wq": P(None, None, "model"),
    "wk": P(None, None, "model"),
    "wv": P(None, None, "model"),
    "bq": P(None, "model"),
    "bv": P(None, "model"),
    "wo": P(None, "model", None),
    "fc1_w": P(None, None, "model"),
    "fc1_b": P(None, "model"),
    "fc2_w": P(None, "model", None),
    "cross_wq": P(None, None, "model"),
    "cross_wk": P(None, None, "model"),
    "cross_wv": P(None, None, "model"),
    "cross_bq": P(None, "model"),
    "cross_bv": P(None, "model"),
    "cross_wo": P(None, "model", None),
    # MoE encoder blocks: experts over "model" (expert parallelism); the
    # router is replicated.
    "moe_w_in": P(None, "model", None, None),
    "moe_w_out": P(None, "model", None, None),
}

_TOP_RULES: Dict[str, P] = {
    "tok_emb": P("model", None),  # vocab-sharded; logits gathered
}


def _map_with_name(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def whisper_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """PartitionSpec tree matching a Whisper parameter tree."""
    return _map_with_name(
        lambda name, _: _BLOCK_RULES.get(name, _TOP_RULES.get(name, P())),
        params)


def placements(mesh, spec: P):
    """The DTensor placements (one per mesh dim) of a PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(spec.index(name)) if name in spec else Replicate()
            for name in mesh.mesh_dim_names]


def batch_sharding(mesh):
    """Placements of a batch whose leading dim is split over "data"."""
    return placements(mesh, P("data"))


def shard_leaf(leaf: torch.Tensor, mesh, spec: P):
    """A tensor that every rank holds whole -> the DTensor of `spec`, each
    rank keeping its own slice (no communication: the reference's
    make_array_from_callback). A dim that its mesh dims do not divide is
    refused, as jax.device_put refuses it."""
    from torch.distributed.tensor import DTensor

    local = leaf
    copy = False
    for d, name in enumerate(spec):
        if name is None:
            continue
        copy = copy or d > 0
        size = mesh.size(mesh.mesh_dim_names.index(name))
        if leaf.shape[d] % size:
            raise ValueError(
                f"the sharding {spec!r} over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                f"implies that the global size of dimension {d} should be "
                f"divisible by {size}, but it is equal to {leaf.shape[d]} "
                f"(full shape: {tuple(leaf.shape)})")
        step = leaf.shape[d] // size
        local = local.narrow(d, mesh.get_local_rank(name) * step, step)
    # A slice of a later dim is copied into its own rows; a leaf kept whole
    # or sliced on its first dim keeps its strides (a W8A8 weight's
    # out-major int8 tensor stays out-major).
    local = local.to(mesh.device_type)
    if copy:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False)


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Place a parameter tree (identical on every rank) onto the mesh per
    the sharding rules: a tree of DTensors."""
    specs = whisper_param_specs(params)

    def put(node, spec):
        if isinstance(node, dict):
            return {k: put(v, spec[k]) for k, v in node.items()}
        return shard_leaf(node, mesh, spec)

    return put(params, specs)


# ---------------------------------------------------------------------------
# The local view the forward runs on
# ---------------------------------------------------------------------------

# Groups of a block: (weights, biases). A group is split only when all its
# weights are sharded; otherwise its sharded leaves are gathered.
_GROUPS = {
    "attn": (("wq", "wk", "wv", "wo"), ("bq", "bv")),
    "cross": (("cross_wq", "cross_wk", "cross_wv", "cross_wo"),
              ("cross_bq", "cross_bv")),
    "mlp": (("fc1_w", "fc2_w"), ("fc1_b",)),
    "moe": (("moe_w_in", "moe_w_out"), ()),
}


class ShardGroups:
    """What the forward needs of the mesh: the "model" group, its size
    (tp) and this rank's place in it, and which groups of each block stack
    ("encoder", "decoder") run split over "model"."""

    def __init__(self, mesh, split: Dict[str, FrozenSet[str]], vocab: bool):
        self.mesh = mesh
        self.split = split
        self.vocab = vocab  # tok_emb split over "model"
        names = mesh.mesh_dim_names
        if "model" in names:
            self.model_group = mesh.get_group("model")
            self.tp = mesh.size(names.index("model"))
            self.model_rank = mesh.get_local_rank("model")
        else:
            self.model_group, self.tp, self.model_rank = None, 1, 0

    def splits(self, stack: str, group: str) -> bool:
        return group in self.split.get(stack, ())

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over "model" (the row-parallel products' partials): in
        place, or under autograd differentiable (all_reduce_sum)."""
        return all_reduce_sum(x, self.model_group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """x's "model" shards concatenated along `dim` in rank order."""
        return all_gather_cat(x, self.model_group, dim)


# Collectives the forward calls: autograd Functions whose backward is each
# collective's adjoint (all_reduce's an all_reduce of the gradients,
# all_gather's a sum over the ranks of each rank's slice), as
# torch.distributed.nn.functional's are; outside autograd all_reduce_sum
# works in place on plain tensors and saves its clone; that module's all_gather backward
# scatters from global ranks and fails on a gloo subgroup, so both are
# written here. Every rank then gets the gradient of the SUM of all ranks'
# objectives with respect to its own tensors, which train/step.py turns
# into the global function's gradient (each rank's objective is its share,
# and a leaf's gradient is summed over the ranks that hold a copy of it).


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        total = _AllReduceSum.apply(grad, ctx.group)
        return total.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` (x itself when group is None)."""
    if group is None:
        return x
    if _differentiable(x):
        return _AllReduceSum.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """x of every rank of `group` concatenated along `dim` in rank order."""
    if group is None:
        return x
    return _AllGatherCat.apply(x, group, dim % x.dim())


class LocalParams(dict):
    """A sharded tree's local shards as plain tensors (what the
    hand-written kernels take), carrying its ShardGroups."""

    shards: ShardGroups


def _leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _is_split(leaf) -> bool:
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(leaf, DTensor) and any(
        isinstance(p, Shard) for p in leaf.placements)


def _local(node, gather: bool = False):
    """DTensor leaves -> local tensors; gather=True: sharded leaves whole."""
    from torch.distributed.tensor import DTensor

    if isinstance(node, dict):
        return {k: _local(v, gather) for k, v in node.items()}
    if isinstance(node, DTensor):
        return node.full_tensor() if gather and _is_split(node) else node.to_local()
    return node


def _local_blocks(blocks: Dict[str, Any], split: set) -> Dict[str, Any]:
    out = {}
    grouped = set()
    for gname, (weights, biases) in _GROUPS.items():
        present = [w for w in weights if w in blocks]
        if not present:
            continue
        whole = all(_is_split(blocks[w]) for w in present)
        if whole:
            split.add(gname)
        for key in present + [b for b in biases if b in blocks]:
            out[key] = _local(blocks[key], gather=not whole)
            grouped.add(key)
    for key, leaf in blocks.items():
        if key not in grouped:
            out[key] = _local(leaf, gather=True)
    return {k: out[k] for k in blocks}


def local_params(tree):
    """The tree the forward runs on: itself when it holds no DTensor (or
    is already local), else a LocalParams of its local shards, each block
    group either wholly split or gathered whole (module docstring)."""
    if isinstance(tree, LocalParams) or not _distributed():
        return tree
    from torch.distributed.tensor import DTensor

    first = next((x for x in _leaves(tree) if isinstance(x, DTensor)), None)
    if first is None:
        return tree
    split: Dict[str, FrozenSet[str]] = {}
    out = LocalParams()
    vocab = False
    for stack, sub in tree.items():
        if not isinstance(sub, dict):
            out[stack] = _local(sub, gather=True)
            continue
        node = {}
        for key, leaf in sub.items():
            if key == "blocks":
                groups: set = set()
                node[key] = _local_blocks(leaf, groups)
                split[stack] = frozenset(groups)
            elif key == "tok_emb":
                vocab = _is_split(leaf)
                node[key] = _local(leaf)
            else:
                node[key] = _local(leaf, gather=True)
        out[stack] = node
    out.shards = ShardGroups(first.device_mesh, split, vocab)
    return out


def shard_groups(params) -> Optional[ShardGroups]:
    """The ShardGroups of a local_params tree (None for a plain tree)."""
    return getattr(params, "shards", None)


def local_rows(x):
    """A batch that may be a DTensor -> (local rows, its DTensor spec or
    None, the "data" group when the rows are split over "data")."""
    if not _distributed():
        return x, None, None
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x, None, None
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    group = None
    if "data" in names:
        p = x.placements[names.index("data")]
        if isinstance(p, Shard) and p.dim == 0:
            group = mesh.get_group("data")
    return x.to_local(), (mesh, tuple(x.placements)), group


def like_rows(local: torch.Tensor, spec):
    """local rows back into the DTensor spec local_rows returned (local
    itself when the spec is None)."""
    if spec is None:
        return local
    from torch.distributed.tensor import DTensor

    mesh, place = spec
    return DTensor.from_local(local, mesh, list(place), run_check=False)
