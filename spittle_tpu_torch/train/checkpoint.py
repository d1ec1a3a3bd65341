"""Checkpoint and resume of fine-tuning state (port of
spittle_tpu/train/checkpoint.py): (params, optimizer state, step) under
<path>/step_<n>/, written into a temporary directory beside it and renamed
into place, so that an interrupted save leaves no partial step_<n> and a
resumed run equals an unbroken one. The reference writes any tree with
orbax, which the port does not use:

- a plain tree goes through torch.save into one file, state.pt;
- a sharded tree (DTensor leaves, parallel/mesh.py:shard_params) goes
  through torch.distributed.checkpoint, every rank writing its own shards:
  the parameters as they are, and AdamW's moments of each leaf as DTensors
  of that leaf's placements. Every rank of the mesh calls save and
  restore; rank 0 renames the directory once all have written.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import torch

from spittle_tpu_torch.io.npz_checkpoint import named_leaves

_STATE = "state.pt"
_DCP_METADATA = ".metadata"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(tree) -> bool:
    return any(_is_dtensor(leaf) for _, leaf in named_leaves(tree))


def _tensors(tree):
    """The tree with every leaf detached."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return tree.detach()


def _publish(tmp: str, final: str) -> None:
    """Put the written directory in place of step_<n>."""
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def save_checkpoint(path: str, params: Any, opt_state: Any, step: int) -> None:
    """Write (params, the AdamW state of opt_state, an OptState, step) as
    <path>/step_<step>, replacing one that exists. With a sharded tree
    every rank of its process group must call it."""
    path = os.path.abspath(path)
    final = os.path.join(path, f"step_{step}")
    if _sharded(params):
        _save_sharded(path, final, params, opt_state, step)
        return
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    try:
        torch.save({"params": _tensors(params),
                    "opt_state": opt_state.optimizer.state_dict(), "step": step},
                   os.path.join(tmp, _STATE))
        _publish(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint keys {sorted(src)} differ from "
                             f"{sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k])
        return
    if dst.shape != src.shape:
        raise ValueError(f"checkpoint leaf {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def restore_checkpoint(path: str, like: Any) -> Optional[Tuple[Any, Any, int]]:
    """Restore the latest checkpoint into `like` = (params, opt_state) of
    the same structure (freshly initialized state, say): the parameters
    are copied into like[0]'s tensors in place (a sharded tree's local
    shards) and the optimizer state loaded into like[1]. Returns (params,
    opt_state, step), or None when nothing is saved. With a sharded tree
    every rank of its process group must call it."""
    step = latest_step(path)
    if step is None:
        return None
    directory = os.path.join(os.path.abspath(path), f"step_{step}")
    params, opt_state = like
    sharded = _sharded(params)
    if sharded != os.path.exists(os.path.join(directory, _DCP_METADATA)):
        raise ValueError(f"{directory} holds a {'plain' if sharded else 'sharded'} "
                         f"tree; `like` is {'sharded' if sharded else 'plain'}")
    if sharded:
        return params, opt_state, _restore_sharded(directory, params, opt_state)
    state = torch.load(os.path.join(directory, _STATE), map_location="cpu",
                       weights_only=True)
    with torch.no_grad():
        _copy_into(params, state["params"])
    opt_state.optimizer.load_state_dict(state["opt_state"])
    return params, opt_state, state["step"]


# -- sharded trees -------------------------------------------------------------


def _paired(params, opt_state):
    """[(path, leaf, the optimizer's tensor of it)]: the optimizer holds
    the leaves' local tensors in the tree's order (train/step.py)."""
    leaves = list(named_leaves(params))
    local = opt_state.optimizer.param_groups[0]["params"]
    if len(leaves) != len(local):
        raise ValueError("opt_state was made for another parameter tree")
    return [(name, leaf, t) for (name, leaf), t in zip(leaves, local)]


def _like_leaf(leaf, local: torch.Tensor):
    """A per-leaf optimizer tensor as the checkpoint holds it: a DTensor of
    the leaf's placements where the leaf is one, else the tensor."""
    from torch.distributed.tensor import DTensor

    if _is_dtensor(leaf) and local.shape == leaf._local_tensor.shape:
        return DTensor.from_local(local, leaf.device_mesh, leaf.placements,
                                  run_check=False)
    return local


def _save_sharded(path: str, final: str, params, opt_state, step: int) -> None:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    opt = opt_state.optimizer
    # The param groups as one tuple: torch.distributed.checkpoint keeps a
    # tuple whole (it would split a list of dicts into its entries).
    state = {"params": dict(named_leaves(params)), "optim": {},
             "param_groups": tuple(opt.state_dict()["param_groups"]), "step": step}
    for name, leaf, local in _paired(params, opt_state):
        for key, value in opt.state.get(local, {}).items():
            if torch.is_tensor(value):
                value = _like_leaf(leaf, value.detach())
            state["optim"][f"{name}/{key}"] = value
    rank = dist.get_rank()
    # One temporary name for every rank: rank 0 clears what an earlier,
    # interrupted save left there before anyone writes.
    tmp = os.path.join(path, f".step_{step}.partial")
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    dist.barrier()
    try:
        # save returns on each rank once rank 0 has written the metadata,
        # after every rank's shards.
        dcp.save(state, checkpoint_id=tmp)
        failed = None
        if rank == 0:
            try:
                _publish(tmp, final)
            except BaseException as e:  # every rank raises, none waits
                failed = e
        outcome = [None if failed is None else repr(failed)]
        dist.broadcast_object_list(outcome, src=0)
        if failed is not None:
            raise failed
        if outcome[0] is not None:
            raise RuntimeError(f"rank 0 could not put {final} in place: {outcome[0]}")
    except BaseException:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise


def _restore_sharded(directory: str, params, opt_state) -> int:
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(directory).read_metadata().state_dict_metadata
    opt = opt_state.optimizer
    pairs = _paired(params, opt_state)
    moments = {}
    for name, leaf, local in pairs:
        prefix = f"optim.{name}/"
        for fqn, item in meta.items():
            if not fqn.startswith(prefix) or not isinstance(item, dcp.TensorStorageMetadata):
                continue
            key = fqn[len(prefix):]
            shape = tuple(item.size)
            if shape == tuple(leaf.shape):
                value = _like_leaf(leaf, torch.zeros_like(local, dtype=item.properties.dtype))
            else:  # AdamW's step count, one scalar on every rank
                value = torch.zeros(shape, dtype=item.properties.dtype)
            moments[f"{name}/{key}"] = value
    state = {"params": dict(named_leaves(params)), "optim": moments,
             "param_groups": (), "step": 0}
    with torch.no_grad():
        dcp.load(state, checkpoint_id=directory)
    per_leaf = {}
    for fqn, value in state["optim"].items():
        name, key = fqn.rsplit("/", 1)
        per_leaf.setdefault(name, {})[key] = (
            value.to_local() if _is_dtensor(value) else value)
    opt.load_state_dict({
        "state": {i: per_leaf[name] for i, (name, _, _) in enumerate(pairs)
                  if name in per_leaf},
        "param_groups": list(state["param_groups"])})
    return int(state["step"])
