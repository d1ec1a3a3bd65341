"""Checkpoint and resume of fine-tuning state (port of
spittle_tpu/train/checkpoint.py): (params, optimizer state, step) under
<path>/step_<n>/, written by torch.save into a temporary directory beside
it and renamed into place, so that an interrupted save leaves no partial
step_<n> and a resumed run equals an unbroken one. The reference writes
with orbax, which the port does not use. Trees of DTensors (a sharded
tree's shards differ by rank) are refused.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import torch

_STATE = "state.pt"


def _tensors(tree):
    """The tree with every leaf detached; DTensor leaves refused."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        raise ValueError("save_checkpoint takes a plain tree, not DTensors")
    return tree.detach()


def save_checkpoint(path: str, params: Any, opt_state: Any, step: int) -> None:
    """Write (params, the AdamW state of opt_state, an OptState, step) as
    <path>/step_<step>, replacing one that exists."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    try:
        torch.save({"params": _tensors(params),
                    "opt_state": opt_state.optimizer.state_dict(), "step": step},
                   os.path.join(tmp, _STATE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
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
    are copied into like[0]'s tensors in place and the optimizer state
    loaded into like[1]. Returns (params, opt_state, step), or None when
    nothing is saved."""
    step = latest_step(path)
    if step is None:
        return None
    state = torch.load(os.path.join(os.path.abspath(path), f"step_{step}", _STATE),
                       map_location="cpu", weights_only=True)
    params, opt_state = like
    with torch.no_grad():
        _copy_into(params, state["params"])
    opt_state.optimizer.load_state_dict(state["opt_state"])
    return params, opt_state, state["step"]
