"""GPipe-style pipeline parallelism over stacked transformer layers (port of
spittle_tpu/parallel/pipeline_parallel.py).

The stacked [L, ...] layer layout makes pipeline stages a reshape:
[L, ...] -> [S, L/S, ...], stage s holding layers s*L/S .. (s+1)*L/S - 1.
Microbatches flow through the stages on the GPipe schedule: at step t
stage s takes microbatch t - s, so a round is M + S - 1 steps. The
reference rotates every stage's activation with ppermute at every step;
here a stage computes only at the steps where its microbatch exists and
hands the activation to the next stage with send / recv, which changes
none of the numbers the last stage emits.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def _stage_tree(tree, stage: int):
    """This stage's [L/S, ...] leaves: a DTensor split over the stage axis
    holds only its own stage ([1, L/S, ...] locally); a plain [S, L/S, ...]
    tensor is indexed."""
    if isinstance(tree, dict):
        return {k: _stage_tree(v, stage) for k, v in tree.items()}
    if hasattr(tree, "to_local"):
        return tree.to_local()[0]
    return tree[stage]


def pipeline_apply(mesh, axis: str, block_fn: Callable[[Any, torch.Tensor],
                                                        torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor) -> torch.Tensor:
    """Run microbatches [M, mb, ...] (the same on every rank) through the S
    stages of mesh dim `axis`. stage_params: leaves [S, L/S, ...]
    (stack_to_stages), plain or split over `axis`; block_fn(params of one
    stage, x) applies that stage's layers to a microbatch and keeps its
    shape. Every rank returns the outputs [M, mb, ...]."""
    s = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    peer = [dist.get_global_rank(group, i) for i in range(s)]
    m = microbatches.shape[0]
    params = _stage_tree(stage_params, stage)
    outputs = torch.zeros_like(microbatches)
    for t in range(m + s - 1):
        mb = t - stage
        if not 0 <= mb < m:
            continue
        if stage == 0:
            x = microbatches[mb]
        else:
            x = torch.empty_like(microbatches[0])
            dist.recv(x, src=peer[stage - 1], group=group)
        y = block_fn(params, x)
        if stage < s - 1:
            dist.send(y.contiguous(), dst=peer[stage + 1], group=group)
        else:
            outputs[mb] = y
    # Only the last stage holds the outputs; every rank gets them.
    dist.broadcast(outputs, src=peer[s - 1], group=group)
    return outputs


def stack_to_stages(stacked: Any, num_stages: int) -> Any:
    """[L, ...] tree -> [S, L/S, ...] for pipeline_apply."""

    def reshape(a):
        if isinstance(a, dict):
            return {k: reshape(v) for k, v in a.items()}
        n = a.shape[0]
        assert n % num_stages == 0, (n, num_stages)
        return a.reshape(num_stages, n // num_stages, *a.shape[1:])

    return reshape(stacked)
