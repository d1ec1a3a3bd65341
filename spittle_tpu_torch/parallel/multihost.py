"""Multi-process meshes (port of spittle_tpu/parallel/multihost.py).

torch runs one process per card, so every mesh of more than one rank spans
processes, and host data reaches another rank's card only through a
collective. Parameters that every process holds whole are placed by each
rank slicing its own shard (mesh.shard_leaf, the reference's
make_array_from_callback); a batch whose rows each process stages itself
is the concatenation of the processes' rows in rank order
(global_batch_from_local, the reference's
make_array_from_process_local_data).

Recommended layout: "model" inside a host (NVLink), "data" across hosts;
make_mesh gives that when each host's ranks are consecutive.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spittle_tpu_torch.device import resolve_device

from .mesh import P, like_rows, placements
# Host data identical on every process -> the DTensor of a spec, each rank
# keeping its own slice (no communication).
from .mesh import shard_leaf as global_put  # noqa: F401


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, local_device_ids=None,
                           device: str = "cuda") -> None:
    """init_process_group over tcp://coordinator_address with world size
    num_processes and rank process_id. device "cuda" (default; raises
    without a card): the NCCL backend on the card local_device_ids[0]
    (default: process_id modulo the visible cards). device "cpu": gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = list(local_device_ids) if local_device_ids is not None else [
            process_id % torch.cuda.device_count()]
        torch.cuda.set_device(ids[0])
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)


def mesh_is_multiprocess(mesh) -> bool:
    """True when the mesh holds ranks other than this process."""
    return mesh.size() > 1


def global_batch_from_local(local_rows, mesh, spec: Optional[P] = None):
    """Each process's local rows -> the global batch split over `spec`'s
    mesh dim (default the mesh's first, "data"): a DTensor whose rows are
    the processes' rows concatenated in rank order, each rank holding its
    own. Ranks that share a "data" index contribute the same rows."""
    spec = spec if spec is not None else P(mesh.mesh_dim_names[0])
    rows = torch.as_tensor(np.asarray(local_rows) if not torch.is_tensor(local_rows)
                           else local_rows).to(mesh.device_type)
    return like_rows(rows, (mesh, tuple(placements(mesh, spec))))


def replicated_to_host(x) -> np.ndarray:
    """Read back a fully replicated global array (a loss scalar, say) on
    any process; a sharded one raises ValueError."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        if not all(isinstance(p, Replicate) for p in x.placements):
            raise ValueError("array is not fully replicated across the mesh")
        x = x.to_local()
    return x.detach().cpu().numpy()
