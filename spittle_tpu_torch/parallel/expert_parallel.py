"""Expert parallelism: a Switch-style top-1 MoE feed-forward over a device
mesh (port of spittle_tpu/parallel/expert_parallel.py).

The function is the reference's exactly. Each expert takes at most
C = ceil(N / E) * capacity_factor tokens (Python arithmetic: a ceiling,
then a truncation); a token's slot is its running count within its expert
in the flattened [N] token order, and a token whose slot is >= C is
dropped and outputs exactly 0. The router runs in f32; the expert input
is cast to w_in's dtype, both expert products and the exact GELU run in
that dtype, and the combine (weighted by the gate, the top probability)
in f32, cast back to x's dtype.

The reference writes dispatch and combine as dense [N, E, C] one-hot
einsums (720 MB at turbo width and B 8); here they are index ops: the
kept tokens are gathered into [E, C, D], torch.bmm runs each expert's
batch, and each token takes its expert row back. Each one-hot einsum
picks exactly one term plus zeros, so the numbers are those of the
expert products. The JAX package leaves those products to XLA, so they
stay torch products here: there is no TPU kernel to port.

Under autograd the router learns through the gate (the combine's weight,
Switch's semantics, as the reference's docstring says): the argmax, the
slots and the drops carry no gradient, and the load-balancing loss's
gradient flows through the mean router probability only. The collectives
of the mesh are then differentiable (mesh.all_reduce_sum).

Under a mesh (x a DTensor split over "data", the expert weights split over
"model"), the result is the global function, as GSPMD gives the
reference's: capacity comes from the global N, a token's slot from its
place in the global flattened order (an exclusive prefix of the
per-expert counts of the lower "data" ranks, one all_gather of [E]
counts), and aux_loss, expert_counts and dropped are global. Tokens are
replicated over "model": each rank routes every token of its "data" shard,
runs only its own experts, and the partial combines are summed over
"model", every other term being an exact zero.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spittle_tpu_torch.ops.w8a8_gemm import gelu_erf

from .mesh import P, all_reduce_sum, local_rows, like_rows, shard_leaf

Params = Dict[str, Any]


def init_moe_params(d_model: int, d_ff: int, n_experts: int,
                    dtype=torch.float32, seed: int = 0, device="cpu") -> Params:
    """router_w [D, E] f32 (scale D^-0.5), w_in [E, D, F] (D^-0.5) and
    w_out [E, F, D] (F^-0.5) in `dtype`, drawn from numpy's
    default_rng(seed) (the reference draws from a jax key)."""
    rng = np.random.default_rng(seed)

    def w(shape, scale, dt):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return {
        "router_w": w((d_model, n_experts), d_model ** -0.5, torch.float32),
        "w_in": w((n_experts, d_model, d_ff), d_model ** -0.5, dtype),
        "w_out": w((n_experts, d_ff, d_model), d_ff ** -0.5, dtype),
    }


def moe_param_specs() -> Dict[str, P]:
    """PartitionSpecs: experts shard over the mesh's "model" axis."""
    return {
        "router_w": P(None, None),
        "w_in": P("model", None, None),
        "w_out": P("model", None, None),
    }


def shard_moe_params(params: Params, mesh) -> Params:
    specs = moe_param_specs()
    return {k: shard_leaf(v, mesh, specs[k]) for k, v in params.items()}


def _group_of(dim: str, leaf) -> Tuple[Optional[Any], int]:
    """(the group, this rank's index) of a DTensor leaf split over `dim`;
    (None, 0) for a plain tensor or a replicated one."""
    from torch.distributed.tensor import DTensor, Shard

    if not (dist.is_available() and dist.is_initialized()
            and isinstance(leaf, DTensor)):
        return None, 0
    mesh = leaf.device_mesh
    names = mesh.mesh_dim_names
    if dim in names and isinstance(leaf.placements[names.index(dim)], Shard):
        return mesh.get_group(dim), mesh.get_local_rank(dim)
    return None, 0


def _plain(t):
    return t.to_local() if hasattr(t, "to_local") else t


def moe_ffn(params: Params, x, capacity_factor: float = 1.25):
    """Top-1 routed MoE feed-forward. x: [N, D] tokens (a tensor, or a
    DTensor split over "data"); params: init_moe_params' tree, plain or
    from shard_moe_params. Returns (out [N, D] like x, aux) where aux holds
    "aux_loss" (Switch eq. 4), "expert_counts" [E] and "dropped"."""
    xl, spec, data_group = local_rows(x)
    model_group, model_rank = _group_of("model", params["w_in"])
    out, aux = moe_ffn_local(
        _plain(params["router_w"]), _plain(params["w_in"]),
        _plain(params["w_out"]), xl, capacity_factor,
        data_group=data_group, model_group=model_group, model_rank=model_rank)
    return like_rows(out, spec), aux


def moe_ffn_local(router_w, w_in, w_out, x: torch.Tensor,
                  capacity_factor: float = 1.25, data_group=None,
                  model_group=None, model_rank: int = 0):
    """moe_ffn on local tensors. x [n, D]: this rank's tokens, the rows of
    its "data" shard when data_group is given (else all N). w_in/w_out:
    this rank's E / tp experts, those from model_rank * E / tp, when
    model_group is given (else all E); router_w [D, E] is whole."""
    n, d = x.shape
    e = router_w.shape[-1]
    e_local = w_in.shape[0]
    e0 = model_rank * e_local
    dev = x.device

    logits = x.to(torch.float32) @ router_w.to(torch.float32)  # [n, E]
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # the first max
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert_idx, e)  # int64 [n, E]
    counts = onehot.sum(dim=0)  # [E]
    prob_sum = probs.sum(dim=0)
    # The token's place among its expert's tokens here, then its global
    # slot: the counts of the lower "data" ranks come first.
    local_pos = (onehot.cumsum(dim=0) * onehot).sum(dim=1) - 1  # [n]
    n_total = n
    offset = torch.zeros_like(counts)
    if data_group is not None:
        sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
                 for _ in range(dist.get_world_size(data_group))]
        dist.all_gather(sizes, torch.tensor([n], dtype=torch.int64, device=dev),
                        group=data_group)
        n_total = int(torch.cat(sizes).sum())
        all_counts = [torch.empty_like(counts) for _ in sizes]
        dist.all_gather(all_counts, counts, group=data_group)
        me = dist.get_rank(data_group)
        offset = torch.stack(all_counts[:me]).sum(0) if me else offset
        counts = torch.stack(all_counts).sum(0)
        prob_sum = all_reduce_sum(prob_sum, data_group)
    capacity = max(int(-(-n_total // e) * capacity_factor), 1)
    slot = offset[expert_idx] + local_pos
    kept = slot < capacity

    # Dispatch: this rank's experts' kept tokens into [E_local, rows, D],
    # a row per token of this shard (its slots are a contiguous run of
    # the global ones), then both products per expert batch.
    mine = kept & (expert_idx >= e0) & (expert_idx < e0 + e_local)
    tok = torch.nonzero(mine)[:, 0]
    ex = expert_idx[tok] - e0
    row = local_pos[tok]
    rows = max(int(row.max()) + 1 if tok.numel() else 1, 1)
    expert_in = torch.zeros((e_local, rows, d), dtype=w_in.dtype, device=dev)
    expert_in[ex, row] = x[tok].to(torch.float32).to(w_in.dtype)
    h = gelu_erf(torch.bmm(expert_in, w_in))
    expert_out = torch.bmm(h, w_out)
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    out[tok] = expert_out[ex, row].to(torch.float32) * gate[tok, None]
    out = all_reduce_sum(out, model_group)

    # Switch load-balancing loss: E * sum_e(fraction_e * mean_prob_e).
    countsf = counts.to(torch.float32)
    frac = countsf / n_total
    mean_prob = prob_sum / n_total
    aux_loss = e * torch.sum(frac * mean_prob)
    kept_total = torch.minimum(counts, torch.full_like(counts, capacity)).sum()
    return out.to(x.dtype), {
        "aux_loss": aux_loss,
        "expert_counts": countsf,
        "dropped": (n_total - kept_total).to(torch.float32),
    }


def moe_ffn_dense_reference(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-token dense evaluation of the routed expert, no capacity drops
    (the oracle of the tests)."""
    probs = torch.softmax(x.float() @ params["router_w"].float(), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    w_in = params["w_in"][idx].float()  # [N, D, F]
    w_out = params["w_out"][idx].float()
    h = gelu_erf(torch.einsum("nd,ndf->nf", x.float(), w_in))
    out = torch.einsum("nf,nfd->nd", h, w_out) * gate[:, None]
    return out.to(x.dtype)
