"""Interpreter for imported ONNX graphs on torch tensors (port of
spittle_tpu/io/onnx_interp.py).

Executes the op subset of the models Spittle bundles or downloads (Silero
VAD v4 today; the conv/LSTM/elementwise family generally) over the graphs
of io/onnx_proto.py, on the device it is given: the slow but faithful
oracle that the model code is held against. Not a performance path: it
runs plain torch ops, one per node. The reductions (Conv, the LSTM's
recurrence, ReduceMean) accumulate in f64 and round each output to its
input's dtype once, so that a result does not depend on the device's
summation order: the card and the CPU give the same f32 values up to the
last ulp of the elementwise ops.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from spittle_tpu_torch.device import resolve_device

from .onnx_proto import _DTYPES, Graph, Node

# An ONNX Slice end (or start) past this is "to the end" (INT64_MAX-ish).
_SLICE_INF = 2 ** 62


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """numpy array (or scalar) or tensor -> tensor on dev."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype in (np.uint16, np.uint32, np.uint64):
        raise NotImplementedError(f"ONNX tensor of dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _torch_dtype(tag: int) -> torch.dtype:
    """ONNX TensorProto.DataType tag -> torch dtype."""
    return _tensor(np.zeros(0, _DTYPES[tag]), torch.device("cpu")).dtype


def _ints(t) -> list:
    """A shape / index operand as Python ints."""
    if isinstance(t, torch.Tensor):
        return [int(v) for v in t.reshape(-1).tolist()]
    return [int(v) for v in np.atleast_1d(t)]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A floating tensor in f64, the reductions' accumulator."""
    return t.to(torch.float64) if t.is_floating_point() else t


def _conv(x, w, b=None, group=1, strides=(1,), pads=(0, 0), dilations=(1,)):
    """1D convolution, NCW layout, matching ONNX Conv semantics; summed in
    f64, rounded to x's dtype."""
    assert x.dim() == 3 and w.dim() == 3, (x.shape, w.shape)
    xp = F.pad(_wide(x), (int(pads[0]), int(pads[1])))
    out = F.conv1d(xp, _wide(w), None if b is None else _wide(b),
                   stride=int(strides[0]), dilation=int(dilations[0]),
                   groups=int(group))
    return out.to(x.dtype)


def _lstm(x, w, r, b, h0, c0, hidden_size):
    """ONNX LSTM, forward direction, layout=0.

    x: [T, N, I]; w: [1, 4H, I]; r: [1, 4H, H]; b: [1, 8H];
    h0/c0: [1, N, H]. Gate order i, o, f, c (ONNX spec).
    Returns (Y [T, 1, N, H], h [1, N, H], c [1, N, H]) in x's dtype; the
    recurrence runs in f64.
    """
    T = x.shape[0]
    H = hidden_size
    wt = _wide(w[0]).T  # [I, 4H]
    rt = _wide(r[0]).T  # [H, 4H]
    wb = _wide(b[0, : 4 * H] + b[0, 4 * H:])  # [4H]
    xw, h, c = _wide(x), _wide(h0[0]), _wide(c0[0])
    ys = []
    for t in range(T):
        gates = xw[t] @ wt + h @ rt + wb  # [N, 4H]
        i = torch.sigmoid(gates[:, 0:H])
        o = torch.sigmoid(gates[:, H: 2 * H])
        f = torch.sigmoid(gates[:, 2 * H: 3 * H])
        g = torch.tanh(gates[:, 3 * H: 4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    y = (torch.stack(ys)[:, None] if ys
         else xw.new_zeros((0, 1) + tuple(h.shape)))
    return y.to(x.dtype), h[None].to(x.dtype), c[None].to(x.dtype)


def _pad_index(n: int, left: int, right: int, mode: str) -> np.ndarray:
    """Source indices of a dim of n padded by (left, right), numpy's
    "reflect" or "edge" rule."""
    idx = np.arange(-left, n + right)
    if mode == "edge":
        return np.clip(idx, 0, n - 1)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


class OnnxInterpreter:
    """Execute a parsed ONNX graph on torch tensors on `device` (the card
    by default; it raises without one)."""

    def __init__(self, graph: Graph, device="cuda"):
        self.graph = graph
        self.device = resolve_device(device)

    def run(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        env = self._initializers(self.graph)
        env.update({k: _tensor(v, self.device) for k, v in feeds.items()})
        with torch.inference_mode():
            self._exec_nodes(self.graph.nodes, env)
        return {name: env[name] for name in self.graph.outputs}

    def _initializers(self, graph: Graph) -> Dict[str, torch.Tensor]:
        return {k: _tensor(v, self.device) for k, v in graph.initializers.items()}

    # -- op dispatch ------------------------------------------------------

    def _exec_nodes(self, nodes: Sequence[Node], env: Dict[str, torch.Tensor]):
        for node in nodes:
            handler = getattr(self, f"_op_{node.op_type.lower()}", None)
            if handler is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            ins = [env[i] if i else None for i in node.inputs]
            outs = handler(node, ins, env)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                env[name] = val

    def _op_identity(self, node, ins, env):
        return ins[0]

    def _op_shape(self, node, ins, env):
        start = node.attr("start", 0) or 0
        return torch.tensor(tuple(ins[0].shape)[start:], dtype=torch.int64,
                            device=self.device)

    def _op_gather(self, node, ins, env):
        data = ins[0]
        axis = (node.attr("axis", 0) or 0) % max(data.dim(), 1)
        idx = ins[1].to(torch.int64)
        idx = torch.where(idx < 0, idx + data.shape[axis], idx)
        out = data.index_select(axis, idx.reshape(-1))
        return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])

    def _op_unsqueeze(self, node, ins, env):
        axes = ins[1] if len(ins) > 1 else node.attr("axes")
        out = ins[0]
        for ax in sorted(_ints(axes)):
            out = out.unsqueeze(ax)
        return out

    def _op_squeeze(self, node, ins, env):
        if len(ins) > 1 and ins[1] is not None:
            return ins[0].squeeze(tuple(_ints(ins[1])))
        return ins[0].squeeze()

    def _op_concat(self, node, ins, env):
        return torch.cat(ins, dim=node.attr("axis", 0))

    def _op_reshape(self, node, ins, env):
        return ins[0].reshape(tuple(_ints(ins[1])))

    def _op_pad(self, node, ins, env):
        mode = (node.attr("mode") or b"constant").decode()
        if mode not in ("constant", "reflect", "edge"):
            raise NotImplementedError(f"ONNX Pad mode {mode}")
        x = ins[0]
        pads = _ints(ins[1])
        rank = x.dim()
        pairs = [(pads[i], pads[i + rank]) for i in range(rank)]
        if mode == "constant":
            flat = [p for pair in reversed(pairs) for p in pair]
            return F.pad(x, flat)
        for dim, (left, right) in enumerate(pairs):
            if left or right:
                idx = _pad_index(x.shape[dim], left, right, mode)
                x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
        return x

    def _op_equal(self, node, ins, env):
        return torch.eq(ins[0], ins[1])

    def _op_cast(self, node, ins, env):
        return ins[0].to(_torch_dtype(node.attr("to")))

    def _op_if(self, node, ins, env):
        cond = bool(ins[0].reshape(()).item())
        branch: Graph = node.attr("then_branch" if cond else "else_branch")
        sub_env = dict(env)
        sub_env.update(self._initializers(branch))
        self._exec_nodes(branch.nodes, sub_env)
        return tuple(sub_env[name] for name in branch.outputs)

    def _op_conv(self, node, ins, env):
        return _conv(
            ins[0],
            ins[1],
            ins[2] if len(ins) > 2 else None,
            group=node.attr("group", 1) or 1,
            strides=tuple(node.attr("strides", [1])),
            pads=tuple(node.attr("pads", [0, 0])),
            dilations=tuple(node.attr("dilations", [1])),
        )

    def _op_slice(self, node, ins, env):
        data = ins[0]
        starts, ends = _ints(ins[1]), _ints(ins[2])
        axes = (_ints(ins[3]) if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = (_ints(ins[4]) if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
        for s, e, a, st in zip(starts, ends, axes, steps):
            a %= data.dim()
            e = None if e >= _SLICE_INF else e
            s = None if s <= -_SLICE_INF else s
            if st > 0:
                data = data[(slice(None),) * a + (slice(s, e, st),)]
            else:  # torch slices take no negative step
                keep = range(*slice(s, e, st).indices(data.shape[a]))
                idx = torch.tensor(list(keep), dtype=torch.int64, device=data.device)
                data = data.index_select(a, idx)
        return data

    def _op_pow(self, node, ins, env):
        return torch.pow(ins[0], ins[1])

    def _op_add(self, node, ins, env):
        return ins[0] + ins[1]

    def _op_mul(self, node, ins, env):
        return ins[0] * ins[1]

    def _op_neg(self, node, ins, env):
        return -ins[0]

    def _op_sqrt(self, node, ins, env):
        return torch.sqrt(ins[0])

    def _op_log(self, node, ins, env):
        return torch.log(ins[0])

    def _op_relu(self, node, ins, env):
        return torch.clamp_min(ins[0], 0)

    def _op_sigmoid(self, node, ins, env):
        return torch.sigmoid(ins[0])

    def _op_reducemean(self, node, ins, env):
        axes = node.attr("axes")
        keepdims = bool(node.attr("keepdims", 1))
        x = ins[0]
        if axes is None:
            out = _wide(x).mean().to(x.dtype)
            return out.reshape((1,) * x.dim()) if keepdims else out
        axes = tuple(int(a) if a < _SLICE_INF else -1 for a in axes)
        return _wide(x).mean(dim=axes, keepdim=keepdims).to(x.dtype)

    def _op_transpose(self, node, ins, env):
        perm = node.attr("perm")
        x = ins[0]
        return x.permute(*(perm if perm is not None else range(x.dim() - 1, -1, -1)))

    def _op_constantofshape(self, node, ins, env):
        t = node.attr("value")
        fill = (t.reshape(-1)[0] if t is not None and t.size
                else np.float32(0))
        dtype = _tensor(np.zeros(0, fill.dtype), torch.device("cpu")).dtype
        return torch.full(tuple(_ints(ins[0])), fill.item(), dtype=dtype,
                          device=self.device)

    def _op_lstm(self, node, ins, env):
        x, w, r, b = ins[0], ins[1], ins[2], ins[3]
        h0 = ins[5] if len(ins) > 5 and ins[5] is not None else None
        c0 = ins[6] if len(ins) > 6 and ins[6] is not None else None
        hidden = node.attr("hidden_size")
        if h0 is None:
            h0 = x.new_zeros((1, x.shape[1], hidden))
        if c0 is None:
            c0 = x.new_zeros((1, x.shape[1], hidden))
        return _lstm(x, w, r, b, h0, c0, hidden)
