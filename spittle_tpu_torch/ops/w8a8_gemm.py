"""W8A8 GEMM: per-row dynamic int8 activations x int8 weights (kernel K2).

Port of spittle_tpu/ops/w8a8_gemm.py:w8a8_gemm. The CUDA kernels are in
spittle_tpu_torch/csrc/w8a8_gemm.cu: a row quantizer, then a persistent
TMA + int8 wgmma GEMM over 128 x `tile_n` output tiles in `tile_order`;
`w8a8_gemm_plain` is the same function in plain PyTorch. The wrapper
takes the plain version for a tensor on the CPU only; on a CUDA tensor it
launches the kernels or raises.

    y = act((qx @ qw) * sx * (sw * s) + b * s)
    sx = amax(|x|, row) / 127 (1 where 0); qx = clip(round(x / sx), +-127)

out_scale s is folded into the [N]-sized operands, as in the TPU kernel
(w8a8_gemm.py:104-105): the bias is scaled in its own dtype, then read
as f32. The GELU is the exact erf form (mm_bias's jax.nn.gelu, not the
TPU kernel's polynomial erf).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import _build
from .attention import _num_sms

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# The GEMM's tile rows (two consumer warpgroups of 64) and the row tiles
# that sweep the columns together (kBM and kGroupM in the source).
TILE_M = 128
GROUP_M = 8


def tile_n(m: int, n: int, k: int, dtype: torch.dtype, num_sms: int,
           gelu: bool = False) -> int:
    """The GEMM's output tile width for an [m, k] x [k, n] product, which
    also names its schedule. 256: both consumer warpgroups on each 128 x
    256 tile (cooperative), where the output is bf16 without GELU, k is
    past 2048 (many products per epilogue; the wide tile reads fewer
    shared-memory bytes per product), n is a multiple of 256 and those
    tiles still give every SM one. 128 otherwise: without GELU the
    warpgroups take 128 x 128 tiles in turn (ping-pong: one's epilogue
    runs under the other's products); with GELU both share each 128 x 128
    tile, so that eight warps, not four, compute its erf."""
    if dtype != torch.bfloat16 or gelu or n % 256 or k <= 2048:
        return 128
    tiles = -(-m // TILE_M) * (n // 256)
    return 256 if tiles >= num_sms else 128


def tile_order(m: int, n: int, bn: int):
    """The (row, column) origins of the output tiles in the persistent
    kernel's order (tile_at in the source): groups of GROUP_M row tiles,
    each group walking the columns with its row tiles adjacent. Block i of
    a grid of g takes tiles i, i + g, ..."""
    m_tiles, n_tiles = -(-m // TILE_M), -(-n // bn)
    per_group = GROUP_M * n_tiles
    order = []
    for t in range(m_tiles * n_tiles):
        first = t // per_group * GROUP_M
        rows = min(GROUP_M, m_tiles - first)
        r = t % per_group
        order.append(((first + r % rows) * TILE_M, r // rows * bn))
    return order


def quantize_rows(x2d: torch.Tensor):
    """[M, K] -> (qx int8 [M, K], sx f32 [M, 1]): the reference's exact rule
    (true division, round-half-even, clip to +-127)."""
    x32 = x2d.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # Divide by a device tensor: CUDA turns division by a Python scalar
    # into a multiply by its reciprocal, which is not the reference's
    # IEEE division.
    sx = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                     torch.ones_like(amax))
    qx = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return qx, sx


class QuantizedRows(NamedTuple):
    """x [..., K] quantized by rows once for several W8A8 GEMMs that read
    the same rows (q, k and v read one LayerNorm output): qx int8 [M, K]
    and sx f32 [M, 1], the bytes and scales each GEMM would make, with x's
    dtype and leading shape."""
    qx: torch.Tensor
    sx: torch.Tensor
    dtype: torch.dtype
    lead: Tuple[int, ...]


def quantize_for_gemm(x: torch.Tensor) -> QuantizedRows:
    """Quantize x's rows for w8a8_gemm: quantize_rows on the CPU, the row
    quantizer kernel on a CUDA tensor (checked as w8a8_gemm checks x)."""
    k = x.shape[-1]
    xm = x.reshape(-1, k)
    if x.device.type == "cpu":
        qx, sx = quantize_rows(xm)
    else:
        _check_rows(x, xm)
        qx, sx = launch_quantize(xm)
        sx = sx[:, None]
    return QuantizedRows(qx, sx, x.dtype, tuple(x.shape[:-1]))


def _check_rows(x: torch.Tensor, xm: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"w8a8_gemm: x must be bf16 or f32, got {x.dtype}")
    if not xm.is_contiguous() or xm.data_ptr() % 16:
        raise ValueError("w8a8_gemm: x rows must be contiguous and 16-byte aligned")


def int8_dot(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> integer sums, as f64 (every |sum| here is far
    below 2**53, so f64 holds the int32 accumulator exactly; integer
    matmul is not available on every device)."""
    return qx.to(torch.float64) @ qw.to(torch.float64)


def _fold(sw, bias, out_scale):
    swr = (sw * out_scale).to(torch.float32)
    br = None if bias is None else (bias * out_scale).to(torch.float32)
    return swr, br


def gelu_erf(y: torch.Tensor) -> torch.Tensor:
    """Exact GELU, x * 0.5 * (1 + erf(x / sqrt 2)), computed in f32 for
    bf16 inputs (the kernel's epilogue uses the same formula)."""
    return torch.nn.functional.gelu(y, approximate="none")


def w8a8_gemm_plain(x, qw, sw, bias=None, act: str = "none",
                    out_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch K2: the kernel's arithmetic, op for op. x: a tensor
    or its QuantizedRows."""
    k, n = qw.shape
    if isinstance(x, QuantizedRows):
        qx, sx, dtype, lead = x
    else:
        qx, sx = quantize_rows(x.reshape(-1, k))
        dtype, lead = x.dtype, x.shape[:-1]
    swr, br = _fold(sw, bias, out_scale)
    y = int8_dot(qx, qw).to(torch.float32) * sx * swr
    if br is not None:
        y = y + br
    if act == "gelu":
        y = gelu_erf(y)
    return y.to(dtype).reshape(*lead, n)


def launch_quantize(xm: torch.Tensor):
    """The row quantizer kernel on a contiguous CUDA [M, K] (checked by
    w8a8_gemm): (qx int8 [M, K], sx f32 [M])."""
    m, k = xm.shape
    qx = torch.empty((m, k), dtype=torch.int8, device=xm.device)
    sx = torch.empty((m,), dtype=torch.float32, device=xm.device)
    _build.check(_build.load_library().spt_w8a8_quantize_rows(
        xm.data_ptr(), qx.data_ptr(), sx.data_ptr(), m, k, _DTYPES[xm.dtype],
        _build.stream_ptr(xm.device),
    ), "spt_w8a8_quantize_rows")
    return qx, sx


def launch_gemm(qx, sx, qw, sw, bias, out_scale: float, gelu: bool,
                dtype) -> torch.Tensor:
    """The GEMM kernel on launch_quantize's output and w8a8_gemm's checked
    operands (the kernel folds out_scale into sw and bias as _fold does):
    [M, N] of dtype, in tiles tile_n wide."""
    m, k = qx.shape
    n = qw.shape[1]
    sms = _num_sms(qx.device.index)
    out = torch.empty((m, n), dtype=dtype, device=qx.device)
    _build.check(_build.load_library().spt_w8a8_gemm(
        qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, n, k, int(gelu), _DTYPES[dtype],
        int(bias is not None and bias.dtype == torch.bfloat16),
        tile_n(m, n, k, dtype, sms, gelu), sms, out_scale,
        _build.stream_ptr(qx.device),
    ), "spt_w8a8_gemm")
    return out


def w8a8_gemm(x: Union[torch.Tensor, QuantizedRows], qw: torch.Tensor,
              sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
              act: str = "none", out_scale: float = 1.0) -> torch.Tensor:
    """x [..., K] bf16/f32, or its QuantizedRows (quantize_for_gemm: the
    row quantizer then runs once for every GEMM on those rows); qw int8
    [K, N] stored N-major (strides (1, K), as quantize_weight_w8a8 stores
    it); sw f32 [N]; bias [N] or None."""
    if act not in ("none", "gelu"):
        raise ValueError(f"act must be 'none' or 'gelu', got {act!r}")
    rows = x.qx if isinstance(x, QuantizedRows) else x
    if rows.device.type == "cpu":
        return w8a8_gemm_plain(x, qw, sw, bias, act, out_scale)
    k, n = qw.shape
    if rows.shape[-1] != k or qw.dtype != torch.int8:
        raise ValueError(f"w8a8_gemm: x {tuple(rows.shape)} vs qw {tuple(qw.shape)} {qw.dtype}")
    if qw.stride() != (1, k):
        raise ValueError("w8a8_gemm: qw must be stored N-major (strides (1, K))")
    if k % 64:
        raise ValueError(f"w8a8_gemm: K={k} must be a multiple of 64")
    if n % 8:
        raise ValueError(f"w8a8_gemm: N={n} must be a multiple of 8")
    if qw.data_ptr() % 16:
        raise ValueError("w8a8_gemm: qw must be 16-byte aligned")
    for t in (qw, sw) + (() if bias is None else (bias,)):
        if t.device != rows.device:
            raise ValueError("w8a8_gemm: operands on different devices")
    if sw.dtype != torch.float32 or not sw.is_contiguous() or sw.shape != (n,):
        raise ValueError("w8a8_gemm: sw must be a contiguous f32 [N]")
    if bias is not None and (bias.dtype not in _DTYPES or not bias.is_contiguous()
                             or bias.shape != (n,)):
        raise ValueError("w8a8_gemm: bias must be a contiguous bf16 or f32 [N]")
    if isinstance(x, QuantizedRows):
        qx, sx, dtype, lead = x
    else:
        xm = x.reshape(-1, k)
        _check_rows(x, xm)
        qx, sx = launch_quantize(xm)
        dtype, lead = x.dtype, x.shape[:-1]
    out = launch_gemm(qx, sx, qw, sw, bias, out_scale, act == "gelu", dtype)
    w8a8_gemm.launches += 1
    return out.reshape(*lead, n)


w8a8_gemm.launches = 0
