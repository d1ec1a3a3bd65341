"""W8A8 GEMM: per-row dynamic int8 activations x int8 weights (kernel K2).

Port of spittle_tpu/ops/w8a8_gemm.py:w8a8_gemm. The CUDA kernel is
spittle_tpu_torch/csrc/w8a8_gemm.cu; `w8a8_gemm_plain` is the same
function in plain PyTorch. The wrapper takes the plain version for a
tensor on the CPU only; on a CUDA tensor it launches the kernel or raises.

    y = act((qx @ qw) * sx * (sw * s) + b * s)
    sx = amax(|x|, row) / 127 (1 where 0); qx = clip(round(x / sx), +-127)

out_scale s is folded into the [N]-sized operands, as in the TPU kernel
(w8a8_gemm.py:104-105): the bias is scaled in its own dtype, then read
as f32. The GELU is the exact erf form (mm_bias's jax.nn.gelu, not the
TPU kernel's polynomial erf).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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
    """Plain PyTorch K2: the kernel's arithmetic, op for op."""
    k, n = qw.shape
    lead = x.shape[:-1]
    qx, sx = quantize_rows(x.reshape(-1, k))
    swr, br = _fold(sw, bias, out_scale)
    y = int8_dot(qx, qw).to(torch.float32) * sx * swr
    if br is not None:
        y = y + br
    if act == "gelu":
        y = gelu_erf(y)
    return y.to(x.dtype).reshape(*lead, n)


def w8a8_gemm(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor] = None, act: str = "none",
              out_scale: float = 1.0) -> torch.Tensor:
    """x [..., K] bf16/f32; qw int8 [K, N] stored N-major (strides (1, K),
    as quantize_weight_w8a8 stores it); sw f32 [N]; bias [N] or None."""
    if act not in ("none", "gelu"):
        raise ValueError(f"act must be 'none' or 'gelu', got {act!r}")
    if x.device.type == "cpu":
        return w8a8_gemm_plain(x, qw, sw, bias, act, out_scale)
    k, n = qw.shape
    lead = x.shape[:-1]
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"w8a8_gemm: x must be bf16 or f32, got {x.dtype}")
    if x.shape[-1] != k or qw.dtype != torch.int8:
        raise ValueError(f"w8a8_gemm: x {tuple(x.shape)} vs qw {tuple(qw.shape)} {qw.dtype}")
    if qw.stride() != (1, k):
        raise ValueError("w8a8_gemm: qw must be stored N-major (strides (1, K))")
    if k % 64:
        raise ValueError(f"w8a8_gemm: K={k} must be a multiple of 64")
    if qw.data_ptr() % 16:
        raise ValueError("w8a8_gemm: qw must be 16-byte aligned")
    for t in (qw, sw) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError("w8a8_gemm: operands on different devices")
    xm = x.reshape(-1, k)
    if not xm.is_contiguous():
        raise ValueError("w8a8_gemm: x rows must be contiguous")
    m = xm.shape[0]
    swr, br = _fold(sw, bias, out_scale)
    swr = swr.contiguous()
    br = None if br is None else br.contiguous()
    qx = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    stream = _build.stream_ptr(x.device)
    dt = _DTYPES[x.dtype]
    _build.check(lib.spt_w8a8_quantize_rows(
        xm.data_ptr(), qx.data_ptr(), sx.data_ptr(), m, k, dt, stream,
    ), "spt_w8a8_quantize_rows")
    _build.check(lib.spt_w8a8_gemm(
        qx.data_ptr(), qw.data_ptr(), sx.data_ptr(), swr.data_ptr(),
        None if br is None else br.data_ptr(), out.data_ptr(),
        m, n, k, int(act == "gelu"), dt, stream,
    ), "spt_w8a8_gemm")
    w8a8_gemm.launches += 1
    return out.reshape(*lead, n)


w8a8_gemm.launches = 0
