"""In-place write of one position of a KV cache, the position read from
the device (kernels K12 and K13, csrc/cache_col_write.cu; port of the
aliased column writes of scripts/bench_cache_dus.py).

- alias_col_write (K13): ctx minor, cache[..., pos] = cols; replaces the
  Pallas `alias_col_write`.
- alias_col_write_sub (K12): ctx on the row axis, cache_t[:, pos, :] =
  cols; replaces the Pallas `alias_col_write_sub`.

Both return the tensor they were given: the cache is updated in place and
nothing else is copied (the reference aliases the cache to a new result).
`pos` is an int32 tensor on the cache's device, so the launch depends on
no host value; a pos outside [0, ctx) writes nothing. The TPU forms' rows
% 8 rule is not carried over.

A wrapper takes its plain version (a slice assignment) for tensors on
the CPU only; on a CUDA tensor it launches the kernel or raises. Each
wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from . import _build


def _check(name, cache, cols, pos, cols_shape):
    if cache.element_size() != 2 or cols.dtype != cache.dtype:
        raise TypeError(f"{name}: cache and cols must share a 2-byte dtype, "
                        f"got {cache.dtype} and {cols.dtype}")
    if tuple(cols.shape) != tuple(cols_shape):
        raise ValueError(f"{name}: cols must be {tuple(cols_shape)}, got "
                         f"{tuple(cols.shape)}")
    if not (cache.is_contiguous() and cols.is_contiguous()):
        raise ValueError(f"{name}: cache and cols must be contiguous")
    if not torch.is_tensor(pos) or pos.dtype != torch.int32 or pos.numel() != 1:
        raise TypeError(f"{name}: pos must be one int32 on the cache's device")
    if cols.device != cache.device or pos.device != cache.device:
        raise ValueError(f"{name}: operands on different devices")


def _pos_on_cpu(pos, ctx: int):
    p = int(pos)
    return p if 0 <= p < ctx else None


def alias_col_write_plain(cache, cols, pos) -> torch.Tensor:
    """Plain K13: cache[..., pos] = cols, in place."""
    p = _pos_on_cpu(pos, cache.shape[-1])
    if p is not None:
        cache[..., p] = cols
    return cache


def alias_col_write(cache, cols, pos) -> torch.Tensor:
    """K13. cache [..., ctx] and cols [...] (cache's leading axes),
    contiguous, one 2-byte dtype; pos one int32 on the same device.
    Writes cache[..., pos] = cols in place and returns cache."""
    if cache.device.type == "cpu":
        return alias_col_write_plain(cache, cols, pos)
    _check("alias_col_write", cache, cols, pos, cache.shape[:-1])
    lib = _build.load_library()
    _build.check(lib.spt_cache_col_write(
        cache.data_ptr(), cols.data_ptr(), pos.data_ptr(), cols.numel(),
        cache.shape[-1], _build.stream_ptr(cache.device),
    ), "spt_cache_col_write")
    alias_col_write.launches += 1
    return cache


alias_col_write.launches = 0


def alias_col_write_sub_plain(cache_t, cols, pos) -> torch.Tensor:
    """Plain K12: cache_t[:, pos, :] = cols, in place."""
    p = _pos_on_cpu(pos, cache_t.shape[1])
    if p is not None:
        cache_t[:, p, :] = cols
    return cache_t


def alias_col_write_sub(cache_t, cols, pos) -> torch.Tensor:
    """K12. cache_t [rows, ctx, hd] and cols [rows, hd], contiguous, one
    2-byte dtype, hd a multiple of 8; pos one int32 on the same device.
    Writes cache_t[:, pos, :] = cols in place and returns cache_t."""
    if cache_t.device.type == "cpu":
        return alias_col_write_sub_plain(cache_t, cols, pos)
    if cache_t.dim() != 3:
        raise ValueError("alias_col_write_sub: cache_t must be [rows, ctx, hd]")
    rows, ctx, hd = cache_t.shape
    _check("alias_col_write_sub", cache_t, cols, pos, (rows, hd))
    if hd % 8 or cache_t.data_ptr() % 16 or cols.data_ptr() % 16:
        raise ValueError("alias_col_write_sub: hd must be a multiple of 8 and "
                         "the data 16-byte aligned")
    lib = _build.load_library()
    _build.check(lib.spt_cache_col_write_rows(
        cache_t.data_ptr(), cols.data_ptr(), pos.data_ptr(), rows, ctx, hd,
        _build.stream_ptr(cache_t.device),
    ), "spt_cache_col_write_rows")
    alias_col_write_sub.launches += 1
    return cache_t


alias_col_write_sub.launches = 0
