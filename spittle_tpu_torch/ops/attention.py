"""Attention ops: the port's kernels K1, K3, K4 and K6 with their plain
versions (port of spittle_tpu/ops/attention.py).

- attention_reference: plain attention (the reference's XLA form).
- flash_attention_fullkv (K1, csrc/fullkv_attention.cu): encoder
  self-attention; replaces the Pallas `flash_attention_fullkv`.
- decode_cross_attention (K4, csrc/decode_cross_attention.cu): <= 8 query
  rows against the whole K/V in the decode layout [B, H, Dh, Tk]; replaces
  the Pallas `decode_cross_attention`.
- decode_cross_attention_q8 (K3) and decode_cross_attention_q4 (K6),
  csrc/decode_cross_attention_q.cu: the same over int8 K/V, or int4 K/V
  packed two per byte, with one f32 scale per position; replace the
  Pallas `decode_cross_attention_q8` and `decode_cross_attention_q4`.
- multihead_attention: the dispatcher.

A kernel wrapper takes its plain version for tensors on the CPU only; on a
CUDA tensor it launches the kernel or raises. Each wrapper counts its
launches in `<wrapper>.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_NEG_INF = -1e30


def attention_reference(q, k, v, causal: bool = False,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain attention. q: [B, H, Tq, D]; k/v: [B, H, Tk, D]. Scores and
    softmax in f32; probabilities cast to v's dtype for the PV product,
    which accumulates in f32."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    tq, tk = q.shape[2], k.shape[2]
    dev = q.device
    if kv_len is not None and kv_len < tk:
        mask = torch.arange(tk, device=dev)[None, :] < kv_len
        scores = torch.where(mask, scores, _NEG_INF)
    if causal:
        cmask = (torch.arange(tq, device=dev)[:, None]
                 >= torch.arange(tk, device=dev)[None, :] - (tk - tq))
        scores = torch.where(cmask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# K1: encoder self-attention
# ---------------------------------------------------------------------------


def flash_attention_fullkv_plain(q, k, v, causal: bool = False,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K1: f32 scores, masked softmax numerator, P cast to v's dtype
    for PV, 1/l applied after PV (the TPU kernel's order)."""
    tq, tk = q.shape[2], k.shape[2]
    kv_len = tk if kv_len is None else kv_len
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    col = torch.arange(tk, device=dev)[None, :]
    keep = col < kv_len
    if causal:
        keep = keep & (torch.arange(tq, device=dev)[:, None] >= col)
    s = torch.where(keep, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def _check_attn_operand(name, t, d):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype} "
                        "(the kernel has no other form; run the model in bf16)")
    if t.shape[-1] != d or t.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be {d} and contiguous")
    if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides must be multiples of 8 elements "
                         "and the data 16-byte aligned")


def flash_attention_fullkv(q, k, v, causal: bool = False,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """q [B, H, Tq, 64], k/v [B, H, Tk, 64] (strided views allowed, head dim
    contiguous) -> [B, H, Tq, 64]. On CUDA the result is a view of a
    [B, Tq, H, 64] buffer, so merging heads afterwards copies nothing."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_plain(q, k, v, causal, kv_len)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    kv_len = tk if kv_len is None else kv_len
    if d != 64:
        raise ValueError(f"flash_attention_fullkv: head dim {d} != 64")
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError("flash_attention_fullkv: q/k/v shapes disagree")
    if not 1 <= kv_len <= tk:
        raise ValueError(f"flash_attention_fullkv: kv_len {kv_len} not in [1, {tk}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("flash_attention_fullkv: operands on different devices")
        _check_attn_operand(name, t, d)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(lib.spt_fullkv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, tk, kv_len, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), "spt_fullkv_attention")
    flash_attention_fullkv.launches += 1
    return out.permute(0, 2, 1, 3)


flash_attention_fullkv.launches = 0


def multihead_attention(q, k, v, causal: bool = False,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Dispatch on shape alone, as the reference's multihead_attention
    does: K1 at encoder scale (tq >= 128, Dh 64 or 128); the plain
    reference for short sequences (the decoder's causal prefill) and other
    head dims. K1's wrapper raises on CUDA for what its kernel does not
    take (a dtype other than bf16, Dh 128). Inputs [B, H, T, D]."""
    tq, d = q.shape[2], q.shape[3]
    if d in (64, 128) and tq >= 128:
        return flash_attention_fullkv(q, k, v, causal=causal, kv_len=kv_len)
    return attention_reference(q, k, v, causal=causal, kv_len=kv_len)


# ---------------------------------------------------------------------------
# K4: decode cross-attention (bf16, decode layout)
# ---------------------------------------------------------------------------


def decode_cross_attention_plain(q, k, v,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K4. q [B, H, R, D] pre-scaled by D^-0.5; k/v [B, H, D, Tk]."""
    tk = k.shape[3]
    kv_len = tk if kv_len is None else kv_len
    kr, vr = k[..., :kv_len], v[..., :kv_len]
    s = torch.matmul(q.float(), kr.float())  # [B, H, R, kv_len]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vr.float().transpose(-1, -2))
    return (o / l).to(q.dtype)


def _check_decode_cross(name, q, kv, scales, rows, kv_dtype, kv_len):
    """Checks shared by K4, K3 and K6 on CUDA: q [B, H, R<=8, 64] bf16
    with its head dim contiguous; kv = (k, v), each contiguous
    [B, H, rows, Tk] of kv_dtype; scales = (ks, vs), each contiguous f32
    [B, H, Tk], or () for bf16 K/V. Returns kv_len (Tk when None)."""
    b, h, r, d = q.shape
    tk = kv[0].shape[3]
    kv_len = tk if kv_len is None else kv_len
    if d != 64 or not 1 <= r <= 8:
        raise ValueError(f"{name}: needs Dh=64 and 1..8 rows, got {tuple(q.shape)}")
    if any(t.shape != (b, h, rows, tk) for t in kv):
        raise ValueError(f"{name}: K/V must be [{b}, {h}, {rows}, Tk], got "
                         f"{[tuple(t.shape) for t in kv]}")
    if any(t.shape != (b, h, tk) for t in scales):
        raise ValueError(f"{name}: scales must be [{b}, {h}, {tk}]")
    if not 1 <= kv_len <= tk:
        raise ValueError(f"{name}: kv_len={kv_len} not in [1, {tk}]")
    operands = [("q", q, torch.bfloat16)]
    operands += [(label, t, kv_dtype) for label, t in zip("kv", kv)]
    operands += [(f"{label} scale", t, torch.float32)
                 for label, t in zip("kv", scales)]
    for label, t, dtype in operands:
        if t.dtype != dtype or t.device != q.device:
            raise TypeError(f"{name}: {label} must be {dtype} on {q.device}, "
                            f"got {t.dtype} on {t.device} (the kernel has no "
                            "other form; run the model in bf16)")
    if q.stride(-1) != 1 or not all(t.is_contiguous() for t in (*kv, *scales)):
        raise ValueError(f"{name}: q's head dim, K/V and scales must be contiguous")
    return kv_len


def decode_cross_attention(q, k, v,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """q [B, H, R<=8, 64] (head dim contiguous); k/v contiguous
    [B, H, 64, Tk] bf16 with Tk even -> [B, H, R, 64]. On CUDA the result
    is a view of a [B, R, H, 64] buffer."""
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, k, v, kv_len)
    b, h, r, d = q.shape
    tk = k.shape[3]
    kv_len = _check_decode_cross("decode_cross_attention", q, (k, v), (), d,
                                 torch.bfloat16, kv_len)
    if tk % 2:
        raise ValueError(f"decode_cross_attention: Tk={tk} must be even")
    if r * ((kv_len + 1) & ~1) * 4 > 200 * 1024:
        raise ValueError("decode_cross_attention: score rows exceed shared memory")
    out = torch.empty((b, r, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(lib.spt_decode_cross_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, r, tk, kv_len, *q.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), "spt_decode_cross_attention")
    decode_cross_attention.launches += 1
    return out.permute(0, 2, 1, 3)


decode_cross_attention.launches = 0


# ---------------------------------------------------------------------------
# K3 and K6: decode cross-attention over int8 and packed int4 K/V
# ---------------------------------------------------------------------------


# Time positions per block of K3/K6 (kChunk in the source).
_QUANT_CHUNK = 256


def decode_cross_attention_q8_plain(q, qk, ks, qv, vs,
                                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K3. q [B, H, R, D] pre-scaled by D^-0.5; qk/qv int8
    [B, H, D, Tk]; ks/vs f32 [B, H, Tk]. The TPU kernel's function:
    s = (q . qK) * ks, masked to t < kv_len before the max, p = exp(s - m),
    o = ((p * vs) rounded to bf16) . qV / l."""
    tk = qk.shape[3]
    kv_len = tk if kv_len is None else kv_len
    s = torch.matmul(q.float(), qk[..., :kv_len].float()) * ks[..., None, :kv_len]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[..., None, :kv_len]).to(torch.bfloat16).float()
    o = torch.matmul(pv, qv[..., :kv_len].float().transpose(-1, -2))
    return (o / l).to(q.dtype)


def decode_cross_attention_q4_plain(q, qk, ks, qv, vs,
                                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K6: K3 on K/V packed two int4 values per byte, qk/qv int8
    [B, H, D/2, Tk] (ops/quant.py:quantize_kv_int4)."""
    from .quant import unpack_kv_int4

    return decode_cross_attention_q8_plain(q, unpack_kv_int4(qk), ks,
                                           unpack_kv_int4(qv), vs, kv_len)


def _launch_decode_cross_quant(name, entry, q, qk, ks, qv, vs, kv_len, rows):
    """Checks and launch shared by K3 and K6 (rows: stored K/V rows, 64
    for int8 and 32 for packed int4). Returns the [B, H, R, 64] result
    as a view of a [B, R, H, 64] buffer."""
    b, h, r, d = q.shape
    tk = qk.shape[3]
    kv_len = _check_decode_cross(name, q, (qk, qv), (ks, vs), rows, torch.int8,
                                 kv_len)
    chunks = -(-kv_len // _QUANT_CHUNK)
    part = torch.empty((b * h, chunks, r, d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, r, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(getattr(lib, entry)(
        q.data_ptr(), qk.data_ptr(), ks.data_ptr(), qv.data_ptr(),
        vs.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, h, r, tk, kv_len, *q.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), entry)
    return out.permute(0, 2, 1, 3)


def decode_cross_attention_q8(q, qk, ks, qv, vs,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """K3. q [B, H, R<=8, 64] bf16 pre-scaled by Dh^-0.5 (head dim
    contiguous); qk/qv int8 [B, H, 64, Tk] and ks/vs f32 [B, H, Tk],
    contiguous, any Tk -> [B, H, R, 64]."""
    if q.device.type == "cpu":
        return decode_cross_attention_q8_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross_quant(
        "decode_cross_attention_q8", "spt_decode_cross_attention_q8",
        q, qk, ks, qv, vs, kv_len, q.shape[3])
    decode_cross_attention_q8.launches += 1
    return out


decode_cross_attention_q8.launches = 0


def decode_cross_attention_q4(q, qk, ks, qv, vs,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """K6. As K3 with qk/qv the packed int4 [B, H, 32, Tk]."""
    if q.device.type == "cpu":
        return decode_cross_attention_q4_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross_quant(
        "decode_cross_attention_q4", "spt_decode_cross_attention_q4",
        q, qk, ks, qv, vs, kv_len, q.shape[3] // 2)
    decode_cross_attention_q4.launches += 1
    return out


decode_cross_attention_q4.launches = 0
