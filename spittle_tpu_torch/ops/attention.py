"""Attention ops: the port's kernels K1, K3–K11, K14 and K15 with their plain versions
(port of spittle_tpu/ops/attention.py, and of the decode cross-attention
probe's kernel).

- attention_reference: plain attention (the reference's XLA form).
- flash_attention (K5, csrc/flash_attention.cu): tiled online-softmax
  attention for K/V longer than 4096 positions (a long-window model's
  encoder); replaces the Pallas `flash_attention`. An instance of the
  TMA + wgmma attention core (csrc/attention_sm90.cuh).
- flash_attention_fullkv (K1, csrc/fullkv_attention.cu): encoder
  self-attention; replaces the Pallas `flash_attention_fullkv`. The
  attention core's SplitRows instance, as K5.
- flash_attention_fullkv_f32 and flash_attention_f32 (K1 and K5's route
  at f32, csrc/fullkv_attention_f32.cu): the same functions on f32 q, k, v
  and output, the JAX package's default precision, one kernel on the CUDA
  cores (K/V streamed through shared memory, online softmax in f32).
  flash_attention_fullkv and flash_attention hand an f32 q to them.
- The encoder-attention forms, each replacing the Pallas kernel of the
  same name: flash_attention_fullkv_packed (K8), K1's instance on the
  packed [B, T, H*Dh] projections (csrc/fullkv_attention.cu), and
  flash_attention_fullkv_packed_pair (K9, csrc/fullkv_attention_pair.cu),
  the core's HeadPair instance, two heads per block;
  flash_attention_fullkv_pipe (K10, csrc/fullkv_attention_pipe.cu), K1's
  function on the core's persistent kernel, whose pipeline runs on across
  work items; flash_attention_fullkv_q8 (K7,
  csrc/fullkv_attention_q8.cu), both products int8 on wgmma, K/V resident
  in shared memory up to 1536 positions and streamed past them (q8_form).
- decode_cross_attention (K4): <= 8 query rows against the whole bf16 K/V
  in the decode layout [B, H, Dh, Tk]; replaces the Pallas
  `decode_cross_attention`. The bf16 instance of K3's kernel
  (csrc/decode_cross_attention_mh.cu), on the decoder's rows padded to a
  multiple of 16 bytes (tma_pitch).
- decode_cross_attention_q8 (K3) and decode_cross_attention_q8_mh (K11),
  one kernel (csrc/decode_cross_attention_mh.cu, K4's): the same over int8
  K/V, a batch item's K/V read as one slab of row pitch ld (the decoder
  pads it to a multiple of 16 bytes, tma_pitch) in a persistent grid fed
  by producer warps; replace the Pallas `decode_cross_attention_q8` and
  `mh_q8` of scripts/bench_decode_cross.py.
- decode_cross_attention_q4 (K6): the same over int4 K/V packed two per
  byte, with one f32 scale per position, the int4 instance of that
  kernel, on the decoder's padded rows; replaces the Pallas
  `decode_cross_attention_q4`.
- decode_cross_attention_f32 (K4 over f32 K/V, P unrounded),
  decode_cross_attention_q8_f32q and decode_cross_attention_q4_f32q (K3
  and K6 with an f32 q and output): the f32 instances of the same kernel,
  the JAX package's default precision. K4's, K3's and K6's wrappers hand
  an f32 q to them.
- decode_cross_attention_w8a8 (K14, csrc/decode_cross_attention_w8a8.cu):
  the "w8a8" decoder's cross-attention over int8 K/V with both products
  int8 x int8 -> int32, q and P quantized per row, for any number of
  rows. It replaces no TPU kernel: the reference leaves these products to
  XLA, and PyTorch has no integer matmul on CUDA.
- flash_attention_fullkv_bwd (K15, csrc/fullkv_attention_bwd.cu): K1's
  backward, dq, dk and dv, from K1's o and each row's log-sum-exp. It
  replaces no TPU kernel: the reference's training gradient is XLA's
  transpose of its attention. Under autograd the dispatch runs K1 as an
  autograd Function whose forward is flash_attention_fullkv_lse (K1's
  instance that also stores the log-sum-exp) and whose backward is K15;
  the other kernels have no backward and raise there.
- multihead_attention_packed and multihead_attention: the dispatchers.
  They pick a kernel from the shapes and the encoder-attention form, an
  argument (ENCODER_ATTENTION_FORMS), never the environment.

A kernel wrapper takes its plain version for tensors on the CPU only; on a
CUDA tensor it launches the kernel or raises. Each wrapper counts its
launches in `<wrapper>.launches` (an f32 entry on its own counter, not on
the bf16 wrapper's that handed it the call). At f32 on the card the forms
"q8", "packed", "pair" and "pipe" (K7-K10) and K1 under autograd (K15)
raise: they have no f32 kernel yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build

_NEG_INF = -1e30

# The encoder-attention forms and the reference's environment settings
# they stand for: "fullkv" none (K1), "q8" SPITTLE_ATTN_Q8=1 (K7),
# "packed" SPITTLE_PACKED_ATTENTION=1 (K8), "pair"
# SPITTLE_PACKED_ATTENTION=pair (K9), "pipe" SPITTLE_ATTN_PIPE=1 (K10).
# The reference checks the packed settings first, then q8, then pipe;
# the port takes one form at a time.
ENCODER_ATTENTION_FORMS = ("fullkv", "q8", "packed", "pair", "pipe")
# The full-KV kernels take K/V up to this length; longer goes to the
# tiled flash kernel (K5), whatever the form, as in the reference.
_FULLKV_MAX_KV = 4096
# The reference's tile sizes for K5.
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def check_encoder_attention(form: str) -> str:
    if form not in ENCODER_ATTENTION_FORMS:
        raise ValueError(f"encoder_attention must be one of "
                         f"{ENCODER_ATTENTION_FORMS}, got {form!r}")
    return form


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, H*Dh] -> [B, H, T, Dh] (a view)."""
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, H*Dh] (free when x views a [B, T, H, Dh]
    buffer, as the attention kernels return)."""
    b, h, t, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dh)


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


def _fullkv_scores(q, k, causal: bool, kv_len: Optional[int]) -> torch.Tensor:
    """K1's f32 scores q k^T with its masks (col < kv_len; row >= col on
    absolute indices under `causal`) set to -inf."""
    tq, tk = q.shape[2], k.shape[2]
    kv_len = tk if kv_len is None else kv_len
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    col = torch.arange(tk, device=dev)[None, :]
    keep = col < kv_len
    if causal:
        keep = keep & (torch.arange(tq, device=dev)[:, None] >= col)
    return torch.where(keep, s, float("-inf"))


def _fullkv_softmax_out(s, v, dtype) -> torch.Tensor:
    """K1's output from its masked scores: the softmax numerator, P cast
    to v's dtype for PV, 1/l applied after PV (the TPU kernel's order)."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(dtype)


def flash_attention_fullkv_plain(q, k, v, causal: bool = False,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K1: f32 scores, masked softmax numerator, P cast to v's dtype
    for PV, 1/l applied after PV (the TPU kernel's order)."""
    return _fullkv_softmax_out(_fullkv_scores(q, k, causal, kv_len), v, q.dtype)


def flash_attention_fullkv_lse_plain(q, k, v, causal: bool = False,
                                     kv_len: Optional[int] = None):
    """Plain K1 with each row's log-sum-exp: (flash_attention_fullkv_plain's
    o, lse [B, H, Tq] f32, torch.logsumexp of the masked f32 scores)."""
    s = _fullkv_scores(q, k, causal, kv_len)
    return _fullkv_softmax_out(s, v, q.dtype), torch.logsumexp(s, dim=-1)


def _head_view_ok(t) -> bool:
    """A tensor the attention kernels read in place: head dim contiguous,
    strides multiples of 8 elements, data 16-byte aligned (their 16-byte
    loads and the core's TMA tensor maps need it)."""
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_attn_operand(name, t, d, dtype=torch.bfloat16):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on CUDA, got {t.dtype} (this "
                        "kernel's form; f32 goes to the f32 entries, "
                        "flash_attention_fullkv_f32 and flash_attention_f32)")
    if t.shape[-1] != d or t.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be {d} and contiguous")
    if not _head_view_ok(t):
        raise ValueError(f"{name}: strides must be multiples of 8 elements "
                         "and the data 16-byte aligned")


# The wgmma attention core (K1, K5, K8, K9) puts batch x head groups on
# the grid's y axis, which CUDA caps at 65535; its x axis holds the query
# blocks, so that blocks of one head run side by side and share its K/V
# in L2.
_SM90_MAX_GROUPS = 65535


def _check_sm90_groups(name, groups):
    if groups > _SM90_MAX_GROUPS:
        raise ValueError(f"{name}: {groups} (batch x head groups) blocks on the "
                         f"grid's y axis, past CUDA's {_SM90_MAX_GROUPS}")


def _check_split_qkv(name, q, k, v, kv_len, dtype=torch.bfloat16):
    """Checks shared by K1, K5, K7 and K10 (and K1's f32 form) on CUDA: q
    [B, H, Tq, 64] and k/v [B, H, Tk, 64] of `dtype` on one device, head
    dim contiguous. Returns kv_len (Tk when None)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    kv_len = tk if kv_len is None else kv_len
    if d != 64:
        raise ValueError(f"{name}: head dim {d} != 64")
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q/k/v shapes disagree")
    if not 1 <= kv_len <= tk:
        raise ValueError(f"{name}: kv_len {kv_len} not in [1, {tk}]")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
        _check_attn_operand(label, t, d, dtype)
    return kv_len


def _fullkv_launch(q, k, v, causal, kv_len, with_lse: bool):
    """Launches K1 on CUDA tensors: spt_fullkv_attention, or with_lse
    spt_fullkv_attention_lse (the same instance, its epilogue also storing
    m + ln(l) per row into a [B * H, Tq] f32 buffer, so o keeps K1's
    bits). Counts one K1 launch. Returns (o, lse or None)."""
    kv_len = _check_split_qkv("flash_attention_fullkv", q, k, v, kv_len)
    b, h, tq, d = q.shape
    _check_sm90_groups("flash_attention_fullkv", b * h)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    args = (b, h, tq, k.shape[2], kv_len, int(causal),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            out.stride(0), out.stride(2), out.stride(1),
            _build.stream_ptr(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    lib = _build.load_library()
    lse = None
    if with_lse:
        lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
        _build.check(lib.spt_fullkv_attention_lse(*ptrs, lse.data_ptr(), *args),
                     "spt_fullkv_attention_lse")
        lse = lse.view(b, h, tq)
    else:
        _build.check(lib.spt_fullkv_attention(*ptrs, *args), "spt_fullkv_attention")
    flash_attention_fullkv.launches += 1
    return out.permute(0, 2, 1, 3), lse


def flash_attention_fullkv(q, k, v, causal: bool = False,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """K1. q [B, H, Tq, 64], k/v [B, H, Tk, 64], q and k pre-scaled
    (strided views allowed, head dim contiguous) -> [B, H, Tq, 64]. On
    CUDA the result is a view of a [B, Tq, H, 64] buffer, so merging heads
    afterwards copies nothing. The kernel is the attention core's SplitRows
    instance (128 query rows of one head per block, 128-key tiles), K5's
    policy and tile, so on the same inputs it gives K5's bits; bf16, and
    B * H at most 65535 (the grid's y axis), else it raises. An f32 q goes
    to flash_attention_fullkv_f32 (K1's f32 form)."""
    if q.dtype == torch.float32:
        return flash_attention_fullkv_f32(q, k, v, causal, kv_len)
    if q.device.type == "cpu":
        return flash_attention_fullkv_plain(q, k, v, causal, kv_len)
    return _fullkv_launch(q, k, v, causal, kv_len, with_lse=False)[0]


def flash_attention_fullkv_lse(q, k, v, causal: bool = False,
                               kv_len: Optional[int] = None):
    """K1 with each row's log-sum-exp (its forward under autograd, for
    K15): (o, lse), o as flash_attention_fullkv gives it, bit for bit, and
    lse [B, H, Tq] f32 (on CUDA a view of a [B * H, Tq] buffer). One K1
    launch, counted on flash_attention_fullkv.launches."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_lse_plain(q, k, v, causal, kv_len)
    return _fullkv_launch(q, k, v, causal, kv_len, with_lse=True)


flash_attention_fullkv.launches = 0


# ---------------------------------------------------------------------------
# K1 and K5's route at f32
# ---------------------------------------------------------------------------


def _fullkv_f32_launch(name, q, k, v, causal, kv_len) -> torch.Tensor:
    """One launch of spt_fullkv_attention_f32 on CUDA tensors: f32 q [B, H,
    Tq, 64] and k/v [B, H, Tk, 64] (strided views as K1 takes them) ->
    [B, H, Tq, 64], a view of a [B, Tq, H, 64] buffer."""
    kv_len = _check_split_qkv(name, q, k, v, kv_len, torch.float32)
    b, h, tq, d = q.shape
    _check_sm90_groups(name, b * h)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(lib.spt_fullkv_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, k.shape[2], kv_len, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), "spt_fullkv_attention_f32")
    return out.permute(0, 2, 1, 3)


def flash_attention_fullkv_f32(q, k, v, causal: bool = False,
                               kv_len: Optional[int] = None) -> torch.Tensor:
    """K1 at f32 (csrc/fullkv_attention_f32.cu): q [B, H, Tq, 64], k/v
    [B, H, Tk, 64] f32, q and k pre-scaled (strided views allowed, head
    dim contiguous) -> [B, H, Tq, 64] f32, on CUDA a view of a [B, Tq, H,
    64] buffer. Its plain version is K1's (f32 end to end, as the Pallas
    kernel on f32 inputs). The kernel streams K/V in tiles of 64 keys with
    an online softmax, all f32 on the CUDA cores (no TF32); B * H at most
    65535. No backward: under autograd the card raises (K15 has no f32
    form)."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_plain(q, k, v, causal, kv_len)
    out = _fullkv_f32_launch("flash_attention_fullkv_f32", q, k, v, causal,
                             kv_len)
    flash_attention_fullkv_f32.launches += 1
    return out


flash_attention_fullkv_f32.launches = 0


def flash_attention_f32(q, k, v, causal: bool = False,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """K5's route at f32 (K/V past 4096 positions): K5's function on f32
    q, k, v (its plain version, flash_attention_plain, on the CPU), on the
    card the kernel of flash_attention_fullkv_f32, which streams K/V at any
    length. Shapes and layout as K1's f32 form."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, kv_len)
    out = _fullkv_f32_launch("flash_attention_f32", q, k, v, causal, kv_len)
    flash_attention_f32.launches += 1
    return out


flash_attention_f32.launches = 0


def _f32_unported(what: str, q) -> None:
    """Raise for an f32 CUDA tensor on a route whose kernel has no f32
    form yet (the CPU's plain versions take f32)."""
    if q.dtype == torch.float32 and q.device.type != "cpu":
        raise NotImplementedError(
            f"{what} is not yet ported at f32: on the card it takes bf16 "
            "only (an f32 model runs the 'fullkv' form, without gradients)")


# ---------------------------------------------------------------------------
# K15: K1's backward, and K1 under autograd
# ---------------------------------------------------------------------------


def flash_attention_fullkv_bwd_plain(q, k, v, o, do, lse, causal: bool = False,
                                     kv_len: Optional[int] = None):
    """Plain K15: the gradient of o = softmax(q k^T) v under K1's masks
    (col < kv_len; row >= col on absolute indices under `causal`), as the
    explicit formulae in f32 from K1's o and lse ([B, H, Tq], each row's
    log-sum-exp): P = exp(S - lse), dV = P^T dO, dP = dO V^T, D =
    rowsum(dO * o), dS = P * (dP - D), dQ = dS K, dK = dS^T Q. Masked
    positions have P = 0, so keys at or past kv_len get a zero gradient.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = _fullkv_scores(q, k, causal, kv_len)
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dof * o.float()).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fullkv_bwd(q, k, v, o, do, lse, causal: bool = False,
                               kv_len: Optional[int] = None):
    """K15 (csrc/fullkv_attention_bwd.cu): (dq, dk, dv) of K1's attention.
    q, o, do [B, H, Tq, 64] and k/v [B, H, Tk, 64] bf16, q and k
    pre-scaled, strided views as K1 takes them; o and lse ([B, H, Tq] f32,
    contiguous) are flash_attention_fullkv_lse's. On CUDA each gradient is
    a view of a [B, T, H, 64] buffer (the packed projections' layout) and
    B * H is at most 65535. Two launches, both TMA + wgmma: the rows pass
    (rowsum(dO * o) into f32 scratch, then dQ) and the columns pass (dK,
    dV); no atomics, so two calls give the same bits."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_bwd_plain(q, k, v, o, do, lse, causal,
                                                kv_len)
    name = "flash_attention_fullkv_bwd"
    kv_len = _check_split_qkv(name, q, k, v, kv_len)
    for label, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: {label} must be q's shape on q's device")
        _check_attn_operand(label, t, 64)
    b, h, tq, d = q.shape
    if (lse.shape != (b, h, tq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be contiguous f32 [B, H, Tq] on "
                         "q's device (flash_attention_fullkv_lse's)")
    tk = k.shape[2]
    _check_sm90_groups(name, b * h)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dd = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    grads = [t.permute(0, 2, 1, 3) for t in (dq, dk, dv)]
    lib = _build.load_library()
    _build.check(lib.spt_fullkv_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), b, h, tq, tk, kv_len, int(causal),
        *(s for t in (q, k, v, o, do, *grads) for s in t.stride()[:3]),
        _build.stream_ptr(q.device),
    ), "spt_fullkv_attention_bwd")
    flash_attention_fullkv_bwd.launches += 1
    return tuple(grads)


flash_attention_fullkv_bwd.launches = 0


class _FullKVAttention(torch.autograd.Function):
    """K1 forward, K15 backward (their plain versions for CPU tensors).
    When q, k or v needs a gradient the forward is K1's instance that also
    writes each row's log-sum-exp, for K15; otherwise it is K1 itself."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len):
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_fullkv(q, k, v, causal, kv_len)
        o, lse = flash_attention_fullkv_lse(q, k, v, causal, kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kv_len = causal, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type != "cpu" and not _head_view_ok(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_fullkv_bwd(q, k, v, o, do, lse,
                                                ctx.causal, ctx.kv_len)
        return dq, dk, dv, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(kernel: str, *tensors) -> None:
    """Raise when a gradient would have to pass through a kernel that has
    no backward (on every device, so that the CPU takes the card's route)."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{kernel} has no backward kernel: under autograd, attention runs "
            "only as K1 (the 'fullkv' form, K/V up to "
            f"{_FULLKV_MAX_KV} positions) or on plain ops")


# ---------------------------------------------------------------------------
# K5: tiled online-softmax attention (K/V longer than 4096)
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, causal: bool = False,
                          kv_len: Optional[int] = None,
                          block_q: int = DEFAULT_BLOCK_Q,
                          block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Plain K5: the reference kernel's loop over key tiles of block_k,
    in its rounding order. Per tile: f32 scores, the mask (col < kv_len,
    and under `causal` row >= col on absolute indices, with no Tk - Tq
    offset) set to -1e30 before the max; m' = max(m, tile max), alpha =
    exp(m - m'), p = exp(s - m'), l = l * alpha + sum p, acc = acc * alpha
    + (p in v's dtype) . v; acc / l at the end. A last tile shorter than
    block_k stands for the reference's zero padding, whose columns are
    masked. block_q only shapes the TPU grid: rows are independent."""
    del block_q
    b, h, tq, d = q.shape
    tk = k.shape[2]
    kv_len = tk if kv_len is None else kv_len
    dev = q.device
    qf = q.float()
    row = torch.arange(tq, device=dev)[:, None]
    m = torch.full((b, h, tq, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    for k0 in range(0, tk, block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = torch.matmul(qf, kt.float().transpose(-1, -2))
        col = k0 + torch.arange(kt.shape[2], device=dev)[None, :]
        keep = col < kv_len
        if causal:
            keep = keep & (row >= col)
        s = torch.where(keep, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (acc / l).to(q.dtype)


def flash_attention(q, k, v, causal: bool = False,
                    kv_len: Optional[int] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """K5: tiled online-softmax attention. q [B, H, Tq, 64], k/v [B, H,
    Tk, 64], q and k pre-scaled (strided views allowed, head dim
    contiguous) -> [B, H, Tq, 64], on CUDA a view of a [B, Tq, H, 64]
    buffer. Any Tq and Tk: the kernel masks its own ragged tiles where the
    reference pads to multiples of 128. On CUDA bf16, and block_k must be
    the kernel's 128 (it sets where the running max advances, so the
    rounding); block_q changes no value and is not used. An f32 q goes to
    flash_attention_f32 (K5's route at f32, any tile)."""
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v, causal, kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, kv_len, block_q, block_k)
    if block_k != DEFAULT_BLOCK_K:
        raise ValueError(f"flash_attention: block_k {block_k} != "
                         f"{DEFAULT_BLOCK_K}, the kernel's key tile")
    kv_len = _check_split_qkv("flash_attention", q, k, v, kv_len)
    b, h, tq, d = q.shape
    _check_sm90_groups("flash_attention", b * h)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(lib.spt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, k.shape[2], kv_len, int(causal),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), "spt_flash_attention")
    flash_attention.launches += 1
    return out.permute(0, 2, 1, 3)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# K10: K1 on a persistent, cross-item pipeline (non-causal)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    """The card's SM count: the size of the persistent kernels' grids."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_fullkv_pipe(q, k, v,
                                kv_len: Optional[int] = None) -> torch.Tensor:
    """K10: K1's function for a non-causal call, shapes and result as
    flash_attention_fullkv's. Its plain version is K1's: the two compute
    the same function (the reference's pipelined kernel reorders the
    schedule, not the arithmetic). The kernel is the attention core's
    persistent instance on K1's policy and tiles, one block per SM walking
    K1's work items, so it gives K1's bits; bf16 only. Its grid is the SM
    count, so K1's cap of 65535 on B * H does not apply."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_plain(q, k, v, False, kv_len)
    kv_len = _check_split_qkv("flash_attention_fullkv_pipe", q, k, v, kv_len)
    b, h, tq, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(lib.spt_fullkv_attention_pipe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, tq, k.shape[2], kv_len, _num_sms(q.device.index),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), "spt_fullkv_attention_pipe")
    flash_attention_fullkv_pipe.launches += 1
    return out.permute(0, 2, 1, 3)


flash_attention_fullkv_pipe.launches = 0


# ---------------------------------------------------------------------------
# K7: int8-dot encoder attention (non-causal)
# ---------------------------------------------------------------------------


def _q8_probs(q, k, v, kv_len: int):
    """K7's first steps in the reference's arithmetic, on the K that its
    dispatcher hands the TPU kernel: padded with zero rows to a multiple
    of 128. Those rows score exactly 0, so 0 enters the unmasked row max
    when Tk % 128 != 0 (q's pad rows are dropped and change nothing).
    q, k and v are quantized per row over Dh by the reference's
    _quantize_rows_i8 rule, which is quantize_kv_t's. Returns p =
    exp(s - m) masked to col < kv_len, V's codes and V's scales."""
    from .quant import quantize_kv_t

    tk = k.shape[2]
    q8, k8, v8 = (quantize_kv_t(x) for x in (q, k, v))
    # int8 codes as f32: every product and partial sum is an integer below
    # 2**24, so this is the int32 dot, exactly.
    s = torch.matmul(q8["qw"].float(), k8["qw"].float().transpose(-1, -2))
    s = s * q8["scale"][..., :, None] * k8["scale"][..., None, :]
    m = s.amax(dim=-1, keepdim=True)
    if tk % 128:
        m = torch.clamp_min(m, 0.0)
    p = torch.exp(s - m)
    if kv_len < tk:
        p = p * (torch.arange(tk, device=q.device) < kv_len)
    return p, v8["qw"], v8["scale"]


def flash_attention_fullkv_q8_plain(q, k, v,
                                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K7: the reference's arithmetic step by step. q/k/v
    [B, H, T, D] (q and k pre-scaled) -> [B, H, Tq, D] in q's dtype."""
    from .quant import _scale

    kv_len = k.shape[2] if kv_len is None else kv_len
    p, v8, vs = _q8_probs(q, k, v, kv_len)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * vs[..., None, :]
    sp = _scale(pv.amax(dim=-1, keepdim=True), 127.0)
    p8 = torch.round(pv / sp)
    # f64: the int32 sums may pass 2**24; one rounding to f32 after, as
    # the reference's o_i32.astype(f32).
    o = torch.matmul(p8.double(), v8.double()).float()
    return ((o * sp) / l).to(q.dtype)


def q8_code_step(q, k, v, kv_len: Optional[int] = None) -> torch.Tensor:
    """Per query row [B, H, Tq]: mp/l, the most that one of K7's P codes
    moved by one shifts that row's outputs (|v8| <= 127 times sp = mp/127,
    over l). Two computations of K7 whose exp differs in the last bit
    differ by this step where p*vs/sp lands on a rounding boundary;
    comparisons of K7 allow one per row."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    p, _, vs = _q8_probs(q, k, v, kv_len)
    return (p * vs[..., None, :]).amax(dim=-1) / p.sum(dim=-1)


# K/V positions that K7 keeps resident in shared memory (12 key tiles of
# 128; kStages in its source).
_Q8_RESIDENT_KV = 1536


def q8_form(tk: int) -> str:
    """K7's form for K/V of tk positions, from the shape alone: "resident"
    (a head's int8 K and Vt loaded once into shared memory, tk <= 1536)
    or "streamed" (every pass streams them through the same stages)."""
    return "resident" if -(-tk // 128) * 128 <= _Q8_RESIDENT_KV else "streamed"


def _q8_buffers(q, k) -> dict:
    """K7's buffers for q [B, H, Tq, 64] and k [B, H, Tk, 64]: the int8
    operands q8 [B, H, Tq, 64], k8 [B, H, Tk, 64] and v8t [B, H, 64, Tpad]
    (V transposed), their f32 scales qs [B, H, Tqpad], ks and vs [B, H,
    Tpad] (Tq and Tk rounded up to 128), and the output out [B, Tq, H,
    64] in q's dtype."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    tqpad, tpad = (-(-t // 128) * 128 for t in (tq, tk))
    dev = q.device
    bufs = {
        "q8": torch.empty((b, h, tq, d), dtype=torch.int8, device=dev),
        "k8": torch.empty((b, h, tk, d), dtype=torch.int8, device=dev),
        "v8t": torch.empty((b, h, d, tpad), dtype=torch.int8, device=dev),
        "out": torch.empty((b, tq, h, d), dtype=q.dtype, device=dev),
    }
    for key, t in (("qs", tqpad), ("ks", tpad), ("vs", tpad)):
        bufs[key] = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    return bufs


def _q8_quantize(entry, q, k, v, bufs: dict) -> None:
    """K7's three row-quantizer launches through `entry` (a loaded
    library's spt_fullkv_q8_quantize) into _q8_buffers' operands and
    scales: V written transposed, the scales padded to 128 positions."""
    b, h = q.shape[:2]
    stream = _build.stream_ptr(q.device)
    for x, x8, scale, transposed in ((q, "q8", "qs", 0), (k, "k8", "ks", 0),
                                     (v, "v8t", "vs", 1)):
        _build.check(entry(
            x.data_ptr(), *x.stride()[:3], b, h, x.shape[2],
            bufs[scale].shape[2], bufs[x8].data_ptr(), bufs[scale].data_ptr(),
            transposed, stream,
        ), "spt_fullkv_q8_quantize")


def _q8_attend(entry, bufs: dict, kv_len: int) -> None:
    """K7's attention launch through `entry` (a loaded library's
    spt_fullkv_attention_q8) on quantized _q8_buffers, into bufs["out"],
    in q8_form's form for their K/V length."""
    b, h, tq, _ = bufs["q8"].shape
    tk, tpad = bufs["k8"].shape[2], bufs["v8t"].shape[3]
    out = bufs["out"]
    _build.check(entry(
        bufs["q8"].data_ptr(), bufs["qs"].data_ptr(), bufs["k8"].data_ptr(),
        bufs["ks"].data_ptr(), bufs["v8t"].data_ptr(), bufs["vs"].data_ptr(),
        out.data_ptr(), b, h, tq, tk, tpad, kv_len, int(tk % 128 != 0),
        int(q8_form(tk) == "resident"), _num_sms(out.device.index),
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(out.device),
    ), "spt_fullkv_attention_q8")


def flash_attention_fullkv_q8(q, k, v,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """K7: int8-dot full-KV attention, non-causal. q [B, H, Tq, 64], k/v
    [B, H, Tk, 64] bf16 (strided views allowed, head dim contiguous) ->
    [B, H, Tq, 64], on CUDA a view of a [B, Tq, H, 64] buffer. The
    function is flash_attention_fullkv_q8_plain's; on the card the wrapper
    quantizes q, k and v (three launches of the K7 source's row quantizer,
    V written transposed, the scales padded to 128 positions) before the
    attention launch, as the reference's function quantizes before its
    kernel."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_q8_plain(q, k, v, kv_len)
    kv_len = _check_split_qkv("flash_attention_fullkv_q8", q, k, v, kv_len)
    bufs = _q8_buffers(q, k)
    lib = _build.load_library()
    _q8_quantize(lib.spt_fullkv_q8_quantize, q, k, v, bufs)
    _q8_attend(lib.spt_fullkv_attention_q8, bufs, kv_len)
    flash_attention_fullkv_q8.launches += 1
    return bufs["out"].permute(0, 2, 1, 3)


flash_attention_fullkv_q8.launches = 0


# ---------------------------------------------------------------------------
# K8 and K9: K1's function on the packed [B, T, H*Dh] projections
# ---------------------------------------------------------------------------


def flash_attention_fullkv_packed_plain(q, k, v, n_head: int,
                                        causal: bool = False,
                                        kv_len: Optional[int] = None
                                        ) -> torch.Tensor:
    """Plain K8 and K9 (one function, two kernels): K1's per head of the
    packed q [B, Tq, H*Dh] and k/v [B, Tk, H*Dh] -> [B, Tq, H*Dh]."""
    o = flash_attention_fullkv_plain(
        split_heads(q, n_head), split_heads(k, n_head),
        split_heads(v, n_head), causal, kv_len)
    return merge_heads(o)


def _launch_packed(name, entry, q, k, v, n_head, causal, kv_len,
                   heads_per_block):
    """Checks and launch shared by K8 and K9: contiguous bf16 q [B, Tq,
    H*64] and k/v [B, Tk, H*64] on one device -> a new [B, Tq, H*64]."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    kv_len = tk if kv_len is None else kv_len
    if hd != 64 * n_head:
        raise ValueError(f"{name}: head dim {hd // n_head} != 64")
    if n_head % heads_per_block:
        raise ValueError(f"{name}: needs an even head count, got {n_head}")
    if k.shape != (b, tk, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: q/k/v shapes disagree")
    if not 1 <= kv_len <= tk:
        raise ValueError(f"{name}: kv_len {kv_len} not in [1, {tk}]")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
        _check_attn_operand(label, t, hd)
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous "
                             "[B, T, H*64] tensor")
    out = torch.empty_like(q)
    lib = _build.load_library()
    _build.check(getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n_head, tq, tk, kv_len, int(causal), _build.stream_ptr(q.device),
    ), entry)
    return out


def flash_attention_fullkv_packed(q, k, v, n_head: int, causal: bool = False,
                                  kv_len: Optional[int] = None) -> torch.Tensor:
    """K8: K1 per head, reading and writing the packed layout. q [B, Tq,
    H*64], k/v [B, Tk, H*64], contiguous bf16 on CUDA -> [B, Tq, H*64].
    The kernel is K1's instance of the attention core on the packed
    strides, so it gives K1's bits; B * H at most 65535 (the grid's y
    axis), else it raises."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_packed_plain(q, k, v, n_head, causal, kv_len)
    _check_sm90_groups("flash_attention_fullkv_packed", q.shape[0] * n_head)
    out = _launch_packed("flash_attention_fullkv_packed",
                         "spt_fullkv_attention_packed", q, k, v, n_head,
                         causal, kv_len, 1)
    flash_attention_fullkv_packed.launches += 1
    return out


flash_attention_fullkv_packed.launches = 0


def flash_attention_fullkv_packed_pair(q, k, v, n_head: int,
                                       causal: bool = False,
                                       kv_len: Optional[int] = None
                                       ) -> torch.Tensor:
    """K9: K8's function with two adjacent heads per block, on the wgmma
    attention core; n_head must be even. Held to K1's tolerance: its rows
    take K1's tiles, but its 64-row causal blocks skip other masked
    tiles."""
    if q.device.type == "cpu":
        return flash_attention_fullkv_packed_plain(q, k, v, n_head, causal, kv_len)
    _check_sm90_groups("flash_attention_fullkv_packed_pair",
                       q.shape[0] * (n_head // 2))
    out = _launch_packed("flash_attention_fullkv_packed_pair",
                         "spt_fullkv_attention_packed_pair", q, k, v, n_head,
                         causal, kv_len, 2)
    flash_attention_fullkv_packed_pair.launches += 1
    return out


flash_attention_fullkv_packed_pair.launches = 0


# ---------------------------------------------------------------------------
# The dispatchers
# ---------------------------------------------------------------------------


def _block_q(tq: int) -> int:
    """The reference's q block for its full-KV kernels, which its K10
    gate reads."""
    if tq % 768 == 0 or tq > 1024:
        return 768
    return 512 if tq >= 512 else 128


def multihead_attention(q, k, v, causal: bool = False,
                        kv_len: Optional[int] = None,
                        form: str = "fullkv") -> torch.Tensor:
    """Dispatch on shape and the encoder-attention form, in the order of
    the reference's multihead_attention: plain attention for short
    sequences (the decoder's causal prefill) and head dims other than 64
    and 128; K5 for K/V longer than 4096 under every form; K7 for a
    non-causal call under "q8"; K10 for a non-causal call under "pipe"
    whose q block times Tk rounded up to 128 is at most 768 x 2048 (the
    reference's VMEM gate); K1 otherwise. Causal calls never take K7 or
    K10. A wrapper raises on CUDA for what its kernel does not take (Dh
    128, a dtype it has no form for). Inputs [B, H, T, D]. f32 (the JAX
    package's default precision) takes K1's and K5's f32 forms; at f32 on
    the card the routes to K7 and K10 raise (no f32 form yet).

    K1 runs as its autograd Function, whose backward is K15 (with no
    input that requires grad it records no graph); under autograd a route
    to K5, K7 or K10 raises, since those kernels have no backward, and so
    does f32 on the card (K15 has no f32 form)."""
    check_encoder_attention(form)
    tq, d = q.shape[2], q.shape[3]
    if d not in (64, 128) or tq < 128:
        return attention_reference(q, k, v, causal=causal, kv_len=kv_len)
    tk = k.shape[2]
    if tk > _FULLKV_MAX_KV:
        _no_backward("K5 (flash_attention, K/V past 4096)", q, k, v)
        return flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    if not causal:
        if form == "q8":
            _no_backward("K7 (the 'q8' form)", q, k, v)
            _f32_unported("K7 (the 'q8' form)", q)
            return flash_attention_fullkv_q8(q, k, v, kv_len=kv_len)
        if form == "pipe" and _block_q(tq) * -(-tk // 128) * 128 <= 768 * 2048:
            _no_backward("K10 (the 'pipe' form)", q, k, v)
            _f32_unported("K10 (the 'pipe' form)", q)
            return flash_attention_fullkv_pipe(q, k, v, kv_len=kv_len)
    if _needs_grad(q, k, v):
        _f32_unported("K15 (K1's backward, for attention under autograd)", q)
    return _FullKVAttention.apply(q, k, v, causal, kv_len)


def multihead_attention_packed(q, k, v, n_head: int, causal: bool = False,
                               kv_len: Optional[int] = None,
                               form: str = "fullkv") -> torch.Tensor:
    """The reference's multihead_attention_packed: q/k/v [B, T, H*Dh] (q
    and k pre-scaled) -> [B, T, H*Dh]. K8 under "packed" and K9 under
    "pair", on the packed tensors; the heads split as views into
    multihead_attention under the other forms and wherever the reference
    falls back: "pair" with an odd head count or Dh != 64, Dh not 64 or
    128, tq < 128, Tk > 4096."""
    check_encoder_attention(form)
    b, tq, hd = q.shape
    d = hd // n_head
    if (form not in ("packed", "pair")
            or (form == "pair" and (n_head % 2 or d != 64))
            or d not in (64, 128) or tq < 128 or k.shape[1] > _FULLKV_MAX_KV):
        o = multihead_attention(
            split_heads(q, n_head), split_heads(k, n_head),
            split_heads(v, n_head), causal=causal, kv_len=kv_len, form=form)
        return merge_heads(o)
    _no_backward(f"K{9 if form == 'pair' else 8} (the {form!r} form)", q, k, v)
    _f32_unported(f"K{9 if form == 'pair' else 8} (the {form!r} form)", q)
    kernel = (flash_attention_fullkv_packed_pair if form == "pair"
              else flash_attention_fullkv_packed)
    return kernel(q, k, v, n_head, causal=causal, kv_len=kv_len)


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


def _check_decode_cross(name, q, kv, scales, rows, kv_dtype, kv_len,
                        q_dtype=torch.bfloat16):
    """Checks shared by K4, K3, K6 and K11 (and their f32 forms) on CUDA:
    q [B, H, R<=8, 64] of q_dtype with its head dim contiguous; kv = (k,
    v), each [B, H, rows, Tk] of kv_dtype, rows of any pitch _slab_pitch
    takes; scales = (ks, vs), each contiguous f32 [B, H, Tk], or () for
    bf16 or f32 K/V. Returns kv_len (Tk when None)."""
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
    operands = [("q", q, q_dtype)]
    operands += [(label, t, kv_dtype) for label, t in zip("kv", kv)]
    operands += [(f"{label} scale", t, torch.float32)
                 for label, t in zip("kv", scales)]
    for label, t, dtype in operands:
        if t.dtype != dtype or t.device != q.device:
            raise TypeError(f"{name}: {label} must be {dtype} on {q.device}, "
                            f"got {t.dtype} on {t.device} (this kernel's form; "
                            "an f32 q goes to the f32 entries)")
    if q.stride(-1) != 1 or not all(t.is_contiguous() for t in scales):
        raise ValueError(f"{name}: q's head dim and the scales must be contiguous")
    return kv_len


def decode_cross_attention(q, k, v,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """K4. q [B, H, R<=8, 64] bf16 pre-scaled by Dh^-0.5 (head dim
    contiguous); k/v bf16 [B, H, 64, Tk], contiguous or with rows of a
    pitch that is a multiple of 16 bytes (the decoder's layout,
    tma_pitch); any Tk >= 1 -> [B, H, R, 64], on CUDA a view of a
    [B, R, H, 64] buffer. The kernel is K3's bf16 instance: items of
    (batch item, head pair, 64 positions), so P rounds to bf16 against
    each 64-position chunk's max. An f32 q goes to
    decode_cross_attention_f32 (K4 at f32)."""
    if q.dtype == torch.float32:
        return decode_cross_attention_f32(q, k, v, kv_len)
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, k, v, kv_len)
    out = _launch_decode_cross("decode_cross_attention",
                               "spt_decode_cross_attention", q, k, v, (), kv_len)
    decode_cross_attention.launches += 1
    return out


decode_cross_attention.launches = 0


def decode_cross_attention_f32(q, k, v,
                               kv_len: Optional[int] = None) -> torch.Tensor:
    """K4 at f32, the JAX package's default precision: q [B, H, R<=8, 64]
    f32 pre-scaled by Dh^-0.5; k/v f32 [B, H, 64, Tk], contiguous or with
    rows of a pitch that is a multiple of 16 bytes (the decoder's layout,
    tma_pitch(Tk, 4): 1500 for 1500) -> [B, H, R, 64] f32. Its plain
    version is K4's (f32 end to end). The kernel is K3's f32 instance:
    items of (batch item, head pair, 32 positions), P kept in f32 (the
    Pallas kernel keeps P in V's dtype), the combine in f32."""
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, k, v, kv_len)
    out = _launch_decode_cross("decode_cross_attention_f32",
                               "spt_decode_cross_attention_f32", q, k, v, (),
                               kv_len, q_dtype=torch.float32)
    decode_cross_attention_f32.launches += 1
    return out


decode_cross_attention_f32.launches = 0


# ---------------------------------------------------------------------------
# K3, K6 and K11: decode cross-attention over int8 and packed int4 K/V
# ---------------------------------------------------------------------------


# Bytes of a K/V row per work item and partial record of the decode
# kernel (kSlice in csrc/decode_cross_attention_mh.cu): 128 of int8 (K3,
# K11), bf16 and f32 (K4) and packed int4 (K6, one position per byte).
_ROW_SLICE = 128
# TMA addresses a row only where its pitch and base are multiples of this
# many bytes.
TMA_ALIGN = 16


def item_positions(itemsize: int) -> int:
    """Positions per work item and partial record of K3/K4/K6/K11 (kChunk
    in csrc/decode_cross_attention_mh.cu): 128 of int8 or packed int4
    (itemsize 1), 64 of bf16, 32 of f32."""
    return _ROW_SLICE // itemsize


def tma_pitch(tk: int, itemsize: int = 1) -> int:
    """The row pitch, in elements of `itemsize` bytes, at which rows of tk
    positions can be addressed by TMA: rows rounded up to a multiple of 16
    bytes (1504 for 1500, int8 and bf16 alike; 1500 for f32)."""
    per = TMA_ALIGN // itemsize
    return -(-tk // per) * per


def decode_cross_load_path(pitch: int, *addresses: int) -> str:
    """K3/K4/K6/K11's load path for K/V slabs whose rows lie `pitch` bytes
    apart (ld times the element size) at the given base addresses: "tma"
    (one box per item's K and V) where the pitch and every address are
    multiples of 16 bytes, "cp.async" (16-byte covers of each row's slice)
    otherwise."""
    aligned = all(a % TMA_ALIGN == 0 for a in (pitch, *addresses))
    return "tma" if aligned else "cp.async"


def _slab_pitch(name, kv) -> int:
    """The row pitch ld (elements) of K/V [B, H, rows, Tk] (rows 64, or
    32 of packed int4) that K3/K4/K6/K11 read as one slab per batch item:
    strides (H*rows*ld, rows*ld, ld, 1), alike for K and V, with ld = Tk
    (contiguous) or, past it, a pitch whose rows are a multiple of 16
    bytes (the decoder's padded rows, tma_pitch). Strides of dimensions
    of size 1 are not compared, as torch's contiguity does not."""
    b, h, rows, tk = kv[0].shape
    ld = kv[0].stride(2) if rows > 1 else tk
    want = (h * rows * ld, rows * ld, ld, 1)
    ok = ld >= tk and (ld == tk or ld * kv[0].element_size() % TMA_ALIGN == 0) and all(
        st == w for t in kv for n, st, w in zip(t.shape, t.stride(), want) if n > 1)
    if not ok:
        raise ValueError(
            f"{name}: K/V must be contiguous, or rows of a pitch that is a "
            f"multiple of 16 bytes with strides (H*rows*ld, rows*ld, ld, 1), "
            f"alike for K and V; got {[t.stride() for t in kv]}")
    return ld


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


def _launch_decode_cross(name, entry, q, k, v, scales, kv_len, packed=False,
                         q_dtype=torch.bfloat16):
    """Checks and launch shared by K3, K4, K6 and K11 and their f32 forms,
    one persistent kernel: K/V [B, H, rows, Tk] of any pitch _slab_pitch
    takes (rows 64, or 32 of packed int4: packed), one partial record per
    work item (item_positions), the SM count and the load path passed
    after kv_len and ld after q's strides. scales: (ks, vs) for int8 and
    int4 K/V, () for bf16 or f32 K/V (K4, of q_dtype). The output is of
    q_dtype. Returns the [B, H, R, 64] result as a view of a [B, R, H, 64]
    buffer."""
    b, h, r, d = q.shape
    tk = k.shape[3]
    kv_dtype = torch.int8 if scales else q_dtype
    kv_len = _check_decode_cross(name, q, (k, v), scales, d // 2 if packed else d,
                                 kv_dtype, kv_len, q_dtype)
    chunks = -(-kv_len // item_positions(k.element_size()))
    ld = _slab_pitch(name, (k, v))
    path = decode_cross_load_path(ld * k.element_size(), k.data_ptr(), v.data_ptr())
    part = torch.empty((b * h, chunks, r, d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, r, h, d), dtype=q.dtype, device=q.device)
    ptrs = ((k, scales[0], v, scales[1]) if scales else (k, v))
    lib = _build.load_library()
    _build.check(getattr(lib, entry)(
        q.data_ptr(), *(t.data_ptr() for t in ptrs), part.data_ptr(),
        out.data_ptr(), b, h, r, tk, kv_len, _num_sms(q.device.index),
        int(path == "tma"), *q.stride()[:3], ld,
        out.stride(0), out.stride(2), out.stride(1),
        _build.stream_ptr(q.device),
    ), entry)
    return out.permute(0, 2, 1, 3)


def decode_cross_attention_q8(q, qk, ks, qv, vs,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """K3. q [B, H, R<=8, 64] bf16 pre-scaled by Dh^-0.5 (head dim
    contiguous); qk/qv int8 [B, H, 64, Tk], contiguous or with rows of a
    pitch that is a multiple of 16 bytes (the decoder's layout,
    tma_pitch); ks/vs f32 [B, H, Tk], contiguous; any Tk -> [B, H, R,
    64]. The kernel is K11's (the same bits on the same inputs): items of
    (batch item, head pair, 128 positions), so P rounds to bf16 against
    each 128-position chunk's max. An f32 q goes to
    decode_cross_attention_q8_f32q."""
    if q.dtype == torch.float32:
        return decode_cross_attention_q8_f32q(q, qk, ks, qv, vs, kv_len)
    if q.device.type == "cpu":
        return decode_cross_attention_q8_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross(
        "decode_cross_attention_q8", "spt_decode_cross_attention_q8",
        q, qk, qv, (ks, vs), kv_len)
    decode_cross_attention_q8.launches += 1
    return out


decode_cross_attention_q8.launches = 0


def decode_cross_attention_q8_f32q(q, qk, ks, qv, vs,
                                   kv_len: Optional[int] = None) -> torch.Tensor:
    """K3 with an f32 q, the JAX package's default precision: operands as
    K3's but q f32, output f32 [B, H, R, 64]. The function is K3's plain
    version on an f32 q (f32 scores, p * vs rounded to bf16 as the Pallas
    kernel casts it for PV, f32 output); the kernel is K3's instance with
    an f32 q and output."""
    if q.device.type == "cpu":
        return decode_cross_attention_q8_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross(
        "decode_cross_attention_q8_f32q", "spt_decode_cross_attention_q8_f32q",
        q, qk, qv, (ks, vs), kv_len, q_dtype=torch.float32)
    decode_cross_attention_q8_f32q.launches += 1
    return out


decode_cross_attention_q8_f32q.launches = 0


def decode_cross_attention_q4(q, qk, ks, qv, vs,
                              kv_len: Optional[int] = None) -> torch.Tensor:
    """K6. As K3 with qk/qv the packed int4 [B, H, 32, Tk] (byte t of row
    d: dims d and d + 32 of position t), contiguous or with rows of a
    pitch that is a multiple of 16 bytes (the decoder's layout,
    tma_pitch). The kernel is K3's int4 instance: items of (batch item,
    head pair, 128 positions), so P rounds to bf16 against each such
    chunk's max. An f32 q goes to decode_cross_attention_q4_f32q."""
    if q.dtype == torch.float32:
        return decode_cross_attention_q4_f32q(q, qk, ks, qv, vs, kv_len)
    if q.device.type == "cpu":
        return decode_cross_attention_q4_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross(
        "decode_cross_attention_q4", "spt_decode_cross_attention_q4",
        q, qk, qv, (ks, vs), kv_len, packed=True)
    decode_cross_attention_q4.launches += 1
    return out


decode_cross_attention_q4.launches = 0


def decode_cross_attention_q4_f32q(q, qk, ks, qv, vs,
                                   kv_len: Optional[int] = None) -> torch.Tensor:
    """K6 with an f32 q: operands as K6's but q f32, output f32. K6's
    plain version on an f32 q; the kernel is K6's instance with an f32 q
    and output (p * vs still rounded to bf16)."""
    if q.device.type == "cpu":
        return decode_cross_attention_q4_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross(
        "decode_cross_attention_q4_f32q", "spt_decode_cross_attention_q4_f32q",
        q, qk, qv, (ks, vs), kv_len, packed=True, q_dtype=torch.float32)
    decode_cross_attention_q4_f32q.launches += 1
    return out


decode_cross_attention_q4_f32q.launches = 0


def decode_cross_attention_q8_mh(q, qk, ks, qv, vs,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """K11: K3's function and kernel (decode_cross_attention_q8_plain is
    its plain version) over the K/V of a batch item as one [H*64, Tk]
    slab, the probe kernel's view: a persistent grid of one block per SM
    over items of (batch item, head pair, 128 positions), each loaded as
    one box per K and V (decode_cross_load_path: TMA where the row pitch
    and the slabs are 16-byte aligned, 16-byte cp.async covers otherwise).
    Operands as K3's."""
    if q.device.type == "cpu":
        return decode_cross_attention_q8_plain(q, qk, ks, qv, vs, kv_len)
    out = _launch_decode_cross(
        "decode_cross_attention_q8_mh", "spt_decode_cross_attention_q8",
        q, qk, qv, (ks, vs), kv_len)
    decode_cross_attention_q8_mh.launches += 1
    return out


decode_cross_attention_q8_mh.launches = 0


# ---------------------------------------------------------------------------
# K14: cross-attention with both products int8 x int8 -> int32 ("w8a8")
# ---------------------------------------------------------------------------


def _exact_int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer-valued operands as the int32 product rounded once
    to f32: f64 holds every partial sum exactly (|sum| < 2**53), on any
    device (CUDA has no integer matmul)."""
    return torch.matmul(a.double(), b.double()).float()


def _w8a8_probs(q, qk, ks, vs, kv_len: int):
    """K14's first steps in the reference's order (spittle_tpu/models/
    whisper/model.py, the "qw8" branch of _cross_attention): q's rows
    quantized per row over Dh (amax/127, round half to even), the scores
    f32(int32 qq . qK) * sq * ks masked to t < kv_len before the max, the
    softmax e / sum(e), and pv = p * vs. Returns pv [B, H, R, T]."""
    from .quant import _scale

    q32 = q.float()
    sq = _scale(q32.abs().amax(dim=-1, keepdim=True), 127.0)
    qq = torch.clamp(torch.round(q32 / sq), -127, 127)
    s = _exact_int_dot(qq, qk) * sq * ks[..., None, :]
    tk = qk.shape[-1]
    if kv_len < tk:
        s = torch.where(torch.arange(tk, device=s.device) < kv_len, s, _NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True) * vs[..., None, :]


def decode_cross_attention_w8a8_plain(q, qk, ks, qv, vs,
                                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain K14: the reference's "qw8" cross-attention step by step. q
    [B, H, R, Dh] pre-scaled by Dh^-0.5; qk/qv int8 [B, H, Dh, T]; ks/vs
    f32 [B, H, T]. pv's rows are quantized over T (pa/127 with pa its
    max, codes 0..127), and the output is f32(int32 qp . qV) * sp in q's
    dtype. Both products are exact."""
    from .quant import _scale

    kv_len = qk.shape[-1] if kv_len is None else kv_len
    pv = _w8a8_probs(q, qk, ks, vs, kv_len)
    sp = _scale(pv.amax(dim=-1, keepdim=True), 127.0)
    qp = torch.clamp(torch.round(pv / sp), 0, 127)
    return (_exact_int_dot(qp, qv.transpose(-1, -2)) * sp).to(q.dtype)


def w8a8_code_step(q, qk, ks, qv, vs, kv_len: Optional[int] = None) -> torch.Tensor:
    """Per query row [B, H, R]: pa = max(p * vs), the most that one of
    K14's P codes moved by one shifts that row's outputs (|qV| <= 127
    times sp = pa/127). Two computations whose exp or sum differs in the
    last bit differ by this step where pv/sp lands on a rounding boundary;
    comparisons of K14 allow one per row."""
    kv_len = qk.shape[-1] if kv_len is None else kv_len
    return _w8a8_probs(q, qk, ks, vs, kv_len).amax(dim=-1)


# K14's launch plan (csrc/decode_cross_attention_w8a8.cu): shared memory a
# CTA may use (kSmemBudget, 227 KB), the largest portable cluster, the
# fewest positions per rank worth a CTA of their own, and the query rows
# per CTA at most on each regime.
W8A8_SMEM_BUDGET = 232448
W8A8_MAX_CLUSTER = 8
W8A8_MIN_SLICE = 128
W8A8_DP4A_ROWS = 8


class W8A8Plan(NamedTuple):
    """How K14 runs at one (T, R, Dh): `mma` the regime (int8 tensor-core
    tiles past 8 rows when Dh is a multiple of 32, else __dp4a), `cluster`
    CTAs per (item, head, row tile), rank c taking positions [c * slice,
    (c + 1) * slice) of T, `row_tile` query rows per CTA, `smem` bytes
    of dynamic shared memory per CTA (the kernel's Layout: the C entry
    computes its own, spt_w8a8_smem_bytes) and `stream` (__dp4a only): K
    and V read from global memory, not held in shared memory."""

    mma: bool
    cluster: int
    slice: int
    row_tile: int
    smem: int
    stream: bool = False

    @property
    def regime(self) -> str:
        return "mma" if self.mma else "dp4a_stream" if self.stream else "dp4a"

    def row_tiles(self, r: int) -> int:
        return -(-r // self.row_tile)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def w8a8_smem_bytes(mma: bool, slice_: int, row_tile: int, dh: int, cluster: int,
                    stream: bool = False) -> int:
    """A K14 CTA's dynamic shared memory (the kernel's Layout, which the
    C entry computes for itself and spt_w8a8_smem_bytes exports; the card
    tests hold the two equal): K and V's slice rows (slice + 16 bytes
    each; none when streamed); f32 scores (slice + 16 floats per row; then
    this CTA's int32 partials), which under mma take K's space as loaded;
    the transposed K (mma); the partials peers store for this rank's rows
    ([cluster][ceil(row_tile / cluster)][dh] int32, in K's or the
    transposed K's space, else their own); q's and P's codes (room for the
    row tile rounded up to 1, 2, 4 or 8 under __dp4a); both scale slices;
    the row slots (two scales and three [cluster] reduction slots per
    row); four mbarriers (the three reductions, the partials)."""
    sp, dhp, sf = slice_ + 16, dh + 16, slice_ + 16
    kbytes, sbytes = dh * sp, max(row_tile * sf, row_tile * dh) * 4
    rbytes = cluster * -(-row_tile // cluster) * dh * 4
    if mma:
        total = (_align16(max(kbytes, sbytes)) + _align16(kbytes)
                 + _align16(max(slice_ * dhp, rbytes)))
    elif stream:
        total = _align16(sbytes) + _align16(rbytes)
    else:
        total = _align16(max(kbytes, rbytes)) + _align16(sbytes) + _align16(kbytes)
    # rows of q's and P's codes
    crows = row_tile if mma else next(n for n in (1, 2, 4, 8) if n >= row_tile)
    total += _align16(crows * dhp) + _align16(crows * sp)
    total += 2 * _align16(slice_ * 4) + _align16((2 + 3 * cluster) * row_tile * 4)
    return total + 32  # four mbarriers


def w8a8_plan(tk: int, r: int, dh: int) -> W8A8Plan:
    """K14's plan for K/V of tk positions, r query rows and head dim dh.
    The regime follows r and dh while a slice of K and V fits in shared
    memory: the tensor cores past 8 rows with dh a multiple of 32, else
    __dp4a. The cluster is the largest power of two up to 8 that leaves
    each rank W8A8_MIN_SLICE positions (1 below that); the slice is T over
    the ranks rounded up to 16 positions (32 under mma, a k-step of the
    tensor cores); the row tile is 64 under mma (32 for up to 32 rows: a
    tile of 16 keeps too few of the CTA's 16 warps busy), halved down to
    16 until the CTA fits the budget, and under __dp4a as many of r's
    rows, up to 8, as fit. Where no tile fits (T past ~12,000 at Dh 64 and
    8 rows, ~7,700 at 228), K and V are streamed from global memory on
    __dp4a, as many rows as fit (one row fits up to T ~140,000). Raises
    ValueError where even that does not fit.
    probes/w8a8_cluster.py times K14 under the other clusters and tiles."""
    cluster = 1
    while 2 * cluster <= W8A8_MAX_CLUSTER and 2 * cluster * W8A8_MIN_SLICE <= tk:
        cluster *= 2
    mma = r > W8A8_DP4A_ROWS and dh % 32 == 0
    for mma, stream in ((mma, False), (False, True)):
        gran = 32 if mma else 16
        slice_ = -(-(-(-tk // cluster)) // gran) * gran
        if mma:
            tiles = [t for t in (64, 32, 16) if t <= max(32, -(-r // 16) * 16)]
        else:
            tiles = list(range(min(r, W8A8_DP4A_ROWS), 0, -1))
        for rt in tiles:
            smem = w8a8_smem_bytes(mma, slice_, rt, dh, cluster, stream)
            if smem <= W8A8_SMEM_BUDGET:
                return W8A8Plan(mma, cluster, slice_, rt, smem, stream)
    raise ValueError(f"decode_cross_attention_w8a8: T={tk} at Dh {dh} does not fit "
                     f"{slice_} positions per CTA in shared memory")


def _check_w8a8(q, k, ks, v, vs, kv_len):
    """K14's checks on CUDA: q [B, H, R, Dh] bf16 or f32 with its head dim
    contiguous, Dh a multiple of 4 up to 256; k/v int8 [B, H, Dh, T] with
    T contiguous (rows of any pitch, as the decoder's tma_pitch); ks/vs
    contiguous f32 [B, H, T]; B * H and the row tiles within the grid's
    65535. Returns (kv_len, plan)."""
    name = "decode_cross_attention_w8a8"
    b, h, r, d = q.shape
    tk = k.shape[3]
    kv_len = tk if kv_len is None else kv_len
    if d % 4 or not 4 <= d <= 256 or r < 1:
        raise ValueError(f"{name}: needs Dh a multiple of 4 up to 256 and R >= 1, "
                         f"got {tuple(q.shape)}")
    if any(t.shape != (b, h, d, tk) for t in (k, v)) or \
            any(t.shape != (b, h, tk) for t in (ks, vs)):
        raise ValueError(f"{name}: K/V must be [{b}, {h}, {d}, T] and their scales "
                         f"[{b}, {h}, T], got {[tuple(t.shape) for t in (k, v, ks, vs)]}")
    if not 1 <= kv_len <= tk:
        raise ValueError(f"{name}: kv_len={kv_len} not in [1, {tk}]")
    plan = w8a8_plan(tk, r, d)
    if b * h > 65535 or plan.row_tiles(r) > 65535:
        raise ValueError(f"{name}: B*H={b * h} and {plan.row_tiles(r)} row tiles must "
                         "each be at most 65535 (the grid's z and y)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q must be bf16 or f32, got {q.dtype}")
    for label, t, dtype in (("k", k, torch.int8), ("v", v, torch.int8),
                            ("k scale", ks, torch.float32),
                            ("v scale", vs, torch.float32)):
        if t.dtype != dtype or t.device != q.device:
            raise TypeError(f"{name}: {label} must be {dtype} on {q.device}, "
                            f"got {t.dtype} on {t.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1 or \
            not (ks.is_contiguous() and vs.is_contiguous()):
        raise ValueError(f"{name}: q's head dim, K/V's positions and the scales "
                         "must be contiguous")
    return kv_len, plan


def decode_cross_attention_w8a8(q, qk, ks, qv, vs,
                                kv_len: Optional[int] = None) -> torch.Tensor:
    """K14 (csrc/decode_cross_attention_w8a8.cu): cross-attention whose two
    products are int8 x int8 -> int32 with q and P quantized per row, for
    any number of query rows R (a decode step's, a speculative verify's
    block, a prefill's prompt). q [B, H, R, Dh] bf16 or f32 pre-scaled by
    Dh^-0.5; qk/qv int8 [B, H, Dh, T], rows of any pitch (the decoder's
    tma_pitch); ks/vs f32 [B, H, T] -> contiguous [B, H, R, Dh] in q's
    dtype. The JAX package leaves these products to XLA; PyTorch has no
    integer matmul on CUDA, so on the card nothing else computes them.
    One launch of a cluster per (item, head, row tile) as w8a8_plan says."""
    if q.device.type == "cpu":
        return decode_cross_attention_w8a8_plain(q, qk, ks, qv, vs, kv_len)
    kv_len, plan = _check_w8a8(q, qk, ks, qv, vs, kv_len)
    out = _launch_w8a8(q, qk, ks, qv, vs, kv_len, plan)
    decode_cross_attention_w8a8.launches += 1
    return out


def _launch_w8a8(q, qk, ks, qv, vs, kv_len: int, plan: W8A8Plan) -> torch.Tensor:
    """One K14 launch under `plan` (checked inputs; probes pass other plans)."""
    b, h, r, d = q.shape
    out = torch.empty((b, h, r, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    _build.check(lib.spt_decode_cross_attention_w8a8(
        q.data_ptr(), qk.data_ptr(), ks.data_ptr(), qv.data_ptr(), vs.data_ptr(),
        out.data_ptr(), b, h, r, d, qk.shape[3], kv_len, int(plan.mma), plan.cluster,
        plan.slice, plan.row_tile, int(plan.stream), int(q.dtype == torch.bfloat16),
        *q.stride()[:3], *qk.stride()[:3], *qv.stride()[:3],
        _build.stream_ptr(q.device),
    ), "spt_decode_cross_attention_w8a8")
    return out


decode_cross_attention_w8a8.launches = 0
