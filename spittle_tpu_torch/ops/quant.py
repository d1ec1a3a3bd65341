"""Weight and K/V quantization and the matmul dispatch (port of
spittle_tpu/ops/quant.py: quantize_weight, quantize_weight_w8a8,
quantize_tree, quantize_whisper_encoder_w8a8, quantize_whisper_decoder,
quantize_kv, quantize_kv_t, quantize_kv_w8a8, quantize_kv_int4,
unpack_kv_int4, mm, mm_bias).

A quantized weight is a dict: {"qw": int8 [.., in, out], "scale": f32
[.., out]} (weight-only) or {"qw8": ..., "scale": ...} (W8A8 compute).
The rule is the reference's exactly: scale = amax/127 per output channel
(1 where amax is 0), round-half-even, clip to +-127. Quantized attention
K/V are {"qw": int8 [.., Dh, T], "scale": f32 [.., T]}, the same bytes
tagged {"qw8": ..., "scale": ...} for the int8 x int8 cross-attention
(K14 on the card) or, packed two per byte, {"qw4": int8 [.., Dh/2, T],
"scale": ...} with amax/7 scales.
Every scale is an IEEE division by a device tensor: on CUDA, PyTorch
turns division by a Python scalar into a reciprocal multiply, which
moves int8 codes away from the reference's.

The W8A8 int8 tensor keeps the reference's [in, out] shape but is stored
out-major (strides (1, in) per layer), the operand order the int8
tensor-core product reads; `.numpy()` of it equals the reference bytes.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .w8a8_gemm import gelu_erf, w8a8_gemm


def is_quant(w: Any) -> bool:
    return isinstance(w, dict) and "qw" in w and "scale" in w


def is_quant_w8a8(w: Any) -> bool:
    return isinstance(w, dict) and "qw8" in w and "scale" in w


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """amax / qmax (1 where amax is 0). A device-tensor divisor keeps the
    IEEE division on CUDA (see w8a8_gemm.quantize_rows)."""
    return torch.where(amax > 0, amax / amax.new_full((), qmax),
                       torch.ones_like(amax))


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 over [.., in, out]:
    w ~= qw * scale[.., None, :]."""
    w32 = w.to(torch.float32)
    scale = _scale(w32.abs().amax(dim=-2), 127.0)
    qw = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127, 127)
    return {"qw": qw.to(torch.int8), "scale": scale}


def out_major(qw: torch.Tensor) -> torch.Tensor:
    """Same values and shape [.., in, out], stored with `in` minor."""
    return qw.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight_w8a8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """quantize_weight's numbers under the "qw8" key (the W8A8 compute
    path), stored out-major for the kernel."""
    q = quantize_weight(w)
    return {"qw8": out_major(q["qw"]), "scale": q["scale"]}


def quantize_tree(tree: Any, keys: tuple = (), mode: str = "weight") -> Any:
    """Quantize the leaves named in `keys` of a param tree (2-D [in, out]
    or stacked 3-D [L, in, out]; per-layer scales). mode: "weight" or
    "w8a8"."""
    if mode not in ("weight", "w8a8"):
        raise ValueError(f"mode must be 'weight' or 'w8a8', got {mode!r}")
    quant = quantize_weight_w8a8 if mode == "w8a8" else quantize_weight
    kset = set(keys)

    def walk(node):
        if isinstance(node, dict):
            return {
                name: quant(child)
                if name in kset and torch.is_tensor(child) and child.dim() in (2, 3)
                else walk(child)
                for name, child in node.items()
            }
        return node

    return walk(tree)


# Encoder block leaves quantized for W8A8 compute: every GEMM of the
# 1500-frame forward. The conv stem and layer norms stay as they are.
WHISPER_ENCODER_QUANT_KEYS = ("wq", "wk", "wv", "wo", "fc1_w", "fc2_w")


def quantize_whisper_encoder_w8a8(params: Dict[str, Any]) -> Dict[str, Any]:
    """W8A8-quantize the encoder block GEMMs of a Whisper param tree."""
    out = dict(params)
    enc = dict(params["encoder"])
    enc["blocks"] = quantize_tree(
        enc["blocks"], WHISPER_ENCODER_QUANT_KEYS, mode="w8a8"
    )
    out["encoder"] = enc
    return out


# Decoder block leaves quantized weight-only int8: everything the
# per-token step reads except embeddings, norms, biases and the cross-K/V
# projections (those run once per window).
WHISPER_DECODER_QUANT_KEYS = (
    "wq", "wk", "wv", "wo",
    "cross_wq", "cross_wo",
    "fc1_w", "fc2_w",
)


def quantize_whisper_decoder(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 on the decoder block weights of a Whisper tree."""
    out = dict(params)
    dec = dict(params["decoder"])
    dec["blocks"] = quantize_tree(dec["blocks"], WHISPER_DECODER_QUANT_KEYS)
    out["decoder"] = dec
    return out


# ---------------------------------------------------------------------------
# Attention K/V quantization: one f32 scale per position, over Dh
# ---------------------------------------------------------------------------


def quantize_kv(kv: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int8 for K/V in the decode layout [..., Dh, T]: one scale
    per (..., T) vector, kv ~= qw * scale[..., None, :]."""
    kv32 = kv.to(torch.float32)
    scale = _scale(kv32.abs().amax(dim=-2), 127.0)
    q = torch.clamp(torch.round(kv32 / scale.unsqueeze(-2)), -127, 127)
    return {"qw": q.to(torch.int8), "scale": scale}


def quantize_kv_t(kv: torch.Tensor) -> Dict[str, torch.Tensor]:
    """quantize_kv for the ctx-major layout [..., T, Dh] (amax over the
    minor Dh axis): the same bytes and scales as quantize_kv of the
    transpose."""
    kv32 = kv.to(torch.float32)
    scale = _scale(kv32.abs().amax(dim=-1), 127.0)
    q = torch.clamp(torch.round(kv32 / scale.unsqueeze(-1)), -127, 127)
    return {"qw": q.to(torch.int8), "scale": scale}


def dequantize_kv(q: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """An int8 K/V dict ("qw" or "qw8") back to dtype."""
    qw = q["qw8"] if "qw8" in q else q["qw"]
    return (qw.to(torch.float32) * q["scale"].unsqueeze(-2)).to(dtype)


def quantize_kv_w8a8(kv: torch.Tensor) -> Dict[str, torch.Tensor]:
    """quantize_kv's bytes and scales under the "qw8" key: K/V for the
    cross-attention whose two products are both int8 x int8 -> int32
    (ops.attention.decode_cross_attention_w8a8, K14 on the card)."""
    q = quantize_kv(kv)
    return {"qw8": q["qw"], "scale": q["scale"]}


def is_quant_kv4(w: Any) -> bool:
    return isinstance(w, dict) and "qw4" in w and "scale" in w


def kv_codes(kv: Any) -> torch.Tensor:
    """The code tensor of a quantized K/V dict ("qw4", "qw8" or "qw"), or
    a plain K/V tensor itself."""
    if not isinstance(kv, dict):
        return kv
    return kv["qw4" if "qw4" in kv else "qw8" if "qw8" in kv else "qw"]


def quantize_kv_int4(kv: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int4 for K/V in the decode layout [..., Dh, T], two values
    per byte: rows [0, Dh/2) in the low nibble, [Dh/2, Dh) in the high one,
    values clipped to -7..7, one f32 scale per position."""
    d = kv.shape[-2]
    if d % 2:
        raise ValueError(f"quantize_kv_int4: head dim {d} must be even")
    kv32 = kv.to(torch.float32)
    scale = _scale(kv32.abs().amax(dim=-2), 7.0)
    q = torch.clamp(torch.round(kv32 / scale.unsqueeze(-2)), -7, 7).to(torch.int8)
    lo = q[..., : d // 2, :].view(torch.uint8) & 0xF
    hi = q[..., d // 2:, :].view(torch.uint8) & 0xF
    return {"qw4": ((hi << 4) | lo).view(torch.int8), "scale": scale}


def unpack_kv_int4(qw4: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., Dh/2, T] -> int8 [..., Dh, T] in -7..7: each
    nibble sign-extended ((n ^ 8) - 8), low nibbles first."""
    x = qw4.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8
    hi = (((x >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def dequantize_kv_int4(q: Dict[str, torch.Tensor],
                       dtype=torch.bfloat16) -> torch.Tensor:
    return (unpack_kv_int4(q["qw4"]).to(torch.float32)
            * q["scale"].unsqueeze(-2)).to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain weight; the W8A8 GEMM (K2) for a "qw8" dict; the
    weight-only int8 product for a "qw" dict, in the reference's order:
    the int8 weight widened to x's dtype, the product, then the
    per-column scale. The JAX package leaves the weight-only product to
    XLA, so it stays a plain matmul here and never reaches K2."""
    if is_quant_w8a8(w):
        return w8a8_gemm(x, w["qw8"], w["scale"])
    if is_quant(w):
        return (x @ w["qw"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def mm_bias(x: torch.Tensor, w, bias=None, act: str = "none",
            out_scale: float = 1.0) -> torch.Tensor:
    """mm + bias + out-scale + optional exact GELU.

    A W8A8 weight always goes through w8a8_gemm, which folds the bias,
    the scale and the GELU into its epilogue. Plain weights compute the
    same values in the reference's order: (x @ w + b) * s, then GELU."""
    if is_quant_w8a8(w):
        return w8a8_gemm(x, w["qw8"], w["scale"], bias=bias, act=act,
                         out_scale=out_scale)
    y = mm(x, w)
    if bias is not None:
        y = y + bias
    if out_scale != 1.0:
        y = y * out_scale
    if act == "gelu":
        y = gelu_erf(y)
    return y
