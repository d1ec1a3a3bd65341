"""Weight quantization and the matmul dispatch (port of
spittle_tpu/ops/quant.py: quantize_weight, quantize_weight_w8a8,
quantize_tree, quantize_whisper_encoder_w8a8, mm, mm_bias).

A quantized weight is a dict: {"qw": int8 [.., in, out], "scale": f32
[.., out]} (weight-only) or {"qw8": ..., "scale": ...} (W8A8 compute).
The rule is the reference's exactly: scale = amax/127 per output channel
(1 where amax is 0), round-half-even, clip to +-127.

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


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 over [.., in, out]:
    w ~= qw * scale[.., None, :]."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2)
    # A device-tensor divisor keeps the IEEE division on CUDA (see
    # w8a8_gemm.quantize_rows).
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0),
                        torch.ones_like(amax))
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


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain weight, or the W8A8 GEMM (K2) for a "qw8" dict.
    Weight-only int8 dicts belong to the quantized decoders, which this
    slice does not carry."""
    if is_quant_w8a8(w):
        return w8a8_gemm(x, w["qw8"], w["scale"])
    if is_quant(w):
        raise NotImplementedError(
            "weight-only int8 decoders are not ported yet (ROADMAP queue 1)"
        )
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
