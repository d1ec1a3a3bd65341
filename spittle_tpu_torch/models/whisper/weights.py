"""Whisper parameters for the port: the checkpoint loaders (whisper.cpp
GGML files, HF safetensors directories and spittle .npz files, numpy
only: the port's copies of spittle_tpu/models/whisper/weights.py's GGML
reader and name maps, and a safetensors reader of its own that needs no
`safetensors` package), conversion from the reference's parameter tree,
and seeded random weights.

The tree is the reference's (spittle_tpu/models/whisper/model.py module
docstring): {"encoder": {conv1_w [D, n_mels, 3], conv1_b, conv2_w,
conv2_b, blocks {stacked [L, ...] leaves}, ln_g, ln_b}, "decoder":
{tok_emb [V, D], pos_emb [n_ctx, D], blocks {...}, ln_g, ln_b}}, with
torch tensors as leaves.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from spittle_tpu_torch.ops.quant import out_major

from .config import WhisperConfig

Params = Dict[str, Any]


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: exact via f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16
        )
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_jax(tree: Any, device="cpu") -> Params:
    """The reference's parameter tree (numpy or jax arrays as leaves) ->
    the port's tensors, same nesting and dtypes. W8A8 dicts {"qw8",
    "scale"} keep their values; the int8 tensor is stored out-major, the
    operand order the W8A8 kernel reads."""
    if isinstance(tree, dict):
        out = {k: params_from_jax(v, device) for k, v in tree.items()}
        if "qw8" in out:
            out["qw8"] = out_major(out["qw8"])
        return out
    return _to_tensor(tree, device)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """The engine's cast rule: layer-norm gains and biases (keys ending in
    ln_g / ln_b) stay f32; every other f32 leaf goes to `dtype`."""
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key.endswith(("ln_g", "ln_b")) or node.dtype != torch.float32:
            return node
        return node.to(dtype)

    return walk(params)


def load_npz_checkpoint(path: str, dtype=np.float32):
    """spittle-native .npz (the reference's save_npz_checkpoint format) ->
    (cfg, params as numpy arrays, extras). Float leaves are cast to
    `dtype`; extras holds the "vocab" byte strings when present."""
    with np.load(path) as z:
        cfg = WhisperConfig(**json.loads(bytes(z["__config__"]).decode()))
        params: Params = {}
        for key in z.files:
            if not key.startswith("param:"):
                continue
            node = params
            parts = key[len("param:"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = z[key]
            node[parts[-1]] = arr.astype(dtype) if arr.dtype.kind == "f" else arr
        extras: Dict[str, Any] = {}
        if "__vocab__" in z.files:
            table = json.loads(bytes(z["__vocab__"]).decode())
            extras["vocab"] = [t.encode("latin1") for t in table]
    return cfg, params, extras


# ---------------------------------------------------------------------------
# GGML (whisper.cpp) files: header, mel filterbank, vocabulary, tensors
# ---------------------------------------------------------------------------

GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
# Tensor type id -> (elements per block, bytes per block).
_TENSOR_TYPE_SIZES = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_Q4_0: (32, 2 + 16),
    GGML_Q4_1: (32, 4 + 16),
    GGML_Q5_0: (32, 2 + 4 + 16),
    GGML_Q5_1: (32, 4 + 4 + 16),
    GGML_Q8_0: (32, 2 + 32),
}
GGML_MAGIC = 0x67676D6C  # 'ggml'


def _dequant(data: bytes, ttype: int, n: int) -> np.ndarray:
    """A GGML tensor payload of n elements -> float32, block by block (the
    public ggml formats: f16 scale d, f16 min m where the type has one,
    the high bits of 5-bit codes in a u32, then the packed low nibbles)."""
    if ttype == GGML_F32:
        return np.frombuffer(data, np.float32, n).copy()
    if ttype == GGML_F16:
        return np.frombuffer(data, np.float16, n).astype(np.float32)
    block_n, block_b = _TENSOR_TYPE_SIZES[ttype]
    nb = n // block_n
    raw = np.frombuffer(data, np.uint8, nb * block_b).reshape(nb, block_b)

    def f16(cols):
        return raw[:, cols].copy().view(np.float16).astype(np.float32)[:, 0]

    if ttype == GGML_Q4_0:
        d = f16(range(2))[:, None]
        q = raw[:, 2:18]
        lo = (q & 0x0F).astype(np.int8) - 8
        hi = (q >> 4).astype(np.int8) - 8
        vals = np.concatenate([lo, hi], axis=1).astype(np.float32)
        return (vals * d).reshape(-1)[:n]
    if ttype == GGML_Q4_1:
        d = f16(range(2))[:, None]
        m = f16(range(2, 4))[:, None]
        q = raw[:, 4:20]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        vals = np.concatenate([lo, hi], axis=1)
        return (vals * d + m).reshape(-1)[:n]
    if ttype in (GGML_Q5_0, GGML_Q5_1):
        has_min = ttype == GGML_Q5_1
        d = f16(range(2))[:, None]
        m = f16(range(2, 4))[:, None] if has_min else None
        c = 4 if has_min else 2  # first byte of the high bits
        qh = raw[:, c:c + 4].copy().view(np.uint32)[:, 0]
        q = raw[:, c + 4:c + 20]
        bits = (qh[:, None] >> np.arange(32)[None, :]) & 1
        lo = (q & 0x0F).astype(np.int32) | (bits[:, :16] << 4)
        hi = (q >> 4).astype(np.int32) | (bits[:, 16:] << 4)
        codes = np.concatenate([lo, hi], axis=1)
        if has_min:
            return (codes.astype(np.float32) * d + m).reshape(-1)[:n]
        return ((codes - 16).astype(np.float32) * d).reshape(-1)[:n]
    if ttype == GGML_Q8_0:
        d = f16(range(2))[:, None]
        q = raw[:, 2:34].copy().view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)[:n]
    raise ValueError(f"unsupported ggml tensor type {ttype}")


def load_ggml(path: str) -> Tuple[WhisperConfig, Dict[str, np.ndarray],
                                   np.ndarray, List[bytes]]:
    """Parse a whisper.cpp GGML model file -> (config, tensors by OpenAI
    name as float32, mel filterbank [n_mels, 201], vocabulary bytes)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic = struct.unpack_from("<I", buf, 0)[0]
    if magic != GGML_MAGIC:
        raise ValueError(f"{path}: not a ggml file (magic {magic:#x})")
    off = 4

    def i32():
        nonlocal off
        (v,) = struct.unpack_from("<i", buf, off)
        off += 4
        return v

    (n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
     n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels,
     _ftype) = (i32() for _ in range(11))
    cfg = WhisperConfig(
        name=os.path.basename(path), n_mels=n_mels, n_audio_ctx=n_audio_ctx,
        n_audio_state=n_audio_state, n_audio_head=n_audio_head,
        n_audio_layer=n_audio_layer, n_vocab=n_vocab, n_text_ctx=n_text_ctx,
        n_text_state=n_text_state, n_text_head=n_text_head,
        n_text_layer=n_text_layer,
    )
    fb_mel, fb_fft = i32(), i32()
    filters = np.frombuffer(buf, np.float32, fb_mel * fb_fft, off).reshape(
        fb_mel, fb_fft).copy()
    off += 4 * fb_mel * fb_fft
    vocab: List[bytes] = []
    for _ in range(i32()):
        ln = i32()
        vocab.append(buf[off:off + ln])
        off += ln
    tensors: Dict[str, np.ndarray] = {}
    while off < len(buf):
        n_dims, name_len, ttype = i32(), i32(), i32()
        dims = [i32() for _ in range(n_dims)]
        name = buf[off:off + name_len].decode()
        off += name_len
        n = int(np.prod(dims))
        block_n, block_b = _TENSOR_TYPE_SIZES[ttype]
        nbytes = (n // block_n) * block_b
        vals = _dequant(buf[off:off + nbytes], ttype, n)
        off += nbytes
        # ggml lists dims fastest first: reversed, they are numpy's shape.
        tensors[name] = vals.reshape(tuple(reversed(dims)))
    return cfg, tensors, filters, vocab


# ---------------------------------------------------------------------------
# safetensors (HF format), read without the safetensors package
# ---------------------------------------------------------------------------

# The dtypes safetensors.numpy.load_file takes (BF16 has no numpy type).
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "U64": np.uint64, "I32": np.int32, "U32": np.uint32,
    "I16": np.int16, "U16": np.uint16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_, "C64": np.complex64,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One .safetensors file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}} (and an optional
    "__metadata__"), then the tensors' little-endian bytes, offsets counted
    from the end of the header."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    header = json.loads(buf[8:8 + n])
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, which is not read")
        start, end = info["data_offsets"]
        out[name] = np.frombuffer(
            buf, np.dtype(dt).newbyteorder("<"), (end - start)
            // np.dtype(dt).itemsize, base + start).reshape(info["shape"])
    return out


def load_safetensors_dir(model_dir: str) -> Dict[str, np.ndarray]:
    """Every *.safetensors in model_dir, in name order, one dict."""
    tensors: Dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(model_dir)):
        if fname.endswith(".safetensors"):
            tensors.update(load_safetensors(os.path.join(model_dir, fname)))
    if not tensors:
        raise FileNotFoundError(f"no .safetensors in {model_dir}")
    return tensors


# ---------------------------------------------------------------------------
# OpenAI-named tensors -> the stacked parameter tree
# ---------------------------------------------------------------------------

# Our key -> (OpenAI name under "{side}.blocks.{i}.", transposed [out, in]
# on disk, kept f32).
_BLOCK_KEYS = {
    "attn_ln_g": ("attn_ln.weight", False, True),
    "attn_ln_b": ("attn_ln.bias", False, True),
    "wq": ("attn.query.weight", True, False),
    "bq": ("attn.query.bias", False, False),
    "wk": ("attn.key.weight", True, False),
    "wv": ("attn.value.weight", True, False),
    "bv": ("attn.value.bias", False, False),
    "wo": ("attn.out.weight", True, False),
    "bo": ("attn.out.bias", False, False),
    "mlp_ln_g": ("mlp_ln.weight", False, True),
    "mlp_ln_b": ("mlp_ln.bias", False, True),
    "fc1_w": ("mlp.0.weight", True, False),
    "fc1_b": ("mlp.0.bias", False, False),
    "fc2_w": ("mlp.2.weight", True, False),
    "fc2_b": ("mlp.2.bias", False, False),
}
_CROSS_KEYS = {
    "cross_ln_g": ("cross_attn_ln.weight", False, True),
    "cross_ln_b": ("cross_attn_ln.bias", False, True),
    "cross_wq": ("cross_attn.query.weight", True, False),
    "cross_bq": ("cross_attn.query.bias", False, False),
    "cross_wk": ("cross_attn.key.weight", True, False),
    "cross_wv": ("cross_attn.value.weight", True, False),
    "cross_bv": ("cross_attn.value.bias", False, False),
    "cross_wo": ("cross_attn.out.weight", True, False),
    "cross_bo": ("cross_attn.out.bias", False, False),
}


def params_from_openai_tensors(t: Dict[str, np.ndarray], cfg: WhisperConfig,
                               dtype=np.float32) -> Params:
    """OpenAI-named tensors (GGML files use these names) -> the reference's
    stacked parameter tree of numpy arrays: per-layer leaves stacked on a
    leading [L] axis, linear weights transposed from [out, in] on disk to
    [in, out], layer-norm gains and biases f32, everything else `dtype`."""
    def stack(side, n, keys):
        out = {}
        for our, (name, transpose, f32) in keys.items():
            arrs = []
            for i in range(n):
                a = t[f"{side}.blocks.{i}.{name}"]
                if transpose:
                    a = np.ascontiguousarray(a.T)
                arrs.append(a.astype(np.float32 if f32 else dtype))
            out[our] = np.stack(arrs, axis=0)
        return out

    dec_blocks = stack("decoder", cfg.n_text_layer, _BLOCK_KEYS)
    dec_blocks.update(stack("decoder", cfg.n_text_layer, _CROSS_KEYS))
    return {
        "encoder": {
            "conv1_w": t["encoder.conv1.weight"].astype(dtype),
            "conv1_b": t["encoder.conv1.bias"].astype(dtype),
            "conv2_w": t["encoder.conv2.weight"].astype(dtype),
            "conv2_b": t["encoder.conv2.bias"].astype(dtype),
            "blocks": stack("encoder", cfg.n_audio_layer, _BLOCK_KEYS),
            "ln_g": t["encoder.ln_post.weight"].astype(np.float32),
            "ln_b": t["encoder.ln_post.bias"].astype(np.float32),
        },
        "decoder": {
            "tok_emb": t["decoder.token_embedding.weight"].astype(dtype),
            "pos_emb": t["decoder.positional_embedding"].astype(dtype),
            "blocks": dec_blocks,
            "ln_g": t["decoder.ln.weight"].astype(np.float32),
            "ln_b": t["decoder.ln.bias"].astype(np.float32),
        },
    }


_HF_TO_OPENAI = [
    ("model.encoder.conv1.", "encoder.conv1."),
    ("model.encoder.conv2.", "encoder.conv2."),
    ("model.encoder.layer_norm.", "encoder.ln_post."),
    ("model.decoder.embed_tokens.weight", "decoder.token_embedding.weight"),
    ("model.decoder.embed_positions.weight", "decoder.positional_embedding"),
    ("model.decoder.layer_norm.", "decoder.ln."),
]

_HF_LAYER_MAP = {
    "self_attn.q_proj": "attn.query",
    "self_attn.k_proj": "attn.key",
    "self_attn.v_proj": "attn.value",
    "self_attn.out_proj": "attn.out",
    "self_attn_layer_norm": "attn_ln",
    "encoder_attn.q_proj": "cross_attn.query",
    "encoder_attn.k_proj": "cross_attn.key",
    "encoder_attn.v_proj": "cross_attn.value",
    "encoder_attn.out_proj": "cross_attn.out",
    "encoder_attn_layer_norm": "cross_attn_ln",
    "fc1": "mlp.0",
    "fc2": "mlp.2",
    "final_layer_norm": "mlp_ln",
}


def hf_to_openai_names(t: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rename HF WhisperForConditionalGeneration tensors to OpenAI names.
    The output projection (tied to the token embedding) and any name
    without a counterpart are dropped; the encoder's stored positions
    become encoder.positional_embedding (unused: the encoder computes its
    sinusoids)."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in t.items():
        mapped = None
        for pre, sub in _HF_TO_OPENAI:
            if name.startswith(pre):
                mapped = sub + name[len(pre):]
                break
        if mapped is None:
            for side in ("encoder", "decoder"):
                pre = f"model.{side}.layers."
                if name.startswith(pre):
                    idx, sub = name[len(pre):].split(".", 1)
                    for hf_key, oa_key in _HF_LAYER_MAP.items():
                        if sub.startswith(hf_key + "."):
                            tail = sub[len(hf_key) + 1:]
                            mapped = f"{side}.blocks.{idx}.{oa_key}.{tail}"
                            break
                    break
        if mapped is None and name == "model.encoder.embed_positions.weight":
            mapped = "encoder.positional_embedding"
        if mapped is not None:
            out[mapped] = arr
    return out


def _hf_config(model_dir: str) -> WhisperConfig:
    """WhisperConfig from an HF directory's config.json."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return WhisperConfig(
        name=os.path.basename(model_dir), n_mels=hf["num_mel_bins"],
        n_audio_ctx=hf["max_source_positions"], n_audio_state=hf["d_model"],
        n_audio_head=hf["encoder_attention_heads"],
        n_audio_layer=hf["encoder_layers"], n_vocab=hf["vocab_size"],
        n_text_ctx=hf["max_target_positions"], n_text_state=hf["d_model"],
        n_text_head=hf["decoder_attention_heads"],
        n_text_layer=hf["decoder_layers"],
    )


def load_params(model_path: str, cfg: Optional[WhisperConfig] = None,
                dtype=np.float32):
    """A Whisper checkpoint: a spittle .npz, an HF safetensors directory
    (its config.json gives the config unless `cfg` is passed) or a GGML
    file -> (cfg, the stacked parameter tree of numpy arrays, extras).
    extras may hold "mel_filters" [n_mels, 201] and "vocab" (token bytes
    by id): a GGML file embeds both, an .npz may embed the vocabulary."""
    if model_path.endswith(".npz"):
        return load_npz_checkpoint(model_path, dtype=dtype)
    extras: Dict[str, Any] = {}
    if os.path.isdir(model_path):
        tensors = hf_to_openai_names(load_safetensors_dir(model_path))
        if cfg is None:
            cfg = _hf_config(model_path)
    else:
        cfg_g, tensors, filters, vocab = load_ggml(model_path)
        cfg = cfg or cfg_g
        extras["mel_filters"] = filters
        extras["vocab"] = vocab
    return cfg, params_from_openai_tensors(tensors, cfg, dtype=dtype), extras


def moe_leaf_init(d: int, experts: int, layers: int) -> dict:
    """The routed MoE FFN's encoder leaves in the reference's init
    (model.py:170-181), stacked [L, ...] like every block leaf: name ->
    (shape, scale of a standard normal draw, f32). f32 marks the top-1
    router, which stays f32 whatever the weights' dtype."""
    f = 4 * d
    return {"moe_router": ((layers, d, experts), d ** -0.5, True),
            "moe_w_in": ((layers, experts, d, f), d ** -0.5, False),
            "moe_w_out": ((layers, experts, f, d), f ** -0.5, False)}


def random_params(cfg: WhisperConfig, seed: int = 0, dtype=torch.float32,
                  device="cpu") -> Params:
    """Random-normal weights at the reference's init_params scales, drawn
    from numpy's default_rng(seed) leaf by leaf (the reference draws from
    jax.random, which numpy cannot reproduce: the same seed gives other
    numbers). Layer norms are ones/zeros in f32, biases and pos_emb zeros,
    everything else `dtype` on `device`. For cfg.moe_experts > 0 the
    encoder blocks carry moe_router [L, D, E] (f32), moe_w_in [L, E, D, 4D]
    and moe_w_out [L, E, 4D, D] in place of fc1_*/fc2_*, at the
    reference's scales; the decoder stays dense."""
    rng = np.random.default_rng(seed)
    d = cfg.n_audio_state

    def w(shape, scale, dt=dtype):
        if len(shape) < 3:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(scale)
            return torch.from_numpy(a).to(device=device, dtype=dt)
        # A stacked leaf one layer at a time: the same numbers as one draw
        # of the whole shape, with a host buffer of one layer.
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):
            out[i] = w(shape[1:], scale, dt)
        return out

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones32(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def stack(layers, cross, moe=0):
        mlp_d = 4 * d
        scale = d ** -0.5
        blocks = {
            "attn_ln_g": ones32((layers, d)),
            "attn_ln_b": zeros((layers, d), torch.float32),
            "wq": w((layers, d, d), scale),
            "wk": w((layers, d, d), scale),
            "wv": w((layers, d, d), scale),
            "wo": w((layers, d, d), scale),
            "bq": zeros((layers, d)),
            "bv": zeros((layers, d)),
            "bo": zeros((layers, d)),
            "mlp_ln_g": ones32((layers, d)),
            "mlp_ln_b": zeros((layers, d), torch.float32),
        }
        if moe:
            blocks.update({k: w(shape, s, torch.float32 if f32 else dtype)
                           for k, (shape, s, f32)
                           in moe_leaf_init(d, moe, layers).items()})
        else:
            blocks.update({
                "fc1_w": w((layers, d, mlp_d), scale),
                "fc1_b": zeros((layers, mlp_d)),
                "fc2_w": w((layers, mlp_d, d), (2 * mlp_d) ** -0.5),
                "fc2_b": zeros((layers, d)),
            })
        if cross:
            blocks.update({
                "cross_ln_g": ones32((layers, d)),
                "cross_ln_b": zeros((layers, d), torch.float32),
                "cross_wq": w((layers, d, d), scale),
                "cross_wk": w((layers, d, d), scale),
                "cross_wv": w((layers, d, d), scale),
                "cross_wo": w((layers, d, d), scale),
                "cross_bq": zeros((layers, d)),
                "cross_bv": zeros((layers, d)),
                "cross_bo": zeros((layers, d)),
            })
        return blocks

    encoder = {
        "conv1_w": w((d, cfg.n_mels, 3), (3 * cfg.n_mels) ** -0.5),
        "conv1_b": zeros((d,)),
        "conv2_w": w((d, d, 3), (3 * d) ** -0.5),
        "conv2_b": zeros((d,)),
        "blocks": stack(cfg.n_audio_layer, False, cfg.moe_experts),
        "ln_g": ones32((d,)),
        "ln_b": zeros((d,), torch.float32),
    }
    decoder = {
        "tok_emb": w((cfg.n_vocab, d), d ** -0.5),
        "pos_emb": zeros((cfg.n_text_ctx, d)),
        "blocks": stack(cfg.n_text_layer, True),
        "ln_g": ones32((d,)),
        "ln_b": zeros((d,), torch.float32),
    }
    return {"encoder": encoder, "decoder": decoder}
