"""Whisper encoder-decoder forward passes in PyTorch (port of
spittle_tpu/models/whisper/model.py).

Parameters are the reference's tree as nested dicts of tensors: every
per-layer weight carries a leading [L] axis (see weights.py). Weights
default to bf16 with f32 layer norms and logits; layer norms compute in
f32.

Layouts:
- encoder activations [B, T, D]; attention heads are strided views of the
  packed [B, T, H*Dh] projections (K1, K7 and K10 read them in place),
  or the packed tensors themselves (K8, K9);
- cross-attention K/V in the decode layout [L, B, H, Dh, T] (time minor),
  the layout K4 streams;
- the decoder self-attention cache is ctx-major [L, 2, B, H, ctx, Dh] and
  is written in place one column per step, then attended (the reference
  attends its fresh column in registers before a bulk write; both compute
  the same function).

Quantized forms (the large-v3 leg): cross-K/V as int8 dicts {"qw" [L, B,
H, Dh, T], "scale" [L, B, H, T]} (K3 on the card), the same bytes as
{"qw8", "scale"} for the "w8a8" decoder, whose two cross-attention
products are int8 x int8 with q and P quantized per row (K14 on the card,
at any number of rows), or packed int4 {"qw4" [L, B, H, Dh/2, T],
"scale"} (K6), and an int8 self-cache {"qw" [L, 2, B, H, ctx, Dh],
"scale" [L, 2, B, H, ctx]}, one f32 scale per position.

Under a mesh (parallel/mesh.py: a tree from shard_params, a batch split
over "data" as a DTensor), every entry point computes the global
function, as GSPMD gives the reference's: it runs on local_params' local
shards and calls the collectives itself (a group split over "model" holds
its own heads or columns, its row-parallel product is summed over "model"
before the bias, the vocab-sharded embedding is masked and summed and the
logits gathered; the MoE FFN is parallel/expert_parallel.py's). The
self-cache and cross-K/V then hold this rank's heads.

decode_block scores K positions in one pass (speculative decoding's
verify). Its start position is clamped as JAX's dynamic_slice and
dynamic_update_slice clamp theirs: the position embeddings are read from
min(pos, n_text_ctx - K) and the columns written from min(pos, ctx - K),
while the causal mask keeps the unclamped pos + j; decode_step clamps the
same way (K = 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spittle_tpu_torch.ops.attention import (
    attention_reference,
    decode_cross_attention,
    decode_cross_attention_q4,
    decode_cross_attention_q8,
    decode_cross_attention_w8a8,
    merge_heads,
    multihead_attention,
    multihead_attention_packed,
    split_heads,
    tma_pitch,
)
from spittle_tpu_torch.ops.quant import (
    is_quant_kv4,
    is_quant_w8a8,
    kv_codes,
    mm,
    mm_bias,
    quantize_kv_t,
    unpack_kv_int4,
)
from spittle_tpu_torch.ops.w8a8_gemm import quantize_for_gemm
from spittle_tpu_torch.parallel.mesh import (
    ShardGroups,
    like_rows,
    local_params,
    local_rows,
    shard_groups,
)

from .config import WhisperConfig

Params = Dict[str, Any]
_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Small building blocks
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 (eps 1e-5), cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (out * g + b).to(x.dtype)


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper encoder positional embedding (log-spaced sinusoids)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32
    )


def layer_params(blocks, layer: int):
    """Layer `layer` of a stacked block tree, quantized dict or tensor."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, layer) for k, v in blocks.items()}
    return blocks[layer]


def n_layers(blocks: Params) -> int:
    leaf = blocks["attn_ln_g"]
    return leaf.shape[0]


def _split(sh: Optional[ShardGroups], stack: str, group: str
           ) -> Optional[ShardGroups]:
    """sh when `group` of the `stack` blocks runs split over "model"."""
    return sh if sh is not None and sh.splits(stack, group) else None


def _heads(n_head: int, tp: Optional[ShardGroups]) -> int:
    """The heads this rank holds of a group (all of them unsplit)."""
    return n_head if tp is None else n_head // tp.tp


def _row_parallel(x, w, b, tp: Optional[ShardGroups]):
    """x @ w + b; split over "model", the partial products are summed
    before the replicated bias is added (a bias before the sum would
    count tp times)."""
    if tp is None:
        return mm_bias(x, w, b)
    return tp.reduce(mm(x, w)) + b


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _attn_full(x, blk, n_head: int, causal: bool, attention: str = "fullkv",
               tp: Optional[ShardGroups] = None):
    """Self-attention over a full sequence. q and k carry Whisper's split
    Dh^-0.25 scaling (folded into the projection epilogue). attention: the
    encoder-attention form (ops.attention.ENCODER_ATTENTION_FORMS). tp:
    the block's attention split over "model" (this rank's heads)."""
    scale = (x.shape[-1] // n_head) ** -0.25
    if all(is_quant_w8a8(blk[key]) for key in ("wq", "wk", "wv")):
        x = quantize_for_gemm(x)  # one row quantizer for the three GEMMs
    q = mm_bias(x, blk["wq"], blk["bq"], out_scale=scale)
    k = mm_bias(x, blk["wk"], out_scale=scale)
    v = mm_bias(x, blk["wv"], blk["bv"])
    o = multihead_attention_packed(q, k, v, _heads(n_head, tp),
                                   causal=causal, form=attention)
    return _row_parallel(o, blk["wo"], blk["bo"], tp)


def _mlp(x, blk, tp: Optional[ShardGroups] = None):
    h = mm_bias(x, blk["fc1_w"], blk["fc1_b"], act="gelu")
    return _row_parallel(h, blk["fc2_w"], blk["fc2_b"], tp)


def _moe_mlp_aux(x: torch.Tensor, blk, tp: Optional[ShardGroups] = None,
                 data_group=None):
    """The Switch top-1 routed MoE FFN of a MoE encoder block over all
    B * T tokens of the call at once (capacity and drops depend on the
    whole batch): (out [B, T, D], the load-balancing aux loss). tp: the
    experts split over "model"; data_group: the "data" group when x's rows
    are this rank's shard of a batch split over "data"."""
    from spittle_tpu_torch.parallel.expert_parallel import moe_ffn_local

    b, t, d = x.shape
    out, aux = moe_ffn_local(
        blk["moe_router"], blk["moe_w_in"], blk["moe_w_out"],
        x.reshape(-1, d), data_group=data_group,
        model_group=None if tp is None else tp.model_group,
        model_rank=0 if tp is None else tp.model_rank)
    return out.reshape(b, t, d), aux["aux_loss"]


def _moe_mlp(x: torch.Tensor, blk, tp: Optional[ShardGroups] = None,
             data_group=None) -> torch.Tensor:
    return _moe_mlp_aux(x, blk, tp, data_group)[0]


def encoder_block_body_aux(h: torch.Tensor, blk, n_head: int,
                           attention: str = "fullkv",
                           sh: Optional[ShardGroups] = None,
                           data_group=None):
    """One encoder block (pre-LN attention + MLP residuals): (h, the MoE
    FFN's Switch load-balancing loss, or None for a dense block). A block
    that carries moe_* leaves takes the routed MoE FFN in place of the
    dense MLP. sh: the ShardGroups of a sharded tree; data_group: see
    _moe_mlp_aux."""
    h = h + _attn_full(layer_norm(h, blk["attn_ln_g"], blk["attn_ln_b"]),
                       blk, n_head, causal=False, attention=attention,
                       tp=_split(sh, "encoder", "attn"))
    xn = layer_norm(h, blk["mlp_ln_g"], blk["mlp_ln_b"])
    if "moe_w_in" in blk:
        out, aux = _moe_mlp_aux(xn, blk, _split(sh, "encoder", "moe"),
                                data_group)
        return h + out, aux
    return h + _mlp(xn, blk, _split(sh, "encoder", "mlp")), None


def encoder_block_body(h: torch.Tensor, blk, n_head: int,
                       attention: str = "fullkv",
                       sh: Optional[ShardGroups] = None,
                       data_group=None) -> torch.Tensor:
    """encoder_block_body_aux's h alone; pipeline_apply's stages run it as
    it is."""
    return encoder_block_body_aux(h, blk, n_head, attention, sh, data_group)[0]


def _stem_gemm(enc, mel: torch.Tensor) -> torch.Tensor:
    """The conv stem as two im2col GEMMs: mel [B, n_mels, frames] ->
    [B, frames / 2, D] (the reference's _stem_gemm, its
    SPITTLE_STEM_GEMM=1 form, measured slower than the convolutions on its
    TPU and kept as an option). A k=3 conv is a [3 * C_in, C_out] product
    over unfolded windows: three strided slices and one concat in
    time-major order, k-major with C within k, matching w.permute(2, 1,
    0).reshape(3 * C, D)."""
    w1, w2 = enc["conv1_w"], enc["conv2_w"]  # [D, C, 3], [D, D, 3]
    d, c, _ = w1.shape
    xt = mel.to(w1.dtype).transpose(1, 2)  # [B, T, C]
    t = xt.shape[1]
    assert t % 2 == 0, t
    xp = F.pad(xt, (0, 0, 1, 1))
    cat1 = torch.cat([xp[:, 0:t], xp[:, 1:t + 1], xp[:, 2:t + 2]], dim=-1)
    h = F.gelu(cat1 @ w1.permute(2, 1, 0).reshape(3 * c, d) + enc["conv1_b"])
    hp = F.pad(h, (0, 0, 1, 1))  # [B, T + 2, D]
    cat2 = torch.cat([hp[:, 0:t:2], hp[:, 1:t + 1:2], hp[:, 2:t + 2:2]], dim=-1)
    return F.gelu(cat2 @ w2.permute(2, 1, 0).reshape(3 * d, d) + enc["conv2_b"])


def _encoder_stem(enc, mel: torch.Tensor, cfg: WhisperConfig,
                  positions: Optional[torch.Tensor] = None,
                  stem_gemm: bool = False) -> torch.Tensor:
    """Conv stem + positions: mel [B, n_mels, frames] -> [B, T, D].
    positions: sinusoidal_positions(n_audio_ctx, n_audio_state) already on
    x's device in x's dtype (a caller that encodes many batches keeps it);
    made here when None. stem_gemm: the stem as two im2col GEMMs
    (_stem_gemm; the reference's SPITTLE_STEM_GEMM=1) in place of the
    convolutions."""
    if stem_gemm:
        x = _stem_gemm(enc, mel).contiguous()
    else:
        w1 = enc["conv1_w"]
        x = F.conv1d(mel.to(w1.dtype), w1, stride=1, padding=1)
        x = F.gelu(x + enc["conv1_b"][None, :, None])
        x = F.conv1d(x, enc["conv2_w"], stride=2, padding=1)
        x = F.gelu(x + enc["conv2_b"][None, :, None])
        # [B, T, D] in row-major order: the transposed view's strides would
        # carry through every block, and at B = 1 a row view of them is not
        # contiguous, which K2's row quantizer refuses.
        x = x.transpose(1, 2).contiguous()
    pos = positions
    if pos is None:
        pos = torch.from_numpy(
            sinusoidal_positions(cfg.n_audio_ctx, cfg.n_audio_state)
        ).to(device=x.device, dtype=x.dtype)
    # A mel shorter than the full window encodes with the FIRST T positions.
    return x + pos[None, : x.shape[1]]


def _encode(params: Params, mel, cfg: WhisperConfig, attention: str,
            positions: Optional[torch.Tensor], stem_gemm: bool = False,
            data_group=None):
    """(features, aux) of encode_with_aux. data_group: the "data" group
    when mel is this rank's rows as a plain tensor (the train step's);
    a mel that is a DTensor brings its own."""
    params = local_params(params)
    sh = shard_groups(params)
    mel, spec, group = local_rows(mel)
    data_group = group if group is not None else data_group
    enc = params["encoder"]
    x = _encoder_stem(enc, mel, cfg, positions, stem_gemm)
    blocks = enc["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_layers(blocks)):
        x, layer_aux = encoder_block_body_aux(
            x, layer_params(blocks, layer), cfg.n_audio_head, attention, sh,
            data_group)
        if layer_aux is not None:
            aux = aux + layer_aux
    return like_rows(layer_norm(x, enc["ln_g"], enc["ln_b"]), spec), aux


def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
           attention: str = "fullkv",
           positions: Optional[torch.Tensor] = None,
           stem_gemm: bool = False) -> torch.Tensor:
    """mel [B, n_mels, frames] -> audio features [B, frames / 2, D], at
    most cfg.n_audio_ctx positions (1500 for the stock models). attention:
    the encoder-attention form, one of ops.attention.ENCODER_ATTENTION_FORMS
    (the reference reads it from the environment). positions, stem_gemm:
    see _encoder_stem. A mel that is a DTensor split over "data" gives the
    features as one (the MoE FFN then routes over the global batch).
    Differentiable: under autograd the attention runs as K1 with K15 as
    its backward (ops.attention.multihead_attention)."""
    return _encode(params, mel, cfg, attention, positions, stem_gemm)[0]


def encode_with_aux(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
                    attention: str = "fullkv",
                    positions: Optional[torch.Tensor] = None,
                    stem_gemm: bool = False):
    """encode() that also returns the MoE aux loss SUMMED over layers (the
    training objective's: Switch applies alpha to each layer's loss); 0
    for a dense config."""
    return _encode(params, mel, cfg, attention, positions, stem_gemm)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _padded_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised [n, *a.shape] buffer for n layers of `a` (time
    last) whose rows are tma_pitch(T) elements apart: a view of the
    logical shape."""
    t = a.shape[-1]
    return a.new_empty((n, *a.shape[:-1], tma_pitch(t, a.element_size())))[..., :t]


def cross_heads(params: Params, cfg: WhisperConfig) -> int:
    """The cross-attention heads this rank holds (all of them unsharded)."""
    return _heads(cfg.n_text_head, _split(shard_groups(params), "decoder",
                                          "cross"))


def self_heads(params: Params, cfg: WhisperConfig) -> int:
    """The self-attention heads (and self-cache heads) this rank holds."""
    return _heads(cfg.n_text_head, _split(shard_groups(params), "decoder",
                                          "attn"))


def precompute_cross_kv(params: Params, xa: torch.Tensor, cfg: WhisperConfig):
    """Per-layer cross-attention K/V from the encoder output, each
    [L, B, H, Dh, T]: the decode layout (time minor) that K4 streams.

    The rows are stored tma_pitch(T) elements apart (1504 for T 1500: a
    multiple of 16 bytes, 0.27% more bytes, never read past T) and
    returned as views of the logical shape, so that K4 can load them by
    TMA; the values are the stacked projections'. Under a mesh, this
    rank's heads."""
    params = local_params(params)
    blocks = params["decoder"]["blocks"]
    h = cross_heads(params, cfg)
    n = n_layers(blocks)
    out = None
    for layer in range(n):
        blk = layer_params(blocks, layer)
        k = split_heads(mm(xa, blk["cross_wk"]), h).transpose(-1, -2)
        v = split_heads(mm(xa, blk["cross_wv"]) + blk["cross_bv"], h
                         ).transpose(-1, -2)
        if out is None:
            out = (_padded_rows(k, n), _padded_rows(v, n))
        out[0][layer].copy_(k)
        out[1][layer].copy_(v)
    return out


def _cross_kv_buffer(key: str, a: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised [n, *a.shape] buffer for n layers of `a`; for the
    int8 "qw" and "qw8" and the packed int4 "qw4" a view of one whose rows
    are tma_pitch(T) apart."""
    if key not in ("qw", "qw8", "qw4"):
        return a.new_empty((n, *a.shape))
    return _padded_rows(a, n)


def precompute_cross_kv_quant(params: Params, xa: torch.Tensor,
                              cfg: WhisperConfig, quant):
    """precompute_cross_kv fused with K/V quantization, one layer at a
    time (the reference's fused precompute_cross_kv_q8): only one layer's
    bf16/f32 intermediates are ever live. quant is quantize_kv (int8:
    {"qw" int8 [L, B, H, Dh, T], "scale" f32 [L, B, H, T]}),
    quantize_kv_w8a8 (the same bytes as {"qw8", "scale"}; the reference
    quantizes the stacked precompute_cross_kv, the same numbers per layer)
    or quantize_kv_int4 ({"qw4" int8 [L, B, H, Dh/2, T], "scale"}).
    Returns the K dict and the V dict.

    The int8 "qw"/"qw8" and packed int4 "qw4" rows are stored
    tma_pitch(T) bytes apart (1504 for T 1500: 0.27% more bytes, never
    read past T) and returned as views of the logical shape, so that K3
    and K6 can load them by TMA; the values are those of quant's. The
    scales are contiguous."""
    params = local_params(params)
    blocks = params["decoder"]["blocks"]
    h = cross_heads(params, cfg)
    n = n_layers(blocks)
    out = None
    for layer in range(n):
        blk = layer_params(blocks, layer)
        k = split_heads(mm(xa, blk["cross_wk"]), h).transpose(-1, -2)
        v = split_heads(mm(xa, blk["cross_wv"]) + blk["cross_bv"], h
                         ).transpose(-1, -2)
        qkv = (quant(k), quant(v))
        if out is None:
            out = [{key: _cross_kv_buffer(key, a, n) for key, a in q.items()}
                   for q in qkv]
        for dst, src in zip(out, qkv):
            for key, a in src.items():
                dst[key][layer].copy_(a)
    return out[0], out[1]


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype=torch.float32,
                  ctx: int = 0, device="cpu", quant: bool = False,
                  heads: int = 0):
    """Self-attention cache [L, 2, B, H, ctx, Dh], zeros (ctx-major).
    quant: the int8 dict {"qw" int8 zeros, "scale" f32 ones [L, 2, B, H,
    ctx]}; columns are quantized as they are written. heads: H (default
    cfg.n_text_head; self_heads() under a mesh)."""
    shape = (
        cfg.n_text_layer, 2, batch, heads or cfg.n_text_head,
        ctx or cfg.n_text_ctx, cfg.n_text_state // cfg.n_text_head,
    )
    if quant:
        return {"qw": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.ones(shape[:5], dtype=torch.float32,
                                    device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def _cross_attention_quant(cq, ck, cv, dh: int, kv_len: int):
    """Cross-attention over int8 or packed int4 K/V dicts (qw/qw8/qw4
    [B, H, Dh or Dh/2, T], scale [B, H, T]). "qw8": K14 for any number of
    rows (int8 x int8 products; its plain version on the CPU). "qw" and
    "qw4": K3 or K6 for decode-sized queries, on shape alone; otherwise
    the reference's plain int8 math."""
    if is_quant_w8a8(ck):
        return decode_cross_attention_w8a8(
            cq * (dh ** -0.5), ck["qw8"], ck["scale"], cv["qw8"], cv["scale"],
            kv_len=kv_len or ck["qw8"].shape[-1])
    int4 = is_quant_kv4(ck)
    key = "qw4" if int4 else "qw"
    kvl = kv_len or ck[key].shape[-1]
    if cq.shape[2] <= 8 and dh in (64, 128):
        kernel = decode_cross_attention_q4 if int4 else decode_cross_attention_q8
        return kernel(cq * (dh ** -0.5), ck[key], ck["scale"], cv[key],
                      cv["scale"], kv_len=kvl)
    qk, qv = ck[key], cv[key]
    if int4:
        qk, qv = unpack_kv_int4(qk), unpack_kv_int4(qv)
    scores = torch.matmul((cq * (dh ** -0.5)).float(), qk.float()) \
        * ck["scale"][:, :, None, :]
    if kvl < qk.shape[-1]:
        cmask = torch.arange(qk.shape[-1], device=qk.device) < kvl
        scores = torch.where(cmask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul((probs * cv["scale"][:, :, None, :]).to(cq.dtype),
                        qv.to(cq.dtype).transpose(-1, -2))


def _cross_attention(cq, ck, cv, dh: int, kv_len: int = 0):
    """Cross-attention core for the decode and prefill paths.

    cq: [Bq, H, q, Dh]; ck/cv: [Bc, H, Dh, T] in the decode layout, or
    quantized dicts (see _cross_attention_quant), with Bq a multiple of
    Bc. Beam search shares one K/V among an item's Bq / Bc beams, so the
    beams fold into the query rows, [Bc, H, beams * q, Dh], before the
    route is decided on the folded rows, and unfold after it.
    kv_len: real length of K/V (0 = all of T)."""
    bq, h, q, d = cq.shape
    beams = bq // kv_codes(ck).shape[0]
    if beams > 1:
        cq = (cq.reshape(bq // beams, beams, h, q, d).transpose(1, 2)
              .reshape(bq // beams, h, beams * q, d))
    co = _cross_attention_rows(cq, ck, cv, dh, kv_len)
    if beams > 1:
        co = (co.reshape(bq // beams, h, beams, q, d).transpose(1, 2)
              .reshape(bq, h, q, d))
    return co


def _cross_attention_rows(cq, ck, cv, dh: int, kv_len: int):
    """_cross_attention with one K/V per query item: the kernel for
    decode-sized queries, else plain ops."""
    if isinstance(ck, dict):
        return _cross_attention_quant(cq, ck, cv, dh, kv_len)
    kvl = kv_len or ck.shape[-1]
    # K4 for decode-sized queries, on shape alone as the reference's
    # use_decode_cross_kernel decides; its wrapper raises on CUDA for what
    # the kernel does not take.
    if cq.shape[2] <= 8 and dh in (64, 128):
        return decode_cross_attention(cq * (dh ** -0.5), ck, cv, kv_len=kvl)
    cscores = torch.matmul((cq * (dh ** -0.25)).float(),
                           (ck * (dh ** -0.25)).float())
    if kvl < ck.shape[-1]:
        cmask = torch.arange(ck.shape[-1], device=ck.device) < kvl
        cscores = torch.where(cmask, cscores, _NEG_INF)
    cprobs = torch.softmax(cscores, dim=-1)
    return torch.matmul(cprobs.to(cv.dtype), cv.transpose(-1, -2))


def _proj_qkv(h, blk, n_head: int, scale: float):
    """Self-attention projections: h [B, P, D] -> q, k, v [B, H, P, Dh];
    q and k pre-scaled by Dh^-0.25 (Whisper's split scaling)."""
    xn = layer_norm(h, blk["attn_ln_g"], blk["attn_ln_b"])
    q = split_heads(mm(xn, blk["wq"]) + blk["bq"], n_head) * scale
    k = split_heads(mm(xn, blk["wk"]), n_head) * scale
    v = split_heads(mm(xn, blk["wv"]) + blk["bv"], n_head)
    return q, k, v


def _reduced(y, tp: Optional[ShardGroups]):
    return y if tp is None else tp.reduce(y)


def _layer_rest(h, o, blk, ck, cv, n_head: int, cross_kv_len: int,
                sh: Optional[ShardGroups] = None):
    """Post-self-attention remainder of a decoder layer: output projection
    and residual, cross-attention, MLP. n_head: the model's; sh: the
    ShardGroups of a sharded tree."""
    h = h + _reduced(mm(merge_heads(o), blk["wo"]), _split(sh, "decoder", "attn")
                     ) + blk["bo"]
    xn = layer_norm(h, blk["cross_ln_g"], blk["cross_ln_b"])
    dh = xn.shape[-1] // n_head
    cross = _split(sh, "decoder", "cross")
    cq = split_heads(mm(xn, blk["cross_wq"]) + blk["cross_bq"],
                     _heads(n_head, cross))
    co = _cross_attention(cq, ck, cv, dh, kv_len=cross_kv_len)
    h = h + _reduced(mm(merge_heads(co), blk["cross_wo"]), cross) + blk["cross_bo"]
    return h + _mlp(layer_norm(h, blk["mlp_ln_g"], blk["mlp_ln_b"]), blk,
                    _split(sh, "decoder", "mlp"))


def _cache_write(cache, layer: int, k, v, start: int) -> None:
    """Write k/v [B, H, P, Dh] into cache columns start..start+P-1 of
    `layer`, in place; an int8 cache quantizes each column over Dh
    (quantize_kv_t)."""
    p = k.shape[2]
    if isinstance(cache, dict):
        q8 = quantize_kv_t(torch.stack([k, v]))
        cache["qw"][layer, :, :, :, start:start + p].copy_(q8["qw"])
        cache["scale"][layer, :, :, :, start:start + p].copy_(q8["scale"])
        return
    cache[layer, 0, :, :, start:start + p].copy_(k)
    cache[layer, 1, :, :, start:start + p].copy_(v)


def _causal_mask(n_ctx: int, pos: int, rows: int, device) -> torch.Tensor:
    """[rows, n_ctx]: row j (position pos + j) sees columns <= pos + j."""
    col = torch.arange(n_ctx, device=device)
    return col[None, :] <= pos + torch.arange(rows, device=device)[:, None]


def _clamped_start(pos: int, rows: int, n: int) -> int:
    """JAX's dynamic_slice / dynamic_update_slice start: pos clamped to
    [0, n - rows], so that `rows` entries fit below n."""
    return max(0, min(pos, n - rows))


def _cache_attend(q, cache_l, mask: torch.Tensor):
    """q [B, H, Q, Dh] over the columns of cache_l [2, B, H, ctx, Dh] that
    mask [Q, ctx] (_causal_mask) lets each row see: f32 scores, masked
    softmax, PV in the cache dtype.
    An int8 cache_l {"qw", "scale" [2, B, H, ctx]} scores (q . qK) * ks
    and takes ((p * vs) in q's dtype) . qV: the scales factor out of both
    products exactly."""
    if isinstance(cache_l, dict):
        qk, qv = cache_l["qw"][0], cache_l["qw"][1]
        ks, vs = cache_l["scale"][0], cache_l["scale"][1]
        scores = torch.matmul(q.float(), qk.float().transpose(-1, -2)) \
            * ks[:, :, None, :]
        scores = torch.where(mask, scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul((probs * vs[:, :, None, :]).to(q.dtype),
                            qv.to(q.dtype))
    k_all, v_all = cache_l[0], cache_l[1]
    scores = torch.matmul(q.float(), k_all.float().transpose(-1, -2))
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_all.dtype)
    return torch.matmul(probs, v_all)


def _embed(dec, tokens: torch.Tensor, start: int, n: int,
           sh: Optional[ShardGroups]) -> torch.Tensor:
    """Token embeddings of tokens [B, n] plus the position embeddings from
    `start`. A vocab-sharded table: each rank looks up the tokens in its
    rows, zeros elsewhere, and the lookups are summed over "model"."""
    table = dec["tok_emb"]
    if sh is None or not sh.vocab:
        emb = table[tokens]
    else:
        lo = sh.model_rank * table.shape[0]
        mine = (tokens >= lo) & (tokens < lo + table.shape[0])
        emb = sh.reduce(table[torch.where(mine, tokens - lo, 0)]
                        * mine[..., None].to(table.dtype))
    return (emb + dec["pos_emb"][None, start:start + n]).to(table.dtype)


def logits_from_hidden(params: Params, h: torch.Tensor) -> torch.Tensor:
    """f32 logits [..., V]; a vocab-sharded table's shards gathered."""
    params = local_params(params)
    sh = shard_groups(params)
    dec = params["decoder"]
    h = layer_norm(h, dec["ln_g"], dec["ln_b"])
    logits = (h @ dec["tok_emb"].T.to(h.dtype)).to(torch.float32)
    if sh is not None and sh.vocab:
        logits = sh.gather(logits, -1)
    return logits


def decode_step(params: Params, tokens: torch.Tensor, pos: int,
                kv_cache: torch.Tensor, cross_kv, cfg: WhisperConfig,
                audio_ctx: int = 0) -> torch.Tensor:
    """One K=1 decode step (the semantics of the reference's
    decode_step_tmajor): embeds `tokens` [B] at position `pos`, writes each
    layer's new K/V column into kv_cache [L, 2, B, H, ctx, Dh] (or the
    int8 dict) IN PLACE, attends over columns 0..pos, and returns logits
    [B, V] (f32). decode_block with K = 1, clamps and all."""
    return decode_block(params, tokens[:, None], pos, kv_cache, cross_kv, cfg,
                        audio_ctx)[:, 0]


def decode_block(params: Params, tokens: torch.Tensor, pos: int,
                 kv_cache, cross_kv, cfg: WhisperConfig,
                 audio_ctx: int = 0) -> torch.Tensor:
    """K-position decode (speculative decoding's verify pass): tokens
    [B, K] at positions pos..pos+K-1 write their K/V columns into kv_cache
    IN PLACE and attend causally (row j over columns <= pos + j); returns
    logits [B, K, V] (f32). Past the end, the reference's clamps: the
    position embeddings start at min(pos, n_text_ctx - K) and the columns
    at min(pos, ctx - K), the mask keeping pos + j. Columns above the
    accepted point hold stale draft K/V that later blocks overwrite."""
    params = local_params(params)
    sh = shard_groups(params)
    dec = params["decoder"]
    b, kk = tokens.shape
    n_head = cfg.n_text_head
    scale = (cfg.n_text_state // n_head) ** -0.25
    n_ctx = (kv_cache["qw"] if isinstance(kv_cache, dict) else kv_cache).shape[4]
    x = _embed(dec, tokens, _clamped_start(pos, kk, dec["pos_emb"].shape[0]),
               kk, sh)
    start = _clamped_start(pos, kk, n_ctx)
    mask = _causal_mask(n_ctx, pos, kk, x.device)
    heads = self_heads(params, cfg)
    blocks = dec["blocks"]
    for layer in range(n_layers(blocks)):
        blk = layer_params(blocks, layer)
        q, k_new, v_new = _proj_qkv(x, blk, heads, scale)
        _cache_write(kv_cache, layer, k_new, v_new, start)
        o = _cache_attend(q, layer_params(kv_cache, layer), mask)
        x = _layer_rest(x, o, blk, layer_params(cross_kv[0], layer),
                        layer_params(cross_kv[1], layer), n_head,
                        audio_ctx or cfg.n_audio_ctx, sh)
    return logits_from_hidden(params, x)


def decoder_prefill(params: Params, tokens: torch.Tensor, cross_kv,
                    cfg: WhisperConfig, ctx: int, quant_cache: bool = False
                    ) -> Tuple[torch.Tensor, Any]:
    """Teacher-forced prefix pass: tokens [B, P] -> (logits [B, P, V] f32,
    cache [L, 2, B, H, ctx, Dh] holding positions 0..P-1, K pre-scaled).
    quant_cache: the int8 dict cache, each prefix column quantized over
    Dh; the prefix's own attention uses the unquantized K/V."""
    params = local_params(params)
    sh = shard_groups(params)
    dec = params["decoder"]
    b, p = tokens.shape
    h = cfg.n_text_head
    x = _embed(dec, tokens, 0, p, sh)
    scale = (cfg.n_text_state // h) ** -0.25
    heads = self_heads(params, cfg)
    cache = init_kv_cache(cfg, b, dtype=x.dtype, ctx=ctx, device=x.device,
                          quant=quant_cache, heads=heads)
    blocks = dec["blocks"]
    for layer in range(n_layers(blocks)):
        blk = layer_params(blocks, layer)
        q, k, v = _proj_qkv(x, blk, heads, scale)
        o = multihead_attention(q, k, v, causal=True)
        _cache_write(cache, layer, k, v, 0)
        x = _layer_rest(x, o, blk, layer_params(cross_kv[0], layer),
                        layer_params(cross_kv[1], layer), h, 0, sh)
    return logits_from_hidden(params, x), cache


def decoder_forward(params: Params, tokens: torch.Tensor, xa: torch.Tensor,
                    cfg: WhisperConfig) -> torch.Tensor:
    """Teacher-forced decoder over a full token sequence: tokens [B, T],
    encoder output xa [B, T_audio, D] -> logits [B, T, V] (f32), the
    training objective's forward (the reference's decoder_forward).

    The causal self-attention goes through multihead_attention_packed, so
    K1 (K15 backward) at T >= 128 and plain ops below; the cross-attention
    is attention_reference over exactly xa's T_audio positions, as in the
    reference: precompute_cross_kv's rows are stored tma_pitch(T_audio)
    apart and attended through their logical views. Differentiable (no
    inference_mode anywhere on the path). Under a mesh, this rank's heads
    and the collectives of the sharded groups, as in decode_block."""
    params = local_params(params)
    sh = shard_groups(params)
    dec = params["decoder"]
    b, t = tokens.shape
    n_head = cfg.n_text_head
    x = _embed(dec, tokens, 0, t, sh)
    cross_k, cross_v = precompute_cross_kv(params, xa, cfg)
    cross = _split(sh, "decoder", "cross")
    blocks = dec["blocks"]
    for layer in range(n_layers(blocks)):
        blk = layer_params(blocks, layer)
        x = x + _attn_full(layer_norm(x, blk["attn_ln_g"], blk["attn_ln_b"]),
                           blk, n_head, causal=True,
                           tp=_split(sh, "decoder", "attn"))
        xn = layer_norm(x, blk["cross_ln_g"], blk["cross_ln_b"])
        dh = xn.shape[-1] // n_head
        cq = split_heads(mm(xn, blk["cross_wq"]) + blk["cross_bq"],
                         _heads(n_head, cross)) * dh ** -0.25
        # [B, H, Dh, T] decode-layout views -> [B, H, T, Dh].
        ck = layer_params(cross_k, layer).transpose(-1, -2)
        cv = layer_params(cross_v, layer).transpose(-1, -2)
        o = attention_reference(cq, ck * dh ** -0.25, cv)
        x = x + _reduced(mm(merge_heads(o), blk["cross_wo"]), cross) \
            + blk["cross_bo"]
        x = x + _mlp(layer_norm(x, blk["mlp_ln_g"], blk["mlp_ln_b"]), blk,
                     _split(sh, "decoder", "mlp"))
    return logits_from_hidden(params, x)
