"""spittle_tpu_torch's quantized decoder against the JAX reference on the
CPU: the K/V and decoder quantizers, the plain versions of K3 (int8 decode
cross-attention) and K6 (int4) against the Pallas kernels in interpret
mode, the cross-attention dispatch over quantized dicts, and the int8
self-cache through prefill and decode steps on a random tiny Whisper.

Inputs are made with numpy.random.default_rng and cross between the two
packages as numpy arrays. Each comparison states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.ops import attention as jatt
from spittle_tpu.ops import quant as jquant
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import attention as tatt
from spittle_tpu_torch.ops import quant as tquant


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _eq(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


def _kv(shape, seed):
    rng = np.random.default_rng(seed)
    kv = rng.standard_normal(shape).astype(np.float32)
    kv[..., 0, :, 3] = 0.0  # an all-zero position takes scale 1
    kv[..., 1, 5, :] *= 20.0  # a head whose one row sets every amax
    return kv


@pytest.mark.parametrize("shape", [(2, 3, 64, 50), (2, 2, 3, 64, 37)])
def test_quantize_kv_bytes_equal(shape):
    kv = _kv(shape, 0)
    ref = jquant.quantize_kv(jnp.asarray(kv))
    got = tquant.quantize_kv(_t(kv))
    # The same IEEE division and round-half-even: bytes and scales equal.
    _eq(got["qw"], ref["qw"])
    _eq(got["scale"], ref["scale"])
    np.testing.assert_allclose(tquant.dequantize_kv(got, torch.float32).numpy(),
                               np.asarray(jquant.dequantize_kv(ref, jnp.float32)),
                               rtol=0, atol=0)


def test_quantize_kv_t_bytes_equal_and_transposes():
    kv = _kv((2, 3, 40, 64), 1)
    ref = jquant.quantize_kv_t(jnp.asarray(kv))
    got = tquant.quantize_kv_t(_t(kv))
    _eq(got["qw"], ref["qw"])
    _eq(got["scale"], ref["scale"])
    # The ctx-major form equals quantize_kv of the transpose.
    tr = tquant.quantize_kv(_t(kv).transpose(-1, -2))
    _eq(got["qw"], tr["qw"].transpose(-1, -2))
    _eq(got["scale"], tr["scale"])


@pytest.mark.parametrize("shape", [(2, 3, 64, 50), (3, 2, 2, 64, 37)])
def test_quantize_kv_int4_bytes_equal(shape):
    kv = _kv(shape, 2)
    ref = jquant.quantize_kv_int4(jnp.asarray(kv))
    got = tquant.quantize_kv_int4(_t(kv))
    # Packed bytes equal (the reference maps its 5-D form over layers).
    # Scales equal for one layer; inside the reference's lax.map over
    # layers XLA computes amax / 7 an f32 ulp off the IEEE quotient
    # (as its fused int8 cross-K/V does, ROADMAP queue 3), so there they
    # agree to 1 ulp (rtol 2.4e-7).
    rtol = 0 if len(shape) == 4 else 2.4e-7
    _eq(got["qw4"], ref["qw4"])
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(ref["scale"]),
                               rtol=rtol, atol=0)
    _eq(tquant.unpack_kv_int4(got["qw4"]), jquant.unpack_kv_int4(ref["qw4"]))
    np.testing.assert_allclose(
        tquant.dequantize_kv_int4(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize_kv_int4(ref, jnp.float32)), rtol=rtol,
        atol=0)


def test_quantize_kv_int4_stacked_equals_per_layer():
    # Every code and scale depends on its own position only, so a stacked
    # [L, ...] tensor quantizes to its per-layer results stacked, as the
    # fused cross-K/V builds them one layer at a time.
    kv = _t(_kv((3, 2, 2, 64, 37), 6))
    whole = tquant.quantize_kv_int4(kv)
    parts = [tquant.quantize_kv_int4(layer) for layer in kv]
    _eq(whole["qw4"], torch.stack([p["qw4"] for p in parts]))
    _eq(whole["scale"], torch.stack([p["scale"] for p in parts]))


def test_int4_pack_unpack_exact_on_every_nibble():
    # Every byte 0..255 (all 16 x 16 nibble pairs) unpacks as the
    # reference unpacks it, and every pair of values in -7..7 round-trips.
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    _eq(tquant.unpack_kv_int4(_t(every)), jquant.unpack_kv_int4(jnp.asarray(every)))
    # Dh 4: rows 0, 1 go to the low nibbles of stored rows 0, 1 and rows
    # 2, 3 to their high nibbles. Row 1 and 3 hold 7, so every position's
    # scale is 1 and its codes are exact; stored row 0 takes every (lo, hi)
    # pair of -7..7.
    pairs = np.array([(a, b) for a in range(-7, 8) for b in range(-7, 8)],
                     np.float32).T  # [2, 225]
    seven = np.full(225, 7.0, np.float32)
    kv = np.stack([pairs[0], seven, pairs[1], seven])
    packed = tquant.quantize_kv_int4(_t(kv))
    _eq(packed["qw4"], jquant.quantize_kv_int4(jnp.asarray(kv))["qw4"])
    np.testing.assert_array_equal(
        tquant.unpack_kv_int4(packed["qw4"]).numpy().astype(np.float32)
        * packed["scale"].numpy(), kv)


def test_quantize_whisper_decoder_bytes_equal():
    rng = np.random.default_rng(3)
    blocks = {k: rng.standard_normal((2, 32, 48)).astype(np.float32)
              for k in tquant.WHISPER_DECODER_QUANT_KEYS + ("cross_wk",)}
    blocks["cross_bv"] = rng.standard_normal((2, 48)).astype(np.float32)
    tree = {"encoder": {}, "decoder": {"blocks": blocks}}
    ref = jquant.quantize_whisper_decoder(
        jax.tree.map(jnp.asarray, tree))["decoder"]["blocks"]
    got = tquant.quantize_whisper_decoder(
        {"encoder": {}, "decoder": {"blocks": {k: _t(v) for k, v in blocks.items()}}}
    )["decoder"]["blocks"]
    assert tquant.WHISPER_DECODER_QUANT_KEYS == jquant.WHISPER_DECODER_QUANT_KEYS
    for k in tquant.WHISPER_DECODER_QUANT_KEYS:
        _eq(got[k]["qw"], ref[k]["qw"])
        _eq(got[k]["scale"], ref[k]["scale"])
    # The cross-K/V projections run once per window: left as they are.
    _eq(got["cross_wk"], blocks["cross_wk"])


def test_weight_only_mm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = jquant.quantize_weight(jnp.asarray(rng.standard_normal((32, 48)),
                                           jnp.float32))
    ref = jquant.mm(jnp.asarray(x), w)
    got = tquant.mm(_t(x), params_from_jax(w))
    # The same order ((x @ qw) * scale) in f32: summation order only.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# K3 and K6: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _quant_inputs(b, h, r, tk, kv_len, bits, seed):
    """bf16 q pre-scaled by Dh^-0.5 and quantized K/V whose columns from
    kv_len on are pad with scale 1.0 (codes kept: they must be masked)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, r, 64)) * 64 ** -0.5).astype(np.float32)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)  # bf16 values
    quant = jquant.quantize_kv if bits == 8 else jquant.quantize_kv_int4
    key = "qw" if bits == 8 else "qw4"
    out = [q]
    for _ in range(2):
        kv = quant(jnp.asarray(rng.standard_normal((b, h, 64, tk)), jnp.float32))
        scale = np.array(kv["scale"])
        scale[..., kv_len:] = 1.0
        out += [np.asarray(kv[key]), scale]
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("r", [1, 3, 4, 8])
@pytest.mark.parametrize("kv_len", [256, 200])
def test_decode_cross_quant_plain_matches_pallas_interpret(bits, r, kv_len):
    q, qk, ks, qv, vs = _quant_inputs(2, 3, r, 256, kv_len, bits, 10 + r)
    jfn = (jatt.decode_cross_attention_q8 if bits == 8
           else jatt.decode_cross_attention_q4)
    tfn = (tatt.decode_cross_attention_q8 if bits == 8
           else tatt.decode_cross_attention_q4)
    ref = jfn(jnp.asarray(q, jnp.bfloat16),
              *(jnp.asarray(a) for a in (qk, ks, qv, vs)),
              kv_len=kv_len, interpret=True)
    got = tfn(_t(q).bfloat16(), *(_t(a) for a in (qk, ks, qv, vs)),
              kv_len=kv_len)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, r, 64)
    # The same function in the same order: exact bf16 widening of the
    # codes, f32 dot, * scale, masked max, bf16(p * vs), f32 PV, / l. Only
    # the f32 summation order can differ, then one bf16 rounding of the
    # output (2**-8 relative): one bf16 ulp of the largest output.
    scale = float(np.abs(np.asarray(ref, np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=2.0 ** -8 * scale)


# ---------------------------------------------------------------------------
# Cross-attention dispatch over quantized dicts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("r,dh,kernel", [
    (1, 64, True),    # a decode step: K3 / K6
    (3, 64, True),    # the prefill's [sot, language, task]
    (9, 64, False),   # more rows than the kernels take: plain int8 math
    (1, 8, False),    # a head dim the reference keeps on plain ops
])
def test_cross_attention_quant_dispatch(monkeypatch, bits, r, dh, kernel):
    """The port picks K3/K6 on shape alone, on the CPU as on the card, and
    matches the reference's `_cross_attention` (its XLA path off the TPU)."""
    name = "decode_cross_attention_q8" if bits == 8 else "decode_cross_attention_q4"
    seen = []
    real = getattr(tmod, name)
    monkeypatch.setattr(tmod, name,
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    rng = np.random.default_rng(7)
    tk, kv_len = 96, 90
    cq = rng.standard_normal((2, 3, r, dh)).astype(np.float32)
    quant = jquant.quantize_kv if bits == 8 else jquant.quantize_kv_int4
    ck, cv = (quant(jnp.asarray(rng.standard_normal((2, 3, dh, tk)), jnp.float32))
              for _ in range(2))
    got = tmod._cross_attention(_t(cq), params_from_jax(ck), params_from_jax(cv),
                                dh, kv_len=kv_len)
    assert bool(seen) == kernel
    ref = np.asarray(jmod._cross_attention(jnp.asarray(cq), ck, cv, dh,
                                           kv_len=kv_len))
    if kernel:
        # The kernel route rounds p * vs to bf16 before PV (the TPU
        # kernel's order); the reference's f32 XLA path does not: 2**-9
        # relative per weight, averaged over the sum.
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=2.0 ** -8 * np.abs(ref).max())
    else:
        # f32 end to end; softmax order only.
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(quant_kv=True, quant_kv_bits=2), ValueError),
    (dict(quant_kv_bits=16), ValueError),
])
def test_decode_options_accept_only_4_or_8_bits(kwargs, exc):
    with pytest.raises(exc, match="4 or 8"):
        tdec.DecodeOptions(**kwargs)


# ---------------------------------------------------------------------------
# Model level: random tiny (Dh 64, 4+4 layers), int8 decoder and self-cache
# ---------------------------------------------------------------------------


JCFG = jcfg.CONFIGS["tiny"]
TCFG = tcfg.CONFIGS["tiny"]
AUDIO_T = 100  # encoder positions fed to the decoder (not a multiple of 16)


@pytest.fixture(scope="module")
def tiny_trees():
    """Numpy-drawn weights at the reference's init scales for the decoder
    (the encoder is not run here), weight-only int8 decoder quantized by
    the reference and carried across by params_from_jax."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jmod.init_params(JCFG))

    def fill(path, leaf):
        key = path[-1].key
        if key.endswith("ln_g"):
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif key.endswith(("_b", "ln_b", "bq", "bv", "bo")) or key == "pos_emb":
            a = 0.1 * rng.standard_normal(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) * leaf.shape[-2] ** -0.5
        return jnp.asarray(a, jnp.float32)

    jp = jquant.quantize_whisper_decoder(
        jax.tree_util.tree_map_with_path(fill, shapes))
    xa = rng.standard_normal((2, AUDIO_T, JCFG.n_audio_state)).astype(np.float32)
    return jp, params_from_jax(jp), xa


def test_params_from_jax_carries_quantized_dicts(tiny_trees):
    jp, tp, _ = tiny_trees
    blk_j, blk_t = jp["decoder"]["blocks"], tp["decoder"]["blocks"]
    for k in tquant.WHISPER_DECODER_QUANT_KEYS:
        assert set(blk_t[k]) == {"qw", "scale"}
        assert blk_t[k]["qw"].dtype == torch.int8
        _eq(blk_t[k]["qw"], blk_j[k]["qw"])
        _eq(blk_t[k]["scale"], blk_j[k]["scale"])
    kv = jquant.quantize_kv_int4(jnp.ones((2, 64, 5)))
    _eq(params_from_jax(kv)["qw4"], kv["qw4"])


def test_fused_cross_kv_q8_matches_reference(tiny_trees):
    jp, tp, xa = tiny_trees
    ref = jmod.precompute_cross_kv_q8(jp, jnp.asarray(xa), JCFG)
    got = tmod.precompute_cross_kv_quant(tp, _t(xa), TCFG, tquant.quantize_kv)
    for g, r in zip(got, ref):
        assert g["qw"].shape == (4, 2, 6, 64, AUDIO_T)
        # The projections differ by f32 summation order only, which can
        # flip a code sitting on a rounding tie by one; scales to f32
        # rounding (ROADMAP queue 3: the reference's own fused and
        # two-step forms differ by scale ulps).
        diff = np.abs(g["qw"].numpy().astype(np.int16)
                      - np.asarray(r["qw"]).astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(r["scale"]),
                                   rtol=1e-5)


def test_fused_cross_kv_int4_matches_reference(tiny_trees):
    """The port fuses int4 as it fuses int8; the reference projects the
    whole bf16 pair first, then quantizes it (decode.py's int4 arm)."""
    jp, tp, xa = tiny_trees
    ck_j, cv_j = jmod.precompute_cross_kv(jp, jnp.asarray(xa), JCFG)
    ref = (jquant.quantize_kv_int4(ck_j), jquant.quantize_kv_int4(cv_j))
    got = tmod.precompute_cross_kv_quant(tp, _t(xa), TCFG, tquant.quantize_kv_int4)
    for g, r in zip(got, ref):
        assert set(g) == {"qw4", "scale"}
        assert g["qw4"].shape == (4, 2, 6, 32, AUDIO_T)
        # As the int8 test: f32 summation order can flip a code on a
        # rounding tie by one; scales to f32 rounding.
        diff = np.abs(tquant.unpack_kv_int4(g["qw4"]).numpy().astype(np.int16)
                      - np.asarray(jquant.unpack_kv_int4(r["qw4"])).astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(r["scale"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_cache_prefill_and_steps_match_reference(tiny_trees, bits):
    """decoder_prefill(quant_cache=True) and decode_step over the int8
    cache with int8 or int4 cross-K/V, against the reference's prefill and
    decode_step_tmajor (its greedy loop's step form) on the same cross-K/V
    bytes."""
    jp, tp, xa = tiny_trees
    ck_j, cv_j = jmod.precompute_cross_kv(jp, jnp.asarray(xa), JCFG)
    quant = jquant.quantize_kv if bits == 8 else jquant.quantize_kv_int4
    cross_j = (quant(ck_j), quant(cv_j))
    cross_t = tuple(params_from_jax(c) for c in cross_j)
    ctx = 32
    prefix = np.array([[JCFG.sot, JCFG.lang_begin, JCFG.transcribe]] * 2, np.int32)
    lj, cache_j = jmod.decoder_prefill(jp, jnp.asarray(prefix), cross_j, JCFG,
                                       ctx, quant_cache=True)
    lt, cache_t = tmod.decoder_prefill(tp, _t(prefix).long(), cross_t, TCFG,
                                       ctx, quant_cache=True)
    # The cache is int8 with per-position scales; the port's is ctx-major.
    cache_j = jmod.transpose_cache_tmajor(cache_j)
    assert cache_t["qw"].shape == cache_j["qw"].shape == (4, 2, 2, 6, ctx, 64)
    _check_cache(cache_t, cache_j)
    # Cross-attention on the port's kernel route rounds p * vs to bf16
    # (the TPU kernel's order); the reference's XLA path keeps it f32:
    # 2**-9 relative per weight, averaged over the sum, moves the logits
    # by ~2e-3 of their largest value here. Two bf16 ulps of the largest
    # logit (2**-7 relative) hold them; a wrong scale, mask or cache
    # column moves them by a large part of it.
    atol = 2.0 ** -7 * float(np.abs(np.asarray(lj)).max())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol)
    rng = np.random.default_rng(5)
    for step in range(4):
        pos = prefix.shape[1] + step
        tok = rng.integers(0, JCFG.eot, size=2).astype(np.int32)
        lj, cache_j = jmod.decode_step_tmajor(jp, jnp.asarray(tok),
                                              jnp.asarray(pos, jnp.int32),
                                              cache_j, cross_j, JCFG,
                                              audio_ctx=AUDIO_T)
        lt = tmod.decode_step(tp, _t(tok).long(), pos, cache_t, cross_t, TCFG,
                              audio_ctx=AUDIO_T)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=atol)
    _check_cache(cache_t, cache_j)


def _check_cache(cache_t, cache_j):
    """The int8 caches agree: layer 0's K/V come from identical inputs
    (f32 projections in another summation order), so its codes are equal
    and scales within f32 rounding; later layers also carry the
    cross-attention's bf16 rounding above (~5e-4 relative in the values),
    which can move a code by one. Unwritten columns are 0 with scale 1."""
    qt = cache_t["qw"].numpy().astype(np.int16)
    qj = np.asarray(cache_j["qw"]).astype(np.int16)
    st, sj = cache_t["scale"].numpy(), np.asarray(cache_j["scale"])
    np.testing.assert_array_equal(qt[0], qj[0])
    np.testing.assert_allclose(st[0], sj[0], rtol=1e-6)
    assert np.abs(qt - qj).max() <= 1 and (qt == qj).mean() > 0.99
    np.testing.assert_allclose(st, sj, rtol=2e-3)
