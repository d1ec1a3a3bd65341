"""spittle_tpu_torch ops against the JAX reference on the CPU: mu-law,
log-mel, weight quantization, and the plain versions of the three kernels
(K1 encoder attention, K2 W8A8 GEMM, K4 decode cross-attention) against
the Pallas kernels run in interpret mode.

Inputs are made with numpy.random.default_rng and cross between the two
packages as numpy arrays. Each comparison states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spittle_tpu.audio import mel as jmel
from spittle_tpu.audio import mulaw as jmulaw
from spittle_tpu.ops import attention as jatt
from spittle_tpu.ops import quant as jquant
from spittle_tpu.ops.w8a8_gemm import w8a8_gemm as jax_w8a8_gemm
from spittle_tpu_torch.audio import mel as tmel
from spittle_tpu_torch.audio import mulaw as tmulaw
from spittle_tpu_torch.ops import attention as tatt
from spittle_tpu_torch.ops import quant as tquant
from spittle_tpu_torch.ops import w8a8_gemm as tw8


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# ---------------------------------------------------------------------------
# mu-law and log-mel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_mulaw_encode_codes_equal(dtype):
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal((3, 4000)) * 0.4, -1.2, 1.2)
    x = (x * 32767).astype(np.int16) if dtype == np.int16 else x.astype(np.float32)
    # Codes are integers from the same f32/f64 promotion chain: exact.
    np.testing.assert_array_equal(tmulaw.mulaw_encode(x), jmulaw.mulaw_encode(x))


def test_mulaw_decode_within_one_ulp():
    codes = np.arange(256, dtype=np.uint8)
    ref = np.asarray(jmulaw.mulaw_decode_jnp(jnp.asarray(codes)))
    got = tmulaw.mulaw_decode(_t(codes)).numpy()
    assert got.dtype == np.float32
    # f32 power implementations may differ in the last place: <= 1 ULP.
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_reference(n_mels):
    rng = np.random.default_rng(1)
    audio = (0.2 * rng.standard_normal((2, 16000 * 2))).astype(np.float32)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels))
    got = tmel.log_mel_spectrogram(_t(audio), n_mels=n_mels).numpy()
    assert got.shape == ref.shape == (2, n_mels, 200)
    # tests/test_mel.py's tolerance against the FFT oracle.
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_mel_filterbank_equal():
    np.testing.assert_array_equal(tmel.mel_filterbank(128),
                                  jmel.mel_filterbank(128))


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96)])
def test_quantize_weight_w8a8_bytes_equal(shape):
    rng = np.random.default_rng(2)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes scale 1
    if len(shape) == 2:
        ref = jquant.quantize_weight_w8a8(jnp.asarray(w))
    else:
        ref = jax.vmap(jquant.quantize_weight_w8a8)(jnp.asarray(w))
    got = tquant.quantize_weight_w8a8(_t(w))
    # Same IEEE division and round-half-even: int8 bytes equal; scales to
    # f32 rounding of amax/127.
    np.testing.assert_array_equal(got["qw8"].numpy(), np.asarray(ref["qw8"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(ref["scale"]),
                               rtol=1e-6)
    assert got["qw8"].stride()[-2:] == (1, shape[-2])  # stored out-major


def test_quantize_encoder_tree_matches_reference():
    rng = np.random.default_rng(3)
    blocks = {k: rng.standard_normal((2, 32, 48)).astype(np.float32)
              for k in tquant.WHISPER_ENCODER_QUANT_KEYS}
    blocks["attn_ln_g"] = np.ones((2, 32), np.float32)
    params = {"encoder": {"blocks": blocks}, "decoder": {}}
    ref = jquant.quantize_whisper_encoder_w8a8(
        jax.tree.map(jnp.asarray, params))["encoder"]["blocks"]
    got = tquant.quantize_whisper_encoder_w8a8(
        {"encoder": {"blocks": {k: _t(v) for k, v in blocks.items()}},
         "decoder": {}})["encoder"]["blocks"]
    for k in tquant.WHISPER_ENCODER_QUANT_KEYS:
        np.testing.assert_array_equal(got[k]["qw8"].numpy(),
                                      np.asarray(ref[k]["qw8"]))
    np.testing.assert_array_equal(got["attn_ln_g"].numpy(), blocks["attn_ln_g"])


# ---------------------------------------------------------------------------
# K2: W8A8 GEMM
# ---------------------------------------------------------------------------


def _w8a8_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, jquant.quantize_weight_w8a8(jnp.asarray(w)), b


def test_w8a8_plain_int8_bytes_and_int32_sums_equal():
    x, q, _ = _w8a8_inputs(200, 256, 384, 4)
    # The reference's quantization rule (quant.py:_mm_w8a8) in JAX.
    x32 = jnp.asarray(x)
    amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
    sx = jnp.where(amax > 0, amax / 127.0, 1.0)
    qx_ref = jnp.clip(jnp.round(x32 / sx), -127, 127).astype(jnp.int8)
    acc_ref = jax.lax.dot_general(
        qx_ref, q["qw8"], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    qx, sx_t = tw8.quantize_rows(_t(x))
    np.testing.assert_array_equal(qx.numpy(), np.asarray(qx_ref))
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx))
    acc = tw8.int8_dot(qx, tquant.out_major(_t(np.asarray(q["qw8"]))))
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  np.asarray(acc_ref).astype(np.int64))


@pytest.mark.parametrize("m,bias,act,out_scale", [
    (256, False, "none", 1.0),
    (200, True, "none", 64 ** -0.25),  # ragged M: partial last block
    (256, True, "gelu", 1.0),
])
def test_w8a8_plain_matches_pallas_kernel(m, bias, act, out_scale):
    x, q, b = _w8a8_inputs(m, 256, 384, 5)
    bj = jnp.asarray(b) if bias else None
    ref = jax_w8a8_gemm(jnp.asarray(x), q["qw8"], q["scale"], bias=bj, act=act,
                        block_m=128, out_scale=out_scale, interpret=True)
    got = tw8.w8a8_gemm(
        _t(x), tquant.out_major(_t(np.asarray(q["qw8"]))),
        _t(np.asarray(q["scale"])), bias=_t(b) if bias else None, act=act,
        out_scale=out_scale,
    )
    # Same int8 bytes and int32 sums; the f32 epilogue may round the
    # scale-and-bias sum once (an FMA) or twice, an f32 ulp of the operands
    # (1e-6 of the largest output covers it where a bias cancels a
    # product). The Pallas GELU's A&S erf is within 1.5e-7 of erf: <=
    # 1.5e-7*|y| more on the GELU output.
    scale = float(np.abs(np.asarray(ref)).max())
    atol = (1e-6 + (2e-6 if act == "gelu" else 0.0)) * scale
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=atol)


def test_mm_bias_dispatches_w8a8_to_the_gemm():
    x, q, b = _w8a8_inputs(64, 128, 64, 6)
    tq = {"qw8": tquant.out_major(_t(np.asarray(q["qw8"]))),
          "scale": _t(np.asarray(q["scale"]))}
    via_mm_bias = tquant.mm_bias(_t(x), tq, _t(b), act="gelu", out_scale=0.5)
    direct = tw8.w8a8_gemm(_t(x), tq["qw8"], tq["scale"], bias=_t(b),
                           act="gelu", out_scale=0.5)
    torch.testing.assert_close(via_mm_bias, direct, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K1: encoder attention and the plain reference attention
# ---------------------------------------------------------------------------


def _qkv(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, t, d)) * d ** -0.25).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal,kv_len", [(False, 200), (False, 256), (True, 256)])
def test_fullkv_plain_matches_pallas_interpret(causal, kv_len):
    q, k, v = _qkv(1, 2, 256, 64, 7)
    with pltpu.force_tpu_interpret_mode():
        ref = jatt.flash_attention_fullkv(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            kv_len=kv_len, block_q=128)
    got = tatt.flash_attention_fullkv(_t(q), _t(k), _t(v), causal=causal,
                                      kv_len=kv_len)
    # f32 end to end; only the softmax's max/normalization order differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal,kv_len", [(False, None), (False, 50), (True, None)])
def test_attention_reference_matches(causal, kv_len):
    q, k, v = _qkv(2, 3, 64, 32, 8)
    ref = jatt.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, kv_len=kv_len)
    got = tatt.attention_reference(_t(q), _t(k), _t(v), causal=causal,
                                   kv_len=kv_len)
    # f32 dots and softmax in both: float summation order only.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("tq,d,causal,kernel", [
    (160, 64, False, True),   # encoder scale: K1
    (160, 128, False, True),
    (160, 64, True, True),
    (8, 64, True, False),     # the decoder's short causal prefill
    (160, 32, False, False),  # a head dim the reference keeps on plain ops
])
def test_multihead_attention_dispatch(monkeypatch, tq, d, causal, kernel):
    """The dispatch depends on shape alone (the reference's rule), so the
    CPU takes the same route as the card; only K1's wrapper tells them
    apart, by the tensor's device."""
    seen = []
    real = tatt.flash_attention_fullkv
    monkeypatch.setattr(tatt, "flash_attention_fullkv",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    q, k, v = _qkv(1, 2, tq, d, 9)
    got = tatt.multihead_attention(_t(q), _t(k), _t(v), causal=causal)
    assert bool(seen) == kernel
    ref = jatt.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    # f32 end to end; only the softmax's max/normalization order differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# K4: decode cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("kv_len", [200, 256])
def test_decode_cross_plain_matches_pallas_interpret(r, kv_len):
    rng = np.random.default_rng(10 + r)
    d, tk = 64, 256
    q = (rng.standard_normal((2, 3, r, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((2, 3, d, tk)).astype(np.float32)
    v = rng.standard_normal((2, 3, d, tk)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jatt.decode_cross_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), kv_len=kv_len)
    got = tatt.decode_cross_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    # f32 end to end; the reference masks after exp, the port before the
    # max: the same function up to float rounding.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kv_len", [6401, 6500])
def test_decode_cross_plain_long_kv_matches_pallas_interpret(kv_len):
    """8 query rows (a prefill with a prompt) over K/V longer than 6400
    positions: past the score rows that K4's one-pass kernel keeps in
    shared memory, where the card walks kv in chunks. The plain version,
    which the CPU runs, holds the reference's value there."""
    rng = np.random.default_rng(16)
    r, d, tk = 8, 64, 6528
    q = (rng.standard_normal((1, 2, r, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((1, 2, d, tk)).astype(np.float32)
    v = rng.standard_normal((1, 2, d, tk)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jatt.decode_cross_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), kv_len=kv_len)
    got = tatt.decode_cross_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    # As at 256 positions: f32 end to end, the mask before the max against
    # the reference's after exp.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
