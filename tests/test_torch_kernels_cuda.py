"""Card-only tests: the port's CUDA kernels (K1, K2, K3, K4, K6, and the
encoder-attention forms K7-K10) against their plain PyTorch versions on
CUDA tensors, and the engine's main paths (bf16 decoder; int8 and int4
decoders; each encoder-attention form) on a small config with every
kernel counter moving.

The kernels have no CPU mode, so every test here carries the `cuda`
marker and skips without a card; whether a card is present is decided in
the `cuda` fixture, never at import. This file imports no JAX, so it also
runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops.quant import (
    quantize_kv,
    quantize_kv_int4,
    quantize_weight_w8a8,
)
from spittle_tpu_torch.ops.w8a8_gemm import w8a8_gemm, w8a8_gemm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.bfloat16, scale=1.0):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,bias,act,out_scale", [
    (300, 256, 384, False, "none", 1.0),
    (257, 512, 128, True, "gelu", 1.0),
    (1000, 1280, 1280, True, "none", 0.125 ** 0.5),
])
def test_w8a8_kernel_matches_plain(cuda, dtype, m, k, n, bias, act, out_scale):
    rng = np.random.default_rng(0)
    x = _randn(rng, (m, k), cuda, dtype)
    q = quantize_weight_w8a8(_randn(rng, (k, n), cuda, torch.float32, 0.05))
    b = _randn(rng, (n,), cuda, dtype) if bias else None
    got = w8a8_gemm(x, q["qw8"], q["scale"], bias=b, act=act,
                    out_scale=out_scale)
    want = w8a8_gemm_plain(x, q["qw8"], q["scale"], bias=b, act=act,
                           out_scale=out_scale)
    torch.cuda.synchronize()
    # Same int8 bytes and exact int32 sums on both sides; the f32 epilogue
    # may differ by an f32 ulp (erf implementations), i.e. at most one
    # output ulp after rounding: 2**-7 relative in bf16, 1e-5 in f32.
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("t,kv_len,causal", [
    (300, 290, False), (1500, 1500, False), (200, 200, True),
])
def test_fullkv_kernel_matches_plain(cuda, t, kv_len, causal):
    rng = np.random.default_rng(1)
    b, h, d = 2, 3, 64
    # Heads as strided views of packed [B, T, H*D] projections, as the
    # encoder passes them.
    packed = [_randn(rng, (b, t, h * d), cuda, scale=d ** -0.25)
              for _ in range(3)]
    q, k, v = (p.view(b, t, h, d).permute(0, 2, 1, 3) for p in packed)
    got = att.flash_attention_fullkv(q, k, v, causal=causal, kv_len=kv_len)
    want = att.flash_attention_fullkv_plain(q, k, v, causal=causal,
                                            kv_len=kv_len)
    torch.cuda.synchronize()
    # bf16 P is rounded against the running max in the kernel and the
    # final max in the plain version: ~1 bf16 ulp per weight, averaged,
    # then one bf16 rounding of the output (outputs ~0.02, at most ~1 for
    # the first causal rows). A wrong rescale or kv_len mask moves outputs
    # by ~1e-2.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def test_f32_at_kernel_shapes_raises(cuda):
    """On the card a tensor launches the kernel or raises: f32 at shapes
    that the dispatch sends to K1 or K4 raises and never falls back to
    plain ops. The engine defaults to bf16 on the card."""
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.models.whisper import model as tmod

    q = torch.zeros((1, 2, 256, 64), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        att.multihead_attention(q, q, q)
    qd = torch.zeros((1, 2, 1, 64), device=cuda)
    kd = torch.zeros((1, 2, 64, 256), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        tmod._cross_attention(qd, kd, kd, 64)
    assert WhisperEngine(device="cuda").dtype == torch.bfloat16


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("tk,kv_len", [(300, 257), (1500, 1500)])
def test_decode_cross_kernel_matches_plain(cuda, r, tk, kv_len):
    rng = np.random.default_rng(2)
    b, h, d = 2, 3, 64
    q = _randn(rng, (b, h, r, d), cuda, scale=d ** -0.5)
    k = _randn(rng, (b, h, d, tk), cuda)
    v = _randn(rng, (b, h, d, tk), cuda)
    got = att.decode_cross_attention(q, k, v, kv_len=kv_len)
    want = att.decode_cross_attention_plain(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    # Same bf16-rounded P; only the f32 summation order differs, then one
    # bf16 rounding of the output.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def test_engine_main_path_runs_every_kernel(cuda):
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw")
    eng.load_model("random:tiny")
    rng = np.random.default_rng(3)
    audio = [(rng.standard_normal(16000 * 30) * 3000).astype(np.int16)
             for _ in range(2)]
    p = TranscribeParams(language="en", parallel_windows=True,
                         condition_on_previous_text=False,
                         temperatures=(0.0,), max_tokens=8)
    for fn in (att.flash_attention_fullkv, w8a8_gemm,
               att.decode_cross_attention):
        fn.launches = 0
    results = list(eng.transcribe_stream([audio, audio], p,
                                         overlap_fetch=True))
    assert len(results) == 2 and all(len(r) == 2 for r in results)
    layers = eng.cfg.n_audio_layer
    assert att.flash_attention_fullkv.launches == 2 * layers
    assert w8a8_gemm.launches == 2 * 6 * layers
    steps = sum(eng.last_decode_steps)
    assert att.decode_cross_attention.launches == eng.cfg.n_text_layer * (
        2 + steps)


def _quant_kv(rng, b, h, tk, kv_len, bits, dev):
    """K/V [B, H, 64, Tk] quantized as the decoder quantizes them, with the
    columns from kv_len on replaced by pad: random codes and scale 1.0, so
    a pad column that reached the row max would swamp the real ones."""
    kv = _randn(rng, (b, h, 64, tk), dev, torch.float32)
    q = quantize_kv(kv) if bits == 8 else quantize_kv_int4(kv)
    key = "qw" if bits == 8 else "qw4"
    qw, scale = q[key], q["scale"]
    if kv_len < tk:
        pad = torch.from_numpy(rng.integers(-128, 128, size=qw[..., kv_len:].shape,
                                            dtype=np.int8)).to(dev)
        qw[..., kv_len:] = pad
        scale[..., kv_len:] = 1.0
    return qw.contiguous(), scale.contiguous()


_QUANT_KERNELS = {
    8: (att.decode_cross_attention_q8, att.decode_cross_attention_q8_plain),
    4: (att.decode_cross_attention_q4, att.decode_cross_attention_q4_plain),
}


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("r", [1, 3, 4, 8])
@pytest.mark.parametrize("tk,kv_len", [(1500, 1500), (1500, 1300),
                                       (1536, 1536), (1536, 1500)])
def test_decode_cross_quant_kernel_matches_plain(cuda, bits, b, r, tk, kv_len):
    rng = np.random.default_rng(4 + r)
    h = 20
    q = _randn(rng, (b, h, r, 64), cuda, scale=64 ** -0.5)
    qk, ks = _quant_kv(rng, b, h, tk, kv_len, bits, cuda)
    qv, vs = _quant_kv(rng, b, h, tk, kv_len, bits, cuda)
    kernel, plain = _QUANT_KERNELS[bits]
    got = kernel(q, qk, ks, qv, vs, kv_len=kv_len)
    want = plain(q, qk, ks, qv, vs, kv_len=kv_len)
    torch.cuda.synchronize()
    # The kernel rounds bf16(p * vs) with p scaled by its 256-position
    # chunk's max and rescales the chunk sums after; the plain version
    # rounds with the global max. That moves each weight by up to a bf16
    # half-ulp (2**-9 relative), averaged over the sum, then one bf16
    # rounding of the output: K4's tolerance. A pad column in the max, or
    # nibbles read without sign extension, move outputs by far more.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_decode_cross_quant_wrapper_raises(cuda, bits):
    rng = np.random.default_rng(9)
    kernel, _ = _QUANT_KERNELS[bits]
    qk, ks = _quant_kv(rng, 1, 2, 300, 300, bits, cuda)
    q = _randn(rng, (1, 2, 1, 64), cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        kernel(q.float(), qk, ks, qk, ks)
    with pytest.raises(TypeError, match="int8"):
        kernel(q, qk.float(), ks, qk, ks)
    with pytest.raises(ValueError, match="1..8 rows"):
        kernel(_randn(rng, (1, 2, 9, 64), cuda), qk, ks, qk, ks)
    assert kernel(q, qk, ks, qk, ks).shape == (1, 2, 1, 64)


@pytest.mark.parametrize("quantize_decoder", ["int8", "int4"])
def test_engine_quantized_decoder_runs_its_kernel(cuda, quantize_decoder):
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, quantize_decoder=quantize_decoder,
                        quantize_cache=True, wire="mulaw")
    eng.load_model("random:tiny")
    rng = np.random.default_rng(3)
    audio = [(rng.standard_normal(16000 * 30) * 3000).astype(np.int16)
             for _ in range(2)]
    p = TranscribeParams(language="en", parallel_windows=True,
                         condition_on_previous_text=False,
                         temperatures=(0.0,), max_tokens=8)
    kernels = (att.decode_cross_attention, att.decode_cross_attention_q8,
               att.decode_cross_attention_q4)
    for fn in kernels:
        fn.launches = 0
    results = list(eng.transcribe_stream([audio, audio], p,
                                         overlap_fetch=True))
    assert len(results) == 2 and all(len(r) == 2 for r in results)
    want = eng.cfg.n_text_layer * (2 + sum(eng.last_decode_steps))
    used = (att.decode_cross_attention_q8 if quantize_decoder == "int8"
            else att.decode_cross_attention_q4)
    assert {fn.__name__: fn.launches for fn in kernels} == {
        fn.__name__: (want if fn is used else 0) for fn in kernels}


# ---------------------------------------------------------------------------
# The encoder-attention forms: K7 (int8 products), K8/K9 (packed heads,
# head pairs), K10 (pipelined)
# ---------------------------------------------------------------------------


def _packed(rng, b, t, h, dev):
    """q, k, v as the encoder makes them: contiguous packed [B, T, H*64]
    projections, pre-scaled by Dh^-0.25."""
    return [_randn(rng, (b, t, h * 64), dev, scale=64 ** -0.25) for _ in range(3)]


@pytest.mark.parametrize("t,kv_len", [(1500, 1500), (1500, 1300), (1536, 1536),
                                      (300, 290)])
def test_pipe_kernel_matches_plain_and_k1(cuda, t, kv_len):
    rng = np.random.default_rng(5)
    q, k, v = (att.split_heads(x, 4) for x in _packed(rng, 2, t, 4, cuda))
    got = att.flash_attention_fullkv_pipe(q, k, v, kv_len=kv_len)
    want = att.flash_attention_fullkv_plain(q, k, v, kv_len=kv_len)
    k1 = att.flash_attention_fullkv(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    # K1's tolerance (the same arithmetic), and K1's bits: K10 reorders
    # K1's schedule, not its operations.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)
    assert torch.equal(got, k1)


@pytest.mark.parametrize("pair", [False, True], ids=["packed", "pair"])
@pytest.mark.parametrize("t,kv_len,causal", [
    (1500, 1500, False), (1500, 1300, False), (1500, 1500, True),
    (300, 290, True),
])
def test_packed_kernel_matches_plain_and_k1(cuda, pair, t, kv_len, causal):
    rng = np.random.default_rng(6)
    h = 4
    q, k, v = _packed(rng, 2, t, h, cuda)
    fn = (att.flash_attention_fullkv_packed_pair if pair
          else att.flash_attention_fullkv_packed)
    got = fn(q, k, v, h, causal=causal, kv_len=kv_len)
    want = att.flash_attention_fullkv_packed_plain(q, k, v, h, causal=causal,
                                                   kv_len=kv_len)
    k1 = att.merge_heads(att.flash_attention_fullkv(
        *(att.split_heads(x, h) for x in (q, k, v)), causal=causal,
        kv_len=kv_len))
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    # K1's tolerance, and K1's bits: the same body reading the packed layout.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)
    assert torch.equal(got, k1)


@pytest.mark.parametrize("t,kv_len", [(1500, 1500), (1500, 1300), (1536, 1536),
                                      (300, 290)])
def test_q8_kernel_matches_plain(cuda, t, kv_len):
    rng = np.random.default_rng(7)
    q, k, v = (att.split_heads(x, 4) for x in _packed(rng, 2, t, 4, cuda))
    got = att.flash_attention_fullkv_q8(q, k, v, kv_len=kv_len)
    want = att.flash_attention_fullkv_q8_plain(q, k, v, kv_len=kv_len)
    step = att.q8_code_step(q, k, v, kv_len)
    torch.cuda.synchronize()
    # The same int8 codes and int32 sums on both sides and the same f32
    # operations in the same order; exp's last bit may differ, and where
    # it lands p*vs/sp across a rounding boundary one P code moves by one,
    # shifting that row by at most mp/l. So: within one bf16 ulp of the
    # output (2**-7 relative: the two sides round values an f32 ulp apart)
    # plus one such step per row, and at most 1% of the rows beyond one
    # ulp. Dropping V's scales from P or fixing sp at 1 moves every row by
    # far more.
    err = (got.float() - want.float()).abs()
    tol = 2.0 ** -7 * want.float().abs() + 1e-5
    excess = (err - tol).amax(dim=-1)
    worst = (excess - 1.001 * step).max().item()
    share = (excess > 0).float().mean().item()
    assert worst <= 0 and share <= 0.01, (
        f"K7 not close to its plain version: {worst:.3e} past the bound, "
        f"{share:.2%} of the rows past one bf16 ulp")


@pytest.mark.parametrize("form", ["q8", "pipe", "packed", "pair"])
def test_form_wrappers_raise(cuda, form):
    """On the card a form's wrapper launches its kernel or raises: f32,
    Dh 128, and (pair) an odd head count never fall back."""
    rng = np.random.default_rng(8)
    h = 2

    def call(x, heads=h):
        if form in ("q8", "pipe"):
            fn = (att.flash_attention_fullkv_q8 if form == "q8"
                  else att.flash_attention_fullkv_pipe)
            xs = att.split_heads(x, heads)
            return fn(xs, xs, xs)
        fn = (att.flash_attention_fullkv_packed_pair if form == "pair"
              else att.flash_attention_fullkv_packed)
        return fn(x, x, x, heads)

    x = _randn(rng, (1, 256, h * 64), cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        call(x.float())
    with pytest.raises(ValueError, match="head dim"):
        call(_randn(rng, (1, 256, h * 128), cuda))
    if form == "pair":
        with pytest.raises(ValueError, match="even head count"):
            call(_randn(rng, (1, 256, 3 * 64), cuda), heads=3)
    assert call(x).shape[-1] in (64, h * 64)
    launched = {"q8": att.flash_attention_fullkv_q8,
                "pipe": att.flash_attention_fullkv_pipe,
                "packed": att.flash_attention_fullkv_packed,
                "pair": att.flash_attention_fullkv_packed_pair}[form]
    before = launched.launches
    call(x)
    assert launched.launches == before + 1


_FORM_WRAPPERS = {
    "q8": att.flash_attention_fullkv_q8,
    "packed": att.flash_attention_fullkv_packed,
    "pair": att.flash_attention_fullkv_packed_pair,
    "pipe": att.flash_attention_fullkv_pipe,
}


@pytest.mark.parametrize("form", list(_FORM_WRAPPERS))
def test_engine_encoder_attention_form_runs_its_kernel(cuda, form):
    """random:tiny (6 heads of 64, 1500 positions) under each form: the
    form's kernel once per encoder layer and batch, K1 never, K2 and K4
    as on the default path."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw",
                        encoder_attention=form)
    eng.load_model("random:tiny")
    rng = np.random.default_rng(3)
    audio = [(rng.standard_normal(16000 * 30) * 3000).astype(np.int16)
             for _ in range(2)]
    p = TranscribeParams(language="en", parallel_windows=True,
                         condition_on_previous_text=False,
                         temperatures=(0.0,), max_tokens=8)
    kernels = (att.flash_attention_fullkv, w8a8_gemm,
               att.decode_cross_attention, *_FORM_WRAPPERS.values())
    for fn in kernels:
        fn.launches = 0
    results = list(eng.transcribe_stream([audio, audio], p, overlap_fetch=True))
    assert len(results) == 2 and all(len(r) == 2 for r in results)
    layers = eng.cfg.n_audio_layer
    steps = sum(eng.last_decode_steps)
    want = {fn.__name__: 0 for fn in kernels}
    want.update({
        _FORM_WRAPPERS[form].__name__: 2 * layers,
        "w8a8_gemm": 2 * 6 * layers,
        "decode_cross_attention": eng.cfg.n_text_layer * (2 + steps),
    })
    assert {fn.__name__: fn.launches for fn in kernels} == want
