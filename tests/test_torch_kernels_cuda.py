"""Card-only tests: the port's CUDA kernels (K1-K6 and the f32 forms of K1,
K5's route, K4, K3 and K6, the encoder-attention
forms K7-K10, the probe kernels K11-K13, K14, the "w8a8" decoder's
int8 x int8 cross-attention, and K15, K1's backward, with K1's instance
that writes each row's log-sum-exp) against their plain PyTorch
versions on CUDA tensors (K2 also at the encoder's widths, its quantizer
byte for byte; K3 and K4, one kernel, also on the decoder's padded rows,
K3 bit for bit against K11; K7 in both of its forms), and the engine's
main paths (bf16 decoder; int8
and int4 decoders; each encoder-attention form; a reduced and a long
audio context; the app's transcribe_samples with language detection and
the sampled ladder, its decode kept on the card) on a small config with
every kernel counter moving.

The kernels have no CPU mode, so every test here carries the `cuda`
marker and skips without a card; whether a card is present is decided in
the `cuda` fixture, never at import. This file imports no JAX, so it also
runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops import cache_write as cw
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


# K2 at the encoder's widths and the odd row counts around a 128-row tile;
# bias, GELU and out_scale rotate over the cases so that each (K, N) and
# dtype meets each of them.
_K2_OPTIONS = ((True, "none", 1.0), (False, "gelu", 1.0),
               (True, "gelu", 0.125 ** 0.5), (False, "none", 0.125 ** 0.5))
_K2_CASES = [(m, k, n, dtype) + _K2_OPTIONS[i % len(_K2_OPTIONS)]
             for i, (m, (k, n), dtype) in enumerate(
                 (m, kn, dtype) for m in (1, 127, 129, 2048, 12000)
                 for kn in ((1280, 384), (1280, 1280), (1280, 5120), (5120, 1280))
                 for dtype in (torch.bfloat16, torch.float32))]


@pytest.mark.parametrize("m,k,n,dtype,bias,act,out_scale", _K2_CASES,
                         ids=[f"{m}-{k}-{n}-{str(d)[6:]}-{int(b)}-{a}-{s:.2f}"
                              for m, k, n, d, b, a, s in _K2_CASES])
def test_w8a8_kernel_at_encoder_shapes(cuda, m, k, n, dtype, bias, act,
                                       out_scale):
    """The persistent wgmma GEMM on 128 x 256 tiles (bf16, tile_n's choice
    where the tiles fill the card) and 128 x 128 (f32, N 384, M 2048 at N
    1280), with ragged rows (M 1, 127, 129) and columns (N 384)."""
    rng = np.random.default_rng(m + k + n)
    x = _randn(rng, (m, k), cuda, dtype)
    q = quantize_weight_w8a8(_randn(rng, (k, n), cuda, torch.float32, k ** -0.5))
    b = _randn(rng, (n,), cuda, dtype, 0.1) if bias else None
    before = w8a8_gemm.launches
    got = w8a8_gemm(x, q["qw8"], q["scale"], bias=b, act=act, out_scale=out_scale)
    want = w8a8_gemm_plain(x, q["qw8"], q["scale"], bias=b, act=act,
                           out_scale=out_scale)
    torch.cuda.synchronize()
    assert w8a8_gemm.launches == before + 1
    # test_w8a8_kernel_matches_plain's tolerance, for its reasons.
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(12000, 1280), (129, 5120), (3, 20480)])
def test_w8a8_quantizer_bytes_equal_plain(cuda, dtype, m, k):
    """The row quantizer's int8 bytes and f32 scales equal quantize_rows'
    (true division, round-half-even) exactly: K 1280 one warp per row,
    5120 four, 20480 eight, past the units a thread holds."""
    from spittle_tpu_torch.ops.w8a8_gemm import launch_quantize, quantize_rows

    rng = np.random.default_rng(k)
    x = _randn(rng, (m, k), cuda, dtype, 3.0)
    x[0] = 0.0  # amax 0: scale 1
    qx, sx = launch_quantize(x)
    want_qx, want_sx = quantize_rows(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(sx, want_sx[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(qx.float(), want_qx.float(), rtol=0, atol=0)


@pytest.mark.parametrize("t,kv_len,causal", [
    (300, 290, False), (1500, 1500, False), (200, 200, True),
    (96, 90, False), (1500, 1281, False),
])
def test_fullkv_kernel_matches_plain(cuda, t, kv_len, causal):
    """K1 on the attention core: t 96 is one key tile and one query block
    taller than the tensor (TMA fills the rest with zeros), t 200 is not a
    multiple of 64 and causal, kv_len 1281 is one key past a tile."""
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


def _bwd_inputs(cuda, seed, b, h, tq, tk):
    """q, k, v as head views of packed projections, and dO, as the
    encoder passes them."""
    rng = np.random.default_rng(seed)
    d = 64
    packed = [_randn(rng, (b, t, h * d), cuda, scale=d ** -0.25)
              for t in (tq, tk, tk)]
    q, k, v = (p.view(b, -1, h, d).permute(0, 2, 1, 3) for p in packed)
    do = _randn(rng, (b, tq, h * d), cuda).view(b, tq, h, d).permute(0, 2, 1, 3)
    return q, k, v, do


@pytest.mark.parametrize("b,h,tq,tk,kv_len,causal", [
    (8, 20, 1500, 1500, 1500, False), (4, 20, 224, 224, 224, True),
    (8, 20, 1500, 1504, 1300, False),
    (2, 3, 1, 300, 300, False), (2, 3, 65, 65, 65, False),
    (2, 3, 200, 333, 129, False), (2, 3, 1501, 1501, 1, False),
    (2, 3, 1501, 1600, 129, False), (2, 3, 224, 224, 224, True),
    (2, 3, 257, 257, 257, True),
], ids=["encoder", "decoder-causal", "kv_len-1300", "tq1", "tq65",
        "tq200-kv129", "tq1501-kv1", "tq1501-kv129", "causal224", "causal257"])
def test_fullkv_bwd_kernel_matches_plain(cuda, b, h, tq, tk, kv_len, causal):
    """K15 at the training path's shapes: the encoder's [8, 20, 1500, 64],
    the decoder's causal self-attention at 224 tokens, and kv_len 1300 of
    1504 keys (the keys past kv_len get exact zeros); and at ragged shapes:
    one query row, one key block, rows and keys past a 64- or 128-row tile,
    kv_len 1 (every key block but the first stores zeros) and 129, causal
    at 224 and 257. Against its plain version and against autograd
    through K1's plain version; two calls give the same bits (no
    atomics)."""
    q, k, v, do = _bwd_inputs(cuda, 3, b, h, tq, tk)
    o, lse = att.flash_attention_fullkv_lse(q, k, v, causal=causal,
                                            kv_len=kv_len)
    got = att.flash_attention_fullkv_bwd(q, k, v, o, do, lse, causal=causal,
                                         kv_len=kv_len)
    again = att.flash_attention_fullkv_bwd(q, k, v, o, do, lse, causal=causal,
                                           kv_len=kv_len)
    want = att.flash_attention_fullkv_bwd_plain(q, k, v, o, do, lse,
                                                causal=causal, kv_len=kv_len)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        att.flash_attention_fullkv_plain(*leaves, causal=causal, kv_len=kv_len),
        leaves, do)
    torch.cuda.synchronize()
    for name, g, g2, w, a in zip("qkv", got, again, want, auto):
        assert torch.equal(g, g2), f"d{name}: two calls differ"
        assert torch.isfinite(g).all()
        # P and dS are rounded to bf16 as the second products' A operands
        # and each gradient once more on output: a few bf16 ulps (2^-8
        # relative) of the largest entry. A wrong mask, lse or D moves
        # whole rows by far more. With one key kept dS is zero in exact
        # arithmetic, so dq and dk hold only rounding noise on both sides:
        # there they are held to the largest entry of the three.
        scale = w.float().abs().max().item()
        if kv_len == 1 and name in "qk":
            scale = max(x.float().abs().max().item() for x in want)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1e-2 * scale, (name, err, scale)
        err = (g.float() - a.float()).abs().max().item()
        assert err <= 2e-2 * scale, (name, "vs autograd", err, scale)
    if kv_len < tk:
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("b,tq,tk,kv_len,causal", [
    (8, 1500, 1500, 1500, False), (4, 224, 224, 224, True),
    (8, 1500, 1504, 1300, False),
], ids=["encoder", "decoder-causal", "kv_len-1300"])
def test_fullkv_lse_instance_matches_k1(cuda, b, tq, tk, kv_len, causal):
    """K1's instance with each row's log-sum-exp (the forward under
    autograd): o bit for bit K1's, lse within 1e-4 of the plain version's
    (f32 sums of ex2.approx terms in another order, ~1e-6; one key more
    or less in a row of 1500 moves its lse by ~7e-4)."""
    q, k, v, _ = _bwd_inputs(cuda, 5, b, 20, tq, tk)
    before = att.flash_attention_fullkv.launches
    o, lse = att.flash_attention_fullkv_lse(q, k, v, causal=causal,
                                            kv_len=kv_len)
    assert att.flash_attention_fullkv.launches == before + 1
    ref = att.flash_attention_fullkv(q, k, v, causal=causal, kv_len=kv_len)
    _, want = att.flash_attention_fullkv_lse_plain(q, k, v, causal=causal,
                                                   kv_len=kv_len)
    torch.cuda.synchronize()
    assert lse.shape == (b, 20, tq) and lse.dtype == torch.float32
    assert torch.equal(o, ref), "o differs from K1's"
    err = (lse - want).abs().max().item()
    assert err <= 1e-4, err


def test_fullkv_bwd_fifty_calls_bit_equal(cuda):
    """No atomics: 50 consecutive K15 calls at the encoder's shape give
    the first call's bits."""
    q, k, v, do = _bwd_inputs(cuda, 6, 8, 20, 1500, 1500)
    o, lse = att.flash_attention_fullkv_lse(q, k, v)
    first = att.flash_attention_fullkv_bwd(q, k, v, o, do, lse)
    for i in range(49):
        again = att.flash_attention_fullkv_bwd(q, k, v, o, do, lse)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), i


def test_fullkv_bwd_ptxas_keeps_wgmma_in_registers(cuda):
    """ptxas builds K15's two passes within their 168 registers a thread
    with no spills and no note on wgmma serialisation or an ignored
    setmaxnreg (C7500-C7520): the design's tiles are sized to fit, and
    this pins it, so that a toolchain change cannot leave it silently."""
    from spittle_tpu_torch.probes import ptxas_report

    lines = []
    recs = ptxas_report.main(["fullkv_attention_bwd.cu"], out=lines.append)
    assert len(recs) == 2 and all("bwd_" in r["kernel"] for r in recs), recs
    for rec in recs:
        assert rec["spill_stores"] == 0 and rec["spill_loads"] == 0, rec
        assert rec["registers"] <= 168, rec
    notes = [n for line in lines if "ptxas_notes" in line
             for n in json.loads(line)["ptxas_notes"]]
    assert not notes, notes


def test_fullkv_autograd_launches_k1_and_k15(cuda):
    """Under autograd the dispatch runs K1 as its autograd Function: one
    K1 launch forward and one K15 launch backward; the forms without a
    backward kernel raise."""
    rng = np.random.default_rng(4)
    q, k, v = (_randn(rng, (2, 4, 256, 64), cuda, scale=0.35).requires_grad_()
               for _ in range(3))
    k1, k15 = att.flash_attention_fullkv.launches, att.flash_attention_fullkv_bwd.launches
    o = att.multihead_attention(q, k, v, causal=True)
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    assert att.flash_attention_fullkv.launches == k1 + 1
    assert att.flash_attention_fullkv_bwd.launches == k15 + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    for form in ("q8", "pipe"):
        with pytest.raises(NotImplementedError, match="no backward"):
            att.multihead_attention(q, k, v, form=form)
    with pytest.raises(NotImplementedError, match="no backward"):
        att.multihead_attention_packed(q.view(2, 256, 256), k.view(2, 256, 256),
                                       v.view(2, 256, 256), 4, form="packed")


def test_f32_at_kernel_shapes_raises(cuda):
    """On the card a tensor launches the kernel or raises, never falling
    back to plain ops. At f32 (the engine's default, as the JAX engine's)
    K1 and K4 launch their f32 forms; the forms with no f32 kernel yet
    ("q8" here) and K1 under autograd (K15 has no f32 form) raise."""
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.models.whisper import model as tmod

    q = torch.zeros((1, 2, 256, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="'q8' form.*not yet ported at f32"):
        att.multihead_attention(q, q, q, form="q8")
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="K15.*not yet ported at f32"):
        att.multihead_attention(qg, qg, qg)
    before = att.flash_attention_fullkv_f32.launches
    assert att.multihead_attention(q, q, q).dtype == torch.float32
    assert att.flash_attention_fullkv_f32.launches == before + 1
    qd = torch.zeros((1, 2, 1, 64), device=cuda)
    kd = torch.zeros((1, 2, 64, 256), device=cuda)
    before = att.decode_cross_attention_f32.launches
    assert tmod._cross_attention(qd, kd, kd, 64).dtype == torch.float32
    assert att.decode_cross_attention_f32.launches == before + 1
    with pytest.raises(TypeError, match="bfloat16"):
        att._fullkv_launch(q, q, q, False, None, with_lse=False)
    assert WhisperEngine(device="cuda").dtype == torch.float32


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("tk,kv_len", [(300, 257), (1500, 1500), (301, 301),
                                       (255, 200), (1, 1)])
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


@pytest.mark.parametrize("r,kv_len", [(8, 6500), (3, 6401)])
def test_decode_cross_kernel_long_kv_matches_plain(cuda, r, kv_len):
    """K4 at Tk 6500, past the 200 KB of score rows that bounded its first
    kernel: 8 rows of 6500 positions, and 3 of 6401. The kernel splits any
    length into 64-position items combined by a second pass."""
    rng = np.random.default_rng(14)
    b, h, d, tk = 2, 20, 64, 6500
    q = _randn(rng, (b, h, r, d), cuda, scale=d ** -0.5)
    k = _randn(rng, (b, h, d, tk), cuda)
    v = _randn(rng, (b, h, d, tk), cuda)
    got = att.decode_cross_attention(q, k, v, kv_len=kv_len)
    want = att.decode_cross_attention_plain(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    # As at the shorter lengths: P rounds to bf16 against its 64-position
    # chunk's max instead of the row max (as K3's split-T does): a bf16
    # half-ulp per weight, averaged.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def _k4_kv(rng, b, h, tk, kv_len, pitch, dev):
    """bf16 K or V [B, H, 64, Tk] in rows `pitch` positions apart (a view
    of the logical shape; pitch Tk: contiguous), the columns from kv_len
    on and the padding past Tk holding NaN and inf, which the kernel must
    never let through (the plain version never reads them)."""
    buf = torch.full((b, h, 64, pitch), float("nan"), dtype=torch.bfloat16, device=dev)
    buf[..., :kv_len] = _randn(rng, (b, h, 64, kv_len), dev)
    buf[..., kv_len:tk:2] = float("inf")
    return buf[..., :tk]


_K4_SHAPES = [(r, tk, kv_len) for r in (1, 3, 4, 8)
              for tk, kv_len in ((255, 255), (255, 201), (1500, 1500), (1500, 1300),
                                 (1536, 1536), (6000, 6000))] + [(8, 6500, 6500)]


@pytest.mark.parametrize("layout", ["padded", "contiguous"])
@pytest.mark.parametrize("r,tk,kv_len", _K4_SHAPES,
                         ids=[f"R{r}-{tk}-{kv}" for r, tk, kv in _K4_SHAPES])
def test_k4_on_decoder_layouts_matches_plain(cuda, layout, r, tk, kv_len):
    """K4 on the decoder's padded rows (tma_pitch: TMA at every Tk) and on
    contiguous K/V (TMA where 2 * Tk is a multiple of 16: 1536, 6000,
    6500; cp.async covers at 255 and 1500), against its plain version."""
    rng = np.random.default_rng(40 + r + tk)
    b, h = 2, 20
    pitch = att.tma_pitch(tk, 2) if layout == "padded" else tk
    q = _randn(rng, (b, h, r, 64), cuda, scale=64 ** -0.5)
    k = _k4_kv(rng, b, h, tk, kv_len, pitch, cuda)
    v = _k4_kv(rng, b, h, tk, kv_len, pitch, cuda)
    if layout == "padded":
        assert k.stride(2) == pitch and pitch * 2 % 16 == 0
    before = att.decode_cross_attention.launches
    got = att.decode_cross_attention(q, k, v, kv_len=kv_len)
    want = att.decode_cross_attention_plain(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert att.decode_cross_attention.launches == before + 1
    # test_decode_cross_kernel_matches_plain's tolerance; P rounds to bf16
    # against each 64-position chunk's max (the long-K/V test's reason).
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def test_k4_at_the_turbo_batch(cuda):
    """bench.py's turbo batch, B 48, one row, on the decoder's padded rows."""
    rng = np.random.default_rng(48)
    b, h, tk = 48, 20, 1500
    q = _randn(rng, (b, h, 1, 64), cuda, scale=64 ** -0.5)
    k, v = (_k4_kv(rng, b, h, tk, tk, att.tma_pitch(tk, 2), cuda) for _ in range(2))
    got = att.decode_cross_attention(q, k, v)
    want = att.decode_cross_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("kind,b,r", [("bf16", 48, 1), ("bf16", 48, 3), ("int8", 56, 3),
                                      ("int4", 56, 3), ("int4", 8, 1)])
def test_decode_cross_ring_stable_over_many_launches(cuda, kind, b, r):
    """K4, K3 and K6 (one persistent kernel) launched 600 times back to
    back at bench.py's batches on the decoder's padded rows: every output
    equals the first. Rings of more stages than consumer teams faulted or
    hung within 50-750 such launches on an H100 (the source's kStages
    note)."""
    rng = np.random.default_rng(60 + b + r)
    h, tk = 20, 1500
    q = _randn(rng, (b, h, r, 64), cuda, scale=64 ** -0.5)
    if kind == "bf16":
        k, v = (_k4_kv(rng, b, h, tk, tk, att.tma_pitch(tk, 2), cuda) for _ in range(2))
        run = lambda: att.decode_cross_attention(q, k, v)  # noqa: E731
    else:
        bits = 8 if kind == "int8" else 4
        qk, ks = _quant_kv(rng, b, h, tk, tk, bits, cuda)
        qv, vs = _quant_kv(rng, b, h, tk, tk, bits, cuda)
        args = (q, _padded_rows(qk, 1504), ks, _padded_rows(qv, 1504), vs)
        kernel = _QUANT_KERNELS[bits][0]
        run = lambda: kernel(*args)  # noqa: E731
    first = run()
    outs = [run() for _ in range(600)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)


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
    # The kernel rounds bf16(p * vs) with p scaled by its chunk's max (K3
    # and K6: each work item's 128 positions, on K11's kernel) and
    # rescales the chunk sums after; the plain version rounds with the
    # global max. That moves each weight by up to a bf16
    # half-ulp (2**-9 relative), averaged over the sum, then one bf16
    # rounding of the output: K4's tolerance. A pad column in the max, or
    # nibbles read without sign extension, move outputs by far more.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def _padded_rows(x, pitch):
    """x [..., Tk] copied into rows `pitch` bytes apart (the decoder's
    int8 cross-K/V layout), the padding filled with random codes that the
    kernel must never read: a view of the logical shape."""
    tk = x.shape[-1]
    buf = torch.randint(-128, 128, (*x.shape[:-1], pitch), dtype=torch.int8,
                        device=x.device)
    buf[..., :tk] = x
    return buf[..., :tk]


@pytest.mark.parametrize("layout", ["padded-1500", "contiguous-1500",
                                    "contiguous-1536"])
@pytest.mark.parametrize("b", [1, 8, 56])
@pytest.mark.parametrize("r", [1, 3, 4, 8])
def test_k3_on_decoder_layouts_matches_plain(cuda, layout, b, r):
    """K3 on the decoder's padded rows (Tk 1500 at a pitch of 1504 bytes:
    TMA) and on contiguous Tk 1500 (cp.async covers) and 1536 (TMA),
    against its plain version. K11 calls the same entry
    (test_k3_and_k11_call_one_entry)."""
    tk = 1536 if layout.endswith("1536") else 1500
    rng = np.random.default_rng(30 + r + b)
    h = 20
    q = _randn(rng, (b, h, r, 64), cuda, scale=64 ** -0.5)
    qk, ks = _quant_kv(rng, b, h, tk, tk, 8, cuda)
    qv, vs = _quant_kv(rng, b, h, tk, tk, 8, cuda)
    if layout.startswith("padded"):
        qk, qv = _padded_rows(qk, 1504), _padded_rows(qv, 1504)
        assert qk.stride(2) == 1504 and not qk.is_contiguous()
    before = att.decode_cross_attention_q8.launches
    got = att.decode_cross_attention_q8(q, qk, ks, qv, vs)
    want = att.decode_cross_attention_q8_plain(q, qk, ks, qv, vs)
    torch.cuda.synchronize()
    assert att.decode_cross_attention_q8.launches == before + 1
    # test_decode_cross_quant_kernel_matches_plain's tolerance.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


_K6_CASES = [  # (layout, B, Tk, kv_len)
    ("padded", 8, 1500, 1500), ("contiguous", 8, 1500, 1500),
    ("padded", 8, 1500, 1300), ("contiguous", 1, 1536, 1500),
    ("padded", 2, 301, 301), ("contiguous", 2, 301, 257),
    ("padded", 56, 1500, 1500), ("contiguous", 56, 1500, 1500),
]


@pytest.mark.parametrize("layout,b,tk,kv_len", _K6_CASES,
                         ids=["-".join(map(str, c)) for c in _K6_CASES])
@pytest.mark.parametrize("r", [1, 3, 4, 8])
def test_k6_on_decoder_layouts_matches_plain(cuda, layout, b, tk, kv_len, r):
    """K6 on the decoder's padded int4 rows (tma_pitch: 1504 bytes for Tk
    1500, 304 for 301; the TMA path) and on contiguous rows (Tk 1500 and
    301: cp.async covers; 1536: TMA), with pad columns past kv_len,
    against its plain version."""
    rng = np.random.default_rng(40 + r + b + tk)
    h = 20
    q = _randn(rng, (b, h, r, 64), cuda, scale=64 ** -0.5)
    qk, ks = _quant_kv(rng, b, h, tk, kv_len, 4, cuda)
    qv, vs = _quant_kv(rng, b, h, tk, kv_len, 4, cuda)
    if layout == "padded":
        qk, qv = (_padded_rows(x, att.tma_pitch(tk)) for x in (qk, qv))
        assert qk.stride(2) % 16 == 0 and not qk.is_contiguous()
    before = att.decode_cross_attention_q4.launches
    got = att.decode_cross_attention_q4(q, qk, ks, qv, vs, kv_len=kv_len)
    want = att.decode_cross_attention_q4_plain(q, qk, ks, qv, vs, kv_len=kv_len)
    torch.cuda.synchronize()
    assert att.decode_cross_attention_q4.launches == before + 1
    # test_decode_cross_quant_kernel_matches_plain's tolerance.
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
    # Rows of a pitch that is no multiple of 16 bytes: K3 and K6 refuse them.
    odd = torch.zeros((1, 2, qk.shape[2], 310), dtype=torch.int8, device=cuda)[..., :300]
    with pytest.raises(ValueError, match="pitch"):
        kernel(q, odd, ks, odd, ks)
    assert kernel(q, qk, ks, qk, ks).shape == (1, 2, 1, 64)


@pytest.mark.parametrize("quantize_decoder", ["int8", "int4", "w8a8"])
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
               att.decode_cross_attention_q4, att.decode_cross_attention_w8a8)
    for fn in kernels:
        fn.launches = 0
    results = list(eng.transcribe_stream([audio, audio], p,
                                         overlap_fetch=True))
    assert len(results) == 2 and all(len(r) == 2 for r in results)
    # Per decoder layer: each batch's prefill (3 prefix rows) and steps.
    want = eng.cfg.n_text_layer * (2 + sum(eng.last_decode_steps))
    used = {"int8": att.decode_cross_attention_q8,
            "int4": att.decode_cross_attention_q4,
            "w8a8": att.decode_cross_attention_w8a8}[quantize_decoder]
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


@pytest.mark.parametrize("b,h,t,kv_len", [
    (2, 4, 1500, 1500), (2, 4, 1500, 1300), (2, 4, 1536, 1536), (2, 4, 300, 290),
    (1, 4, 300, 300), (2, 20, 1500, 1500), (2, 20, 1500, 1281),
])
def test_pipe_kernel_matches_plain_and_k1(cuda, b, h, t, kv_len):
    """K10, the attention core's persistent kernel: [1, 4, 300] has 12
    work items, fewer than the SMs (one item per block); [2, 20, 1500] has
    480, not a multiple of the SM count, so blocks walk 3 or 4 items and
    carry the ring, Q buffers and named-barrier turns across them;
    kv_len 1281 leaves one live key in the last tile."""
    rng = np.random.default_rng(5)
    q, k, v = (att.split_heads(x, h) for x in _packed(rng, b, t, h, cuda))
    got = att.flash_attention_fullkv_pipe(q, k, v, kv_len=kv_len)
    want = att.flash_attention_fullkv_plain(q, k, v, kv_len=kv_len)
    k1 = att.flash_attention_fullkv(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    # K1's tolerance against the plain version; and K1's bits: each row
    # takes K1's tiles and steps on the same core.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)
    assert torch.equal(got, k1)


def test_pipe_kernel_after_k1_on_other_inputs(cuda):
    """K10 launched right behind K1 on other inputs, with no synchronise
    between: nothing that one kernel leaves in shared memory or in the
    barriers reaches the other's items."""
    rng = np.random.default_rng(8)
    other = [att.split_heads(x, 20) for x in _packed(rng, 2, 1500, 20, cuda)]
    q, k, v = (att.split_heads(x, 20) for x in _packed(rng, 2, 1500, 20, cuda))
    k1_other = att.flash_attention_fullkv(*other, kv_len=1300)
    got = att.flash_attention_fullkv_pipe(q, k, v, kv_len=1500)
    again = att.flash_attention_fullkv_pipe(*other, kv_len=1300)
    want = att.flash_attention_fullkv_plain(q, k, v, kv_len=1500)
    k1 = att.flash_attention_fullkv(q, k, v, kv_len=1500)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)
    assert torch.equal(got, k1)
    assert torch.equal(again, k1_other)


@pytest.mark.parametrize("pair", [False, True], ids=["packed", "pair"])
@pytest.mark.parametrize("t,kv_len,causal", [
    (1500, 1500, False), (1500, 1300, False), (1500, 1500, True),
    (300, 290, True), (1500, 1281, False), (1000, 1000, False),
])
def test_packed_kernel_matches_plain_and_k1(cuda, pair, t, kv_len, causal):
    """K8 and K9 on the packed layout. kv_len 1281 is one key past a
    128-key tile; t = 1000 ends inside a 64-row block."""
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
    # K1's tolerance for both. K8 is K1's instance of the attention core on
    # the packed strides, so it gives K1's bits. K9 is the core's head-pair
    # instance: its rows run K1's 128-key tiles, but its 64-row causal
    # blocks skip other fully masked tiles, so it is held to K1's tolerance.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)
    if not pair:
        assert torch.equal(got, k1)


@pytest.mark.parametrize("t,kv_len", [(1500, 1500), (1500, 1300), (1536, 1536),
                                      (300, 290), (4096, 4096), (2000, 1900)])
def test_q8_kernel_matches_plain(cuda, t, kv_len):
    """K7 resident (T <= 1536: a head's K and Vt loaded once) and streamed
    (T 2000 and 4096: every pass streams them)."""
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
    Dh 128, and (pair) an odd head count or more head pairs than the
    grid holds never fall back."""
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
        # B * H / 2 past the grid's y axis (65535) raises before the launch.
        wide = torch.zeros((1, 1, 131072 * 64), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="grid's y axis"):
            call(wide, heads=131072)
    if form == "packed":
        # K8 is on the attention core too: B * H past 65535 raises.
        wide = torch.zeros((1, 1, 65536 * 64), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="grid's y axis"):
            call(wide, heads=65536)
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


# ---------------------------------------------------------------------------
# K5: tiled flash attention (K/V longer than 4096), and the audio contexts
# other than 1500 that reach it or K4 at another length
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tq,tk,kv_len,causal,contiguous", [
    (256, 384, 300, False, False), (256, 384, 384, False, False),
    (256, 256, 256, True, False), (333, 4301, 4200, False, False),
    (130, 4224, 4224, False, False), (200, 500, 500, True, False),
    (500, 200, 150, True, False), (64, 129, 1, False, False),
    (130, 4225, 4225, False, True), (333, 4301, 4200, True, True),
])
def test_flash_kernel_matches_plain(cuda, tq, tk, kv_len, causal, contiguous):
    """Heads as strided views of packed projections (as the encoder passes
    them), or contiguous [B, H, T, 64] tensors: the two tensor-map layouts.
    Tk 4225 is one key past a 128-multiple: a last tile of one key and 127
    rows that TMA fills with zeros."""
    rng = np.random.default_rng(11)
    b, h, d = 2, 3, 64
    packed = [_randn(rng, (b, t, h * d), cuda, scale=d ** -0.25)
              for t in (tq, tk, tk)]
    q, k, v = (att.split_heads(x, h) for x in packed)
    if contiguous:
        q, k, v = (x.contiguous() for x in (q, k, v))
    got = att.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    want = att.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert got.shape == (b, h, tq, d)
    # The two sides advance the running max at the same keys (128-key
    # tiles), so P rounds alike up to exp's last bit; only the f32
    # summation order differs, then one bf16 rounding of the output: K1's
    # tolerance. The causal rule is K5's (row >= col on absolute indices):
    # with Tq != Tk an offset of Tk - Tq moves whole rows.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("t,kv_len,causal", [
    (1500, 1500, False), (1500, 1281, False), (200, 200, True), (96, 90, False),
])
def test_flash_equals_fullkv_on_its_inputs(cuda, t, kv_len, causal):
    """K5 and K1 are one instance of the attention core (SplitRows,
    128-key tiles) behind two entries: on K1's inputs, strided head views
    of packed projections, they give the same bits."""
    rng = np.random.default_rng(15)
    q, k, v = (att.split_heads(x, 4) for x in _packed(rng, 2, t, 4, cuda))
    k1 = att.flash_attention_fullkv(q, k, v, causal=causal, kv_len=kv_len)
    k5 = att.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert torch.equal(k5, k1)


@pytest.mark.parametrize("form", ["fullkv", "q8", "pipe", "packed", "pair"])
def test_long_kv_dispatches_to_flash(cuda, form):
    """K/V longer than 4096 goes to K5 under every encoder-attention
    form, through both dispatchers."""
    rng = np.random.default_rng(12)
    h = 2
    q, k, v = (_randn(rng, (1, t, h * 64), cuda, scale=64 ** -0.25)
               for t in (128, 4200, 4200))
    others = (att.flash_attention_fullkv, att.flash_attention_fullkv_q8,
              att.flash_attention_fullkv_pipe, att.flash_attention_fullkv_packed,
              att.flash_attention_fullkv_packed_pair)
    for fn in (att.flash_attention, *others):
        fn.launches = 0
    got = att.multihead_attention_packed(q, k, v, h, form=form)
    want = att.merge_heads(att.flash_attention_plain(
        *(att.split_heads(x, h) for x in (q, k, v))))
    torch.cuda.synchronize()
    assert att.flash_attention.launches == 1
    assert all(fn.launches == 0 for fn in others)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def test_flash_wrapper_raises(cuda):
    rng = np.random.default_rng(13)
    x = att.split_heads(_randn(rng, (1, 256, 2 * 64), cuda), 2)
    with pytest.raises(TypeError, match="bfloat16"):
        att.flash_attention(x.float(), x.float(), x.float())
    with pytest.raises(ValueError, match="block_k"):
        att.flash_attention(x, x, x, block_k=64)
    x128 = att.split_heads(_randn(rng, (1, 256, 2 * 128), cuda), 2)
    with pytest.raises(ValueError, match="head dim"):
        att.flash_attention(x128, x128, x128)
    with pytest.raises(ValueError, match="kv_len"):
        att.flash_attention(x, x, x, kv_len=0)
    # B * H past the grid's y axis (65535) raises before the launch, for
    # K5 and for K1, the attention core's other SplitRows entry.
    wide = torch.zeros((1, 65536, 1, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="grid's y axis"):
        att.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="grid's y axis"):
        att.flash_attention_fullkv(wide, wide, wide)
    before = att.flash_attention.launches
    assert att.flash_attention(x, x, x).shape == x.shape
    assert att.flash_attention.launches == before + 1


@pytest.mark.parametrize("case", ["reduced-odd", "reduced-256", "long"])
def test_engine_audio_contexts_run_their_kernels(cuda, case):
    """random:tiny (6 heads of 64) away from 1500 positions: a reduced
    audio_ctx (odd: K4 reads 2-byte-aligned K/V rows) keeps K1 and runs K4
    at Tk = audio_ctx; a model with 4200 positions encodes through K5 and
    never K1."""
    import dataclasses

    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.models.whisper.config import CONFIGS

    CONFIGS["tiny-ctx4200"] = dataclasses.replace(
        CONFIGS["tiny"], name="tiny-ctx4200", n_audio_ctx=4200)
    long_model = case == "long"
    audio_ctx = {"reduced-odd": 255, "reduced-256": 256, "long": None}[case]
    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw")
    eng.load_model("random:tiny-ctx4200" if long_model else "random:tiny")
    seconds = 84 if long_model else 5
    rng = np.random.default_rng(3)
    audio = [(rng.standard_normal(16000 * seconds) * 3000).astype(np.int16)
             for _ in range(2)]
    p = TranscribeParams(language="en", parallel_windows=True,
                         condition_on_previous_text=False,
                         temperatures=(0.0,), max_tokens=8, audio_ctx=audio_ctx)
    kernels = (att.flash_attention_fullkv, att.flash_attention, w8a8_gemm,
               att.decode_cross_attention)
    for fn in kernels:
        fn.launches = 0
    results = list(eng.transcribe_stream([audio, audio], p, overlap_fetch=True))
    assert len(results) == 2 and all(len(r) == 2 for r in results)
    layers = eng.cfg.n_audio_layer
    steps = sum(eng.last_decode_steps)
    want = {fn.__name__: 0 for fn in kernels}
    want.update({
        ("flash_attention" if long_model else "flash_attention_fullkv"): 2 * layers,
        "w8a8_gemm": 2 * 6 * layers,
        "decode_cross_attention": eng.cfg.n_text_layer * (2 + steps),
    })
    assert {fn.__name__: fn.launches for fn in kernels} == want


# ---------------------------------------------------------------------------
# K11: K3's function, the heads of a batch item walked inside one block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [20, 3, 1])
@pytest.mark.parametrize("b,r", [(1, 1), (16, 1), (2, 3), (2, 8), (1, 8)])
@pytest.mark.parametrize("tk,kv_len", [(1536, 1500), (1500, 1500), (300, 257)])
def test_mh_kernel_matches_plain(cuda, h, b, r, tk, kv_len):
    """K11 on both load paths: Tk 1536 (a multiple of 16) on TMA boxes, Tk
    1500 and 300 on 16-byte cp.async covers; H 3 and 1 leave the last head
    pair half empty; B 1 with H 20 gives fewer work items than SMs."""
    rng = np.random.default_rng(14 + r)
    q = _randn(rng, (b, h, r, 64), cuda, scale=64 ** -0.5)
    qk, ks = _quant_kv(rng, b, h, tk, kv_len, 8, cuda)
    qv, vs = _quant_kv(rng, b, h, tk, kv_len, 8, cuda)
    before = att.decode_cross_attention_q8_mh.launches
    got = att.decode_cross_attention_q8_mh(q, qk, ks, qv, vs, kv_len=kv_len)
    want = att.decode_cross_attention_q8_plain(q, qk, ks, qv, vs, kv_len=kv_len)
    torch.cuda.synchronize()
    assert att.decode_cross_attention_q8_mh.launches == before + 1
    # K3's tolerance for K3's reasons: bf16(p * vs) is rounded against the
    # 128-position chunk's max and the chunks rescaled after.
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)


def test_mh_wrapper_raises(cuda):
    rng = np.random.default_rng(15)
    qk, ks = _quant_kv(rng, 1, 6, 300, 300, 8, cuda)
    q = _randn(rng, (1, 6, 1, 64), cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        att.decode_cross_attention_q8_mh(q.float(), qk, ks, qk, ks)
    with pytest.raises(ValueError, match="kv_len"):
        att.decode_cross_attention_q8_mh(q, qk, ks, qk, ks, kv_len=301)
    assert att.decode_cross_attention_q8_mh(q, qk, ks, qk, ks).shape == (1, 6, 1, 64)


# ---------------------------------------------------------------------------
# K12 and K13: in-place cache column writes, the position on the device
# ---------------------------------------------------------------------------


def _bits(x):
    return x.view(torch.int16)


@pytest.mark.parametrize("shape", [(3, 2, 2, 5, 64, 40), (7, 33), (1, 1, 128)])
@pytest.mark.parametrize("pos", [0, 17, -1])
def test_cache_col_write_matches_slice_assignment(cuda, shape, pos):
    """K13: cache[..., pos] = cols, bit for bit, every other element
    unchanged, in place (pos -1: the last position)."""
    rng = np.random.default_rng(16)
    ctx = shape[-1]
    pos = pos % ctx
    cache = _randn(rng, shape, cuda)
    cols = _randn(rng, shape[:-1], cuda)
    want = cache.clone()
    want[..., pos] = cols
    ptr = cache.data_ptr()
    got = cw.alias_col_write(cache, cols, torch.tensor(pos, dtype=torch.int32,
                                                       device=cuda))
    torch.cuda.synchronize()
    assert got is cache and cache.data_ptr() == ptr
    wrong = (_bits(got) != _bits(want)).sum().item()
    assert wrong == 0, (f"K13 not close to its plain version: {wrong} elements "
                        f"differ from the slice assignment")


def _col_write_case(rng, rows, ctx, pos, offset, dev):
    """A cache [rows, ctx] bf16 whose base lies `offset` elements into its
    buffer, cols [rows], and the slice assignment's result."""
    buf = _randn(rng, (rows * ctx + offset,), dev)
    cache = buf[offset:].view(rows, ctx)
    cols = _randn(rng, (rows,), dev)
    want = cache.clone()
    want[:, pos] = cols
    return cache, cols, want


_COL_WRITE_CASES = [  # (rows, ctx, offset)
    (300, 128, 0), (300, 136, 0), (300, 16, 0), (300, 8, 0), (1, 24, 0),
    (300, 100, 0), (300, 128, 1), (300, 136, 4),
]


@pytest.mark.parametrize("rows,ctx,offset", _COL_WRITE_CASES,
                         ids=["-".join(map(str, c)) for c in _COL_WRITE_CASES])
@pytest.mark.parametrize("pos", [0, 7, 8, 15, 16, -1])
def test_cache_col_write_at_sector_edges(cuda, rows, ctx, offset, pos):
    """K13 bit for bit against the slice assignment over the whole cache
    and in place, at the edges of a row's 32-byte sectors (pos 0, 7, 8,
    15, 16, the last): ctx 128, 136, 16, 8, 24 and 100, and a cache 2 or 8
    bytes off a 16-byte boundary."""
    rng = np.random.default_rng(19 + ctx + offset)
    pos = pos % ctx
    cache, cols, want = _col_write_case(rng, rows, ctx, pos, offset, cuda)
    ptr = cache.data_ptr()
    got = cw.alias_col_write(cache, cols, torch.tensor(pos, dtype=torch.int32,
                                                       device=cuda))
    torch.cuda.synchronize()
    assert got is cache and cache.data_ptr() == ptr
    wrong = (_bits(cache) != _bits(want)).sum().item()
    assert wrong == 0, (f"K13 not close to its plain version: {wrong} "
                        f"elements differ from the slice assignment")


@pytest.mark.parametrize("rows,ctx,hd", [(7, 24, 128), (64, 128, 1280), (1, 1, 8)])
@pytest.mark.parametrize("pos", [0, 5, -1])
def test_cache_col_write_rows_matches_slice_assignment(cuda, rows, ctx, hd, pos):
    """K12: cache_t[:, pos, :] = cols, bit for bit and in place; rows need
    not be a multiple of 8."""
    rng = np.random.default_rng(17)
    pos = pos % ctx
    cache = _randn(rng, (rows, ctx, hd), cuda)
    cols = _randn(rng, (rows, hd), cuda)
    want = cache.clone()
    want[:, pos, :] = cols
    ptr = cache.data_ptr()
    got = cw.alias_col_write_sub(cache, cols, torch.tensor(
        pos, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert got is cache and cache.data_ptr() == ptr
    wrong = (_bits(got) != _bits(want)).sum().item()
    assert wrong == 0, (f"K12 not close to its plain version: {wrong} elements "
                        f"differ from the slice assignment")


def test_cache_col_write_position_and_checks(cuda):
    """A position outside [0, ctx) writes nothing; the position follows
    the device tensor between launches; host positions, other dtypes and
    shapes raise."""
    rng = np.random.default_rng(18)
    cache = _randn(rng, (4, 6, 16), cuda)
    cols = _randn(rng, (4, 6), cuda)
    keep = cache.clone()
    pos = torch.tensor(16, dtype=torch.int32, device=cuda)
    cw.alias_col_write(cache, cols, pos)
    assert torch.equal(cache, keep)
    pos.fill_(-1)
    cw.alias_col_write(cache, cols, pos)
    assert torch.equal(cache, keep)
    for p in (3, 9):  # the same tensor, updated on the device
        pos.fill_(p)
        cw.alias_col_write(cache, cols, pos)
        keep[..., p] = cols
    assert torch.equal(cache, keep)
    with pytest.raises(TypeError, match="int32"):
        cw.alias_col_write(cache, cols, 3)
    with pytest.raises(TypeError, match="int32"):
        cw.alias_col_write(cache, cols, pos.long())
    with pytest.raises(TypeError, match="2-byte"):
        cw.alias_col_write(cache.float(), cols.float(), pos)
    with pytest.raises(ValueError, match="cols must be"):
        cw.alias_col_write(cache, cols[:3], pos)
    sub = _randn(rng, (4, 16, 100), cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        cw.alias_col_write_sub(sub, _randn(rng, (4, 100), cuda), pos)
    with pytest.raises(ValueError, match="contiguous"):
        cw.alias_col_write(cache.transpose(0, 1), cols.transpose(0, 1), pos)


# ---------------------------------------------------------------------------
# The app's path: sampling, language detection and transcribe_samples
# ---------------------------------------------------------------------------


def _tiny_engine(**opts):
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16,
                        quantize_encoder=True, wire="mulaw", **opts)
    eng.load_model("random:tiny")
    return eng


def test_sampled_decode_on_the_card_is_seeded(cuda):
    """Temperature sampling on the card draws its noise from a generator
    on the card: the same seed gives the same tokens on every call, another
    seed other tokens, and the draws leave the argmax path."""
    from spittle_tpu_torch.models.whisper.decode import (
        DecodeOptions,
        gumbel_noise,
        greedy_decode,
    )

    eng = _tiny_engine()
    rng = np.random.default_rng(5)
    xa = _randn(rng, (2, eng.cfg.n_audio_ctx, eng.cfg.n_audio_state), cuda)
    assert gumbel_noise((2, 8), 0, cuda)(0).device.type == "cuda"

    def tokens(**kw):
        return greedy_decode(eng.params, xa, eng.cfg,
                             DecodeOptions(language="en", max_tokens=16, **kw)
                             )["tokens"]

    first = tokens(temperature=0.7, seed=5)
    assert first.device.type == "cuda"
    assert torch.equal(first, tokens(temperature=0.7, seed=5))
    assert not torch.equal(first, tokens(temperature=0.7, seed=6))
    assert not torch.equal(first, tokens())


def _all_on_the_card(value, where):
    """Every tensor inside value (tensors, dicts, tuples, lists) is on a
    CUDA device."""
    if isinstance(value, torch.Tensor):
        assert value.device.type == "cuda", (where, value.shape, value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _all_on_the_card(v, where)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _all_on_the_card(v, where)


def test_transcribe_samples_keeps_its_decode_on_the_card(cuda, monkeypatch):
    """transcribe_samples with the app's defaults over 35 s (two windows,
    language detection, the six-rung ladder at an 8-token budget, the
    prompt carry): every tensor that reaches detection, the decode loop,
    the prefill and each step lies on the card, and the kernel counters
    move as the path's shapes say (K1 and K2 per window, K4 per decoder
    layer for each step, each prefill of at most 8 rows and each
    detection)."""
    from spittle_tpu_torch.engine import whisper_engine as tengine
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.models.whisper import decode as tdec

    for module, name in ((tdec, "decode_step"), (tdec, "decoder_prefill"),
                         (tengine, "greedy_decode"),
                         (tengine, "detect_language")):
        real = getattr(module, name)

        def checked(*a, _real=real, _name=name, **kw):
            _all_on_the_card((a, kw), _name)
            out = _real(*a, **kw)
            _all_on_the_card(out, _name)
            return out

        monkeypatch.setattr(module, name, checked)
    eng = _tiny_engine()
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal(16000 * 35) * 3000).astype(np.int16)
    kernels = (att.flash_attention_fullkv, w8a8_gemm,
               att.decode_cross_attention, att.decode_cross_attention_q8,
               att.decode_cross_attention_q4)
    for fn in kernels:
        fn.launches = 0
    res = eng.transcribe_samples(audio, TranscribeParams(max_tokens=8))
    torch.cuda.synchronize()
    assert res.language in eng.tokenizer.languages
    windows = len(eng.last_decode_rungs)
    assert windows >= 2
    dec = sum(s + (rows <= 8) for s, rows in
              zip(eng.last_decode_steps, eng.last_prefix_rows))
    want = {fn.__name__: 0 for fn in kernels}
    want.update({
        "flash_attention_fullkv": windows * eng.cfg.n_audio_layer,
        "w8a8_gemm": windows * 6 * eng.cfg.n_audio_layer,
        "decode_cross_attention": eng.cfg.n_text_layer * (dec + 1),
    })
    assert {fn.__name__: fn.launches for fn in kernels} == want


def test_detect_language_runs_k4_on_an_int8_engine(cuda):
    """Under the int8 decoder and cache, detection still reads
    unquantized cross-K/V: K4 once per decoder layer, never K3; the
    probabilities are finite and sum to 1."""
    from spittle_tpu_torch.models.whisper.decode import detect_language

    eng = _tiny_engine(quantize_decoder="int8", quantize_cache=True)
    rng = np.random.default_rng(6)
    xa = _randn(rng, (3, eng.cfg.n_audio_ctx, eng.cfg.n_audio_state), cuda)
    for fn in (att.decode_cross_attention, att.decode_cross_attention_q8):
        fn.launches = 0
    probs = detect_language(eng.params, xa, eng.cfg)
    assert att.decode_cross_attention.launches == eng.cfg.n_text_layer
    assert att.decode_cross_attention_q8.launches == 0
    assert probs.shape == (3, eng.cfg.n_langs) and probs.dtype == torch.float32
    assert torch.isfinite(probs).all()
    torch.testing.assert_close(probs.sum(-1), torch.ones(3, device=cuda),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K14: the "w8a8" decoder's cross-attention, both products int8 x int8
# ---------------------------------------------------------------------------


def _w8a8_inputs(rng, b, h, r, dh, t, dev, dtype=torch.bfloat16, pitch=None,
                 kv_len=None, ties=False):
    """q (pre-scaled by Dh^-0.5) and the decoder's "qw8" K/V with f32
    scales, K/V rows `pitch` bytes apart (random codes in the padding,
    which K14 may read but must not use). With kv_len < t the pad
    positions carry random codes and scales 1e3: their scores dwarf the
    real ones, so only a mask before the max keeps them out. ties: q rows
    of half-integers with amax 127 (sq = 1), where rounding half to even
    and half away differ."""
    from spittle_tpu_torch.ops.quant import quantize_kv_w8a8

    kv = [quantize_kv_w8a8(_randn(rng, (b, h, dh, t), dev, torch.float32))
          for _ in range(2)]
    if kv_len is not None and kv_len < t:
        for d in kv:
            d["qw8"][..., kv_len:] = torch.randint(-127, 128, d["qw8"][..., kv_len:].shape,
                                                   dtype=torch.int8, device=dev)
            d["scale"][..., kv_len:] = 1e3
    if pitch is not None:
        for d in kv:
            d["qw8"] = _padded_rows(d["qw8"], pitch)
    if ties:
        q = torch.from_numpy(rng.integers(-126, 126, (b, h, r, dh)).astype(np.float32)
                             + 0.5).to(dev)
        q[..., 0] = 127.0
        q = q.to(dtype)
    else:
        q = _randn(rng, (b, h, r, dh), dev, dtype, dh ** -0.5)
    return q, kv[0]["qw8"], kv[0]["scale"], kv[1]["qw8"], kv[1]["scale"]


def _assert_k14_close(got, args, kv_len):
    """K14 against its plain version on CPU copies of the same inputs: the
    same q codes and scales (IEEE division, round half to even), exact
    int32 sums and the same f32 operations in the same order; exp's last
    bit and the sum's order differ, and where that lands pv/sp on the
    other side of a rounding boundary one P code moves by one, moving the
    row by at most max(p * vs) (att.w8a8_code_step). So: within one
    output ulp (2**-7 relative in bf16, 1e-5 in f32) plus one such step
    per row, and at most 1% of the rows beyond one ulp. A code rounded
    half away, a row's scores taken with a neighbour's q scale, the pad
    let into the max or the rows read at the wrong pitch move rows by far
    more."""
    cpu = [a.cpu() for a in args]
    want = att.decode_cross_attention_w8a8_plain(*cpu, kv_len=kv_len)
    step = att.w8a8_code_step(*cpu, kv_len=kv_len)
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous()
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
    err = (got.cpu().float() - want.float()).abs()
    tol = rel * want.float().abs() + 1e-5
    excess = (err - tol).amax(dim=-1)
    worst = (excess - 1.001 * step).max().item()
    share = (excess > 0).float().mean().item()
    assert worst <= 0 and share <= 0.01, (
        f"K14 not close to its plain version: {worst:.3e} past the bound, "
        f"{share:.2%} of the rows past one ulp")


# (B, R, T, kv_len, pitch, dtype, Dh): chip_smoke's large-v3 shapes (B 8,
# H 20, Dh 64, T 1500 at a 1504-byte pitch) at a greedy step (R 1), a
# speculative verify (4), K3's most rows (8) and a prefill tile (228);
# kv_len < T; contiguous rows, an odd T (byte loads), f32 q and the
# trained tiny checkpoint's Dh 8; a long T (tiles of 16 rows on the tensor
# cores); bench.py's large-v3 batch (B 56, H 20); kv_len 100, so that
# ranks 1-7 of the cluster hold only pad; R 64 and 65 at a tensor-core row
# tile's edge; a prefill with kv_len < T; Dh 8 past 8 rows (the __dp4a
# regime in row tiles of 8); K/V streamed from global memory (T 45000 at a
# step's row and a prefill's 228 rows, with kv_len < T; an odd T whose
# rows are read byte by byte).
_K14_CASES = {
    "B8-R1-T1500-padded": (8, 1, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R4-T1500-padded": (8, 4, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R8-T1500-padded": (8, 8, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R228-T1500-padded": (8, 228, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R4-T1500-kv1300-padded": (8, 4, 1500, 1300, 1504, torch.bfloat16, 64),
    "B2-R3-T1500-contiguous": (2, 3, 1500, 1500, None, torch.bfloat16, 64),
    "B2-R5-T301-kv257-contiguous": (2, 5, 301, 257, None, torch.bfloat16, 64),
    "B2-R4-T1500-f32": (2, 4, 1500, 1500, 1504, torch.float32, 64),
    "B2-R13-T96-dh8-f32": (2, 13, 96, 96, None, torch.float32, 8),
    "B1-R9-T6000": (1, 9, 6000, 6000, None, torch.bfloat16, 64),
    "B56-R1-T1500-padded": (56, 1, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R4-T1500-kv100-padded": (8, 4, 1500, 100, 1504, torch.bfloat16, 64),
    "B8-R64-T1500-padded": (8, 64, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R65-T1500-padded": (8, 65, 1500, 1500, 1504, torch.bfloat16, 64),
    "B8-R228-T1500-kv1300-padded": (8, 228, 1500, 1300, 1504, torch.bfloat16, 64),
    "B2-R16-T1500-dh8-f32": (2, 16, 1500, 1500, 1504, torch.float32, 8),
    "B1-R1-T45000-stream": (1, 1, 45000, 45000, None, torch.bfloat16, 64),
    "B1-R228-T45000-kv44000-stream": (1, 228, 45000, 44000, 45008, torch.bfloat16, 64),
    "B1-R3-T20001-kv19999-stream-contiguous": (1, 3, 20001, 19999, None, torch.bfloat16, 64),
}


@pytest.mark.parametrize("case", list(_K14_CASES))
def test_k14_kernel_matches_plain(cuda, case):
    b, r, t, kv_len, pitch, dtype, dh = _K14_CASES[case]
    rng = np.random.default_rng(14)
    h = 20 if b >= 8 else 3
    args = _w8a8_inputs(rng, b, h, r, dh, t, cuda, dtype, pitch, kv_len)
    got = att.decode_cross_attention_w8a8(*args, kv_len=kv_len)
    torch.cuda.synchronize()
    _assert_k14_close(got, args, kv_len)


def test_k14_kernel_matches_plain_on_ties(cuda):
    """q / sq on .5 for most entries: the codes round half to even."""
    rng = np.random.default_rng(15)
    args = _w8a8_inputs(rng, 2, 4, 4, 64, 1500, cuda, ties=True, pitch=1504)
    got = att.decode_cross_attention_w8a8(*args)
    torch.cuda.synchronize()
    _assert_k14_close(got, args, 1500)


def test_k14_stable_over_many_launches(cuda):
    """200 launches at the large-v3 step's shape, alternating two input
    sets: each set's output is the same bits every time (no atomics, no
    state kept between launches) and close to its plain version."""
    rng = np.random.default_rng(16)
    sets = [_w8a8_inputs(rng, 8, 20, 4, 64, 1500, cuda, pitch=1504) for _ in range(2)]
    first = [att.decode_cross_attention_w8a8(*a) for a in sets]
    for i in range(200):
        got = att.decode_cross_attention_w8a8(*sets[i % 2])
        assert torch.equal(got, first[i % 2]), f"launch {i} differs"
    torch.cuda.synchronize()
    for out, args in zip(first, sets):
        _assert_k14_close(out, args, 1500)


def test_k14_plan_smem_is_the_kernels_layout(cuda):
    """The plan's shared-memory bytes (ops.attention.w8a8_smem_bytes, which
    fits the row tile on the host) equal the kernel's own Layout, which the
    C entry launches with (spt_w8a8_smem_bytes), at every plan from T 1 to
    T 100000 (streamed), every R and Dh 8 to 256."""
    lib = _build.load_library()
    for tk in (1, 96, 301, 1500, 6000, 8000, 13000, 20001, 45000, 100000):
        for r in (1, 3, 4, 8, 9, 13, 64, 65, 228):
            for dh in (8, 32, 64, 256):
                p = att.w8a8_plan(tk, r, dh)
                want = lib.spt_w8a8_smem_bytes(int(p.mma), int(p.stream), p.slice,
                                               p.row_tile, dh, p.cluster)
                assert p.smem == want, (tk, r, dh, p)


def test_k14_wrapper_raises(cuda):
    """On the card the wrapper launches K14 or raises: no fallback for a
    head dim that is not a multiple of 4, int8 K/V of another dtype, f16
    q, or T too long for one row's scores in shared memory."""
    rng = np.random.default_rng(17)
    q, qk, ks, qv, vs = _w8a8_inputs(rng, 1, 2, 3, 64, 100, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        att.decode_cross_attention_w8a8(q[..., :62], qk[:, :, :62], ks, qv[:, :, :62], vs)
    with pytest.raises(TypeError, match="bf16 or f32"):
        att.decode_cross_attention_w8a8(q.half(), qk, ks, qv, vs)
    with pytest.raises(TypeError, match="int8"):
        att.decode_cross_attention_w8a8(q, qk.float(), ks, qv, vs)
    big = torch.zeros((1, 1, 64, 150000), dtype=torch.int8, device=cuda)
    sc = torch.ones((1, 1, 150000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        att.decode_cross_attention_w8a8(q[:, :1], big, sc, big, sc)
    assert att.decode_cross_attention_w8a8(q, qk, ks, qv, vs).shape == q.shape


def test_engine_speculative_verifies_k_rows(cuda):
    """A bf16 engine with a self-draft: every main-model pass verifies
    draft_k = 4 rows per item through K4, the draft's steps one row each:
    K4 runs once per main layer for the prefill and each round, and once
    per draft layer for the prefill and each of a round's 4 draft steps."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

    eng = WhisperEngine(device="cuda", dtype=torch.bfloat16)
    eng.load_model("random:tiny")
    eng.load_self_draft(2)
    rng = np.random.default_rng(18)
    audio = [(rng.standard_normal(16000 * 30) * 3000).astype(np.int16) for _ in range(2)]
    p = TranscribeParams(language="en", parallel_windows=True,
                         condition_on_previous_text=False, temperatures=(0.0,),
                         max_tokens=12)
    att.decode_cross_attention.launches = 0
    eng.last_decode_steps.clear()
    res = eng.transcribe_batch(audio, p)
    assert len(res) == 2
    (rounds,) = eng.last_decode_steps
    assert rounds == eng.last_spec_stats["rounds"] > 0
    main, draft = eng.cfg.n_text_layer, eng.draft_cfg.n_text_layer
    assert att.decode_cross_attention.launches == (
        main * (1 + rounds) + draft * (1 + 4 * rounds))


def test_device_trace_names_k4(cuda, tmp_path):
    """Tracer.device_trace around K4 calls: the trace's kernel events name
    K4's __global__ symbol (decode_cross_mh_kernel) once per launch the
    wrapper counts."""
    from spittle_tpu_torch.utils.tracing import Tracer

    rng = np.random.default_rng(20)
    b, h, d, tk = 2, 4, 64, 1500
    q = _randn(rng, (b, h, 1, d), cuda, scale=d ** -0.5)
    k = _randn(rng, (b, h, d, tk), cuda)
    v = _randn(rng, (b, h, d, tk), cuda)
    att.decode_cross_attention(q, k, v)  # built and warm outside the trace
    torch.cuda.synchronize()
    att.decode_cross_attention.launches = 0
    with Tracer().device_trace(str(tmp_path)) as rec:
        for _ in range(3):
            att.decode_cross_attention(q, k, v)
    with open(rec["path"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k4 = [n for n in kernels if "decode_cross_mh_kernel" in n]
    assert att.decode_cross_attention.launches == 3
    assert len(k4) == att.decode_cross_attention.launches, kernels


# ---------------------------------------------------------------------------
# The f32 forms: K1 (and K5's route), K4, K3 and K6 at the JAX package's
# default precision
# ---------------------------------------------------------------------------


def _f32_close(got, want):
    """The f32 kernels' rule: max |kernel - plain| <= 1e-5 * max |plain|.
    Both are f32 end to end; only the order of the f32 sums and the
    softmax's running max differ (errors of ~1e-7 of the largest output)."""
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("b,tq,tk,kv_len,causal", [
    (8, 1500, 1500, 1500, False), (1, 1500, 1500, 1500, False),
    (8, 256, 256, 256, False), (4, 224, 224, 224, True),
    (8, 1500, 1500, 1300, False), (2, 333, 1500, 1201, True),
    (1, 130, 4096, 4000, False),
])
def test_fullkv_f32_kernel_matches_plain(cuda, b, tq, tk, kv_len, causal):
    """K1's f32 form at the encoder's shapes (B 8 and the app's B 1 at 1500
    positions, the reduced context's 256), causal, a ragged kv_len, Tq !=
    Tk and K/V at the full-KV limit, q, k, v as strided views of packed
    projections, against K1's plain version."""
    rng = np.random.default_rng(b + tq + kv_len)
    h, d = 20, 64
    q = _randn(rng, (b, tq, h * d), cuda, torch.float32, d ** -0.25)
    k, v = (_randn(rng, (b, tk, h * d), cuda, torch.float32, d ** -0.25)
            for _ in range(2))
    q, k, v = (att.split_heads(x, h) for x in (q, k, v))
    before = att.flash_attention_fullkv_f32.launches
    got = att.flash_attention_fullkv(q, k, v, causal=causal, kv_len=kv_len)
    want = att.flash_attention_fullkv_plain(q, k, v, causal, kv_len)
    torch.cuda.synchronize()
    assert att.flash_attention_fullkv_f32.launches == before + 1
    _f32_close(got, want)


@pytest.mark.parametrize("tq,tk,kv_len,causal", [
    (6000, 6000, 6000, False), (6000, 6000, 5000, False), (6000, 6000, 6000, True),
    (333, 4301, 4200, True),
])
def test_flash_f32_route_matches_plain(cuda, tq, tk, kv_len, causal):
    """K5's route at f32 ([2, 20, 6000, 64], the long window), through the
    dispatch, against K5's plain version."""
    rng = np.random.default_rng(tq + kv_len)
    b, h, d = 2, 20, 64
    q = _randn(rng, (b, h, tq, d), cuda, torch.float32, d ** -0.25)
    k, v = (_randn(rng, (b, h, tk, d), cuda, torch.float32, d ** -0.25)
            for _ in range(2))
    before = att.flash_attention_f32.launches
    got = att.multihead_attention(q, k, v, causal=causal, kv_len=kv_len)
    want = att.flash_attention_plain(q, k, v, causal, kv_len)
    torch.cuda.synchronize()
    assert att.flash_attention_f32.launches == before + 1
    _f32_close(got, want)


@pytest.mark.parametrize("b,r,tk,kv_len,layout", [
    (8, 1, 1500, 1500, "padded"), (8, 3, 1500, 1500, "padded"),
    (8, 8, 1500, 1500, "padded"), (1, 1, 1500, 1500, "padded"),
    (2, 1, 6000, 6000, "padded"), (2, 5, 1500, 1300, "padded"),
    (2, 3, 255, 201, "contiguous"), (2, 8, 301, 301, "contiguous"),
])
def test_decode_cross_f32_kernel_matches_plain(cuda, b, r, tk, kv_len, layout):
    """K4's f32 instance on the decoder's rows (tma_pitch at 4 bytes: 1500
    for 1500, TMA) and on contiguous rows of odd length (cp.async covers),
    the columns from kv_len on and the padding holding NaN and inf, against
    K4's plain version (P unrounded in both)."""
    rng = np.random.default_rng(70 + b + r + tk)
    h = 20
    pitch = att.tma_pitch(tk, 4) if layout == "padded" else tk

    def kv():
        buf = torch.full((b, h, 64, pitch), float("nan"), device=cuda)
        buf[..., :kv_len] = _randn(rng, (b, h, 64, kv_len), cuda, torch.float32)
        buf[..., kv_len:tk:2] = float("inf")
        return buf[..., :tk]

    q = _randn(rng, (b, h, r, 64), cuda, torch.float32, 64 ** -0.5)
    k, v = kv(), kv()
    before = att.decode_cross_attention_f32.launches
    got = att.decode_cross_attention(q, k, v, kv_len=kv_len)
    want = att.decode_cross_attention_plain(q, k[..., :kv_len].contiguous(),
                                            v[..., :kv_len].contiguous())
    torch.cuda.synchronize()
    assert att.decode_cross_attention_f32.launches == before + 1
    _f32_close(got, want)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("b,r,kv_len", [(8, 1, 1500), (8, 5, 1500), (1, 1, 1500),
                                        (2, 3, 1300)])
def test_decode_cross_quant_f32q_kernel_matches_plain(cuda, bits, b, r, kv_len):
    """K3's and K6's instances with an f32 q on the decoder's padded rows
    (1504 bytes), against their plain versions on the same f32 q: f32
    output, the bf16 instances' tolerance (P rounds to bf16 against each
    128-position item's max in the kernel, the row max in the plain
    version)."""
    rng = np.random.default_rng(90 + bits + b + r)
    h, tk = 20, 1500
    q = _randn(rng, (b, h, r, 64), cuda, torch.float32, 64 ** -0.5)
    qk, ks = _quant_kv(rng, b, h, tk, kv_len, bits, cuda)
    qv, vs = _quant_kv(rng, b, h, tk, kv_len, bits, cuda)
    args = (q, _padded_rows(qk, 1504), ks, _padded_rows(qv, 1504), vs)
    fn, plain = _QUANT_KERNELS[bits]
    entry = (att.decode_cross_attention_q8_f32q if bits == 8
             else att.decode_cross_attention_q4_f32q)
    before = entry.launches
    got = fn(*args, kv_len=kv_len)
    want = plain(*args, kv_len=kv_len)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-2, atol=2e-3)


def test_engine_f32_default_runs_the_f32_kernels(cuda):
    """WhisperEngine(device="cuda") at its default dtype (f32) on a small
    Dh-64 config: one encode per window batch on K1's f32 form, every
    decode step on K4's f32 instance, no bf16 instance launched."""
    from spittle_tpu_torch.engine.base import TranscribeParams
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.models.whisper.config import CONFIGS, WhisperConfig

    CONFIGS["test-f32-card"] = WhisperConfig(
        name="test-f32-card", n_mels=80, n_audio_ctx=200, n_audio_state=256,
        n_audio_head=4, n_audio_layer=2, n_vocab=51865, n_text_ctx=32,
        n_text_state=256, n_text_head=4, n_text_layer=2)
    eng = WhisperEngine(device="cuda")
    eng.load_model("random:test-f32-card", seed=0)
    names = ("flash_attention_fullkv", "decode_cross_attention",
             "flash_attention_fullkv_f32", "decode_cross_attention_f32")
    for n in names:
        getattr(att, n).launches = 0
    rng = np.random.default_rng(3)
    audio = [(0.3 * rng.standard_normal(16000 * 3)).astype(np.float32)
             for _ in range(2)]
    res = eng.transcribe_batch(audio, TranscribeParams(
        language="en", parallel_windows=True, temperatures=(0.0,),
        condition_on_previous_text=False))
    torch.cuda.synchronize()
    assert len(res) == 2 and eng.dtype == torch.float32
    assert att.flash_attention_fullkv_f32.launches == 2
    assert att.decode_cross_attention_f32.launches >= 2
    assert att.flash_attention_fullkv.launches == 0
    assert att.decode_cross_attention.launches == 0
