"""The "w8a8" decoder of spittle_tpu_torch against the JAX reference on
the CPU: quantize_kv_w8a8, K14's plain version (both cross-attention
products int8 x int8 -> int32, q and P quantized per row) against the
reference's "qw8" branch of _cross_attention at any number of rows, with
kv_len masking and the beam fold, the two-step cross-K/V, greedy_decode
and WhisperEngine(quantize_decoder="w8a8") against the JAX engine, and
beam search, which takes plain int8 K/V (K3's route) under "w8a8" as the
reference does. The same numpy-seeded weights go into both packages
through params_from_jax; each tolerance says why.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import beam as jbeam
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.ops import quant as jquant
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import beam as tbeam
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import attention as tatt
from spittle_tpu_torch.ops import quant as tquant
from spittle_tpu_torch.ops.attention import tma_pitch

from test_torch_app_path import NARROW, _numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

MAX_TOKENS = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Eager torch loops beside the suite's other workers: one intra-op
    thread for this module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def narrow():
    """The narrow model (Dh 64, 2 decoder layers, the multilingual token
    layout), its weight-only int8 decoder in both packages, and an
    encoder output for two windows."""
    jc, tc = jcfg.WhisperConfig(**NARROW), tcfg.WhisperConfig(**NARROW)
    tree = _numpy_tree(jc, seed=5)
    jp = jquant.quantize_whisper_decoder(jax.tree.map(jnp.asarray, tree))
    xa = np.random.default_rng(6).standard_normal(
        (2, jc.n_audio_ctx, jc.n_audio_state)).astype(np.float32)
    return jc, tc, jp, params_from_jax(jp), xa


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# quantize_kv_w8a8 and K14's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 2, 64, 10), (2, 1, 2, 8, 37)])
def test_quantize_kv_w8a8_bytes_equal_reference(shape):
    rng = np.random.default_rng(0)
    kv = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    kv[0, 0, ..., 1] = 0.0  # an all-zero position takes scale 1
    got = tquant.quantize_kv_w8a8(_t(kv))
    ref = jquant.quantize_kv_w8a8(jnp.asarray(kv))
    assert tquant.is_quant_w8a8(got) and set(got) == {"qw8", "scale"}
    np.testing.assert_array_equal(got["qw8"].numpy(), np.asarray(ref["qw8"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    np.testing.assert_array_equal(tquant.dequantize_kv(got, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize_kv(ref, jnp.float32)))
    assert tquant.kv_codes(got) is got["qw8"]


def _w8a8_operands(rng, bc, h, dh, t, pad_to=None):
    """(K dict, V dict) in both packages from one draw: quantize_kv_w8a8
    of N(0, 1) K/V, optionally padded to pad_to positions with junk codes
    (77) and large scales (50), which only the kv_len mask keeps out."""
    jk, jv = (jquant.quantize_kv_w8a8(
        jnp.asarray(rng.standard_normal((bc, h, dh, t)), jnp.float32)) for _ in range(2))
    if pad_to:
        def pad(q):
            return {"qw8": jnp.pad(q["qw8"], [(0, 0)] * 3 + [(0, pad_to - t)],
                                   constant_values=77),
                    "scale": jnp.pad(q["scale"], [(0, 0)] * 2 + [(0, pad_to - t)],
                                     constant_values=50.0)}
        jk, jv = pad(jk), pad(jv)
    return (jk, jv), (params_from_jax(jk), params_from_jax(jv))


def assert_w8a8_close(got, ref, q, k, v, kv_len):
    """K14's plain version repeats the reference's arithmetic: the same q
    codes and scales (IEEE division, round half to even), exact int32
    sums, the same f32 operations in the same order. Only exp's last bit
    (two libraries) and the softmax sum's order differ (~1e-7), and where
    that lands pv/sp on the other side of a rounding boundary one P code
    moves by one, which moves the row by at most max(p * vs) (|qV| <= 127
    times sp = pa/127; w8a8_code_step). So: every output within 1e-5 plus
    one such step, and at most 1% of the rows beyond 1e-5. q [B, H, R,
    Dh] pre-scaled, k/v the port's K/V dicts, one per query item."""
    step = tatt.w8a8_code_step(q, k["qw8"], k["scale"], v["qw8"], v["scale"],
                               kv_len).numpy()
    err = np.abs(np.asarray(got) - np.asarray(ref)).max(axis=-1)
    assert got.shape == ref.shape
    assert np.all(err <= 1e-5 + 1.001 * step), (err - step).max()
    assert np.mean(err > 1e-5) <= 0.01


@pytest.mark.parametrize("r,padded", [(1, False), (4, True), (8, False), (13, True)])
def test_k14_plain_matches_reference(monkeypatch, r, padded):
    """R rows (a step, a speculative verify, K3's largest, a prefill's
    prompt) through the port's _cross_attention, which sends every "qw8"
    call to K14's wrapper whatever R is (its plain version here), against
    the reference's; padded: 100 real positions of 128, the pad's codes
    junk and its scales large."""
    rows = []
    real = tmod.decode_cross_attention_w8a8
    monkeypatch.setattr(tmod, "decode_cross_attention_w8a8",
                        lambda qq, *a, **kw: rows.append(qq.shape[2]) or real(qq, *a, **kw))
    rng = np.random.default_rng(r)
    b, h, dh, t = 2, 3, 64, 100
    (jk, jv), (tk_, tv_) = _w8a8_operands(rng, b, h, dh, t, 128 if padded else None)
    cq = rng.standard_normal((b, h, r, dh)).astype(np.float32)
    got = tmod._cross_attention(_t(cq), tk_, tv_, dh, kv_len=t).numpy()
    ref = np.asarray(jmod._cross_attention(jnp.asarray(cq), jk, jv, dh, kv_len=t))
    assert rows == [r]
    assert_w8a8_close(got, ref, _t(cq) * dh ** -0.5, tk_, tv_, t)


@pytest.mark.parametrize("beams,q", [(3, 1), (5, 3)])
def test_k14_beam_fold_matches_reference(monkeypatch, beams, q):
    """Bq = B * beams query items over B items' K/V: the beams fold into
    the item's rows (one K14 call at beams * q rows), as the reference
    folds them."""
    rows = []
    real = tmod.decode_cross_attention_w8a8
    monkeypatch.setattr(tmod, "decode_cross_attention_w8a8",
                        lambda qq, *a, **kw: rows.append(qq.shape[2]) or real(qq, *a, **kw))
    rng = np.random.default_rng(40 + beams)
    bc, h, dh, t = 2, 2, 64, 64
    (jk, jv), (tk_, tv_) = _w8a8_operands(rng, bc, h, dh, t)
    cq = rng.standard_normal((bc * beams, h, q, dh)).astype(np.float32)
    got = tmod._cross_attention(_t(cq), tk_, tv_, dh).numpy()
    ref = np.asarray(jmod._cross_attention(jnp.asarray(cq), jk, jv, dh))
    assert rows == [beams * q]
    # Query item i reads K/V item i // beams.
    per_item = [{key: a.repeat_interleave(beams, dim=0) for key, a in d.items()}
                for d in (tk_, tv_)]
    assert_w8a8_close(got, ref, _t(cq) * dh ** -0.5, *per_item, t)


def test_k14_plain_ties_round_half_to_even():
    """q rows of half-integers with amax 127 (sq = 1): q / sq lands on .5
    for most entries, where round half to even and half away differ; the
    plain version's codes must be the reference's."""
    rng = np.random.default_rng(8)
    b, h, dh, t = 1, 2, 64, 40
    (jk, jv), (tk_, tv_) = _w8a8_operands(rng, b, h, dh, t)
    q = rng.integers(-126, 126, (b, h, 3, dh)).astype(np.float32) + 0.5
    q[..., 0] = 127.0
    # _cross_attention scales q by Dh^-0.5 = 1/8 (exact): pass 8 q.
    got = tmod._cross_attention(_t(8 * q), tk_, tv_, dh).numpy()
    ref = np.asarray(jmod._cross_attention(jnp.asarray(8 * q), jk, jv, dh))
    assert_w8a8_close(got, ref, _t(q), tk_, tv_, t)
    away = np.sign(q) * np.floor(np.abs(q) + 0.5)
    assert np.any(np.round(q) != away)  # the ties are there


def test_k14_rows_per_block_fit_shared_memory():
    """The tiling of K14's rows by T and R (w8a8_plan): up to 8 rows per
    CTA under __dp4a, 64 under the tensor cores, fewer where a rank's
    slice of T would not fit beside them; past that K and V are streamed
    from global memory, and one row per CTA still runs at T 45000 (the
    most the first design took) at a step's R 1 and a prefill's R 228;
    none past what one row fits."""
    assert tatt.w8a8_plan(1500, 8, 64).row_tile == 8
    assert tatt.w8a8_plan(1500, 228, 64).row_tile == 64
    assert tatt.w8a8_plan(6000, 228, 64).row_tile == 16
    assert tatt.w8a8_plan(12000, 1, 64).row_tile == 1
    for r in (1, 228):
        plan = tatt.w8a8_plan(45000, r, 64)
        assert plan.stream and not plan.mma and plan.row_tile >= 1
    with pytest.raises(ValueError, match="shared memory"):
        tatt.w8a8_plan(150000, 1, 64)
    for tk in (1, 1500, 1501, 6000, 45000):
        for r in (1, 8, 228):
            plan = tatt.w8a8_plan(tk, r, 64)
            assert plan.smem == tatt.w8a8_smem_bytes(plan.mma, plan.slice, plan.row_tile,
                                                     64, plan.cluster, plan.stream)
            assert plan.smem <= tatt.W8A8_SMEM_BUDGET


# ---------------------------------------------------------------------------
# The decoder under "w8a8"
# ---------------------------------------------------------------------------


def test_cross_kv_w8a8_matches_reference(narrow):
    """The reference's two-step cross-K/V (precompute_cross_kv, then
    quantize_kv_w8a8 of the stack) against the port's per-layer one: the
    same int8 codes, scales to rtol 1e-6 (XLA's fusion may move the f32
    projection by an ulp), the codes stored tma_pitch(T) apart."""
    jc, tc, jp, tp, xa = narrow
    opts = tdec.DecodeOptions(quant_kv=True, quant_kv_w8a8=True)
    got = tdec.precompute_cross_kv_for(tp, _t(xa), tc, opts)
    jk, jv = jmod.precompute_cross_kv(jp, jnp.asarray(xa), jc)
    for g, r in zip(got, (jquant.quantize_kv_w8a8(jk), jquant.quantize_kv_w8a8(jv))):
        assert set(g) == {"qw8", "scale"}
        np.testing.assert_array_equal(g["qw8"].numpy(), np.asarray(r["qw8"]))
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(r["scale"]),
                                   rtol=1e-6)
        assert g["qw8"].stride(-2) == tma_pitch(jc.n_audio_ctx)


@pytest.mark.parametrize("quant_cache,prompt", [(False, ()), (True, tuple(range(300, 312)))])
def test_greedy_decode_w8a8_matches_reference(monkeypatch, narrow, quant_cache, prompt):
    """greedy_decode under quant_kv_w8a8 (the weight-only int8 decoder,
    "qw8" cross-K/V, with and without the int8 self-cache, with a prompt
    whose prefill takes 16 rows): tokens identical to the reference's;
    avg_logprob within 2e-3 (a P code moved by one per row, above, moves a
    log-prob by ~1e-4 per step); every cross-attention call goes to K14's
    wrapper, the steps at 1 row, the prefill at its prefix's rows."""
    jc, tc, jp, tp, xa = narrow
    rows = []
    real = tmod.decode_cross_attention_w8a8
    monkeypatch.setattr(tmod, "decode_cross_attention_w8a8",
                        lambda qq, *a, **kw: rows.append(qq.shape[2]) or real(qq, *a, **kw))
    kw = dict(language="en", max_tokens=MAX_TOKENS, quant_kv=True,
              quant_kv_w8a8=True, quant_cache=quant_cache)
    ref = jdec.greedy_decode(jp, jnp.asarray(xa), jc, jdec.DecodeOptions(**kw),
                             prompt_tokens=prompt)
    got = tdec.greedy_decode(tp, _t(xa), tc, tdec.DecodeOptions(**kw),
                             prompt_tokens=prompt)
    assert got["sample_begin"] == ref["sample_begin"]
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    np.testing.assert_allclose(got["avg_logprob"].numpy(),
                               np.asarray(ref["avg_logprob"]), atol=2e-3)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(),
                               np.asarray(ref["no_speech_prob"]), atol=1e-5)
    p = got["sample_begin"]
    assert rows == [p] * tc.n_text_layer + [1] * (tc.n_text_layer * got["steps"])


def test_beam_search_under_w8a8_takes_the_int8_route(monkeypatch, narrow):
    """Beam search under quant_kv_w8a8 quantizes its cross-K/V to plain
    int8 ("qw"), as the reference's beam_decode does (it reads only
    quant_kv_bits): K3's wrapper at 5 rows per item in every step, K14's
    never; tokens equal the reference's."""
    jc, tc, jp, tp, xa = narrow
    calls = {"q8": [], "w8a8": []}
    for key, name in (("q8", "decode_cross_attention_q8"),
                      ("w8a8", "decode_cross_attention_w8a8")):
        real = getattr(tmod, name)
        monkeypatch.setattr(tmod, name, lambda qq, *a, _r=real, _k=key, **kw:
                            calls[_k].append(qq.shape[2]) or _r(qq, *a, **kw))
    kw = dict(language="en", max_tokens=8, quant_kv=True, quant_kv_w8a8=True,
              quant_cache=True)
    ref = jbeam.beam_decode(jp, jnp.asarray(xa), jc, jdec.DecodeOptions(**kw),
                            beam_size=5)
    got = tbeam.beam_decode(tp, _t(xa), tc, tdec.DecodeOptions(**kw), beam_size=5)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    assert calls["w8a8"] == []
    assert calls["q8"] == [5] * (tc.n_text_layer * got["steps"])


def test_engine_w8a8_matches_jax_engine(goldens):
    """WhisperEngine(quantize_decoder="w8a8") against the JAX engine's on
    the trained tiny checkpoint (Dh 8: K14's plain version takes any Dh):
    parallel windows and the app's transcribe_samples (sequential seeks,
    the ladder) give the same text, tokens and segments; word timestamps
    are refused, as under every quantized decoder."""
    cases = goldens["cases"][:3]
    audio = [tcc.utterance(c["word_ids"])[0] for c in cases]
    port = WhisperEngine(device="cpu", quantize_decoder="w8a8")
    port.load_model(NPZ)
    ref = JaxEngine(quantize_decoder="w8a8")
    ref.load_model(NPZ)
    base = dict(language="en", condition_on_previous_text=False, temperatures=(0.0,))

    def as_dicts(results):
        return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                     segments=[(s.start, s.end, s.text) for s in r.segments])
                for r in results]

    got = port.transcribe_batch(audio, TranscribeParams(parallel_windows=True, **base))
    want = ref.transcribe_batch(audio, JParams(parallel_windows=True, **base))
    assert as_dicts(got) == as_dicts(want)
    assert all(r.tokens for r in got)
    got = port.transcribe_samples(audio[0], TranscribeParams())
    want = ref.transcribe_samples(audio[0], JParams())
    assert as_dicts([got]) == as_dicts([want])
    with pytest.raises(ValueError, match="word_timestamps"):
        port.transcribe_samples(audio[0], TranscribeParams(word_timestamps=True))
