"""Beam search and word timestamps in spittle_tpu_torch against the JAX
reference on the CPU: the beam fold in the cross-attention, beam_decode
over float, int8 and int4 cross-K/V (with the int8 self-cache) on a narrow
numpy-seeded model, the order of tied candidates, the alignment pass and
its numpy half, and the engine's paths on the trained tiny checkpoint (the
beam_tokens and word_timestamps goldens, parallel windows with overlap,
the ladder's rungs under beam_size). Inputs are numpy-seeded; each
tolerance says why.
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
from spittle_tpu.models.whisper import alignment as jalign
from spittle_tpu.models.whisper import beam as jbeam
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.ops import quant as jquant
from spittle_tpu_torch.engine import whisper_engine as tengine
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import alignment as talign
from spittle_tpu_torch.models.whisper import beam as tbeam
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from test_torch_app_path import NARROW, _numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

BEAM = 5
MAX_TOKENS = 10  # decode budget of the narrow model's beam decodes
# The narrow model (Dh 64, 2 decoder layers) with one encoder layer: the
# encoder is not run here.
BEAM_CFG = dict(NARROW, n_audio_layer=1)


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
def goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def engines():
    port = WhisperEngine(device="cpu")
    port.load_model(NPZ)
    ref = JaxEngine()
    ref.load_model(NPZ)
    return port, ref


@pytest.fixture(scope="module")
def narrow():
    """The reference's tree for the narrow model, numpy-drawn, with the
    final layer norm's bias moved along a direction u and the EOT row of
    the token embedding moved along u too, so that some beams end before
    the budget and the loop meets finished beams."""
    jc, tc = jcfg.WhisperConfig(**BEAM_CFG), tcfg.WhisperConfig(**BEAM_CFG)
    tree = _numpy_tree(jc)
    u = np.random.default_rng(9).standard_normal(jc.n_text_state).astype(np.float32)
    u /= np.linalg.norm(u)
    tree["decoder"]["ln_b"] = tree["decoder"]["ln_b"] + u
    tree["decoder"]["tok_emb"][jc.eot] += 0.25 * u
    return jc, tc, tree


# ---------------------------------------------------------------------------
# Ties, the fold, beam_decode
# ---------------------------------------------------------------------------


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal scores: the lower index first, as jax.lax.top_k orders them,
    including whole rows of NEG_INF (the dead beams' candidates)."""
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    x[1] = tdec.NEG_INF
    x[2, ::3] = 7.0
    x[3] = np.float32(-1e30) + rng.standard_normal(40).astype(np.float32)  # absorbed: ties
    for k in (1, 5, 25):
        vals, idx = tbeam.top_k(_t(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        assert np.array_equal(vals.numpy(), np.asarray(jvals))


def _quant_kv(kind, rng, shape):
    kv = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    if kind == "int8":
        return jquant.quantize_kv(kv)
    if kind == "int4":
        return jquant.quantize_kv_int4(kv)
    return kv


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("beams,q", [(1, 1), (5, 1), (2, 3), (5, 3)])
def test_cross_attention_folds_beams(monkeypatch, kind, beams, q):
    """Bq = B * beams query items over B items' K/V: each beam's rows equal
    the unfolded computation of that beam alone, and the reference's
    folded _cross_attention; the kernel route sees the folded rows
    (beams * q <= 8: K3, K4 or K6's wrapper at beams * q rows; more: the
    plain math), and beams = 1 leaves the rows as they were."""
    name = {"float": "decode_cross_attention", "int8": "decode_cross_attention_q8",
            "int4": "decode_cross_attention_q4"}[kind]
    rows = []
    real = getattr(tmod, name)
    monkeypatch.setattr(tmod, name,
                        lambda qq, *a, **kw: rows.append(qq.shape[2]) or real(qq, *a, **kw))
    rng = np.random.default_rng(11)
    b, h, dh, tk, kv_len = 2, 3, 64, 96, 90
    cq = rng.standard_normal((b * beams, h, q, dh)).astype(np.float32)
    ck, cv = (_quant_kv(kind, rng, (b, h, dh, tk)) for _ in range(2))
    tk_, tv_ = params_from_jax(ck), params_from_jax(cv)
    got = tmod._cross_attention(_t(cq), tk_, tv_, dh, kv_len=kv_len).numpy()
    kernel = beams * q <= 8
    assert rows == ([beams * q] if kernel else [])
    # Each beam alone takes the kernel route at q rows; where the folded
    # rows leave it (int8/int4 at 15 rows: plain math without the bf16
    # rounding), only the reference below holds them.
    for j in range(beams if kernel or kind == "float" else 0):
        alone = tmod._cross_attention(_t(cq[j::beams]), tk_, tv_, dh, kv_len=kv_len)
        # Rows are independent; only the products' blocking may differ.
        np.testing.assert_allclose(got[j::beams], alone.numpy(), rtol=1e-6, atol=1e-6)
    ref = np.asarray(jmod._cross_attention(jnp.asarray(cq), ck, cv, dh, kv_len=kv_len))
    # The quantized kernel route rounds p * vs to bf16 before PV, the
    # reference's f32 XLA path does not (2**-9 relative per weight); the
    # float route and the plain int8 math are f32 throughout.
    atol = 2.0 ** -8 * np.abs(ref).max() if kernel and kind != "float" else 1e-5
    np.testing.assert_allclose(got, ref, atol=atol)


CASES = {  # (batch, prompt, per-item language tokens)
    "b1-prompt": (1, (400, 500), None),
    "b3-languages": (3, (), (0, 2, 5)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_beam_decode_matches_reference(narrow, monkeypatch, kind, case):
    """beam_decode against the reference's on the same weights and encoder
    output: tokens identical; avg_logprob and no_speech_prob within the
    stated tolerances. int8 and int4 run the weight-only int8 decoder, the
    quantized cross-K/V and the int8 self-cache. The steps: K4, K3 or K6's
    wrapper once per decoder layer and step at 5 rows per item, the
    prefill's 5 x P rows on the plain math."""
    jc, tc, tree = narrow
    b, prompt, langs = CASES[case]
    kw = dict(language="en", max_tokens=MAX_TOKENS)
    jp = jax.tree.map(jnp.asarray, tree)
    if kind != "float":
        kw.update(quant_kv=True, quant_kv_bits=8 if kind == "int8" else 4,
                  quant_cache=True)
        jp = jquant.quantize_whisper_decoder(jp)
    xa = np.random.default_rng(3).standard_normal(
        (b, jc.n_audio_ctx, jc.n_audio_state)).astype(np.float32)
    lt = None if langs is None else np.asarray(langs) + jc.lang_begin
    ref = jbeam.beam_decode(jp, jnp.asarray(xa), jc, jdec.DecodeOptions(**kw),
                            beam_size=BEAM, prompt_tokens=prompt,
                            lang_tokens=None if lt is None else jnp.asarray(lt, jnp.int32))
    name = {"float": "decode_cross_attention", "int8": "decode_cross_attention_q8",
            "int4": "decode_cross_attention_q4"}[kind]
    rows = []
    real = getattr(tmod, name)
    monkeypatch.setattr(tmod, name,
                        lambda qq, *a, **k: rows.append(qq.shape[2]) or real(qq, *a, **k))
    got = tbeam.beam_decode(params_from_jax(jp), _t(xa), tc, tdec.DecodeOptions(**kw),
                            beam_size=BEAM, prompt_tokens=prompt,
                            lang_tokens=None if lt is None else _t(lt))
    assert got["sample_begin"] == ref["sample_begin"]
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    # float: f32 on both sides, summation order only. int8/int4: the
    # kernel route's bf16 rounding of p * vs moves each step's log-prob by
    # up to ~5e-4 (PERF.md and ROADMAP queue 3, "Kernel route rounding").
    tol = 1e-5 if kind == "float" else 2e-3
    np.testing.assert_allclose(got["avg_logprob"].numpy(), np.asarray(ref["avg_logprob"]),
                               atol=tol)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(),
                               np.asarray(ref["no_speech_prob"]), atol=1e-6)
    assert rows == [BEAM] * (tc.n_text_layer * got["steps"])
    gen = got["tokens"][:, got["sample_begin"]:].numpy()
    if case == "b1-prompt":  # every beam ended: the loop stopped early
        assert got["steps"] < MAX_TOKENS - 1 and gen[0, -1] == tc.eot
    else:  # some items ended early, one ran the budget
        assert got["steps"] == MAX_TOKENS - 1
        assert (gen[:, -1] == tc.eot).sum() == 2


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------


def test_decoder_cross_attention_matches_reference(narrow):
    """The teacher-forced pass's probabilities [L, B, H, T, Tk], f32 on both
    sides: within 1e-6 of probabilities that sum to 1 (summation order)."""
    jc, tc, tree = narrow
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jc.eot, (2, 20))
    tokens[:, 0] = jc.sot
    xa = rng.standard_normal((2, jc.n_audio_ctx, jc.n_audio_state)).astype(np.float32)
    got = talign.decoder_cross_attention(params_from_jax(tree), _t(tokens), _t(xa), tc)
    ref = jalign.decoder_cross_attention(jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(tokens, jnp.int32),
                                         jnp.asarray(xa), jc)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_token_emission_times_and_dtw_equal_reference(narrow):
    """The numpy half on the same inputs: equal arrays. The DTW costs are
    small integers, so equal-cost moves meet OpenAI's tie-breaking."""
    jc, tc, _ = narrow
    rng = np.random.default_rng(8)
    cost = rng.integers(0, 3, (9, 14)).astype(np.float64)
    for a, b in zip(talign.dtw_path(cost), jalign.dtw_path(cost)):
        assert np.array_equal(a, b)
    attn = rng.random((jc.n_text_layer, 1, jc.n_text_head, 12, jc.n_audio_ctx))
    attn = (attn / attn.sum(-1, keepdims=True)).astype(np.float32)
    for heads in (None, [(0, 1), (1, 0)]):
        got = talign.token_emission_times(attn, 3, 50, tc, heads=heads)
        ref = jalign.token_emission_times(attn, 3, 50, jc, heads=heads)
        assert np.array_equal(got, ref)
    assert talign.alignment_heads(tc) == jalign.alignment_heads(jc)
    x = rng.standard_normal((2, 3, 10))
    assert np.array_equal(talign._median_filter(x), jalign._median_filter(x))


# ---------------------------------------------------------------------------
# The engine on the trained tiny checkpoint
# ---------------------------------------------------------------------------


def _words(res):
    return [{"word": w.word, "start": round(w.start, 4), "end": round(w.end, 4)}
            for w in res.words]


def _as_dicts(results):
    return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                 segments=[(s.start, s.end, s.text) for s in r.segments],
                 words=[(w.word, w.start, w.end) for w in r.words])
            for r in results]


def test_beam_goldens_through_transcribe_samples(engines, goldens):
    """beam_size=5 reproduces the beam_tokens goldens and the expected
    text, as tests/test_trained_checkpoint.py holds the reference; the
    decode records 5 x 3 prefix rows."""
    port, _ = engines
    p = TranscribeParams(language="en", condition_on_previous_text=False,
                         temperatures=(0.0,), beam_size=BEAM)
    port.last_prefix_rows.clear()
    for case in goldens["cases"][:3]:
        res = port.transcribe_samples(tcc.utterance(case["word_ids"])[0], p)
        assert res.tokens == case["beam_tokens"], case["word_ids"]
        assert res.text.strip() == case["expected_text"].strip()
    assert port.last_prefix_rows == [BEAM * 3] * 3


def test_word_timestamps_golden_through_transcribe_samples(engines, goldens):
    """word_timestamps=True reproduces case 0's word_timestamps golden
    exactly, and the words are the expected names in order."""
    port, _ = engines
    case = goldens["cases"][0]
    p = TranscribeParams(language="en", condition_on_previous_text=False,
                         temperatures=(0.0,), word_timestamps=True)
    port.stage_seconds.clear()
    res = port.transcribe_samples(tcc.utterance(case["word_ids"])[0], p)
    assert _words(res) == case["word_timestamps"]
    assert [w["word"] for w in _words(res)] == case["expected_text"].split()
    assert port.stage_seconds["align"] > 0


@pytest.mark.parametrize("beam_size", [1, BEAM])
def test_parallel_windows_with_words_match_jax_engine(engines, goldens, beam_size):
    """Parallel windows with a 2 s overlap and word timestamps (greedy or
    beam): tokens, text, segments and words equal to the JAX engine's; the
    words are shifted by each window's offset and stitched by core region
    like the segments."""
    port, ref = engines
    cases = goldens["cases"]
    audio = [np.concatenate([tcc.utterance(cases[0]["word_ids"])[0],
                             tcc.utterance(cases[1]["word_ids"])[0][: 16000 * 12]])]
    kw = dict(language="en", condition_on_previous_text=False, temperatures=(0.0,),
              parallel_windows=True, parallel_overlap_s=2.0, word_timestamps=True,
              beam_size=beam_size)
    got = port.transcribe_batch(audio, TranscribeParams(**kw))
    assert _as_dicts(got) == _as_dicts(ref.transcribe_batch(audio, JParams(**kw)))
    starts = [w.start for w in got[0].words]
    assert len(starts) > 6 and starts == sorted(starts) and starts[-1] > 30.0


def test_beam_only_at_temperature_zero(engines, goldens, monkeypatch):
    """Under beam_size the ladder's rung at 0 is a beam search and the
    sampled rungs stay greedy sampling, as in the reference; a gate that
    every decode fails takes both rungs."""
    port, _ = engines
    calls = []
    for name in ("beam_decode", "greedy_decode"):
        real = getattr(tengine, name)
        monkeypatch.setattr(tengine, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append((_n, a[3].temperature)) or _r(*a, **kw)))
    monkeypatch.setattr(port, "LOGPROB_THRESHOLD", 0.0)  # avg_logprob < 0 fails
    port.last_prefix_rows.clear()
    case = goldens["cases"][0]
    port.transcribe_samples(tcc.utterance(case["word_ids"])[0], TranscribeParams(
        language="en", condition_on_previous_text=False, temperatures=(0.0, 0.4),
        beam_size=BEAM, max_tokens=8))
    assert calls == [("beam_decode", 0.0), ("greedy_decode", 0.4)]
    assert port.last_prefix_rows == [BEAM * 3, 3]


def test_word_timestamps_under_a_quantized_decoder():
    """The reference's alignment pass multiplies by the decoder's weights
    as plain arrays, so under quantize_decoder it raises TypeError; the
    port refuses the call with ValueError before decoding anything."""
    audio = tcc.utterance([4, 2, 3, 0])[0]
    kw = dict(language="en", condition_on_previous_text=False, temperatures=(0.0,),
              word_timestamps=True)
    ref = JaxEngine(quantize_decoder=True)
    ref.load_model(NPZ)
    with pytest.raises(TypeError, match="dict"):
        ref.transcribe_samples(audio, JParams(**kw))
    port = WhisperEngine(device="cpu", quantize_decoder="int8")
    port.load_model(NPZ)
    with pytest.raises(ValueError, match="word_timestamps"):
        port.transcribe_samples(audio, TranscribeParams(**kw))
    assert port.last_decode_steps == []
    res = port.transcribe_samples(audio, TranscribeParams(**dict(kw, word_timestamps=False)))
    assert res.text and res.words == []
