"""The app's own path through spittle_tpu_torch against the JAX reference
on the CPU: temperature sampling in the decode loop, language detection,
the temperature ladder's decisions, and WhisperEngine.transcribe_samples
with the sequential seek loop and prompt carry (the call the dictation
app makes, TranscribeParams() with its defaults), plus the parallel
windows under language detection and a two-rung ladder.

torch's generator cannot reproduce JAX's random stream, so wherever a
sampled rung must match the reference token for token, the port is
handed JAX's own Gumbel noise through greedy_decode's `noise` seam (the
jax_noise fixture); the generator path is held by its distribution.
Inputs are numpy-seeded; each tolerance says why.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.tokenizer import make_test_vocab
from spittle_tpu.models.whisper.weights import save_npz_checkpoint
from spittle_tpu.ops.quant import quantize_whisper_decoder as jquant_dec
from spittle_tpu_torch.engine import whisper_engine as tengine
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops.quant import quantize_whisper_decoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

SR = 16000

# A narrow Whisper with the real multilingual token layout: Dh = 64, 2+2
# layers, a 64-position audio context and a 64-position text context.
NARROW = dict(name="test-app-narrow", n_mels=80, n_audio_ctx=64,
              n_audio_state=128, n_audio_head=2, n_audio_layer=2,
              n_vocab=51865, n_text_ctx=64, n_text_state=128, n_text_head=2,
              n_text_layer=2)
MAX_TOKENS = 12  # decode budget of the narrow model's sampled decodes


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _numpy_tree(cfg, seed=0):
    """The reference's parameter tree, every leaf drawn from numpy:
    weights ~ N(0, 1/fan_in), biases and pos_emb ~ 0.1 N, norms ~ 1 +
    0.1 N."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape,
                          jmod.init_params(cfg, jax.random.PRNGKey(0)))

    def fill(path, shape):
        key = path[-1].key
        if key.endswith("ln_g"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif key.endswith(("_b", "ln_b", "bq", "bv", "bo")) or key == "pos_emb":
            a = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            if key.startswith("conv"):
                fan_in = shape[1] * shape[2]
            a = rng.standard_normal(shape) * fan_in ** -0.5
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, shapes, is_leaf=lambda s: isinstance(s, tuple))


def jax_gumbel(seed, shape):
    """The reference loop's noise, position by position: key, sub =
    split(key) from PRNGKey(seed), then gumbel(sub, shape), as
    jax.random.categorical draws it. Checks that the port asks for the
    positions in loop order."""
    state = {"key": jax.random.PRNGKey(seed), "next": 0}

    def noise(step):
        assert step == state["next"], (step, state["next"])
        state["next"] += 1
        state["key"], sub = jax.random.split(state["key"])
        return _t(jax.random.gumbel(sub, shape))

    return noise


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's engine with every sampled rung fed the reference's
    noise. Returns the temperatures of the sampled decodes it saw."""
    real = tengine.greedy_decode
    sampled = []

    def with_jax_noise(params, xa, cfg, opts, **kw):
        if opts.temperature > 0:
            sampled.append(opts.temperature)
            kw["noise"] = jax_gumbel(opts.seed, (xa.shape[0], cfg.n_vocab))
        return real(params, xa, cfg, opts, **kw)

    monkeypatch.setattr(tengine, "greedy_decode", with_jax_noise)
    return sampled


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run eager decode loops of many small ops; beside the
    suite's other workers, intra-op threads only oversubscribe the cores.
    One thread for this module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow():
    jc, tc = jcfg.WhisperConfig(**NARROW), tcfg.WhisperConfig(**NARROW)
    tree = _numpy_tree(jc)
    rng = np.random.default_rng(4)
    xa = rng.standard_normal((2, jc.n_audio_ctx, jc.n_audio_state)).astype(
        np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, tree), params_from_jax(tree), xa


# ---------------------------------------------------------------------------
# Sampling and language detection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("temperature", [0.4, 1.0])
def test_sampled_decode_matches_reference_with_its_noise(narrow, temperature, seed):
    """Given JAX's per-step Gumbel noise, the port's sampled decode is
    token-identical to the reference's categorical draws; avg_logprob
    (from the unscaled logits) to 1e-5 and no_speech_prob to 1e-6: f32
    logits agree to ~1e-6 (vocab-wide dots of O(1) hidden states)."""
    jc, tc, jp, tp, xa = narrow
    jopts = jdec.DecodeOptions(temperature=temperature, seed=seed,
                               max_tokens=MAX_TOKENS)
    topts = tdec.DecodeOptions(temperature=temperature, seed=seed,
                               max_tokens=MAX_TOKENS)
    ref = jdec.greedy_decode(jp, jnp.asarray(xa), jc, jopts)
    got = tdec.greedy_decode(tp, _t(xa), tc, topts,
                             noise=jax_gumbel(seed, (xa.shape[0], tc.n_vocab)))
    greedy = tdec.greedy_decode(tp, _t(xa), tc,
                                tdec.DecodeOptions(max_tokens=MAX_TOKENS))
    assert got["sample_begin"] == ref["sample_begin"]
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    np.testing.assert_allclose(got["avg_logprob"].numpy(),
                               np.asarray(ref["avg_logprob"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(),
                               np.asarray(ref["no_speech_prob"]), rtol=0,
                               atol=1e-6)
    # The noise moved the draws off the argmax path.
    assert not torch.equal(got["tokens"], greedy["tokens"])


@pytest.mark.parametrize("temperature", [0.4, 1.0])
def test_generator_noise_samples_softmax_over_temperature(temperature):
    """The generator path's draws, argmax(noise + logits / T), follow
    softmax(logits / T): a chi-squared test over 20k draws (bins with
    fewer than 5 expected draws merged) at p > 1e-3."""
    rng = np.random.default_rng(11)
    v, draws = 24, 20000
    logits = torch.from_numpy(rng.standard_normal(v).astype(np.float32) * 2)
    noise = tdec.gumbel_noise((draws, v), seed=5, device=torch.device("cpu"))
    picks = torch.argmax(noise(0) + logits / temperature, dim=-1).numpy()
    counts = np.bincount(picks, minlength=v).astype(np.float64)
    expected = torch.softmax(logits.double() / temperature, 0).numpy() * draws
    rare = expected < 5.0
    obs, exp = counts[~rare], expected[~rare]
    if rare.any():
        obs = np.append(obs, counts[rare].sum())
        exp = np.append(exp, expected[rare].sum())
    assert stats.chisquare(obs, exp).pvalue > 1e-3, (obs, exp)


def test_sampled_decode_is_seeded(narrow):
    """The default generator: the same seed gives the same tokens on every
    call (the reference makes PRNGKey(seed) afresh per call), another seed
    other tokens."""
    _, tc, _, tp, xa = narrow
    xa = _t(xa[:1])
    runs = [tdec.greedy_decode(tp, xa, tc, tdec.DecodeOptions(
        temperature=1.0, seed=s, max_tokens=MAX_TOKENS))["tokens"]
        for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("quantized", [False, True])
def test_detect_language_matches_reference(narrow, quantized):
    """Language probabilities from one [sot] step over unquantized
    cross-K/V and cache, under a bf16/f32 or a weight-only int8 decoder:
    to 1e-5 in f32 (logits agree to ~1e-6; probabilities are below 1)."""
    jc, tc, jp, tp, xa = narrow
    if quantized:
        jp, tp = jquant_dec(jp), quantize_whisper_decoder(tp)
    ref = np.asarray(jdec.detect_language(jp, jnp.asarray(xa), jc))
    got = tdec.detect_language(tp, _t(xa), tc)
    assert got.dtype == torch.float32 and got.shape == (2, tc.n_langs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), ref.argmax(-1))


# ---------------------------------------------------------------------------
# The ladder's decisions on forced rung outputs
# ---------------------------------------------------------------------------


def _forced_rungs():
    """(temperature, item) -> (text, avg_logprob, no_speech_prob) of a
    forced rung. Item 0 passes at rung 0; item 1 fails rung 0 on
    avg_logprob and passes rung 1; item 2 fails rungs 0 and 1 on its
    compression ratio and passes rung 2; item 3 fails every rung."""
    rep = " the" * 60  # compresses far past 2.4
    table = {}
    for ri, temp in enumerate(WhisperEngine.FALLBACK_TEMPERATURES):
        table[temp, 0] = (" hello world", -0.2, 0.01)
        table[temp, 1] = (" this test", -2.0 if ri == 0 else -0.5, 0.02)
        table[temp, 2] = (rep if ri < 2 else " the test", -0.3, 0.03)
        table[temp, 3] = (f" the{' hello' * ri}" if ri % 2 else rep,
                          -1.5 - ri, 0.5 + 0.05 * ri)
    return table


def _stub_decode_once(eng, table, calls, as_array):
    """A _decode_once that reads the items from xa[:, 0, 0] and returns
    the forced rung: tokens [sot, lang, task, text..., eot...]."""
    cfg, tok = eng.cfg, eng.tokenizer
    width = 80

    def decode_once(xa, opts, params, lt, prompt_tokens, **_):
        items = [int(i) for i in np.asarray(xa)[:, 0, 0]]
        calls.append((opts.temperature, items))
        rows, lps, nss = [], [], []
        for i in items:
            text, lp, ns = table[opts.temperature, i]
            ids = [cfg.sot, cfg.lang_begin, cfg.transcribe] + tok.encode(text)
            rows.append(ids + [cfg.eot] * (width - len(ids)))
            lps.append(lp)
            nss.append(ns)
        return {"tokens": as_array(np.asarray(rows, np.int64)),
                "avg_logprob": as_array(np.asarray(lps, np.float32)),
                "no_speech_prob": as_array(np.asarray(nss, np.float32)),
                "sample_begin": 3}

    return decode_once


def test_ladder_decisions_match_reference(monkeypatch):
    """The same forced rungs through both engines' _finish_decode: the
    same decodes (items and temperatures), and the same accepted rows,
    exactly; item 3 keeps the last rung's result, not its best."""
    port = WhisperEngine(device="cpu")
    port.load_model(NPZ)
    ref = JaxEngine()
    ref.load_model(NPZ)
    table = _forced_rungs()
    results = {}
    for name, eng, as_array, xa_of in (
            ("port", port, torch.from_numpy, torch.from_numpy),
            ("ref", ref, np.asarray, np.asarray)):
        calls = []
        monkeypatch.setattr(eng, "_decode_once",
                            _stub_decode_once(eng, table, calls, as_array))
        xa = xa_of(np.arange(4, dtype=np.float32)[:, None, None]
                   * np.ones((4, 2, 3), np.float32))
        p = (TranscribeParams if name == "port" else JParams)()
        opts = eng._decode_options(p)
        out = eng._decode_with_fallback(xa, opts, p, None, ())
        results[name] = (calls, {k: np.asarray(out[k]) for k in
                                 ("tokens", "avg_logprob", "no_speech_prob")})
    (pcalls, pout), (rcalls, rout) = results["port"], results["ref"]
    assert pcalls == rcalls
    temps = WhisperEngine.FALLBACK_TEMPERATURES
    assert pcalls == ([(temps[0], [0, 1, 2, 3]), (temps[1], [1, 2, 3]),
                       (temps[2], [2, 3])] + [(t, [3]) for t in temps[3:]])
    for k in pout:
        np.testing.assert_array_equal(pout[k], rout[k])
    assert pout["avg_logprob"][3] == np.float32(-1.5 - 5)
    assert port.last_decode_rungs == [6]


# ---------------------------------------------------------------------------
# The engine: transcribe_samples with default params
# ---------------------------------------------------------------------------


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


def _as_dicts(results):
    return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                 segments=[(s.start, s.end, s.text) for s in r.segments])
            for r in results]


@pytest.mark.parametrize("case", range(8))
def test_transcribe_samples_defaults_on_goldens(engines, goldens, jax_noise, case):
    """The app's call, TranscribeParams() (sequential, prompt carry,
    language detection, the six-rung ladder): the golden tokens and
    detected language, and the JAX engine's tokens, text, segments and
    language, exactly."""
    port, ref = engines
    c = goldens["cases"][case]
    audio = tcc.utterance(c["word_ids"])[0]
    got = port.transcribe_samples(audio, TranscribeParams())
    want = ref.transcribe_samples(audio, JParams())
    assert got.tokens == c["greedy_tokens"]
    assert got.language == goldens["language_detected"]
    assert _as_dicts([got]) == _as_dicts([want])


def _sixty_five_seconds(goldens):
    """The eight trained utterances' speech (each cut 0.4 s after its last
    tone) back to back, repeated to 65 s: three or more sequential
    windows, each holding several utterances, which the trained model
    (one utterance per window in training) decodes with less confidence:
    later windows go down the ladder."""
    parts = []
    for c in goldens["cases"]:
        audio, _, end = tcc.utterance(c["word_ids"])
        parts.append(audio[: int((end + 0.4) * SR)])
    return np.concatenate(parts * 3)[: 65 * SR]


@pytest.mark.parametrize("seconds,params", [
    (65, dict()),
    (65, dict(initial_prompt="hello this test")),
    (20, dict(audio_ctx=750)),
    (65, dict(condition_on_previous_text=False)),
], ids=["defaults", "initial_prompt", "audio_ctx", "no_carry"])
def test_sequential_windows_match_reference(engines, goldens, jax_noise,
                                            seconds, params):
    """The 65 s item through both engines: the sequential windows, the
    prompt carry (with and without an initial prompt; the confused
    windows go down the ladder), and the windows with no carry; its first
    20 s under audio_ctx (15 s windows and a 5 s tail; the seek clamp
    binds only on a last window, where no later window can show it).
    Tokens, text, segments and language equal the JAX engine's, sampled
    rungs included."""
    port, ref = engines
    audio = _sixty_five_seconds(goldens)[: seconds * SR]
    port.last_prefix_rows.clear()
    port.last_decode_rungs.clear()
    got = port.transcribe_samples(audio, TranscribeParams(**params))
    want = ref.transcribe_samples(audio, JParams(**params))
    assert _as_dicts([got]) == _as_dicts([want])
    assert got.text and got.language == "en"
    assert len(port.last_decode_rungs) >= 2  # windows
    carry = params.get("condition_on_previous_text", True)
    # A carried prompt lengthens the prefix past the bare SOT sequence.
    assert (max(port.last_prefix_rows[1:]) > 3) == carry
    if seconds == 65 and carry:
        assert max(port.last_decode_rungs) > 1 and jax_noise


def test_parallel_windows_detect_and_two_rungs(engines, goldens, jax_noise):
    """Parallel windows with language=None and the ladder (0.0, 0.6):
    detection on each item's first window; on the trained utterances the
    golden tokens; under a prompt that confuses the model, rung 1 for only
    the windows that failed rung 0. Equal to the JAX engine."""
    port, ref = engines
    cases = goldens["cases"]
    audio = [tcc.utterance(c["word_ids"])[0] for c in cases[:2]]
    audio.append(_sixty_five_seconds(goldens)[: 35 * SR])
    kw = dict(language=None, parallel_windows=True,
              condition_on_previous_text=False, temperatures=(0.0, 0.6))
    got = port.transcribe_batch(audio, TranscribeParams(**kw))
    assert _as_dicts(got) == _as_dicts(ref.transcribe_batch(audio, JParams(**kw)))
    for r, c in zip(got[:2], cases):
        assert r.tokens == c["greedy_tokens"]
    assert all(r.language == "en" for r in got)
    port.last_decode_steps.clear()
    kw["initial_prompt"] = "hello world hello world hello world"
    got = port.transcribe_batch(audio, TranscribeParams(**kw))
    assert _as_dicts(got) == _as_dicts(ref.transcribe_batch(audio, JParams(**kw)))
    assert jax_noise == [0.6] and len(port.last_decode_steps) == 2


# ---------------------------------------------------------------------------
# The prompt carry's buckets, on a text context that reaches them
# ---------------------------------------------------------------------------


BUCKETS = dict(name="test-app-buckets", n_mels=80, n_audio_ctx=100,
               n_audio_state=64, n_audio_head=1, n_audio_layer=1,
               n_vocab=51865, n_text_ctx=160, n_text_state=64, n_text_head=1,
               n_text_layer=1)


@pytest.fixture(scope="module")
def bucket_npz(tmp_path_factory):
    """A numpy-seeded model whose text context (160) lets the carried
    prompt reach the 32- and 64-token buckets (n_text_ctx // 2 - 1 = 79),
    with 2 s windows (100 positions), saved as an .npz both engines
    load."""
    cfg = jcfg.WhisperConfig(**BUCKETS)
    path = str(tmp_path_factory.mktemp("buckets") / "params.npz")
    save_npz_checkpoint(path, cfg, _numpy_tree(cfg, seed=2), make_test_vocab())
    return path


@pytest.mark.parametrize("words,bucket", [(20, 32), (35, 64)])
def test_prompt_carry_buckets_match_reference(bucket_npz, words, bucket):
    """An initial prompt of 40 or 70 tokens, carried with each window's
    text: from the second window on the prompt is cut to the last 32 or
    64 tokens (the largest bucket that fits), as the reference cuts it.
    Tokens, text and segments over 5 s of noise (three or more windows,
    8-token budget, greedy) equal the JAX engine's."""
    audio = (0.1 * np.random.default_rng(9).standard_normal(5 * SR)).astype(
        np.float32)
    port = WhisperEngine(device="cpu")
    port.load_model(bucket_npz)
    ref = JaxEngine()
    ref.load_model(bucket_npz)
    p = dict(language="en", temperatures=(0.0,), max_tokens=8,
             initial_prompt=" ".join(["hello world"] * words))
    got = port.transcribe_samples(audio, TranscribeParams(**p))
    want = ref.transcribe_samples(audio, JParams(**p))
    assert _as_dicts([got]) == _as_dicts([want])
    # [sot_prev, *prompt, sot, lang, task]: window 0 takes the whole
    # initial prompt, the later windows a bucket.
    prompts = [rows - 4 for rows in port.last_prefix_rows]
    assert prompts[0] == 2 * words and len(prompts) >= 3
    assert set(prompts[1:]) == {bucket}, prompts


def test_encoder_stem_rows_are_row_major_at_batch_one(narrow):
    """The app encodes one window at a time. The stem's [B, T, D] must be
    row-major: at B = 1 a row view of the conv output's transposed
    strides is not contiguous, and K2's row quantizer on the card refuses
    it (found by the app path's first run on the card)."""
    _, tc, _, tp, _ = narrow
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, tc.n_mels, 2 * tc.n_audio_ctx)).astype(np.float32))
    x = tmod._encoder_stem(tp["encoder"], mel, tc)
    assert x.shape == (1, tc.n_audio_ctx, tc.n_audio_state)
    assert x.is_contiguous() and x.reshape(-1, x.shape[-1]).is_contiguous()


def test_suppress_non_speech_matches_reference(goldens):
    """suppress_non_speech: the same suppressed ids as the reference
    engine's decode options, and the same transcript under them."""
    port = WhisperEngine(device="cpu", suppress_non_speech=True)
    port.load_model(NPZ)
    ref = JaxEngine(suppress_non_speech=True)
    ref.load_model(NPZ)
    got_ids = port._decode_options(TranscribeParams()).suppress_tokens
    assert got_ids and got_ids == ref._decode_options(JParams()).suppress_tokens
    audio = tcc.utterance(goldens["cases"][2]["word_ids"])[0]
    got = port.transcribe_samples(audio, TranscribeParams())
    want = ref.transcribe_samples(audio, JParams())
    assert _as_dicts([got]) == _as_dicts([want])


def test_unload_model():
    """unload_model drops the weights, the tokenizer and the position
    table; the engine then refuses to transcribe until a model is loaded
    again."""
    eng = WhisperEngine(device="cpu")
    eng.load_model(NPZ)
    assert eng.is_loaded and eng._positions is not None
    eng.unload_model()
    assert not eng.is_loaded
    assert eng.cfg is None and eng.tokenizer is None and eng._positions is None
    with pytest.raises(RuntimeError, match="no model loaded"):
        eng.transcribe_samples(np.zeros(SR, np.float32))
    eng.load_model(NPZ)
    assert eng.transcribe_samples(np.zeros(SR, np.float32)).language == "en"
