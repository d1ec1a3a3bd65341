"""Audio contexts other than 1500 in spittle_tpu_torch against the JAX
reference on the CPU: the tiled flash kernel K5's plain version against
the Pallas kernel in interpret mode, the dispatch past 4096 key positions,
the encoder of a long-window model, the engine under a reduced
TranscribeParams.audio_ctx (window plan, window array, tokens, text and
segments), and pad_or_trim.

The Pallas K5 has no `interpret` argument, so it runs under
pltpu.force_tpu_interpret_mode(); to make the JAX dispatcher reach it on
the CPU a test patches spittle_tpu.ops.attention._on_tpu to True and
clears JAX's caches around the call. Inputs are numpy-seeded; each
tolerance says why.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spittle_tpu.audio import mel as jmel
from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.ops import attention as jatt
from spittle_tpu_torch.audio import mel as tmel
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import attention as tatt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "tests", "data", "trained_tiny", "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@contextlib.contextmanager
def reference_on_tpu_path(monkeypatch):
    """The JAX dispatcher taking its TPU branch on the CPU, its Pallas
    kernels in interpret mode."""
    monkeypatch.setattr(jatt, "_on_tpu", lambda: True)
    jax.clear_caches()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        jax.clear_caches()


def _qkv(tq, tk, b=1, h=2, d=64, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, t, d)) * s).astype(np.float32)
            for t, s in ((tq, 0.3), (tk, 0.3), (tk, 1.0))]


# ---------------------------------------------------------------------------
# K5's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,kv_len,causal", [
    (256, 384, 300, False), (256, 384, None, False), (256, 256, None, True),
    (128, 384, 200, True),
])
def test_flash_plain_matches_pallas_interpret(dtype, tq, tk, kv_len, causal):
    q, k, v = _qkv(tq, tk)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = jatt.flash_attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                   causal=causal, kv_len=kv_len)
    got = tatt.flash_attention(*(_t(x).to(tdt) for x in (q, k, v)),
                               causal=causal, kv_len=kv_len)
    assert got.shape == ref.shape and str(got.dtype).endswith(dtype)
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        # The same tile loop in the same order; exp's last bit and the
        # summation order inside a tile only.
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    else:
        # bf16 operands with f32 sums on both sides: P may round the other
        # way where exp's last bit differs, then one bf16 output rounding.
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


def test_flash_causal_rule_has_no_offset():
    """K5's causal rule is row >= col on absolute indices; with Tq != Tk
    it differs from attention_reference's, which shifts by Tk - Tq."""
    q, k, v = (_t(x) for x in _qkv(128, 384, seed=3))
    got = tatt.flash_attention(q, k, v, causal=True)
    # Under K5's rule row r sees keys 0..r only: the first 128 keys.
    want = tatt.attention_reference(q, k[:, :, :128], v[:, :, :128], causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    shifted = tatt.attention_reference(q, k, v, causal=True)
    assert np.abs(got.numpy() - shifted.numpy()).max() > 1e-2


@pytest.mark.parametrize("tq,tk,kv_len", [(130, 300, 300), (200, 391, 333)])
def test_flash_plain_ragged_equals_padded(tq, tk, kv_len):
    """The port takes ragged Tq and Tk where the reference's dispatcher
    pads both to multiples of 128 with zeros and slices the result: the
    pad columns are masked, so they add exact zeros."""
    q, k, v = _qkv(tq, tk, seed=5)
    got = tatt.flash_attention(_t(q), _t(k), _t(v), kv_len=kv_len)
    pq, pk = (-tq) % 128, (-tk) % 128
    padded = tatt.flash_attention(
        _t(np.pad(q, ((0, 0), (0, 0), (0, pq), (0, 0)))),
        _t(np.pad(k, ((0, 0), (0, 0), (0, pk), (0, 0)))),
        _t(np.pad(v, ((0, 0), (0, 0), (0, pk), (0, 0)))), kv_len=kv_len)[:, :, :tq]
    # Zeros added to the sums in another order: an f32 ulp.
    np.testing.assert_allclose(got.numpy(), padded.numpy(), rtol=0, atol=1e-6)


def test_flash_block_sizes():
    """block_k sets where the running max advances (the rounding, not the
    function); block_q changes nothing."""
    q, k, v = (_t(x) for x in _qkv(128, 384, seed=6))
    base = tatt.flash_attention(q, k, v, kv_len=300)
    other_q = tatt.flash_attention(q, k, v, kv_len=300, block_q=64)
    other_k = tatt.flash_attention(q, k, v, kv_len=300, block_k=64)
    assert torch.equal(base, other_q)
    np.testing.assert_allclose(other_k.numpy(), base.numpy(), rtol=0, atol=2e-5)
    full = tatt.attention_reference(q, k, v, kv_len=300)
    np.testing.assert_allclose(base.numpy(), full.numpy(), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# The dispatch past 4096 key positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form,tq,tk,causal", [
    ("fullkv", 128, 4224, False), ("fullkv", 130, 4200, False),
    ("fullkv", 128, 4224, True), ("pipe", 128, 4224, False),
    ("q8", 128, 4224, False),
])
def test_long_kv_dispatch_matches_reference(monkeypatch, form, tq, tk, causal):
    """multihead_attention sends K/V longer than 4096 to K5 under every
    form, ragged shapes included, and gives the JAX dispatcher's output
    (which pads to 128 and slices)."""
    q, k, v = _qkv(tq, tk, seed=12)
    calls = []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tatt.multihead_attention(_t(q), _t(k), _t(v), causal=causal, form=form)
    assert len(calls) == 1
    with reference_on_tpu_path(monkeypatch):
        ref = jatt.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal)
    # f32; the same tile loop on both sides.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# A long-window model: the encoder at 4224 positions
# ---------------------------------------------------------------------------

LONG = dict(name="test-long", n_mels=80, n_audio_ctx=4224, n_audio_state=64,
            n_audio_head=1, n_audio_layer=1, n_vocab=51865, n_text_ctx=24,
            n_text_state=64, n_text_head=1, n_text_layer=1)
JLONG = jcfg.WhisperConfig(**LONG)
TLONG = tcfg.WhisperConfig(**LONG)


def _seeded_tree(cfg, seed=0):
    """A numpy-seeded parameter tree in the reference's layout: weights ~
    N(0, 1/fan_in), biases ~ 0.1 N, norms ~ 1 + 0.1 N."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape,
                          jax.eval_shape(lambda: jmod.init_params(
                              cfg, jax.random.PRNGKey(0))))

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


@pytest.fixture(scope="module")
def long_model():
    tree = _seeded_tree(JLONG)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def test_long_window_encoder_matches_reference(monkeypatch, long_model):
    """encode over 4224 positions (84.48 s of audio): the port's
    self-attention goes through K5's plain version, the reference's
    through the Pallas K5."""
    jp, tp = long_model
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((1, 80, 2 * JLONG.n_audio_ctx)).astype(np.float32)
    calls = []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tmod.encode(tp, _t(mel), TLONG).numpy()
    assert len(calls) == JLONG.n_audio_layer
    traced = []
    jreal = jatt.flash_attention
    monkeypatch.setattr(jatt, "flash_attention",
                        lambda *a, **kw: traced.append(1) or jreal(*a, **kw))
    with reference_on_tpu_path(monkeypatch):
        ref = np.asarray(jmod.encode(jp, jnp.asarray(mel), JLONG))
    assert traced
    assert got.shape == (1, JLONG.n_audio_ctx, JLONG.n_audio_state)
    # f32 throughout; summation order only (the f32 encoder's tolerance
    # in test_torch_model.py).
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_long_window_engine_geometry(monkeypatch):
    """The engine of a model with 4224 positions plans 84.48 s windows,
    encodes each through K5 and decodes over all 4224 positions."""
    monkeypatch.setitem(tcfg.CONFIGS, "test-long", TLONG)
    eng = WhisperEngine(device="cpu")
    eng.load_model("random:test-long")
    assert eng.window_frames == 8448 and eng.window_samples == 8448 * 160
    calls, ctxs = [], []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    real_step = tmod._cross_attention
    monkeypatch.setattr(
        tmod, "_cross_attention",
        lambda cq, ck, cv, dh, kv_len=0: ctxs.append((ck.shape[-1], kv_len))
        or real_step(cq, ck, cv, dh, kv_len=kv_len))
    rng = np.random.default_rng(4)
    audio = [(0.3 * rng.standard_normal(16000 * 100)).astype(np.float32)]
    p = TranscribeParams(language="en", condition_on_previous_text=False,
                         temperatures=(0.0,), parallel_windows=True, max_tokens=3)
    plan = eng._plan_parallel_windows(audio, p)[0]
    assert plan == [(0, 0), (0, 8448)]  # 100 s: two 84.48 s windows
    res = eng.transcribe_batch(audio, p)
    assert len(res) == 1 and len(calls) == TLONG.n_audio_layer
    assert ctxs and all(t == 4224 and kv in (0, 4224) for t, kv in ctxs)


# ---------------------------------------------------------------------------
# A reduced audio context: the engine on the trained tiny checkpoint
# ---------------------------------------------------------------------------


def _params(cls, **kw):
    return cls(language="en", condition_on_previous_text=False,
               temperatures=(0.0,), parallel_windows=True, **kw)


def _as_dicts(results):
    return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                 segments=[(s.start, s.end, s.text) for s in r.segments])
            for r in results]


@pytest.fixture(scope="module")
def engines():
    port = WhisperEngine(device="cpu")
    port.load_model(NPZ)
    ref = JaxEngine()
    ref.load_model(NPZ)
    return port, ref


@pytest.fixture(scope="module")
def utterances():
    rng = np.random.default_rng(777)
    ids = [tcc.sample_word_ids(rng) for _ in range(3)]
    return [tcc.utterance(w)[0] for w in ids]


@pytest.mark.parametrize("audio_ctx", [None, 256, 750, 1500, 375, 9999])
def test_window_geometry_matches_reference(engines, audio_ctx):
    port, ref = engines
    assert (port._window_geometry(_params(TranscribeParams, audio_ctx=audio_ctx))
            == ref._window_geometry(_params(JParams, audio_ctx=audio_ctx)))
    assert port.window_samples == ref.window_samples


@pytest.mark.parametrize("audio_ctx,overlap_s,wire", [
    (750, 0.0, "auto"), (1500, 0.0, "auto"), (375, 2.0, "auto"),
    (100, 2.0, "auto"),  # the overlap capped at half the reduced window
    (750, 1.0, "mulaw"),
])
def test_reduced_window_plan_matches_reference(engines, utterances, audio_ctx,
                                               overlap_s, wire):
    """Plan, stride, overlap and the assembled window array under a
    reduced audio_ctx: int16 and f32 inputs of different lengths."""
    port, ref = engines
    audio = [utterances[0], utterances[1][:16000 * 7],
             (utterances[2][:16000 * 11] * 32767).astype(np.int16)]
    if wire == "mulaw":
        audio = [a if a.dtype == np.int16 else (a * 32767).astype(np.int16)
                 for a in audio]
    kw = dict(audio_ctx=audio_ctx, parallel_overlap_s=overlap_s)
    monkey = pytest.MonkeyPatch()
    try:
        monkey.setattr(port, "wire", wire)
        monkey.setattr(ref, "wire", wire)
        got = port._plan_parallel_windows(audio, _params(TranscribeParams, **kw))
        want = ref._plan_parallel_windows(audio, _params(JParams, **kw))
    finally:
        monkey.undo()
    assert got[0] == want[0] and got[2:] == want[2:]
    assert got[1].dtype == want[1].dtype and got[1].shape == want[1].shape
    assert got[1].shape[1] == min(2 * audio_ctx, 3000) * 160
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("entry", ["batch", "stream"])
@pytest.mark.parametrize("audio_ctx,overlap_s", [(750, 0.0), (1500, 0.0),
                                                 (750, 2.0), (375, 1.0)])
def test_reduced_context_engine_matches_reference(engines, utterances, entry,
                                                  audio_ctx, overlap_s):
    """transcribe_batch and transcribe_stream under audio_ctx = half, the
    full context and a quarter (an odd count): tokens, text and segments
    equal to the JAX engine's."""
    port, ref = engines
    kw = dict(audio_ctx=audio_ctx, parallel_overlap_s=overlap_s)
    if entry == "batch":
        got = port.transcribe_batch(utterances, _params(TranscribeParams, **kw))
        want = ref.transcribe_batch(utterances, _params(JParams, **kw))
    else:
        batches = [utterances[:2], utterances[2:]]
        got = [r for b in port.transcribe_stream(
            batches, _params(TranscribeParams, **kw), overlap_fetch=True)
            for r in b]
        want = [r for b in ref.transcribe_stream(
            batches, _params(JParams, **kw), overlap_fetch=True) for r in b]
    assert _as_dicts(got) == _as_dicts(want)
    assert any(r.tokens for r in got)  # the windows decoded something


def test_reduced_context_encodes_fewer_positions(engines, utterances):
    """Under audio_ctx the encoder output, the cross-K/V length and the
    timestamp suppression all follow the reduced context."""
    port, _ = engines
    p = _params(TranscribeParams, audio_ctx=256)
    _, windows, _, _ = port._plan_parallel_windows(utterances[:1], p)
    assert windows.shape[1] == 512 * 160
    with torch.inference_mode():
        xa = port._frontend(torch.from_numpy(windows))
    assert xa.shape[1] == 256
    full = port._plan_parallel_windows(utterances[:1], _params(TranscribeParams))[1]
    assert full.shape[1] == 3000 * 160


# ---------------------------------------------------------------------------
# pad_or_trim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,length", [
    ((100,), 160), ((200,), 160), ((160,), 160), ((2, 3, 50), 64),
    ((2, 480100), None), ((1000,), None),
])
def test_pad_or_trim_matches_reference(shape, length):
    rng = np.random.default_rng(8)
    x = rng.standard_normal(shape).astype(np.float32)
    args = () if length is None else (length,)
    got = tmel.pad_or_trim(_t(x), *args)
    want = np.asarray(jmel.pad_or_trim(jnp.asarray(x), *args))
    assert tuple(got.shape) == want.shape
    assert got.shape[-1] == (length or tmel.N_SAMPLES)
    np.testing.assert_array_equal(got.numpy(), want)
