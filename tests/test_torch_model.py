"""spittle_tpu_torch's Whisper model against the JAX reference on the CPU:
building blocks, the f32 and W8A8 encoders, decoder prefill and K=1 steps,
and greedy decoding, all on the same numpy-seeded weights carried across
with params_from_jax.
"""

import dataclasses
import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper import tokenizer as jtok
from spittle_tpu.ops.quant import quantize_whisper_encoder_w8a8 as jquant_enc
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper import tokenizer as ttok
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops.quant import quantize_whisper_encoder_w8a8

# A narrow Whisper with the real multilingual token layout: Dh = 64 (the
# kernels' head dim), 2+2 layers, a 64-position audio context.
FIELDS = dict(name="test-narrow", n_mels=80, n_audio_ctx=64, n_audio_state=128,
              n_audio_head=2, n_audio_layer=2, n_vocab=51865, n_text_ctx=64,
              n_text_state=128, n_text_head=2, n_text_layer=2)
JCFG = jcfg.WhisperConfig(**FIELDS)
TCFG = tcfg.WhisperConfig(**FIELDS)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _numpy_tree(seed=0):
    """The reference's parameter tree shape, every leaf drawn from numpy:
    weights ~ N(0, 1/fan_in), biases and pos_emb ~ 0.1 N, norms ~ 1 + 0.1 N."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape,
                          jmod.init_params(JCFG, jax.random.PRNGKey(0)))

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
def trees():
    tree = _numpy_tree()
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _pristine_reference_configs():
    """The reference's CONFIGS as its module defines them. Other test
    modules register extra entries in the imported module at collection
    time, so this executes a fresh copy of its source."""
    name = "_reference_whisper_config_copy"
    spec = importlib.util.spec_from_file_location(name, jcfg.__file__)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses resolves the module by name
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[name]
    return mod.CONFIGS


def test_copies_match_reference():
    ref_configs = _pristine_reference_configs()
    assert set(tcfg.CONFIGS) == set(ref_configs)
    for name, cfg in ref_configs.items():
        assert dataclasses.asdict(tcfg.CONFIGS[name]) == dataclasses.asdict(cfg)
    assert tcfg.CATALOG_TO_CONFIG == jcfg.CATALOG_TO_CONFIG
    vocab = jtok.make_test_vocab()
    assert ttok.make_test_vocab() == vocab
    jt = jtok.WhisperTokenizer(jcfg.CONFIGS["large-v3"], vocab)
    tt = ttok.WhisperTokenizer(tcfg.CONFIGS["large-v3"], vocab)
    for s in (" hello world", "the test_that is", " 12 ab, c!"):
        assert tt.encode(s) == jt.encode(s)
        assert tt.decode(tt.encode(s)) == jt.decode(jt.encode(s))
    ids = [jt.lang_token("en"), 50360, 50365, 51000]
    assert tt.decode_with_timestamps(ids) == jt.decode_with_timestamps(ids)


def test_layer_norm_and_positions():
    rng = np.random.default_rng(1)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 5, 48), (48,), (48,)))
    ref = np.asarray(jmod.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = tmod.layer_norm(_t(x), _t(g), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)  # f32 mean/var order
    np.testing.assert_array_equal(tmod.sinusoidal_positions(100, 64),
                                  jmod.sinusoidal_positions(100, 64))


def _mel(seed=2, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 80, 2 * JCFG.n_audio_ctx)).astype(np.float32)


def test_encoder_f32_matches(trees):
    jp, tp = trees
    mel = _mel()
    ref = np.asarray(jmod.encode(jp, jnp.asarray(mel), JCFG))
    got = tmod.encode(tp, _t(mel), TCFG).numpy()
    assert got.shape == (2, JCFG.n_audio_ctx, JCFG.n_audio_state)
    # f32 throughout; summation order only, over 2 layers of O(1) values.
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_encoder_w8a8_matches(trees):
    """W8A8 rounds activations to int8 per GEMM, so one f32 ulp upstream
    can flip a code and move a whole output row by ~sx*sw*|qw| (~1e-3 here).
    The port folds out_scale into sw and b (the TPU kernel's epilogue);
    the reference's XLA path applies them after the dot: an ulp apart.
    Hence two checks: one block on identical inputs agrees to f32 accuracy
    almost everywhere, and over the whole encoder the port stays much
    closer to the reference's W8A8 encoder than W8A8 is to f32."""
    jp, tp = trees
    jq, tq = jquant_enc(jp), quantize_whisper_encoder_w8a8(tp)
    mel = _mel(seed=3)
    x = jmod._encoder_stem(jq["encoder"], jnp.asarray(mel), JCFG)
    blk_j = jax.tree.map(lambda a: a[0], jq["encoder"]["blocks"])
    blk_t = tmod.layer_params(tq["encoder"]["blocks"], 0)
    one_j = np.asarray(jmod.encoder_block_body(x, blk_j, JCFG.n_audio_head))
    one_t = tmod.encoder_block_body(_t(x), blk_t, TCFG.n_audio_head).numpy()
    d1 = np.abs(one_t - one_j)
    assert np.mean(d1 < 1e-5) > 0.99 and d1.max() < 2e-2

    ref = np.asarray(jmod.encode(jq, jnp.asarray(mel), JCFG))
    f32 = np.asarray(jmod.encode(jp, jnp.asarray(mel), JCFG))
    got = tmod.encode(tq, _t(mel), TCFG).numpy()
    port_err = np.abs(got - ref)
    quant_err = np.abs(ref - f32)
    assert port_err.mean() < 0.5 * quant_err.mean()
    assert port_err.max() < quant_err.max()


@pytest.fixture(scope="module")
def xa():
    rng = np.random.default_rng(4)
    return rng.standard_normal((2, JCFG.n_audio_ctx, JCFG.n_audio_state)).astype(
        np.float32)


def test_cross_kv_prefill_and_decode_steps_match(trees, xa):
    jp, tp = trees
    ck_j, cv_j = jmod.precompute_cross_kv(jp, jnp.asarray(xa), JCFG)
    ck_t, cv_t = tmod.precompute_cross_kv(tp, _t(xa), TCFG)
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), atol=1e-5)
    np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), atol=1e-5)

    ctx = 32
    prefix = np.array([[JCFG.sot, JCFG.lang_begin, JCFG.transcribe]] * 2,
                      np.int32)
    lj, cache_j = jmod.decoder_prefill(jp, jnp.asarray(prefix), (ck_j, cv_j),
                                       JCFG, ctx)
    lt, cache_t = tmod.decoder_prefill(tp, _t(prefix).long(), (ck_t, cv_t),
                                       TCFG, ctx)
    # f32 throughout: per-position logits to 1e-4 (vocab-wide dot of
    # O(1) hidden states).
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    rng = np.random.default_rng(5)
    for step in range(4):
        pos = prefix.shape[1] + step
        tok = rng.integers(0, JCFG.eot, size=2).astype(np.int32)
        lj, cache_j = jmod.decode_step(jp, jnp.asarray(tok),
                                       jnp.asarray(pos, jnp.int32), cache_j,
                                       (ck_j, cv_j), JCFG)
        lt = tmod.decode_step(tp, _t(tok).long(), pos, cache_t, (ck_t, cv_t),
                              TCFG)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    # The port's cache is ctx-major; the reference's time-minor.
    np.testing.assert_allclose(cache_t.transpose(-1, -2).numpy(),
                               np.asarray(cache_j), atol=1e-5)


@pytest.mark.parametrize("r,dh,kernel", [
    (1, 64, True),    # a decode step: K4
    (8, 64, True),
    (9, 64, False),   # more rows than K4 takes
    (1, 8, False),    # a head dim the reference keeps on plain ops
])
def test_cross_attention_dispatch(monkeypatch, r, dh, kernel):
    """The cross-attention core picks K4 on shape alone (the reference's
    rule), on the CPU as on the card, and matches the reference's plain
    form of `_cross_attention`."""
    seen = []
    real = tmod.decode_cross_attention
    monkeypatch.setattr(tmod, "decode_cross_attention",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    rng = np.random.default_rng(7)
    tk, kv_len = 96, 90
    cq = rng.standard_normal((2, 3, r, dh)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 3, dh, tk)).astype(np.float32)
              for _ in range(2))
    got = tmod._cross_attention(_t(cq), _t(ck), _t(cv), dh, kv_len=kv_len)
    assert bool(seen) == kernel
    ref = jmod._cross_attention(jnp.asarray(cq), jnp.asarray(ck),
                                jnp.asarray(cv), dh, kv_len=kv_len)
    # f32 end to end; softmax order and masking form differ only.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kv_len", [0, 6401])
def test_cross_attention_long_audio_ctx(monkeypatch, kv_len):
    """A prefill's 8 rows (sot, language, task and a prompt) against the
    cross K/V of a model with n_audio_ctx 6500: past the 6400 positions
    whose 8 score rows fit K4's shared memory in one pass. The core still
    picks K4 on shape alone, and matches the reference's `_cross_attention`."""
    seen = []
    real = tmod.decode_cross_attention
    monkeypatch.setattr(tmod, "decode_cross_attention",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    cfg = dataclasses.replace(JCFG, n_audio_ctx=6500)
    rng = np.random.default_rng(17)
    dh = cfg.n_text_state // cfg.n_text_head
    cq = rng.standard_normal((1, cfg.n_text_head, 8, dh)).astype(np.float32)
    ck, cv = (rng.standard_normal((1, cfg.n_text_head, dh, cfg.n_audio_ctx))
              .astype(np.float32) for _ in range(2))
    got = tmod._cross_attention(_t(cq), _t(ck), _t(cv), dh, kv_len=kv_len)
    assert seen
    ref = jmod._cross_attention(jnp.asarray(cq), jnp.asarray(ck),
                                jnp.asarray(cv), dh, kv_len=kv_len)
    # f32 end to end; softmax order and masking form differ only.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("language,max_tokens", [("en", 12), ("de", 6)])
def test_greedy_tokens_identical(trees, xa, language, max_tokens):
    jp, tp = trees
    ref = jdec.greedy_decode(jp, jnp.asarray(xa), JCFG,
                             jdec.DecodeOptions(language=language,
                                                max_tokens=max_tokens))
    got = tdec.greedy_decode(tp, _t(xa), TCFG,
                             tdec.DecodeOptions(language=language,
                                                max_tokens=max_tokens))
    assert got["sample_begin"] == ref["sample_begin"]
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    np.testing.assert_allclose(got["avg_logprob"].numpy(),
                               np.asarray(ref["avg_logprob"]), atol=1e-4)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(),
                               np.asarray(ref["no_speech_prob"]), atol=1e-5)


def test_process_logits_rules_match():
    """The whisper.cpp logits rules on hand-built states: at the sample
    start, after a lone timestamp, after a timestamp pair, with a floor."""
    rng = np.random.default_rng(6)
    cfg_j, cfg_t = JCFG, TCFG
    ts = cfg_j.timestamp_begin
    opts_j = jdec.DecodeOptions(space_token=220)
    opts_t = tdec.DecodeOptions(space_token=220)
    mask = jdec._static_suppress_mask(cfg_j, opts_j, audio_ctx=64)
    np.testing.assert_array_equal(
        tdec._static_suppress_mask(cfg_t, opts_t, audio_ctx=64), mask)
    logits = rng.standard_normal((3, cfg_j.n_vocab)).astype(np.float32) * 3
    cases = [  # (pos, last, penult, floor), sample_begin = 3
        (3, [50259] * 3, [50258] * 3, [ts - 1] * 3),
        (5, [ts + 10, 300, ts + 4], [300, ts + 2, ts + 3], [ts + 11, ts + 3, ts + 5]),
        (4, [ts + 7, 220, 301], [ts + 7, 300, 300], [ts + 8, ts - 1, ts + 2]),
    ]
    for pos, last, penult, floor in cases:
        ref = jdec._process_logits(
            jnp.asarray(logits), cfg=cfg_j, opts=opts_j,
            static_mask=jnp.asarray(mask), pos=jnp.asarray(pos), sample_begin=3,
            last_tok=jnp.asarray(last), penult_tok=jnp.asarray(penult),
            ts_floor=jnp.asarray(floor))
        got = tdec._process_logits(
            _t(logits), cfg=cfg_t, opts=opts_t, static_mask=_t(mask), pos=pos,
            sample_begin=3, last_tok=_t(np.array(last)),
            penult_tok=_t(np.array(penult)), ts_floor=_t(np.array(floor)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
