"""The encoder-attention forms of spittle_tpu_torch against the JAX
reference on the CPU: the plain versions of K7 (int8 products), K8 and K9
(packed heads, head pairs) and K10 (pipelined) against their Pallas
kernels in interpret mode, the dispatch under each form, the encoder
under each form against the JAX encoder under the same environment
setting, the engine's tokens, and the option's checks.

To make the JAX package reach its Pallas kernels on the CPU, a test
patches spittle_tpu.ops.attention._on_tpu to True, sets the form's
environment variable and runs in interpret mode. The JAX package reads
the variable when it traces, so every such test clears JAX's caches
before and after. Inputs are numpy-seeded; each tolerance says why.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.tokenizer import make_test_vocab
from spittle_tpu.models.whisper.weights import save_npz_checkpoint
from spittle_tpu.ops import attention as jatt
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import attention as tatt
from spittle_tpu_torch.ops import quant as tquant

# The reference's environment setting for each form of the port's option.
FORM_ENV = {
    "fullkv": {},
    "q8": {"SPITTLE_ATTN_Q8": "1"},
    "packed": {"SPITTLE_PACKED_ATTENTION": "1"},
    "pair": {"SPITTLE_PACKED_ATTENTION": "pair"},
    "pipe": {"SPITTLE_ATTN_PIPE": "1"},
}
# The JAX kernel and the port wrapper each form reaches at encoder scale.
FORM_KERNEL = {
    "fullkv": "flash_attention_fullkv",
    "q8": "flash_attention_fullkv_q8",
    "packed": "flash_attention_fullkv_packed",
    "pair": "flash_attention_fullkv_packed_pair",
    "pipe": "flash_attention_fullkv_pipe",
}

# A narrow Whisper whose encoder reaches the kernels: Dh = 64 with an even
# head count (so "pair" applies), and 200 positions (>= 128 rows, padded
# to 256 by the reference's dispatcher, so the padded-max rule of K7 is
# exercised). The committed trained_tiny checkpoint has Dh = 8, which
# every form keeps on plain attention.
FIELDS = dict(name="test-forms", n_mels=80, n_audio_ctx=200, n_audio_state=128,
              n_audio_head=2, n_audio_layer=2, n_vocab=51865, n_text_ctx=24,
              n_text_state=128, n_text_head=2, n_text_layer=2)
JCFG = jcfg.WhisperConfig(**FIELDS)
TCFG = tcfg.WhisperConfig(**FIELDS)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@contextlib.contextmanager
def reference_form(monkeypatch, form):
    """The JAX package under `form`'s environment setting, reaching its
    Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(jatt, "_on_tpu", lambda: True)
    for name, value in FORM_ENV[form].items():
        monkeypatch.setenv(name, value)
    jax.clear_caches()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        for name in FORM_ENV[form]:
            monkeypatch.delenv(name)
        jax.clear_caches()


def _count_calls(monkeypatch, module, names):
    """Wrap module.<name> for each name; returns {name: calls}. The JAX
    package's kernels count when they are traced."""
    seen = {name: 0 for name in names}
    for name in names:
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return seen


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _qkv(b=1, h=2, t=256, d=64, seed=7):
    """The shapes and scales of tests/test_attention_kernels.py."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, t, d)) * s).astype(np.float32)
            for s in (0.3, 0.3, 1.0)]


def test_q8_row_quantizer_bytes_equal():
    """K7 quantizes q, k and v by the reference's _quantize_rows_i8, whose
    rule the port's quantize_kv_t carries."""
    x = _qkv()[0] * 3.0
    x[0, 0, 5] = 0.0  # an all-zero row takes scale 1
    got = tquant.quantize_kv_t(_t(x))
    r8, rscale = jatt._quantize_rows_i8(jnp.asarray(x))
    np.testing.assert_array_equal(got["qw"].numpy(), np.asarray(r8))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(rscale)[..., 0])


def assert_q8_close(got, ref, q, k, v, kv_len=None):
    """K7's plain version repeats the reference's arithmetic: the same
    int8 codes, exact int32 sums, the same f32 operations in the same
    order. Only exp's last bit (two libraries) and l's summation order
    differ (~1e-7), and where exp's last bit lands p*vs/sp on the other
    side of a rounding boundary, one P code moves by one. That moves row
    r's outputs by at most |v8| * sp / l <= mp/l (~1e-3 here; mp/l does
    not depend on the max subtracted). So: every output within 1e-5 plus
    one such step, and at most 1% of the rows with a step at all. The
    reference's own test holds the kernel to 4e-2 against f32 attention."""
    step = tatt.q8_code_step(q, k, v, kv_len).numpy()
    err = np.abs(np.asarray(got) - np.asarray(ref)).max(axis=-1)
    assert got.shape == ref.shape
    assert np.all(err <= 1e-5 + 1.001 * step), (err - step).max()
    assert np.mean(err > 1e-5) <= 0.01


@pytest.mark.parametrize("seed,kv_len", [(7, 256), (7, 200), (1, 200)])
def test_q8_plain_matches_pallas_interpret(seed, kv_len):
    q, k, v = _qkv(seed=seed)
    ref = jatt.flash_attention_fullkv_q8(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), kv_len=kv_len,
                                         block_q=128, interpret=True)
    got = tatt.flash_attention_fullkv_q8(_t(q), _t(k), _t(v), kv_len=kv_len)
    assert_q8_close(got.numpy(), ref, _t(q), _t(k), _t(v), kv_len)


def test_q8_plain_zero_k_poisoned_v_tail():
    """K's tail zeroed as the dispatcher pads it, V's tail poisoned: the
    post-exp mask keeps V's tail out, and the zero scores enter the
    unmasked max in both."""
    q, k, v = _qkv(seed=9)
    k[:, :, 200:] = 0.0
    v[:, :, 200:] = -50.0
    ref = jatt.flash_attention_fullkv_q8(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), kv_len=200,
                                         block_q=128, interpret=True)
    got = tatt.flash_attention_fullkv_q8(_t(q), _t(k), _t(v), kv_len=200)
    assert_q8_close(got.numpy(), ref, _t(q), _t(k), _t(v), 200)


def test_q8_plain_unpadded_matches_padded_reference():
    """The port reads an unpadded Tk = 200; the reference's dispatcher
    pads q, k and v to 256 with zeros. The plain version's max starts at
    the pad columns' score 0, so the two agree."""
    q, k, v = (x[:, :, :200] for x in _qkv(seed=11))
    pad = [(0, 0), (0, 0), (0, 56), (0, 0)]
    ref = jatt.flash_attention_fullkv_q8(
        *(jnp.pad(jnp.asarray(x), pad) for x in (q, k, v)), kv_len=200,
        block_q=128, interpret=True)[:, :, :200]
    got = tatt.flash_attention_fullkv_q8(_t(q), _t(k), _t(v))
    assert_q8_close(got.numpy(), ref, _t(q), _t(k), _t(v))


@pytest.mark.parametrize("block_q", [128, 256])
@pytest.mark.parametrize("kv_len", [256, 200])
def test_pipe_plain_matches_pallas_interpret(block_q, kv_len):
    q, k, v = _qkv(b=2, h=3)
    ref = jatt.flash_attention_fullkv_pipe(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), kv_len=kv_len,
                                           block_q=block_q, interpret=True)
    got = tatt.flash_attention_fullkv_pipe(_t(q), _t(k), _t(v), kv_len=kv_len)
    # f32 end to end; the softmax's max (masked here, unmasked there) and
    # normalization order only: the reference's own test tolerance.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("kernel", ["flash_attention_fullkv_packed",
                                    "flash_attention_fullkv_packed_pair"])
@pytest.mark.parametrize("causal,kv_len", [(False, 256), (False, 200),
                                           (True, 256), (True, 200)])
def test_packed_plain_matches_pallas_interpret(kernel, causal, kv_len):
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 256, 4, 64
    q, k, v = (rng.standard_normal((b, t, h * d)).astype(np.float32) * 0.5
               for _ in range(3))
    ref = getattr(jatt, kernel)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                h, causal=causal, kv_len=kv_len, block_q=128,
                                interpret=True)
    got = getattr(tatt, kernel)(_t(q), _t(k), _t(v), h, causal=causal,
                                kv_len=kv_len)
    assert got.shape == (b, t, h * d)
    # f32 end to end; max and normalization order only, as above.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------

PORT_KERNELS = (*FORM_KERNEL.values(), "flash_attention")


@pytest.mark.parametrize("form,h,d,tq,tk,causal,want", [
    ("fullkv", 2, 64, 160, 160, False, "flash_attention_fullkv"),
    ("q8", 2, 64, 160, 160, False, "flash_attention_fullkv_q8"),
    ("q8", 2, 64, 160, 160, True, "flash_attention_fullkv"),
    ("q8", 2, 64, 128, 4200, False, "flash_attention"),  # Tk > 4096: K5
    ("q8", 2, 64, 64, 64, False, None),  # short: plain attention
    ("pipe", 2, 64, 160, 160, False, "flash_attention_fullkv_pipe"),
    ("pipe", 2, 64, 160, 160, True, "flash_attention_fullkv"),
    # The VMEM gate: block_q 768 x Tk rounded up to 128 <= 768 x 2048.
    ("pipe", 1, 64, 1536, 2048, False, "flash_attention_fullkv_pipe"),
    ("pipe", 1, 64, 1536, 2049, False, "flash_attention_fullkv"),
    ("packed", 2, 64, 160, 160, False, "flash_attention_fullkv_packed"),
    ("packed", 2, 64, 160, 160, True, "flash_attention_fullkv_packed"),
    ("packed", 2, 64, 128, 4200, False, "flash_attention"),  # Tk > 4096: K5
    ("pair", 2, 64, 160, 160, True, "flash_attention_fullkv_packed_pair"),
    ("pair", 3, 64, 160, 160, False, "flash_attention_fullkv"),  # odd heads
    ("pair", 2, 128, 160, 160, False, "flash_attention_fullkv"),  # Dh 128
])
def test_packed_dispatch_routes_as_the_reference(monkeypatch, form, h, d, tq,
                                                 tk, causal, want):
    """multihead_attention_packed under each form picks the reference's
    kernel on shape alone and gives its output (the JAX dispatcher under
    the same setting, Pallas in interpret mode; the tiled flash kernel K5
    past Tk 4096, under every form)."""
    rng = np.random.default_rng(12)
    q = (rng.standard_normal((1, tq, h * d)) * d ** -0.25).astype(np.float32)
    k, v = ((rng.standard_normal((1, tk, h * d)) * d ** -0.25).astype(np.float32)
            for _ in range(2))
    seen = _count_calls(monkeypatch, tatt, PORT_KERNELS)
    got = tatt.multihead_attention_packed(_t(q), _t(k), _t(v), h,
                                          causal=causal, form=form)
    assert {n for n, c in seen.items() if c} == ({want} if want else set())
    with reference_form(monkeypatch, form):
        ref = jatt.multihead_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), h, causal=causal)
    if want == "flash_attention_fullkv_q8":
        split = [tatt.split_heads(_t(x), h) for x in (q, k, v)]
        assert_q8_close(tatt.split_heads(got, h).numpy(),
                        np.asarray(ref).reshape(1, tq, h, d).transpose(0, 2, 1, 3),
                        *split)
        return
    # f32; the softmax's max and normalization order only.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("tk,want", [(1500, "resident"), (1536, "resident"),
                                     (300, "resident"), (1537, "streamed"),
                                     (2000, "streamed"), (4096, "streamed")])
def test_q8_form_by_shape(tk, want):
    """K7 keeps a head's int8 K and Vt in shared memory up to 12 key tiles
    of 128 (1536 positions) and streams them past that: a function of Tk
    alone."""
    assert tatt.q8_form(tk) == want


@pytest.mark.parametrize("tq,tk,tqpad,tpad", [(1500, 1500, 1536, 1536),
                                              (1536, 1536, 1536, 1536),
                                              (300, 300, 384, 384),
                                              (1537, 1537, 1664, 1664),
                                              (160, 2000, 256, 2048),
                                              (4096, 4096, 4096, 4096)])
def test_q8_buffers_shapes(tq, tk, tqpad, tpad):
    """K7's buffers, shared by the wrapper, its parts probe and chip_smoke:
    q8 and k8 row-major, V transposed over Tk rounded up to 128, the
    scales padded to 128 positions, the output [B, Tq, H, 64] in q's
    dtype."""
    q = torch.zeros((2, 3, tq, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 3, tk, 64), dtype=torch.bfloat16)
    bufs = tatt._q8_buffers(q, k)
    shapes = {name: tuple(t.shape) for name, t in bufs.items()}
    assert shapes == {"q8": (2, 3, tq, 64), "k8": (2, 3, tk, 64),
                      "v8t": (2, 3, 64, tpad), "out": (2, tq, 3, 64),
                      "qs": (2, 3, tqpad), "ks": (2, 3, tpad), "vs": (2, 3, tpad)}
    assert [bufs[n].dtype for n in ("q8", "k8", "v8t", "qs", "out")] == [
        torch.int8, torch.int8, torch.int8, torch.float32, torch.bfloat16]


def test_unknown_form_raises():
    q = torch.zeros((1, 2, 160, 64))
    for call in (
        lambda: tatt.multihead_attention(q, q, q, form="flash"),
        lambda: tatt.multihead_attention_packed(q[0][None], q[0][None],
                                                q[0][None], 2, form="Q8"),
        lambda: WhisperEngine(device="cpu", encoder_attention="int8"),
    ):
        with pytest.raises(ValueError, match="encoder_attention"):
            call()
    eng = WhisperEngine(device="cpu")
    assert eng.encoder_attention == "fullkv"
    with pytest.raises(ValueError, match="encoder_attention"):
        eng.encoder_attention = None


# ---------------------------------------------------------------------------
# The slice: the encoder and the engine under each form
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(JAX params, port params, npz path) of a numpy-seeded narrow model:
    weights ~ N(0, 1/fan_in), biases ~ 0.1 N, norms ~ 1 + 0.1 N."""
    rng = np.random.default_rng(0)
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

    tree = jax.tree_util.tree_map_with_path(
        fill, shapes, is_leaf=lambda s: isinstance(s, tuple))
    path = str(tmp_path_factory.mktemp("forms") / "forms.npz")
    save_npz_checkpoint(path, JCFG, tree, make_test_vocab())
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree), path


def _mel(seed=2, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 80, 2 * JCFG.n_audio_ctx)).astype(np.float32)


@pytest.mark.parametrize("form", list(FORM_ENV))
def test_encoder_under_each_form_matches_reference(monkeypatch, model, form):
    jp, tp, _ = model
    mel = _mel()
    port_seen = _count_calls(monkeypatch, tatt, [FORM_KERNEL[form]])
    got = tmod.encode(tp, _t(mel), TCFG, attention=form).numpy()
    ref_seen = _count_calls(monkeypatch, jatt, [FORM_KERNEL[form]])
    with reference_form(monkeypatch, form):
        ref = np.asarray(jmod.encode(jp, jnp.asarray(mel), JCFG))
    # One launch per layer in the port; traced in the reference's scan.
    assert port_seen[FORM_KERNEL[form]] == JCFG.n_audio_layer
    assert ref_seen[FORM_KERNEL[form]] >= 1
    assert got.shape == (2, JCFG.n_audio_ctx, JCFG.n_audio_state)
    if form != "q8":
        # f32 throughout; summation order only, over 2 layers of O(1)
        # values (the f32 encoder's tolerance in test_torch_model.py).
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        return
    # q8 rounds q, k, v and P to int8 codes, so an f32 ulp upstream (the
    # projections' summation order) can move a code and a row by ~1e-3.
    # As for the W8A8 encoder: the port stays far closer to the reference's
    # q8 encoder than q8 is to the f32 encoder.
    with reference_form(monkeypatch, "fullkv"):
        f32 = np.asarray(jmod.encode(jp, jnp.asarray(mel), JCFG))
    port_err, quant_err = np.abs(got - ref), np.abs(ref - f32)
    assert port_err.mean() < 0.1 * quant_err.mean()
    assert port_err.max() < quant_err.max()


def _results(results):
    return [dict(text=r.text, tokens=list(r.tokens),
                 segments=[(s.start, s.end, s.text) for s in r.segments])
            for r in results]


@pytest.mark.parametrize("form", ["q8", "packed", "pair", "pipe"])
def test_engine_tokens_under_each_form(monkeypatch, model, form):
    """Through transcribe_batch: under "q8" the port's tokens, text and
    segments equal the JAX engine's with SPITTLE_ATTN_Q8=1; the other
    forms compute K1's function, so the port's output equals its own
    "fullkv" output."""
    _, _, path = model
    rng = np.random.default_rng(5)
    audio = [(0.3 * rng.standard_normal(16000 * 3)).astype(np.float32)
             for _ in range(3)]

    def params(cls):
        return cls(language="en", condition_on_previous_text=False,
                   temperatures=(0.0,), parallel_windows=True)

    eng = WhisperEngine(device="cpu", encoder_attention=form)
    eng.load_model(path)
    seen = _count_calls(monkeypatch, tatt, [FORM_KERNEL[form]])
    got = _results(eng.transcribe_batch(audio, params(TranscribeParams)))
    assert seen[FORM_KERNEL[form]] == JCFG.n_audio_layer
    assert any(r["tokens"] for r in got)
    if form == "q8":
        ref_eng = JaxEngine()
        ref_eng.load_model(path)
        ref_seen = _count_calls(monkeypatch, jatt, [FORM_KERNEL[form]])
        with reference_form(monkeypatch, form):
            ref = _results(ref_eng.transcribe_batch(audio, params(JParams)))
        assert ref_seen[FORM_KERNEL[form]] >= 1
    else:
        eng.encoder_attention = "fullkv"
        ref = _results(eng.transcribe_batch(audio, params(TranscribeParams)))
    assert got == ref
    assert os.environ.get("SPITTLE_ATTN_Q8") is None  # nothing leaked
