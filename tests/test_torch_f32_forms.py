"""The JAX package's default precision, f32, in spittle_tpu_torch on the
CPU: the engine's default compute dtype against the JAX engine's; the plain
versions of K3 and K6 on an f32 q against the Pallas kernels in interpret
mode; the f32 routes (K1's and K5's f32 forms, K4's, K3's and K6's f32
instances) picked by name, and the forms with no f32 kernel yet raising on
a tensor that is not on the CPU; and the whole slice, the f32 engines of
both packages on a Dh-64 model whose encoder and decode steps take the
kernels' dispatch (the JAX package's Pallas kernels in interpret mode),
with the unquantized, int8 and int4 decoders, token for token.

Inputs are made with numpy.random.default_rng and cross between the two
packages as numpy arrays. Each comparison states its tolerance and why.
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
from spittle_tpu.ops import quant as jquant
from spittle_tpu_torch.engine import whisper_engine as tengine
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.ops import attention as tatt
from spittle_tpu_torch.ops import quant as tquant

# The f32 entries and the kernel each stands for.
F32_ENTRIES = {
    "flash_attention_fullkv_f32": "K1",
    "flash_attention_f32": "K5's route",
    "decode_cross_attention_f32": "K4",
    "decode_cross_attention_q8_f32q": "K3",
    "decode_cross_attention_q4_f32q": "K6",
}

# A narrow Whisper whose encoder and decode steps reach the kernels' routes:
# Dh = 64 and 200 encoder positions (>= 128 query rows; the reference pads
# its cross-K/V to 256 for its decode kernels and masks at 200).
FIELDS = dict(name="test-f32", n_mels=80, n_audio_ctx=200, n_audio_state=128,
              n_audio_head=2, n_audio_layer=2, n_vocab=51865, n_text_ctx=24,
              n_text_state=128, n_text_head=2, n_text_layer=2)
JCFG = jcfg.WhisperConfig(**FIELDS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager decode loops of many small ops: beside the suite's other
    workers, intra-op threads only oversubscribe the cores. One thread for
    this module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _count_calls(monkeypatch, module, names):
    """Wrap module.<name> for each name; returns {name: calls}."""
    seen = {name: 0 for name in names}
    for name in names:
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return seen


# ---------------------------------------------------------------------------
# The engine's default precision
# ---------------------------------------------------------------------------


def test_default_dtype_on_the_card_is_the_reference_default(monkeypatch):
    """WhisperEngine(device="cuda") without a dtype computes in the JAX
    engine's default, f32 (the port once took bf16 on the card, a
    precision the JAX app never runs). No card is needed: the device
    resolver and the copy stream are stood in for."""
    monkeypatch.setattr(tengine, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **kw: None)
    want = jnp.dtype(JaxEngine().dtype).name
    for eng in (WhisperEngine(device="cuda"), WhisperEngine.from_env(device="cuda")):
        assert eng.device.type == "cuda"
        assert eng.dtype == torch.float32
        assert str(eng.dtype).removeprefix("torch.") == want == "float32"
    assert WhisperEngine(device="cuda", dtype=torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# K3 and K6 on an f32 q: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _quant_inputs(b, h, r, tk, kv_len, bits, seed):
    """An f32 q pre-scaled by Dh^-0.5 and quantized K/V whose columns from
    kv_len on are pad with scale 1.0 (codes kept: they must be masked)."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, r, 64)) * 64 ** -0.5).astype(np.float32)
    quant = jquant.quantize_kv if bits == 8 else jquant.quantize_kv_int4
    key = "qw" if bits == 8 else "qw4"
    out = [q]
    for _ in range(2):
        kv = quant(jnp.asarray(rng.standard_normal((b, h, 64, tk)), jnp.float32))
        scale = np.array(kv["scale"])
        scale[..., kv_len:] = 1.0
        out += [np.asarray(kv[key]), scale]
    return out


def _p_step(q, qk, ks, qv, vs, kv_len, bits):
    """Per query row [B, H, R, 1]: one bf16 step of P's largest weight,
    2**-8 * max_t(p * vs) * max|qV| / l, the most that one weight rounded
    to the other side of a bf16 boundary moves that row's outputs."""
    codes = [_t(x) for x in (qk, qv)]
    if bits == 4:
        codes = [tquant.unpack_kv_int4(c) for c in codes]
    ck, cv = (c[..., :kv_len].double() for c in codes)
    s = torch.matmul(_t(q).double(), ck) * _t(ks)[..., None, :kv_len].double()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = p * _t(vs)[..., None, :kv_len].double()
    vmax = cv.abs().amax(dim=(-1, -2))[..., None, None]
    return (2.0 ** -8 * pv.amax(dim=-1, keepdim=True) * vmax
            / p.sum(dim=-1, keepdim=True)).numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("r", [1, 5, 8])
@pytest.mark.parametrize("kv_len", [256, 200])
def test_quant_plain_with_f32_q_matches_pallas_interpret(bits, r, kv_len):
    q, qk, ks, qv, vs = _quant_inputs(2, 3, r, 256, kv_len, bits, 30 + r)
    jfn = (jatt.decode_cross_attention_q8 if bits == 8
           else jatt.decode_cross_attention_q4)
    tfn = (tatt.decode_cross_attention_q8 if bits == 8
           else tatt.decode_cross_attention_q4)
    ref = jfn(*(jnp.asarray(a) for a in (q, qk, ks, qv, vs)),
              kv_len=kv_len, interpret=True)
    got = tfn(*(_t(a) for a in (q, qk, ks, qv, vs)), kv_len=kv_len)
    # f32 q in, f32 out in both: the reference's output takes q's dtype.
    assert ref.dtype == jnp.float32
    assert got.dtype == torch.float32 and got.shape == (2, 3, r, 64)
    # The same function in the same order: f32 scores over exact codes,
    # * scale, masked max, bf16(p * vs), f32 PV, / l; no output rounding.
    # p may differ in its last f32 bit (exp and the dot's summation order),
    # which can put p * vs on the other side of a bf16 rounding boundary:
    # one bf16 step of P per row, plus f32 summation order.
    err = np.abs(got.numpy() - np.asarray(ref))
    step = _p_step(q, qk, ks, qv, vs, kv_len, bits)
    scale = float(np.abs(np.asarray(ref)).max())
    assert np.all(err <= step + 1e-6 * scale), float((err - step).max())


# ---------------------------------------------------------------------------
# The f32 routes, by name
# ---------------------------------------------------------------------------


def _cross_inputs(bits, dtype, seed=3):
    """Decode-step cross-attention operands for model._cross_attention: q
    [1, 2, 1, 64] and K/V [1, 2, 64, 256] (bf16 or f32), or their int8 or
    int4 dicts (bits 8, 4)."""
    rng = np.random.default_rng(seed)
    cq = _t(rng.standard_normal((1, 2, 1, 64)).astype(np.float32)).to(dtype)
    kv = [_t(rng.standard_normal((1, 2, 64, 256)).astype(np.float32)) for _ in "kv"]
    if bits == 8:
        return cq, *(tquant.quantize_kv(x) for x in kv)
    if bits == 4:
        return cq, *(tquant.quantize_kv_int4(x) for x in kv)
    return cq, *(x.to(dtype) for x in kv)


def _route(case, dtype):
    """Runs one route on CPU tensors of `dtype`."""
    rng = np.random.default_rng(4)

    def qkv(tq, tk):
        return [_t(rng.standard_normal((1, 2, t, 64)).astype(np.float32) * 0.3
                   ).to(dtype) for t in (tq, tk, tk)]

    if case == "K1":
        return tatt.multihead_attention(*qkv(160, 160))
    if case == "K1 causal":
        return tatt.multihead_attention(*qkv(160, 160), causal=True)
    if case == "K5's route":
        return tatt.multihead_attention(*qkv(128, 4200), kv_len=4100)
    bits = {"K4": 0, "K3": 8, "K6": 4}[case]
    return tmod._cross_attention(*_cross_inputs(bits, dtype), 64, kv_len=200)


@pytest.mark.parametrize("case,want", [
    ("K1", "flash_attention_fullkv_f32"),
    ("K1 causal", "flash_attention_fullkv_f32"),
    ("K5's route", "flash_attention_f32"),
    ("K4", "decode_cross_attention_f32"),
    ("K3", "decode_cross_attention_q8_f32q"),
    ("K6", "decode_cross_attention_q4_f32q"),
])
def test_f32_routes_pick_the_f32_entries(monkeypatch, case, want):
    """An f32 tensor takes the f32 entry of its route and a bf16 one none:
    the dispatch decides by shape, and the bf16 wrapper hands an f32 q to
    its f32 entry, on the CPU as on the card (the CPU runs the entry's
    plain version)."""
    seen = _count_calls(monkeypatch, tatt, F32_ENTRIES)
    out = _route(case, torch.float32)
    assert out.dtype == torch.float32
    assert {n for n, c in seen.items() if c} == {want}
    seen.update(dict.fromkeys(seen, 0))
    assert _route(case, torch.bfloat16).dtype == torch.bfloat16
    assert not any(seen.values())


def _meta(*shape, grad=False):
    """An f32 tensor that is not on the CPU (PyTorch's meta device): the
    wrappers take the card's route for it, so a route that raises on the
    card raises here before any kernel is built."""
    return torch.empty(shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("form,packed", [("q8", False), ("pipe", False),
                                         ("packed", True), ("pair", True)])
def test_forms_with_no_f32_kernel_raise_off_the_cpu(form, packed):
    """"q8", "pipe", "packed" and "pair" (K7, K10, K8, K9) have no f32
    kernel yet: at f32 off the CPU their routes raise and name the form;
    on the CPU their plain versions take f32."""
    if packed:
        x = _meta(1, 160, 128)
        call = lambda t: tatt.multihead_attention_packed(t, t, t, 2, form=form)  # noqa: E731
    else:
        x = _meta(1, 2, 160, 64)
        call = lambda t: tatt.multihead_attention(t, t, t, form=form)  # noqa: E731
    with pytest.raises(NotImplementedError, match=f"'{form}' form.*not yet ported at f32"):
        call(x)
    cpu = torch.zeros(x.shape)
    assert call(cpu).dtype == torch.float32


def test_f32_under_autograd_raises_off_the_cpu():
    """K15 (K1's backward) has no f32 form: off the CPU an f32 call that
    needs a gradient raises; on the CPU the plain backward runs."""
    x = _meta(1, 2, 160, 64, grad=True)
    with pytest.raises(NotImplementedError, match="K15.*not yet ported at f32"):
        tatt.multihead_attention(x, x, x)
    q = torch.zeros((1, 2, 160, 64), requires_grad=True)
    tatt.multihead_attention(q, q, q).sum().backward()
    assert q.grad is not None


# ---------------------------------------------------------------------------
# The slice: both packages' f32 engines on a Dh-64 model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """An .npz of a numpy-seeded narrow model: weights ~ N(0, 1/fan_in),
    biases ~ 0.1 N, norms ~ 1 + 0.1 N."""
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
    path = str(tmp_path_factory.mktemp("f32") / "f32.npz")
    save_npz_checkpoint(path, JCFG, tree, make_test_vocab())
    return path


@contextlib.contextmanager
def reference_kernels(monkeypatch):
    """The JAX package on its kernels' routes: _on_tpu patched, the decode
    cross-attention kernels enabled (SPITTLE_DECODE_CROSS_KERNEL=1), the
    Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(jatt, "_on_tpu", lambda: True)
    monkeypatch.setenv("SPITTLE_DECODE_CROSS_KERNEL", "1")
    jax.clear_caches()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        monkeypatch.delenv("SPITTLE_DECODE_CROSS_KERNEL")
        jax.clear_caches()


def _results(results):
    return [dict(text=r.text, tokens=list(r.tokens),
                 segments=[(s.start, s.end, s.text) for s in r.segments])
            for r in results]


# The decode kernel each decoder takes, in the port and in the reference.
DECODE_KERNEL = {False: ("decode_cross_attention_f32", "decode_cross_attention"),
                 "int8": ("decode_cross_attention_q8_f32q", "decode_cross_attention_q8"),
                 "int4": ("decode_cross_attention_q4_f32q", "decode_cross_attention_q4")}


@pytest.mark.parametrize("quantize_decoder", [False, "int8", "int4"])
def test_f32_engines_token_identical(monkeypatch, model_path, quantize_decoder):
    """transcribe_batch (parallel windows, greedy) on both packages' engines
    at their default dtype, f32: the port's tokens, text and segments equal
    the JAX engine's, the port through K1's f32 form once per encoder layer
    and its decoder's f32 cross-attention entry, the reference through its
    Pallas K1 and decode kernel."""
    rng = np.random.default_rng(5)
    audio = [(0.3 * rng.standard_normal(16000 * 3)).astype(np.float32)
             for _ in range(2)]

    def params(cls):
        return cls(language="en", condition_on_previous_text=False,
                   temperatures=(0.0,), parallel_windows=True)

    port_dec, ref_dec = DECODE_KERNEL[quantize_decoder]
    eng = WhisperEngine(device="cpu", quantize_decoder=quantize_decoder)
    assert eng.dtype == torch.float32
    eng.load_model(model_path)
    seen = _count_calls(monkeypatch, tatt, F32_ENTRIES)
    got = _results(eng.transcribe_batch(audio, params(TranscribeParams)))
    assert seen["flash_attention_fullkv_f32"] == JCFG.n_audio_layer
    assert seen[port_dec] >= JCFG.n_text_layer
    assert {n for n, c in seen.items() if c} == {"flash_attention_fullkv_f32", port_dec}
    assert any(r["tokens"] for r in got)

    ref_eng = JaxEngine(quantize_decoder=quantize_decoder)
    ref_eng.load_model(model_path)
    ref_k1 = _count_calls(monkeypatch, jatt, ["flash_attention_fullkv"])
    ref_k4 = _count_calls(monkeypatch, jmod, [ref_dec])
    with reference_kernels(monkeypatch):
        ref = _results(ref_eng.transcribe_batch(audio, params(JParams)))
    # Traced once each in the reference's jitted encoder and decode loop.
    assert ref_k1["flash_attention_fullkv"] >= 1 and ref_k4[ref_dec] >= 1
    assert got == ref
    assert os.environ.get("SPITTLE_DECODE_CROSS_KERNEL") is None  # nothing leaked
