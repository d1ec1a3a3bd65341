"""K4's host side on the CPU: the row pitch that TMA needs for bf16 (and
int8) K/V slabs, the load path and the slab checks, and the decoder's bf16
cross-K/V stored at that pitch. The padded layout is held against the JAX
reference's precompute_cross_kv and greedy decode on the same
numpy-seeded weights; the kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import cast_params, params_from_jax
from spittle_tpu_torch.ops import attention as att

ALIGNED = 0x7F0000000000  # a 16-byte-aligned base address


@pytest.mark.parametrize("tk,itemsize,want", [
    (1500, 1, 1504), (1536, 1, 1536), (255, 1, 256), (6000, 1, 6000),
    (1500, 2, 1504), (1536, 2, 1536), (255, 2, 256), (6000, 2, 6000),
    (1, 2, 8), (1499, 4, 1500), (1500, 4, 1500),
])
def test_tma_pitch_by_element_size(tk, itemsize, want):
    """tma_pitch is in elements: rows rounded up to a multiple of 16 bytes."""
    pitch = att.tma_pitch(tk, itemsize)
    assert pitch == want and pitch * itemsize % 16 == 0 and pitch >= tk
    assert pitch - tk < 16 // itemsize


def _rows(b, h, tk, pitch, dtype):
    return torch.zeros((b, h, 64, pitch), dtype=dtype)[..., :tk]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("tk", [1500, 1536, 255, 6000])
def test_slab_pitch_and_load_path(tk, dtype):
    """The decoder's padded rows take TMA at tma_pitch; contiguous rows take
    it only where Tk's bytes are a multiple of 16 (cp.async covers
    otherwise), for bf16 as for int8."""
    es = torch.tensor([], dtype=dtype).element_size()
    pitch = att.tma_pitch(tk, es)
    padded = _rows(2, 3, tk, pitch, dtype)
    assert att._slab_pitch("k4", (padded, padded)) == pitch
    assert att.decode_cross_load_path(pitch * es, ALIGNED, ALIGNED + 4096) == "tma"
    contiguous = torch.zeros((2, 3, 64, tk), dtype=dtype)
    assert att._slab_pitch("k4", (contiguous, contiguous)) == tk
    want = "tma" if tk * es % 16 == 0 else "cp.async"
    assert att.decode_cross_load_path(tk * es, ALIGNED, ALIGNED + 4096) == want
    # A base 2 bytes off a 16-byte boundary (a bf16 row of a reduced
    # context) takes the covers whatever the pitch.
    assert att.decode_cross_load_path(pitch * es, ALIGNED + 2, ALIGNED) == "cp.async"


@pytest.mark.parametrize("case", ["pitch-not-16", "k-v-differ", "heads-apart",
                                  "time-strided"])
def test_slab_pitch_refuses_other_bf16_layouts(case):
    """bf16 rows 1502 elements apart are 3004 bytes, no multiple of 16."""
    k = v = _rows(2, 3, 1500, 1504, torch.bfloat16)
    if case == "pitch-not-16":
        k = v = _rows(2, 3, 1500, 1502, torch.bfloat16)
    elif case == "k-v-differ":
        v = torch.zeros((2, 3, 64, 1500), dtype=torch.bfloat16)
    elif case == "heads-apart":
        k = v = torch.zeros((2, 5, 64, 1504), dtype=torch.bfloat16)[:, :3, :, :1500]
    else:
        k = v = torch.zeros((2, 3, 64, 3000), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="pitch"):
        att._slab_pitch("k4", (k, v))


def test_k4_on_padded_views_equals_contiguous():
    """On the CPU the wrapper is the plain version, which reads the views
    of the padded rows as it reads contiguous K/V (the padding holds NaN
    and is never read)."""
    rng = np.random.default_rng(3)
    b, h, tk = 2, 3, 255
    q = torch.from_numpy(rng.standard_normal((b, h, 3, 64)).astype(np.float32) * 0.125)
    k, v = (torch.from_numpy(rng.standard_normal((b, h, 64, tk)).astype(np.float32))
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    pitch = att.tma_pitch(tk, 2)
    pk, pv = (torch.full((b, h, 64, pitch), float("nan"), dtype=torch.bfloat16)
              for _ in range(2))
    pk[..., :tk], pv[..., :tk] = k, v
    for kv_len in (tk, 200):
        got = att.decode_cross_attention(q, pk[..., :tk], pv[..., :tk], kv_len=kv_len)
        want = att.decode_cross_attention(q, k, v, kv_len=kv_len)
        assert torch.equal(got, want)


# A narrow model with large-v3-turbo's vocabulary, mel bands and four
# decoder layers, Dh 64.
FIELDS = dict(name="test-narrow-turbo", n_mels=128, n_audio_ctx=64,
              n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=51866,
              n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=4)
JCFG = jcfg.WhisperConfig(**FIELDS)
TCFG = tcfg.WhisperConfig(**FIELDS)


@pytest.fixture(scope="module")
def trees():
    """Numpy-drawn weights, the reference's tree and the port's."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jmod.init_params(JCFG))

    def fill(path, leaf):
        key = path[-1].key
        if key.endswith("ln_g"):
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif key.endswith(("_b", "ln_b", "bq", "bv", "bo")) or key == "pos_emb":
            a = 0.1 * rng.standard_normal(leaf.shape)
        else:
            fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
            a = rng.standard_normal(leaf.shape) * fan_in ** -0.5
        return jnp.asarray(a, jnp.float32)

    jp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jp, params_from_jax(jp)


def _xa(t):
    rng = np.random.default_rng(t)
    return rng.standard_normal((2, t, JCFG.n_audio_state)).astype(np.float32)


@pytest.mark.parametrize("dtype,t,pitch", [
    (torch.float32, 1499, 1500),   # f32 rows of 1499 pad to 6000 bytes
    (torch.bfloat16, 1500, 1504),  # the engine's bf16 decoder on the card
    (torch.bfloat16, 255, 256),    # a reduced context's odd length
])
def test_precompute_cross_kv_padded_rows_equal_reference(trees, dtype, t, pitch):
    """precompute_cross_kv returns [L, B, H, 64, T] views whose rows lie
    tma_pitch(T) elements apart (a multiple of 16 bytes), each layer the
    slab K4 takes by TMA, with the reference's values: f32 to f32
    rounding, bf16 to the bf16 rounding of the port's projections."""
    jp, tp = trees
    xa = _xa(t)
    ref = jmod.precompute_cross_kv(jp, jnp.asarray(xa), JCFG)
    got = tmod.precompute_cross_kv(cast_params(tp, dtype),
                                   torch.from_numpy(xa).to(dtype), TCFG)
    for g, r in zip(got, ref):
        assert g.shape == (4, 2, 2, 64, t) and g.dtype == dtype
        assert g.stride() == (2 * 2 * 64 * pitch, 2 * 64 * pitch, 64 * pitch, pitch, 1)
        assert pitch * g.element_size() % 16 == 0
        for layer in range(4):
            view = g[layer]
            ld = att._slab_pitch("k4", (view, view))
            assert ld == pitch
            assert att.decode_cross_load_path(ld * g.element_size(), ALIGNED) == "tma"
        tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else \
            dict(atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r), **tol)


def test_greedy_tokens_through_the_padded_rows(trees, monkeypatch):
    """Greedy decoding over the bf16 decoder's cross-K/V layout: the port's
    tokens on rows padded to tma_pitch (T 1499 in f32: rows of 1500)
    equal those on contiguous rows and the reference's."""
    jp, tp = trees
    xa = _xa(1499)
    ref = jdec.greedy_decode(jp, jnp.asarray(xa), JCFG,
                             jdec.DecodeOptions(language="en", max_tokens=10))
    opts = tdec.DecodeOptions(language="en", max_tokens=10)
    padded = tdec.greedy_decode(tp, torch.from_numpy(xa), TCFG, opts)
    monkeypatch.setattr(tmod, "_padded_rows",
                        lambda a, n: a.new_empty((n, *a.shape)))
    contiguous = tdec.greedy_decode(tp, torch.from_numpy(xa), TCFG, opts)
    assert torch.equal(padded["tokens"], contiguous["tokens"])
    np.testing.assert_array_equal(padded["tokens"].numpy(), np.asarray(ref["tokens"]))
