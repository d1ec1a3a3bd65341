"""The host-side choices of K2 (the W8A8 GEMM's tile width and persistent
tile order) and K3 (the decode cross-attention's load path and the
decoder's padded int8 cross-K/V rows) on the CPU, where they are plain
Python: the kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py). The padded layout is held against
the JAX reference's precompute_cross_kv_q8 and greedy decode on the same
numpy-seeded weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.ops import quant as jquant
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.ops import quant as tquant
from spittle_tpu_torch.ops import w8a8_gemm as k2

H100_SMS = 132
# The encoder's six GEMMs per layer as (K, N).
LAYER_GEMMS = ((1280, 1280), (1280, 5120), (5120, 1280))
# M = B * 1500 at chip_smoke's batch 8 and bench.py's 48 and 56, the
# reduced context's 8 * 256, and the card tests' odd sizes.
ROWS = (12000, 72000, 84000, 2048, 1, 127, 129)


# ---------------------------------------------------------------------------
# K2: tile width and order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", LAYER_GEMMS + ((1280, 384),))
@pytest.mark.parametrize("m", ROWS)
def test_tile_order_covers_every_output_tile_once(m, k, n, dtype):
    """Every 128 x bn tile of the [m, n] output comes once in the
    persistent order, and the blocks of a min(SMs, tiles) grid, block i
    taking tiles i, i + grid, ..., share them out with none left over."""
    for gelu in (False, True):
        bn = k2.tile_n(m, n, k, dtype, H100_SMS, gelu)
        order = k2.tile_order(m, n, bn)
        grid_tiles = {(r, c) for r in range(0, m, k2.TILE_M) for c in range(0, n, bn)}
        assert len(order) == len(grid_tiles) and set(order) == grid_tiles
        grid = min(H100_SMS, len(order))
        taken = [t for b in range(grid) for t in order[b::grid]]
        assert sorted(taken) == sorted(grid_tiles)


def test_tile_order_keeps_row_tiles_of_a_group_adjacent():
    """The grouped order: GROUP_M row tiles take each column in turn, so a
    wave of blocks reads a few panels of qx and the weight's columns."""
    order = k2.tile_order(12000, 1280, 256)
    first = order[:k2.GROUP_M]
    assert [r for r, _ in first] == [i * k2.TILE_M for i in range(k2.GROUP_M)]
    assert {c for _, c in first} == {0}
    assert order[k2.GROUP_M] == (0, 256)
    assert k2.tile_order(12000, 1280, 128)[k2.GROUP_M] == (0, 128)
    # The last group holds the leftover 94 % 8 = 6 row tiles.
    assert [r for r, _ in order[-6:]] == [(88 + i) * k2.TILE_M for i in range(6)]


@pytest.mark.parametrize("m,k,n,dtype,gelu,want", [
    (12000, 5120, 1280, torch.bfloat16, False, 256),  # fc2: 94 x 5 tiles of 256
    (84000, 5120, 1280, torch.bfloat16, False, 256),
    (12000, 1280, 1280, torch.bfloat16, False, 128),  # q, k, v, out: ping-pong
    (12000, 1280, 5120, torch.bfloat16, True, 128),   # fc1: GELU
    (2048, 5120, 1280, torch.bfloat16, False, 128),   # 16 x 5 = 80 < 132 SMs
    (12000, 5120, 384, torch.bfloat16, False, 128),   # 384 is no multiple of 256
    (12000, 5120, 1280, torch.float32, False, 128),   # f32 staging needs the room
    (1, 5120, 1280, torch.bfloat16, False, 128),
])
def test_tile_width_is_a_function_of_the_shape(m, k, n, dtype, gelu, want):
    assert k2.tile_n(m, n, k, dtype, H100_SMS, gelu) == want


@pytest.mark.parametrize("k,n", LAYER_GEMMS)
def test_w8a8_plain_unchanged_at_layer_widths(k, n):
    """The wrapper on CPU tensors is the plain version: the reference's
    arithmetic at the encoder's widths (a few rows)."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((3, k)).astype(np.float32))
    q = tquant.quantize_weight_w8a8(
        torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)))
    got = k2.w8a8_gemm(x, q["qw8"], q["scale"], act="gelu" if n > k else "none")
    want = k2.w8a8_gemm_plain(x, q["qw8"], q["scale"], act="gelu" if n > k else "none")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K3: load path, row pitch and the decoder's layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tk,want", [(1500, 1504), (1536, 1536), (100, 112),
                                     (1, 16), (6000, 6000), (255, 256)])
def test_tma_pitch(tk, want):
    assert att.tma_pitch(tk) == want


@pytest.mark.parametrize("pitch,addresses,want", [
    (1504, (0x7f0000000000, 0x7f0000100000), "tma"),     # the decoder's layout
    (1536, (0x7f0000000100, 0x7f0000200000), "tma"),     # contiguous Tk 1536
    (1500, (0x7f0000000000, 0x7f0000100000), "cp.async"),  # contiguous Tk 1500
    (1504, (0x7f0000000008, 0x7f0000100000), "cp.async"),  # K's base off by 8
    (1504, (0x7f0000000000, 0x7f0000100004), "cp.async"),  # V's base off by 4
    (300, (0, 0), "cp.async"),
])
def test_decode_cross_load_path(pitch, addresses, want):
    assert att.decode_cross_load_path(pitch, *addresses) == want


def test_k3_and_k11_call_one_entry(monkeypatch):
    """K3 moved onto K11's kernel: both wrappers launch one C entry with
    the same layout, so they give the same bits on the same inputs; each
    keeps its own launch count. K6 launches the kernel's int4 entry on
    packed rows, K4 its bf16 one; there is no other launch path."""
    calls = []

    def record(name, entry, *args, **kw):
        calls.append((entry, kw))
        return None

    monkeypatch.setattr(att, "_launch_decode_cross", record)
    q = torch.empty((1, 2, 1, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 2, 64, 300), dtype=torch.int8, device="meta")
    s = torch.empty((1, 2, 300), dtype=torch.float32, device="meta")
    counts = (att.decode_cross_attention_q8.launches,
              att.decode_cross_attention_q8_mh.launches)
    att.decode_cross_attention_q8(q, kv, s, kv, s)
    att.decode_cross_attention_q8_mh(q, kv, s, kv, s)
    att.decode_cross_attention_q4(q, kv[:, :, :32], s, kv[:, :, :32], s)
    att.decode_cross_attention(q, kv.bfloat16(), kv.bfloat16())
    assert calls[0] == calls[1] == ("spt_decode_cross_attention_q8", {})
    assert calls[2] == ("spt_decode_cross_attention_q4", {"packed": True})
    assert calls[3] == ("spt_decode_cross_attention", {})
    assert "spt_decode_cross_attention_q8_mh" not in _build.SIGNATURES
    assert (_build.SIGNATURES["spt_decode_cross_attention_q4"]
            == _build.SIGNATURES["spt_decode_cross_attention_q8"])
    assert (att.decode_cross_attention_q8.launches,
            att.decode_cross_attention_q8_mh.launches) == (counts[0] + 1, counts[1] + 1)


@pytest.mark.parametrize("itemsize,want", [(1, 128), (2, 64)])
def test_item_positions(itemsize, want):
    """Positions per work item: one 128-byte row slice of int8, packed
    int4 (one position per byte) or bf16."""
    assert att.item_positions(itemsize) == want
    assert att.item_positions(itemsize) * itemsize == 128


def _padded(b, h, tk, pitch, rows=64):
    return torch.zeros((b, h, rows, pitch), dtype=torch.int8)[..., :tk]


@pytest.mark.parametrize("rows", [64, 32], ids=["int8", "int4"])
@pytest.mark.parametrize("b,h", [(8, 20), (1, 20), (2, 1)])
def test_slab_pitch_accepts_contiguous_and_padded_rows(b, h, rows):
    """int8 slabs of 64 rows per head (K3) and packed int4 slabs of 32
    (K6): contiguous, padded, and one layer of the decoder's buffer."""
    contiguous = torch.zeros((b, h, rows, 1500), dtype=torch.int8)
    assert att._slab_pitch("k3", (contiguous, contiguous)) == 1500
    padded = _padded(b, h, 1500, 1504, rows)
    assert att._slab_pitch("k3", (padded, padded)) == 1504
    # One layer of the decoder's [L, B, H, rows, T] buffer.
    layer = torch.zeros((4, b, h, rows, 1504), dtype=torch.int8)[..., :1500][2]
    assert att._slab_pitch("k3", (layer, layer)) == 1504


@pytest.mark.parametrize("rows", [64, 32], ids=["int8", "int4"])
@pytest.mark.parametrize("case", ["pitch-not-16", "k-v-differ", "heads-apart",
                                  "time-strided"])
def test_slab_pitch_refuses_other_layouts(case, rows):
    k = _padded(2, 3, 1500, 1504, rows)
    v = k
    if case == "pitch-not-16":
        k = v = _padded(2, 3, 1500, 1510, rows)
    elif case == "k-v-differ":
        v = torch.zeros((2, 3, rows, 1500), dtype=torch.int8)
    elif case == "heads-apart":  # a head slice of a wider buffer
        k = v = torch.zeros((2, 5, rows, 1504), dtype=torch.int8)[:, :3, :, :1500]
    else:
        k = v = torch.zeros((2, 3, rows, 3000), dtype=torch.int8)[..., ::2]
    with pytest.raises(ValueError, match="pitch"):
        att._slab_pitch("k3", (k, v))


@pytest.mark.parametrize("tk", [1500, 1536, 301, 256])
def test_int4_load_path(tk):
    """Packed int4 rows take TMA at tma_pitch (one byte per position, as
    int8) and on contiguous rows whose Tk is a multiple of 16; covers
    otherwise, or where a base is off a 16-byte boundary."""
    pitch = att.tma_pitch(tk)
    padded = _padded(2, 3, tk, pitch, 32)
    ld = att._slab_pitch("k6", (padded, padded))
    assert ld == pitch and att.decode_cross_load_path(ld, 0x7F0000000000) == "tma"
    contiguous = torch.zeros((2, 3, 32, tk), dtype=torch.int8)
    ld = att._slab_pitch("k6", (contiguous, contiguous))
    assert att.decode_cross_load_path(ld, 0x7F0000000000, 0x7F0000001000) == (
        "tma" if tk % 16 == 0 else "cp.async")
    assert att.decode_cross_load_path(pitch, 0x7F0000000004) == "cp.async"


FIELDS = dict(name="test-narrow-q8", n_mels=80, n_audio_ctx=64, n_audio_state=128,
              n_audio_head=2, n_audio_layer=2, n_vocab=51865, n_text_ctx=64,
              n_text_state=128, n_text_head=2, n_text_layer=2)
JCFG = jcfg.WhisperConfig(**FIELDS)
TCFG = tcfg.WhisperConfig(**FIELDS)
AUDIO_T = 1500  # the stock encoder length: rows of 1500 bytes pad to 1504


@pytest.fixture(scope="module")
def trees():
    """Numpy-drawn weights for a narrow Whisper (Dh 64, 2+2 layers), the
    reference's tree carried across with params_from_jax, and an encoder
    output of AUDIO_T positions."""
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
    xa = rng.standard_normal((2, AUDIO_T, JCFG.n_audio_state)).astype(np.float32)
    return jp, params_from_jax(jp), xa


def test_cross_kv_int8_rows_padded_and_equal_to_reference(trees):
    jp, tp, xa = trees
    ref = jmod.precompute_cross_kv_q8(jp, jnp.asarray(xa), JCFG)
    got = tmod.precompute_cross_kv_quant(tp, torch.from_numpy(xa), TCFG,
                                         tquant.quantize_kv)
    for g, r in zip(got, ref):
        qw = g["qw"]
        assert qw.shape == (2, 2, 2, 64, AUDIO_T)
        assert qw.stride()[-2:] == (1504, 1) and qw.stride(-2) % 16 == 0
        assert qw.stride()[:3] == (2 * 2 * 64 * 1504, 2 * 64 * 1504, 64 * 1504)
        assert g["scale"].is_contiguous()
        for layer in range(2):  # the view K3 is handed: TMA-addressable
            view = qw[layer]
            ld = att._slab_pitch("k3", (view, view))
            assert att.decode_cross_load_path(ld, 0x7f0000000000) == "tma"
        # As tests/test_torch_quant.py: f32 summation order can flip a code
        # on a rounding tie by one; scales to f32 rounding.
        diff = np.abs(qw.numpy().astype(np.int16)
                      - np.asarray(r["qw"]).astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(r["scale"]),
                                   rtol=1e-5)


def test_cross_kv_int4_rows_padded_and_equal_to_reference(trees):
    """The packed int4 "qw4" is stored as the int8 "qw" is: rows
    tma_pitch(T) bytes apart (1504 for 1500), views of the logical [L, B,
    H, 32, T] that K6 loads by TMA, whose codes are the JAX package's
    quantize_kv_int4 bytes of the same projections."""
    jp, tp, xa = trees
    ck_j, cv_j = jmod.precompute_cross_kv(jp, jnp.asarray(xa), JCFG)
    ref = (jquant.quantize_kv_int4(ck_j), jquant.quantize_kv_int4(cv_j))
    got = tmod.precompute_cross_kv_quant(tp, torch.from_numpy(xa), TCFG,
                                         tquant.quantize_kv_int4)
    for g, r in zip(got, ref):
        qw = g["qw4"]
        assert qw.shape == (2, 2, 2, 32, AUDIO_T)
        assert qw.stride() == (2 * 2 * 32 * 1504, 2 * 32 * 1504, 32 * 1504, 1504, 1)
        assert g["scale"].is_contiguous()
        for layer in range(2):
            view = qw[layer]
            ld = att._slab_pitch("k6", (view, view))
            assert att.decode_cross_load_path(ld, 0x7f0000000000) == "tma"
        # As tests/test_torch_quant.py: f32 summation order can flip a code
        # on a rounding tie by one; scales to f32 rounding.
        diff = np.abs(tquant.unpack_kv_int4(qw).numpy().astype(np.int16)
                      - np.asarray(jquant.unpack_kv_int4(r["qw4"])).astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(r["scale"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("max_tokens", [10])
def test_int8_greedy_tokens_unchanged_by_the_padded_rows(trees, max_tokens, bits,
                                                         monkeypatch):
    """Greedy decoding with the int8 or packed int4 cross-K/V: the port's
    tokens on the padded rows equal those on contiguous rows and the
    reference's (greedy_decode with quant_kv_bits of the same width)."""
    jp, tp, xa = trees
    ref = jdec.greedy_decode(jp, jnp.asarray(xa), JCFG, jdec.DecodeOptions(
        language="en", max_tokens=max_tokens, quant_kv=True, quant_kv_bits=bits))
    opts = tdec.DecodeOptions(language="en", max_tokens=max_tokens, quant_kv=True,
                              quant_kv_bits=bits)
    padded = tdec.greedy_decode(tp, torch.from_numpy(xa), TCFG, opts)
    monkeypatch.setattr(tmod, "_cross_kv_buffer",
                        lambda key, a, n: a.new_empty((n, *a.shape)))
    contiguous = tdec.greedy_decode(tp, torch.from_numpy(xa), TCFG, opts)
    assert torch.equal(padded["tokens"], contiguous["tokens"])
    np.testing.assert_array_equal(padded["tokens"].numpy(), np.asarray(ref["tokens"]))
