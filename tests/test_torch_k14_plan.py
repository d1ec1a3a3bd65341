"""K14's launch plan (spittle_tpu_torch/ops/attention.py:w8a8_plan) on the
CPU: at every shape of the card tests' _K14_CASES, chip_smoke's K14
shapes and the engines' (T 1500 on rows of 1504, T 6000, the trained tiny
checkpoint's T 96 at Dh 8; R 1, 4, 8, 13, 228; T 13000 to 45000, where K
and V are streamed), the ranks' slices tile [0, T) exactly from aligned
starts, the cluster is a power of two up to 8, the CTA's shared memory
fits the budget and is the kernel's layout, and the regime follows R and
Dh while K and V fit, streamed __dp4a past that. On tensors that are not on the CPU
(meta tensors here, with the kernel library replaced by a recorder), the
wrapper raises ValueError for shapes the kernel cannot take and never
calls the plain version; a shape it can take reaches the C entry once
with the plan's numbers.
"""

import pytest
import torch

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att

# (T, R, Dh)
SHAPES = sorted({
    # tests/test_torch_kernels_cuda.py:_K14_CASES
    (1500, 1, 64), (1500, 4, 64), (1500, 8, 64), (1500, 228, 64), (1500, 3, 64),
    (301, 5, 64), (96, 13, 8), (6000, 9, 64), (1500, 64, 64), (1500, 65, 64),
    (1500, 16, 8),
    # the engines': the decoder's steps, verifies and prefills at T 1500 and
    # at the long window's 6000; the trained tiny checkpoint at Dh 8
    (1504, 1, 64), (1504, 228, 64), (6000, 1, 64), (6000, 4, 64), (6000, 8, 64),
    (6000, 13, 64), (6000, 228, 64), (96, 1, 8), (96, 4, 8), (96, 8, 8),
    (96, 228, 8), (1500, 13, 64),
    # long K/V: streamed past what a slice of K and V fits (the card tests'
    # T 45000 at R 1 and 228, and an odd T read byte by byte)
    (45000, 1, 64), (45000, 228, 64), (20001, 3, 64), (13000, 8, 64), (8000, 228, 64),
    (45000, 4, 256),
})


def _id(shape):
    return "T{}-R{}-dh{}".format(*shape)


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_slices_tile_t(shape):
    tk, r, dh = shape
    plan = att.w8a8_plan(tk, r, dh)
    gran = 32 if plan.mma else 16
    assert plan.slice % gran == 0
    # Rank c takes [c * slice, (c + 1) * slice) of T (the kernel's t0 and n).
    spans = [(min(c * plan.slice, tk), min((c + 1) * plan.slice, tk))
             for c in range(plan.cluster)]
    assert len(spans) == plan.cluster
    assert spans[0][0] == 0 and spans[-1][1] == tk
    for c, (t0, t1) in enumerate(spans):
        assert t0 <= t1 <= t0 + plan.slice
        if c:
            assert t0 == spans[c - 1][1]
        if t1 > t0:
            assert t0 == c * plan.slice and t0 % gran == 0
    assert spans[0][1] > 0


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_cluster_in_range(shape):
    tk, r, dh = shape
    plan = att.w8a8_plan(tk, r, dh)
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= att.W8A8_MAX_CLUSTER
    # Each rank but the first has W8A8_MIN_SLICE positions of T at least.
    assert plan.cluster == 1 or tk >= plan.cluster * att.W8A8_MIN_SLICE
    if tk >= att.W8A8_MAX_CLUSTER * att.W8A8_MIN_SLICE:
        assert plan.cluster == att.W8A8_MAX_CLUSTER


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_shared_memory_fits(shape):
    tk, r, dh = shape
    plan = att.w8a8_plan(tk, r, dh)
    assert plan.smem == att.w8a8_smem_bytes(plan.mma, plan.slice, plan.row_tile, dh,
                                             plan.cluster, plan.stream)
    assert 0 < plan.smem <= att.W8A8_SMEM_BUDGET
    # The scores of every row of the tile over the slice are in it, with
    # both scale slices, and K and V's slices unless they are streamed.
    kv = 0 if plan.stream else 2 * dh * plan.slice
    assert plan.smem >= plan.row_tile * plan.slice * 4 + 8 * plan.slice + kv


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_regime_follows_rows_and_head_dim(shape):
    tk, r, dh = shape
    plan = att.w8a8_plan(tk, r, dh)
    mma = r > 8 and dh % 32 == 0
    assert plan.mma == (mma and not plan.stream)
    assert not (plan.mma and plan.stream)
    assert plan.regime == ("mma" if plan.mma else "dp4a_stream" if plan.stream else "dp4a")
    # Streamed only where the regime's smallest tile, K and V held, does
    # not fit.
    gran = 32 if mma else 16
    slice_ = -(-(-(-tk // plan.cluster)) // gran) * gran
    held = att.w8a8_smem_bytes(mma, slice_, 16 if mma else 1, dh, plan.cluster)
    assert plan.stream == (held > att.W8A8_SMEM_BUDGET)
    if plan.mma:
        assert plan.row_tile in (16, 32, 64)
    else:
        assert 1 <= plan.row_tile <= min(r, 8)
    assert plan.row_tiles(r) * plan.row_tile >= r > (plan.row_tiles(r) - 1) * plan.row_tile


def test_plan_at_the_decoder_shapes():
    """large-v3's decode step and prefill at T 1500: clusters of 8 ranks
    of 192 positions, a step's row in one CTA, a prefill in tiles of 64
    on the tensor cores; the trained tiny checkpoint (Dh 8) in row tiles
    of 8 on __dp4a."""
    assert att.w8a8_plan(1500, 1, 64)[:4] == (False, 8, 192, 1)
    assert att.w8a8_plan(1500, 228, 64)[:4] == (True, 8, 192, 64)
    assert att.w8a8_plan(96, 13, 8)[:4] == (False, 1, 96, 8)
    assert att.w8a8_plan(6000, 9, 64)[:4] == (True, 8, 768, 16)
    assert att.w8a8_plan(45000, 1, 64)[:4] == (False, 8, 5632, 1)
    assert att.w8a8_plan(45000, 228, 64)[:4] == (False, 8, 5632, 6)
    assert att.w8a8_plan(45000, 1, 64).stream and att.w8a8_plan(45000, 228, 64).stream


@pytest.fixture
def recorder(monkeypatch):
    """The kernel library replaced by a recorder of C calls, the stream by
    0, and the plain version by a failure."""
    calls = []

    class Lib:
        def spt_decode_cross_attention_w8a8(self, *args):
            calls.append(args)
            return 0

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a tensor off the CPU")

    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(att, "decode_cross_attention_w8a8_plain", plain)
    return calls


def _meta(b, h, r, dh, t, pitch=None, dtype=torch.bfloat16):
    q = torch.empty((b, h, r, dh), dtype=dtype, device="meta")
    kv = torch.empty((b, h, dh, pitch or t), dtype=torch.int8, device="meta")[..., :t]
    sc = torch.empty((b, h, t), dtype=torch.float32, device="meta")
    return q, kv, sc, kv, sc


_UNFIT = {
    "dh62": ((1, 2, 3, 62, 100), {}, "multiple of 4"),
    "dh260": ((1, 2, 3, 260, 100), {}, "multiple of 4"),
    "T150000": ((1, 2, 3, 64, 150000), {}, "shared memory"),
    "BH65536": ((65536, 1, 1, 64, 16), {}, "65535"),
    "kv_len0": ((1, 2, 3, 64, 100), dict(kv_len=0), "kv_len"),
    "kv_len_past_T": ((1, 2, 3, 64, 100), dict(kv_len=101), "kv_len"),
}


@pytest.mark.parametrize("case", list(_UNFIT))
def test_unfit_shapes_raise_off_the_cpu(recorder, case):
    shape, kw, match = _UNFIT[case]
    before = att.decode_cross_attention_w8a8.launches
    with pytest.raises(ValueError, match=match):
        att.decode_cross_attention_w8a8(*_meta(*shape), **kw)
    assert recorder == []
    assert att.decode_cross_attention_w8a8.launches == before


def test_mismatched_kv_raises_off_the_cpu(recorder):
    q, k, ks, v, vs = _meta(1, 2, 3, 64, 100)
    with pytest.raises(ValueError, match="K/V must be"):
        att.decode_cross_attention_w8a8(q, k[..., :99], ks, v, vs)
    assert recorder == []


@pytest.mark.parametrize("t, r", [(1500, 1), (1500, 4), (1500, 228), (45000, 1),
                                  (45000, 228)])
def test_fit_shape_reaches_the_entry_with_the_plan(recorder, t, r):
    """B 8, H 20 on rows 4 bytes past T: one C call, whose arguments are
    the signature's count and carry the plan (the C entry lays out the
    shared memory itself) and the row pitch."""
    before = att.decode_cross_attention_w8a8.launches
    out = att.decode_cross_attention_w8a8(*_meta(8, 20, r, 64, t, pitch=t + 4))
    assert out.shape == (8, 20, r, 64) and out.dtype == torch.bfloat16
    assert att.decode_cross_attention_w8a8.launches == before + 1
    (args,) = recorder
    assert len(args) == len(_build.SIGNATURES["spt_decode_cross_attention_w8a8"])
    plan = att.w8a8_plan(t, r, 64)
    b, h, rr, dh, tk, kv_len, mma, cluster, slice_, row_tile, stream, bf16 = args[6:18]
    assert (b, h, rr, dh, tk, kv_len, bf16) == (8, 20, r, 64, t, t, 1)
    assert (bool(mma), cluster, slice_, row_tile, bool(stream)) == \
        (plan.mma, plan.cluster, plan.slice, plan.row_tile, plan.stream)
    assert args[23] == t + 4 and args[26] == t + 4  # k_ld, v_ld
