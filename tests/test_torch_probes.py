"""The port's probes (spittle_tpu_torch.probes) and their kernels' plain
versions against the reference's probe scripts on the CPU.

scripts/bench_decode_cross.py and scripts/bench_cache_dus.py are loaded by
path (their main()s are not run): K11's plain version is held against
`mh_q8` under pltpu.force_tpu_interpret_mode(), K12's and K13's against
`alias_col_write_sub` and `alias_col_write`, which interpret on the CPU
by themselves. Both scripts set JAX's compilation cache directory when
they are imported; the loader puts the setting back. Inputs are
numpy-seeded; each tolerance says why.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spittle_tpu.ops.quant import quantize_kv as jquantize_kv
from spittle_tpu_torch.ops import attention as tatt
from spittle_tpu_torch.ops import cache_write as cw
from spittle_tpu_torch.ops.quant import quantize_kv
from spittle_tpu_torch.probes import cache_dus, decode_cross, decode_cross_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    """scripts/<name>.py as a module, with the JAX settings it changes on
    import restored."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def cross_script():
    return _load_script("bench_decode_cross")


@pytest.fixture(scope="module")
def dus_script():
    return _load_script("bench_cache_dus")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K11: mh_q8
# ---------------------------------------------------------------------------


def _mh_inputs(b, h, t, r, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, r, 64)) * 64 ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, h, 64, t)).astype(np.float32)
    v = rng.standard_normal((b, h, 64, t)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("t,kv_len", [(256, 200), (256, 256), (384, 129)])
def test_mh_plain_matches_pallas_interpret(cross_script, r, t, kv_len):
    b, h = 2, 2
    q, k, v = _mh_inputs(b, h, t, r, seed=r)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    jk, jv = (jquantize_kv(jnp.asarray(x)) for x in (k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = cross_script.mh_q8(jq, jk["qw"], jk["scale"], jv["qw"],
                                 jv["scale"], kv_len=kv_len)
    tk, tv = (quantize_kv(_t(x)) for x in (k, v))
    # The two quantizers give the same bytes (tests/test_torch_quant.py).
    np.testing.assert_array_equal(tk["qw"].numpy(), np.asarray(jk["qw"]))
    got = tatt.decode_cross_attention_q8_mh(
        _t(q).to(torch.bfloat16), tk["qw"], tk["scale"], tv["qw"], tv["scale"],
        kv_len=kv_len)
    assert got.shape == (b, h, r, 64) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    # The same function step by step (f32 scores of exact widened values,
    # the mask before the max, bf16(p * vs), one division): exp's last bit
    # and the summation order move the f32 result by ~1e-7 relative, which
    # can cross one bf16 rounding boundary of the output: one bf16 ulp.
    assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("b,h,t,r,kv_len", [
    (2, 4, 300, 2, 257),   # a chunk of one position past 256
    (1, 20, 300, 1, 300),  # the probe's head count, kv_len = Tk
    (2, 3, 129, 8, 1),     # an odd head count, a single live position
    (3, 1, 256, 3, 255),   # one head
    (1, 6, 520, 5, 513),
    (2, 2, 64, 4, None),   # kv_len left to default to Tk
])
def test_mh_function_is_k3s(b, h, t, r, kv_len):
    """K11 computes K3's function: on the CPU both wrappers take the same
    plain version, for any head count, and the slab view [B, H*64, Tk] is
    a view of K3's operand."""
    q, k, v = _mh_inputs(b, h, t, r, seed=4 + h)
    tk, tv = (quantize_kv(_t(x)) for x in (k, v))
    args = (_t(q).to(torch.bfloat16), tk["qw"], tk["scale"], tv["qw"], tv["scale"])
    base = tatt.decode_cross_attention_q8(*args, kv_len=kv_len)
    got = tatt.decode_cross_attention_q8_mh(*args, kv_len=kv_len)
    assert got.shape == (b, h, r, 64) and torch.equal(got, base)
    slab = tk["qw"].view(b, h * 64, t)
    assert slab.data_ptr() == tk["qw"].data_ptr() and slab.is_contiguous()


# ---------------------------------------------------------------------------
# K12 and K13: the aliased column writes
# ---------------------------------------------------------------------------


def _bf16(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16)


def _to_torch(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


def _same_bits(t, j):
    return np.array_equal(t.view(torch.int16).numpy(),
                          np.asarray(jax.lax.bitcast_convert_type(j, jnp.int16)))


@pytest.mark.parametrize("pos", [0, 5, 127])
def test_col_write_plain_matches_pallas(dus_script, pos):
    """K13's plain version against alias_col_write, bit for bit: rows a
    multiple of 8 and ctx 128, as the TPU form needs."""
    rng = np.random.default_rng(20 + pos)
    shape = (2, 2, 2, 2, 8, 128)  # [L, 2, B, H, Dh, ctx]: 8 rows of 16
    cache, cols = _bf16(rng, shape), _bf16(rng, shape[:-1])
    ref = dus_script.alias_col_write(cache, cols, jnp.int32(pos))
    tc = _to_torch(cache)
    got = cw.alias_col_write(tc, _to_torch(cols), torch.tensor(pos, dtype=torch.int32))
    assert got is tc  # in place
    assert _same_bits(got, ref)


@pytest.mark.parametrize("pos", [0, 5, 127])
def test_col_write_sub_plain_matches_pallas(dus_script, pos):
    """K12's plain version against alias_col_write_sub, bit for bit."""
    rng = np.random.default_rng(30 + pos)
    cache, cols = _bf16(rng, (16, 128, 128)), _bf16(rng, (16, 128))
    ref = dus_script.alias_col_write_sub(cache, cols, jnp.int32(pos))
    tc = _to_torch(cache)
    got = cw.alias_col_write_sub(tc, _to_torch(cols),
                                 torch.tensor(pos, dtype=torch.int32))
    assert got is tc
    assert _same_bits(got, ref)


@pytest.mark.parametrize("pos", [-1, 16, 400])
def test_col_write_out_of_range_writes_nothing(pos):
    cache = torch.arange(4 * 16, dtype=torch.float32).reshape(4, 16).to(torch.bfloat16)
    keep = cache.clone()
    p = torch.tensor(pos, dtype=torch.int32)
    assert torch.equal(cw.alias_col_write(cache, cache[:, 0].clone(), p), keep)
    sub = cache.reshape(2, 16, 2).clone()
    keep_sub = sub.clone()
    assert torch.equal(cw.alias_col_write_sub(sub, sub[:, 0].clone(), p), keep_sub)


# ---------------------------------------------------------------------------
# The probes' main()s at a small size on the CPU
# ---------------------------------------------------------------------------


def test_decode_cross_probe_runs_every_variant():
    lines = []
    recs = decode_cross.main(device="cpu", b=2, h=4, t=96, kv_len=70, rows=1,
                             n_iter=1, out=lines.append)
    assert [json.loads(x) for x in lines] == recs
    names = [r["variant"] for r in recs[:-1]]
    assert names == ["plain-bf16", "k4-bf16", "plain-int8", "k3-int8",
                     "k11-int8-mh"]
    # A CPU run reports its host clock, never a device time or rate.
    for r in recs[:-1]:
        assert r["device"] == "cpu" and r["host_ms"] > 0
        assert "ms" not in r and "eff_GBps" not in r
    assert recs[-1]["k11_vs_plain_int8_maxerr"] == 0.0


def test_decode_cross_probe_variants_agree():
    """The int8 variants compute one function, and the bf16 ones another,
    close to it: K/V quantization error only."""
    q, k, v, qk, qv = decode_cross.make_inputs(torch.device("cpu"), b=2, h=3,
                                               t=160, rows=2)
    runs = decode_cross.variants(q, k, v, qk, qv, 130)
    out = {name: fn().float() for name, (fn, _) in runs.items()}
    assert torch.equal(out["k3-int8"], out["plain-int8"])
    assert torch.equal(out["k11-int8-mh"], out["plain-int8"])
    assert torch.equal(out["k4-bf16"], out["plain-bf16"])
    assert (out["plain-int8"] - out["plain-bf16"]).abs().max() < 0.05
    assert runs["k3-int8"][1] * 2 == runs["k4-bf16"][1] == 2 * 2 * 3 * 64 * 160 * 2


def test_cache_dus_probe_runs_every_variant():
    lines = []
    recs = cache_dus.main(device="cpu", l=2, b=2, h=2, dh=8, ctx=16, steps=20,
                          reps=1, out=lines.append)
    assert [json.loads(x) for x in lines] == recs
    assert recs[0]["ctx"] == 16 and recs[0]["steps"] == 20
    assert recs[0]["cache_gb"] == 2 * 2 * 2 * 2 * 8 * 16 * 2 / 1e9
    assert tuple(r["variant"] for r in recs[1:]) == cache_dus.VARIANTS
    for r in recs[1:]:
        assert r["device"] == "cpu" and r["host_ms_per_step"] > 0
        assert "ms_per_step" not in r and "eff_read_GBps" not in r


@pytest.mark.parametrize("pair", [("read+index", "read+k13"),
                                  ("read+index-sub", "read+k12-sub")])
def test_cache_dus_kernel_variant_equals_indexed_write(pair):
    """The kernel variant of each layout lands the same columns as the
    indexed assignment: the same acc and the same cache after the run."""
    dev = torch.device("cpu")
    finals = []
    for name in pair:
        cache, cache_sub = cache_dus.make_cache(dev, 2, 2, 2, 8, 16)
        acc = cache_dus.steps_fn(name, cache, cache_sub, 20)()
        finals.append((acc, cache, cache_sub))
    assert torch.equal(finals[0][0], finals[1][0])
    assert torch.equal(finals[0][1], finals[1][1])
    assert torch.equal(finals[0][2], finals[1][2])
    fresh = cache_dus.make_cache(dev, 2, 2, 2, 8, 16)
    changed = fresh[1] if pair[0].endswith("-sub") else fresh[0]
    assert not torch.equal(changed, finals[0][2 if pair[0].endswith("-sub") else 1])


def test_cache_layouts_hold_the_same_values():
    cache, cache_sub = cache_dus.make_cache(torch.device("cpu"), 2, 2, 3, 8, 16)
    assert cache.shape == (2, 2, 2, 3, 8, 16) and cache_sub.shape == (8, 16, 24)
    back = cache_sub.reshape(2, 2, 2, 16, 3, 8).permute(0, 1, 2, 4, 5, 3)
    assert torch.equal(back, cache)


@pytest.mark.parametrize("name", ["decode_cross_host", "q8_parts", "step_profile",
                                  "w8a8_cluster", "w8a8_cross_parts",
                                  "fullkv_bwd_parts", "train_profile"])
def test_card_only_probes_raise_without_a_card(name):
    """The probes that time host submission, K7's parts, a profiled turbo
    leg, K14's plans and parts, K15's passes, or a profiled train step run
    only on a card, and say so."""
    if torch.cuda.is_available():
        return
    probe = importlib.import_module(f"spittle_tpu_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        probe.main()


@pytest.mark.parametrize("dtype,tk,pitch", [(torch.bfloat16, 1500, 1504),
                                            (torch.bfloat16, 255, 256),
                                            (torch.int8, 1500, 1504),
                                            (torch.int8, 255, 256)])
def test_host_probe_pitched_rows(dtype, tk, pitch):
    """decode_cross_host's padded layout: the values of x in rows a
    multiple of 16 bytes apart, as a view of x's shape, which K3/K4's
    pitch check takes."""
    x = (torch.arange(2 * 3 * 64 * tk) % 100).reshape(2, 3, 64, tk).to(dtype)
    got = decode_cross_host._pitched(x)
    assert got.shape == x.shape and torch.equal(got, x)
    assert got.stride() == (3 * 64 * pitch, 64 * pitch, pitch, 1)
    assert tatt._slab_pitch("probe", (got, got)) == pitch


def test_probes_need_a_card_by_default():
    if torch.cuda.is_available():
        return  # with a card the default runs there (chip_smoke.py does)
    for probe in (decode_cross, cache_dus):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe.main()


def test_bwd_parts_edits_match_source():
    """Every edit fullkv_bwd_parts makes to K15's source finds its text
    there as often as it is applied, so the copies it times are the
    source with only that edit."""
    from spittle_tpu_torch.ops import _build
    from spittle_tpu_torch.probes import fullkv_bwd_parts as parts

    text = (_build.CSRC / parts.SOURCE).read_text()
    for name, edits in parts.VARIANTS.items():
        for old in {old for old, _ in edits}:
            assert text.count(old) >= sum(o == old for o, _ in edits), (name, old)
