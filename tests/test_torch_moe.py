"""The port's MoE feed-forward (spittle_tpu_torch/parallel/expert_parallel.py)
and MoE Whisper encoder against the JAX package on the CPU: moe_ffn's
output, aux loss, expert counts and drops at two capacity factors (one
that drops tokens) in f32 and bf16, one expert against the dense FFN,
random_params' MoE tree against init_params', encode and encode_with_aux
on a carried tiny MoE tree, and a tiny MoE engine's tokens against the JAX
engine's. moe_ffn under a mesh is held in tests/test_torch_mesh.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.config import CONFIGS as JCONFIGS
from spittle_tpu.parallel import expert_parallel as jep
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.config import CONFIGS
from spittle_tpu_torch.models.whisper.weights import params_from_jax, random_params
from spittle_tpu_torch.ops.quant import quantize_whisper_encoder_w8a8
from spittle_tpu_torch.parallel import expert_parallel as tep

N, D, F, E = 256, 32, 64, 4
TRAINED_TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                            "trained_tiny", "params.npz")
TINY_MOE = dataclasses.replace(CONFIGS["tiny"], name="tiny-moe", moe_experts=4)
JTINY_MOE = dataclasses.replace(JCONFIGS["tiny"], name="tiny-moe", moe_experts=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Beside the other test workers, more intra-op threads oversubscribe.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _moe_inputs(dtype, seed=0):
    """init_moe_params' tree and N tokens leaning to expert 0 (so that a
    capacity factor of 1.25 drops tokens)."""
    p = tep.init_moe_params(D, F, E, dtype=dtype, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((N, D)).astype(np.float32)
    lean = p["router_w"][:, 0].numpy()
    x += 0.4 * lean / np.linalg.norm(lean) * np.sqrt(D)
    return p, x


def _to_jax(p, jdtype):
    return {k: jnp.asarray(v.float().numpy()).astype(
        jnp.float32 if k == "router_w" else jdtype) for k, v in p.items()}


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_moe_ffn_matches_reference(dtype, jdtype, cf):
    p, x = _moe_inputs(dtype)
    out, aux = tep.moe_ffn(p, torch.from_numpy(x).to(dtype), capacity_factor=cf)
    jout, jaux = jep.moe_ffn(_to_jax(p, jdtype), jnp.asarray(x).astype(jdtype),
                             capacity_factor=cf)
    ref = np.asarray(jout.astype(jnp.float32))
    assert out.dtype == dtype
    np.testing.assert_array_equal(aux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    assert float(aux["dropped"]) == float(jaux["dropped"])
    if cf == 1.25:
        assert float(aux["dropped"]) > 0  # the capacity bites
    # The router is f32 in both: the aux loss to f32 rounding.
    np.testing.assert_allclose(float(aux["aux_loss"]), float(jaux["aux_loss"]),
                               rtol=1e-6)
    # Dropped tokens are exactly 0 in both.
    np.testing.assert_array_equal(out.float().numpy() == 0, ref == 0)
    err = np.abs(out.float().numpy() - ref).max()
    # f32: the same products in another order. bf16: both expert products
    # and the GELU round to bf16 (torch and XLA round the GELU's inside
    # differently), within two bf16 ulps of the largest output.
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -8 * np.abs(ref).max()
    assert err <= tol, (err, tol)


def test_one_expert_is_the_dense_ffn():
    p = tep.init_moe_params(D, F, 1, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (N, D)).astype(np.float32))
    out, aux = tep.moe_ffn(p, x, capacity_factor=1.0)
    dense = torch.nn.functional.gelu(x @ p["w_in"][0], approximate="none") @ p["w_out"][0]
    assert float(aux["dropped"]) == 0 and float(aux["aux_loss"]) == 1.0
    torch.testing.assert_close(out, dense, rtol=0, atol=1e-6)
    torch.testing.assert_close(tep.moe_ffn_dense_reference(p, x), dense,
                               rtol=0, atol=1e-6)
    jref = jep.moe_ffn_dense_reference(_to_jax(p, jnp.float32), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=0, atol=1e-5)


def test_random_params_moe_tree_matches_init_params():
    ours = random_params(TINY_MOE, seed=0)
    ref = jax.eval_shape(lambda: jmod.init_params(JTINY_MOE))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       ours)
    assert got == shapes
    enc = ours["encoder"]["blocks"]
    assert not any(k.startswith(("fc1_", "fc2_")) for k in enc)
    assert enc["moe_router"].dtype == torch.float32
    assert tuple(enc["moe_w_in"].shape) == (4, 4, 384, 1536)
    assert "fc1_w" in ours["decoder"]["blocks"]  # the decoder stays dense
    # W8A8 quantization leaves the experts float (no fc1_w/fc2_w to take).
    q = quantize_whisper_encoder_w8a8(ours)["encoder"]["blocks"]
    assert set(q["wq"]) == {"qw8", "scale"}
    assert torch.equal(q["moe_w_in"], enc["moe_w_in"])


@pytest.fixture(scope="module")
def carried():
    """The JAX init_params tree of tiny with 4 experts, and the port's
    copy (params_from_jax)."""
    jparams = jmod.init_params(JTINY_MOE, jax.random.PRNGKey(3))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def test_encode_matches_reference_on_a_carried_moe_tree(carried):
    """The parent tree died here with KeyError: 'fc1_w'."""
    jparams, tparams = carried
    mel = np.random.default_rng(7).standard_normal((3, 80, 400)).astype(np.float32)
    ref = np.asarray(jmod.encode(jparams, jnp.asarray(mel), JTINY_MOE))
    jx, jaux = jmod.encode_with_aux(jparams, jnp.asarray(mel), JTINY_MOE)
    got = tmod.encode(tparams, torch.from_numpy(mel), TINY_MOE).numpy()
    x, aux = tmod.encode_with_aux(tparams, torch.from_numpy(mel), TINY_MOE)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(x.numpy(), got)
    # Summed over the 4 layers (f32 router and softmax in both).
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_block_matches_reference(carried):
    """One MoE encoder block of the carried tree: _moe_mlp and
    encoder_block_body_aux against the reference's, and encoder_block_body
    as the latter's h; a dense block reports no aux loss."""
    jparams, tparams = carried
    x = np.random.default_rng(8).standard_normal((2, 24, 384)).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], jparams["encoder"]["blocks"])
    tblk = tmod.layer_params(tparams["encoder"]["blocks"], 0)
    ref = np.asarray(jmod._moe_mlp(jnp.asarray(x), jblk))
    np.testing.assert_allclose(tmod._moe_mlp(torch.from_numpy(x), tblk).numpy(),
                               ref, rtol=0, atol=1e-5)
    jh, jaux = jmod.encoder_block_body_aux(jnp.asarray(x), jblk, 6)
    h, aux = tmod.encoder_block_body_aux(torch.from_numpy(x), tblk, 6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_array_equal(
        tmod.encoder_block_body(torch.from_numpy(x), tblk, 6).numpy(), h.numpy())
    dense = tmod.layer_params(tparams["decoder"]["blocks"], 0)
    assert tmod.encoder_block_body_aux(torch.from_numpy(x), dense, 6)[1] is None


def test_moe_engine_tokens_match_reference(carried, tmp_path):
    """A tiny MoE engine (the carried tree, saved once) against the JAX
    engine on the same file: tokens and text of parallel windows."""
    jparams, _ = carried
    flat = {"param:" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat["__config__"] = np.frombuffer(
        json.dumps(dataclasses.asdict(JTINY_MOE)).encode(), np.uint8)
    with np.load(TRAINED_TINY) as z:  # a token table for both engines
        flat["__vocab__"] = z["__vocab__"]
    path = str(tmp_path / "tiny_moe.npz")
    np.savez(path, **flat)
    rng = np.random.default_rng(8)
    audio = [(0.1 * rng.standard_normal(16000 * s)).astype(np.float32)
             for s in (3, 7)]
    port = WhisperEngine(device="cpu")
    port.load_model(path)
    ref_eng = JaxEngine()
    ref_eng.load_model(path)
    kw = dict(language="en", condition_on_previous_text=False,
              temperatures=(0.0,), parallel_windows=True, max_tokens=16)
    got = port.transcribe_batch(audio, TranscribeParams(**kw))
    ref = ref_eng.transcribe_batch(audio, JParams(**kw))
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert all(r.tokens for r in got)  # something was decoded
    assert [r.text for r in got] == [r.text for r in ref]
    assert "moe_w_in" in port.params["encoder"]["blocks"]
