"""The port's mesh layer (spittle_tpu_torch/parallel/{mesh, multihost,
pipeline_parallel, expert_parallel, serving, dryrun}.py) against the JAX
package on the CPU.

whisper_param_specs is compared in-process. Everything else runs once, in
one gloo group of 4 ranks spawned for this module
(parallel/dryrun.py's workers, one intra-op thread each, fed the JAX
package's weights and inputs), and its results are held here to the JAX
package's under the same mesh on conftest's 8 CPU devices:
make_mesh(4, tp=2) for dp + tp encode and greedy decode, the shard shapes,
moe_ffn under dp x ep and one train step (sequence parallelism, remat); a
data-only mesh of 4 for serving. The same group saves and restores a
sharded tree's checkpoint, held to an unbroken run of the port itself.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.decode import DecodeOptions as JOpts
from spittle_tpu.models.whisper.decode import greedy_decode as jgreedy
from spittle_tpu.ops import quant as jquant
from spittle_tpu.parallel import expert_parallel as jep
from spittle_tpu.parallel import mesh as jmesh
from spittle_tpu.parallel.serving import BatchingTranscriptionServer as JServer
from spittle_tpu.train import step as jstep
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import quant as tquant
from spittle_tpu_torch.parallel import dryrun
from spittle_tpu_torch.parallel import mesh as tmesh
from spittle_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "data", "trained_tiny", "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

CFG = jcfg.WhisperConfig(**dryrun.DRYRUN_CFG)
MOE_CFG = jcfg.WhisperConfig(**{**dryrun.DRYRUN_CFG, **dict(
    name="tiny-moe", n_audio_ctx=1500, n_audio_state=384, n_audio_head=6,
    n_audio_layer=4, n_vocab=51865, n_text_ctx=448, n_text_state=384,
    n_text_head=6, n_text_layer=4, moe_experts=4)})
WORLD = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _jflat(tree):
    """{"a/b": leaf} of a JAX tree whose leaves may be PartitionSpecs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(k.key for k in path): leaf for path, leaf in leaves}


# -- the sharding rules, in-process -------------------------------------------


@pytest.mark.parametrize("form", ["float", "int8 decoder", "w8a8 encoder"])
def test_param_specs_match_reference(form):
    jparams = jmod.init_params(CFG, jax.random.PRNGKey(0))
    tparams = params_from_jax(_np(jparams))
    if form == "int8 decoder":
        jparams = jquant.quantize_whisper_decoder(jparams)
        tparams = tquant.quantize_whisper_decoder(tparams)
    elif form == "w8a8 encoder":
        jparams = jquant.quantize_whisper_encoder_w8a8(jparams)
        tparams = tquant.quantize_whisper_encoder_w8a8(tparams)
    ref = {k: tuple(v) for k, v in _jflat(jmesh.whisper_param_specs(jparams)).items()}
    got = {k: tuple(v) for k, v in _flat(tmesh.whisper_param_specs(tparams)).items()}
    assert got == ref
    # A quantized weight stays whole; the float bias beside it is split.
    if form != "float":
        side = "decoder" if form == "int8 decoder" else "encoder"
        assert got[f"{side}/blocks/wq/scale"] == ()
        assert got[f"{side}/blocks/bq"] == (None, "model")


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


def test_importing_dryrun_starts_no_group():
    code = ("import torch.distributed as d, spittle_tpu_torch.parallel.dryrun\n"
            "import spittle_tpu_torch.parallel as p\n"
            "assert not d.is_initialized()\n"
            "assert 'jax' not in __import__('sys').modules\n"
            "print(sorted(p.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "pipeline_apply" in out.stdout and "make_mesh" in out.stdout


# -- the spawned group ----------------------------------------------------------


def _lean(x, router, expert, amount):
    lean = router[:, expert] / np.linalg.norm(router[:, expert])
    return (x + amount * lean * np.sqrt(x.shape[1])).astype(np.float32)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Inputs from the JAX package, one spawned 4-rank gloo group through
    every dry-run task, and the paths of its results."""
    inputs = tmp_path_factory.mktemp("mesh_inputs")
    out = tmp_path_factory.mktemp("mesh_out")
    jparams = jmod.init_params(CFG, jax.random.PRNGKey(0))
    dryrun.save_tree(str(inputs / "dp_tp_params.npz"), _np(jparams))
    mel = np.random.default_rng(2).standard_normal(
        (4, CFG.n_mels, CFG.n_audio_ctx * 2)).astype(np.float32)
    np.save(inputs / "dp_tp_mel.npy", mel)
    moe = _np(jep.init_moe_params(jax.random.PRNGKey(3), 32, 64, 4))
    dryrun.save_tree(str(inputs / "moe_params.npz"), moe)
    x = _lean(np.random.default_rng(4).standard_normal((64, 32)).astype(np.float32),
              moe["router_w"], 1, 0.3)
    np.save(inputs / "moe_x.npy", x)
    moe_params = jmod.init_params(MOE_CFG, jax.random.PRNGKey(5))
    dryrun.save_tree(str(inputs / "moe_enc_params.npz"),
                     {"encoder": _np(moe_params["encoder"])})
    moe_mel = np.random.default_rng(6).standard_normal(
        (4, MOE_CFG.n_mels, 96)).astype(np.float32)
    np.save(inputs / "moe_mel.npy", moe_mel)
    (inputs / "serving_ckpt.txt").write_text(TINY)
    words = ([4, 2, 3, 0], [1, 5, 2], [3, 3, 1, 0], [2, 6])
    audio = np.stack([tcc.utterance(w)[0] for w in words]).astype(np.float32)
    np.save(inputs / "serving_audio.npy", audio)
    rng = np.random.default_rng(8)
    train = dict(
        mel=rng.standard_normal((4, CFG.n_mels, CFG.n_audio_ctx * 2)).astype(np.float32),
        tokens=rng.integers(0, CFG.n_vocab, (4, CFG.n_text_ctx)).astype(np.int32),
        targets=rng.integers(0, CFG.n_vocab, (4, CFG.n_text_ctx)).astype(np.int32),
        mask=np.ones((4, CFG.n_text_ctx), np.float32))
    train["mask"][3, 5:] = 0.0
    np.savez(inputs / "train_batch.npz", **train)
    log = dryrun.spawn(WORLD, "cpu", list(dryrun.TASKS), str(inputs), str(out),
                       timeout=600)
    return dict(out=str(out), log=log, jparams=jparams, mel=mel, moe=moe, x=x,
                moe_params=moe_params, moe_mel=moe_mel, audio=audio, train=train)


def _load(group, name):
    return np.load(os.path.join(group["out"], name + ".npz"))


def _json(group, name):
    with open(os.path.join(group["out"], name + ".json")) as f:
        return json.load(f)


def test_dp_tp_encode_and_greedy_match_unsharded_and_reference(group):
    res = _load(group, "dp_tp")
    np.testing.assert_array_equal(res["tokens"], res["tokens_ref"])
    np.testing.assert_array_equal(res["beams"], res["beams_ref"])
    np.testing.assert_array_equal(res["q8"], res["q8_ref"])
    np.testing.assert_allclose(res["xa"], res["xa_ref"], rtol=0, atol=1e-5)
    mesh = jmesh.make_mesh(4, tp=2)
    with mesh:
        params = jmesh.shard_params(group["jparams"], mesh)
        mel = jax.device_put(group["mel"], jmesh.batch_sharding(mesh))
        xa = jmod.encode(params, mel, CFG)
        out = jgreedy(params, xa, CFG, JOpts(timestamps=False, max_tokens=8))
    np.testing.assert_allclose(res["xa"], np.asarray(xa), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res["tokens"], np.asarray(out["tokens"]))
    assert "tokens equal to the unsharded run: True" in group["log"]


def test_shard_shapes_match_reference(group):
    mesh = jmesh.make_mesh(4, tp=2)
    with mesh:
        params = jmesh.shard_params(group["jparams"], mesh)
    leaves = _jflat(params)
    for rank, dev in enumerate(mesh.devices.flat):
        got = _json(group, f"dp_tp_shapes_{rank}")
        want = {k: [list(s.data.shape) for s in v.addressable_shards
                    if s.device == dev][0] for k, v in leaves.items()}
        assert got == want, rank
    # Column-parallel heads, row-parallel inputs, the vocab split.
    assert got["decoder/blocks/wq"] == [2, 64, 32]
    assert got["decoder/blocks/wo"] == [2, 32, 64]
    assert got["decoder/tok_emb"] == [25933, 64]


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_moe_ffn_under_dp_ep_is_the_global_function(group, cf):
    res = _load(group, "moe")
    tag = str(cf).replace(".", "_")
    mesh = jmesh.make_mesh(4, tp=2)
    with mesh:
        moe = jep.shard_moe_params({k: jnp.asarray(v) for k, v in group["moe"].items()},
                                   mesh)
        x = jax.device_put(group["x"], NamedSharding(mesh, JP("data", None)))
        out, aux = jax.jit(lambda p, xx: jep.moe_ffn(p, xx, capacity_factor=cf))(moe, x)
    # Capacity and slots are those of the global token order: the counts
    # and drops exactly, and every token's output.
    for k in ("expert_counts", "dropped"):
        np.testing.assert_array_equal(res[f"{k}_{tag}"], np.asarray(aux[k]))
        np.testing.assert_array_equal(res[f"{k}_{tag}"], res[f"ref_{k}_{tag}"])
    if cf == 1.25:
        assert float(res[f"dropped_{tag}"]) > 0
    np.testing.assert_allclose(res[f"aux_loss_{tag}"], float(aux["aux_loss"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(res[f"out_{tag}"] == 0, np.asarray(out) == 0)
    np.testing.assert_allclose(res[f"out_{tag}"], np.asarray(out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res[f"out_{tag}"], res[f"ref_{tag}"], rtol=0,
                               atol=1e-6)


def test_moe_encoder_sharded_matches_unsharded_and_reference(group):
    res = _load(group, "moe")
    np.testing.assert_allclose(res["xa"], res["xa_ref"], rtol=0, atol=1e-5)
    mesh = jmesh.make_mesh(4, tp=2)
    with mesh:
        enc = {"encoder": jmesh.shard_params(group["moe_params"]["encoder"], mesh)}
        mel = jax.device_put(group["moe_mel"], jmesh.batch_sharding(mesh))
        xa = jax.jit(lambda p, m: jmod.encode(p, m, MOE_CFG))(enc, mel)
    np.testing.assert_allclose(res["xa"], np.asarray(xa), rtol=0, atol=2e-4)


def test_pipeline_equals_the_sequential_loop(group):
    res = _json(group, "pp")
    assert res["equal_2"] and res["equal_4"], res
    assert res["err_2"] == 0.0 and res["err_4"] == 0.0


def test_serving_under_a_data_mesh(group):
    res = _json(group, "serving")
    for r in ("0", "1"):
        assert res["tokens"][f"mesh_{r}"] == res["tokens"][f"plain_{r}"]
        assert res["text"][f"mesh_{r}"] == res["text"][f"plain_{r}"]
    assert res["batch_sizes"] == [4, 4] and res["ladder"] == [4]
    assert all(lang == "en" for lang in res["language"]["mesh_1"])
    # The JAX server under its data mesh on the same checkpoint and audio.
    eng = JaxEngine()
    eng.load_model(TINY)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    srv = JServer(eng, max_batch=4, max_wait_ms=200.0, mesh=mesh,
                  overlap_transfers=True)
    try:
        for ri, lang in enumerate(("en", None)):
            p = JParams(language=lang, parallel_windows=True,
                        condition_on_previous_text=False, max_tokens=24,
                        temperatures=(0.0,))
            futs = [srv.submit(a, p) for a in group["audio"]]
            ref = [f.result(timeout=600) for f in futs]
            assert res["tokens"][f"mesh_{ri}"] == [r.tokens for r in ref]
            assert res["language"][f"mesh_{ri}"] == [r.language for r in ref]
    finally:
        srv.shutdown()


def test_two_process_batch_and_replicated_reads(group):
    res = _json(group, "multihost")
    assert res["global_batch"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
    assert res["multiprocess"] and res["sharded_refused"]
    assert res["replicated"] == [1.0]


def test_uneven_vocab_refused_as_the_reference_refuses_it(group):
    res = _json(group, "multihost")["uneven"]
    for key, msg in res.items():
        n_vocab, tp = (int(x) for x in key.split("@"))
        mesh = jmesh.make_mesh(4, tp=tp)
        try:
            jax.device_put(np.zeros((n_vocab, 8), np.float32),
                           NamedSharding(mesh, jmesh._TOP_RULES["tok_emb"]))
            ref = "ok"
        except ValueError as e:
            ref = str(e)
        assert (msg == "ok") == (ref == "ok"), key
        if ref != "ok":
            assert f"divisible by {tp}, but it is equal to {n_vocab}" in ref
            assert f"divisible by {tp}, but it is equal to {n_vocab}" in msg
    assert res["51865@2"] != "ok" and res["51866@2"] == "ok"


def test_train_step_under_dp_tp_sp_matches_unsharded_and_reference(group):
    """One make_train_step step (lr 1e-3, remat, sequence parallelism)
    under make_mesh(4, tp=2) on the port's gloo group and on JAX's
    devices, with a ragged mask: the loss within 1e-5, every leaf's
    gradient within 1e-4 of its largest (f32 sums in other orders), and
    the updated parameters as tests/test_torch_train.py bounds one AdamW
    step: within 2 * lr everywhere (lr * g / (|g| + eps) flips with a
    near-zero g's sign), and within lr * 1e-3 where |g| is over 1e-2 of the
    leaf's largest and over 1e-6."""
    res = _load(group, "train")
    lr = 1e-3
    jb = {k: jnp.asarray(v) for k, v in group["train"].items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(jstep.cross_entropy_loss),
                              static_argnums=(5,))(
        group["jparams"], jb["mel"], jb["tokens"], jb["targets"], jb["mask"], CFG)
    mesh = jmesh.make_mesh(4, tp=2)
    with mesh:
        params = jmesh.shard_params(jax.tree.map(jnp.copy, group["jparams"]), mesh)
        batch = {k: jax.device_put(v, jmesh.batch_sharding(mesh))
                 for k, v in group["train"].items()}
        init_opt, step = jstep.make_train_step(
            CFG, learning_rate=lr, sequence_parallel_mesh=mesh, remat=True)
        stepped, _, loss = step(params, init_opt(params), batch)
    np.testing.assert_allclose(float(res["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(res["loss"]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(res["loss"]), float(res["loss_ref"]), rtol=1e-5)
    grads = _flat(jax.tree.map(np.asarray, grads_j))
    stepped = _flat(jax.tree.map(np.asarray, stepped))
    for name, g in grads.items():
        scale = float(np.abs(g).max())
        for key in ("grad/", "grad_ref/"):
            err = float(np.abs(res[key + name] - g).max())
            assert err <= 1e-4 * scale + 1e-9, (key, name, err, scale)
        sure = (np.abs(g) > 1e-2 * scale) & (np.abs(g) > 1e-6)
        for key in ("param/", "param_ref/"):
            far = np.abs(res[key + name] - stepped[name])
            assert far.max() <= 2 * lr + 1e-6, (key, name)
            assert (far[sure] <= 1e-3 * lr + 1e-6 * np.abs(stepped[name][sure])).all(), \
                (key, name)
    assert "train step under dp 2 x tp 2" in group["log"]


def test_sharded_checkpoint_resume_equals_unbroken(group):
    """Under make_mesh(4, tp=2) (sequence parallelism, lr 1e-3): 2 steps,
    save_checkpoint of the sharded tree and its AdamW state, a save
    interrupted after its write, restore_checkpoint into a freshly sharded
    tree of zeros, 2 more steps: the losses, every parameter shard and
    every AdamW moment bit-equal to 4 unbroken steps, and the interrupted
    save left no step_3 (nor its temporary directory)."""
    res = _load(group, "checkpoint")
    assert res["losses"].tolist() == res["losses_ref"].tolist()
    assert len(res["losses"]) == 4 and res["losses"][3] < res["losses"][0]
    assert int(res["step"]) == 2 and int(res["equal"]) == 1
    assert res["left"].tolist() == ["step_2"] and str(res["raised"]) != "None"
    assert "parameters and moments bit-equal: True" in group["log"]
