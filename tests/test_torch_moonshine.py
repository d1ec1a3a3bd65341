"""spittle_tpu_torch's Moonshine (raw-waveform encoder, KV-cache greedy
decoder) against the JAX reference on the CPU.

The same inputs, made from numpy seeds, go through the JAX function and
the port's: the encoder, the greedy decode loop at several budgets, the
engines on the same .npz (JAX's init_params tree at the moonshine-test
config, its zero biases replaced by seeded noise and the token embedding
widened so the decoder does not emit EOT at once, saved with
save_family_npz), an HF MoonshineForConditionalGeneration directory
(tests/test_moonshine_engine_load.py's fixture), and the committed
trained_families goldens.

Tolerances: encoder states within 1e-4 of the reference's largest
magnitude; token ids, lengths, texts, segments and languages exactly
equal.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from spittle_tpu.engine.moonshine_engine import MoonshineEngine as JaxEngine
from spittle_tpu.engine.parakeet_engine import SentencePieceTable as JTable
from spittle_tpu.io.npz_checkpoint import save_family_npz
from spittle_tpu.models.moonshine import model as jmodel
from spittle_tpu_torch.engine.moonshine_engine import MoonshineEngine
from spittle_tpu_torch.models.moonshine import model as tmodel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import train_family_checkpoints as tone_task  # noqa: E402

FAMILIES = os.path.join(os.path.dirname(__file__), "data", "trained_families")
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def _results(res):
    return [(r.text, [(s.start, s.end, s.text) for s in r.segments], r.language)
            for r in res]


def noisy_init(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: a if a.any() else (0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.tree.map(np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(0))))
    tree["decoder"]["tok_emb"] = tree["decoder"]["tok_emb"] * 25.0
    return tree


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    cfg = jmodel.CONFIGS["moonshine-test"]
    path = str(tmp_path_factory.mktemp("moonshine") / "moonshine-test.npz")
    save_family_npz(path, cfg, noisy_init(cfg),
                    JTable.test_table(cfg.vocab_size).pieces)
    jeng, teng = JaxEngine(), MoonshineEngine(device="cpu")
    jeng.load_model(path)
    teng.load_model(path)
    return jeng, teng


def test_random_params_has_the_reference_tree():
    for name in ("moonshine-test", "moonshine-base"):
        ours = tmodel.random_params(tmodel.CONFIGS[name], seed=0)
        ref = jax.eval_shape(lambda: jmodel.init_params(jmodel.CONFIGS[name]))
        assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
                == jax.tree.map(lambda t: (tuple(t.shape),
                                           str(t.dtype).split(".")[-1]), ours))
    cfg = tmodel.CONFIGS["moonshine-test"]
    torch.testing.assert_close(
        tmodel.random_params(cfg, seed=3)["decoder"]["tok_emb"],
        tmodel.random_params(cfg, seed=3)["decoder"]["tok_emb"], rtol=0, atol=0)
    assert {k: v.__dict__ for k, v in tmodel.CONFIGS.items()} == {
        k: v.__dict__ for k, v in jmodel.CONFIGS.items()}
    assert tmodel.CONFIGS["moonshine-base"].rotary_dim == 46


def test_encode_matches_reference(engines):
    jeng, teng = engines
    x = np.stack([audio(1, 1.7), audio(2, 1.7)])
    ref = jmodel.encode(jeng.params, jnp.asarray(x), jeng.cfg)
    got = tmodel.encode(teng.params, torch.from_numpy(x), teng.cfg)
    assert got.shape == ref.shape and got.shape[1] > 50
    err = float(np.max(np.abs(got.numpy() - np.asarray(ref))))
    assert err <= 1e-4 * float(np.max(np.abs(np.asarray(ref)))), err


@pytest.mark.parametrize("max_tokens", [0, 5])
def test_greedy_decode_matches_reference(engines, max_tokens):
    jeng, teng = engines
    xa = np.random.default_rng(4).standard_normal((3, 11, teng.cfg.dim)).astype(
        np.float32)
    jt, jl = map(np.asarray, jmodel.greedy_decode(
        jeng.params, jnp.asarray(xa), jeng.cfg, max_tokens))
    tt, tl, steps = tmodel.greedy_decode(teng.params, torch.from_numpy(xa),
                                         teng.cfg, max_tokens)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert jl.max() > 0  # the decoder emits before EOT
    assert steps == (max_tokens or teng.cfg.max_tokens) or (jt[:, steps - 1]
                                                             == teng.cfg.eot).all()


def test_engine_matches_reference(engines):
    jeng, teng = engines
    batch = [audio(5, 1.0), audio(6, 2.6), (audio(7, 0.3) * 32767).astype(np.int16),
             audio(8, 0.01)]
    ref = jeng.transcribe_batch(batch)
    got = teng.transcribe_batch(batch)
    assert _results(got) == _results(ref)
    assert any(r.text for r in got)
    assert (_results([teng.transcribe_samples(batch[1])])
            == _results([jeng.transcribe_samples(batch[1])]))


def test_engine_device_and_dtype_contract():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MoonshineEngine()
    with pytest.raises(ValueError, match="float32"):
        MoonshineEngine(device="cpu", dtype=torch.bfloat16)
    eng = MoonshineEngine(device="cpu")
    eng.load_model("random:moonshine-test", seed=1)
    assert eng.is_loaded
    eng.unload_model()
    assert not eng.is_loaded


def test_hf_checkpoint_matches_reference(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MoonshineConfig(
        hidden_size=64, intermediate_size=128, encoder_num_hidden_layers=2,
        decoder_num_hidden_layers=2, encoder_num_attention_heads=8,
        decoder_num_attention_heads=8, encoder_num_key_value_heads=8,
        decoder_num_key_value_heads=8, vocab_size=128)
    torch.manual_seed(1)
    hf_model = transformers.MoonshineForConditionalGeneration(hf_cfg).eval()
    save_file({k: v.detach().numpy() for k, v in hf_model.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "vocab.txt").write_text(
        "".join(f"▁piece{i}\n" for i in range(128)), encoding="utf-8")
    jeng, teng = JaxEngine(), MoonshineEngine(device="cpu")
    jeng.load_model(str(tmp_path))
    teng.load_model(str(tmp_path))
    assert teng.cfg.__dict__ == jeng.cfg.__dict__
    assert teng.table.pieces == jeng.table.pieces
    ref = jax.tree.map(np.asarray, jeng.params)

    def equal(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got.numpy(), want)

    equal(teng.params, ref)
    batch = [audio(9, 1.0), audio(10, 0.5)]
    assert _results(teng.transcribe_batch(batch)) == _results(
        jeng.transcribe_batch(batch))


def test_trained_goldens():
    with open(os.path.join(FAMILIES, "goldens.json")) as f:
        cases = json.load(f)["cases"]
    eng = MoonshineEngine(device="cpu")
    eng.load_model(os.path.join(FAMILIES, "moonshine.npz"))
    res = eng.transcribe_batch([tone_task.utterance(c["word_ids"]) for c in cases])
    assert [r.text for r in res] == [c["moonshine"]["text"] for c in cases]
    assert [r.language for r in res] == [c["moonshine"]["language"] for c in cases]
