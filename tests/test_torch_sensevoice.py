"""spittle_tpu_torch's SenseVoice (SAN-M encoder + CTC) against the JAX
reference on the CPU.

The same inputs, made from numpy seeds, go through the JAX function and
the port's: the LFR stacking, the sinusoidal positions, the encoder's CTC
logits (prompt frames and CMVN included), the engines on the same .npz
(JAX's init_params tree at the sense-voice-test config, its zero biases
replaced by seeded noise, saved with save_family_npz) under each
language and use_itn setting, FunASR checkpoint directories
(model.safetensors and model.pt, am.mvn, a .bpe.model; the state_dict of
tests/test_sensevoice_funasr.py's make_funasr_state), and the committed
trained_families goldens.

Tolerances: LFR frames and positions bit for bit; CTC logits within 1e-5
absolute; token ids, texts, segments and languages exactly equal.
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

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.parakeet_engine import SentencePieceTable as JTable
from spittle_tpu.engine.sensevoice_engine import SenseVoiceEngine as JaxEngine
from spittle_tpu.io.npz_checkpoint import save_family_npz
from spittle_tpu.models.sensevoice import model as jmodel
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.sensevoice_engine import SenseVoiceEngine
from spittle_tpu_torch.models.sensevoice import model as tmodel
from test_parakeet_nemo import encode_spm
from test_sensevoice_funasr import TINY as FUNASR_CFG
from test_sensevoice_funasr import make_funasr_state

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


def noisy_init(cfg, seed=0):
    """JAX init_params with every zero-initialized leaf replaced by seeded
    noise."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a if a.any() else (0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.tree.map(np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(0))))


def tree_equal(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            tree_equal(got[k], ref[k])
        return
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(ref))


def _results(res):
    return [(r.text, [(s.start, s.end, s.text) for s in r.segments], r.language)
            for r in res]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    cfg = jmodel.CONFIGS["sense-voice-test"]
    path = str(tmp_path_factory.mktemp("sensevoice") / "sense-voice-test.npz")
    save_family_npz(path, cfg, noisy_init(cfg),
                    JTable.test_table(cfg.vocab_size).pieces)
    jeng, teng = JaxEngine(), SenseVoiceEngine(device="cpu")
    jeng.load_model(path)
    teng.load_model(path)
    return jeng, teng


def test_random_params_has_the_reference_tree():
    cfg = tmodel.CONFIGS["sense-voice-test"]
    ours = tmodel.random_params(cfg, seed=0)
    ref = jax.eval_shape(
        lambda: jmodel.init_params(jmodel.CONFIGS["sense-voice-test"]))
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[-1]), ours))
    torch.testing.assert_close(tmodel.random_params(cfg, seed=0)["ctc_w"],
                               ours["ctc_w"], rtol=0, atol=0)
    assert {k: v.__dict__ for k, v in tmodel.CONFIGS.items()} == {
        k: v.__dict__ for k, v in jmodel.CONFIGS.items()}


@pytest.mark.parametrize("frames", [60, 61, 7, 3])
def test_lfr_and_positions_match_reference(frames):
    mel = np.random.default_rng(frames).standard_normal((2, 80, frames)).astype(
        np.float32)
    ref = np.asarray(jmodel.lfr_stack(jnp.asarray(mel)))
    got = tmodel.lfr_stack(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, frames // 6, 560)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tmodel.sinusoidal_positions(frames, 560),
                                  jmodel.sinusoidal_positions(frames, 560))


@pytest.mark.parametrize("cmvn", [False, True])
def test_encode_matches_reference(engines, cmvn):
    jeng, teng = engines
    cfg = teng.cfg
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 9, cfg.input_dim)).astype(np.float32)
    pids = np.stack([jmodel.prompt_ids_for(cfg, "en", True),
                     jmodel.prompt_ids_for(cfg, "auto", False)])
    jp, tp = dict(jeng.params), dict(teng.params)
    if cmvn:
        shift = rng.standard_normal(cfg.input_dim).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, cfg.input_dim).astype(np.float32)
        jp.update(cmvn_shift=jnp.asarray(shift), cmvn_scale=jnp.asarray(scale))
        tp.update(cmvn_shift=torch.from_numpy(shift),
                  cmvn_scale=torch.from_numpy(scale))
    ref = np.asarray(jmodel.encode(jp, jnp.asarray(feats), jnp.asarray(pids),
                                   jeng.cfg))
    got = tmodel.encode(tp, torch.from_numpy(feats), torch.from_numpy(pids), cfg)
    assert got.shape == ref.shape == (2, 4 + 9, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), ref.argmax(-1))


@pytest.mark.parametrize("language,use_itn", [(None, True), ("en", True),
                                               ("zh", False)])
def test_engine_matches_reference(engines, language, use_itn):
    jeng, teng = engines
    jeng.use_itn = teng.use_itn = use_itn
    batch = [audio(1, 1.4), audio(2, 0.6), (audio(3, 2.1) * 32767).astype(np.int16)]
    ref = jeng.transcribe_batch(batch, JParams(language=language))
    got = teng.transcribe_batch(batch, TranscribeParams(language=language))
    assert _results(got) == _results(ref)
    assert any(r.text for r in got)
    assert (_results([teng.transcribe_samples(batch[0])])
            == _results([jeng.transcribe_samples(batch[0])]))


def test_engine_device_and_dtype_contract():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SenseVoiceEngine()
    with pytest.raises(ValueError, match="float32"):
        SenseVoiceEngine(device="cpu", dtype=torch.float16)
    eng = SenseVoiceEngine(device="cpu", use_itn=False)
    eng.load_model("random:sense-voice-test", seed=2)
    assert eng.is_loaded and not eng.use_itn
    eng.unload_model()
    assert not eng.is_loaded


def _write_am_mvn(path, dim, rng):
    shift = " ".join(f"{v:.6f}" for v in rng.standard_normal(dim))
    scale = " ".join(f"{v:.6f}" for v in rng.uniform(0.5, 1.5, dim))
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
                f"<LearnRateCoef> 0 [ {shift} ]\n<Rescale> {dim} {dim}\n"
                f"<LearnRateCoef> 0 [ {scale} ]\n</Nnet>\n")


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_funasr_checkpoint_matches_reference(tmp_path, fmt):
    state = make_funasr_state(FUNASR_CFG)
    if fmt == "safetensors":
        save_file({k: v.numpy() for k, v in state.items()},
                  str(tmp_path / "model.safetensors"))
    else:
        torch.save(state, str(tmp_path / "model.pt"))
    _write_am_mvn(tmp_path / "am.mvn", FUNASR_CFG.input_dim,
                  np.random.default_rng(6))
    (tmp_path / "chn_jpn_yue_eng_ko_spectok.bpe.model").write_bytes(
        encode_spm([f"▁s{i}" for i in range(FUNASR_CFG.vocab_size)]))
    jeng, teng = JaxEngine(), SenseVoiceEngine(device="cpu")
    jeng.load_model(str(tmp_path))
    teng.load_model(str(tmp_path))
    assert teng.cfg.__dict__ == jeng.cfg.__dict__
    assert teng.table.pieces == jeng.table.pieces
    assert "cmvn_shift" in teng.params
    tree_equal(teng.params, jax.tree.map(np.asarray, jeng.params))
    batch = [audio(7, 1.3), audio(8, 0.9)]
    ref = jeng.transcribe_batch(batch, JParams(language="en"))
    got = teng.transcribe_batch(batch, TranscribeParams(language="en"))
    assert _results(got) == _results(ref)


def test_trained_goldens():
    with open(os.path.join(FAMILIES, "goldens.json")) as f:
        cases = json.load(f)["cases"]
    eng = SenseVoiceEngine(device="cpu")
    eng.load_model(os.path.join(FAMILIES, "sensevoice.npz"))
    res = eng.transcribe_batch([tone_task.utterance(c["word_ids"]) for c in cases],
                               TranscribeParams(language=None))
    assert [r.text for r in res] == [c["sensevoice"]["text"] for c in cases]
    assert [r.language for r in res] == [c["sensevoice"]["language"]
                                         for c in cases]
