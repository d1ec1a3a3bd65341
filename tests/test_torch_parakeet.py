"""spittle_tpu_torch's Parakeet (FastConformer-TDT and CTC) against the JAX
reference on the CPU.

The same inputs, made from numpy seeds, go through the JAX function and
the port's: the features, the encoder, the prediction network and joint,
the TDT greedy loop (its zero-duration guard too), the CTC head, the
engines on the same .npz (JAX's init_params tree at the parakeet-test
config, its zero biases replaced by seeded noise so every bias is
exercised, saved with save_family_npz), an HF ParakeetForCTC directory,
a .nemo archive written by tests/test_parakeet_nemo.py's helpers, the
piece tables, and the committed trained_families goldens.

Tolerances: features and encoder states within 1e-4 of the reference's
largest magnitude; the LSTM state, the joint's logits and the CTC logits
within 1e-5 absolute; token ids, counts, frames, texts, segments and
languages exactly equal.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from safetensors.numpy import save_file

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.parakeet_engine import ParakeetEngine as JaxEngine
from spittle_tpu.engine.parakeet_engine import SentencePieceTable as JTable
from spittle_tpu.io.npz_checkpoint import save_family_npz
from spittle_tpu.models.parakeet import decode as jdecode
from spittle_tpu.models.parakeet import model as jmodel
from spittle_tpu.models.parakeet import nemo as jnemo
from spittle_tpu.models.parakeet.config import CONFIGS as JCONFIGS
from spittle_tpu.models.parakeet.features import parakeet_features as jfeatures
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.parakeet_engine import (
    ParakeetEngine,
    SentencePieceTable,
)
from spittle_tpu_torch.models.parakeet import decode as tdecode
from spittle_tpu_torch.models.parakeet import model as tmodel
from spittle_tpu_torch.models.parakeet import nemo as tnemo
from spittle_tpu_torch.models.parakeet.config import CONFIGS
from spittle_tpu_torch.models.parakeet.features import parakeet_features
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from test_parakeet_nemo import TINY as NEMO_CFG
from test_parakeet_nemo import make_nemo_state, write_nemo

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import train_family_checkpoints as tone_task  # noqa: E402

FAMILIES = os.path.join(os.path.dirname(__file__), "data", "trained_families")
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager decode loops of small ops: beside the suite's other workers,
    intra-op threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_rel(got, ref, rel=1e-4):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), err


def tree_equal(got, ref):
    """Same keys and values (dtypes may differ in width, not in kind)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            tree_equal(got[k], ref[k])
        return
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


def noisy_init(cfg, seed=0):
    """JAX init_params with every zero-initialized bias (and the BatchNorm
    running mean) replaced by seeded noise; the running variance stays
    positive."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jmodel.init_params(cfg, jax.random.PRNGKey(0)))

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "conv_bn_var":
                node[k] = (v + rng.uniform(0.0, 1.0, v.shape)).astype(v.dtype)
            elif not v.any():
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)

    walk(tree)
    return tree


def audio(seed, seconds):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(int(seconds * SR))).astype(np.float32)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    cfg = JCONFIGS["parakeet-test"]
    path = str(tmp_path_factory.mktemp("parakeet") / "parakeet-test.npz")
    save_family_npz(path, cfg, noisy_init(cfg),
                    JTable.test_table(cfg.vocab_size).pieces,
                    store_dtype=np.float32)
    return path


@pytest.fixture(scope="module")
def engines(npz):
    jeng, teng = JaxEngine(), ParakeetEngine(device="cpu")
    jeng.load_model(npz)
    teng.load_model(npz)
    return jeng, teng


def test_random_params_has_the_reference_tree():
    cfg = CONFIGS["parakeet-test"]
    ours = tmodel.random_params(cfg, seed=0)
    ref = jax.eval_shape(lambda: jmodel.init_params(JCONFIGS["parakeet-test"]))
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[-1]), ours))
    again = tmodel.random_params(cfg, seed=0)
    torch.testing.assert_close(again["blocks"]["wq"], ours["blocks"]["wq"],
                               rtol=0, atol=0)
    assert {k: v.__dict__ for k, v in CONFIGS.items()} == {
        k: v.__dict__ for k, v in JCONFIGS.items()}


def test_features_match_reference():
    x = np.stack([audio(1, 1.3), audio(2, 1.3)])
    ref = np.asarray(jfeatures(jnp.asarray(x), n_mels=80))
    got = parakeet_features(torch.from_numpy(x), n_mels=80)
    assert got.shape == ref.shape == (2, 80, len(x[0]) // 160)
    assert_rel(got, ref)


def test_encoder_matches_reference(engines):
    jeng, teng = engines
    feats = np.random.default_rng(3).standard_normal((2, 80, 123)).astype(
        np.float32)
    ref = jmodel.encode(jeng.params, jnp.asarray(feats), jeng.cfg)
    got = tmodel.encode(teng.params, torch.from_numpy(feats), teng.cfg)
    assert got.shape == ref.shape == (2, 16, 64)
    assert_rel(got, ref)


def test_pred_step_and_joint_match_reference(engines):
    jeng, teng = engines
    cfg, rng = teng.cfg, np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size + 1, 5)
    h, c = (rng.standard_normal((2, 5, cfg.pred_hidden)).astype(np.float32))
    enc_t = rng.standard_normal((5, cfg.d_model)).astype(np.float32)
    jout, (jh, jc) = jmodel.pred_step(jeng.params, jnp.asarray(tok),
                                      (jnp.asarray(h), jnp.asarray(c)), jeng.cfg)
    tout, (th, tc) = tmodel.pred_step(teng.params, torch.from_numpy(tok),
                                      (torch.from_numpy(h), torch.from_numpy(c)),
                                      cfg)
    for got, ref in ((tout, jout), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    jl, jd = jmodel.joint(jeng.params, jnp.asarray(enc_t), jout)
    tl, td = tmodel.joint(teng.params, torch.from_numpy(enc_t), tout)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def _guarded(params, cfg):
    """tests/test_parakeet.py's zero-duration arm: duration bin 0 dominates
    and blank is suppressed, so same-frame emissions chain and the
    max-symbols guard must force +1."""
    joint = dict(params["joint"])
    dur_b, out_b = np.array(joint["dur_b"]), np.array(joint["out_b"])
    dur_b[0] += 8.0
    out_b[cfg.blank_id] -= 8.0
    joint["dur_b"], joint["out_b"] = dur_b, out_b
    return {**params, "joint": joint}


@pytest.mark.parametrize("case", ["plain", "zero_duration_guard"])
def test_tdt_decode_matches_reference(engines, case):
    jeng, teng = engines
    cfg = teng.cfg
    tree = jax.tree.map(np.asarray, jeng.params)
    if case == "zero_duration_guard":
        tree = _guarded(tree, cfg)
        shape, lens = (3, 8, cfg.d_model), [8, 5, 2]
    else:
        shape, lens = (4, 24, cfg.d_model), [24, 13, 7, 1]
    enc = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    jt, jc, jf = map(np.asarray, jdecode.tdt_greedy_decode(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(enc), jnp.asarray(lens),
        jeng.cfg, max_tokens=256))
    tt, tc, tf, steps = tdecode.tdt_greedy_decode(
        params_from_jax(tree), torch.from_numpy(enc), torch.tensor(lens), cfg,
        max_tokens=256)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tf.numpy(), jf)
    assert 0 < steps <= shape[1] * (cfg.max_symbols_per_step + 1)
    if case == "zero_duration_guard":  # the guard fired: runs of 10 per frame
        assert jc.max() >= cfg.max_symbols_per_step


def test_tdt_batch_matches_single(engines):
    _, teng = engines
    enc = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 10, teng.cfg.d_model)).astype(np.float32))
    lens = torch.tensor([10, 10])
    tb, cb, fb, _ = tdecode.tdt_greedy_decode(teng.params, enc, lens, teng.cfg)
    t0, c0, f0, _ = tdecode.tdt_greedy_decode(teng.params, enc[:1], lens[:1],
                                              teng.cfg)
    assert int(cb[0]) == int(c0[0])
    torch.testing.assert_close(tb[0], t0[0], rtol=0, atol=0)
    torch.testing.assert_close(fb[0], f0[0], rtol=0, atol=0)


def _results(res):
    return [(r.text, [(s.start, s.end, s.text) for s in r.segments], r.language)
            for r in res]


@pytest.mark.parametrize("language", [None, "en"])
def test_engine_matches_reference(engines, language):
    """Mixed lengths (the valid-frame counts differ), one int16 item, and
    one single-item call."""
    jeng, teng = engines
    batch = [audio(5, 1.0), audio(6, 2.3), audio(7, 0.4)]
    batch[2] = (batch[2] * 32767).astype(np.int16)
    ref = jeng.transcribe_batch(batch, JParams(language=language))
    got = teng.transcribe_batch(batch, TranscribeParams(language=language))
    assert _results(got) == _results(ref)
    assert any(r.text for r in got)
    assert (_results([teng.transcribe_samples(batch[1])])
            == _results([jeng.transcribe_samples(batch[1])]))
    assert teng.last_decode_steps[-1] > 0


def test_engine_device_and_dtype_contract():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParakeetEngine()
    with pytest.raises(ValueError, match="float32"):
        ParakeetEngine(device="cpu", dtype=torch.bfloat16)
    eng = ParakeetEngine(device="cpu")
    assert not eng.is_loaded
    eng.load_model("random:parakeet-test", seed=1)
    assert eng.is_loaded and eng.params["blocks"]["wq"].device.type == "cpu"
    eng.unload_model()
    assert not eng.is_loaded


# -- HF ParakeetForCTC (tests/test_parakeet_ctc.py's fixture) -----------------


@pytest.fixture(scope="module")
def ctc_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("parakeet_ctc")
    enc_cfg = transformers.ParakeetEncoderConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, num_mel_bins=80,
        subsampling_conv_channels=32, conv_kernel_size=9)
    cfg = transformers.ParakeetCTCConfig(encoder_config=enc_cfg.to_dict(),
                                         vocab_size=65)
    torch.manual_seed(2)
    hf_model = transformers.ParakeetForCTC(cfg).eval()
    with torch.no_grad():
        for layer in hf_model.encoder.layers:
            layer.conv.norm.running_mean.uniform_(-0.5, 0.5)
            layer.conv.norm.running_var.uniform_(0.5, 2.0)
    save_file({k: v.detach().numpy() for k, v in hf_model.state_dict().items()},
              str(d / "model.safetensors"))
    with open(d / "vocab.txt", "w", encoding="utf-8") as f:
        for i in range(65):
            f.write(f"▁p{i}\n")
    return str(d)


def test_ctc_checkpoint_matches_reference(ctc_dir):
    jeng, teng = JaxEngine(), ParakeetEngine(device="cpu")
    jeng.load_model(ctc_dir)
    teng.load_model(ctc_dir)
    assert teng.mode == jeng.mode == "ctc"
    assert teng.cfg.__dict__ == jeng.cfg.__dict__
    tree_equal(teng.params, jax.tree.map(np.asarray, jeng.params))
    enc = np.random.default_rng(8).standard_normal((2, 12, 64)).astype(np.float32)
    ref = np.asarray(jdecode.ctc_logits(jeng.params, jnp.asarray(enc)))
    got = tdecode.ctc_logits(teng.params, torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    lens = [12, 5]
    assert (tdecode.ctc_greedy_decode(teng.params, torch.from_numpy(enc),
                                      torch.tensor(lens), 64)
            == jdecode.ctc_greedy_decode(jeng.params, jnp.asarray(enc),
                                         jnp.asarray(lens), 64))
    batch = [audio(9, 1.5), audio(10, 0.7)]
    assert (_results(teng.transcribe_batch(batch))
            == _results(jeng.transcribe_batch(batch)))


# -- .nemo archives and their YAML ---------------------------------------------


@pytest.fixture(scope="module")
def nemo_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nemo") / "tiny.nemo")
    write_nemo(path, make_nemo_state(NEMO_CFG), NEMO_CFG,
               [f"▁w{i}" for i in range(NEMO_CFG.vocab_size)])
    return path


def test_nemo_loader_matches_reference(nemo_file):
    cfg, tree, pieces = tnemo.load_nemo(nemo_file)
    jcfg, jtree, jpieces = jnemo.load_nemo(nemo_file)
    assert cfg.__dict__ == jcfg.__dict__ and cfg.name == "tiny-nemo"
    assert pieces == jpieces
    tree_equal(tree, jtree)
    jeng, teng = JaxEngine(), ParakeetEngine(device="cpu")
    jeng.load_model(nemo_file)
    teng.load_model(nemo_file)
    batch = [audio(11, 1.2), audio(12, 2.0)]
    assert (_results(teng.transcribe_batch(batch, TranscribeParams(language="en")))
            == _results(jeng.transcribe_batch(batch, JParams(language="en"))))


NEMO_LIKE_YAML = """\
# a NeMo-style model_config.yaml
name: "FastConformer-TDT #2"   # trailing comment
sample_rate: 16000
target: nemo.collections.asr.models.rnnt_bpe_models.EncDecRNNTBPEModel
model_defaults:
  enc_hidden: 1024
  pred_hidden: 640
  tdt_durations: [0, 1, 2, 3, 4]
train_ds:
  manifest_filepath: null
  shuffle: true
  bucketing:
    - name: a
      size: 3
    - name: b
  tags:
    - x
    - 'y z'
joint:
  _target_: nemo.collections.asr.modules.RNNTJoint
  durations:
  - 0
  - 1
  - 2
  jointnet:
    activation: relu
    note: |
      multi line
      durations: [9]
  num_extra_outputs: 3
empty:
last: 7
"""


@pytest.mark.parametrize("which", ["write_nemo", "nemo_like"])
def test_block_yaml_reader_matches_pyyaml(which):
    if which == "write_nemo":
        text = yaml.safe_dump({"name": NEMO_CFG.name,
                               "joint": {"durations": list(range(5))}})
        assert tnemo.read_block_yaml(text) == yaml.safe_load(text)
    else:
        text = NEMO_LIKE_YAML
    got, ref = tnemo.read_block_yaml(text), yaml.safe_load(text)
    assert got["name"] == ref["name"]
    assert tnemo._yaml_durations(got) == jnemo._yaml_durations(ref)
    if which == "nemo_like":
        for a, b in (("model_defaults", "tdt_durations"), ("joint", "durations"),
                     ("train_ds", "tags"), ("train_ds", "shuffle"),
                     ("joint", "num_extra_outputs")):
            assert got[a][b] == ref[a][b]
        assert got["last"] == ref["last"] and got["empty"] is ref["empty"]


# -- piece tables ------------------------------------------------------------


def test_sentencepiece_table_matches_reference(tmp_path):
    pieces = ["<blank>", "▁hello", "▁world", "ly", "▁и", "x\ty"]
    ids = [[1, 2, 3], [4, 0, 99, -1], [], [3, 3]]
    for p_ids in ids:
        assert (SentencePieceTable(pieces).decode(p_ids)
                == JTable(pieces).decode(p_ids))
    assert SentencePieceTable.test_table(7).pieces == JTable.test_table(7).pieces
    for name, body in (
        ("vocab.txt", "".join(f"{p.split(chr(9))[0]}\t{i}\n"
                              for i, p in enumerate(pieces))),
        ("tokenizer.json", json.dumps({"model": {"vocab": [[p, 0.0]
                                                           for p in pieces]}})),
        ("tokenizer.json", json.dumps({"model": {"vocab": {
            p: i for i, p in reversed(list(enumerate(pieces)))}}})),
    ):
        d = tmp_path / f"{name}_{len(list(tmp_path.iterdir()))}"
        d.mkdir()
        (d / name).write_text(body, encoding="utf-8")
        assert (SentencePieceTable.load(str(d)).pieces
                == JTable.load(str(d)).pieces)
    with pytest.raises(FileNotFoundError):
        SentencePieceTable.load(str(tmp_path))


def test_sentencepiece_model_pieces_match_reference():
    from test_parakeet_nemo import encode_spm

    blob = encode_spm(["▁a", "b", "▁путь", "<unk>"])
    assert tnemo.sentencepiece_pieces(blob) == jnemo.sentencepiece_pieces(blob)


def test_tdt_safetensors_tree(npz, engines, tmp_path):
    """A TDT tree in the stacked layout under "/"-joined names: the port
    reads its config from the shapes and decodes as the .npz does."""
    from spittle_tpu.io.npz_checkpoint import load_family_npz

    jcfg, tree, pieces = load_family_npz(npz, JCONFIGS["parakeet-test"].__class__)
    flat = {}
    for top, sub in tree.items():
        for k, v in sub.items():
            flat[f"{top}/{k}"] = np.ascontiguousarray(v)
    d = tmp_path / "parakeet-tdt-v3-tree"
    d.mkdir()
    save_file(flat, str(d / "model.safetensors"))
    (d / "vocab.txt").write_text("".join(p + "\n" for p in pieces),
                                 encoding="utf-8")
    eng = ParakeetEngine(device="cpu")
    eng.load_model(str(d))
    assert eng.mode == "tdt" and eng.cfg.name == "parakeet-tdt-0.6b-v3"
    assert {**eng.cfg.__dict__, "name": None} == {**jcfg.__dict__, "name": None}
    batch = [audio(13, 1.1)]
    assert (_results(eng.transcribe_batch(batch))
            == _results(engines[1].transcribe_batch(batch)))


# -- the committed trained checkpoint ------------------------------------------


def test_trained_goldens():
    with open(os.path.join(FAMILIES, "goldens.json")) as f:
        cases = json.load(f)["cases"]
    eng = ParakeetEngine(device="cpu")
    eng.load_model(os.path.join(FAMILIES, "parakeet.npz"))
    res = eng.transcribe_batch([tone_task.utterance(c["word_ids"]) for c in cases],
                               TranscribeParams(language="en"))
    assert [r.text for r in res] == [c["parakeet"]["text"] for c in cases]
    assert [r.language for r in res] == [c["language"] for c in cases]
    # The trained trajectory hops by duration 2: emissions on the tone grid.
    n = len(cases[0]["word_ids"])
    seg = res[0].segments[0]
    assert (seg.start, seg.end) == (2 * 0.08, (2 + 10 * (n - 1)) * 0.08)


def test_port_loads_family_checkpoints_without_jax_yaml_or_safetensors(
        nemo_file, ctc_dir):
    """In a process where importing jax, spittle_tpu, yaml or safetensors
    raises ImportError, as on the card machine, the port's three engines
    load a .nemo archive, an HF safetensors directory and the committed
    .npz files and transcribe."""
    import subprocess

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'spittle_tpu',\n"
        "                                  'yaml', 'safetensors'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from spittle_tpu_torch.engine.moonshine_engine import MoonshineEngine\n"
        "from spittle_tpu_torch.engine.parakeet_engine import ParakeetEngine\n"
        "from spittle_tpu_torch.engine.sensevoice_engine import SenseVoiceEngine\n"
        "nemo, ctc, fam = sys.argv[1:]\n"
        "for cls, path in ((ParakeetEngine, nemo), (ParakeetEngine, ctc),\n"
        "                  (ParakeetEngine, fam + '/parakeet.npz'),\n"
        "                  (SenseVoiceEngine, fam + '/sensevoice.npz'),\n"
        "                  (MoonshineEngine, fam + '/moonshine.npz')):\n"
        "    eng = cls(device='cpu')\n"
        "    eng.load_model(path)\n"
        "    r = eng.transcribe_samples(np.zeros(16000, np.float32))\n"
        "    print(cls.__name__, type(r.text).__name__)\n"
        "assert not any(n.split('.')[0] in ('jax', 'spittle_tpu', 'yaml',\n"
        "                                   'safetensors') for n in sys.modules)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, nemo_file, ctc_dir,
                          FAMILIES], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:5] == [
        "ParakeetEngine str", "ParakeetEngine str", "ParakeetEngine str",
        "SenseVoiceEngine str", "MoonshineEngine str"]
