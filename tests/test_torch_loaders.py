"""spittle_tpu_torch's checkpoint loaders against the JAX reference's on the
same files, on the CPU: GGML files (every tensor type the reference
reads), HF safetensors directories (read by the port without the
safetensors package), spittle .npz files with tokenizer files beside them,
the tokenizer loaders, the alignment-heads sidecar, a GGML file's own mel
filterbank, and WhisperEngine.load_model on each, transcribing to the JAX
engine's tokens. Files are written from numpy-seeded weights at tiny
configs; the loaders must agree bit for bit (np.array_equal).
"""

import base64
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from spittle_tpu.audio.mel import log_mel_spectrogram as jax_mel
from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import alignment as jalign
from spittle_tpu.models.whisper import tokenizer as jtok
from spittle_tpu.models.whisper import weights as jw
from spittle_tpu.models.whisper.config import WhisperConfig as JConfig
from spittle_tpu_torch.audio.mel import log_mel_spectrogram, mel_filterbank
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import alignment as talign
from spittle_tpu_torch.models.whisper import tokenizer as ttok
from spittle_tpu_torch.models.whisper import weights as tw
from spittle_tpu_torch.models.whisper.config import WhisperConfig
from test_whisper_weights import TINY, openai_tensor_names, write_ggml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
QUANT_TYPES = (tw.GGML_F16, tw.GGML_Q4_0, tw.GGML_Q4_1, tw.GGML_Q5_0,
               tw.GGML_Q5_1, tw.GGML_Q8_0)


def _tensors(cfg, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, shape in openai_tensor_names(cfg).items()}


def _tree_equal(got, ref):
    """Same nesting, keys, dtypes and values."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _tree_equal(got[k], ref[k])
        return
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.fixture()
def tiny_cfg():
    return WhisperConfig(name="t", **TINY)


def _block_payload(rng, ttype, n):
    """n elements of one GGML tensor type as valid block bytes: f16 scales
    and mins drawn from a normal, every code byte random."""
    if ttype == tw.GGML_F16:
        return rng.standard_normal(n).astype(np.float16).tobytes()
    block_n, block_b = tw._TENSOR_TYPE_SIZES[ttype]
    n_f16 = 2 if ttype in (tw.GGML_Q4_1, tw.GGML_Q5_1) else 1
    out = bytearray()
    for _ in range(n // block_n):
        out += (rng.standard_normal(n_f16) * 0.05).astype(np.float16).tobytes()
        out += rng.integers(0, 256, block_b - 2 * n_f16, np.uint8).tobytes()
    return bytes(out)


def _write_quant_ggml(path, cfg, tensors, seed=3):
    """write_ggml's layout with every tensor whose size allows it stored in
    one of the quantized types (cycling through them), the rest F32.
    Returns the tensor type used per name."""
    rng = np.random.default_rng(seed)
    types = {}
    write_ggml(path, cfg, {})  # header, filterbank and vocabulary
    with open(path, "rb") as f:
        out = bytearray(f.read())
    for i, (name, arr) in enumerate(tensors.items()):
        ttype = QUANT_TYPES[i % len(QUANT_TYPES)] if arr.size % 32 == 0 else tw.GGML_F32
        nb = name.encode()
        dims = list(reversed(arr.shape))
        out += struct.pack("<3i", len(dims), len(nb), ttype)
        out += struct.pack(f"<{len(dims)}i", *dims)
        out += nb
        out += (arr.tobytes() if ttype == tw.GGML_F32
                else _block_payload(rng, ttype, arr.size))
        types[name] = ttype
    with open(path, "wb") as f:
        f.write(bytes(out))
    return types


@pytest.mark.parametrize("ttype", [tw.GGML_F32, *QUANT_TYPES])
def test_dequant_equals_reference(ttype):
    """Each tensor type's block bytes dequantize to the reference's floats,
    bit for bit (random codes in every nibble and high bit)."""
    rng = np.random.default_rng(ttype)
    n = 32 * 40
    if ttype == tw.GGML_F32:
        payload = rng.standard_normal(n).astype(np.float32).tobytes()
    else:
        payload = _block_payload(rng, ttype, n)
    got = tw._dequant(payload, ttype, n)
    ref = jw._dequant(payload, ttype, n)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert tw._TENSOR_TYPE_SIZES == jw._TENSOR_TYPE_SIZES
    assert tw.GGML_MAGIC == jw.GGML_MAGIC


def test_dequant_refuses_unknown_type():
    with pytest.raises((ValueError, KeyError)):
        tw._dequant(b"\0" * 64, 9, 32)


def test_ggml_loader_equals_reference(tmp_path, tiny_cfg):
    """Config, tensors, filterbank and vocabulary of an F32 file and of a
    file holding every quantized type: equal to the reference's."""
    tensors = _tensors(tiny_cfg)
    for name, write in (("f32.bin", lambda p: write_ggml(p, tiny_cfg, tensors)),
                        ("quant.bin", lambda p: _write_quant_ggml(p, tiny_cfg, tensors))):
        path = str(tmp_path / name)
        write(path)
        cfg, t, fb, vocab = tw.load_ggml(path)
        jcfg, jt, jfb, jvocab = jw.load_ggml(path)
        assert cfg.__dict__ == jcfg.__dict__
        assert set(t) == set(jt)
        for k in jt:
            assert np.array_equal(t[k], jt[k]), k
        assert np.array_equal(fb, jfb) and fb.shape == (tiny_cfg.n_mels, 201)
        assert vocab == jvocab
    types = _write_quant_ggml(str(tmp_path / "q.bin"), tiny_cfg, tensors)
    assert set(types.values()) == {tw.GGML_F32, *QUANT_TYPES}
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(ValueError, match="not a ggml file"):
        tw.load_ggml(str(tmp_path / "bad.bin"))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_params_from_openai_tensors_equals_reference(tiny_cfg, dtype):
    t = _tensors(tiny_cfg)
    _tree_equal(tw.params_from_openai_tensors(t, tiny_cfg, dtype=dtype),
                jw.params_from_openai_tensors(t, tiny_cfg, dtype=dtype))


def _openai_to_hf(name):
    """The inverse of the reference's HF -> OpenAI name map."""
    for hf, oa in jw._HF_TO_OPENAI:
        if name.startswith(oa):
            return hf + name[len(oa):]
    side, _, idx, rest = name.split(".", 3)
    for hf_key, oa_key in jw._HF_LAYER_MAP.items():
        if rest.startswith(oa_key + "."):
            return f"model.{side}.layers.{idx}.{hf_key}.{rest[len(oa_key) + 1:]}"
    raise KeyError(name)


def _hf_tensors(cfg, seed=1, dtype=np.float32):
    t = {_openai_to_hf(k): v.astype(dtype) for k, v in _tensors(cfg, seed).items()}
    # An HF checkpoint also stores the encoder's positions and the tied
    # output projection.
    t["model.encoder.embed_positions.weight"] = np.zeros(
        (cfg.n_audio_ctx, cfg.n_audio_state), dtype)
    t["proj_out.weight"] = t["model.decoder.embed_tokens.weight"]
    return t


def _hf_config_json(cfg):
    return {"num_mel_bins": cfg.n_mels, "max_source_positions": cfg.n_audio_ctx,
            "d_model": cfg.n_audio_state,
            "encoder_attention_heads": cfg.n_audio_head,
            "encoder_layers": cfg.n_audio_layer, "vocab_size": cfg.n_vocab,
            "max_target_positions": cfg.n_text_ctx,
            "decoder_attention_heads": cfg.n_text_head,
            "decoder_layers": cfg.n_text_layer}


def _write_hf_dir(path, cfg, dtype=np.float32, seed=1):
    """An HF directory: the tensors split over two .safetensors files, a
    config.json and a vocab.json."""
    os.makedirs(path, exist_ok=True)
    t = _hf_tensors(cfg, seed, dtype)
    names = sorted(t)
    save_file({k: t[k] for k in names[::2]}, os.path.join(path, "model-00001.safetensors"))
    save_file({k: t[k] for k in names[1::2]}, os.path.join(path, "model-00002.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config_json(cfg), f)
    enc = jtok._bytes_to_unicode()
    table = {"".join(enc[b] for b in tok): i
             for tok, i in jtok.make_test_vocab().items()}
    table["<|endoftext|>"] = cfg.eot
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(table, f)
    return t


def test_hf_name_mapping_equals_reference(tiny_cfg):
    t = _hf_tensors(tiny_cfg)
    t["model.decoder.layers.0.unknown.weight"] = np.zeros(3, np.float32)
    got, ref = tw.hf_to_openai_names(t), jw.hf_to_openai_names(t)
    assert list(got) == list(ref)
    assert "proj_out.weight" not in got and "encoder.positional_embedding" in got


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_safetensors_dir_equals_reference(tmp_path, tiny_cfg, dtype):
    """load_params on an HF directory (two shards, F32 or F16, config.json)
    gives the reference's config and numpy tree."""
    path = str(tmp_path / "hf")
    _write_hf_dir(path, tiny_cfg, dtype)
    cfg, tree, extras = tw.load_params(path)
    jcfg, jtree, jextras = jw.load_params(path)
    assert cfg.__dict__ == jcfg.__dict__ and extras == jextras == {}
    _tree_equal(tree, jtree)
    assert tw.load_safetensors_dir(path).keys() == jw.load_safetensors_dir(path).keys()


def test_safetensors_reader_equals_package(tmp_path):
    """Every dtype safetensors.numpy reads, read by the port to the same
    arrays; BF16, which it does not read, raises ValueError by name."""
    rng = np.random.default_rng(5)
    arrays = {
        "f64": rng.standard_normal((2, 3)), "f32": rng.standard_normal((4,)).astype(np.float32),
        "f16": rng.standard_normal((3, 2)).astype(np.float16),
        "i64": rng.integers(-9, 9, (5,)), "u64": rng.integers(0, 9, (2,)).astype(np.uint64),
        "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "u32": rng.integers(0, 9, (3,)).astype(np.uint32),
        "i16": rng.integers(-9, 9, (3,)).astype(np.int16),
        "u16": rng.integers(0, 9, (3,)).astype(np.uint16),
        "i8": rng.integers(-9, 9, (7,)).astype(np.int8),
        "u8": rng.integers(0, 9, (1, 7)).astype(np.uint8),
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "c64": (rng.standard_normal(3) + 1j).astype(np.complex64),
        "empty": np.zeros((0, 3), np.float32), "scalar": np.array(2.5, np.float32),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(arrays, path, metadata={"k": "v"})
    got, ref = tw.load_safetensors(path), load_file(path)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k
    # A BF16 tensor: the header names the dtype, the bytes are 2 per value.
    header = json.dumps({"w": {"dtype": "BF16", "shape": [2], "data_offsets": [0, 4]}})
    with open(tmp_path / "bf16.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header.encode() + b"\0" * 4)
    with pytest.raises(ValueError, match="BF16"):
        tw.load_safetensors(str(tmp_path / "bf16.safetensors"))
    os.makedirs(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        tw.load_safetensors_dir(str(tmp_path / "none"))


def _tiktoken_file(path, vocab):
    with open(path, "wb") as f:
        for tok, i in sorted(vocab.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok) + b" " + str(i).encode() + b"\n")


@pytest.mark.parametrize("kind", ["vocab.json", "multilingual.tiktoken", "gpt2.tiktoken",
                                  "vocab.tiktoken", "both"])
def test_load_tokenizer_equals_reference(tmp_path, tiny_cfg, kind):
    """load_tokenizer from an HF vocab.json or a .tiktoken file (a tiktoken
    file wins over vocab.json, as in the reference): the reference's
    vocabulary and encodings."""
    vocab = jtok.make_test_vocab()
    if kind in ("vocab.json", "both"):
        _write_hf_dir(str(tmp_path), tiny_cfg)
    if kind != "vocab.json":
        name = "multilingual.tiktoken" if kind == "both" else kind
        _tiktoken_file(str(tmp_path / name), {**vocab, b"\xff\xfe": 999})
    got = ttok.load_tokenizer(tiny_cfg, str(tmp_path))
    ref = jtok.load_tokenizer(JConfig(**tiny_cfg.__dict__), str(tmp_path))
    assert got.vocab == ref.vocab
    assert (b"\xff\xfe" in got.vocab) == (kind != "vocab.json")
    text = " hello world, the test_ing"
    assert got.encode(text) == ref.encode(text)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(tiny_cfg, str(tmp_path / "missing"))


def test_alignment_heads_sidecar_equals_reference(tmp_path):
    model = tmp_path / "m.bin"
    model.write_bytes(b"")
    assert talign.load_alignment_heads(str(model)) is None
    (tmp_path / "alignment_heads.json").write_text(json.dumps([[1, 0], [1, 3], [0, 2]]))
    for p in (str(model), str(tmp_path)):
        assert talign.load_alignment_heads(p) == jalign.load_alignment_heads(p) \
            == [(1, 0), (1, 3), (0, 2)]


def _audio(seconds, seed=4):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def _params(cls, **kw):
    return cls(language="en", condition_on_previous_text=False, temperatures=(0.0,),
               max_tokens=8, **kw)


def _transcribe_both(path, audios, **kw):
    port = WhisperEngine(device="cpu")
    port.load_model(path)
    ref = JaxEngine()
    ref.load_model(path)
    got = port.transcribe_batch(audios, _params(TranscribeParams, **kw))
    want = ref.transcribe_batch(audios, _params(JParams, **kw))
    return port, ref, got, want


def test_engine_loads_ggml_like_the_jax_engine(tmp_path, tiny_cfg):
    """A GGML file holding every tensor type: the engine's tensors, its
    filterbank and vocabulary are the reference loader's, and it
    transcribes to the JAX engine's tokens and segments, on the file's
    filterbank."""
    path = str(tmp_path / "tiny-model.bin")
    _write_quant_ggml(path, tiny_cfg, _tensors(tiny_cfg))
    audios = [_audio(1.0), _audio(2.5, seed=5)]
    port, ref, got, want = _transcribe_both(path, audios)
    assert np.array_equal(port.mel_filters.numpy(), np.asarray(ref.mel_filters))
    assert port.tokenizer.vocab == ref.tokenizer.vocab
    assert np.array_equal(port.params["decoder"]["blocks"]["wq"].numpy(),
                          np.asarray(ref.params["decoder"]["blocks"]["wq"]))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [[(s.start, s.end, s.text) for s in r.segments] for r in got] == \
        [[(s.start, s.end, s.text) for s in r.segments] for r in want]
    assert any(r.tokens for r in got)
    port.unload_model()
    assert port.mel_filters is None and port.alignment_heads is None


def test_engine_loads_safetensors_like_the_jax_engine(tmp_path, tiny_cfg):
    """An HF directory with vocab.json and an alignment_heads.json: the
    JAX engine's tokens, its heads; a reload from a GGML file and back
    resets the filterbank."""
    path = str(tmp_path / "hf")
    _write_hf_dir(path, tiny_cfg)
    with open(os.path.join(path, "alignment_heads.json"), "w") as f:
        json.dump([[0, 1]], f)
    port, ref, got, want = _transcribe_both(path, [_audio(1.0)])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert port.alignment_heads == ref.alignment_heads == [(0, 1)]
    assert port.mel_filters is None and port.tokenizer.vocab == ref.tokenizer.vocab
    ggml = str(tmp_path / "g.bin")
    write_ggml(ggml, tiny_cfg, _tensors(tiny_cfg))
    port.load_model(ggml)
    assert port.mel_filters is not None and port.alignment_heads is None
    port.load_model(path)
    assert port.mel_filters is None and port.alignment_heads == [(0, 1)]


def test_engine_loads_npz_with_tokenizer_files_beside_it(tmp_path, tiny_cfg):
    """A spittle .npz that embeds no vocabulary takes the vocab.json beside
    it, as the reference engine does."""
    jcfg = JConfig(**tiny_cfg.__dict__)
    tree = jw.params_from_openai_tensors(_tensors(tiny_cfg), jcfg)
    path = str(tmp_path / "m.npz")
    jw.save_npz_checkpoint(path, jcfg, jax.tree.map(jnp.asarray, tree))
    _write_hf_dir(str(tmp_path / "unused"), tiny_cfg)
    os.replace(tmp_path / "unused" / "vocab.json", tmp_path / "vocab.json")
    port, ref, got, want = _transcribe_both(path, [_audio(1.0)])
    assert port.tokenizer.vocab == ref.tokenizer.vocab
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_ggml_filterbank_drives_the_mel(tmp_path, tiny_cfg):
    """write_ggml's filterbank (0, 1, 2, ... row-major, not librosa's)
    changes the mel, and the port's mel under it equals the reference's."""
    path = str(tmp_path / "g.bin")
    filters = write_ggml(path, tiny_cfg, _tensors(tiny_cfg))
    assert not np.allclose(filters, mel_filterbank(tiny_cfg.n_mels))
    audio = _audio(1.0)[None]
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=80,
                              filters=torch.from_numpy(filters)).numpy()
    ref = np.asarray(jax_mel(jnp.asarray(audio), n_mels=80, filters=jnp.asarray(filters)))
    librosa = log_mel_spectrogram(torch.from_numpy(audio), n_mels=80).numpy()
    # log10 of f32 mel energies: the STFT and the projection's summation
    # order differ (torch.stft against the reference's factored DFT).
    np.testing.assert_allclose(got, ref, atol=2e-4)
    assert np.abs(got - librosa).max() > 0.1
    eng = WhisperEngine(device="cpu")
    eng.load_model(path)
    assert np.array_equal(eng.mel_filters.numpy(), filters)


def test_port_loads_checkpoints_without_jax_or_safetensors(tmp_path, tiny_cfg):
    """In a process where importing jax, spittle_tpu or safetensors raises
    ImportError, as on the card machine, the port loads a GGML file and an
    HF directory and transcribes both."""
    ggml = str(tmp_path / "g.bin")
    _write_quant_ggml(ggml, tiny_cfg, _tensors(tiny_cfg))
    hf = str(tmp_path / "hf")
    _write_hf_dir(hf, tiny_cfg)
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'spittle_tpu', 'safetensors'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from spittle_tpu_torch.engine.base import TranscribeParams\n"
        "from spittle_tpu_torch.engine.whisper_engine import WhisperEngine\n"
        "for path in sys.argv[1:]:\n"
        "    eng = WhisperEngine(device='cpu')\n"
        "    eng.load_model(path)\n"
        "    r = eng.transcribe_samples(np.zeros(16000, np.float32),\n"
        "        TranscribeParams(language='en', temperatures=(0.0,), max_tokens=4))\n"
        "    print(type(r.text).__name__, eng.cfg.n_audio_state)\n"
        "try:\n"
        "    import safetensors\n"
        "except ImportError:\n"
        "    print('blocked')\n"
        "assert not any(n.split('.')[0] in ('jax', 'spittle_tpu', 'safetensors')\n"
        "               for n in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, ggml, hf], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:3] == ["str 8", "str 8", "blocked"]
