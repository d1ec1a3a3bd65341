"""spittle_tpu_torch's engine and weights against the JAX reference on the
CPU: the whole slice on the trained tiny checkpoint (goldens and the JAX
engine's parallel-windows output), the npz loader and the cast rule, the
device rule, the paths that are not ported yet, and that the port imports
neither JAX nor the JAX package. The app's path (transcribe_samples, the ladder and
language detection) is held in tests/test_torch_app_path.py.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.engine.whisper_engine import _cast_params_bf16
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.config import CONFIGS as JCONFIGS
from spittle_tpu.models.whisper.weights import (
    load_npz_checkpoint as jax_load_npz,
)
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper.config import CONFIGS
from spittle_tpu_torch.models.whisper.weights import (
    cast_params,
    load_npz_checkpoint,
    params_from_jax,
    random_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


def _stream_params(cls, **kw):
    return cls(language="en", condition_on_previous_text=False,
               temperatures=(0.0,), parallel_windows=True, **kw)


def _as_dicts(results):
    return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                 segments=[(s.start, s.end, s.text) for s in r.segments])
            for r in results]


@pytest.mark.parametrize("wire", ["auto", "mulaw"])
def test_stream_on_trained_tiny_matches_goldens_and_reference(goldens, wire):
    cases = goldens["cases"]
    audio = [tcc.utterance(c["word_ids"])[0] for c in cases]
    batches = [audio[:4], audio[4:]]
    port = WhisperEngine(device="cpu", wire=wire)
    port.load_model(NPZ)
    got = [r for b in port.transcribe_stream(batches, _stream_params(TranscribeParams),
                                             overlap_fetch=True) for r in b]
    ref_eng = JaxEngine(wire=wire)
    ref_eng.load_model(NPZ)
    ref = [r for b in ref_eng.transcribe_stream(batches, _stream_params(JParams),
                                                overlap_fetch=True) for r in b]
    if wire == "auto":  # the goldens were made from the f32 audio
        for r, c in zip(got, cases):
            assert r.tokens == c["greedy_tokens"], c["word_ids"]
            assert r.text.strip() == c["expected_text"].strip()
    # Tokens, text and segments identical to the reference engine.
    assert _as_dicts(got) == _as_dicts(ref)


@pytest.mark.parametrize("quantize_decoder", ["int8", "int4"])
def test_quantized_leg_on_trained_tiny_matches_reference(goldens, quantize_decoder):
    """bench.py's large-v3 leg options (W8A8 encoder, quantized decoder and
    cross-K/V, int8 self-cache, mu-law wire) through transcribe_stream:
    tokens, text and segments equal to the JAX engine with the same
    options. Held against the JAX engine, not the goldens: quantization
    may move tokens away from the goldens in both packages alike."""
    cases = goldens["cases"]
    audio = [tcc.utterance(c["word_ids"])[0] for c in cases]
    batches = [audio[:4], audio[4:]]
    opts = dict(quantize_encoder=True, quantize_decoder=quantize_decoder,
                quantize_cache=True, wire="mulaw")
    port = WhisperEngine(device="cpu", **opts)
    port.load_model(NPZ)
    got = [r for b in port.transcribe_stream(batches, _stream_params(TranscribeParams),
                                             overlap_fetch=True) for r in b]
    ref_eng = JaxEngine(**opts)
    ref_eng.load_model(NPZ)
    ref = [r for b in ref_eng.transcribe_stream(batches, _stream_params(JParams),
                                                overlap_fetch=True) for r in b]
    assert _as_dicts(got) == _as_dicts(ref)
    assert any(r.tokens for r in got)  # the windows decoded something


@pytest.mark.parametrize("value,exc", [
    ("w8a8", None),
    ("int2", ValueError),
    (8, ValueError),
])
def test_quantize_decoder_option_checks(value, exc):
    """Unknown widths are refused; "w8a8" is taken: the weight-only int8
    decoder with "qw8" cross-K/V (tests/test_torch_w8a8_decoder.py holds
    its decodes against the reference)."""
    if exc is None:
        eng = WhisperEngine(device="cpu", quantize_decoder=value)
        eng.load_model(NPZ)
        opts = eng._decode_options(TranscribeParams())
        assert opts.quant_kv and opts.quant_kv_w8a8 and opts.quant_kv_bits == 8
        assert set(eng.params["decoder"]["blocks"]["wq"]) == {"qw", "scale"}
        return
    with pytest.raises(exc, match="quantize_decoder"):
        WhisperEngine(device="cpu", quantize_decoder=value)


def test_long_audio_overlap_stitch_matches_reference(goldens):
    """Two utterances back to back (60 s) decode as overlapping windows;
    plan, parse and stitch must give the reference engine's result."""
    cases = goldens["cases"]
    long_audio = [np.concatenate([tcc.utterance(cases[i]["word_ids"])[0],
                                  tcc.utterance(cases[i + 1]["word_ids"])[0][:16000 * 12]])
                  for i in (0, 2)]
    port = WhisperEngine(device="cpu")
    port.load_model(NPZ)
    ref_eng = JaxEngine()
    ref_eng.load_model(NPZ)
    got = port.transcribe_batch(
        long_audio, _stream_params(TranscribeParams, parallel_overlap_s=2.0))
    ref = ref_eng.transcribe_batch(
        long_audio, _stream_params(JParams, parallel_overlap_s=2.0))
    assert _as_dicts(got) == _as_dicts(ref)
    assert got[0].text  # the windows were not all skipped as silence


def test_initial_prompt_matches_reference(goldens):
    """A prompt prefix ([sot_prev, *prompt] before the SOT sequence)."""
    cases = goldens["cases"][:3]
    audio = [tcc.utterance(c["word_ids"])[0] for c in cases]
    port = WhisperEngine(device="cpu")
    port.load_model(NPZ)
    ref_eng = JaxEngine()
    ref_eng.load_model(NPZ)
    prompt = dict(initial_prompt="hello world", max_tokens=8)
    got = port.transcribe_batch(audio, _stream_params(TranscribeParams, **prompt))
    ref = ref_eng.transcribe_batch(audio, _stream_params(JParams, **prompt))
    assert _as_dicts(got) == _as_dicts(ref)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default engine would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WhisperEngine()
    eng = WhisperEngine(device="cpu")
    assert eng.device.type == "cpu"
    assert eng.dtype == torch.float32  # bf16 is the default on the card only


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(parallel_windows=True, condition_on_previous_text=True), ValueError,
     "condition_on_previous_text"),
    (dict(draft="load_draft_model"), None, None),
    (dict(draft="load_self_draft"), None, None),
])
def test_unported_paths_raise(goldens, kwargs, exc, match):
    """Parallel windows with prompt carry is refused as the reference
    refuses it. Speculative decoding, once unported, now runs with either
    way of loading its draft: the goldens' greedy tokens, with the
    speculative statistics recorded (tests/test_torch_speculative.py
    holds it against the reference)."""
    eng = WhisperEngine(device="cpu")
    eng.load_model(NPZ)
    base = dict(language="en", condition_on_previous_text=False,
                temperatures=(0.0,), parallel_windows=True)
    kwargs = dict(kwargs)
    draft = kwargs.pop("draft", None)
    base.update(kwargs)
    if draft:
        getattr(eng, draft)(*((NPZ,) if draft == "load_draft_model" else ()))
        case = goldens["cases"][0]
        res = eng.transcribe_batch([tcc.utterance(case["word_ids"])[0]],
                                   TranscribeParams(**base))
        assert res[0].tokens == case["greedy_tokens"]
        assert eng.last_spec_stats["rounds"] > 0
        return
    with pytest.raises(exc, match=match):
        eng.transcribe_batch([np.zeros(16000, np.float32)], TranscribeParams(**base))


def test_npz_loader_and_cast_rule_match_reference():
    cfg, params, extras = load_npz_checkpoint(NPZ)
    jcfg, jparams, jextras = jax_load_npz(NPZ)
    assert cfg.__dict__ == jcfg.__dict__
    assert extras["vocab"] == jextras["vocab"]
    jax.tree.map(np.testing.assert_array_equal, params, jparams)
    cast = cast_params(params_from_jax(params), torch.bfloat16)
    jcast = _cast_params_bf16(jax.tree.map(jax.numpy.asarray, jparams))
    flat = jax.tree_util.tree_leaves_with_path(jcast)
    for path, leaf in flat:
        node = cast
        for k in path:
            node = node[k.key]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_random_params_has_the_reference_tree():
    cfg = CONFIGS["tiny"]
    ours = random_params(cfg, seed=0)
    ref = jax.eval_shape(lambda: jmod.init_params(JCONFIGS["tiny"]))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       ours)
    assert got == shapes
    again = random_params(cfg, seed=0)
    torch.testing.assert_close(again["decoder"]["tok_emb"],
                               ours["decoder"]["tok_emb"], rtol=0, atol=0)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spittle_tpu_torch\n"
        "for m in pkgutil.walk_packages(spittle_tpu_torch.__path__, 'spittle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'spittle_tpu'\n"
        "             or n.startswith('spittle_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('spittle_tpu_torch.')]))\n"
        "assert not bad, bad\n"
        # The card machine has neither PyYAML nor the safetensors package.
        "absent = sorted(n for n in sys.modules\n"
        "                if n.split('.')[0] in ('yaml', 'safetensors'))\n"
        "assert not absent, absent\n"
        "for family in ('parakeet', 'sensevoice', 'moonshine'):\n"
        "    assert 'spittle_tpu_torch.engine.%s_engine' % family in sys.modules\n"
        "    for part in ('model', 'weights'):\n"
        "        assert 'spittle_tpu_torch.models.%s.%s' % (family, part) in sys.modules\n"
        "for name in ('models.whisper.speculative', 'models.t5.model',\n"
        "             'models.t5.weights', 'models.parakeet.decode', 'models.parakeet.features',\n"
        "             'models.parakeet.nemo', 'io.npz_checkpoint', 'io.protobuf',\n"
        "             'text.lang_id', 'parallel.serving', 'parallel.http_server',\n"
        "             'parallel.mesh', 'parallel.multihost', 'parallel.pipeline_parallel',\n"
        "             'parallel.expert_parallel', 'parallel.dryrun', 'io.onnx_proto',\n"
        "             'audio.resample', 'audio.wav', 'audio.vad.silero',\n"
        "             'audio.vad.smoothed', 'audio.vad.segmenter', 'utils.tracing',\n"
        "             'utils.threads', 'utils.logging'):\n"
        "    assert 'spittle_tpu_torch.' + name in sys.modules, name\n"
        # Importing the mesh layer's modules starts no process group.
        "import torch.distributed\n"
        "assert not torch.distributed.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 76  # every submodule was imported
