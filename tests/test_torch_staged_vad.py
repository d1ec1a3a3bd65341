"""WhisperEngine's serving seam (stage_batch / transcribe_staged) and its
VAD-gated long-form call (transcribe_vad_segments) against the JAX engine
on the CPU, on the trained tiny checkpoint. Exact: tokens, texts, segment
timestamps and words."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu_torch.audio.vad.silero import load_silero_params
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.join(REPO, "tests"))
import train_committed_checkpoint as tcc  # noqa: E402
from test_torch_vad import synth_vowel  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops per test; beside the suite's other workers,
    intra-op threads only oversubscribe the cores. One thread for this
    module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)["cases"]


@pytest.fixture(scope="module")
def engines():
    port = WhisperEngine(device="cpu")
    port.load_model(NPZ)
    ref = JaxEngine()
    ref.load_model(NPZ)
    return port, ref


def _view(results):
    return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                 segments=[(s.start, s.end, s.text) for s in r.segments],
                 words=[(w.word, w.start, w.end) for w in r.words])
            for r in results]


@pytest.mark.parametrize("params", [
    TranscribeParams(),
    TranscribeParams(parallel_windows=False, condition_on_previous_text=False),
    TranscribeParams(parallel_windows=True),
])
def test_stage_batch_is_none_for_sequential_params(engines, params):
    port, _ = engines
    assert port.stage_batch([np.zeros(16000, np.float32)], params) is None


def test_stage_batch_needs_a_model():
    eng = WhisperEngine(device="cpu")
    with pytest.raises(RuntimeError, match="no model loaded"):
        eng.stage_batch([np.zeros(160, np.float32)],
                        TranscribeParams(parallel_windows=True,
                                         condition_on_previous_text=False))


@pytest.mark.parametrize("wire,overlap", [("auto", 0.0), ("mulaw", 2.0)])
def test_transcribe_staged_equals_transcribe_batch(engines, cases, wire, overlap):
    """transcribe_staged(stage_batch(b)) equals transcribe_batch(b) and the
    JAX engine's staged call; the handle holds the plan, the placed window
    batch (and its copy event, None on the CPU), content frames and the
    overlap."""
    port, ref = engines
    port.wire = wire
    try:
        batch = [tcc.utterance(c["word_ids"])[0] for c in cases[:3]]
        batch.append(np.concatenate([batch[0], batch[1][:16000 * 10]]))  # 2 windows
        batch.append((batch[2] * 32767).astype(np.int16))
        kw = dict(language="en", parallel_windows=True,
                  condition_on_previous_text=False, temperatures=(0.0,),
                  parallel_overlap_s=overlap)
        handle = port.stage_batch(batch, TranscribeParams(**kw))
        audios, (plan, placed, content_frames, overlap_frames), params = handle
        dev, ready = placed
        assert len(audios) == 5 and params == TranscribeParams(**kw)
        assert dev.shape[0] == len(plan) == 6 and ready is None
        assert dev.dtype == (torch.uint8 if wire == "mulaw" else torch.float32)
        assert overlap_frames == int(overlap * 100)
        got = port.transcribe_staged(handle)
        assert _view(got) == _view(port.transcribe_batch(batch, TranscribeParams(**kw)))
        ref.wire = wire
        want = ref.transcribe_staged(ref.stage_batch(batch, JParams(**kw)))
        assert _view(got) == _view(want)
        for r, c in zip(got[:3], cases[:3]):
            if wire == "auto" and not overlap:
                assert r.tokens == c["greedy_tokens"]
    finally:
        port.wire = ref.wire = "auto"


def _speech_in_silence(cases):
    """Three of the cases' tone sequences with a quiet synthetic vowel under
    them (pure tones are too weak a speech cue for Silero), between spans
    of faint noise: 18.7 s at 16 kHz."""
    rng = np.random.default_rng(0)

    def noise(s):
        return (0.002 * rng.standard_normal(int(s * 16000))).astype(np.float32)

    parts = [noise(1.5)]
    for c in cases[:3]:
        audio, _, t_end = tcc.utterance(c["word_ids"])
        audio = audio[: int((t_end + 0.1) * 16000)]
        parts += [audio + 0.3 * synth_vowel(len(audio)), noise(2.0)]
    return np.concatenate(parts)


@pytest.mark.parametrize("name", ["default", "parallel_words", "int16"])
def test_transcribe_vad_segments_matches_jax(engines, cases, name):
    """Text, language, segment timestamps and words equal to the JAX
    engine's; the spans are where the speech is."""
    port, ref = engines
    audio = _speech_in_silence(cases)
    kw = {"default": {},
          "parallel_words": dict(language="en", parallel_windows=True,
                                 condition_on_previous_text=False,
                                 temperatures=(0.0,), word_timestamps=True),
          "int16": dict(word_timestamps=True)}[name]
    if name == "int16":
        audio = (audio * 32767).astype(np.int16)
    got = port.transcribe_vad_segments(audio, TranscribeParams(**kw))
    want = ref.transcribe_vad_segments(audio, JParams(**kw))
    assert _view([got]) == _view([want])
    assert got.text and got.language == "en"
    assert len(got.segments) >= 3
    assert got.segments[0].start >= 1.0 and got.segments[-1].end <= 16.0
    if kw.get("word_timestamps"):
        assert got.words


def test_transcribe_vad_segments_silence_and_vad_params(engines):
    port, ref = engines
    silence = (0.001 * np.random.default_rng(1).standard_normal(16000 * 3)).astype(
        np.float32)
    got = port.transcribe_vad_segments(silence)
    assert got.text == "" and got.segments == [] and got.language is None
    assert ref.transcribe_vad_segments(silence).text == ""
    # Weights passed in are used as given (their device decides).
    vad = load_silero_params(device="cpu")
    got = port.transcribe_vad_segments(silence, vad_params=vad)
    assert got.text == ""
