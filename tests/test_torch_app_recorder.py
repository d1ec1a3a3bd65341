"""The port's recorder and its manager against the JAX package on the
CPU: AudioRecordingManager over a QueueSource with each package's
production VAD chain (Silero(0.3) in Smoothed(15, 15, 2)), the recording
state machine, the frame resampler (native where g++ builds
native/spittle_audio.cpp) and the mic-level visualizer. Inputs are
numpy-seeded; every comparison is exact unless it says otherwise."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spittle_tpu.app import services as jservices
from spittle_tpu.audio import recorder as jrec
from spittle_tpu.audio import visualizer as jvis
from spittle_tpu.managers import audio as jaudio
from spittle_tpu.managers import recording_pipeline as jrp
from spittle_tpu.native import resampler as jres
from spittle_tpu_torch.app import services as tservices
from spittle_tpu_torch.audio import recorder as trec
from spittle_tpu_torch.audio import visualizer as tvis
from spittle_tpu_torch.audio.vad.smoothed import VadFrame
from spittle_tpu_torch.managers import audio as taudio
from spittle_tpu_torch.managers import recording_pipeline as trp
from spittle_tpu_torch.native import resampler as tres
from _fresh_sources import FreshSources  # noqa: E402

SR = 16000
CHUNK_S = 0.03


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Silero runs one frame at a time (many small ops); beside the
    suite's other workers intra-op threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synth_vowel(n, sr, f0=120):
    """A glottal pulse train through three formant resonators (the
    synthetic vowel of tests/test_torch_vad.py)."""
    from scipy.signal import lfilter

    pulses = np.zeros(n)
    pulses[:: sr // f0] = 1.0

    def resonator(x, f, bw):
        r = np.exp(-np.pi * bw / sr)
        th = 2 * np.pi * f / sr
        return lfilter([1 - r], [1, -2 * r * np.cos(th), r * r], x)

    v = (resonator(pulses, 700, 80) + 0.7 * resonator(pulses, 1200, 90)
         + 0.3 * resonator(pulses, 2600, 120))
    return (0.5 * v / np.abs(v).max()).astype(np.float32)


def speech_in_silence(sr, seed=0):
    """0.8 s of faint noise, 1.5 s of vowel, 1.2 s of noise, 0.8 s of
    vowel, 1 s of noise, at `sr`."""
    rng = np.random.default_rng(seed)

    def noise(s):
        return (0.002 * rng.standard_normal(int(s * sr))).astype(np.float32)

    return np.concatenate([noise(0.8), synth_vowel(int(1.5 * sr), sr), noise(1.2),
                           synth_vowel(int(0.8 * sr), sr), noise(1.0)])


def record(audio_mod, rec_mod, vad_factory, audio, rate, binding="transcribe"):
    """One push-to-talk recording through a package's manager: start,
    push `audio` in 30 ms chunks, stop. Returns the kept samples."""
    src = FreshSources(rec_mod.QueueSource, rate)
    mgr = audio_mod.AudioRecordingManager(source_factory=src,
                                          vad_factory=vad_factory)
    try:
        assert mgr.try_start_recording(binding)
        step = int(CHUNK_S * rate)
        for i in range(0, len(audio), step):
            src.push(audio[i:i + step])
        return mgr.stop_recording(binding)
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("rate", [16000, 48000])
def test_manager_with_each_vad_factory_keeps_the_same_samples(rate):
    """The JAX manager with the JAX default_vad_factory and the port's
    manager with its own default_vad_factory(device="cpu") keep the same
    samples from the same frames: the smoothed chain's speech (pre-roll
    included) and none of the trailing silence."""
    audio = speech_in_silence(rate, seed=rate)
    want = record(jaudio, jrec, jservices.default_vad_factory, audio, rate)
    got = record(taudio, trec,
                 lambda: tservices.default_vad_factory(device="cpu"), audio, rate)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Speech kept, silence gated: between the first vowel and the whole take.
    assert 1.5 * SR <= len(got) < len(audio) * SR / rate


def test_port_recorder_tests_the_port_vad_kind():
    """The port's recorder keeps frames its own SmoothedVad marks
    VadFrame.SPEECH; the JAX recorder, which tests the JAX enum, drops
    every one of them (the fault a JAX app handed the port's VAD had)."""
    audio = speech_in_silence(SR, seed=1)
    port_vad = lambda: tservices.default_vad_factory(device="cpu")  # noqa: E731
    vad = port_vad()
    kinds = {vad.push_frame(audio[i:i + 480])[0] for i in range(0, len(audio) - 479, 480)}
    assert VadFrame.SPEECH in kinds
    assert len(record(taudio, trec, port_vad, audio, SR)) > SR
    assert len(record(jaudio, jrec, port_vad, audio, SR)) == int(1.25 * SR)  # padding only


def test_manager_without_vad_and_short_padding():
    """No VAD: every pushed sample comes back; a take under 1 s is padded
    to 1.25 s with zeros; a stop by another binding returns None."""
    rng = np.random.default_rng(3)
    long_take = rng.standard_normal(int(1.2 * SR)).astype(np.float32) * 0.1
    short_take = long_take[: SR // 2]
    for audio in (long_take, short_take):
        want = record(jaudio, jrec, None, audio, SR)
        got = record(taudio, trec, None, audio, SR)
        np.testing.assert_array_equal(got, want)
    assert len(got) == int(1.25 * SR)
    mgr = taudio.AudioRecordingManager(source_factory=lambda: trec.QueueSource(SR))
    try:
        assert mgr.try_start_recording("a")
        assert mgr.stop_recording("b") is None
        assert mgr.is_recording()
    finally:
        mgr.shutdown()


OPS = st.lists(st.tuples(
    st.sampled_from(["can_attempt_start", "commit_start", "stop_for_binding",
                     "cancel", "is_recording", "active_binding"]),
    st.sampled_from(["transcribe", "transcribe_with_post_process", "cancel"])),
    max_size=30)


@settings(max_examples=80, deadline=None)
@given(OPS)
def test_recording_pipeline_state_machine(ops):
    """The same operation sequence gives the same answers in both state
    machines (results compared by class name and fields)."""
    jp, tp = jrp.RecordingPipeline(), trp.RecordingPipeline()
    for name, binding in ops:
        args = (binding,) if name in ("commit_start", "stop_for_binding") else ()
        want, got = getattr(jp, name)(*args), getattr(tp, name)(*args)
        assert type(got).__name__ == type(want).__name__
        assert getattr(got, "__dict__", got) == getattr(want, "__dict__", want)


@settings(max_examples=40, deadline=None)
@given(st.booleans(), st.one_of(st.none(), st.integers(0, 30_000)),
       st.integers(0, 30_000), st.integers(1, 20_000))
def test_health_recovery_predicate(recording, last, now, threshold):
    args = (recording, last, now, threshold)
    assert (trp.should_trigger_health_recovery(*args)
            == jrp.should_trigger_health_recovery(*args))


def _frames(resampler, audio, chunks):
    frames, pos = [], 0
    for c in chunks:
        resampler.push(audio[pos:pos + c], frames.append)
        pos += c
    resampler.finish(frames.append)
    assert all(len(f) == 480 for f in frames)
    return np.concatenate(frames) if frames else np.zeros(0, np.float32)


@pytest.mark.parametrize("in_hz", [16000, 48000, 44100, 22050, 8000])
def test_make_frame_resampler_matches_reference(in_hz):
    """make_frame_resampler keeps the reference's choice (native when g++
    builds it) and its frames equal the JAX package's, bit for bit."""
    rng = np.random.default_rng(in_hz)
    audio = rng.standard_normal(in_hz // 2 + 77).astype(np.float32)
    chunks, left = [], len(audio)
    while left:
        chunks.append(min(left, int(rng.integers(50, 2000))))
        left -= chunks[-1]
    ours = tres.make_frame_resampler(in_hz)
    assert tres.native_resampler_available()
    assert type(ours).__name__ == type(jres.make_frame_resampler(in_hz)).__name__
    assert isinstance(ours, tres.NativeFrameResampler)
    got = _frames(ours, audio, chunks)
    want = _frames(jres.make_frame_resampler(in_hz), audio, chunks)
    np.testing.assert_array_equal(got, want)


def test_visualizer_levels():
    """AudioVisualizer.feed gives the same mic-level bands."""
    rng = np.random.default_rng(5)
    audio = np.concatenate([0.3 * np.sin(2 * np.pi * 800 * np.arange(SR) / SR),
                            0.01 * rng.standard_normal(SR)]).astype(np.float32)
    jv, tv = jvis.AudioVisualizer(sample_rate=SR), tvis.AudioVisualizer(sample_rate=SR)
    for i in range(0, len(audio), 700):
        want, got = jv.feed(audio[i:i + 700]), tv.feed(audio[i:i + 700])
        assert (got is None) == (want is None)
        if got is not None:
            assert list(got) == list(want)


def test_default_vad_factory_needs_a_card_by_default():
    """default_vad_factory() and AppServices() run on the card unless the
    caller passes device="cpu": without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tservices.default_vad_factory()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tservices.AppServices("unused-data-dir")
