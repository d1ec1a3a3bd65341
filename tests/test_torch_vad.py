"""spittle_tpu_torch's Silero VAD, its smoothing and the offline segmenter
against the JAX package on the CPU, on numpy-seeded audio and the bundled
weights. Tolerances are stated per test."""

import filecmp

import numpy as np
import pytest
import torch

from spittle_tpu.audio.vad import segmenter as jseg
from spittle_tpu.audio.vad import silero as jsil
from spittle_tpu.audio.vad import smoothed as jsm
from spittle_tpu_torch.audio.vad import segmenter as tseg
from spittle_tpu_torch.audio.vad import silero as tsil
from spittle_tpu_torch.audio.vad import smoothed as tsm

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops per test; beside the suite's other workers,
    intra-op threads only oversubscribe the cores. One thread for this
    module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synth_vowel(n, sr=SR, f0=120):
    """A glottal pulse train through three formant resonators (the JAX
    tests' synthetic vowel)."""
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


def speech_in_silence(seed=0):
    """1 s of faint noise, 2 s of vowel, 1.5 s of noise, 1 s of vowel,
    1 s of noise (6.5 s at 16 kHz)."""
    rng = np.random.default_rng(seed)

    def noise(s):
        return (0.002 * rng.standard_normal(int(s * SR))).astype(np.float32)

    return np.concatenate([noise(1.0), synth_vowel(2 * SR), noise(1.5),
                           synth_vowel(SR), noise(1.0)])


@pytest.fixture(scope="module")
def jparams():
    return jsil.load_silero_params()


@pytest.fixture(scope="module")
def tparams():
    return tsil.load_silero_params(device="cpu")


def test_bundled_npz_is_the_reference_file():
    assert filecmp.cmp(tsil.BUNDLED_NPZ, jsil.BUNDLED_NPZ, shallow=False)


def test_weights_across(jparams):
    """silero_params_from_jax of the JAX tree equals the bundled load, and
    the LSTM gates are the ONNX rows permuted to (i, f, g, o)."""
    ours = tsil.silero_params_from_jax(jparams, device="cpu")
    ref = tsil.load_silero_params(device="cpu")
    for a, b in zip(ours["lstm"].parameters(), ref["lstm"].parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    w = np.asarray(jparams["lstm"][1]["w"])
    h = tsil.LSTM_HIDDEN
    got = ours["lstm"].weight_ih_l1.numpy()
    for torch_gate, onnx_gate in enumerate((0, 2, 3, 1)):
        np.testing.assert_array_equal(got[torch_gate * h:(torch_gate + 1) * h],
                                      w[onnx_gate * h:(onnx_gate + 1) * h])
    torch.testing.assert_close(ours["stft_basis"],
                               torch.from_numpy(np.array(jparams["stft_basis"])),
                               rtol=0, atol=0)


def test_onnx_path_raises():
    # A path that is not an .npz goes to the ONNX reader (the reference's
    # rule), which raises for a file that is not there.
    with pytest.raises(FileNotFoundError, match="silero_vad_v4.onnx"):
        tsil.load_silero_params("silero_vad_v4.onnx", device="cpu")


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsil.SileroVad()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsil.load_silero_params()


def test_windows_too_short_for_the_reflect_pads_raise(tparams):
    with pytest.raises(ValueError, match="at least 256"):
        tsil.silero_forward(tparams, np.zeros((1, 255), np.float32),
                            tsil.init_state(1, "cpu"))


@pytest.mark.parametrize("n", [480, 256, 512])
def test_forward_single_frame(jparams, tparams, n):
    """Probability and the [2, 2, 1, 64] state within 1e-5 (f32 convs and
    the LSTM in different summation orders)."""
    rng = np.random.default_rng(n)
    x = (0.1 * rng.standard_normal((1, n))).astype(np.float32)
    pj, sj = jsil.silero_forward(jparams, x, jsil.init_state(1))
    pt, st = tsil.silero_forward(tparams, x, tsil.init_state(1, "cpu"))
    assert tuple(pt.shape) == (1,) and tuple(st.shape) == (2, 2, 1, 64)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_forward_carried_state(jparams, tparams):
    """Six frames of a vowel, the state carried from call to call by each
    side: every probability and state within 1e-5."""
    audio = synth_vowel(480 * 6)
    sj, st = jsil.init_state(1), tsil.init_state(1, "cpu")
    for i in range(6):
        frame = audio[i * 480:(i + 1) * 480][None]
        pj, sj = jsil.silero_forward(jparams, frame, sj)
        pt, st = tsil.silero_forward(tparams, frame, st)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("strides", [(2, 2, 2, 1), (2, 2, 1, 1)])
def test_forward_batch(jparams, tparams, strides):
    """A batch of 5 streams with a random carried state: within 1e-5."""
    rng = np.random.default_rng(7)
    x = (0.2 * rng.standard_normal((5, 480))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((2, 2, 5, 64))).astype(np.float32)
    pj, sj = jsil.silero_forward(jparams, x, s0, strides=strides)
    pt, st = tsil.silero_forward(tparams, x, torch.from_numpy(s0), strides=strides)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_scan_frames_vowel_in_silence(jparams, tparams):
    """Per-frame probabilities of two streams (speech in silence, silence)
    within 1e-5; the vowel's frames are speech, the silence's are not."""
    a = speech_in_silence()
    b = (0.002 * np.random.default_rng(9).standard_normal(len(a))).astype(np.float32)
    n = len(a) // 480 * 480
    batch = np.stack([a[:n], b[:n]])
    pj = np.asarray(jsil.silero_scan_frames(jparams, batch))
    pt = tsil.silero_scan_frames(tparams, torch.from_numpy(batch))
    assert tuple(pt.shape) == pj.shape == (2, n // 480)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-5)
    assert pt[0, 40:60].mean() > 0.3 > pt[1].max()
    # With a carried starting state too.
    s0 = (0.3 * np.random.default_rng(4).standard_normal((2, 2, 2, 64))).astype(
        np.float32)
    pj = np.asarray(jsil.silero_scan_frames(jparams, batch[:, :4800], s0))
    pt = tsil.silero_scan_frames(tparams, batch[:, :4800], torch.from_numpy(s0))
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-5)


def test_single_stream_wrapper_matches_jax():
    """SileroVad.prob over ten vowel frames, state carried: within 1e-5,
    and the decisions equal."""
    audio = synth_vowel(480 * 10)
    ours = tsil.SileroVad(threshold=0.3, device="cpu")
    ref = jsil.SileroVad(threshold=0.3)
    for i in range(10):
        frame = audio[i * 480:(i + 1) * 480]
        assert abs(ours.prob(frame) - ref.prob(frame)) <= 1e-5
    ours.reset()
    ref.reset()
    silence = np.zeros(480, np.float32)
    assert ours.is_voice(silence) == ref.is_voice(silence) is False


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(threshold=0.5, prefill=3, hangover=2, onset=2),
    dict(threshold=0.6, prefill=0, hangover=0, onset=1),
    dict(threshold=0.4, prefill=7, hangover=5, onset=3),
])
def test_smooth_probs_mask_bit_for_bit(seed, cfg):
    """The keep-mask equals JAX's bit for bit. The probabilities stay at
    least 1e-3 from the threshold, so no comparison sits on a rounding
    edge."""
    thr = cfg.get("threshold", jsm.DEFAULT_THRESHOLD)
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0, 1, size=(3, 400)).astype(np.float32)
    # Runs of voiced frames, so onsets, hangovers and pre-rolls all occur.
    probs[:, 100:160] = rng.uniform(thr + 0.01, 1, size=(3, 60))
    probs = np.where(np.abs(probs - thr) < 1e-3, thr + 2e-3, probs).astype(np.float32)
    assert np.abs(probs - thr).min() >= 1e-3
    ref = np.asarray(jsm.smooth_probs(probs, **cfg))
    ours = tsm.smooth_probs(probs, **cfg)
    assert ours.dtype == bool and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tsm.smooth_probs(torch.from_numpy(probs), **cfg),
                                  ref)


class _FixedVad:
    def __init__(self, pattern):
        self.pattern = list(pattern)
        self.i = 0
        self.resets = 0

    def is_voice(self, frame):
        v = self.pattern[self.i]
        self.i += 1
        return v

    def reset(self):
        self.resets += 1


@pytest.mark.parametrize("seed", range(3))
def test_smoothed_vad_streaming_matches_jax(seed):
    """Frame by frame: the same kinds and the same emitted samples."""
    rng = np.random.default_rng(seed)
    pattern = (rng.uniform(size=200) > 0.55).tolist()
    kw = dict(prefill_frames=4, hangover_frames=3, onset_frames=2)
    ours = tsm.SmoothedVad(_FixedVad(pattern), **kw)
    ref = jsm.SmoothedVad(_FixedVad(pattern), **kw)
    for i in range(200):
        frame = np.full(4, i, np.float32)
        (ka, sa), (kb, sb) = ours.push_frame(frame), ref.push_frame(frame)
        assert ka.value == kb.value
        assert (sa is None) == (sb is None)
        if sa is not None:
            np.testing.assert_array_equal(sa, sb)
    ours.reset()
    assert ours.inner.resets == 1


def test_smoothed_vad_over_silero_matches_jax():
    """The production chain streamed: SmoothedVad over SileroVad on speech
    in silence gives JAX's kinds frame for frame."""
    audio = speech_in_silence(1)
    ours = tsm.SmoothedVad(tsil.SileroVad(device="cpu"))
    ref = jsm.SmoothedVad(jsil.SileroVad())
    kinds = []
    for i in range(len(audio) // 480):
        frame = audio[i * 480:(i + 1) * 480]
        (ka, _), (kb, _) = ours.push_frame(frame), ref.push_frame(frame)
        assert ka.value == kb.value, i
        kinds.append(ka.value)
    assert "speech" in kinds and "noise" in kinds


@pytest.mark.parametrize("kw", [
    dict(),
    dict(onset=2, prefill=4, hangover=4),
    dict(onset=1, prefill=2, hangover=2, min_gap_frames=3),
])
def test_segment_speech_and_gated_audio_match_jax(jparams, tparams, kw):
    """Spans equal and the gated audio equal, on speech in silence."""
    audio = speech_in_silence(2)
    ref = jseg.segment_speech(audio, params=jparams, **kw)
    ours = tseg.segment_speech(audio, params=tparams, **kw)
    assert [(s.start_sample, s.end_sample) for s in ours] == [
        (s.start_sample, s.end_sample) for s in ref]
    assert len(ours) >= 1
    assert ours[0].start_sec == ref[0].start_sec
    np.testing.assert_array_equal(tseg.gated_audio(audio, ours),
                                  jseg.gated_audio(audio, ref))
    # A tensor input, with the weights loaded onto its device.
    spans = tseg.segment_speech(torch.from_numpy(audio), **kw)
    assert [(s.start_sample, s.end_sample) for s in spans] == [
        (s.start_sample, s.end_sample) for s in ref]


def test_segment_speech_empty_and_silent(tparams):
    assert tseg.segment_speech(np.zeros(100, np.float32), params=tparams) == []
    silent = (0.001 * np.random.default_rng(0).standard_normal(SR * 2)).astype(
        np.float32)
    assert tseg.segment_speech(silent, params=tparams) == []
    assert tseg.gated_audio(silent, []).size == 0


def test_silero_lstm_probe_at_a_small_size(monkeypatch):
    """probes/silero_lstm.py on the CPU over 6 s of its synthetic speech:
    every variant within 1e-5 of the f64 evaluation there (the CPU has no
    cuDNN), the f64 ones exact; by default it needs a card."""
    from spittle_tpu_torch.probes import silero_lstm

    recs = silero_lstm.main(6.0, "cpu")
    assert [r["variant"] for r in recs] == [
        "f32, TF32 on", "f32", "f32, cuDNN off", "f64", "CPU f32", "CPU f64"]
    assert all(r["steps"] == 200 and r["device"] == "cpu" for r in recs)
    assert all(r["prob_vs_f64"] <= 1e-5 for r in recs)
    assert recs[3]["prob_vs_f64"] == recs[5]["prob_vs_f64"] == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        silero_lstm.main()
