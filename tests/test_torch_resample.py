"""spittle_tpu_torch's resampler, WAV files and host mu-law decode against
the JAX package on the CPU, on numpy-seeded audio."""

import numpy as np
import pytest
import torch

from spittle_tpu.audio import mulaw as jmulaw
from spittle_tpu.audio import resample as jres
from spittle_tpu.audio import wav as jwav
from spittle_tpu_torch.audio import mulaw as tmulaw
from spittle_tpu_torch.audio import resample as tres
from spittle_tpu_torch.audio import wav as twav

RATES = (8000, 22050, 44100, 48000)


def make_audio(shape, sr, seed=0):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / sr
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 1330 * t + 0.7)
           + 0.02 * rng.standard_normal(shape))
    return sig.astype(np.float32)


@pytest.mark.parametrize("in_hz", RATES)
@pytest.mark.parametrize("shape", [(4410,), (16001,), (2, 3, 9973)])
def test_resample_matches_jax(in_hz, shape):
    """Within 1e-5 of the output's peak: one strided conv against XLA's, in
    f32 with different summation orders over F <= 494 taps."""
    x = make_audio(shape, in_hz, seed=in_hz + shape[-1])
    ref = np.asarray(jres.resample(x, in_hz, 16000))
    ours = tres.resample(torch.from_numpy(x), in_hz, 16000)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    assert tuple(ours.shape) == ref.shape
    assert ref.shape[-1] == tres.resampled_length(shape[-1], in_hz, 16000)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_resample_identity_at_equal_rates():
    x = torch.from_numpy(make_audio((1000,), 16000))
    assert tres.resample(x, 16000, 16000) is x


@pytest.mark.parametrize("n", [0, 1, 159, 441, 44100, 123457])
@pytest.mark.parametrize("in_hz", RATES + (16000, 32000))
def test_resampled_length_matches_jax(n, in_hz):
    assert tres.resampled_length(n, in_hz, 16000) == jres.resampled_length(
        n, in_hz, 16000)


@pytest.mark.parametrize("in_hz", RATES + (16000,))
@pytest.mark.parametrize("chunk", [tres.CHUNK_IN, 333])
def test_frame_resampler_matches_jax(in_hz, chunk):
    """Streamed 30 ms frames: the same frame sizes and count, values within
    1e-6 (both run the same numpy arithmetic)."""
    x = make_audio((in_hz + 777,), in_hz, seed=3)
    ours, ref = [], []
    t, j = tres.FrameResampler(in_hz), jres.FrameResampler(in_hz)
    for i in range(0, len(x), chunk):
        t.push(x[i:i + chunk], ours.append)
        j.push(x[i:i + chunk], ref.append)
    t.finish(ours.append)
    j.finish(ref.append)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (tres.FRAME_SAMPLES,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_wav_round_trip_matches_jax(tmp_path):
    x = make_audio((8000,), 16000, seed=5)
    ours, ref = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    twav.save_wav_file(ours, x, 22050)
    jwav.save_wav_file(ref, x, 22050)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    for keep in (False, True):
        a, ra = twav.load_wav_file(ours, keep_int16=keep)
        b, rb = jwav.load_wav_file(ref, keep_int16=keep)
        assert ra == rb == 22050 and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mulaw_decode_np_matches_jax():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(tmulaw.mulaw_decode_np(codes),
                                  jmulaw.mulaw_decode_np(codes))
