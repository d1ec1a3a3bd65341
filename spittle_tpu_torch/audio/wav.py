"""WAV read/write, 16-bit mono PCM (port of spittle_tpu/audio/wav.py;
stdlib wave module)."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def save_wav_file(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """float32 [-1, 1] mono -> 16-bit PCM WAV."""
    samples = np.asarray(samples, np.float32)
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def load_wav_file(
    path: str, keep_int16: bool = False
) -> Tuple[np.ndarray, int]:
    """Returns (mono samples, sample_rate).

    Samples are float32 in [-1, 1]; with keep_int16, a 16-bit mono file
    returns raw int16 instead: the engine's wire format (half the
    host->device bytes, normalized on the device)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        if keep_int16 and channels == 1:
            return np.frombuffer(raw, "<i2"), rate
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate
