"""Offline VAD segmentation for long-form audio (port of
spittle_tpu/audio/vad/segmenter.py).

Batched Silero probabilities over all 30 ms frames in one device call, the
SmoothedVad keep-mask on the host, then contiguous kept-frame runs become
speech segments with sample offsets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .silero import FRAME_SAMPLES_16K, load_silero_params, silero_scan_frames
from .smoothed import (
    DEFAULT_HANGOVER,
    DEFAULT_ONSET,
    DEFAULT_PREFILL,
    DEFAULT_THRESHOLD,
    smooth_probs,
)


@dataclass
class SpeechSegment:
    start_sample: int
    end_sample: int

    @property
    def start_sec(self) -> float:
        return self.start_sample / 16000.0

    @property
    def end_sec(self) -> float:
        return self.end_sample / 16000.0


def segment_speech(
    audio,
    params=None,
    threshold: float = DEFAULT_THRESHOLD,
    prefill: int = DEFAULT_PREFILL,
    hangover: int = DEFAULT_HANGOVER,
    onset: int = DEFAULT_ONSET,
    min_gap_frames: int = 0,
    frame_samples: int = FRAME_SAMPLES_16K,
    device=None,
) -> List[SpeechSegment]:
    """Speech spans of a 16 kHz mono buffer using the production VAD chain.

    audio: [T] numpy or tensor. Silero runs on the weights' device: `params`
    when given, else the bundled weights loaded onto `device` (by default
    the audio tensor's device, or "cuda" for numpy audio)."""
    if params is None:
        if device is None:
            device = audio.device if isinstance(audio, torch.Tensor) else "cuda"
        params = load_silero_params(device=device)
    n_frames = audio.shape[-1] // frame_samples
    if n_frames == 0:
        return []
    trimmed = audio[: n_frames * frame_samples]
    probs = silero_scan_frames(params, trimmed[None])
    mask = smooth_probs(probs, threshold=threshold, prefill=prefill,
                        hangover=hangover, onset=onset)[0]

    segments: List[SpeechSegment] = []
    start: Optional[int] = None
    gap = 0
    for i, keep in enumerate(mask.tolist()):
        if keep:
            if start is None:
                start = i
            gap = 0
        elif start is not None:
            gap += 1
            if gap > min_gap_frames:
                segments.append(
                    SpeechSegment(
                        start * frame_samples, (i - gap + 1) * frame_samples
                    )
                )
                start = None
                gap = 0
    if start is not None:
        segments.append(
            SpeechSegment(start * frame_samples, n_frames * frame_samples)
        )
    return segments


def gated_audio(
    audio: np.ndarray, segments: List[SpeechSegment]
) -> np.ndarray:
    """Concatenate only the speech spans (what the mic path accumulates)."""
    if not segments:
        return np.zeros(0, np.float32)
    return np.concatenate(
        [audio[s.start_sample : s.end_sample] for s in segments]
    )
