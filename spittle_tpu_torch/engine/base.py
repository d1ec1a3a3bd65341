"""Engine result and parameter types and the PCM input contract (the
port's copy of spittle_tpu/engine/base.py: TranscribeParams, Segment,
Word, TranscriptionResult, field for field, normalize_pcm, and the
TranscriptionEngine protocol the app's managers hold an engine to)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TranscribeParams:
    """Per-call decode options.

    beam_size > 1 selects beam search; 1 is greedy."""

    language: Optional[str] = None  # None -> auto-detect
    translate: bool = False
    initial_prompt: Optional[str] = None
    beam_size: int = 1
    word_timestamps: bool = False  # cross-attention DTW word timings
    # Condition later windows on the previous window's text.
    condition_on_previous_text: bool = True
    # Long-audio fast path: decode ALL 30 s windows of every item in one
    # batch (fixed-stride chunking, no timestamp-guided seek or prompt
    # carry). Requires condition_on_previous_text=False.
    parallel_windows: bool = False
    # Overlap between parallel windows (seconds); each window keeps only
    # segments whose midpoint falls in its core region (overlap-stitch).
    parallel_overlap_s: float = 0.0
    # Per-window decode budget. None -> n_text_ctx // 2.
    max_tokens: Optional[int] = None
    # Reduced encoder context: encode only the first audio_ctx positions
    # (= audio_ctx*2 mel frames) per window. None -> full window.
    audio_ctx: Optional[int] = None
    # Temperature-fallback ladder override. None -> the engine default
    # (0.0, 0.2, ..., 1.0); (0.0,) disables retries.
    temperatures: Optional[tuple] = None


@dataclasses.dataclass
class Word:
    word: str
    start: float
    end: float


@dataclasses.dataclass
class Segment:
    start: float  # seconds
    end: float
    text: str


@dataclasses.dataclass
class TranscriptionResult:
    text: str
    segments: List[Segment] = dataclasses.field(default_factory=list)
    language: Optional[str] = None
    words: List[Word] = dataclasses.field(default_factory=list)
    # Raw decoded token ids (text + timestamp tokens, before tokenizer
    # decode).
    tokens: List[int] = dataclasses.field(default_factory=list)


def normalize_pcm(a) -> np.ndarray:
    """PCM input contract of the Parakeet, SenseVoice and Moonshine
    engines: float32 in [-1, 1] passes through; int16 (the wire format)
    scales by 1/32768."""
    a = np.asarray(a)
    if a.dtype == np.int16:
        return a.astype(np.float32) / 32768.0
    return a.astype(np.float32, copy=False)


class TranscriptionEngine(Protocol):
    def load_model(self, model_path: str) -> None: ...

    def unload_model(self) -> None: ...

    @property
    def is_loaded(self) -> bool: ...

    def transcribe_samples(
        self, samples: np.ndarray, params: Optional[TranscribeParams] = None
    ) -> TranscriptionResult: ...

    def transcribe_batch(
        self,
        batch: Sequence[np.ndarray],
        params: Optional[TranscribeParams] = None,
    ) -> List[TranscriptionResult]: ...
