"""Mock engine for CI and app-shell tests (port of spittle_tpu/engine/mock.py).

Counterpart of the reference's mock transcription manager compiled under
`--features mock_transcription` (`src-tauri/src/managers/
transcription_mock.rs`): returns empty text without touching a device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .base import TranscribeParams, TranscriptionResult


class MockEngine:
    def __init__(self, canned_text: str = ""):
        self.canned_text = canned_text
        self._loaded = False
        self.calls: List[int] = []

    def load_model(self, model_path: str) -> None:
        self._loaded = True

    def unload_model(self) -> None:
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def transcribe_samples(
        self, samples: np.ndarray, params: Optional[TranscribeParams] = None
    ) -> TranscriptionResult:
        self.calls.append(len(samples))
        return TranscriptionResult(text=self.canned_text)

    def transcribe_batch(
        self,
        batch: Sequence[np.ndarray],
        params: Optional[TranscribeParams] = None,
    ) -> List[TranscriptionResult]:
        return [self.transcribe_samples(s, params) for s in batch]
