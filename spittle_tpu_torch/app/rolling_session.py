"""Live rolling dictation: re-transcribe-and-rewrite streaming mode.

Port of spittle_tpu/app/rolling_session.py.

The reference ships the test half of this feature — `rolling_harness.rs`
replays hypothesis sequences and detects rewrite drift; the live producer
side is dormant (SURVEY.md §5: segment_tx plumbing exists but
"Segment-on-silence is disabled"). This module revives it: it
re-transcribes the accumulated window on a cadence and keeps visible text
current while the user is still speaking. The engine it is given decides
the device (the port's engines run on the card unless told otherwise).

RollingTranscriber holds the audio window, re-transcribes it when enough
new audio arrives, normalizes the hypothesis the same way the harness
does (`text/rolling.py: normalize_hypothesis`), and emits the minimal
end-rewrite (DEL count + tail to type) against the previously emitted
hypothesis — exactly the keystroke pattern the rolling harness and the
pty terminal replay validate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.text.rolling import normalize_hypothesis

SAMPLE_RATE = 16_000


def compute_rolling_rewrite(prev: str, new: str) -> Tuple[int, str]:
    """Terminal-safe rewrite: (chars to DEL from the end, tail to type).

    Rolling rewrites cannot edit interior text (no caret movement in a
    line-discipline terminal), so the edit keeps the common prefix and
    retypes everything after it."""
    common = 0
    for a, b in zip(prev, new):
        if a != b:
            break
        common += 1
    return len(prev) - common, new[common:]


@dataclass
class RollingUpdate:
    hypothesis: str  # full normalized hypothesis
    delete_chars: int  # DELs against the previous emission
    insert: str  # tail typed after the deletes


class RollingTranscriber:
    """Streaming re-transcribe + rewrite session over one utterance.

    emit(update) is called with each RollingUpdate; a text sink applies it
    as `DEL * delete_chars` + type(insert) (BufferTextOutput.apply_text_diff
    with suffix_chars=0 does the same in-memory).
    """

    def __init__(
        self,
        engine,
        emit: Callable[[RollingUpdate], None],
        params: Optional[TranscribeParams] = None,
        min_new_audio_s: float = 0.5,
        min_interval_s: float = 0.3,
        max_window_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.engine = engine
        self.emit = emit
        self.params = params or TranscribeParams()
        self.min_new_audio = int(min_new_audio_s * SAMPLE_RATE)
        self.min_interval = min_interval_s
        self.max_window = int(max_window_s * SAMPLE_RATE)
        self._clock = clock
        self._chunks: List[np.ndarray] = []
        self._total = 0
        self._transcribed_at_len = 0
        self._last_run = 0.0
        self._typed = ""
        self.hypotheses: List[str] = []  # emission history (harness replay)

    # -- audio in ---------------------------------------------------------

    def push_audio(self, samples: np.ndarray) -> Optional[RollingUpdate]:
        """Add samples; re-transcribe if due. Returns the update, if any."""
        samples = np.asarray(samples, np.float32)
        if len(samples):
            self._chunks.append(samples)
            self._total += len(samples)
        if not self._due():
            return None
        return self._retranscribe()

    def finalize(self) -> str:
        """Final pass over everything buffered; returns the final text."""
        if self._total > self._transcribed_at_len or not self.hypotheses:
            self._retranscribe(force=True)
        return self._typed

    # -- internals --------------------------------------------------------

    def _due(self) -> bool:
        if self._total - self._transcribed_at_len < self.min_new_audio:
            return False
        return self._clock() - self._last_run >= self.min_interval

    def _window(self) -> np.ndarray:
        audio = np.concatenate(self._chunks) if self._chunks else np.zeros(
            0, np.float32
        )
        if len(audio) > self.max_window:
            audio = audio[-self.max_window:]
        return audio

    def _retranscribe(self, force: bool = False) -> Optional[RollingUpdate]:
        audio = self._window()
        if not len(audio):
            return None
        self._last_run = self._clock()
        self._transcribed_at_len = self._total
        result = self.engine.transcribe_samples(audio, self.params)
        hyp = normalize_hypothesis(result.text or "")
        if not hyp or (hyp == self._typed and not force):
            return None
        delete, insert = compute_rolling_rewrite(self._typed, hyp)
        update = RollingUpdate(hypothesis=hyp, delete_chars=delete,
                               insert=insert)
        self._typed = hyp
        self.hypotheses.append(hyp)
        self.emit(update)
        return update
