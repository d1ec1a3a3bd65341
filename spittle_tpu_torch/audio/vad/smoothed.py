"""VAD smoothing: pre-roll, onset debounce, hangover (port of
spittle_tpu/audio/vad/smoothed.py), with the production parameters
prefill=15, hangover=15, onset=2 frames and threshold 0.3.

Two forms:
- `SmoothedVad`: the streaming host-side state machine, frame in /
  decision out (emitting the buffered pre-roll audio when onset triggers).
- `smooth_probs`: the batched form for offline long-form audio: given
  per-frame speech probabilities (silero_scan_frames), the same keep-mask
  for every stream, computed on the host in numpy after one fetch of the
  probabilities (a per-frame loop of device ops would cost a launch per
  frame).
"""

from __future__ import annotations

import enum
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_THRESHOLD = 0.3
DEFAULT_PREFILL = 15
DEFAULT_HANGOVER = 15
DEFAULT_ONSET = 2


class VadFrame(enum.Enum):
    SPEECH = "speech"
    NOISE = "noise"


class SmoothedVad:
    """Streaming hysteresis smoother over any boolean VAD.

    push_frame(frame) -> (VadFrame, samples-to-keep or None). On the onset
    trigger the returned samples include the buffered pre-roll frames.
    """

    def __init__(
        self,
        inner_vad,
        prefill_frames: int = DEFAULT_PREFILL,
        hangover_frames: int = DEFAULT_HANGOVER,
        onset_frames: int = DEFAULT_ONSET,
    ):
        self.inner = inner_vad
        self.prefill_frames = prefill_frames
        self.hangover_frames = hangover_frames
        self.onset_frames = onset_frames
        self._buffer: deque = deque()
        self._hangover = 0
        self._onset = 0
        self._in_speech = False

    def push_frame(self, frame: np.ndarray) -> Tuple[VadFrame, Optional[np.ndarray]]:
        self._buffer.append(np.asarray(frame))
        while len(self._buffer) > self.prefill_frames + 1:
            self._buffer.popleft()

        is_voice = self.inner.is_voice(frame)

        if not self._in_speech and is_voice:
            self._onset += 1
            if self._onset >= self.onset_frames:
                self._in_speech = True
                self._hangover = self.hangover_frames
                self._onset = 0
                samples = np.concatenate(list(self._buffer))
                return VadFrame.SPEECH, samples
            return VadFrame.NOISE, None
        if self._in_speech and is_voice:
            self._hangover = self.hangover_frames
            return VadFrame.SPEECH, np.asarray(frame)
        if self._in_speech and not is_voice:
            if self._hangover > 0:
                self._hangover -= 1
                return VadFrame.SPEECH, np.asarray(frame)
            self._in_speech = False
            return VadFrame.NOISE, None
        self._onset = 0
        return VadFrame.NOISE, None

    def reset(self) -> None:
        self._buffer.clear()
        self._hangover = 0
        self._onset = 0
        self._in_speech = False
        if hasattr(self.inner, "reset"):
            self.inner.reset()


def smooth_probs(
    probs,
    threshold: float = DEFAULT_THRESHOLD,
    prefill: int = DEFAULT_PREFILL,
    hangover: int = DEFAULT_HANGOVER,
    onset: int = DEFAULT_ONSET,
) -> np.ndarray:
    """Batched keep-mask from per-frame speech probabilities.

    probs: [B, F] (numpy, or a tensor on any device: fetched once). Returns
    bool [B, F] numpy: frames that the streaming SmoothedVad would have
    emitted as speech, including the retroactive pre-roll frames captured
    at each onset trigger.
    """
    if isinstance(probs, torch.Tensor):
        probs = probs.cpu().numpy()
    voiced = np.asarray(probs) > threshold  # [B, F]
    b, n = voiced.shape
    speech = np.zeros((b, n), bool)
    triggers = np.zeros((b, n), bool)
    for row in range(b):
        in_speech, onset_ctr, hang = False, 0, 0
        v_row, s_row, t_row = voiced[row].tolist(), speech[row], triggers[row]
        for f, v in enumerate(v_row):
            if not in_speech:
                if v:
                    onset_ctr += 1
                    if onset_ctr >= onset:  # trigger: speech from here
                        s_row[f] = t_row[f] = True
                        in_speech, hang, onset_ctr = True, hangover, 0
                else:
                    onset_ctr = 0
            elif v:  # ongoing voice
                s_row[f] = True
                hang = hangover
            elif hang > 0:  # hangover
                s_row[f] = True
                hang -= 1
            else:
                in_speech = False
    # Retroactive pre-roll: a trigger at frame f marks f-prefill..f as
    # kept, i.e. frame g is kept when a trigger lies in g..g+prefill.
    c = np.concatenate([np.zeros((b, 1), np.int64),
                        np.cumsum(triggers, axis=1)], axis=1)
    hi = np.minimum(np.arange(n) + prefill + 1, n)
    preroll = (c[:, hi] - c[:, :n]) > 0
    return speech | preroll
