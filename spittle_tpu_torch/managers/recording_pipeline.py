"""Recording state machine.

Port of spittle_tpu/managers/recording_pipeline.py.

The reference declares `managers/recording_pipeline.rs` but the file is
absent from the snapshot; this implementation is re-derived from its call
sites (`managers/audio.rs:3-6,210-215,383,408,440,477-488,508` — see
SURVEY.md §2.3): a binding-scoped Idle/Recording state with a two-phase
start (can_attempt_start -> commit_start), binding-checked stop, cancel,
and the mic-health recovery predicate.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional, Union


class StateKind(enum.Enum):
    IDLE = "idle"
    RECORDING = "recording"


@dataclasses.dataclass
class RecordingState:
    kind: StateKind = StateKind.IDLE
    binding_id: Optional[str] = None


@dataclasses.dataclass
class Committed:
    binding_id: str


@dataclasses.dataclass
class Busy:
    active_binding: Optional[str]


StartCommitResult = Union[Committed, Busy]


class RecordingPipeline:
    """Thread-safe recording session state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = RecordingState()

    def can_attempt_start(self) -> bool:
        with self._lock:
            return self._state.kind is StateKind.IDLE

    def commit_start(self, binding_id: str) -> StartCommitResult:
        """Atomically claim the recording slot; Busy if another binding won
        the race between can_attempt_start and here (audio.rs:407-424)."""
        with self._lock:
            if self._state.kind is StateKind.RECORDING:
                return Busy(active_binding=self._state.binding_id)
            self._state = RecordingState(StateKind.RECORDING, binding_id)
            return Committed(binding_id=binding_id)

    def stop_for_binding(self, binding_id: str) -> bool:
        """True iff this binding owned the active recording."""
        with self._lock:
            if (
                self._state.kind is StateKind.RECORDING
                and self._state.binding_id == binding_id
            ):
                self._state = RecordingState()
                return True
            return False

    def cancel(self) -> bool:
        with self._lock:
            was = self._state.kind is StateKind.RECORDING
            self._state = RecordingState()
            return was

    def is_recording(self) -> bool:
        with self._lock:
            return self._state.kind is StateKind.RECORDING

    def active_binding(self) -> Optional[str]:
        with self._lock:
            return self._state.binding_id


def should_trigger_health_recovery(
    recording: bool,
    last_level_ms: Optional[int],
    now_ms: int,
    threshold_ms: int,
) -> bool:
    """Mic watchdog predicate: recording but no level heartbeat for
    threshold_ms (reference default 10_000 ms, audio.rs:106-108)."""
    if not recording or last_level_ms is None:
        return False
    return now_ms - last_level_ms > threshold_ms
