"""Audio recording manager: mic lifecycle, modes, padding, watchdog.

Port of spittle_tpu/managers/audio.py.

Behavior-parity rebuild of `src-tauri/src/managers/
audio.rs`: AlwaysOn vs OnDemand microphone modes (:119-124), the Silero
(threshold 0.3) + Smoothed(15,15,2) VAD chain (:127-151), binding-scoped
recording state via RecordingPipeline, sub-1 s recordings padded to 1.25 s
(:469-475), OS-output mute hooks while recording (:17-104), and the mic
health watchdog cancelling after 10 s without a level heartbeat
(:106-108,201-227).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np

from spittle_tpu_torch.audio.recorder import AudioRecorder, AudioSource
from spittle_tpu_torch.audio.resample import TARGET_SAMPLE_RATE
from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("audio")
from spittle_tpu_torch.events import EventBus, MIC_LEVEL
from .recording_pipeline import (
    Busy,
    Committed,
    RecordingPipeline,
    should_trigger_health_recovery,
)

HEALTH_THRESHOLD_MS = 10_000
MIN_RECORDING_SECONDS = 1.0
PAD_TO_SECONDS = 1.25


def _now_ms() -> int:
    return int(time.monotonic() * 1000)


class AudioRecordingManager:
    """Owns the recorder + recording state machine.

    `source_factory` creates an AudioSource for the selected microphone
    (the desktop shell wraps OS capture; tests inject QueueSource).
    `vad_factory` creates the smoothed VAD chain (None disables gating).
    """

    def __init__(
        self,
        source_factory: Callable[[], AudioSource],
        vad_factory: Optional[Callable[[], object]] = None,
        events: Optional[EventBus] = None,
        always_on: bool = False,
        mute_while_recording: bool = False,
        on_health_cancel: Optional[Callable[[], None]] = None,
        segment_size_getter: Optional[Callable[[], float]] = None,
        on_segment: Optional[Callable[[np.ndarray], None]] = None,
    ):
        """segment_size_getter/on_segment revive the reference's dormant
        segment-on-silence mode (recorder.rs:306-313, setting
        audio_segment_size_seconds): when the size is > 0, accumulated
        speech streams out in fixed-size segments during recording."""
        self.events = events or EventBus()
        self._source_factory = source_factory
        self._vad_factory = vad_factory
        self._always_on = always_on
        self._mute_while_recording = mute_while_recording
        self._on_health_cancel = on_health_cancel
        self._segment_size = segment_size_getter or (lambda: 0.0)
        self._on_segment = on_segment
        self._pipeline = RecordingPipeline()
        self._recorder: Optional[AudioRecorder] = None
        self._rec_lock = threading.Lock()
        self._last_level_ms: Optional[int] = None
        self._shutdown = threading.Event()
        if always_on:
            self._open_stream()
        self._watchdog = threading.Thread(target=self._health_loop, daemon=True)
        self._watchdog.start()

    # -- stream lifecycle ------------------------------------------------

    def _on_level(self, levels) -> None:
        self._last_level_ms = _now_ms()
        self.events.emit(MIC_LEVEL, levels)

    def _open_stream(self) -> None:
        with self._rec_lock:
            if self._recorder is not None:
                return
            rec = AudioRecorder(self._source_factory())
            if self._vad_factory is not None:
                rec = rec.with_vad(self._vad_factory())
            rec = rec.with_level_callback(self._on_level)
            seg_seconds = self._segment_size()
            if seg_seconds and seg_seconds > 0 and self._on_segment:
                rec = rec.with_segment_emission(
                    int(seg_seconds * TARGET_SAMPLE_RATE), self._on_segment
                )
            rec.open()
            self._recorder = rec

    def _close_stream(self) -> None:
        with self._rec_lock:
            if self._recorder is not None:
                self._recorder.close()
                self._recorder = None

    # -- recording -------------------------------------------------------

    def try_start_recording(self, binding_id: str) -> bool:
        if not self._pipeline.can_attempt_start():
            return False
        self._open_stream()
        with self._rec_lock:
            if self._recorder is None:
                return False
            self._recorder.start()
        result = self._pipeline.commit_start(binding_id)
        if isinstance(result, Busy):
            # Lost the race: roll the stream back (audio.rs:414-424).
            with self._rec_lock:
                if self._recorder:
                    self._recorder.stop()
            if not self._always_on:
                self._close_stream()
            return False
        self._last_level_ms = _now_ms()
        if self._mute_while_recording:
            apply_mute()
        return True

    def stop_recording(self, binding_id: str) -> Optional[np.ndarray]:
        if not self._pipeline.stop_for_binding(binding_id):
            return None
        with self._rec_lock:
            samples = self._recorder.stop() if self._recorder else None
        if not self._always_on:
            self._close_stream()
        if self._mute_while_recording:
            remove_mute()
        if samples is None:
            return None
        # Pad very short recordings so engines see a stable minimum length
        # (audio.rs:469-475).
        if len(samples) < MIN_RECORDING_SECONDS * TARGET_SAMPLE_RATE:
            target = int(PAD_TO_SECONDS * TARGET_SAMPLE_RATE)
            samples = np.pad(samples, (0, max(0, target - len(samples))))
        return samples

    def cancel_recording(self) -> None:
        if not self._pipeline.cancel():
            return
        with self._rec_lock:
            if self._recorder:
                self._recorder.stop()
        if not self._always_on:
            self._close_stream()
        if self._mute_while_recording:
            remove_mute()

    def is_recording(self) -> bool:
        return self._pipeline.is_recording()

    def update_mode(self, always_on: bool) -> None:
        self._always_on = always_on
        if always_on:
            self._open_stream()
        elif not self._pipeline.is_recording():
            self._close_stream()

    def shutdown(self) -> None:
        self._shutdown.set()
        self.cancel_recording()
        self._close_stream()

    # -- health watchdog -------------------------------------------------

    def _health_loop(self) -> None:
        while not self._shutdown.wait(1.0):
            try:
                self._health_tick()
            except Exception:
                # The watchdog IS the failure detector; a crash in one
                # tick must not kill it (exception barrier,
                # utils.rs:17-46 reset discipline).
                _log.exception("mic watchdog tick failed")

    def _health_tick(self) -> None:
        if should_trigger_health_recovery(
            self._pipeline.is_recording(),
            self._last_level_ms,
            _now_ms(),
            HEALTH_THRESHOLD_MS,
        ):
            self.cancel_recording()
            if self._on_health_cancel:
                self._on_health_cancel()


# ---------------------------------------------------------------------------
# OS output mute (audio.rs:17-104). Best-effort subprocess calls.
# ---------------------------------------------------------------------------

_mute_state = {"muted": False}


def _run(cmd) -> bool:
    try:
        return subprocess.run(
            cmd, capture_output=True, timeout=2
        ).returncode == 0
    except Exception:
        return False


def apply_mute() -> None:
    if _mute_state["muted"]:
        return
    if sys.platform == "linux":
        for cmd in (
            ["wpctl", "set-mute", "@DEFAULT_AUDIO_SINK@", "1"],
            ["pactl", "set-sink-mute", "@DEFAULT_SINK@", "1"],
            ["amixer", "set", "Master", "mute"],
        ):
            if shutil.which(cmd[0]) and _run(cmd):
                break
    elif sys.platform == "darwin":
        _run(["osascript", "-e", "set volume output muted true"])
    elif sys.platform == "win32":
        # COM IAudioEndpointVolume chain (audio.rs:17-104), in
        # spittle_tpu/shell/windows_audio.py: it comes with the
        # macOS/Windows slice; until then this raises.
        from spittle_tpu_torch.shell.unported import unported

        raise unported("shell/windows_audio.py (output mute)")
    _mute_state["muted"] = True


def remove_mute() -> None:
    if not _mute_state["muted"]:
        return
    if sys.platform == "linux":
        for cmd in (
            ["wpctl", "set-mute", "@DEFAULT_AUDIO_SINK@", "0"],
            ["pactl", "set-sink-mute", "@DEFAULT_SINK@", "0"],
            ["amixer", "set", "Master", "unmute"],
        ):
            if shutil.which(cmd[0]) and _run(cmd):
                break
    elif sys.platform == "darwin":
        _run(["osascript", "-e", "set volume output muted false"])
    elif sys.platform == "win32":
        # See apply_mute.
        from spittle_tpu_torch.shell.unported import unported

        raise unported("shell/windows_audio.py (output unmute)")
    _mute_state["muted"] = False
