"""Streaming audio recorder: source -> resample -> VAD gate -> samples.

Port of spittle_tpu/audio/recorder.py.

Role-parity rebuild of the reference AudioRecorder
(`src-tauri/src/audio_toolkit/audio/recorder.rs`): a worker
thread owns the input stream, converts to mono f32, resamples to 16 kHz
30 ms frames, VAD-gates them with the smoothed Silero chain, accumulates
speech samples, emits mic-level spectra, and optionally emits fixed-size
speech segments for streaming transcription (recorder.rs:57-62,306-313).

Where the reference binds to cpal, this recorder consumes an AudioSource —
any object yielding float32 chunks (the desktop shell wraps the OS capture
API; tests and benches feed arrays). Everything downstream of capture is
identical in behavior.
"""

from __future__ import annotations

import queue
import threading

from spittle_tpu_torch.utils import threads
from typing import Callable, List, Optional, Protocol

import numpy as np

from .resample import TARGET_SAMPLE_RATE
from spittle_tpu_torch.native.resampler import make_frame_resampler
from .vad.smoothed import VadFrame
from .visualizer import AudioVisualizer


class AudioSource(Protocol):
    """Capture abstraction: sample_rate + blocking chunk reads."""

    @property
    def sample_rate(self) -> int: ...

    def read(self, timeout: float) -> Optional[np.ndarray]:
        """Next mono f32 chunk, or None on timeout/closed."""
        ...


class QueueSource:
    """AudioSource fed by push() calls (used by tests and the app shell)."""

    def __init__(self, sample_rate: int = TARGET_SAMPLE_RATE):
        self._rate = sample_rate
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()

    @property
    def sample_rate(self) -> int:
        return self._rate

    def push(self, chunk: np.ndarray) -> None:
        self._q.put(np.asarray(chunk, np.float32))

    def close(self) -> None:
        self._q.put(None)

    def read(self, timeout: float) -> Optional[np.ndarray]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return np.zeros(0, np.float32)


class AudioRecorder:
    """Builder-style recorder (recorder.rs API: with_vad, with_level_callback,
    open/start/stop/close)."""

    def __init__(self, source: AudioSource):
        self._source = source
        self._vad = None
        self._level_cb: Optional[Callable[[List[float]], None]] = None
        self._segment_cb: Optional[Callable[[np.ndarray], None]] = None
        self._segment_samples: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._cmd: "queue.Queue" = queue.Queue()
        self._open = False

    def with_vad(self, vad) -> "AudioRecorder":
        """vad: SmoothedVad-like with push_frame(frame)->(VadFrame, samples)."""
        self._vad = vad
        return self

    def with_level_callback(self, cb: Callable[[List[float]], None]) -> "AudioRecorder":
        self._level_cb = cb
        return self

    def with_segment_emission(
        self, segment_samples: int, cb: Callable[[np.ndarray], None]
    ) -> "AudioRecorder":
        self._segment_samples = segment_samples
        self._segment_cb = cb
        return self

    # -- lifecycle -------------------------------------------------------

    def open(self) -> None:
        assert self._thread is None, "already open"
        self._open = True
        # Exception barrier: a consumer crash is logged (the mic watchdog
        # then recovers the recording session) instead of escaping the
        # thread boundary.
        self._thread = threads.spawn(self._run_consumer, name="audio-consumer")

    def start(self) -> None:
        """Begin accumulating. Synchronous: when this returns, the consumer
        has switched to recording, so any audio subsequently pushed to the
        source is guaranteed to be captured (stop() drains the queue)."""
        ack: "queue.Queue[bool]" = queue.Queue()
        self._cmd.put(("start", ack))
        ack.get(timeout=5)

    def stop(self) -> np.ndarray:
        reply: "queue.Queue[np.ndarray]" = queue.Queue()
        self._cmd.put(("stop", reply))
        return reply.get()

    def close(self) -> None:
        self._open = False
        self._cmd.put(("shutdown", None))
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    # -- worker ----------------------------------------------------------

    def _run_consumer(self) -> None:
        visualizer = AudioVisualizer(sample_rate=self._source.sample_rate)
        resampler = make_frame_resampler(self._source.sample_rate)
        recording = False
        processed: List[np.ndarray] = []
        segment_fill = 0

        def handle_frame(frame: np.ndarray) -> None:
            nonlocal segment_fill
            if not recording:
                return
            if self._vad is not None:
                kind, samples = self._vad.push_frame(frame)
                if kind is not VadFrame.SPEECH or samples is None:
                    return
                keep = samples
            else:
                keep = frame
            processed.append(np.asarray(keep, np.float32))
            if self._segment_samples and self._segment_cb:
                segment_fill += len(keep)
                if segment_fill >= self._segment_samples:
                    segment = np.concatenate(processed)
                    processed.clear()
                    segment_fill = 0
                    self._segment_cb(segment)

        while True:
            # Drain commands first so stop/shutdown are responsive.
            try:
                cmd, arg = self._cmd.get_nowait()
            except queue.Empty:
                cmd, arg = None, None
            if cmd == "start":
                recording = True
                processed.clear()
                segment_fill = 0
                if self._vad is not None and hasattr(self._vad, "reset"):
                    self._vad.reset()
                arg.put(True)
            elif cmd == "stop":
                # Drain audio already queued before the stop arrived so the
                # reply deterministically contains everything pushed so far.
                while True:
                    pending = self._source.read(timeout=0.01)
                    if pending is None or len(pending) == 0:
                        break
                    if self._level_cb is not None:
                        levels = visualizer.feed(pending)
                        if levels is not None:
                            self._level_cb(levels)
                    resampler.push(pending, handle_frame)
                resampler.finish(handle_frame)
                out = (
                    np.concatenate(processed)
                    if processed
                    else np.zeros(0, np.float32)
                )
                recording = False
                processed.clear()
                resampler = make_frame_resampler(self._source.sample_rate)
                arg.put(out)
            elif cmd == "shutdown":
                return

            chunk = self._source.read(timeout=0.05)
            if chunk is None:
                continue
            if len(chunk) == 0:
                continue
            if self._level_cb is not None:
                levels = visualizer.feed(chunk)
                if levels is not None:
                    self._level_cb(levels)
            resampler.push(chunk, handle_frame)
