"""Real microphone capture: subprocess PCM readers feeding the native ring.

Port of spittle_tpu/shell/mic.py over the port's native ring
(native/ringbuffer.py), with the native macOS (AudioQueue,
shell/macos_mic.py) and Windows (waveIn, shell/windows_mic.py) sources.

The reference owns a live cpal input stream on a worker thread
(`src-tauri/src/audio_toolkit/audio/recorder.rs:83-135`).
Here capture is a child process — parec / pw-record / arecord / ffmpeg /
sox — streaming raw PCM to stdout; a reader thread converts to mono f32
(native converters) and writes into the lock-free C++ SPSC ring
(native/spittle_audio.cpp), which the recorder consumes through the same
AudioSource protocol tests use. Tool availability is probed like the
reference's Linux typing-tool chain (`clipboard.rs:205-276`); when nothing
is available the factory degrades with a clear CaptureUnavailable error.
"""

from __future__ import annotations

import shutil
import subprocess
import threading

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from spittle_tpu_torch.utils import threads

TARGET_RATE = 16_000
_READ_BLOCK = 4096  # bytes per stdout read (~1 kB frames at f32)


class CaptureUnavailableError(RuntimeError):
    """No capture tool present; message lists what was probed."""


@dataclass(frozen=True)
class CaptureTool:
    name: str
    fmt: str  # "f32" or "i16"

    def command(self, rate: int, device: Optional[str]) -> List[str]:
        if self.name == "parec":
            cmd = ["parec", f"--rate={rate}", "--channels=1",
                   "--format=float32le"]
            if device:
                cmd += ["-d", device]
            return cmd
        if self.name == "pw-record":
            cmd = ["pw-record", "--rate", str(rate), "--channels", "1",
                   "--format", "f32"]
            if device:
                cmd += ["--target", device]
            return cmd + ["-"]
        if self.name == "arecord":
            # S16_LE: FLOAT_LE is rejected by most raw ALSA hw devices
            # (capture would die instantly as a silent EOF); the reader
            # normalizes i16 -> f32.
            cmd = ["arecord", "-q", "-f", "S16_LE", "-r", str(rate),
                   "-c", "1", "-t", "raw"]
            if device:
                cmd += ["-D", device]
            return cmd
        if self.name == "ffmpeg":
            import sys

            if sys.platform == "darwin":
                # avfoundation input: ":N" = audio-only device N
                # (recorder.rs captures via cpal/CoreAudio; ffmpeg is
                # the subprocess fallback behind shell/macos_mic.py).
                return ["ffmpeg", "-loglevel", "quiet", "-f",
                        "avfoundation", "-i", f":{device or '0'}",
                        "-f", "f32le", "-ac", "1", "-ar", str(rate), "-"]
            return ["ffmpeg", "-loglevel", "quiet", "-f", "pulse",
                    "-i", device or "default", "-f", "f32le", "-ac", "1",
                    "-ar", str(rate), "-"]
        if self.name == "rec":  # sox
            return ["rec", "-q", "-t", "raw", "-b", "32", "-e",
                    "floating-point", "-r", str(rate), "-c", "1", "-"]
        raise ValueError(self.name)


# Priority order mirrors desktop Linux reality: PulseAudio/PipeWire first,
# raw ALSA next, transcoders last.
CAPTURE_TOOLS = (
    CaptureTool("parec", "f32"),
    CaptureTool("pw-record", "f32"),
    CaptureTool("arecord", "i16"),
    CaptureTool("ffmpeg", "f32"),
    CaptureTool("rec", "f32"),
)


def probe_capture_tools() -> List[str]:
    """Names of capture tools present on this machine."""
    return [t.name for t in CAPTURE_TOOLS if shutil.which(t.name)]


def pick_capture_tool(preferred: Optional[str] = None) -> CaptureTool:
    by_name = {t.name: t for t in CAPTURE_TOOLS}
    if preferred:
        tool = by_name.get(preferred)
        if tool is None:
            raise ValueError(f"unknown capture tool: {preferred}")
        if not shutil.which(tool.name):
            raise CaptureUnavailableError(
                f"capture tool {preferred!r} not found on PATH"
            )
        return tool
    for t in CAPTURE_TOOLS:
        if shutil.which(t.name):
            return t
    raise CaptureUnavailableError(
        "no microphone capture tool available; probed: "
        + ", ".join(t.name for t in CAPTURE_TOOLS)
        + " (install pulseaudio-utils, pipewire-utils, alsa-utils, ffmpeg, "
        "or sox)"
    )


class MicSource:
    """AudioSource over a capture subprocess.

    The child writes raw PCM to stdout; a reader thread converts and
    pushes into the native ring (Python-list fallback when the native lib
    is unavailable). popen is injectable so tests can substitute a fake
    process producing deterministic PCM.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        sample_rate: int = TARGET_RATE,
        tool: Optional[str] = None,
        popen: Optional[Callable] = None,
    ):
        self._rate = sample_rate
        self._tool = pick_capture_tool(tool)
        cmd = self._tool.command(sample_rate, device)
        popen = popen or (
            lambda c: subprocess.Popen(
                c, stdout=subprocess.PIPE, stderr=subprocess.PIPE
            )
        )
        self._proc = popen(cmd)
        self._eof = threading.Event()
        self._closed = threading.Event()
        from spittle_tpu_torch.native.ringbuffer import (
            NativeRingBuffer,
            native_available,
        )

        self._ring = NativeRingBuffer() if native_available() else None
        self._fallback: List[np.ndarray] = []
        self._fallback_lock = threading.Lock()
        self._reader = threads.spawn(self._read_loop, name="mic-reader")

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def tool_name(self) -> str:
        return self._tool.name

    def _push(self, samples: np.ndarray) -> None:
        if self._ring is not None:
            self._ring.write(samples)
        else:
            with self._fallback_lock:
                self._fallback.append(samples)

    def _pop(self, max_samples: int) -> np.ndarray:
        if self._ring is not None:
            return self._ring.read(max_samples)
        with self._fallback_lock:
            if not self._fallback:
                return np.zeros(0, np.float32)
            return self._fallback.pop(0)

    def _read_loop(self) -> None:
        stdout = self._proc.stdout
        itemsize = 4 if self._tool.fmt == "f32" else 2
        pending = b""
        try:
            while not self._closed.is_set():
                block = stdout.read(_READ_BLOCK)
                if not block:
                    break  # EOF: child exited
                pending += block
                usable = len(pending) - (len(pending) % itemsize)
                if not usable:
                    continue
                raw, pending = pending[:usable], pending[usable:]
                if self._tool.fmt == "f32":
                    samples = np.frombuffer(raw, "<f4").astype(np.float32)
                else:
                    samples = (
                        np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
                    )
                self._push(samples)
        except (OSError, ValueError):
            pass
        finally:
            self._eof.set()
            self._report_child_error()

    def _report_child_error(self) -> None:
        """Surface the capture child's stderr when it died — a rejected
        sample format otherwise looks like an instant silent EOF."""
        try:
            rc = self._proc.poll()
            # A tool that close() terminated ended as asked.
            if rc in (None, 0) or self._proc.stderr is None or self._closed.is_set():
                return
            detail = self._proc.stderr.read() or b""
            import logging

            logging.getLogger("spittle_tpu_torch.mic").warning(
                "capture tool %s exited rc=%s: %s",
                self._tool.name, rc, detail.decode(errors="replace")[:500],
            )
        except Exception:
            pass

    def read(self, timeout: float) -> Optional[np.ndarray]:
        """Recorder AudioSource protocol: chunk, empty on timeout, None
        when capture has ended and the buffer is drained."""
        import time

        deadline = time.monotonic() + timeout
        while True:
            # The end is read before the ring: the reader pushes its last
            # block before it sets _eof, so an end seen first leaves
            # nothing behind. (The JAX package reads the ring first, and
            # can answer None with that last block still in the ring.)
            ended = self._eof.is_set() or self._closed.is_set()
            data = self._pop(_READ_BLOCK)
            if len(data):
                return data
            if ended:
                return None
            if time.monotonic() >= deadline:
                return np.zeros(0, np.float32)
            time.sleep(0.002)

    def close(self) -> None:
        self._closed.set()
        try:
            self._proc.terminate()
        except Exception:
            pass
        try:
            self._proc.wait(timeout=2)
        except Exception:
            pass
        self._reader.join(timeout=2)


def make_mic_source_factory(
    device_getter: Optional[Callable[[], Optional[str]]] = None,
    tool: Optional[str] = None,
):
    """source_factory for AppServices/AudioRecordingManager: opens the
    selected microphone each time the recorder (re)opens its stream
    (audio.rs:282 start_microphone_stream analog)."""

    def factory():
        device = device_getter() if device_getter else None
        import sys

        if sys.platform == "darwin" and tool in (None, "audioqueue"):
            # Native CoreAudio AudioQueue stream first (the cpal-analog
            # arm, recorder.rs:83-135); subprocess tools are the
            # fallback (ffmpeg avfoundation / sox).
            from spittle_tpu_torch.shell.macos_mic import MacMicSource

            try:  # pragma: no cover (darwin)
                return MacMicSource()
            except OSError:
                if tool == "audioqueue":
                    raise
        if sys.platform == "win32" and tool in (None, "wavein"):
            # Native waveIn stream (the cpal/WASAPI-analog arm).
            from spittle_tpu_torch.shell.windows_mic import WinMicSource

            try:  # pragma: no cover (win32)
                return WinMicSource()
            except OSError:
                if tool == "wavein":
                    raise
        return MicSource(device=device, tool=tool)

    return factory
