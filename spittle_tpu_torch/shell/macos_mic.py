"""macOS microphone capture: a CoreAudio AudioQueue input stream.

Port of spittle_tpu/shell/macos_mic.py.

The reference owns a live cpal input stream on a worker thread
(`src-tauri/src/audio_toolkit/audio/recorder.rs:83-135`); on macOS
cpal's backend IS CoreAudio. This arm binds the same AudioQueue C API
through ctypes:

  AudioQueueNewInput(lpcm f32 mono 16 kHz, callback, ...)
  AudioQueueAllocateBuffer x3 -> AudioQueueEnqueueBuffer
  AudioQueueStart; the HAL thread delivers filled buffers to the
  callback, which copies samples into the lock-free C++ SPSC ring
  (native/spittle_audio.cpp) and re-enqueues the buffer.

Implements the same AudioSource protocol as shell/mic.MicSource so the
recorder consumes it unchanged. AudioToolbox is an injectable seam;
tests drive the input callback with PCM through a compiled C fake
(tests/test_torch_shell_macos.py) — the real ctypes struct/callback
marshalling is exercised, not mocked.
"""

from __future__ import annotations

import ctypes as _c
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("mic")

TARGET_RATE = 16_000
N_BUFFERS = 3
BUFFER_BYTES = 4096  # ~64 ms of f32 mono at 16 kHz

FORMAT_LPCM = 0x6C70636D  # 'lpcm'
FLAG_IS_FLOAT = 1 << 0
FLAG_IS_PACKED = 1 << 3


class AudioStreamBasicDescription(_c.Structure):
    _fields_ = [
        ("mSampleRate", _c.c_double),
        ("mFormatID", _c.c_uint32),
        ("mFormatFlags", _c.c_uint32),
        ("mBytesPerPacket", _c.c_uint32),
        ("mFramesPerPacket", _c.c_uint32),
        ("mBytesPerFrame", _c.c_uint32),
        ("mChannelsPerFrame", _c.c_uint32),
        ("mBitsPerChannel", _c.c_uint32),
        ("mReserved", _c.c_uint32),
    ]


class AudioQueueBuffer(_c.Structure):
    _fields_ = [
        ("mAudioDataBytesCapacity", _c.c_uint32),
        ("mAudioData", _c.c_void_p),
        ("mAudioDataByteSize", _c.c_uint32),
        ("mUserData", _c.c_void_p),
        ("mPacketDescriptionCapacity", _c.c_uint32),
        ("mPacketDescriptions", _c.c_void_p),
        ("mPacketDescriptionCount", _c.c_uint32),
    ]


# AudioQueueInputCallback(userData, queue, buffer, startTime,
#                         numPackets, packetDescs)
INPUT_CALLBACK = _c.CFUNCTYPE(
    None, _c.c_void_p, _c.c_void_p, _c.POINTER(AudioQueueBuffer),
    _c.c_void_p, _c.c_uint32, _c.c_void_p,
)


def _load_audiotoolbox():  # pragma: no cover (darwin)
    return _c.CDLL(
        "/System/Library/Frameworks/AudioToolbox.framework/AudioToolbox"
    )


class MacMicSource:
    """AudioSource over an AudioQueue input stream (injectable lib)."""

    def __init__(self, sample_rate: int = TARGET_RATE, lib=None):
        if lib is None:
            if sys.platform != "darwin":
                raise OSError("AudioQueue capture requires macOS")
            lib = _load_audiotoolbox()  # pragma: no cover (darwin)
        self.lib = lib
        self._rate = sample_rate
        self._closed = threading.Event()
        self._eof = threading.Event()

        from spittle_tpu_torch.native.ringbuffer import (
            NativeRingBuffer,
            native_available,
        )

        self._ring = NativeRingBuffer() if native_available() else None
        self._fallback: List[np.ndarray] = []
        self._fb_lock = threading.Lock()

        lib.AudioQueueNewInput.restype = _c.c_int32
        lib.AudioQueueNewInput.argtypes = [
            _c.POINTER(AudioStreamBasicDescription), INPUT_CALLBACK,
            _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_uint32,
            _c.POINTER(_c.c_void_p),
        ]
        lib.AudioQueueAllocateBuffer.restype = _c.c_int32
        lib.AudioQueueAllocateBuffer.argtypes = [
            _c.c_void_p, _c.c_uint32, _c.POINTER(_c.POINTER(AudioQueueBuffer)),
        ]
        lib.AudioQueueEnqueueBuffer.restype = _c.c_int32
        lib.AudioQueueEnqueueBuffer.argtypes = [
            _c.c_void_p, _c.POINTER(AudioQueueBuffer), _c.c_uint32,
            _c.c_void_p,
        ]
        lib.AudioQueueStart.restype = _c.c_int32
        lib.AudioQueueStart.argtypes = [_c.c_void_p, _c.c_void_p]
        lib.AudioQueueStop.restype = _c.c_int32
        lib.AudioQueueStop.argtypes = [_c.c_void_p, _c.c_bool]
        lib.AudioQueueDispose.restype = _c.c_int32
        lib.AudioQueueDispose.argtypes = [_c.c_void_p, _c.c_bool]

        fmt = AudioStreamBasicDescription(
            mSampleRate=float(sample_rate),
            mFormatID=FORMAT_LPCM,
            mFormatFlags=FLAG_IS_FLOAT | FLAG_IS_PACKED,
            mBytesPerPacket=4, mFramesPerPacket=1, mBytesPerFrame=4,
            mChannelsPerFrame=1, mBitsPerChannel=32, mReserved=0,
        )
        # The thunk must outlive the queue.
        self._cb = INPUT_CALLBACK(self._on_buffer)
        queue = _c.c_void_p()
        status = lib.AudioQueueNewInput(
            _c.byref(fmt), self._cb, None, None, None, 0, _c.byref(queue)
        )
        if status != 0:
            raise OSError(f"AudioQueueNewInput failed: {status}")
        self.queue = queue
        for _ in range(N_BUFFERS):
            buf = _c.POINTER(AudioQueueBuffer)()
            if lib.AudioQueueAllocateBuffer(
                queue, BUFFER_BYTES, _c.byref(buf)
            ) == 0:
                lib.AudioQueueEnqueueBuffer(queue, buf, 0, None)
        status = lib.AudioQueueStart(queue, None)
        if status != 0:
            lib.AudioQueueDispose(queue, True)
            raise OSError(f"AudioQueueStart failed: {status}")

    # -- HAL callback ------------------------------------------------------

    def _on_buffer(self, _user, queue, buf_p, _ts, _packets, _descs):
        try:
            buf = buf_p.contents
            n = buf.mAudioDataByteSize
            if n and buf.mAudioData and not self._closed.is_set():
                raw = _c.string_at(buf.mAudioData, n)
                samples = np.frombuffer(
                    raw[: n - (n % 4)], "<f4"
                ).astype(np.float32)
                self._push(samples)
            if not self._closed.is_set():
                self.lib.AudioQueueEnqueueBuffer(queue, buf_p, 0, None)
        except Exception:  # noqa: BLE001 - HAL callback must not throw
            _log.exception("audio queue callback failed")

    def _push(self, samples: np.ndarray) -> None:
        if self._ring is not None:
            self._ring.write(samples)
        else:
            with self._fb_lock:
                self._fallback.append(samples)

    def _pop(self, max_samples: int) -> np.ndarray:
        if self._ring is not None:
            return self._ring.read(max_samples)
        with self._fb_lock:
            if not self._fallback:
                return np.zeros(0, np.float32)
            return self._fallback.pop(0)

    # -- AudioSource protocol ---------------------------------------------

    @property
    def sample_rate(self) -> int:
        return self._rate

    @property
    def tool_name(self) -> str:
        return "audioqueue"

    def read(self, timeout: float) -> Optional[np.ndarray]:
        deadline = time.monotonic() + timeout
        while True:
            data = self._pop(BUFFER_BYTES)
            if len(data):
                return data
            if self._eof.is_set() or self._closed.is_set():
                return None
            if time.monotonic() >= deadline:
                return np.zeros(0, np.float32)
            time.sleep(0.002)

    def close(self) -> None:
        self._closed.set()
        try:
            self.lib.AudioQueueStop(self.queue, True)
            self.lib.AudioQueueDispose(self.queue, True)
        except Exception:  # noqa: BLE001
            pass
