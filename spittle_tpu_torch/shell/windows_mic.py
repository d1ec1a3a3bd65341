"""Windows microphone capture: a winmm waveIn input stream.

Port of spittle_tpu/shell/windows_mic.py.

The reference captures through cpal (`src-tauri/src/audio_toolkit/audio/
recorder.rs:83-135`), whose Windows backend is WASAPI; the classic
waveIn API sits on the same capture stack with a dramatically simpler
ABI (no COM activation/threading model), is still fully supported, and
natively delivers the exact format the pipeline wants (16 kHz mono
s16le — the engine wire format).

  waveInOpen(WAVE_MAPPER, 16k/16-bit/mono, callback, CALLBACK_FUNCTION)
  waveInPrepareHeader + waveInAddBuffer x3
  waveInStart; the driver thread delivers filled WAVEHDRs to the
  callback (WIM_DATA), which converts i16 -> f32 into the lock-free
  C++ SPSC ring and re-adds the buffer.

Same AudioSource protocol as shell/mic.MicSource / macos_mic
.MacMicSource. winmm is an injectable seam; tests drive the callback
with PCM through a compiled C fake (tests/test_torch_shell_windows.py) so
the real ctypes struct/callback marshalling is exercised.
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
BUFFER_BYTES = 4096  # ~128 ms of s16 mono at 16 kHz

WAVE_MAPPER = 0xFFFFFFFF
WAVE_FORMAT_PCM = 1
CALLBACK_FUNCTION = 0x00030000
WIM_DATA = 0x3C0
MMSYSERR_NOERROR = 0


class WAVEFORMATEX(_c.Structure):
    _fields_ = [
        ("wFormatTag", _c.c_uint16),
        ("nChannels", _c.c_uint16),
        ("nSamplesPerSec", _c.c_uint32),
        ("nAvgBytesPerSec", _c.c_uint32),
        ("nBlockAlign", _c.c_uint16),
        ("wBitsPerSample", _c.c_uint16),
        ("cbSize", _c.c_uint16),
    ]


class WAVEHDR(_c.Structure):
    _fields_ = [
        ("lpData", _c.c_void_p),
        ("dwBufferLength", _c.c_uint32),
        ("dwBytesRecorded", _c.c_uint32),
        ("dwUser", _c.c_void_p),
        ("dwFlags", _c.c_uint32),
        ("dwLoops", _c.c_uint32),
        ("lpNext", _c.c_void_p),
        ("reserved", _c.c_void_p),
    ]


# waveInProc(hwi, uMsg, dwInstance, dwParam1=WAVEHDR*, dwParam2)
_WAVEIN_CALLBACK_FACTORY = getattr(_c, "WINFUNCTYPE", _c.CFUNCTYPE)
WAVEIN_CALLBACK = _WAVEIN_CALLBACK_FACTORY(
    None, _c.c_void_p, _c.c_uint32, _c.c_void_p, _c.POINTER(WAVEHDR),
    _c.c_void_p,
)


class WinMicSource:
    """AudioSource over a waveIn stream (injectable winmm)."""

    def __init__(self, sample_rate: int = TARGET_RATE, winmm=None,
                 device: Optional[int] = None):
        if winmm is None:
            if sys.platform != "win32":
                raise OSError("waveIn capture requires Windows")
            winmm = _c.windll.winmm  # pragma: no cover (win32)
        self.winmm = winmm
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

        winmm.waveInOpen.restype = _c.c_uint32
        winmm.waveInOpen.argtypes = [
            _c.POINTER(_c.c_void_p), _c.c_uint32, _c.POINTER(WAVEFORMATEX),
            WAVEIN_CALLBACK, _c.c_void_p, _c.c_uint32,
        ]
        winmm.waveInPrepareHeader.restype = _c.c_uint32
        winmm.waveInPrepareHeader.argtypes = [
            _c.c_void_p, _c.POINTER(WAVEHDR), _c.c_uint32,
        ]
        winmm.waveInAddBuffer.restype = _c.c_uint32
        winmm.waveInAddBuffer.argtypes = [
            _c.c_void_p, _c.POINTER(WAVEHDR), _c.c_uint32,
        ]
        winmm.waveInStart.restype = _c.c_uint32
        winmm.waveInStart.argtypes = [_c.c_void_p]
        winmm.waveInStop.restype = _c.c_uint32
        winmm.waveInStop.argtypes = [_c.c_void_p]
        winmm.waveInReset.restype = _c.c_uint32
        winmm.waveInReset.argtypes = [_c.c_void_p]
        winmm.waveInClose.restype = _c.c_uint32
        winmm.waveInClose.argtypes = [_c.c_void_p]

        fmt = WAVEFORMATEX(
            wFormatTag=WAVE_FORMAT_PCM, nChannels=1,
            nSamplesPerSec=sample_rate,
            nAvgBytesPerSec=sample_rate * 2, nBlockAlign=2,
            wBitsPerSample=16, cbSize=0,
        )
        self._cb = WAVEIN_CALLBACK(self._on_data)  # must outlive the handle
        handle = _c.c_void_p()
        dev = WAVE_MAPPER if device is None else device
        rc = winmm.waveInOpen(
            _c.byref(handle), dev, _c.byref(fmt), self._cb, None,
            CALLBACK_FUNCTION,
        )
        if rc != MMSYSERR_NOERROR:
            raise OSError(f"waveInOpen failed: {rc}")
        self.handle = handle
        self._buffers = []  # keep hdr + data alive for the driver
        for _ in range(N_BUFFERS):
            data = _c.create_string_buffer(BUFFER_BYTES)
            hdr = WAVEHDR(
                lpData=_c.cast(data, _c.c_void_p),
                dwBufferLength=BUFFER_BYTES,
            )
            self._buffers.append((hdr, data))
            winmm.waveInPrepareHeader(handle, _c.byref(hdr),
                                      _c.sizeof(WAVEHDR))
            winmm.waveInAddBuffer(handle, _c.byref(hdr), _c.sizeof(WAVEHDR))
        rc = winmm.waveInStart(handle)
        if rc != MMSYSERR_NOERROR:
            winmm.waveInClose(handle)
            raise OSError(f"waveInStart failed: {rc}")

    # -- driver callback ---------------------------------------------------

    def _on_data(self, _hwi, msg, _inst, hdr_p, _p2):
        try:
            if msg != WIM_DATA:
                return
            hdr = hdr_p.contents
            n = hdr.dwBytesRecorded
            if n and hdr.lpData and not self._closed.is_set():
                raw = _c.string_at(hdr.lpData, n)
                samples = (
                    np.frombuffer(raw[: n - (n % 2)], "<i2")
                    .astype(np.float32) / 32768.0
                )
                self._push(samples)
            if not self._closed.is_set():
                hdr.dwBytesRecorded = 0
                self.winmm.waveInAddBuffer(
                    self.handle, hdr_p, _c.sizeof(WAVEHDR)
                )
        except Exception:  # noqa: BLE001 - driver callback must not throw
            _log.exception("waveIn callback failed")

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
        return "wavein"

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
            self.winmm.waveInStop(self.handle)
            self.winmm.waveInReset(self.handle)
            self.winmm.waveInClose(self.handle)
        except Exception:  # noqa: BLE001
            pass
