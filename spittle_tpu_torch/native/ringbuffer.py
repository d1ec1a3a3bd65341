"""ctypes bindings for the native audio runtime (port of
spittle_tpu/native/ringbuffer.py over the same source, the repo's
native/spittle_audio.cpp).

Builds the shared library on first use with g++ into the port's own build
directory (build/spittle_tpu_torch/ at the repo root, beside the CUDA
kernels), exposing the lock-free SPSC ring buffer and PCM converters.
`RingBufferSource` adapts the ring into the recorder's AudioSource protocol
so the real-time capture callback stays native while the consumer side is
the same streaming chain the rest of the framework uses.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "spittle_audio.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "spittle_tpu_torch")
_LIB = os.path.join(_BUILD_DIR, "libspittle_audio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    """g++ into a file of this process's own, renamed into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", tmp, _SRC,
    ]
    try:
        ok = subprocess.run(cmd, capture_output=True, timeout=120).returncode == 0
    except Exception:
        ok = False
    if ok:
        os.replace(tmp, _LIB)
    elif os.path.exists(tmp):
        os.remove(tmp)
    return ok


def load_native() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                _build_failed = True
                return None
        lib = ctypes.CDLL(_LIB)
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_uint64]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_capacity.restype = ctypes.c_uint64
        lib.ring_capacity.argtypes = [ctypes.c_void_p]
        lib.ring_available.restype = ctypes.c_uint64
        lib.ring_available.argtypes = [ctypes.c_void_p]
        lib.ring_dropped.restype = ctypes.c_uint64
        lib.ring_dropped.argtypes = [ctypes.c_void_p]
        lib.ring_write.restype = ctypes.c_uint64
        lib.ring_write.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]
        lib.ring_read.restype = ctypes.c_uint64
        lib.ring_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]
        lib.ring_write_i16.restype = ctypes.c_uint64
        lib.ring_write_i16.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_uint64,
            ctypes.c_uint32]
        for name in ("pcm_i16_to_mono_f32", "pcm_i32_to_mono_f32",
                     "pcm_u8_to_mono_f32", "pcm_f32_to_mono"):
            getattr(lib, name).restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


class NativeRingBuffer:
    """SPSC float ring: producer = capture callback, consumer = recorder."""

    def __init__(self, min_capacity: int = 1 << 18):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native audio library unavailable (g++ build failed)")
        self._lib = lib
        self._ptr = lib.ring_create(min_capacity)
        if not self._ptr:
            raise MemoryError("ring_create failed")

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.ring_destroy(ptr)
            self._ptr = None

    @property
    def capacity(self) -> int:
        return self._lib.ring_capacity(self._ptr)

    @property
    def available(self) -> int:
        return self._lib.ring_available(self._ptr)

    @property
    def dropped(self) -> int:
        return self._lib.ring_dropped(self._ptr)

    def write(self, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.float32)
        return self._lib.ring_write(
            self._ptr,
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(samples),
        )

    def write_i16(self, samples: np.ndarray, channels: int = 1) -> int:
        samples = np.ascontiguousarray(samples, np.int16)
        frames = len(samples) // channels
        return self._lib.ring_write_i16(
            self._ptr,
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            frames, channels,
        )

    def read(self, max_samples: int) -> np.ndarray:
        out = np.empty(max_samples, np.float32)
        n = self._lib.ring_read(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples,
        )
        return out[:n]


def pcm_to_mono_f32(data: np.ndarray, channels: int) -> np.ndarray:
    """Native interleaved PCM -> mono f32 (any of u8/i16/i32/f32)."""
    lib = load_native()
    data = np.ascontiguousarray(data)
    frames = len(data) // channels
    out = np.empty(frames, np.float32)
    optr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if data.dtype == np.int16:
        lib.pcm_i16_to_mono_f32(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), frames,
            channels, optr)
    elif data.dtype == np.int32:
        lib.pcm_i32_to_mono_f32(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), frames,
            channels, optr)
    elif data.dtype == np.uint8:
        lib.pcm_u8_to_mono_f32(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), frames,
            channels, optr)
    elif data.dtype == np.float32:
        lib.pcm_f32_to_mono(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames,
            channels, optr)
    else:
        raise TypeError(f"unsupported dtype {data.dtype}")
    return out


class RingBufferSource:
    """AudioSource over a native ring (recorder.AudioSource protocol)."""

    def __init__(self, sample_rate: int = 16000, min_capacity: int = 1 << 18,
                 chunk: int = 2048):
        self._rate = sample_rate
        self.ring = NativeRingBuffer(min_capacity)
        self._chunk = chunk
        self._closed = threading.Event()

    @property
    def sample_rate(self) -> int:
        return self._rate

    def close(self) -> None:
        self._closed.set()

    def read(self, timeout: float):
        if self._closed.is_set() and self.ring.available == 0:
            return None
        deadline = None if timeout is None else (timeout + _mono())
        while True:
            data = self.ring.read(self._chunk)
            if len(data):
                return data
            if self._closed.is_set():
                return None
            if deadline is not None and _mono() >= deadline:
                return np.zeros(0, np.float32)
            _sleep(0.002)


def _mono():
    import time

    return time.monotonic()


def _sleep(s):
    import time

    time.sleep(s)
