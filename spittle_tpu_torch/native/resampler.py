"""ctypes binding for the native streaming resampler (spittle_audio.cpp).

Port of spittle_tpu/native/resampler.py.

NativeFrameResampler mirrors audio/resample.py's FrameResampler interface
(`push(samples, emit)` / `finish(emit)`, 30 ms frame emission) — the role
the reference fills with rubato on its capture thread (resampler.rs) — but
runs the per-sample polyphase dot products in C++ so the mic hot path
stays out of the interpreter. The filter tables come from the same kaiser
design the offline `resample()` uses (`_phase_plan`), so the native,
streaming Python and offline outputs agree to float32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np

from spittle_tpu_torch.audio.resample import (
    FRAME_SAMPLES,
    TARGET_SAMPLE_RATE,
    _phase_plan,
    resampled_length,
)
from .ringbuffer import load_native

_configured = False


def _lib():
    global _configured
    lib = load_native()
    if lib is None:
        return None
    if not _configured:
        lib.resampler_create.restype = ctypes.c_void_p
        lib.resampler_create.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ]
        lib.resampler_destroy.argtypes = [ctypes.c_void_p]
        for name in ("resampler_push", "resampler_finish"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
        lib.resampler_push.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.resampler_finish.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        _configured = True
    return lib


def native_resampler_available() -> bool:
    return _lib() is not None


class NativeFrameResampler:
    """Streaming resample-to-16kHz + exact frame emission, native core."""

    def __init__(
        self,
        in_hz: int,
        out_hz: int = TARGET_SAMPLE_RATE,
        frame_samples: int = FRAME_SAMPLES,
    ):
        self.in_hz = in_hz
        self.out_hz = out_hz
        self.frame_samples = frame_samples
        self._identity = in_hz == out_hz
        self._pending = np.zeros(0, dtype=np.float32)
        self._ptr = None
        if not self._identity:
            lib = _lib()
            if lib is None:
                raise RuntimeError("native library unavailable")
            self._lib_ref = lib
            L, M, d, K, hp = _phase_plan(in_hz, out_hz)
            self._L, self._M, self._K = int(L), int(M), int(K)
            d64 = np.ascontiguousarray(d, np.int64)
            hp32 = np.ascontiguousarray(hp, np.float32)
            self._ptr = lib.resampler_create(
                self._L, self._M, self._K,
                d64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                hp32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if not self._ptr:
                raise MemoryError("resampler_create failed")

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib_ref.resampler_destroy(ptr)
            self._ptr = None

    def push(self, src: np.ndarray, emit: Callable[[np.ndarray], None]) -> None:
        src = np.ascontiguousarray(src, np.float32)
        if self._identity:
            self._emit_frames(src, emit)
            return
        cap = resampled_length(len(src) + self._K * self._M, self.in_hz,
                               self.out_hz) + self._L
        out = np.empty(cap, np.float32)
        n = self._lib_ref.resampler_push(
            self._ptr, src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(src), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        )
        self._emit_frames(out[:n], emit)

    def finish(self, emit: Callable[[np.ndarray], None]) -> None:
        if not self._identity:
            cap = resampled_length(
                self._K * self._M + self._M, self.in_hz, self.out_hz
            ) + self._L + self.frame_samples
            out = np.empty(cap, np.float32)
            n = self._lib_ref.resampler_finish(
                self._ptr,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
            )
            if n > 0:
                self._emit_frames(out[:n], emit)
        if len(self._pending):
            frame = np.pad(
                self._pending, (0, self.frame_samples - len(self._pending))
            )
            emit(frame)
            self._pending = np.zeros(0, dtype=np.float32)

    def _emit_frames(
        self, data: np.ndarray, emit: Callable[[np.ndarray], None]
    ) -> None:
        if len(self._pending):
            data = np.concatenate([self._pending, data])
        n_full = len(data) // self.frame_samples
        for i in range(n_full):
            emit(data[i * self.frame_samples : (i + 1) * self.frame_samples])
        self._pending = data[n_full * self.frame_samples :]


def make_frame_resampler(in_hz: int, out_hz: int = TARGET_SAMPLE_RATE,
                         frame_samples: int = FRAME_SAMPLES):
    """Native resampler when the toolchain is available, Python otherwise."""
    if native_resampler_available():
        return NativeFrameResampler(in_hz, out_hz, frame_samples)
    from spittle_tpu_torch.audio.resample import FrameResampler

    return FrameResampler(in_hz, out_hz, frame_samples)
