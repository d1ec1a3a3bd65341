"""ctypes bindings over native/spittle_audio.cpp (port of
spittle_tpu/native)."""

from .ringbuffer import NativeRingBuffer, RingBufferSource, load_native, native_available

__all__ = [
    "NativeRingBuffer",
    "RingBufferSource",
    "load_native",
    "native_available",
]
