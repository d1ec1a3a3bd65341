"""Linux uinput keystroke backend (the enigo analog).

Port of spittle_tpu/shell/uinput.py over the same source, the repo's
native/spittle_input.cpp, built into the port's own build directory
(build/spittle_tpu_torch/ at the repo root, beside the CUDA kernels and
libspittle_audio.so).

The reference's primary input simulation is enigo
(`src-tauri/src/input.rs`: layout-independent paste
keycodes :28-52, batched arrow movement :120-150); on Linux that bottoms
out in evdev. This binding drives native/spittle_input.cpp — a virtual
keyboard over /dev/uinput that works on X11 and Wayland with no external
tool. shell/textout.py prefers it when available and falls back to the
wtype/ydotool probe chain otherwise (clipboard.rs:205-276 parity).

Availability requires /dev/uinput write access (uinput group or root);
`UinputKeyboard.available()` probes without side effects.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "spittle_input.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "spittle_tpu_torch")
_LIB = os.path.join(_BUILD_DIR, "libspittle_input.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

MOD_CTRL, MOD_SHIFT, MOD_ALT, MOD_META = 1, 2, 4, 8


def _build() -> bool:
    """g++ into a file of this process's own, renamed into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        ok = subprocess.run(cmd, capture_output=True, timeout=120).returncode == 0
    except Exception:
        ok = False
    if ok:
        os.replace(tmp, _LIB)
    elif os.path.exists(tmp):
        os.remove(tmp)
    return ok


def load_lib(build: bool = True) -> Optional[ctypes.CDLL]:
    """build=False: only load a prebuilt library — availability probes
    on the typing hot path must never trigger a synchronous g++ compile
    (up to 120 s stalling the user's first paste)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB):
            if not build:
                return None  # no latch: an explicit build may follow
            if not _build():
                _build_failed = True
                return None
        lib = ctypes.CDLL(_LIB)
        lib.spittle_uinput_open.restype = ctypes.c_int
        lib.spittle_uinput_type.restype = ctypes.c_int
        lib.spittle_uinput_type.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_uint,
        ]
        lib.spittle_uinput_key.restype = ctypes.c_int
        lib.spittle_uinput_key.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint,
        ]
        lib.spittle_uinput_close.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


class UinputKeyboard:
    """One virtual keyboard; create lazily, keep for the process life
    (device enumeration costs ~100 ms on creation)."""

    SETTLE_S = 0.15  # compositors register new devices asynchronously

    def __init__(self, key_delay_us: int = 1200):
        self._fd = -1
        self.key_delay_us = key_delay_us
        lib = load_lib()
        if lib is None:
            raise OSError("native input library unavailable")
        fd = lib.spittle_uinput_open()
        if fd < 0:
            raise OSError("cannot open /dev/uinput (permission or missing)")
        self._fd = fd
        self._lib = lib
        time.sleep(self.SETTLE_S)

    @staticmethod
    def available() -> bool:
        """Side-effect-free probe: requires a PREBUILT native library
        (build one explicitly via load_lib() / python -m
        spittle_tpu_torch.shell.uinput)."""
        return (
            os.name == "posix"
            and os.path.exists("/dev/uinput")
            and os.access("/dev/uinput", os.W_OK)
            and load_lib(build=False) is not None
        )

    def type_text(self, text: str) -> bool:
        """Types ASCII; returns False if any char is unmappable (caller
        should fall back to a clipboard paste for rich text)."""
        return self.type_prefix(text) == len(text)

    def type_prefix(self, text: str) -> int:
        """Types the longest mappable prefix; returns chars typed.

        Callers falling back to an external tool must retype only
        text[typed:] — retyping the whole string would double the
        already-typed prefix in the focused app."""
        i = 0
        while i < len(text) and ord(text[i]) < 128:
            i += 1
        data = text[:i].encode("ascii")
        if not data:
            return 0
        rc = self._lib.spittle_uinput_type(
            self._fd, data, self.key_delay_us
        )
        return max(0, rc)

    def key(self, name: str, mods: int = 0, count: int = 1) -> bool:
        return (
            self._lib.spittle_uinput_key(
                self._fd, name.encode(), mods, count, self.key_delay_us
            )
            == 0
        )

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.spittle_uinput_close(self._fd)
            self._fd = -1

    def __del__(self):  # best-effort: destroy the virtual device
        try:
            self.close()
        except Exception:
            pass


if __name__ == "__main__":  # explicit build hook (boot-time, not hot path)
    print("built" if load_lib(build=True) is not None else "build failed")
