"""Windows global hotkeys: RegisterHotKey + a thread message loop.

Port of spittle_tpu/shell/windows_keys.py.

The reference HEARS global hotkeys on Windows through
tauri-plugin-global-shortcut (`src-tauri/src/shortcut/tauri_impl.rs:
108-109`), whose Windows backend registers system-wide hotkeys. This
arm uses the same OS facility directly:

  RegisterHotKey(NULL, id, MOD_*, vk)    on a dedicated loop thread
  GetMessageW -> WM_HOTKEY               (hotkeys deliver to the
                                          REGISTERING thread's queue,
                                          so registration requests are
                                          posted to the loop thread via
                                          PostThreadMessageW WM_APP+n)
  release detection: WM_HOTKEY only signals the press, but push-to-talk
  needs the release edge — a poller watches GetAsyncKeyState(vk) until
  the key goes up and fires the release callback (the standard pattern
  for RegisterHotKey-based PTT).

Key-capture recording mode is not available through RegisterHotKey
(it hears only registered chords); the registry's capture falls back
to the frontend key-capture path, same as the reference's Windows
binding editor. user32 is an injectable seam; tests drive WM_HOTKEY
delivery and release polling through a compiled C fake
(tests/test_torch_shell_windows.py).
"""

from __future__ import annotations

import ctypes as _c
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger

from .evdev_keys import normalize_hotkey
from .windows_input import vk_for_name

_log = get_logger("hotkeys")

MOD_ALT = 0x0001
MOD_CONTROL = 0x0002
MOD_SHIFT = 0x0004
MOD_WIN = 0x0008
MOD_NOREPEAT = 0x4000

WM_HOTKEY = 0x0312
WM_APP = 0x8000
WM_APP_REGISTER = WM_APP + 1
WM_APP_UNREGISTER = WM_APP + 2
WM_APP_QUIT = WM_APP + 3

KEY_DOWN_BIT = 0x8000

_MOD_BITS = {
    "ctrl": MOD_CONTROL, "alt": MOD_ALT, "shift": MOD_SHIFT,
    "super": MOD_WIN,
}


class MSG(_c.Structure):
    _fields_ = [
        ("hwnd", _c.c_void_p),
        ("message", _c.c_uint32),
        ("wParam", _c.c_size_t),
        ("lParam", _c.c_ssize_t),
        ("time", _c.c_uint32),
        ("pt_x", _c.c_long),
        ("pt_y", _c.c_long),
    ]


def hotkey_to_win(hotkey: str) -> Optional[Tuple[int, int]]:
    """'ctrl+shift+space' -> (MOD_CONTROL|MOD_SHIFT, VK_SPACE)."""
    norm = normalize_hotkey(hotkey)
    if norm is None:
        return None
    mods, key = norm
    vk = vk_for_name(key)
    if vk is None:
        return None
    bits = 0
    for m in mods:
        bits |= _MOD_BITS[m]
    return bits, vk


class WinHotkeyBackend:
    """ShortcutBackend over RegisterHotKey (win32 arm of HANDY_KEYS).

    user32/kernel32 injectable; release polling interval tunable for
    tests."""

    def __init__(self, user32=None, kernel32=None,
                 poll_interval: float = 0.01):
        if user32 is None or kernel32 is None:
            if sys.platform != "win32":
                raise OSError("RegisterHotKey requires Windows")
            user32 = _c.windll.user32  # pragma: no cover (win32)
            kernel32 = _c.windll.kernel32  # pragma: no cover (win32)
        self.user32 = user32
        self.kernel32 = kernel32
        self._poll = poll_interval
        self._lock = threading.Lock()
        self._by_id: Dict[int, Tuple[str, int, Callable]] = {}
        self._ids: Dict[str, int] = {}
        self._next_id = 1
        self._tid: Optional[int] = None
        self._thread = None
        self._ready = threading.Event()
        self._stop = threading.Event()

        user32.RegisterHotKey.restype = _c.c_bool
        user32.RegisterHotKey.argtypes = [
            _c.c_void_p, _c.c_int, _c.c_uint32, _c.c_uint32,
        ]
        user32.UnregisterHotKey.restype = _c.c_bool
        user32.UnregisterHotKey.argtypes = [_c.c_void_p, _c.c_int]
        user32.GetMessageW.restype = _c.c_int
        user32.GetMessageW.argtypes = [
            _c.POINTER(MSG), _c.c_void_p, _c.c_uint32, _c.c_uint32,
        ]
        user32.PostThreadMessageW.restype = _c.c_bool
        user32.PostThreadMessageW.argtypes = [
            _c.c_uint32, _c.c_uint32, _c.c_size_t, _c.c_ssize_t,
        ]
        user32.GetAsyncKeyState.restype = _c.c_int16
        user32.GetAsyncKeyState.argtypes = [_c.c_int]
        kernel32.GetCurrentThreadId.restype = _c.c_uint32
        kernel32.GetCurrentThreadId.argtypes = []

    @classmethod
    def available(cls) -> bool:
        return sys.platform == "win32"

    # -- message loop ------------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._thread is not None:
            return
        self._thread = threads.spawn(self._loop, name="win-hotkeys")
        self._ready.wait(timeout=5)

    def _loop(self) -> None:
        self._tid = int(self.kernel32.GetCurrentThreadId())
        self._ready.set()
        msg = MSG()
        while not self._stop.is_set():
            rc = self.user32.GetMessageW(_c.byref(msg), None, 0, 0)
            if rc <= 0:
                return
            if msg.message == WM_APP_QUIT:
                return
            if msg.message == WM_APP_REGISTER:
                hid = int(msg.wParam)
                packed = int(msg.lParam)
                mods, vk = (packed >> 16) & 0xFFFF, packed & 0xFFFF
                ok = self.user32.RegisterHotKey(
                    None, hid, mods | MOD_NOREPEAT, vk
                )
                if not ok:
                    with self._lock:
                        entry = self._by_id.pop(hid, None)
                        if entry:
                            self._ids.pop(entry[0], None)
                    _log.info("RegisterHotKey(%d) failed", hid)
            elif msg.message == WM_APP_UNREGISTER:
                self.user32.UnregisterHotKey(None, int(msg.wParam))
            elif msg.message == WM_HOTKEY:
                self._fire(int(msg.wParam))

    def _fire(self, hid: int) -> None:
        with self._lock:
            entry = self._by_id.get(hid)
        if entry is None:
            return
        hotkey, vk, callback = entry
        callback(hotkey, True)
        # Release edge: poll the main key until it goes up.
        threads.spawn(
            lambda: self._wait_release(hotkey, vk, callback),
            name="win-hotkey-release",
        )

    def _wait_release(self, hotkey: str, vk: int, callback) -> None:
        while not self._stop.is_set():
            state = int(self.user32.GetAsyncKeyState(vk))
            if not (state & KEY_DOWN_BIT):
                callback(hotkey, False)
                return
            time.sleep(self._poll)

    # -- ShortcutBackend protocol -----------------------------------------

    def register(self, hotkey: str, callback: Callable[[str, bool], None]) -> bool:
        win = hotkey_to_win(hotkey)
        if win is None:
            return False
        mods, vk = win
        self._ensure_loop()
        if self._tid is None:
            return False
        with self._lock:
            if hotkey in self._ids:
                return True
            hid = self._next_id
            self._next_id += 1
            self._by_id[hid] = (hotkey, vk, callback)
            self._ids[hotkey] = hid
        self.user32.PostThreadMessageW(
            self._tid, WM_APP_REGISTER, hid, (mods << 16) | vk
        )
        return True

    def unregister(self, hotkey: str) -> bool:
        with self._lock:
            hid = self._ids.pop(hotkey, None)
            if hid is not None:
                self._by_id.pop(hid, None)
        if hid is None:
            return False
        if self._tid is not None:
            self.user32.PostThreadMessageW(self._tid, WM_APP_UNREGISTER,
                                           hid, 0)
        return True

    def close(self) -> None:
        self._stop.set()
        if self._tid is not None:
            self.user32.PostThreadMessageW(self._tid, WM_APP_QUIT, 0, 0)
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
