"""macOS global-hotkey capture: a CGEventTap session listener.

Port of spittle_tpu/shell/macos_keys.py.

The reference HEARS global hotkeys on macOS through
tauri-plugin-global-shortcut (`src-tauri/src/shortcut/tauri_impl.rs`),
which registers a Carbon/CGEventTap-backed monitor. This arm taps the
session event stream directly:

  CGEventTapCreate(kCGSessionEventTap, kCGHeadInsertEventTap,
                   kCGEventTapOptionListenOnly,
                   keyDown|keyUp|flagsChanged, callback, NULL)
  CFMachPortCreateRunLoopSource -> CFRunLoopAddSource -> CFRunLoopRun
  (on a worker thread; CFRunLoopStop to shut down)

Listen-only (the pill app never swallows keystrokes — parity with the
evdev arm, which reads /dev/input without grabbing). Keycodes are the
fixed kVK_* virtual codes (layout-independent positions, the same
table Carbon has shipped since 10.0); modifiers come from the event
flags word so flagsChanged drives modifier press/release edges.

Chord semantics (subset matching, most-specific-wins, modifier-less
cancel while a chord is held) are inherited from
evdev_keys.ChordDispatchBackend — identical across platforms by
construction. The CoreGraphics/CoreFoundation libraries are injectable
seams; tests drive the registered callback with synthetic events
through a compiled C fake (tests/test_torch_shell_macos.py).
"""

from __future__ import annotations

import ctypes as _c
import sys
import threading
from typing import Optional

from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger

from .evdev_keys import ChordDispatchBackend

_log = get_logger("hotkeys")

# CGEventType values + mask
KEY_DOWN, KEY_UP, FLAGS_CHANGED = 10, 11, 12
EVENT_MASK = (1 << KEY_DOWN) | (1 << KEY_UP) | (1 << FLAGS_CHANGED)
SESSION_TAP = 1          # kCGSessionEventTap
HEAD_INSERT = 0          # kCGHeadInsertEventTap
LISTEN_ONLY = 1          # kCGEventTapOptionListenOnly
KEYCODE_FIELD = 9        # kCGKeyboardEventKeycode

# Event flags -> canonical modifier names (evdev_keys._MOD_ALIASES
# canon: ctrl/alt/shift/super).
FLAG_MODS = (
    (1 << 17, "shift"),    # NSEventModifierFlagShift
    (1 << 18, "ctrl"),     # ...Control
    (1 << 19, "alt"),      # ...Option
    (1 << 20, "super"),    # ...Command
)

# kVK_* virtual keycodes (fixed ANSI positions) -> portable key names
# matching the evdev table's vocabulary.
KVK_TO_NAME = {
    0: "a", 1: "s", 2: "d", 3: "f", 4: "h", 5: "g", 6: "z", 7: "x",
    8: "c", 9: "v", 11: "b", 12: "q", 13: "w", 14: "e", 15: "r",
    16: "y", 17: "t", 18: "1", 19: "2", 20: "3", 21: "4", 22: "6",
    23: "5", 24: "equal", 25: "9", 26: "7", 27: "minus", 28: "8",
    29: "0", 30: "rightbrace", 31: "o", 32: "u", 33: "leftbrace",
    34: "i", 35: "p", 36: "enter", 37: "l", 38: "j", 39: "apostrophe",
    40: "k", 41: "semicolon", 42: "backslash", 43: "comma",
    44: "slash", 45: "n", 46: "m", 47: "dot", 48: "tab", 49: "space",
    50: "grave", 51: "backspace", 53: "escape",
    54: "super", 55: "super", 56: "shift", 58: "alt", 59: "ctrl",
    60: "shift", 61: "alt", 62: "ctrl",
    96: "f5", 97: "f6", 98: "f7", 99: "f3", 100: "f8", 101: "f9",
    103: "f11", 109: "f10", 111: "f12", 115: "home", 116: "pageup",
    117: "delete", 118: "f4", 119: "end", 120: "f2", 121: "pagedown",
    122: "f1", 123: "left", 124: "right", 125: "down", 126: "up",
}

MODIFIER_NAMES = frozenset({"ctrl", "alt", "shift", "super"})

_TAP_CALLBACK = _c.CFUNCTYPE(
    _c.c_void_p, _c.c_void_p, _c.c_uint32, _c.c_void_p, _c.c_void_p
)


def _load_frameworks():  # pragma: no cover (darwin)
    cg = _c.CDLL(
        "/System/Library/Frameworks/ApplicationServices.framework/"
        "ApplicationServices"
    )
    cf = _c.CDLL(
        "/System/Library/Frameworks/CoreFoundation.framework/"
        "CoreFoundation"
    )
    return cg, cf


class QuartzEventTapListener:
    """Owns the tap + run loop thread; emits (key, pressed, mods)."""

    def __init__(self, on_key, cg=None, cf=None):
        if cg is None or cf is None:
            if sys.platform != "darwin":
                raise OSError("CGEventTap requires macOS")
            cg, cf = _load_frameworks()  # pragma: no cover (darwin)
        self.cg = cg
        self.cf = cf
        self.on_key = on_key
        self._mods: set = set()
        self._runloop = None
        self._thread = None
        self._tap = None
        # The callback thunk must outlive the tap.
        self._cb = _TAP_CALLBACK(self._tap_callback)

        cg.CGEventTapCreate.restype = _c.c_void_p
        cg.CGEventTapCreate.argtypes = [
            _c.c_uint32, _c.c_uint32, _c.c_uint32, _c.c_uint64,
            _TAP_CALLBACK, _c.c_void_p,
        ]
        cg.CGEventGetIntegerValueField.restype = _c.c_int64
        cg.CGEventGetIntegerValueField.argtypes = [_c.c_void_p, _c.c_uint32]
        cg.CGEventGetFlags.restype = _c.c_uint64
        cg.CGEventGetFlags.argtypes = [_c.c_void_p]
        cg.CGEventTapEnable.restype = None
        cg.CGEventTapEnable.argtypes = [_c.c_void_p, _c.c_bool]
        cf.CFMachPortCreateRunLoopSource.restype = _c.c_void_p
        cf.CFMachPortCreateRunLoopSource.argtypes = [
            _c.c_void_p, _c.c_void_p, _c.c_long,
        ]
        cf.CFRunLoopGetCurrent.restype = _c.c_void_p
        cf.CFRunLoopGetCurrent.argtypes = []
        cf.CFRunLoopAddSource.restype = None
        cf.CFRunLoopAddSource.argtypes = [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,
        ]
        cf.CFRunLoopRun.restype = None
        cf.CFRunLoopRun.argtypes = []
        cf.CFRunLoopStop.restype = None
        cf.CFRunLoopStop.argtypes = [_c.c_void_p]

    def create_tap(self) -> bool:
        self._tap = self.cg.CGEventTapCreate(
            SESSION_TAP, HEAD_INSERT, LISTEN_ONLY, EVENT_MASK,
            self._cb, None,
        )
        if not self._tap:
            # No Accessibility permission (System Settings > Privacy >
            # Accessibility) — the registry falls back to the in-process
            # backend, same as evdev with no /dev/input access.
            _log.info("CGEventTapCreate failed (accessibility permission?)")
            return False
        self.cg.CGEventTapEnable(self._tap, True)
        return True

    def start(self) -> bool:
        if self._tap is None and not self.create_tap():
            return False
        started = threading.Event()

        def run():
            self._runloop = self.cf.CFRunLoopGetCurrent()
            source = self.cf.CFMachPortCreateRunLoopSource(
                None, self._tap, 0
            )
            mode = getattr(self.cf, "kCFRunLoopCommonModes", None)
            self.cf.CFRunLoopAddSource(self._runloop, source, mode)
            started.set()
            self.cf.CFRunLoopRun()

        self._thread = threads.spawn(run, name="quartz-tap")
        started.wait(timeout=5)
        return True

    def stop(self) -> None:
        if self._runloop is not None:
            self.cf.CFRunLoopStop(self._runloop)
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # -- event decoding ---------------------------------------------------

    def _tap_callback(self, _proxy, etype, event, _refcon):
        try:
            self._handle(etype, event)
        except Exception:  # noqa: BLE001 - a tap callback must not throw
            _log.exception("event tap dispatch failed")
        return event  # listen-only: pass the event through unmodified

    def _handle(self, etype: int, event) -> None:
        keycode = int(self.cg.CGEventGetIntegerValueField(
            event, KEYCODE_FIELD
        ))
        name = KVK_TO_NAME.get(keycode)
        if name is None:
            return
        if etype == FLAGS_CHANGED:
            # Modifier edges arrive as flag transitions, not up/down.
            flags = int(self.cg.CGEventGetFlags(event))
            now = {m for bit, m in FLAG_MODS if flags & bit}
            if name in MODIFIER_NAMES:
                pressed = name in now
                before = set(self._mods)
                self._mods = now
                if pressed and name not in before:
                    self.on_key(name, True, frozenset(now))
                elif not pressed and name in before:
                    self.on_key(name, False, frozenset(now))
            return
        if etype == KEY_DOWN:
            self.on_key(name, True, frozenset(self._mods | {name}))
        elif etype == KEY_UP:
            self.on_key(name, False, frozenset(self._mods))


class QuartzBackend(ChordDispatchBackend):
    """ShortcutBackend over the CGEventTap listener (darwin arm of the
    HANDY_KEYS implementation; chord semantics shared with evdev)."""

    def __init__(self, cg=None, cf=None):
        super().__init__()
        self.listener = QuartzEventTapListener(self._on_key, cg=cg, cf=cf)

    @classmethod
    def available(cls) -> bool:
        return sys.platform == "darwin"

    def _listener_ready(self) -> bool:
        return self.listener._tap is not None or self.listener.create_tap()

    def _ensure_started(self) -> None:
        if not self._started:
            self._started = self.listener.start()

    def close(self) -> None:
        self.listener.stop()
        self._started = False
