"""Linux evdev global-hotkey capture: the listener that HEARS keys.

Port of spittle_tpu/shell/evdev_keys.py.

Completes the hotkey loop the reference's handy-keys backend owns
(reference: src-tauri/src/shortcut/spittle-keys.rs:45-57 manager thread
receiving OS key events, :90 HotkeyManager, :263-380 key-capture
recording mode streaming FrontendKeyEvents). The uinput side
(native/spittle_input.cpp + shell/uinput.py) can only inject; this
module reads the kernel `input_event` stream from `/dev/input/event*`,
tracks chord state, and drives a `ShortcutRegistry` — push-to-talk,
toggle, and cancel hotkeys work with zero external shell.

Design notes:
- The reader consumes the raw 24-byte `struct input_event` wire format
  (struct timeval + type/code/value) from ANY readable fd. Real
  keyboards come from `discover_keyboards()` (EVIOCGBIT capability
  probe); tests feed the same wire format through an `os.pipe()`, so
  the chord tracking, hotkey matching, and capture streaming are
  exercised without hardware (this container has no /dev/input).
- Chord semantics: a binding fires pressed=True when its main key goes
  down with exactly its modifier set held, and pressed=False when the
  main key OR any required modifier is released — a broken chord must
  end push-to-talk.
- Autorepeat (value=2) is ignored, like the reference's HotkeyManager.
"""

from __future__ import annotations

import array
import fcntl
import glob
import os
import select
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("evdev")

# struct input_event on LP64: struct timeval (2 longs) + __u16 type +
# __u16 code + __s32 value.
EVENT_FORMAT = "llHHi"
EVENT_SIZE = struct.calcsize(EVENT_FORMAT)

EV_KEY = 0x01

# Linux input-event-codes.h (keyboard subset).
KEYCODES: Dict[int, str] = {
    1: "escape", 2: "1", 3: "2", 4: "3", 5: "4", 6: "5", 7: "6", 8: "7",
    9: "8", 10: "9", 11: "0", 12: "minus", 13: "equal", 14: "backspace",
    15: "tab", 16: "q", 17: "w", 18: "e", 19: "r", 20: "t", 21: "y",
    22: "u", 23: "i", 24: "o", 25: "p", 26: "leftbrace", 27: "rightbrace",
    28: "enter", 29: "ctrl", 30: "a", 31: "s", 32: "d", 33: "f", 34: "g",
    35: "h", 36: "j", 37: "k", 38: "l", 39: "semicolon", 40: "apostrophe",
    41: "grave", 42: "shift", 43: "backslash", 44: "z", 45: "x", 46: "c",
    47: "v", 48: "b", 49: "n", 50: "m", 51: "comma", 52: "dot",
    53: "slash", 54: "shift", 55: "kpasterisk", 56: "alt", 57: "space",
    58: "capslock", 59: "f1", 60: "f2", 61: "f3", 62: "f4", 63: "f5",
    64: "f6", 65: "f7", 66: "f8", 67: "f9", 68: "f10", 87: "f11",
    88: "f12", 96: "enter", 97: "ctrl", 100: "alt", 102: "home",
    103: "up", 104: "pageup", 105: "left", 106: "right", 107: "end",
    108: "down", 109: "pagedown", 110: "insert", 111: "delete",
    119: "pause", 125: "super", 126: "super", 127: "compose",
}
# Reverse map for tests/injection helpers (first code wins for dups).
KEY_TO_CODE: Dict[str, int] = {}
for _code, _name in KEYCODES.items():
    KEY_TO_CODE.setdefault(_name, _code)

MODIFIER_KEYS = {"ctrl", "shift", "alt", "super"}

# Hotkey-string modifier aliases (matches shortcuts.validate_hotkey).
_MOD_ALIASES = {
    "ctrl": "ctrl", "control": "ctrl",
    "alt": "alt", "option": "alt",
    "shift": "shift",
    "cmd": "super", "super": "super", "meta": "super",
}


def pack_event(code: int, value: int, ev_type: int = EV_KEY) -> bytes:
    """Encode one kernel input_event (tests + loopback tooling)."""
    return struct.pack(EVENT_FORMAT, 0, 0, ev_type, code, value)


def pack_key(name: str, pressed: bool) -> bytes:
    """Encode a key event by name (SYN report omitted; EV_KEY only)."""
    return pack_event(KEY_TO_CODE[name], 1 if pressed else 0)


def normalize_hotkey(hotkey: str) -> Optional[Tuple[frozenset, str]]:
    """'ctrl+shift+space' -> (frozenset({'ctrl','shift'}), 'space')."""
    parts = [p.strip().lower() for p in hotkey.split("+") if p.strip()]
    if not parts:
        return None
    *mods, key = parts
    canon = set()
    for m in mods:
        alias = _MOD_ALIASES.get(m)
        if alias is None:
            return None
        canon.add(alias)
    return frozenset(canon), _MOD_ALIASES.get(key, key)


# -- device discovery ---------------------------------------------------

def _ioc(direction: int, nr: int, size: int) -> int:
    # _IOC(_IOC_READ, 'E', nr, size)
    return (direction << 30) | (size << 16) | (ord("E") << 8) | nr


def _supports_keyboard(fd: int) -> bool:
    """EVIOCGBIT(EV_KEY): device advertises letter keys + space."""
    nbytes = 96  # KEY_MAX/8 rounded up
    buf = array.array("B", bytes(nbytes))
    try:
        fcntl.ioctl(fd, _ioc(2, 0x20 + EV_KEY, nbytes), buf, True)
    except OSError:
        return False

    def bit(code: int) -> bool:
        return bool(buf[code // 8] & (1 << (code % 8)))

    return bit(KEY_TO_CODE["a"]) and bit(KEY_TO_CODE["space"])


def discover_keyboards(pattern: str = "/dev/input/event*") -> List[int]:
    """Open every event device that looks like a keyboard; returns fds."""
    fds = []
    for path in sorted(glob.glob(pattern)):
        try:
            fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        except OSError:
            continue
        if _supports_keyboard(fd):
            fds.append(fd)
        else:
            os.close(fd)
    return fds


# -- the listener -------------------------------------------------------

class EvdevKeyListener:
    """Reads input_event streams, tracks modifier/chord state, and
    dispatches (key, is_pressed, modifiers) to a callback."""

    def __init__(
        self,
        on_key: Callable[[str, bool, frozenset], None],
        fds: Optional[List[int]] = None,
        own_fds: bool = True,
    ):
        self._on_key = on_key
        self._fds = list(fds) if fds is not None else discover_keyboards()
        self._own_fds = own_fds
        self._held_mods: set = set()
        self._stop_r, self._stop_w = os.pipe()
        self._thread: Optional[threading.Thread] = None
        self._buffers: Dict[int, bytes] = {fd: b"" for fd in self._fds}

    @property
    def device_count(self) -> int:
        return len(self._fds)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threads.spawn(self._run, name="evdev-listener")

    def stop(self) -> None:
        if self._thread is not None:
            os.write(self._stop_w, b"x")
            self._thread.join(timeout=5)
            self._thread = None
        if self._own_fds:
            for fd in self._fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._fds = []
        try:
            os.close(self._stop_r)
            os.close(self._stop_w)
        except OSError:
            pass

    def _run(self) -> None:
        while True:
            ready, _, _ = select.select(self._fds + [self._stop_r], [], [])
            if self._stop_r in ready:
                os.read(self._stop_r, 1)
                return
            for fd in ready:
                if fd == self._stop_r:
                    continue
                try:
                    chunk = os.read(fd, EVENT_SIZE * 64)
                except OSError:
                    self._fds.remove(fd)
                    if not self._fds:
                        return
                    continue
                if not chunk:
                    # EOF (pipe writer closed / device gone).
                    self._fds.remove(fd)
                    if not self._fds:
                        return
                    continue
                data = self._buffers.get(fd, b"") + chunk
                n_full = len(data) // EVENT_SIZE * EVENT_SIZE
                self._buffers[fd] = data[n_full:]
                for off in range(0, n_full, EVENT_SIZE):
                    _s, _u, ev_type, code, value = struct.unpack_from(
                        EVENT_FORMAT, data, off
                    )
                    self._handle(ev_type, code, value)

    def _handle(self, ev_type: int, code: int, value: int) -> None:
        if ev_type != EV_KEY or value == 2:  # ignore autorepeat
            return
        name = KEYCODES.get(code)
        if name is None:
            return
        pressed = value == 1
        if name in MODIFIER_KEYS:
            (self._held_mods.add if pressed else self._held_mods.discard)(name)
        try:
            self._on_key(name, pressed, frozenset(self._held_mods))
        except Exception:
            _log.exception("evdev key handler failed")


class ChordDispatchBackend:
    """The listener-independent half of a global-hotkey backend: hotkey
    bookkeeping, subset chord matching with most-specific-wins, and
    key-capture recording mode. Subclasses provide the OS listener
    (evdev here; CGEventTap in shell/macos_keys.py) and feed key events
    into _on_key — the dispatch semantics are then identical across
    platforms by construction."""

    def __init__(self):
        self._hotkeys: Dict[Tuple[frozenset, str], Tuple[str, Callable]] = {}
        self._active: Dict[Tuple[frozenset, str], bool] = {}
        self._capture_sink: Optional[Callable[[str, bool, List[str]], None]] = None
        self._lock = threading.Lock()
        self._started = False

    # subclass hooks
    def _ensure_started(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def _listener_ready(self) -> bool:
        return True

    # -- ShortcutBackend protocol ---------------------------------------

    def register(self, hotkey: str, callback: Callable[[str, bool], None]) -> bool:
        norm = normalize_hotkey(hotkey)
        if norm is None:
            return False
        if not self._listener_ready():
            return False  # no keyboard to hear -> registry falls back
        with self._lock:
            self._hotkeys[norm] = (hotkey, callback)
            self._active.setdefault(norm, False)
        self._ensure_started()
        return True

    def unregister(self, hotkey: str) -> bool:
        norm = normalize_hotkey(hotkey)
        with self._lock:
            self._active.pop(norm, None)
            return self._hotkeys.pop(norm, (None, None))[0] is not None

    # -- key-capture recording mode -------------------------------------

    def start_capture(self, sink: Callable[[str, bool, List[str]], None]) -> None:
        """sink(key, is_pressed, modifiers) — e.g.
        ShortcutRegistry.feed_captured_key."""
        self._capture_sink = sink
        self._ensure_started()

    def stop_capture(self) -> None:
        self._capture_sink = None

    # -- event dispatch --------------------------------------------------

    def _on_key(self, key: str, pressed: bool, mods: frozenset) -> None:
        sink = self._capture_sink
        if sink is not None:
            sink(key, pressed, sorted(mods))

        with self._lock:
            items = list(self._hotkeys.items())
        if pressed:
            # Subset matching with most-specific-wins: a binding fires
            # when its required modifiers are all held; among bindings
            # sharing the main key only the largest matching modifier
            # set fires (ctrl+shift+space must not also trigger
            # ctrl+space). Subset (not exact) matching is what lets the
            # modifier-less cancel hotkey fire while the push-to-talk
            # chord is still held.
            held = mods - {key}
            candidates = [
                (norm, hk_cb) for norm, hk_cb in items
                if norm[1] == key and norm[0] <= held
            ]
            if candidates:
                best = max(len(norm[0]) for norm, _ in candidates)
                for norm, (hotkey, callback) in candidates:
                    if len(norm[0]) == best and not self._active.get(norm):
                        self._active[norm] = True
                        callback(hotkey, True)
        else:
            for norm, (hotkey, callback) in items:
                req_mods, main_key = norm
                # Any release that breaks an active chord ends it.
                if self._active.get(norm) and (
                    key == main_key or key in req_mods
                ):
                    self._active[norm] = False
                    callback(hotkey, False)


class EvdevBackend(ChordDispatchBackend):
    """ShortcutBackend over EvdevKeyListener (the handy-keys analog).

    register/unregister take the same 'mod+mod+key' strings as the
    registry; key-capture mode streams raw events into a sink (wire to
    ShortcutRegistry.feed_captured_key for FrontendKeyEvent parity)."""

    def __init__(self, fds: Optional[List[int]] = None, own_fds: bool = True):
        super().__init__()
        self.listener = EvdevKeyListener(self._on_key, fds=fds, own_fds=own_fds)

    @classmethod
    def available(cls) -> bool:
        return bool(glob.glob("/dev/input/event*"))

    def _listener_ready(self) -> bool:
        return self.listener.device_count > 0

    def _ensure_started(self) -> None:
        if not self._started:
            self.listener.start()
            self._started = True

    def close(self) -> None:
        self.listener.stop()
        self._started = False
