"""Windows keystroke injection: ctypes SendInput (input.rs Windows arm).

Port of spittle_tpu/shell/windows_input.py.

The reference's Windows input path is enigo over SendInput with
layout-independent virtual-key codes — Ctrl+VK_V (0x56) works on
Russian/AZERTY/DVORAK layouts where a character lookup would not
(src-tauri/src/input.rs:28-52), with a 100 ms hold between the V click
and the modifier release (:47). Arrow-key movement for diff apply is
batched into one call (input.rs:120-150).

This module is the UinputKeyboard analog for win32: same surface
(`available`, `type_text`, `type_prefix`, `key(name, mods, count)`,
`close`) so SystemTextOutput._kb() can plug it in unchanged. Text is
typed as KEYEVENTF_UNICODE scan events (layout-independent, full
UTF-16 incl. surrogate pairs) rather than per-layout VK lookups.

Everything dispatches through an injectable `user32` seam so the
struct packing and event sequences are loopback-testable off-Windows
(the same pattern as shell/macos_ax.py's injectable backend).
"""

from __future__ import annotations

import ctypes
import sys
import time
from typing import List, Optional

from spittle_tpu_torch.shell.uinput import MOD_ALT, MOD_CTRL, MOD_META, MOD_SHIFT

INPUT_KEYBOARD = 1
KEYEVENTF_KEYUP = 0x0002
KEYEVENTF_UNICODE = 0x0004

VK_SHIFT, VK_CONTROL, VK_MENU, VK_LWIN = 0x10, 0x11, 0x12, 0x5B

# Layout-independent virtual keys for every name _parse_key can emit
# (textout.py) plus letters/digits (VK 'A'..'Z'/'0'..'9' match ASCII).
_VK_NAMES = {
    "left": 0x25, "up": 0x26, "right": 0x27, "down": 0x28,
    "backspace": 0x08, "enter": 0x0D, "tab": 0x09, "escape": 0x1B,
    "insert": 0x2D, "delete": 0x2E, "home": 0x24, "end": 0x23,
    "space": 0x20, "pageup": 0x21, "pagedown": 0x22,
    # Function keys (VK_F1..VK_F12 — hotkey chords use them).
    **{f"f{i}": 0x6F + i for i in range(1, 13)},
}

_MOD_VKS = (
    (MOD_CTRL, VK_CONTROL),
    (MOD_SHIFT, VK_SHIFT),
    (MOD_ALT, VK_MENU),
    (MOD_META, VK_LWIN),
)


class KEYBDINPUT(ctypes.Structure):
    _fields_ = [
        ("wVk", ctypes.c_ushort),
        ("wScan", ctypes.c_ushort),
        ("dwFlags", ctypes.c_uint),
        ("time", ctypes.c_uint),
        ("dwExtraInfo", ctypes.c_size_t),
    ]


class _INPUT_UNION(ctypes.Union):
    # MOUSEINPUT (the largest arm, 8+4*4+ptr) sized via padding so the
    # union matches the Win64 ABI without declaring the unused arms.
    _fields_ = [
        ("ki", KEYBDINPUT),
        ("_pad", ctypes.c_byte * 32),
    ]


class INPUT(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint),
        ("u", _INPUT_UNION),
    ]


def _key_event(vk: int, scan: int = 0, flags: int = 0) -> INPUT:
    inp = INPUT()
    inp.type = INPUT_KEYBOARD
    inp.u.ki = KEYBDINPUT(vk, scan, flags, 0, 0)
    return inp


def vk_for_name(name: str) -> Optional[int]:
    if name in _VK_NAMES:
        return _VK_NAMES[name]
    if len(name) == 1:
        ch = name.upper()
        if "A" <= ch <= "Z" or "0" <= ch <= "9":
            return ord(ch)
    return None


def unicode_events(text: str) -> List[INPUT]:
    """Down+up KEYEVENTF_UNICODE pair per UTF-16 code unit (surrogate
    halves ship as separate events, which is the documented contract)."""
    events: List[INPUT] = []
    raw = text.encode("utf-16-le")
    units = [
        int.from_bytes(raw[i : i + 2], "little")
        for i in range(0, len(raw), 2)
    ]
    for u in units:
        events.append(_key_event(0, u, KEYEVENTF_UNICODE))
        events.append(_key_event(0, u, KEYEVENTF_UNICODE | KEYEVENTF_KEYUP))
    return events


class SendInputKeyboard:
    """UinputKeyboard-shaped keystroke injector over user32.SendInput.

    `user32`: injectable seam exposing SendInput(nInputs, pInputs,
    cbSize) -> int; None binds the real ctypes.windll.user32 (win32
    only).
    """

    # input.rs:47 holds the combo 100 ms between the key click and the
    # modifier release so slow applications see the chord.
    COMBO_HOLD_S = 0.10

    def __init__(self, user32=None, sleep=time.sleep):
        if user32 is None:
            if sys.platform != "win32":
                raise OSError("SendInput requires Windows")
            user32 = ctypes.windll.user32  # pragma: no cover (win32)
        self._user32 = user32
        self._sleep = sleep

    @staticmethod
    def available() -> bool:
        return sys.platform == "win32"

    def _send(self, events: List[INPUT]) -> bool:
        if not events:
            return True
        arr = (INPUT * len(events))(*events)
        sent = self._user32.SendInput(
            len(events), arr, ctypes.sizeof(INPUT)
        )
        return sent == len(events)

    def type_text(self, text: str) -> bool:
        return self.type_prefix(text) == len(text)

    def type_prefix(self, text: str) -> int:
        """Unicode events cover every char, so all-or-nothing: len(text)
        on success, 0 on an injection failure (caller falls back to the
        clipboard path for the whole string)."""
        if not text:
            return 0
        return len(text) if self._send(unicode_events(text)) else 0

    def key(self, name: str, mods: int = 0, count: int = 1) -> bool:
        vk = vk_for_name(name)
        if vk is None:
            return False
        mod_vks = [m_vk for bit, m_vk in _MOD_VKS if mods & bit]
        events = [_key_event(m) for m in mod_vks]
        for _ in range(count):
            # Batched like input.rs:120-150: N arrow presses ship as one
            # SendInput array instead of N round trips.
            events.append(_key_event(vk))
            events.append(_key_event(vk, flags=KEYEVENTF_KEYUP))
        if not self._send(events):
            return False
        if mod_vks:
            self._sleep(self.COMBO_HOLD_S)
            return self._send(
                [_key_event(m, flags=KEYEVENTF_KEYUP)
                 for m in reversed(mod_vks)]
            )
        return True

    def close(self) -> None:  # surface parity with UinputKeyboard
        pass
