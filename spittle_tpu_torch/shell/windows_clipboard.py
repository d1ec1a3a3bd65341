"""Windows clipboard: CF_UNICODETEXT over raw user32/kernel32.

Port of spittle_tpu/shell/windows_clipboard.py.

The reference's clipboard handling is arboard, which on Windows is
OpenClipboard -> EmptyClipboard -> SetClipboardData(CF_UNICODETEXT)
with a GMEM_MOVEABLE global allocation (clipboard.rs uses it for the
save-clipboard -> write -> paste-keystroke -> restore dance,
src-tauri/src/clipboard.rs:567-633). This is that sequence spoken
directly through ctypes, with the two DLLs as injectable seams so the
allocation/lock/copy discipline is loopback-testable off-Windows: a
fake kernel32 hands out real ctypes buffers, so memmove/wstring_at in
this module run against genuine memory.

Failure is silent-False throughout, matching the best-effort clipboard
semantics of the reference (a failed restore never raises into the
paste path).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("win_clipboard")

CF_UNICODETEXT = 13
GMEM_MOVEABLE = 0x0002


def _bind():  # pragma: no cover (win32)
    if sys.platform != "win32":
        return None, None
    return ctypes.windll.user32, ctypes.windll.kernel32


def clipboard_write(text: str, user32=None, kernel32=None) -> bool:
    """OpenClipboard -> Empty -> SetClipboardData(CF_UNICODETEXT).

    Ownership note: after a successful SetClipboardData the system owns
    the global handle — it must NOT be freed by us; on failure we leak
    rather than double-free (the reference's arboard does the same).
    """
    if user32 is None or kernel32 is None:
        user32, kernel32 = _bind()
        if user32 is None:
            return False
    try:
        raw = text.encode("utf-16-le") + b"\x00\x00"
        if not user32.OpenClipboard(None):
            return False
        try:
            user32.EmptyClipboard()
            handle = kernel32.GlobalAlloc(GMEM_MOVEABLE, len(raw))
            if not handle:
                return False
            ptr = kernel32.GlobalLock(handle)
            if not ptr:
                return False
            ctypes.memmove(ptr, raw, len(raw))
            kernel32.GlobalUnlock(handle)
            return bool(user32.SetClipboardData(CF_UNICODETEXT, handle))
        finally:
            user32.CloseClipboard()
    except Exception as e:  # noqa: BLE001 — best-effort, like arboard use
        _log.debug("clipboard_write failed: %s", e)
        return False


def clipboard_read(user32=None, kernel32=None) -> Optional[str]:
    if user32 is None or kernel32 is None:
        user32, kernel32 = _bind()
        if user32 is None:
            return None
    try:
        if not user32.OpenClipboard(None):
            return None
        try:
            handle = user32.GetClipboardData(CF_UNICODETEXT)
            if not handle:
                return None
            ptr = kernel32.GlobalLock(handle)
            if not ptr:
                return None
            try:
                # Bounded read via GlobalSize + explicit utf-16-le decode
                # (not wstring_at: wchar_t is 4 bytes off-Windows, which
                # would break the loopback tests that exercise this exact
                # copy discipline against real memory).
                size = kernel32.GlobalSize(handle)
                raw = ctypes.string_at(ptr, size)
                return raw.decode("utf-16-le", errors="replace").split(
                    "\x00", 1
                )[0]
            finally:
                kernel32.GlobalUnlock(handle)
        finally:
            user32.CloseClipboard()
    except Exception as e:  # noqa: BLE001
        _log.debug("clipboard_read failed: %s", e)
        return None
