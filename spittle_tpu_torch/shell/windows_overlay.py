"""Windows recording-overlay window: topmost popup over raw user32/gdi32.

Port of spittle_tpu/shell/windows_overlay.py.

The reference's Windows overlay arm is the plainest of the three: a
decoration-less, always-on-top, skip-taskbar, non-focusable webview
(src-tauri/src/overlay.rs — the `#[cfg(target_os = "windows")]` build
of `create_recording_overlay`; same 172x36 pill and top/bottom offsets
as Linux, overlay.rs:33-45). The Win32 equivalent of that window
recipe is:

  ex-style  WS_EX_TOPMOST  | always above normal windows
            WS_EX_TOOLWINDOW | no taskbar button
            WS_EX_NOACTIVATE | never steals focus (the pill must not
                               defocus the app being dictated into)
  style     WS_POPUP         | no frame/titlebar

The window uses the system "STATIC" window class so no WNDCLASS
registration or message pump is needed — the pill is display-only and
repainted explicitly by the overlay controller's mic-level stream.

This module provides only the platform backend; the event-bus
controller (state colors, positioning, bar drawing) is shared with the
X11/Wayland paths — the same class drives all three, which keeps the
pill's behavior identical across platforms by construction. user32 and
gdi32 are injectable seams (the macos_ax/x11 test pattern): tests
drive the exact call sequences with recording fakes.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("overlay")

WS_POPUP = 0x80000000
WS_EX_TOPMOST = 0x00000008
WS_EX_TOOLWINDOW = 0x00000080
WS_EX_NOACTIVATE = 0x08000000

SW_HIDE = 0
SW_SHOWNOACTIVATE = 4

SWP_NOSIZE = 0x0001
SWP_NOMOVE = 0x0002
SWP_NOZORDER = 0x0004
SWP_NOACTIVATE = 0x0010
HWND_TOPMOST = -1

SM_CXSCREEN = 0
SM_CYSCREEN = 1


class RECT(ctypes.Structure):
    _fields_ = [
        ("left", ctypes.c_long),
        ("top", ctypes.c_long),
        ("right", ctypes.c_long),
        ("bottom", ctypes.c_long),
    ]


def rgb_to_colorref(color: int) -> int:
    """Overlay colors are 0xRRGGBB (the x11 convention shared by the
    controller); Win32 COLORREF is 0x00BBGGRR."""
    r = (color >> 16) & 0xFF
    g = (color >> 8) & 0xFF
    b = color & 0xFF
    return (b << 16) | (g << 8) | r


class WinBackend:
    """Overlay platform backend over user32/gdi32 (injectable seams).

    Implements the same surface as x11_overlay.XBackend so the shared
    overlay controller drives it unchanged: open, screen_size,
    create_window, set_background, map, unmap, move, fill_rect, flush,
    close.
    """

    def __init__(self, user32=None, gdi32=None):
        if user32 is None or gdi32 is None:
            if sys.platform != "win32":
                raise OSError("Win32 overlay requires Windows")
            user32 = ctypes.windll.user32  # pragma: no cover (win32)
            gdi32 = ctypes.windll.gdi32  # pragma: no cover (win32)
        self.user32 = user32
        self.gdi32 = gdi32
        self.hwnd = None
        self._bg = 0

    def open(self) -> bool:
        return True

    def screen_size(self):
        return (
            self.user32.GetSystemMetrics(SM_CXSCREEN),
            self.user32.GetSystemMetrics(SM_CYSCREEN),
        )

    def create_window(self, xpos: int, ypos: int, w: int, h: int,
                      color: int) -> None:
        self._bg = color
        self.hwnd = self.user32.CreateWindowExW(
            WS_EX_TOPMOST | WS_EX_TOOLWINDOW | WS_EX_NOACTIVATE,
            "STATIC", "spittle-overlay", WS_POPUP,
            # hWndParent 0, not None: on Windows the tray shares this
            # user32 and declares hWndParent an integer (HWND_MESSAGE),
            # which takes no None (the JAX package passes None there).
            xpos, ypos, w, h, 0, None, None, None,
        )
        self._w, self._h = w, h

    def _paint(self, color: int, xpos: int, ypos: int, w: int,
               h: int) -> None:
        hdc = self.user32.GetDC(self.hwnd)
        if not hdc:
            return
        try:
            brush = self.gdi32.CreateSolidBrush(rgb_to_colorref(color))
            rect = RECT(xpos, ypos, xpos + w, ypos + h)
            self.user32.FillRect(hdc, ctypes.byref(rect), brush)
            self.gdi32.DeleteObject(brush)
        finally:
            self.user32.ReleaseDC(self.hwnd, hdc)

    def set_background(self, color: int) -> None:
        self._bg = color
        self._paint(color, 0, 0, self._w, self._h)

    def map(self) -> None:
        # SW_SHOWNOACTIVATE + SWP_NOACTIVATE: visible, topmost, and the
        # focused app keeps focus (the whole point of the pill).
        self.user32.ShowWindow(self.hwnd, SW_SHOWNOACTIVATE)
        self.user32.SetWindowPos(
            self.hwnd, HWND_TOPMOST, 0, 0, 0, 0,
            SWP_NOSIZE | SWP_NOMOVE | SWP_NOACTIVATE,
        )
        self._paint(self._bg, 0, 0, self._w, self._h)

    def unmap(self) -> None:
        self.user32.ShowWindow(self.hwnd, SW_HIDE)

    def move(self, xpos: int, ypos: int) -> None:
        self.user32.SetWindowPos(
            self.hwnd, 0, xpos, ypos, 0, 0,
            SWP_NOSIZE | SWP_NOZORDER | SWP_NOACTIVATE,
        )

    def fill_rect(self, color: int, xpos: int, ypos: int, w: int,
                  h: int) -> None:
        self._paint(color, xpos, ypos, w, h)

    def flush(self) -> None:
        self.gdi32.GdiFlush()

    def close(self) -> None:
        if self.hwnd:
            self.user32.DestroyWindow(self.hwnd)
            self.hwnd = None


def attach_windows_overlay(services, backend: Optional[WinBackend] = None):
    """Create the Win32 pill; None when unavailable (non-Windows or any
    user32 failure — the state-only controller still runs)."""
    # The controller is platform-neutral despite its module's name: it
    # speaks only the backend seam.
    from spittle_tpu_torch.shell.x11_overlay import X11Overlay

    try:
        overlay = X11Overlay(
            services.events, services.get_settings,
            backend=backend or WinBackend(),
        )
    except Exception as e:  # noqa: BLE001
        _log.info("windows overlay unavailable: %s", e)
        return None
    return overlay if overlay.active else None
