"""Real recording-overlay OS window: X11 via ctypes.

Port of spittle_tpu/shell/x11_overlay.py.

The reference shows a 172x36 always-on-top recording pill
(reference: src-tauri/src/overlay.rs:23-95 — NSPanel on macOS,
gtk-layer-shell/always-on-top webview on Linux; constants
OVERLAY_WIDTH/HEIGHT/TOP_OFFSET/BOTTOM_OFFSET). This module creates an
actual X11 window for it: override-redirect (bypasses the window
manager, so it floats above everything without WM cooperation, the
same net effect as layer-shell's Overlay layer), positioned top/bottom
center per settings.overlay_position, background color per pipeline
state, live mic-level bars drawn with XFillRectangle.

All Xlib traffic runs on one owner thread (Xlib is not thread-safe);
the event-bus callbacks just enqueue commands. The Xlib surface is
behind the `XBackend` seam: the real one loads libX11.so.6 through
ctypes, tests drive the same overlay logic with a recording fake (this
container has no X server).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import queue
from typing import Callable, List, Optional

from spittle_tpu_torch.events import HIDE_OVERLAY, MIC_LEVEL, SHOW_OVERLAY
from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("overlay")

# overlay.rs:33-45
OVERLAY_WIDTH = 172
OVERLAY_HEIGHT = 36
OVERLAY_TOP_OFFSET = 4
OVERLAY_BOTTOM_OFFSET = 40

STATE_COLORS = {
    "recording": 0xE05F5F,     # red pill
    "transcribing": 0xE0A63F,  # amber
    "processing": 0xE0A63F,
}
BAR_COLOR = 0xFFFFFF
N_BARS = 16


class XBackend:
    """ctypes surface over libX11 (injectable for tests)."""

    def __init__(self):
        path = ctypes.util.find_library("X11") or "libX11.so.6"
        self.x = ctypes.CDLL(path)
        self._declare_prototypes()
        self.dpy = None
        self.win = None
        self.gc = None

    def _declare_prototypes(self) -> None:
        # Every libX11 call needs explicit argtypes/restype: Display*
        # and GC are 64-bit pointers that ctypes would otherwise mask
        # to 32-bit C ints (default restype is c_int), which segfaults
        # on any real X server.
        Disp = ctypes.c_void_p          # Display*
        GC = ctypes.c_void_p            # GC (opaque pointer)
        XID = ctypes.c_ulong            # Window / Drawable
        c_int, c_uint, c_ulong = ctypes.c_int, ctypes.c_uint, ctypes.c_ulong
        proto = {
            "XOpenDisplay": (Disp, [ctypes.c_char_p]),
            "XDefaultScreen": (c_int, [Disp]),
            "XDisplayWidth": (c_int, [Disp, c_int]),
            "XDisplayHeight": (c_int, [Disp, c_int]),
            "XRootWindow": (XID, [Disp, c_int]),
            "XCreateSimpleWindow": (XID, [Disp, XID, c_int, c_int, c_uint,
                                          c_uint, c_uint, c_ulong, c_ulong]),
            "XChangeWindowAttributes": (c_int, [Disp, XID, c_ulong,
                                                ctypes.c_void_p]),
            "XCreateGC": (GC, [Disp, XID, c_ulong, ctypes.c_void_p]),
            "XSetWindowBackground": (c_int, [Disp, XID, c_ulong]),
            "XClearWindow": (c_int, [Disp, XID]),
            "XMapRaised": (c_int, [Disp, XID]),
            "XUnmapWindow": (c_int, [Disp, XID]),
            "XMoveWindow": (c_int, [Disp, XID, c_int, c_int]),
            "XSetForeground": (c_int, [Disp, GC, c_ulong]),
            "XFillRectangle": (c_int, [Disp, XID, GC, c_int, c_int,
                                       c_uint, c_uint]),
            "XFlush": (c_int, [Disp]),
            "XCloseDisplay": (c_int, [Disp]),
        }
        for name, (restype, argtypes) in proto.items():
            fn = getattr(self.x, name)
            fn.restype = restype
            fn.argtypes = argtypes

    def open(self) -> bool:
        self.dpy = self.x.XOpenDisplay(None)
        return bool(self.dpy)

    def screen_size(self):
        scr = self.x.XDefaultScreen(self.dpy)
        return (self.x.XDisplayWidth(self.dpy, scr),
                self.x.XDisplayHeight(self.dpy, scr))

    def create_window(self, xpos: int, ypos: int, w: int, h: int,
                      color: int) -> None:
        scr = self.x.XDefaultScreen(self.dpy)
        root = self.x.XRootWindow(self.dpy, scr)
        self.win = self.x.XCreateSimpleWindow(
            self.dpy, root, xpos, ypos, w, h, 0, 0, color
        )

        # override_redirect: the WM never manages/decorate/lowers it.
        class XSetWindowAttributes(ctypes.Structure):
            _fields_ = [("background_pixmap", ctypes.c_ulong),
                        ("background_pixel", ctypes.c_ulong),
                        ("border_pixmap", ctypes.c_ulong),
                        ("border_pixel", ctypes.c_ulong),
                        ("bit_gravity", ctypes.c_int),
                        ("win_gravity", ctypes.c_int),
                        ("backing_store", ctypes.c_int),
                        ("backing_planes", ctypes.c_ulong),
                        ("backing_pixel", ctypes.c_ulong),
                        ("save_under", ctypes.c_int),
                        ("event_mask", ctypes.c_long),
                        ("do_not_propagate_mask", ctypes.c_long),
                        ("override_redirect", ctypes.c_int),
                        ("colormap", ctypes.c_ulong),
                        ("cursor", ctypes.c_ulong)]

        attrs = XSetWindowAttributes()
        attrs.override_redirect = 1
        CW_OVERRIDE_REDIRECT = 1 << 9
        self.x.XChangeWindowAttributes(
            self.dpy, self.win, CW_OVERRIDE_REDIRECT, ctypes.byref(attrs)
        )
        self.gc = self.x.XCreateGC(self.dpy, self.win, 0, None)

    def set_background(self, color: int) -> None:
        self.x.XSetWindowBackground(self.dpy, self.win, color)
        self.x.XClearWindow(self.dpy, self.win)

    def map(self) -> None:
        self.x.XMapRaised(self.dpy, self.win)
        self.x.XFlush(self.dpy)

    def unmap(self) -> None:
        self.x.XUnmapWindow(self.dpy, self.win)
        self.x.XFlush(self.dpy)

    def move(self, xpos: int, ypos: int) -> None:
        self.x.XMoveWindow(self.dpy, self.win, xpos, ypos)

    def fill_rect(self, color: int, xpos: int, ypos: int, w: int,
                  h: int) -> None:
        self.x.XSetForeground(self.dpy, self.gc, color)
        self.x.XFillRectangle(self.dpy, self.win, self.gc, xpos, ypos, w, h)

    def flush(self) -> None:
        self.x.XFlush(self.dpy)

    def close(self) -> None:
        if self.dpy:
            self.x.XCloseDisplay(self.dpy)
            self.dpy = None


class X11Overlay:
    """Event-bus-driven overlay window (OverlayController's OS half)."""

    def __init__(self, events, settings_provider: Callable,
                 backend: Optional[XBackend] = None):
        self.events = events
        self._settings = settings_provider
        self.backend = backend or XBackend()
        self._q: "queue.Queue" = queue.Queue()
        self.active = False
        self.visible = False
        self.state = "recording"
        self._unsubs = []
        if not self.backend.open():
            _log.info("no X display; overlay window disabled")
            return
        self.active = True
        self._thread = threads.spawn(self._run, name="x11-overlay")
        self._unsubs = [
            events.listen(SHOW_OVERLAY, lambda p: self._q.put(("show", p))),
            events.listen(HIDE_OVERLAY, lambda p: self._q.put(("hide", p))),
            events.listen(MIC_LEVEL, lambda p: self._q.put(("level", p))),
        ]

    def _position(self, sw: int, sh: int):
        pos = self._settings().overlay_position.value
        xpos = (sw - OVERLAY_WIDTH) // 2
        if pos == "top":
            return xpos, OVERLAY_TOP_OFFSET
        return xpos, sh - OVERLAY_HEIGHT - OVERLAY_BOTTOM_OFFSET

    def _run(self) -> None:
        b = self.backend
        sw, sh = b.screen_size()
        xpos, ypos = self._position(sw, sh)
        b.create_window(xpos, ypos, OVERLAY_WIDTH, OVERLAY_HEIGHT,
                        STATE_COLORS["recording"])
        while True:
            item = self._q.get()
            if item is None:
                b.close()
                return
            kind, payload = item
            try:
                if kind == "show":
                    if self._settings().overlay_position.value == "none":
                        continue
                    # Reference payload is the bare state string
                    # (overlay.rs:307); tolerate the dict form too.
                    if isinstance(payload, str) and payload:
                        self.state = payload
                    elif isinstance(payload, dict):
                        self.state = payload.get("state", "recording")
                    else:
                        self.state = "recording"
                    b.move(*self._position(*b.screen_size()))
                    b.set_background(
                        STATE_COLORS.get(self.state,
                                         STATE_COLORS["recording"])
                    )
                    b.map()
                    self.visible = True
                elif kind == "hide":
                    b.unmap()
                    self.visible = False
                elif kind == "level" and self.visible:
                    self._draw_bars(payload)
            except Exception:
                _log.exception("overlay %s failed", kind)

    def _draw_bars(self, levels: List[float]) -> None:
        b = self.backend
        levels = list(levels or [])[:N_BARS]
        slot = OVERLAY_WIDTH // N_BARS
        bg = STATE_COLORS.get(self.state, STATE_COLORS["recording"])
        for i in range(N_BARS):
            level = levels[i] if i < len(levels) else 0.0
            h = max(2, int(level * (OVERLAY_HEIGHT - 8)))
            x0 = i * slot + 2
            # clear the slot then draw the bar bottom-aligned
            b.fill_rect(bg, x0, 4, slot - 4, OVERLAY_HEIGHT - 8)
            b.fill_rect(BAR_COLOR, x0, OVERLAY_HEIGHT - 4 - h, slot - 4, h)
        b.flush()

    def close(self) -> None:
        for un in self._unsubs:
            un()
        if self.active:
            self._q.put(None)
            self.active = False


def attach_overlay(services, backend: Optional[XBackend] = None):
    """Create the overlay window when an X display is reachable; None
    otherwise (Wayland-only/headless keeps the state-only controller)."""
    if backend is None and not os.environ.get("DISPLAY"):
        return None
    try:
        overlay = X11Overlay(
            services.events, services.get_settings, backend=backend
        )
    except Exception as e:  # noqa: BLE001
        _log.info("overlay unavailable: %s", e)
        return None
    return overlay if overlay.active else None
