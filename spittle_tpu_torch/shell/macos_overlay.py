"""macOS recording-overlay: non-activating NSPanel over raw objc_msgSend.

Port of spittle_tpu/shell/macos_overlay.py.

The reference's macOS overlay arm (`src-tauri/src/overlay.rs:23-31`)
configures the pill window as an NSPanel with
NSWindowStyleMaskNonactivatingPanel, NSStatusWindowLevel, and
can-join-all-spaces collection behavior so it floats above every app on
every Space WITHOUT ever taking key focus from the app being dictated
into. This is the same recipe over ctypes:

  NSPanel alloc / initWithContentRect:styleMask:backing:defer:
      styleMask = Borderless | NonactivatingPanel
  setLevel: NSStatusWindowLevel (25)
  setIgnoresMouseEvents: YES          (click-through)
  setCollectionBehavior: CanJoinAllSpaces | Stationary
  orderFrontRegardless / orderOut:    (map / unmap)

Drawing: the pill background is the panel's backgroundColor; the mic
level bars are layer-backed NSView subviews whose layer backgroundColor
updates per frame (no drawRect subclass needed — the display-only pill
repaints explicitly from the overlay controller's mic-level stream,
exactly like the Win32/X11 arms).

The shared event-bus controller (state colors, geometry, bar layout)
is x11_overlay.X11Overlay — this module only provides the platform
backend, so pill behavior is identical across all four arms by
construction. The ObjCRuntime is an injectable seam; tests drive the
real ctypes marshalling against a compiled C fake of libobjc
(tests/test_torch_shell_macos.py).

Coordinates: Cocoa's y axis points UP from the bottom-left; the
controller computes top-down X11-convention coordinates, so the
backend flips both the panel origin and the in-window bar frames.
"""

from __future__ import annotations

from typing import Optional

from spittle_tpu_torch.utils.logging import get_logger

from .macos_cocoa import CGPoint, CGRect, ObjCRuntime, nsrect

_log = get_logger("overlay")

import ctypes as _c

NS_BORDERLESS = 0
NS_NONACTIVATING_PANEL = 1 << 7
NS_BACKING_BUFFERED = 2
NS_STATUS_WINDOW_LEVEL = 25
NS_JOIN_ALL_SPACES = 1 << 0
NS_STATIONARY = 1 << 4


def _rgb(color: int):
    return (((color >> 16) & 0xFF) / 255.0, ((color >> 8) & 0xFF) / 255.0,
            (color & 0xFF) / 255.0)


class MacBackend:
    """Overlay platform backend over the objc runtime (injectable).

    Implements the x11_overlay.XBackend surface: open, screen_size,
    create_window, set_background, map, unmap, move, fill_rect, flush,
    close."""

    def __init__(self, runtime: Optional[ObjCRuntime] = None,
                 screen: tuple = None):
        if runtime is None:
            from .macos_cocoa import default_runtime

            runtime = default_runtime()
            if runtime is None:
                raise OSError("Cocoa runtime unavailable")
        self.rt = runtime
        self.panel = None
        self._screen = screen  # injectable for tests (else NSScreen)
        self._bars: dict = {}  # x -> layer-backed NSView
        self._w = self._h = 0

    # -- backend surface -------------------------------------------------

    def open(self) -> bool:
        return True

    def screen_size(self):
        if self._screen is not None:
            return self._screen
        rt = self.rt  # pragma: no cover (darwin) - struct-return path
        screen = rt.send(rt.cls("NSScreen"), "mainScreen")
        import platform

        fname = ("objc_msgSend_stret"
                 if platform.machine() == "x86_64" else "objc_msgSend")
        fn = _c.cast(
            getattr(rt.lib, fname, rt.lib.objc_msgSend),
            _c.CFUNCTYPE(CGRect, _c.c_void_p, _c.c_void_p),
        )
        frame = fn(screen, rt.sel("frame"))
        return int(frame.size.width), int(frame.size.height)

    def create_window(self, xpos: int, ypos: int, w: int, h: int,
                      color: int) -> None:
        rt = self.rt
        self._w, self._h = w, h
        sw, sh = self.screen_size()
        panel = rt.send(rt.cls("NSPanel"), "alloc")
        self.panel = rt.send(
            panel, "initWithContentRect:styleMask:backing:defer:",
            nsrect(xpos, sh - ypos - h, w, h),
            NS_BORDERLESS | NS_NONACTIVATING_PANEL,
            NS_BACKING_BUFFERED, 0,
            argtypes=[CGRect, _c.c_ulong, _c.c_ulong, _c.c_bool],
        )
        rt.send(self.panel, "setLevel:", NS_STATUS_WINDOW_LEVEL,
                argtypes=[_c.c_long])
        rt.send(self.panel, "setIgnoresMouseEvents:", 1,
                argtypes=[_c.c_bool])
        rt.send(self.panel, "setCollectionBehavior:",
                NS_JOIN_ALL_SPACES | NS_STATIONARY,
                argtypes=[_c.c_ulong])
        rt.send(self.panel, "setHasShadow:", 0, argtypes=[_c.c_bool])
        content = rt.send(self.panel, "contentView")
        rt.send(content, "setWantsLayer:", 1, argtypes=[_c.c_bool])
        self.set_background(color)

    def _nscolor(self, color: int):
        r, g, b = _rgb(color)
        return self.rt.send(
            self.rt.cls("NSColor"),
            "colorWithSRGBRed:green:blue:alpha:", r, g, b, 1.0,
            argtypes=[_c.c_double] * 4,
        )

    def set_background(self, color: int) -> None:
        rt = self.rt
        rt.send(self.panel, "setBackgroundColor:", self._nscolor(color))
        # A state repaint covers the bars (X11 semantics): drop them.
        for view in self._bars.values():
            rt.send(view, "removeFromSuperview")
        self._bars.clear()

    def map(self) -> None:
        # orderFrontRegardless: visible and topmost WITHOUT activating
        # the app (the non-activating panel never steals focus).
        self.rt.send(self.panel, "orderFrontRegardless")

    def unmap(self) -> None:
        self.rt.send(self.panel, "orderOut:", None)

    def move(self, xpos: int, ypos: int) -> None:
        sw, sh = self.screen_size()
        self.rt.send(
            self.panel, "setFrameOrigin:",
            CGPoint(float(xpos), float(sh - ypos - self._h)),
            argtypes=[CGPoint],
        )

    def fill_rect(self, color: int, xpos: int, ypos: int, w: int,
                  h: int) -> None:
        """Mic-level bar: one layer-backed subview per x position,
        reframed + recolored per frame (y flipped to bottom-up)."""
        rt = self.rt
        frame = nsrect(xpos, self._h - ypos - h, w, h)
        view = self._bars.get(xpos)
        if view is None:
            view = rt.send(rt.cls("NSView"), "alloc")
            view = rt.send(view, "initWithFrame:", frame,
                           argtypes=[CGRect])
            rt.send(view, "setWantsLayer:", 1, argtypes=[_c.c_bool])
            content = rt.send(self.panel, "contentView")
            rt.send(content, "addSubview:", view)
            self._bars[xpos] = view
        else:
            rt.send(view, "setFrame:", frame, argtypes=[CGRect])
        layer = rt.send(view, "layer")
        cg = rt.send(self._nscolor(color), "CGColor")
        rt.send(layer, "setBackgroundColor:", cg)

    def flush(self) -> None:
        pass  # Cocoa draws on the main runloop; nothing to flush

    def close(self) -> None:
        if self.panel:
            self.rt.send(self.panel, "close")
            self.panel = None


def attach_macos_overlay(services, backend: Optional[MacBackend] = None):
    """Create the NSPanel pill; None when Cocoa is unavailable (the
    state-only controller still runs)."""
    from spittle_tpu_torch.shell.x11_overlay import X11Overlay

    try:
        overlay = X11Overlay(
            services.events, services.get_settings,
            backend=backend or MacBackend(),
        )
    except Exception as e:  # noqa: BLE001
        _log.info("macos overlay unavailable: %s", e)
        return None
    return overlay if overlay.active else None
