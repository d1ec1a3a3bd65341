"""macOS menu-bar tray: NSStatusItem over raw objc_msgSend.

Port of spittle_tpu/shell/macos_tray.py.

The reference tray runs on macOS through tauri's NSStatusItem wrapper
(`src-tauri/src/tray.rs:14-18` builds the same icon+menu tray on all
three platforms). This is that arm over ctypes:

  NSStatusBar systemStatusBar -> statusItemWithLength: -1 (variable)
  item.button setTitle: <state glyph>    (template text, no PNG assets)
  NSMenu of NSMenuItem initWithTitle:action:keyEquivalent:, each
  targeted at a runtime-registered SpittleTrayTarget object whose
  `menuAction:` IMP is a ctypes callback -> the shared tray-menu
  dispatch (tray_sni.tray_menu_handler — identical behavior to the
  Linux SNI arm by construction).

The action target is a REAL objc class registered at runtime
(objc_allocateClassPair + class_addMethod with a CFUNCTYPE IMP,
signature "v@:@") — the same depth of FFI realism as the Windows COM
vtable fakes. The runtime is injectable; tests drive the message
sequence against the compiled C fake of libobjc.
"""

from __future__ import annotations

import ctypes as _c
from typing import Callable, List, Optional, Tuple

from spittle_tpu_torch.app.ui_state import TrayIconState
from spittle_tpu_torch.utils.logging import get_logger

from .macos_cocoa import ObjCRuntime

_log = get_logger("tray")

# State -> menu-bar glyph (text titles render without asset bundles;
# the reference ships PNGs, tray.rs:47-60).
STATE_TITLES = {
    TrayIconState.IDLE: "\U0001f399",          # studio microphone
    TrayIconState.RECORDING: "\U0001f534",     # red circle
    TrayIconState.TRANSCRIBING: "…",      # ellipsis
}

_IMP_TYPE = _c.CFUNCTYPE(None, _c.c_void_p, _c.c_void_p, _c.c_void_p)


class MacTray:
    """A live NSStatusItem: glyph + localized menu + menu actions."""

    def __init__(
        self,
        menu_items: List[Tuple[str, str]],
        on_activate: Optional[Callable[[], None]] = None,
        on_menu: Optional[Callable[[str], None]] = None,
        runtime: Optional[ObjCRuntime] = None,
    ):
        if runtime is None:
            from .macos_cocoa import default_runtime

            runtime = default_runtime()
            if runtime is None:
                raise OSError("Cocoa runtime unavailable")
        self.rt = runtime
        self.on_menu = on_menu
        self.on_activate = on_activate  # menu opens on click on macOS
        self.state = TrayIconState.IDLE
        self._ids = [mid for mid, _ in menu_items]

        rt = self.rt
        lib = rt.lib
        # Runtime-registered action target class. The IMP must outlive
        # the tray (self._imp keeps the ctypes thunk alive).
        lib.objc_allocateClassPair.restype = _c.c_void_p
        lib.objc_allocateClassPair.argtypes = [
            _c.c_void_p, _c.c_char_p, _c.c_size_t,
        ]
        lib.class_addMethod.restype = _c.c_bool
        lib.class_addMethod.argtypes = [
            _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_char_p,
        ]
        lib.objc_registerClassPair.restype = None
        lib.objc_registerClassPair.argtypes = [_c.c_void_p]

        self._imp = _IMP_TYPE(self._menu_action)
        cls = lib.objc_allocateClassPair(
            rt.cls("NSObject"), b"SpittleTrayTarget", 0
        )
        if cls:  # an existing registration (prior tray) reuses the class
            lib.class_addMethod(
                cls, rt.sel("menuAction:"),
                _c.cast(self._imp, _c.c_void_p), b"v@:@",
            )
            lib.objc_registerClassPair(cls)
        self.target = rt.send(
            rt.send(rt.cls("SpittleTrayTarget"), "alloc"), "init"
        )

        bar = rt.send(rt.cls("NSStatusBar"), "systemStatusBar")
        self.item = rt.send(
            bar, "statusItemWithLength:", -1.0, argtypes=[_c.c_double]
        )
        self._set_title(STATE_TITLES[self.state])

        menu = rt.send(rt.send(rt.cls("NSMenu"), "alloc"), "init")
        for i, (mid, label) in enumerate(menu_items):
            mi = rt.send(rt.cls("NSMenuItem"), "alloc")
            mi = rt.send(
                mi, "initWithTitle:action:keyEquivalent:",
                self._nsstr(label), rt.sel("menuAction:"),
                self._nsstr(""),
            )
            rt.send(mi, "setTarget:", self.target)
            rt.send(mi, "setTag:", i, argtypes=[_c.c_long])
            rt.send(menu, "addItem:", mi)
        self.menu = menu
        rt.send(self.item, "setMenu:", menu)

    def _nsstr(self, s: str):
        return self.rt.send(
            self.rt.cls("NSString"), "stringWithUTF8String:",
            s.encode("utf-8"), argtypes=[_c.c_char_p],
        )

    def _set_title(self, title: str) -> None:
        button = self.rt.send(self.item, "button")
        self.rt.send(button, "setTitle:", self._nsstr(title))

    def _menu_action(self, _self, _sel, sender) -> None:
        tag = self.rt.send(sender, "tag", restype=_c.c_long)
        if self.on_menu is not None and 0 <= tag < len(self._ids):
            try:
                self.on_menu(self._ids[tag])
            except Exception:  # noqa: BLE001 - menu handler must not throw
                _log.exception("tray menu action %s failed", tag)

    def set_state(self, state: TrayIconState) -> None:
        self.state = state
        self._set_title(STATE_TITLES[state])

    def close(self) -> None:
        bar = self.rt.send(self.rt.cls("NSStatusBar"), "systemStatusBar")
        self.rt.send(bar, "removeStatusItem:", self.item)


def attach_macos_tray(services, actions, ui, commands=None,
                      runtime: Optional[ObjCRuntime] = None):
    """Wire a MacTray to the app graph (same contract as
    tray_sni.attach_tray). Returns the tray or None when Cocoa is
    unavailable."""
    from .tray_sni import tray_activate_handler, tray_menu_handler

    try:
        tray = MacTray(
            ui.tray.menu_items(),
            on_activate=tray_activate_handler(actions),
            on_menu=tray_menu_handler(services, actions, ui, commands),
            runtime=runtime,
        )
    except Exception as e:  # noqa: BLE001 - headless fallback
        _log.info("macos tray unavailable: %s", e)
        return None
    services.events.listen(
        "tray-state-changed",
        lambda v: tray.set_state(TrayIconState(v)),
    )
    return tray
