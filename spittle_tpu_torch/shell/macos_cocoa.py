"""Objective-C runtime bridge over ctypes (libobjc.A.dylib).

Port of spittle_tpu/shell/macos_cocoa.py.

The macOS shell surfaces (NSPanel overlay, NSStatusItem tray) speak to
Cocoa through `objc_msgSend` — the same raw-FFI approach the Windows
arm takes with COM vtables (shell/windows_audio.vtbl_call) and the
reference takes through its objc2 crates (`src-tauri/src/overlay.rs`,
`tray.rs`). The runtime library is an injectable seam: tests drive the
exact message sequences against an in-process fake that records
selector names and arguments, so argtypes bugs surface as real crashes
in the test process (as the Windows arm's tests do with COM vtables in
real memory).

Calling conventions: every message goes through a freshly-cast function
pointer with explicit restype/argtypes (objc_msgSend is variadic only
in name — calling it uncast truncates pointers on arm64/x86_64 alike).
Struct arguments (NSRect/NSPoint/NSSize) pass by value via ctypes
Structures; struct RETURNS would need objc_msgSend_stret on x86_64 but
none of our messages return structs.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
from typing import Any, Optional

_c = ctypes


class CGPoint(ctypes.Structure):
    _fields_ = [("x", _c.c_double), ("y", _c.c_double)]


class CGSize(ctypes.Structure):
    _fields_ = [("width", _c.c_double), ("height", _c.c_double)]


class CGRect(ctypes.Structure):
    _fields_ = [("origin", CGPoint), ("size", CGSize)]


def nsrect(x: float, y: float, w: float, h: float) -> CGRect:
    return CGRect(CGPoint(x, y), CGSize(w, h))


class ObjCRuntime:
    """Minimal objc runtime: classes, selectors, typed msgSend.

    lib: the objc library (injectable; default loads libobjc + AppKit
    so the Cocoa classes exist in-process)."""

    def __init__(self, lib=None):
        if lib is None:
            if sys.platform != "darwin":
                raise OSError("Cocoa requires macOS")
            lib = _c.CDLL(  # pragma: no cover (darwin)
                ctypes.util.find_library("objc"), mode=_c.RTLD_GLOBAL
            )
            # Load AppKit so NSPanel/NSStatusBar/NSColor resolve.
            _c.CDLL(  # pragma: no cover (darwin)
                "/System/Library/Frameworks/AppKit.framework/AppKit",
                mode=_c.RTLD_GLOBAL,
            )
        self.lib = lib
        lib.objc_getClass.restype = _c.c_void_p
        lib.objc_getClass.argtypes = [_c.c_char_p]
        lib.sel_registerName.restype = _c.c_void_p
        lib.sel_registerName.argtypes = [_c.c_char_p]
        self._sels: dict = {}

    def cls(self, name: str) -> int:
        c = self.lib.objc_getClass(name.encode())
        if not c:
            raise OSError(f"objc class not found: {name}")
        return c

    def sel(self, name: str) -> int:
        s = self._sels.get(name)
        if s is None:
            s = self.lib.sel_registerName(name.encode())
            self._sels[name] = s
        return s

    def send(self, receiver, selname: str, *args,
             restype=_c.c_void_p, argtypes: Optional[list] = None) -> Any:
        """objc_msgSend through a correctly-typed function pointer."""
        if argtypes is None:
            argtypes = []
            for a in args:
                if isinstance(a, CGRect):
                    argtypes.append(CGRect)
                elif isinstance(a, float):
                    argtypes.append(_c.c_double)
                elif isinstance(a, bytes):
                    argtypes.append(_c.c_char_p)
                else:
                    argtypes.append(_c.c_void_p)
        fn = _c.cast(
            self.lib.objc_msgSend,
            _c.CFUNCTYPE(restype, _c.c_void_p, _c.c_void_p, *argtypes),
        )
        return fn(receiver, self.sel(selname), *args)


def default_runtime() -> Optional[ObjCRuntime]:
    if sys.platform != "darwin":
        return None
    try:  # pragma: no cover (darwin)
        return ObjCRuntime()
    except OSError:  # pragma: no cover (darwin)
        return None
