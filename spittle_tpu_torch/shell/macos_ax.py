"""macOS Accessibility selection-replace fast path.

Port of spittle_tpu/shell/macos_ax.py, itself a port of
`src-tauri/src/macos_ax.rs`: before applying a
text diff, select the to-be-replaced range in the focused text element via
the AX API so one "type" replaces it — instead of ArrowLeft x suffix +
Backspace x delete keystrokes (`clipboard.rs:690-790`).

The FFI is an injectable boundary: `AXSelectionBackend` is any object with
`range_settable()`, `selected_range()`, `set_selected_range(loc, length)`.
On macOS the default backend binds ApplicationServices through ctypes;
everywhere else the backend is None and callers fall back to the keyboard
path. The range arithmetic is pure and tested off-macOS.
"""

from __future__ import annotations

import sys
from typing import Optional, Protocol, Tuple


class AXError(RuntimeError):
    """AX unavailable / not settable / cursor too close to the start."""


def compute_replace_range(
    cursor_location: int, delete_chars: int, suffix_chars: int
) -> Tuple[int, int]:
    """Selection covering the delete region that sits `suffix_chars` before
    the cursor: [cursor - delete - suffix, delete] (macos_ax.rs:144-157).

    Raises AXError when the cursor is before the replace boundary."""
    delta = delete_chars + suffix_chars
    if cursor_location < delta:
        raise AXError(
            f"cursor location {cursor_location} is before required replace "
            f"boundary {delta}"
        )
    return cursor_location - delta, delete_chars


class AXSelectionBackend(Protocol):
    def range_settable(self) -> bool: ...

    def selected_range(self) -> Tuple[int, int]:
        """(location, length) of AXSelectedTextRange."""
        ...

    def set_selected_range(self, location: int, length: int) -> None: ...


def try_select_replace_range_before_cursor(
    delete_chars: int,
    suffix_chars: int,
    backend: Optional[AXSelectionBackend] = None,
) -> bool:
    """Select [cursor - delete - suffix, delete] in the focused element.

    Returns True when the selection was applied (the caller's next "type"
    replaces it); False when AX is unavailable or refuses — callers fall
    back to the arrows+backspaces keyboard path, like clipboard.rs:717-733.
    """
    if backend is None:
        backend = default_backend()
    if backend is None:
        return False
    try:
        if not backend.range_settable():
            return False
        location, _length = backend.selected_range()
        start, length = compute_replace_range(
            location, delete_chars, suffix_chars
        )
        backend.set_selected_range(start, length)
        return True
    except AXError:
        return False
    except Exception:
        return False  # any FFI failure degrades to the keyboard path


_default: Optional[AXSelectionBackend] = None
_default_resolved = False


def default_backend() -> Optional[AXSelectionBackend]:
    global _default, _default_resolved
    if not _default_resolved:
        _default_resolved = True
        if sys.platform == "darwin":
            try:
                _default = CtypesAXBackend()
            except Exception:
                _default = None
    return _default


class CtypesAXBackend:
    """ApplicationServices AXUIElement binding (macOS only).

    Mirrors macos_ax.rs: system-wide element -> AXFocusedApplication ->
    AXFocusedUIElement, then get/set AXSelectedTextRange as an AXValue of
    kAXValueTypeCFRange (=4)."""

    K_AX_VALUE_TYPE_CF_RANGE = 4

    def __init__(self):
        import ctypes
        import ctypes.util

        path = ctypes.util.find_library("ApplicationServices")
        if not path:
            raise AXError("ApplicationServices framework not found")
        self.ctypes = ctypes
        self.lib = ctypes.cdll.LoadLibrary(path)
        cf_path = ctypes.util.find_library("CoreFoundation")
        self.cf = ctypes.cdll.LoadLibrary(cf_path)

        class CFRange(ctypes.Structure):
            _fields_ = [("location", ctypes.c_long),
                        ("length", ctypes.c_long)]

        self.CFRange = CFRange
        self.lib.AXUIElementCreateSystemWide.restype = ctypes.c_void_p
        self.lib.AXUIElementCopyAttributeValue.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p)]
        self.lib.AXUIElementSetAttributeValue.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        self.lib.AXUIElementIsAttributeSettable.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ubyte)]
        self.lib.AXValueCreate.restype = ctypes.c_void_p
        self.lib.AXValueCreate.argtypes = [
            ctypes.c_uint32, ctypes.c_void_p]
        self.lib.AXValueGetValue.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p]
        self.cf.CFStringCreateWithCString.restype = ctypes.c_void_p
        self.cf.CFStringCreateWithCString.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        self.cf.CFRelease.argtypes = [ctypes.c_void_p]

    def _cfstr(self, s: str):
        return self.cf.CFStringCreateWithCString(None, s.encode(), 0x08000100)

    def _copy_attr(self, element, name: str):
        attr = self._cfstr(name)
        out = self.ctypes.c_void_p()
        try:
            err = self.lib.AXUIElementCopyAttributeValue(
                element, attr, self.ctypes.byref(out))
        finally:
            self.cf.CFRelease(attr)
        if err != 0 or not out.value:
            raise AXError(f"AXUIElementCopyAttributeValue({name}) -> {err}")
        return out

    def _release(self, *objs) -> None:
        """CFRelease every copied/created CF object — each call here
        creates fresh system-wide/app/element/value objects, and a
        dictation session applies hundreds of diffs (steady native
        memory growth otherwise)."""
        for o in objs:
            try:
                val = o.value if hasattr(o, "value") else o
                if val:
                    self.cf.CFRelease(val)
            except Exception:
                pass

    def _focused_element(self):
        """-> (element, retained_objects_to_release_with_it)."""
        system = self.lib.AXUIElementCreateSystemWide()
        if not system:
            raise AXError("AXUIElementCreateSystemWide returned null")
        try:
            app = self._copy_attr(system, "AXFocusedApplication")
        except AXError:
            self._release(system)
            raise
        try:
            element = self._copy_attr(app, "AXFocusedUIElement")
        except AXError:
            self._release(app, system)
            raise
        return element, (app, system)

    def range_settable(self) -> bool:
        element, owned = self._focused_element()
        attr = self._cfstr("AXSelectedTextRange")
        try:
            settable = self.ctypes.c_ubyte(0)
            err = self.lib.AXUIElementIsAttributeSettable(
                element, attr, self.ctypes.byref(settable))
            return err == 0 and settable.value != 0
        finally:
            self._release(attr, element, *owned)

    def selected_range(self) -> Tuple[int, int]:
        element, owned = self._focused_element()
        value = None
        try:
            value = self._copy_attr(element, "AXSelectedTextRange")
            rng = self.CFRange()
            ok = self.lib.AXValueGetValue(
                value, self.K_AX_VALUE_TYPE_CF_RANGE, self.ctypes.byref(rng))
            if not ok:
                raise AXError("AXValueGetValue(AXSelectedTextRange) failed")
            return int(rng.location), int(rng.length)
        finally:
            if value is not None:
                self._release(value)
            self._release(element, *owned)

    def set_selected_range(self, location: int, length: int) -> None:
        element, owned = self._focused_element()
        rng = self.CFRange(location, length)
        value = self.lib.AXValueCreate(
            self.K_AX_VALUE_TYPE_CF_RANGE, self.ctypes.byref(rng))
        if not value:
            self._release(element, *owned)
            raise AXError("AXValueCreate(CFRange) failed")
        attr = self._cfstr("AXSelectedTextRange")
        try:
            err = self.lib.AXUIElementSetAttributeValue(element, attr, value)
        finally:
            self._release(attr, value, element, *owned)
        if err != 0:
            raise AXError(f"AXUIElementSetAttributeValue -> {err}")
