"""Windows notification-area tray: Shell_NotifyIcon over raw ctypes.

Port of spittle_tpu/shell/windows_tray.py.

The reference tray runs on Windows through tauri's tray wrapper
(`src-tauri/src/tray.rs:14-18` — one icon+menu tray on all three
platforms). This is the Win32 arm:

  RegisterClassW(WNDPROC = ctypes thunk) + CreateWindowExW(
      HWND_MESSAGE)            | a message-only window receives the
                                 tray callbacks (no visible surface)
  Shell_NotifyIconW(NIM_ADD)   | icon + tooltip in the notification area
  WM_APP_TRAY callbacks        | WM_LBUTTONUP -> activate (toggle
                                 transcribe, reference behavior);
                                 WM_RBUTTONUP -> CreatePopupMenu +
                                 TrackPopupMenu(TPM_RETURNCMD) -> the
                                 shared tray-menu dispatch
  NIM_MODIFY                   | state changes retitle the tooltip and
                                 swap the stock icon

Same surface as tray_sni.SniTray / macos_tray.MacTray (set_state,
close), driven by the shared handlers (tray_sni.tray_menu_handler) so
behavior is identical across the three platforms by construction.
user32/shell32/kernel32 are injectable seams; tests drive the real
WNDPROC + NOTIFYICONDATA marshalling against a compiled C fake
(tests/test_torch_shell_windows.py pattern)."""

from __future__ import annotations

import ctypes as _c
import sys
import threading
from typing import Callable, List, Optional, Tuple

from spittle_tpu_torch.app.ui_state import TrayIconState
from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger

# The hotkey backend's MSG: both set user32.GetMessageW's argtypes, and on
# Windows they share one user32 (ctypes.windll caches it), so each must
# accept the other's messages. (The JAX package defines a second MSG here,
# and the hotkey thread's GetMessageW then fails once a tray exists.)
from .windows_keys import MSG

_log = get_logger("tray")

WM_DESTROY = 0x0002
WM_COMMAND = 0x0111
WM_APP = 0x8000
WM_APP_TRAY = WM_APP + 10
WM_APP_QUIT = WM_APP + 11
WM_APP_MODIFY = WM_APP + 12
WM_LBUTTONUP = 0x0202
WM_RBUTTONUP = 0x0205

NIM_ADD = 0
NIM_MODIFY = 1
NIM_DELETE = 2
NIF_MESSAGE = 0x1
NIF_ICON = 0x2
NIF_TIP = 0x4

MF_STRING = 0x0
TPM_RETURNCMD = 0x0100
HWND_MESSAGE = -3

# Stock icons (LoadIconW(NULL, IDI_*)): state-distinct without assets.
IDI_APPLICATION = 32512
IDI_EXCLAMATION = 32515
IDI_INFORMATION = 32516

STATE_ICON = {
    TrayIconState.IDLE: IDI_APPLICATION,
    TrayIconState.RECORDING: IDI_EXCLAMATION,
    TrayIconState.TRANSCRIBING: IDI_INFORMATION,
}
STATE_TIP = {
    TrayIconState.IDLE: "Spittle — idle",
    TrayIconState.RECORDING: "Spittle — recording",
    TrayIconState.TRANSCRIBING: "Spittle — transcribing",
}

_WNDPROC_FACTORY = getattr(_c, "WINFUNCTYPE", _c.CFUNCTYPE)
WNDPROC = _WNDPROC_FACTORY(
    _c.c_ssize_t, _c.c_void_p, _c.c_uint32, _c.c_size_t, _c.c_ssize_t
)


class WNDCLASSW(_c.Structure):
    _fields_ = [
        ("style", _c.c_uint32),
        ("lpfnWndProc", WNDPROC),
        ("cbClsExtra", _c.c_int),
        ("cbWndExtra", _c.c_int),
        ("hInstance", _c.c_void_p),
        ("hIcon", _c.c_void_p),
        ("hCursor", _c.c_void_p),
        ("hbrBackground", _c.c_void_p),
        ("lpszMenuName", _c.c_wchar_p),
        ("lpszClassName", _c.c_wchar_p),
    ]


class NOTIFYICONDATAW(_c.Structure):
    _fields_ = [
        ("cbSize", _c.c_uint32),
        ("hWnd", _c.c_void_p),
        ("uID", _c.c_uint32),
        ("uFlags", _c.c_uint32),
        ("uCallbackMessage", _c.c_uint32),
        ("hIcon", _c.c_void_p),
        ("szTip", _c.c_wchar * 128),
        # (newer fields unused: NIM_ADD honors cbSize)
    ]



class WinTray:
    """A live Shell_NotifyIcon tray (injectable user32/shell32/kernel32)."""

    def __init__(
        self,
        menu_items: List[Tuple[str, str]],
        on_activate: Optional[Callable[[], None]] = None,
        on_menu: Optional[Callable[[str], None]] = None,
        user32=None, shell32=None, kernel32=None,
    ):
        if user32 is None or shell32 is None or kernel32 is None:
            if sys.platform != "win32":
                raise OSError("Shell_NotifyIcon requires Windows")
            user32 = _c.windll.user32  # pragma: no cover (win32)
            shell32 = _c.windll.shell32  # pragma: no cover (win32)
            kernel32 = _c.windll.kernel32  # pragma: no cover (win32)
        self.user32, self.shell32, self.kernel32 = user32, shell32, kernel32
        self.on_activate = on_activate
        self.on_menu = on_menu
        self._items = list(menu_items)
        self.state = TrayIconState.IDLE
        self.hwnd = None
        self._tid = None
        self._ready = threading.Event()
        self._fail: Optional[str] = None

        user32.DefWindowProcW.restype = _c.c_ssize_t
        user32.DefWindowProcW.argtypes = [
            _c.c_void_p, _c.c_uint32, _c.c_size_t, _c.c_ssize_t,
        ]
        user32.RegisterClassW.restype = _c.c_uint16
        user32.RegisterClassW.argtypes = [_c.POINTER(WNDCLASSW)]
        user32.CreateWindowExW.restype = _c.c_void_p
        user32.CreateWindowExW.argtypes = [
            _c.c_uint32, _c.c_wchar_p, _c.c_wchar_p, _c.c_uint32,
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,
            _c.c_ssize_t, _c.c_void_p, _c.c_void_p, _c.c_void_p,
        ]
        user32.GetMessageW.restype = _c.c_int
        user32.GetMessageW.argtypes = [
            _c.POINTER(MSG), _c.c_void_p, _c.c_uint32, _c.c_uint32,
        ]
        user32.DispatchMessageW.restype = _c.c_ssize_t
        user32.DispatchMessageW.argtypes = [_c.POINTER(MSG)]
        user32.PostThreadMessageW.restype = _c.c_bool
        user32.PostThreadMessageW.argtypes = [
            _c.c_uint32, _c.c_uint32, _c.c_size_t, _c.c_ssize_t,
        ]
        user32.LoadIconW.restype = _c.c_void_p
        user32.LoadIconW.argtypes = [_c.c_void_p, _c.c_size_t]
        user32.CreatePopupMenu.restype = _c.c_void_p
        user32.CreatePopupMenu.argtypes = []
        user32.AppendMenuW.restype = _c.c_bool
        user32.AppendMenuW.argtypes = [
            _c.c_void_p, _c.c_uint32, _c.c_size_t, _c.c_wchar_p,
        ]
        user32.TrackPopupMenu.restype = _c.c_int
        user32.TrackPopupMenu.argtypes = [
            _c.c_void_p, _c.c_uint32, _c.c_int, _c.c_int, _c.c_int,
            _c.c_void_p, _c.c_void_p,
        ]
        user32.DestroyMenu.restype = _c.c_bool
        user32.DestroyMenu.argtypes = [_c.c_void_p]
        user32.DestroyWindow.restype = _c.c_bool
        user32.DestroyWindow.argtypes = [_c.c_void_p]
        user32.GetCursorPos.restype = _c.c_bool
        user32.GetCursorPos.argtypes = [_c.POINTER(_c.c_long * 2)]
        shell32.Shell_NotifyIconW.restype = _c.c_bool
        shell32.Shell_NotifyIconW.argtypes = [
            _c.c_uint32, _c.POINTER(NOTIFYICONDATAW),
        ]
        kernel32.GetCurrentThreadId.restype = _c.c_uint32
        kernel32.GetCurrentThreadId.argtypes = []

        # WNDPROC thunk must outlive the window.
        self._proc = WNDPROC(self._wndproc)
        self._thread = threads.spawn(self._loop, name="win-tray")
        self._ready.wait(timeout=5)
        if self._fail:
            raise OSError(self._fail)

    # -- message loop (window + tray icon live on this thread) -----------

    def _loop(self) -> None:
        u = self.user32
        self._tid = int(self.kernel32.GetCurrentThreadId())
        cls = WNDCLASSW(
            lpfnWndProc=self._proc, lpszClassName="SpittleTrayWnd",
        )
        if not u.RegisterClassW(_c.byref(cls)):
            self._fail = "RegisterClassW failed"
            self._ready.set()
            return
        self.hwnd = u.CreateWindowExW(
            0, "SpittleTrayWnd", "spittle-tray", 0, 0, 0, 0, 0,
            HWND_MESSAGE, None, None, None,
        )
        if not self.hwnd:
            self._fail = "CreateWindowExW failed"
            self._ready.set()
            return
        nid = self._nid(NIF_MESSAGE | NIF_ICON | NIF_TIP)
        if not self.shell32.Shell_NotifyIconW(NIM_ADD, _c.byref(nid)):
            self._fail = "Shell_NotifyIconW(NIM_ADD) failed"
            self._ready.set()
            return
        self._ready.set()
        msg = MSG()
        while u.GetMessageW(_c.byref(msg), None, 0, 0) > 0:
            if msg.message == WM_APP_QUIT:
                break
            if msg.message == WM_APP_MODIFY:
                nid = self._nid(NIF_ICON | NIF_TIP)
                self.shell32.Shell_NotifyIconW(NIM_MODIFY, _c.byref(nid))
                continue
            if msg.message == WM_APP_TRAY and msg.hwnd is None:
                # Thread-posted tray callback (tests post via
                # PostThreadMessageW; real callbacks arrive through the
                # window and hit _wndproc via DispatchMessageW below).
                self._on_tray(int(msg.lParam))
                continue
            u.DispatchMessageW(_c.byref(msg))
        nid = self._nid(0)
        self.shell32.Shell_NotifyIconW(NIM_DELETE, _c.byref(nid))
        if self.hwnd:
            u.DestroyWindow(self.hwnd)
            self.hwnd = None

    def _nid(self, flags: int) -> NOTIFYICONDATAW:
        nid = NOTIFYICONDATAW(
            cbSize=_c.sizeof(NOTIFYICONDATAW), hWnd=self.hwnd, uID=1,
            uFlags=flags, uCallbackMessage=WM_APP_TRAY,
            hIcon=self.user32.LoadIconW(None, STATE_ICON[self.state]),
        )
        nid.szTip = STATE_TIP[self.state][:127]
        return nid

    def _wndproc(self, hwnd, message, wparam, lparam) -> int:
        try:
            if message == WM_APP_TRAY:
                self._on_tray(int(lparam))
                return 0
        except Exception:  # noqa: BLE001 - wndproc must not throw
            _log.exception("tray wndproc failed")
            return 0
        return int(self.user32.DefWindowProcW(hwnd, message, wparam, lparam))

    def _on_tray(self, event: int) -> None:
        if event == WM_LBUTTONUP:
            if self.on_activate is not None:
                self.on_activate()
        elif event == WM_RBUTTONUP:
            self._show_menu()

    def _show_menu(self) -> None:
        u = self.user32
        menu = u.CreatePopupMenu()
        for i, (_mid, label) in enumerate(self._items):
            u.AppendMenuW(menu, MF_STRING, i + 1, label)
        pt = (_c.c_long * 2)()
        u.GetCursorPos(_c.byref(pt))
        cmd = int(u.TrackPopupMenu(
            menu, TPM_RETURNCMD, pt[0], pt[1], 0, self.hwnd, None
        ))
        u.DestroyMenu(menu)
        if cmd > 0 and self.on_menu is not None:
            self.on_menu(self._items[cmd - 1][0])

    # -- tray surface ------------------------------------------------------

    def set_state(self, state: TrayIconState) -> None:
        self.state = state
        if self._tid is not None:
            self.user32.PostThreadMessageW(self._tid, WM_APP_MODIFY, 0, 0)

    def close(self) -> None:
        if self._tid is not None:
            self.user32.PostThreadMessageW(self._tid, WM_APP_QUIT, 0, 0)
        self._thread.join(timeout=2)


def attach_windows_tray(services, actions, ui, commands=None,
                        user32=None, shell32=None, kernel32=None):
    """Wire a WinTray to the app graph (same contract as
    tray_sni.attach_tray)."""
    from .tray_sni import tray_activate_handler, tray_menu_handler

    try:
        tray = WinTray(
            ui.tray.menu_items(),
            on_activate=tray_activate_handler(actions),
            on_menu=tray_menu_handler(services, actions, ui, commands),
            user32=user32, shell32=shell32, kernel32=kernel32,
        )
    except Exception as e:  # noqa: BLE001 - headless fallback
        _log.info("windows tray unavailable: %s", e)
        return None
    services.events.listen(
        "tray-state-changed",
        lambda v: tray.set_state(TrayIconState(v)),
    )
    return tray
