"""Wayland recording overlay: wlr-layer-shell over a from-scratch wire client.

Port of spittle_tpu/shell/wayland_overlay.py.

The reference's PRIMARY Linux overlay path is gtk-layer-shell on Wayland
with a KDE bailout (src-tauri/src/overlay.rs:70-95); our X11
override-redirect window (shell/x11_overlay.py) covers X sessions only.
This module adds the Wayland half with the same philosophy as
shell/dbus_client.py: speak the wire protocol directly over the unix
socket — no libwayland, no gtk — so the whole stack is inspectable and
loopback-testable against a fake compositor.

Protocol objects implemented (core + wlr-layer-shell-unstable-v1):
  wl_display.get_registry/sync, wl_registry.bind, wl_callback.done,
  wl_compositor.create_surface, wl_surface.attach/damage/commit,
  wl_shm.create_pool (memfd + SCM_RIGHTS fd passing),
  wl_shm_pool.create_buffer, zwlr_layer_shell_v1.get_layer_surface,
  zwlr_layer_surface_v1.set_size/set_anchor/set_margin/
  set_keyboard_interactivity/ack_configure + configure/closed events.

Wire format: each message is [u32 object_id][u32 size<<16|opcode] then
args (i32/u32 inline, strings/arrays length-prefixed NUL-padded to 4,
fds as SCM_RIGHTS ancillary data). Client object ids allocate upward
from 2 (1 is wl_display).

The pill renders into a shared-memory xrgb8888 buffer (memfd); showing
attaches + commits, hiding attaches NULL + commits, mic bars redraw the
pixels and damage the surface. KDE Wayland sessions bail out exactly
like the reference (overlay.rs:79-84: layer-shell on KWin breaks
gtk-layer-shell's assumptions).
"""

from __future__ import annotations

import array
import mmap
import os
import socket
import struct
from typing import Dict, List, Optional, Tuple

from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("wayland")

# zwlr_layer_shell_v1 layers and anchors (wlr-layer-shell-unstable-v1.xml)
LAYER_OVERLAY = 3
ANCHOR_TOP = 1
ANCHOR_BOTTOM = 2

FORMAT_XRGB8888 = 1


def _pad(n: int) -> int:
    return (n + 3) & ~3


def marshal_string(s: str) -> bytes:
    data = s.encode() + b"\0"
    return struct.pack("<I", len(data)) + data + b"\0" * (_pad(len(data)) - len(data))


class WaylandWire:
    """Socket framing + object-id allocation for one Wayland connection."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._next_id = 2  # 1 = wl_display
        self._buf = b""
        self._fds_out: List[int] = []

    @classmethod
    def connect(cls, display: Optional[str] = None) -> "WaylandWire":
        display = display or os.environ.get("WAYLAND_DISPLAY", "wayland-0")
        if os.path.isabs(display):
            path = display  # spec: absolute WAYLAND_DISPLAY used as-is
        else:
            runtime = os.environ.get("XDG_RUNTIME_DIR")
            if not runtime:
                raise OSError("XDG_RUNTIME_DIR unset")
            path = os.path.join(runtime, display)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(path)
        return cls(sock)

    def new_id(self) -> int:
        oid = self._next_id
        self._next_id += 1
        return oid

    # -- send --------------------------------------------------------------

    def request(self, obj: int, opcode: int, body: bytes = b"",
                fds: Tuple[int, ...] = ()) -> None:
        size = 8 + len(body)
        msg = struct.pack("<II", obj, (size << 16) | opcode) + body
        if fds:
            self.sock.sendmsg(
                [msg],
                [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                  array.array("i", fds).tobytes())],
            )
        else:
            self.sock.sendall(msg)

    # -- receive -----------------------------------------------------------

    def read_message(self) -> Tuple[int, int, bytes]:
        """Blocking read of one event -> (object_id, opcode, body)."""
        while len(self._buf) < 8:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("wayland socket closed")
            self._buf += chunk
        obj, sizeop = struct.unpack_from("<II", self._buf)
        size, opcode = sizeop >> 16, sizeop & 0xFFFF
        while len(self._buf) < size:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("wayland socket closed")
            self._buf += chunk
        body = self._buf[8:size]
        self._buf = self._buf[size:]
        return obj, opcode, body

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class WaylandBackend:
    """Overlay window over the wire client; mirrors XBackend's surface so
    the X11Overlay controller drives either backend unchanged."""

    def __init__(self, display: Optional[str] = None):
        self._display = display
        self.wire: Optional[WaylandWire] = None
        self.ids: Dict[str, int] = {}
        self._globals: Dict[str, Tuple[int, int]] = {}  # iface -> (name, ver)
        self._configured = False
        self._closed_by_compositor = False
        self._mm: Optional[mmap.mmap] = None
        self._size = (0, 0)
        self._attached = False
        self._screen = (1920, 1080)  # wl_output mode updates this

    # -- connection + globals ----------------------------------------------

    def open(self) -> bool:
        try:
            self.wire = WaylandWire.connect(self._display)
        except OSError as e:
            _log.info("no wayland display: %s", e)
            return False
        w = self.wire
        registry = w.new_id()
        w.request(1, 1, struct.pack("<I", registry))  # get_registry
        self.ids["registry"] = registry
        self._roundtrip(collect_globals=True)
        needed = ("wl_compositor", "wl_shm", "zwlr_layer_shell_v1")
        missing = [n for n in needed if n not in self._globals]
        if missing:
            _log.info("compositor lacks %s; wayland overlay disabled",
                      missing)
            self.wire.close()
            return False
        for iface, version in (("wl_compositor", 4), ("wl_shm", 1),
                               ("zwlr_layer_shell_v1", 1)):
            self.ids[iface] = self._bind(iface, version)
        return True

    def _bind(self, iface: str, version: int) -> int:
        w = self.wire
        name, gver = self._globals[iface]
        oid = w.new_id()
        body = (struct.pack("<I", name) + marshal_string(iface)
                + struct.pack("<II", min(version, gver), oid))
        w.request(self.ids["registry"], 0, body)  # registry.bind
        return oid

    def _roundtrip(self, collect_globals: bool = False) -> None:
        """wl_display.sync + drain events until the callback fires."""
        w = self.wire
        cb = w.new_id()
        w.request(1, 0, struct.pack("<I", cb))  # display.sync
        while True:
            obj, opcode, body = w.read_message()
            if obj == cb and opcode == 0:  # callback.done
                return
            self._handle_event(obj, opcode, body,
                               collect_globals=collect_globals)

    def _handle_event(self, obj: int, opcode: int, body: bytes,
                      collect_globals: bool = False) -> None:
        if obj == 1 and opcode == 0:  # display.error
            code_obj, code = struct.unpack_from("<II", body)
            msg_len = struct.unpack_from("<I", body, 8)[0]
            msg = body[12 : 12 + msg_len - 1].decode(errors="replace")
            raise ConnectionError(
                f"wayland protocol error on object {code_obj}: {msg}"
            )
        if collect_globals and obj == self.ids.get("registry") and opcode == 0:
            name = struct.unpack_from("<I", body)[0]
            slen = struct.unpack_from("<I", body, 4)[0]
            iface = body[8 : 8 + slen - 1].decode()
            version = struct.unpack_from("<I", body, 8 + _pad(slen))[0]
            self._globals[iface] = (name, version)
        elif obj == self.ids.get("layer_surface") and opcode == 0:
            # zwlr_layer_surface_v1.configure(serial, w, h) -> ack
            serial = struct.unpack_from("<I", body)[0]
            self.wire.request(obj, 6, struct.pack("<I", serial))
            self._configured = True
        elif obj == self.ids.get("layer_surface") and opcode == 1:
            self._closed_by_compositor = True
        elif obj == self.ids.get("output") and opcode == 1:
            # wl_output.mode(flags, width, height, refresh)
            _, width, height, _ = struct.unpack_from("<IiiI", body)
            self._screen = (width, height)

    # -- XBackend-compatible surface ----------------------------------------

    def screen_size(self) -> Tuple[int, int]:
        # Layer-shell anchors/margins position the pill; the controller
        # only uses this for x-centering math, which anchors make moot —
        # report the last advertised output mode (or the default).
        return self._screen

    def create_window(self, xpos: int, ypos: int, w: int, h: int,
                      color: int) -> None:
        wire = self.wire
        surface = wire.new_id()
        wire.request(self.ids["wl_compositor"], 0,
                     struct.pack("<I", surface))  # create_surface
        self.ids["surface"] = surface
        lsurf = wire.new_id()
        body = (struct.pack("<II", lsurf, surface)
                + struct.pack("<I", 0)  # output: null -> compositor picks
                + struct.pack("<I", LAYER_OVERLAY)
                + marshal_string("spittle-overlay"))
        wire.request(self.ids["zwlr_layer_shell_v1"], 0, body)
        self.ids["layer_surface"] = lsurf
        self._size = (w, h)
        wire.request(lsurf, 0, struct.pack("<II", w, h))  # set_size
        self._anchor_for(ypos)
        wire.request(lsurf, 4, struct.pack("<I", 0))  # no keyboard
        # initial commit with no buffer, then wait for configure
        wire.request(surface, 6)  # commit
        self._roundtrip()
        self._make_buffer(w, h, color)

    def _anchor_for(self, ypos: int) -> None:
        """Anchor top/bottom center with the reference's pixel offsets."""
        lsurf = self.ids["layer_surface"]
        top = ypos < self._screen[1] // 2
        anchor = ANCHOR_TOP if top else ANCHOR_BOTTOM
        self.wire.request(lsurf, 1, struct.pack("<I", anchor))
        margin = ypos if top else max(
            self._screen[1] - ypos - self._size[1], 0
        )
        mt, mb = (margin, 0) if top else (0, margin)
        self.wire.request(
            lsurf, 3, struct.pack("<iiii", mt, 0, mb, 0)
        )  # set_margin(top,right,bottom,left)

    def _make_buffer(self, w: int, h: int, color: int) -> None:
        wire = self.wire
        stride = w * 4
        size = stride * h
        fd = os.memfd_create("spittle-overlay")
        os.ftruncate(fd, size)
        self._mm = mmap.mmap(fd, size)
        pool = wire.new_id()
        wire.request(self.ids["wl_shm"], 0,
                     struct.pack("<Ii", pool, size), fds=(fd,))
        buf = wire.new_id()
        wire.request(pool, 0, struct.pack(
            "<IiiiiI", buf, 0, w, h, stride, FORMAT_XRGB8888))
        self.ids["pool"], self.ids["buffer"] = pool, buf
        os.close(fd)
        self._fill(0, 0, w, h, color)

    def _fill(self, x0: int, y0: int, w: int, h: int, color: int) -> None:
        px = struct.pack("<I", color | 0xFF000000)
        width = self._size[0]
        row = px * w
        for y in range(y0, y0 + h):
            off = (y * width + x0) * 4
            self._mm[off : off + w * 4] = row

    def set_background(self, color: int) -> None:
        self._bg = color
        self._fill(0, 0, *self._size, color)
        self._damage_all()

    def map(self) -> None:
        wire = self.wire
        wire.request(self.ids["surface"], 1,
                     struct.pack("<Iii", self.ids["buffer"], 0, 0))
        self._damage_all()
        wire.request(self.ids["surface"], 6)  # commit
        self._attached = True

    def unmap(self) -> None:
        wire = self.wire
        wire.request(self.ids["surface"], 1,
                     struct.pack("<Iii", 0, 0, 0))  # attach null
        wire.request(self.ids["surface"], 6)
        self._attached = False

    def move(self, xpos: int, ypos: int) -> None:
        self._anchor_for(ypos)

    def fill_rect(self, color: int, xpos: int, ypos: int, w: int,
                  h: int) -> None:
        self._fill(xpos, ypos, w, h, color)

    def flush(self) -> None:
        if self._attached:
            # re-attach so the compositor re-reads the (mutated) buffer
            self.wire.request(self.ids["surface"], 1,
                              struct.pack("<Iii", self.ids["buffer"], 0, 0))
            self._damage_all()
            self.wire.request(self.ids["surface"], 6)

    def _damage_all(self) -> None:
        self.wire.request(self.ids["surface"], 2,
                          struct.pack("<iiii", 0, 0, *self._size))

    def close(self) -> None:
        if self.wire:
            self.wire.close()
            self.wire = None
        if self._mm:
            self._mm.close()
            self._mm = None


def session_is_kde_wayland() -> bool:
    """The reference bails out of layer-shell on KDE Wayland
    (overlay.rs:79-84); mirror that exactly."""
    if os.environ.get("XDG_SESSION_TYPE", "").lower() != "wayland":
        return False
    desktop = (os.environ.get("XDG_CURRENT_DESKTOP", "")
               + ":" + os.environ.get("DESKTOP_SESSION", "")).upper()
    return "KDE" in desktop or "PLASMA" in desktop


def attach_wayland_overlay(services, backend: Optional[WaylandBackend] = None):
    """Layer-shell overlay when a Wayland display is reachable (and the
    session is not KDE — the reference's bailout); None otherwise."""
    from spittle_tpu_torch.shell.x11_overlay import X11Overlay

    if backend is None:
        if not os.environ.get("WAYLAND_DISPLAY"):
            return None
        if session_is_kde_wayland():
            _log.info("KDE Wayland session: layer-shell overlay disabled "
                      "(reference parity, overlay.rs:79-84)")
            return None
        backend = WaylandBackend()
    try:
        overlay = X11Overlay(services.events, services.get_settings,
                             backend=backend)
    except Exception as e:  # noqa: BLE001
        _log.info("wayland overlay unavailable: %s", e)
        return None
    return overlay if overlay.active else None
