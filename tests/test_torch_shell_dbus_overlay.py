"""The port's D-Bus peer, StatusNotifierItem tray, X11 and Wayland overlays
and overlay selection (spittle_tpu_torch/shell/{dbus_client,tray_sni,
x11_overlay,wayland_overlay,overlay_select}.py) against the JAX package's
on the CPU, at exact equality:

- the marshalled bytes of the same values and messages;
- over a fake session bus (one client; EXTERNAL auth, the bus's own
  methods and the watcher answered; every byte the client sends kept),
  the tray's auth, registration, property and menu replies, NewIcon and
  LayoutUpdated signals, byte for byte, directly and through attach_tray;
- the X11 overlay's command stream on a recording XBackend;
- against tests/test_wayland_overlay.py's fake compositor, every request
  the Wayland client sends, the fd it passes and the pixels behind it;
- the arm attach_session_overlay picks for each session type, display and
  desktop, and the win32/darwin arms, which raise in the port.
"""

import ctypes.util
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest

from spittle_tpu.app import actions as j_actions
from spittle_tpu.app import services as j_services
from spittle_tpu.app import ui_state as j_ui
from spittle_tpu.config import settings as j_settings
from spittle_tpu.events import HIDE_OVERLAY, MIC_LEVEL, SHOW_OVERLAY, EventBus as JBus
from spittle_tpu.pipeline import BufferTextOutput as JOut
from spittle_tpu.shell import dbus_client as j_dbus
from spittle_tpu.shell import overlay_select as j_select
from spittle_tpu.shell import tray_sni as j_tray
from spittle_tpu.shell import wayland_overlay as j_wl
from spittle_tpu.shell import x11_overlay as j_x11
from spittle_tpu_torch.app import actions as t_actions
from spittle_tpu_torch.app import services as t_services
from spittle_tpu_torch.app import ui_state as t_ui
from spittle_tpu_torch.config import settings as t_settings
from spittle_tpu_torch.events import EventBus as TBus
from spittle_tpu_torch.pipeline import BufferTextOutput as TOut
from spittle_tpu_torch.shell import dbus_client as t_dbus
from spittle_tpu_torch.shell import overlay_select as t_select
from spittle_tpu_torch.shell import tray_sni as t_tray
from spittle_tpu_torch.shell import wayland_overlay as t_wl
from spittle_tpu_torch.shell import x11_overlay as t_x11

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_wayland_overlay import FakeCompositor  # noqa: E402

JAX = dict(dbus=j_dbus, tray=j_tray, x11=j_x11, wl=j_wl, select=j_select, bus=JBus,
           settings=j_settings, services=j_services, ui=j_ui, actions=j_actions,
           out=JOut, kw={})
PORT = dict(dbus=t_dbus, tray=t_tray, x11=t_x11, wl=t_wl, select=t_select, bus=TBus,
            settings=t_settings, services=t_services, ui=t_ui, actions=t_actions,
            out=TOut, kw={"device": "cpu"})


def _wait(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# -- marshalling ---------------------------------------------------------------

def _values(dbus):
    V = dbus.Variant
    return [
        ("ybnqiuxtd", (7, True, -3, 65535, -70000, 4000000000, -(1 << 40), 1 << 63, 2.5)),
        ("sog", ("héllo", "/a/b", "a{sv}")),
        ("as", (["", "x", "yz"],)),
        ("a{sv}", ({"k": V("s", "v"), "n": V("i", -3), "b": V("b", False)},)),
        ("ua{sv}a(ia{sv}av)", (7, {"k": V("s", "v")},
                               [(1, {"label": V("s", "héllo")},
                                 [V("(ia{sv}av)", (2, {}, []))])])),
        ("u(ia{sv}av)", (3, (0, {"children-display": V("s", "submenu")}, []))),
        ("v", (V("ai", [1, 2, 3]),)),
        ("vvvv", (True, 5, 1.5, "inferred")),
        ("aay", ([[1, 2], [], [3]],)),
        ("a(yv)", ([(1, V("o", "/x")), (8, V("g", "s"))],)),
    ]


def test_marshalled_bytes_match():
    for (sig, jvals), (_, tvals) in zip(_values(j_dbus), _values(t_dbus)):
        jm, tm = j_dbus.Marshaller(), t_dbus.Marshaller()
        jm.write(sig, jvals)
        tm.write(sig, tvals)
        assert tm.getvalue() == jm.getvalue(), sig
        assert (_tree(t_dbus.Unmarshaller(jm.getvalue()).read(sig))
                == _tree(j_dbus.Unmarshaller(jm.getvalue()).read(sig))), sig
    for mtype, fields, sig, vals in (
            (1, [(1, "o", "/StatusNotifierItem"), (3, "s", "Activate"),
                 (2, "s", "org.kde.StatusNotifierItem")], "ii", (0, 0)),
            (4, [(1, "o", "/MenuBar"), (3, "s", "LayoutUpdated")], "ui", (2, 0)),
            (2, [(5, "u", 9), (6, "s", ":1.42")], "", ()),
            (3, [(5, "u", 9), (4, "s", "org.freedesktop.DBus.Error.Failed")], "s", ("x",))):
        want = j_dbus._build_message(mtype, 17, [(f, j_dbus.Variant(s, v))
                                                 for f, s, v in fields], sig, vals)
        got = t_dbus._build_message(mtype, 17, [(f, t_dbus.Variant(s, v))
                                                for f, s, v in fields], sig, vals)
        assert got == want
        jmsg, n = j_dbus.DBusConnection._try_parse(want)
        tmsg, m = t_dbus.DBusConnection._try_parse(want)
        assert (m, tmsg.type, tmsg.serial, tmsg.fields, _tree(tmsg.body)) == (
            n, jmsg.type, jmsg.serial, jmsg.fields, _tree(jmsg.body))
    assert t_dbus._split_signature("a{sv}sia(ii)") == j_dbus._split_signature("a{sv}sia(ii)")


def _tree(x):
    """A decoded D-Bus value with each Variant as (signature, value)."""
    if hasattr(x, "signature") and hasattr(x, "value"):
        return ("variant", x.signature, _tree(x.value))
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v) for v in x)
    return x


# -- the tray over a fake session bus -------------------------------------------

BUS = "org.freedesktop.DBus"
UNIQUE = ":1.42"
SHELL = ":1.7"


class FakeBus:
    """A session bus with one client, speaking the wire through the JAX
    package's marshaller: EXTERNAL auth, Hello, RequestName, AddMatch and
    the StatusNotifierWatcher's RegisterStatusNotifierItem answered; calls
    into the client made as the desktop shell would. Keeps every byte the
    client sends: the auth lines, then each message whole."""

    def __init__(self, path):
        self.address = f"unix:path={path}"
        self.server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.server.bind(path)
        self.server.listen(1)
        self.auth, self.messages, self.replies = [], [], {}
        self.cv = threading.Condition()
        self.serial = 1000
        self.conn = None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _line(self, buf):
        while b"\r\n" not in buf:
            chunk = self.conn.recv(4096)
            if not chunk:
                raise ConnectionError
            buf += chunk
        line, rest = buf.split(b"\r\n", 1)
        self.auth.append(line)
        return rest

    def _serve(self):
        try:
            self.conn, _ = self.server.accept()
            buf = self._line(b"")
            self.conn.sendall(b"OK 0123456789abcdef0123456789abcdef\r\n")
            buf = self._line(buf)
            while True:
                msg, n = j_dbus.DBusConnection._try_parse(buf)
                if msg is None:
                    chunk = self.conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                    continue
                raw, buf = buf[:n], buf[n:]
                self._handle(msg, raw)
        except (OSError, ConnectionError):
            return

    def _send(self, mtype, fields, sig="", vals=()):
        self.serial += 1
        V = j_dbus.Variant
        self.conn.sendall(j_dbus._build_message(
            mtype, self.serial, [(f, V(s, v)) for f, s, v in fields], sig, vals))
        return self.serial

    def _handle(self, msg, raw):
        with self.cv:
            self.messages.append(raw)
            if msg.type in (j_dbus.MSG_METHOD_RETURN, j_dbus.MSG_ERROR):
                self.replies[msg.reply_serial] = raw
            self.cv.notify_all()
        if msg.type != j_dbus.MSG_METHOD_CALL:
            return
        answer = {"Hello": ("s", (UNIQUE,)), "RequestName": ("u", (1,)),
                  "AddMatch": ("", ()), "RegisterStatusNotifierItem": ("", ())}
        if msg.member in answer:
            sig, vals = answer[msg.member]
            self._send(j_dbus.MSG_METHOD_RETURN,
                       [(j_dbus.H_REPLY_SERIAL, "u", msg.serial),
                        (j_dbus.H_DESTINATION, "s", UNIQUE),
                        (j_dbus.H_SENDER, "s", BUS)], sig, vals)

    def call(self, path, iface, member, sig="", vals=()):
        """A method call from the desktop shell; returns the client's reply,
        raw."""
        serial = self._send(j_dbus.MSG_METHOD_CALL, [
            (j_dbus.H_PATH, "o", path), (j_dbus.H_INTERFACE, "s", iface),
            (j_dbus.H_MEMBER, "s", member), (j_dbus.H_DESTINATION, "s", UNIQUE),
            (j_dbus.H_SENDER, "s", SHELL)], sig, vals)
        with self.cv:
            assert self.cv.wait_for(lambda: serial in self.replies, timeout=10), member
            return self.replies[serial]

    def wait_messages(self, n):
        with self.cv:
            assert self.cv.wait_for(lambda: len(self.messages) >= n, timeout=10), n

    def close(self):
        for s in (self.conn, self.server):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.thread.join(timeout=5)


SHELL_CALLS = (
    ("/StatusNotifierItem", "org.freedesktop.DBus.Properties", "GetAll", "s",
     ("org.kde.StatusNotifierItem",)),
    ("/StatusNotifierItem", "org.freedesktop.DBus.Properties", "Get", "ss",
     ("org.kde.StatusNotifierItem", "IconName")),
    ("/StatusNotifierItem", "org.freedesktop.DBus.Properties", "Get", "ss",
     ("org.kde.StatusNotifierItem", "Nope")),
    ("/StatusNotifierItem", "org.freedesktop.DBus.Introspectable", "Introspect", "", ()),
    ("/MenuBar", "com.canonical.dbusmenu", "GetLayout", "iias", (0, -1, [])),
    ("/MenuBar", "com.canonical.dbusmenu", "GetGroupProperties", "aias",
     ([1, 2, 9], [])),
    ("/MenuBar", "com.canonical.dbusmenu", "AboutToShow", "i", (1,)),
    ("/MenuBar", "com.canonical.dbusmenu", "Event", "isvu",
     (2, "clicked", j_dbus.Variant("s", ""), 0)),
    ("/StatusNotifierItem", "org.kde.StatusNotifierItem", "Activate", "ii", (0, 0)),
    ("/StatusNotifierItem", "org.kde.StatusNotifierItem", "Unknown", "", ()),
    ("/Nowhere", "x.y", "Z", "", ()),
)


def _tray_session(pkg, path):
    """One package's SniTray on a fake bus: every byte it sent, the replies
    to the shell's calls, the menu clicks and activations."""
    bus = FakeBus(path)
    clicks, activations = [], []
    tray = pkg["tray"].SniTray([("settings", "Einstellungen"), ("quit", "Beenden")],
                               on_activate=lambda: activations.append(1),
                               on_menu=clicks.append, address=bus.address)
    try:
        assert tray.registered
        replies = [bus.call(*c) for c in SHELL_CALLS]
        _wait(lambda: clicks and activations, "the click and the activation")
        n = len(bus.messages)
        tray.set_state(pkg["ui"].TrayIconState.RECORDING)
        tray.set_state(pkg["ui"].TrayIconState.TRANSCRIBING)
        tray.set_menu([("cancel", "Abbrechen"), ("quit", "Beenden")])
        bus.wait_messages(n + 3)
        replies.append(bus.call(*SHELL_CALLS[4]))
        replies.append(bus.call(*SHELL_CALLS[1]))
    finally:
        tray.close()
        bus.close()
    return bus.auth, bus.messages, replies, clicks, activations, tray.service_name


def test_tray_bytes_match_over_a_fake_bus(tmp_path):
    want = _tray_session(JAX, str(tmp_path / "jbus"))
    got = _tray_session(PORT, str(tmp_path / "tbus"))
    assert got == want
    auth, messages, replies, clicks, activations, name = got
    assert auth[0].startswith(b"\0AUTH EXTERNAL ") and auth[1] == b"BEGIN"
    assert clicks == ["quit"] and activations == [1]
    assert name == f"org.kde.StatusNotifierItem-{os.getpid()}-1"
    assert any(b"NewIcon" in m for m in messages)
    assert any(b"LayoutUpdated" in m for m in messages)


def _attach_session(pkg, tmp_path, path):
    """attach_tray over each package's app graph: what the tray sends when
    the app's TrayController changes state."""
    bus = FakeBus(path)
    svc = pkg["services"].AppServices(str(tmp_path), use_mock_engine=True, **pkg["kw"])
    try:
        ui = pkg["ui"].AppUi(svc, player=lambda p, v: None)
        actions = pkg["actions"].ActionContext(svc, pkg["out"](), ui=ui)
        tray = pkg["tray"].attach_tray(svc, actions, ui, address=bus.address)
        assert tray is not None
        try:
            bus.wait_messages(3)  # Hello, RequestName, the registration
            n = len(bus.messages)
            ui.tray.set_state(pkg["ui"].TrayIconState.TRANSCRIBING)
            _wait(lambda: tray.state is pkg["ui"].TrayIconState.TRANSCRIBING, "the tray")
            bus.wait_messages(n + 1)
            layout = bus.call(*SHELL_CALLS[4])
        finally:
            tray.close()
    finally:
        svc.shutdown()
        bus.close()
    return bus.messages, layout


def test_attach_tray_bytes_match(tmp_path):
    want = _attach_session(JAX, tmp_path / "jax", str(tmp_path / "jbus"))
    got = _attach_session(PORT, tmp_path / "port", str(tmp_path / "tbus"))
    assert got == want


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_attach_tray_without_a_bus(pkg, monkeypatch):
    monkeypatch.delenv("DBUS_SESSION_BUS_ADDRESS", raising=False)
    assert pkg["tray"].attach_tray(None, None, None) is None


@pytest.mark.skipif(shutil.which("dbus-daemon") is None, reason="no dbus-daemon")
def test_port_peer_on_a_real_daemon():
    """The port's DBusConnection against dbus-daemon: a call, properties and
    a signal between two connections."""
    proc = subprocess.Popen(["dbus-daemon", "--session", "--print-address", "--nofork"],
                            stdout=subprocess.PIPE)
    try:
        addr = proc.stdout.readline().decode().strip()
        a, b = t_dbus.DBusConnection(addr), t_dbus.DBusConnection(addr)
        try:
            obj = t_dbus.ExportedObject()
            obj.methods[("t.I", "Echo")] = lambda s, n: ("si", (s.upper(), n + 1))
            obj.properties["t.I"] = {"V": t_dbus.Variant("s", "1")}
            a.export("/t", obj)
            assert a.request_name("t.Svc") == 1
            assert b.call("t.Svc", "/t", "t.I", "Echo", "si", ("hey", 4)) == ("HEY", 5)
            props = b.call("t.Svc", "/t", "org.freedesktop.DBus.Properties", "GetAll",
                           "s", ("t.I",))[0]
            assert props["V"].value == "1"
            got = threading.Event()
            b.add_match("type='signal',interface='t.I'")
            b.on_signal(lambda m: got.set() if m.member == "Ping" else None)
            a.emit_signal("/t", "t.I", "Ping")
            assert got.wait(5)
        finally:
            a.close()
            b.close()
    finally:
        proc.terminate()
        proc.wait(timeout=5)


# -- the X11 overlay -------------------------------------------------------------

class FakeX:
    """Recording stand-in for the ctypes Xlib seam."""

    def __init__(self, fail_open=False):
        self.fail_open = fail_open
        self.calls = []

    def open(self):
        self.calls.append(("open",))
        return not self.fail_open

    def screen_size(self):
        return (1920, 1080)

    def __getattr__(self, name):
        if name in ("create_window", "set_background", "map", "unmap", "move",
                    "fill_rect", "flush", "close"):
            return lambda *a: self.calls.append((name,) + a)
        raise AttributeError(name)


OVERLAY_EVENTS = (
    (SHOW_OVERLAY, "recording"), (MIC_LEVEL, [0.5] * 16),
    (MIC_LEVEL, [0.0, 0.1, 0.9, 1.0, 0.33]), (SHOW_OVERLAY, "transcribing"),
    (SHOW_OVERLAY, {"state": "processing"}), (MIC_LEVEL, None),
    (HIDE_OVERLAY, None), (MIC_LEVEL, [1.0] * 16), (SHOW_OVERLAY, None),
    (SHOW_OVERLAY, "weird-state"), (MIC_LEVEL, [0.25] * 20), (HIDE_OVERLAY, None))


def _x11_session(pkg, position, backend):
    bus = pkg["bus"]()
    s = pkg["settings"].AppSettings()
    s.overlay_position = pkg["settings"].OverlayPosition(position)
    ov = pkg["x11"].X11Overlay(bus, lambda: s, backend=backend)
    if ov.active:
        for name, payload in OVERLAY_EVENTS:
            bus.emit(name, payload)
        ov._q.put(("hide", None))
        thread = ov._thread
        ov.close()
        thread.join(timeout=10)
        assert not thread.is_alive()
    return backend.calls, ov.active, ov.visible, ov.state


@pytest.mark.parametrize("position", ["top", "bottom", "none"])
def test_x11_overlay_commands_match(position):
    want = _x11_session(JAX, position, FakeX())
    got = _x11_session(PORT, position, FakeX())
    assert got == want
    assert got[0][-1] == ("close",)
    assert (_x11_session(PORT, position, FakeX(fail_open=True))
            == _x11_session(JAX, position, FakeX(fail_open=True)))
    assert t_x11.STATE_COLORS == j_x11.STATE_COLORS
    assert ((t_x11.OVERLAY_WIDTH, t_x11.OVERLAY_HEIGHT, t_x11.OVERLAY_TOP_OFFSET,
             t_x11.OVERLAY_BOTTOM_OFFSET, t_x11.BAR_COLOR, t_x11.N_BARS)
            == (j_x11.OVERLAY_WIDTH, j_x11.OVERLAY_HEIGHT, j_x11.OVERLAY_TOP_OFFSET,
                j_x11.OVERLAY_BOTTOM_OFFSET, j_x11.BAR_COLOR, j_x11.N_BARS))


@pytest.mark.skipif(not ctypes.util.find_library("X11"), reason="libX11 not present")
def test_xbackend_prototypes_match():
    """Both XBackends declare the same argtypes and restype for every
    libX11 function they call (64-bit pointers, not C ints)."""
    ours, ref = t_x11.XBackend(), j_x11.XBackend()
    names = [n for n in dir(ref.x) if n.startswith("X")]
    assert names
    for name in names:
        t_fn, j_fn = getattr(ours.x, name), getattr(ref.x, name)
        assert (t_fn.restype, t_fn.argtypes) == (j_fn.restype, j_fn.argtypes), name


def test_attach_overlay_without_a_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert t_x11.attach_overlay(None) is None and j_x11.attach_overlay(None) is None


# -- the Wayland overlay ----------------------------------------------------------

class RecordingCompositor(FakeCompositor):
    """The JAX tests' fake compositor, also keeping each request as sent:
    (object id, opcode, body bytes)."""

    def __init__(self, path):
        self.raw = []
        super().__init__(path)

    def _dispatch(self, obj, opcode, body, fds):
        self.raw.append((obj, opcode, bytes(body)))
        super()._dispatch(obj, opcode, body, fds)


def _wayland_session(pkg, path, controller):
    """One package's client against the compositor: its requests, the
    pixels in the shared buffer it passed, the decoded requests."""
    import mmap
    import struct

    fake = RecordingCompositor(path)
    try:
        backend = pkg["wl"].WaylandBackend(display=path)
        if controller:
            bus = pkg["bus"]()
            s = pkg["settings"].AppSettings()
            s.overlay_position = pkg["settings"].OverlayPosition.BOTTOM
            ov = pkg["x11"].X11Overlay(bus, lambda: s, backend=backend)
            assert ov.active
            for name, payload in OVERLAY_EVENTS:
                bus.emit(name, payload)
            thread = ov._thread
            ov.close()
            thread.join(timeout=10)
        else:
            assert backend.open()
            backend.create_window(874, 4, 172, 36, 0xE05F5F)
            backend.map()
            backend.fill_rect(0xFFFFFF, 10, 10, 4, 20)
            backend.flush()
            backend.set_background(0xE0A63F)
            backend.move(874, 1000)
            backend.unmap()
            backend.close()
        fake.thread.join(timeout=10)
        assert not fake.thread.is_alive()
        w, h, stride, fmt = fake.buffer_meta
        mm = mmap.mmap(fake.shm_fd, h * stride)
        pixels = bytes(mm)
        mm.close()
        os.close(fake.shm_fd)
        first = struct.unpack_from("<I", pixels, 0)[0]
    finally:
        fake.close()
    return fake.raw, pixels, fake.requests, first


@pytest.mark.parametrize("controller", [False, True], ids=["backend", "controller"])
def test_wayland_requests_match(tmp_path, controller):
    want = _wayland_session(JAX, str(tmp_path / "wj"), controller)
    got = _wayland_session(PORT, str(tmp_path / "wt"), controller)
    assert got == want
    raw, pixels, requests, first = got
    # One pool, its memfd passed over SCM_RIGHTS (the pixels were read
    # through the fd the compositor received).
    pools = [a for iface, name, a in requests if name == "create_pool"]
    assert len(pools) == 1 and pools[0][1] == 172 * 36 * 4
    assert len(pixels) == 172 * 36 * 4 and first & 0xFF000000 == 0xFF000000
    assert t_wl.marshal_string("spittle-overlay") == j_wl.marshal_string("spittle-overlay")


def test_wayland_without_a_compositor(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_RUNTIME_DIR", str(tmp_path))
    for mod in (t_wl, j_wl):
        assert mod.WaylandBackend(display="wayland-none").open() is False
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert t_wl.attach_wayland_overlay(None) is None


# -- overlay selection ------------------------------------------------------------

SESSIONS = [
    dict(XDG_SESSION_TYPE=st, WAYLAND_DISPLAY=wd, DISPLAY=dp, XDG_CURRENT_DESKTOP=de,
         DESKTOP_SESSION=ds)
    for st in (None, "x11", "wayland", "Wayland")
    for wd in (None, "wayland-1")
    for dp in (None, ":0")
    for de, ds in ((None, None), ("GNOME", None), ("KDE", None), (None, "plasma"),
                   ("ubuntu:GNOME", "ubuntu"))
]


def _pick(pkg, env, wayland_answers, monkeypatch):
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    arms = []
    monkeypatch.setattr(pkg["wl"], "attach_wayland_overlay",
                        lambda services: arms.append("wayland") or (
                            "wayland-overlay" if wayland_answers else None))
    monkeypatch.setattr(pkg["x11"], "attach_overlay",
                        lambda services: arms.append("x11") or (
                            "x11-overlay" if os.environ.get("DISPLAY") else None))
    got = pkg["select"].attach_session_overlay(object())
    return arms, got, pkg["wl"].session_is_kde_wayland()


@pytest.mark.parametrize("wayland_answers", [True, False], ids=["wl_up", "wl_down"])
def test_overlay_selection_matches(wayland_answers, monkeypatch):
    monkeypatch.setattr(sys, "platform", "linux")
    seen = set()
    for env in SESSIONS:
        want = _pick(JAX, env, wayland_answers, monkeypatch)
        got = _pick(PORT, env, wayland_answers, monkeypatch)
        assert got == want, env
        seen.add(tuple(got[0]))
    assert seen == {("x11",), ("wayland",) if wayland_answers else ("wayland", "x11")}


@pytest.mark.parametrize("platform", ["win32", "darwin"])
def test_overlay_platform_arms_raise(platform, monkeypatch):
    monkeypatch.setattr(sys, "platform", platform)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1b item 1"):
        t_select.attach_session_overlay(object())
