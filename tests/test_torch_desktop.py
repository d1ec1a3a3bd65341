"""The port's desktop assembly, autostart and link probe
(spittle_tpu_torch/app/desktop.py, shell/autostart.py, utils/linkprobe.py)
against the JAX package's on the CPU:

- the autostart desktop entry and LaunchAgent equal but for the `-m`
  module the launcher runs (the port's CLI);
- build_app(..., device="cpu", use_mock_engine=True) in both packages over
  an EvdevBackend on a pipe, a QueueSource and a BufferTextOutput: the
  same key bytes and PCM give the same pasted text, tray states, sounds,
  history and /events order (mic-level and history-updated left out,
  as ROADMAP's kept behaviours say);
- shutdown closes every surface: the hotkey listener, the RPC server, and
  a tray and an overlay attached over a fake session bus and a fake
  Wayland compositor;
- build_app raises NotImplementedError on macOS and Windows, and raises
  without a card unless asked for the CPU, as run_app and the link probe
  do; measure_link_mbps on the CPU returns a positive rate.
"""

import os
import plistlib
import socket
import sys
import time

import numpy as np
import pytest
import torch

from spittle_tpu.app import desktop as j_desktop
from spittle_tpu.audio.recorder import QueueSource as JQueueSource
from spittle_tpu.config.settings import KeyboardImplementation as JImpl
from spittle_tpu.pipeline import BufferTextOutput as JOut
from spittle_tpu.shell import autostart as j_autostart
from spittle_tpu.shell import evdev_keys as j_evdev
from spittle_tpu_torch.app import desktop as t_desktop
from spittle_tpu_torch.audio.recorder import QueueSource as TQueueSource
from spittle_tpu_torch.config.settings import KeyboardImplementation as TImpl
from spittle_tpu_torch.pipeline import BufferTextOutput as TOut
from spittle_tpu_torch.shell import autostart as t_autostart
from spittle_tpu_torch.shell import evdev_keys as t_evdev
from spittle_tpu_torch.utils.linkprobe import measure_link_mbps

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_rpc_server import Events  # noqa: E402
from test_torch_shell_dbus_overlay import FakeBus, RecordingCompositor  # noqa: E402

JAX = dict(desktop=j_desktop, queue=JQueueSource, impl=JImpl, out=JOut,
           autostart=j_autostart, evdev=j_evdev, kw={})
PORT = dict(desktop=t_desktop, queue=TQueueSource, impl=TImpl, out=TOut,
            autostart=t_autostart, evdev=t_evdev, kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def headless(monkeypatch):
    """No session bus, display or compositor unless a test makes one."""
    for k in ("DBUS_SESSION_BUS_ADDRESS", "DISPLAY", "WAYLAND_DISPLAY",
              "XDG_SESSION_TYPE"):
        monkeypatch.delenv(k, raising=False)


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# -- autostart -------------------------------------------------------------------

def _port_module(text):
    return text.replace("spittle_tpu_torch.cli", "spittle_tpu.cli")


@pytest.mark.parametrize("data_dir", [None, "/home/u/app data", '/x/"q"'])
def test_autostart_entries_match(tmp_path, data_dir):
    jcmd, tcmd = j_autostart.default_exec_cmd(data_dir), t_autostart.default_exec_cmd(data_dir)
    assert tcmd[1:3] == ["-m", "spittle_tpu_torch.cli"]
    assert [_port_module(a) for a in tcmd] == jcmd
    assert (t_autostart.APP_ID, t_autostart.APP_NAME) == (j_autostart.APP_ID,
                                                          j_autostart.APP_NAME)
    for platform in ("linux", "darwin"):
        files = {}
        for name, mod, cmd in (("jax", j_autostart, jcmd), ("port", t_autostart, tcmd)):
            home = tmp_path / name / platform
            mgr = mod.AutostartManager(cmd, home=str(home), platform=platform)
            assert not mgr.is_enabled()
            mgr.reconcile(True)
            assert mgr.is_enabled()
            path = mgr.entry_path()
            files[name] = (os.path.relpath(path, home), open(path, "rb").read())
            mgr.reconcile(False)
            assert not mgr.is_enabled() and not os.path.exists(path)
            mgr.disable()
        (jpath, jdata), (tpath, tdata) = files["jax"], files["port"]
        assert tpath == jpath
        if platform == "darwin":
            tplist = plistlib.loads(tdata)
            tplist["ProgramArguments"] = [_port_module(a)
                                          for a in tplist["ProgramArguments"]]
            assert tplist == plistlib.loads(jdata)
        else:
            assert tdata != jdata
            assert _port_module(tdata.decode()) == jdata.decode()


# -- the desktop loop ------------------------------------------------------------

def _pcm():
    t = np.arange(1600) / 16000
    return (0.1 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)


def _build(pkg, data_dir, **extra):
    r, w = os.pipe()
    be = pkg["evdev"].EvdevBackend(fds=[r])
    src = pkg["queue"](16000)
    out = pkg["out"]()
    played = []
    app = pkg["desktop"].build_app(
        str(data_dir), port=0, output=out, source_factory=lambda: src,
        use_mock_engine=True, backends={pkg["impl"].HANDY_KEYS: be},
        player=lambda path, vol: played.append((os.path.basename(path), vol)),
        autostart=pkg["autostart"].AutostartManager(home=str(data_dir)),
        **pkg["kw"], **extra)
    app.services.transcription.load_model("mock", "/fake", "whisper")
    app.services.transcription._engine.canned_text = "typed by hotkey"
    return app, be, w, src, out, played


def _settle(*logs, quiet=0.3, timeout=30.0):
    """Wait until none of the lists has grown for `quiet` seconds."""
    deadline = time.monotonic() + timeout
    sizes = None
    while True:
        now = tuple(len(log() if callable(log) else log) for log in logs)
        if now == sizes:
            return
        assert time.monotonic() < deadline, "the app kept emitting"
        sizes = now
        time.sleep(quiet)


def _cycle(pkg, app, w, src, press, release, n_chunks, cancel=False):
    k = pkg["evdev"].pack_key
    os.write(w, b"".join(k(n, True) for n in press))
    _wait(app.services.audio.is_recording, "recording")
    for _ in range(n_chunks):
        src.push(_pcm())
    if cancel:
        os.write(w, k("escape", True))
        _wait(lambda: not app.services.audio.is_recording(), "the cancel")
        os.write(w, k("escape", False))
    os.write(w, b"".join(k(n, False) for n in release))
    _wait(lambda: not app.services.audio.is_recording(), "the release")


def _desktop_session(pkg, data_dir):
    """Two push-to-talk cycles and a cancelled one through the hotkey wire:
    the pasted text, tray states, sounds, history and /events names."""
    app, be, w, src, out, played = _build(pkg, data_dir)
    trays = []
    app.services.events.listen("tray-state-changed", trays.append)
    app.services.update_settings(audio_feedback=True)
    app.rpc.start()
    host = "%s:%d" % app.rpc.address[:2]
    events = Events(host)
    try:
        time.sleep(0.2)  # the stream attached before the first press
        _cycle(pkg, app, w, src, ("ctrl", "space"), ("space", "ctrl"), 6)
        _wait(lambda: out.buffer.count("typed by hotkey") == 1, "the first paste")
        _wait(lambda: trays[-2:] == ["idle", "idle"], "the first cycle's end")
        _settle(trays, events.snapshot)
        _cycle(pkg, app, w, src, ("ctrl", "shift", "space"),
               ("space", "shift", "ctrl"), 4)
        _wait(lambda: out.buffer.count("typed by hotkey") == 2, "the second paste")
        _wait(lambda: trays[-2:] == ["idle", "idle"] and len(trays) >= 8,
              "the second cycle's end")
        _settle(trays, events.snapshot)
        _cycle(pkg, app, w, src, ("ctrl", "space"), ("space", "ctrl"), 2, cancel=True)
        _wait(lambda: trays[-1] == "idle", "the cancel's end")
        _settle(trays, events.snapshot)
        names = [n for n, _ in events.snapshot()
                 if n not in ("mic-level", "history-updated")]
    finally:
        events.close()
        history = [(e.transcription_text, e.post_processed_text)
                   for e in app.services.history.get_history_entries()]
        app.shutdown()
        os.close(w)
    return out.buffer, trays, played, history, names


def test_desktop_loop_matches_the_jax_app(tmp_path):
    want = _desktop_session(JAX, tmp_path / "jax")
    got = _desktop_session(PORT, tmp_path / "port")
    assert got == want
    buffer, trays, played, history, names = got
    assert buffer.count("typed by hotkey") == 2
    assert trays[:3] == ["recording", "transcribing", "idle"]
    assert "show-overlay" in names and "tray-state-changed" in names


def test_registry_bound_from_settings(tmp_path):
    bound = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        app, be, w, *_ = _build(pkg, tmp_path / name)
        try:
            bound[name] = {k: (b.id, b.current_binding) if hasattr(b, "id") else b
                           for k, b in app.registry._bindings.items()}
            bound[name + " impl"] = app.registry.implementation.value
        finally:
            app.shutdown()
            os.close(w)
    assert bound["port"] == bound["jax"]
    assert bound["port impl"] == bound["jax impl"]
    assert set(bound["port"]) >= {"transcribe", "transcribe_with_post_process", "cancel"}


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_shutdown_closes_every_surface(pkg, tmp_path, monkeypatch):
    """A tray on a fake session bus and a Wayland overlay on a fake
    compositor are attached by build_app; shutdown closes them, the
    hotkey listener and the RPC server."""
    bus = FakeBus(str(tmp_path / "bus"))
    compositor = RecordingCompositor(str(tmp_path / "wayland-0"))
    monkeypatch.setenv("DBUS_SESSION_BUS_ADDRESS", bus.address)
    monkeypatch.setenv("XDG_SESSION_TYPE", "wayland")
    monkeypatch.setenv("XDG_CURRENT_DESKTOP", "GNOME")
    monkeypatch.setenv("WAYLAND_DISPLAY", compositor.path)
    try:
        app, be, w, *_ = _build(pkg, tmp_path / "data")
        try:
            assert app.tray is not None and app.tray.registered
            assert app.overlay is not None and app.overlay.active
            app.rpc.start()
            addr = app.rpc.address[:2]
            listener = be.listener._thread
            assert listener is not None and listener.is_alive()
        finally:
            app.shutdown()
            os.close(w)
        bus.thread.join(timeout=10)
        compositor.thread.join(timeout=10)
        assert not bus.thread.is_alive(), "the tray's bus connection is open"
        assert not compositor.thread.is_alive(), "the overlay's connection is open"
        assert not listener.is_alive() and be.listener._thread is None
        with pytest.raises(OSError):
            socket.create_connection(addr, timeout=2).close()
    finally:
        bus.close()
        compositor.close()


@pytest.mark.parametrize("platform", ["darwin", "win32"])
@pytest.mark.parametrize("with_backends", [False, True])
def test_build_app_raises_on_macos_and_windows(platform, with_backends, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(sys, "platform", platform)
    kw = {"backends": {TImpl.TAURI: None}} if with_backends else {}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1b item 1"):
        t_desktop.build_app(str(tmp_path), port=0, use_mock_engine=True,
                            device="cpu", **kw)
    assert not os.listdir(tmp_path)  # nothing was built


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_desktop.build_app(str(tmp_path / "a"), port=0, use_mock_engine=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_desktop.run_app(str(tmp_path / "b"), port=0, use_mock_engine=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_link_mbps(size_mb=1, reps=1)


def test_link_probe_on_the_cpu():
    mbps = measure_link_mbps(size_mb=1, reps=2, device="cpu")
    assert isinstance(mbps, float) and mbps > 0
