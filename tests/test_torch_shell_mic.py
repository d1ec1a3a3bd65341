"""The port's microphone capture (spittle_tpu_torch/shell/mic.py) against
the JAX package's on the CPU, at exact equality: a fake capture process's
PCM through MicSource (f32 and i16, reads that split samples), each
capture tool's command line, the probe's errors, the source factory that
AppServices picks with and without a capture tool on PATH, and the
macOS (AudioQueue) and Windows (waveIn) capture arms with sys.platform
patched, over the fakes of tests/test_torch_shell_{macos,windows}.py."""

import ctypes
import importlib
import io
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

from spittle_tpu.app import services as j_services
from spittle_tpu.audio.recorder import AudioRecorder as JRecorder
from spittle_tpu.audio.recorder import QueueSource as JQueueSource
from spittle_tpu.shell import mic as j_mic
from spittle_tpu_torch.app import services as t_services
from spittle_tpu_torch.audio.recorder import AudioRecorder as TRecorder
from spittle_tpu_torch.audio.recorder import QueueSource as TQueueSource
from spittle_tpu_torch.shell import mic as t_mic

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_shell_macos import compile_fake as macos_fake  # noqa: E402
from test_torch_shell_windows import compile_fake as windows_fake  # noqa: E402

ALL_TOOLS = lambda name: "/usr/bin/" + name  # noqa: E731


class FakeProc:
    """Subprocess stand-in: stdout yields PCM in blocks of `chunk` bytes,
    then EOF; an optional gate holds the stream until it is set."""

    def __init__(self, pcm: bytes, chunk: int, gate=None):
        self._buf = io.BytesIO(pcm)
        self._chunk = chunk
        self._gate = gate
        self.terminated = False
        self.stdout = self
        self.stderr = None

    def read(self, n: int) -> bytes:
        if self._gate is not None:
            self._gate.wait(timeout=10)
        return self._buf.read(min(n, self._chunk))

    def terminate(self):
        self.terminated = True

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return 0


def _pcm(fmt: str) -> bytes:
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, 5003).astype(np.float32)
    if fmt == "f32":
        return x.astype("<f4").tobytes()
    return (x * 32767).astype("<i2").tobytes()


def _drain(src, timeout=10.0):
    """Every sample the source yields, up to its end: read() until it
    answers None and a second read finds nothing left (the JAX MicSource
    can answer None while the reader's last block is still in its ring)."""
    got = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        chunk = src.read(timeout=0.2)
        if chunk is None:
            chunk = src.read(timeout=0.0)
            if chunk is None:
                break
        if len(chunk):
            got.append(chunk)
    return np.concatenate(got) if got else np.zeros(0, np.float32)


@pytest.mark.parametrize("tool,fmt", [("parec", "f32"), ("arecord", "i16")])
@pytest.mark.parametrize("chunk", [7, 1000, 4096])
def test_mic_source_samples_match(tool, fmt, chunk, monkeypatch):
    monkeypatch.setattr(shutil, "which", ALL_TOOLS)
    pcm = _pcm(fmt)
    out = {}
    for name, mod in (("jax", j_mic), ("port", t_mic)):
        procs = []

        def popen(cmd):
            procs.append(cmd)
            return FakeProc(pcm, chunk)

        src = mod.MicSource(tool=tool, popen=popen)
        out[name] = _drain(src)
        assert src.tool_name == tool and src.sample_rate == 16000
        src.close()
        assert src._proc.terminated
        out[name + " cmd"] = procs
    assert out["port cmd"] == out["jax cmd"]
    assert out["port"].dtype == out["jax"].dtype == np.float32
    assert len(out["port"]) == len(pcm) // (4 if fmt == "f32" else 2)
    np.testing.assert_array_equal(out["port"], out["jax"])


def test_mic_through_the_recorder_matches(monkeypatch):
    """Fake process -> MicSource -> AudioRecorder in each package: the same
    recorded samples (the stream released once recording is active)."""
    monkeypatch.setattr(shutil, "which", ALL_TOOLS)
    t = np.arange(8000) / 16000.0
    pcm = (0.25 * np.sin(2 * np.pi * 440 * t)).astype("<f4").tobytes()
    out = {}
    for name, mod, rec_cls in (("jax", j_mic, JRecorder), ("port", t_mic, TRecorder)):
        gate = threading.Event()
        src = mod.MicSource(popen=lambda cmd: FakeProc(pcm, 1000, gate=gate))
        rec = rec_cls(src)
        rec.open()
        rec.start()
        gate.set()
        deadline = time.monotonic() + 10
        while not src._eof.is_set() and time.monotonic() < deadline:
            time.sleep(0.01)
        out[name] = rec.stop()
        rec.close()
        src.close()
    assert len(out["port"]) >= 8000 - 480
    np.testing.assert_array_equal(out["port"], out["jax"])


@pytest.mark.parametrize("platform", ["linux", "darwin"])
def test_capture_tool_commands_match(platform, monkeypatch):
    monkeypatch.setattr(sys, "platform", platform)
    assert [t.name for t in t_mic.CAPTURE_TOOLS] == [t.name for t in j_mic.CAPTURE_TOOLS]
    assert [t.fmt for t in t_mic.CAPTURE_TOOLS] == [t.fmt for t in j_mic.CAPTURE_TOOLS]
    for ours, ref in zip(t_mic.CAPTURE_TOOLS, j_mic.CAPTURE_TOOLS):
        for rate in (8000, 16000, 44100, 48000):
            for device in (None, "", "usb-mic", "alsa_input.pci-0000_00_1f.3"):
                assert ours.command(rate, device) == ref.command(rate, device)
    with pytest.raises(ValueError) as want:
        j_mic.CaptureTool("sox", "f32").command(16000, None)
    with pytest.raises(ValueError) as got:
        t_mic.CaptureTool("sox", "f32").command(16000, None)
    assert str(got.value) == str(want.value)


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return type(e).__name__, str(e)
    return None


def test_probe_errors_match(monkeypatch):
    for which in (lambda n: None, lambda n: "/bin/arecord" if n == "arecord" else None,
                  ALL_TOOLS):
        monkeypatch.setattr(shutil, "which", which)
        assert t_mic.probe_capture_tools() == j_mic.probe_capture_tools()
        for preferred in (None, "parec", "arecord", "ffmpeg", "sox-but-wrong"):
            want = _raised(j_mic.pick_capture_tool, preferred)
            assert _raised(t_mic.pick_capture_tool, preferred) == want
            if want is None:
                assert (t_mic.pick_capture_tool(preferred).name
                        == j_mic.pick_capture_tool(preferred).name)
    monkeypatch.setattr(shutil, "which", lambda n: None)
    assert _raised(t_mic.MicSource) == _raised(j_mic.MicSource)
    assert "probed: parec" in _raised(t_mic.MicSource)[1]


@pytest.mark.parametrize("found", [True, False], ids=["capture_tool", "headless"])
def test_default_source_factory_matches(found, tmp_path, monkeypatch):
    """AppServices' default source factory: the mic factory when a capture
    tool is on PATH, a QueueSource when none is, in both packages."""
    monkeypatch.setattr(shutil, "which",
                        (lambda n: "/usr/bin/parec" if n == "parec" else None)
                        if found else (lambda n: None))
    kinds = {}
    for name, mod, queue_cls, kw in (
            ("jax", j_services, JQueueSource, {}),
            ("port", t_services, TQueueSource, {"device": "cpu"})):
        svc = mod.AppServices(str(tmp_path / name), use_mock_engine=True, **kw)
        try:
            fac = svc.audio._source_factory
            if found:
                kinds[name] = fac.__qualname__
            else:
                src = fac()
                assert isinstance(src, queue_cls)
                kinds[name] = type(src).__name__
        finally:
            svc.shutdown()
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"] == ("make_mic_source_factory.<locals>.factory" if found
                             else "QueueSource")


def test_mic_factory_opens_the_selected_device(monkeypatch):
    """make_mic_source_factory hands the device getter's answer and the
    tool to MicSource on Linux, as the JAX factory does."""
    monkeypatch.setattr(shutil, "which", ALL_TOOLS)
    seen = {}
    for name, mod in (("jax", j_mic), ("port", t_mic)):
        cmds = []
        real = mod.MicSource

        def spy(device=None, tool=None, _real=real, _cmds=cmds):
            return _real(device=device, tool=tool,
                         popen=lambda c: (_cmds.append(c), FakeProc(b"", 1))[1])

        monkeypatch.setattr(mod, "MicSource", spy)
        src = mod.make_mic_source_factory(lambda: "usb-mic", tool="arecord")()
        src.close()
        seen[name] = cmds
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][-2:] == ["-D", "usb-mic"]


@pytest.fixture(scope="module")
def native_fakes(tmp_path_factory):
    """The AudioQueue and waveIn fakes of tests/test_torch_shell_{macos,
    windows}.py, built once for this module."""
    d = tmp_path_factory.mktemp("native_capture")
    return {"darwin": macos_fake(d), "win32": windows_fake(d)}


def _native_arm(pkg, platform, tool, lib, monkeypatch):
    """The package's mic factory with sys.platform patched, its native
    source over the fake: the class it opened, the PCM fed through the
    driver callback as read, the fake's closing calls, and what the factory
    does when the native source cannot open."""
    mic = importlib.import_module(f"{pkg}.shell.mic")
    name, module = (("MacMicSource", "macos_mic") if platform == "darwin"
                    else ("WinMicSource", "windows_mic"))
    native = importlib.import_module(f"{pkg}.shell.{module}")
    base = getattr(native, name)
    kw = {"lib": lib} if platform == "darwin" else {"winmm": lib}
    monkeypatch.setattr(sys, "platform", platform)
    monkeypatch.setattr(native, name, type(name, (base,), {
        "__init__": lambda self: base.__init__(self, **kw)}))
    factory = mic.make_mic_source_factory(lambda: "usb-mic", tool=tool)
    lib.fake_reset()
    src = factory()
    if platform == "darwin":
        pcm = np.random.default_rng(5).uniform(-0.9, 0.9, 700).astype(np.float32)
        lib.fake_aq_feed(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pcm))
    else:
        pcm = np.random.default_rng(5).integers(-32768, 32767, 700).astype(np.int16)
        lib.fake_wi_feed(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(pcm))
    got = src.read(timeout=1.0)
    src.close()
    closed = ((lib.fake_aq_stops(), lib.fake_aq_disposes()) if platform == "darwin"
              else (lib.fake_wi_stops(), lib.fake_wi_resets(), lib.fake_wi_closes()))

    def refuse(self):
        raise OSError("no capture device")
    monkeypatch.setattr(native, name, type(name, (base,), {"__init__": refuse}))
    monkeypatch.setattr(mic, "MicSource", lambda device=None, tool=None:
                        ("MicSource", device, tool))
    fallback = _raised(factory) or factory()
    return (type(src).__mro__[1].__module__.split(".", 1)[1], src.tool_name,
            pcm.tobytes(), got.tobytes(), closed, fallback)


@pytest.mark.parametrize("platform,tool", [("darwin", None), ("darwin", "audioqueue"),
                                           ("win32", None), ("win32", "wavein")])
def test_native_capture_arms(platform, tool, native_fakes, monkeypatch):
    """On macOS and Windows the factory opens MacMicSource / WinMicSource
    (AudioQueue / waveIn) in each package, over the same fake, with the
    same PCM at read() and the same closing calls; when the native source
    cannot open, the factory falls back to a capture tool unless that
    source was asked for by name."""
    monkeypatch.setattr(shutil, "which", ALL_TOOLS)
    got = {pkg: _native_arm(pkg, platform, tool, native_fakes[platform], monkeypatch)
           for pkg in ("spittle_tpu", "spittle_tpu_torch")}
    assert got["spittle_tpu_torch"] == got["spittle_tpu"]
    module, name, pcm, read, closed, fallback = got["spittle_tpu_torch"]
    if platform == "darwin":
        assert (module, name, read, closed) == ("shell.macos_mic", "audioqueue", pcm, (1, 1))
    else:
        want = (np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0).tobytes()
        assert (module, name, read, closed) == ("shell.windows_mic", "wavein", want,
                                                (1, 1, 1))
    assert fallback == (("MicSource", "usb-mic", None) if tool is None
                        else ("OSError", "no capture device"))


FAKE_PAREC = """#!{python}
import os, sys, time
with open({pids!r}, "a") as f:
    f.write(str(os.getpid()) + "\\n")
while True:
    sys.stdout.buffer.write(bytes(3200))
    sys.stdout.flush()
    time.sleep(0.05)
"""


def _running(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _readers():
    return [t for t in threading.enumerate() if t.name == "mic-reader" and t.is_alive()]


def test_manager_closes_each_capture_process(tmp_path, monkeypatch):
    """Two push-to-talk recordings and a shutdown through each package's
    AudioRecordingManager over the mic factory, with a fake `parec` first
    on PATH: the port's manager closes each stream's source with the
    stream, so no capture process and no reader thread is left; the JAX
    package's leaves one of each per recording (its _close_stream closes
    the recorder only)."""
    from spittle_tpu.managers import audio as j_audio
    from spittle_tpu_torch.managers import audio as t_audio

    bindir = tmp_path / "bin"
    bindir.mkdir()
    parec = bindir / "parec"
    pids = tmp_path / "pids"
    parec.write_text(FAKE_PAREC.format(python=sys.executable, pids=str(pids)))
    parec.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    left = {}
    try:
        for name, audio, mic in (("port", t_audio, t_mic), ("jax", j_audio, j_mic)):
            before = pids.read_text().split() if pids.exists() else []
            readers = len(_readers())
            mgr = audio.AudioRecordingManager(
                source_factory=mic.make_mic_source_factory(tool="parec"))
            try:
                for binding in ("transcribe", "transcribe_with_post_process"):
                    assert mgr.try_start_recording(binding)
                    time.sleep(0.3)
                    assert mgr.stop_recording(binding) is not None
            finally:
                mgr.shutdown()
            started = [int(p) for p in pids.read_text().split()[len(before):]]
            assert len(started) == 2, started
            time.sleep(0.1)
            left[name] = ([p for p in started if _running(p)],
                          len(_readers()) - readers)
        assert left["port"] == ([], 0)
        assert len(left["jax"][0]) == 2 and left["jax"][1] == 2
    finally:
        for pid in (int(p) for p in pids.read_text().split()) if pids.exists() else ():
            if _running(pid):
                os.kill(pid, 15)
        for t in _readers():
            t.join(timeout=5)
