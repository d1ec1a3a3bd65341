"""The port's RPC server (spittle_tpu_torch/app/rpc_server.py) against the
JAX package's on the CPU: one scripted frontend session driven over HTTP
against each package's live app graph (AppServices with the MockEngine,
the port's on device="cpu", an AppUi whose player records): the read
routes, a settings change, a model download from a local HTTP server with
its progress events, a push-to-talk cycle over /shortcut on the
post-process binding, a history read and /history_audio. The JSON
answers must be equal once data paths, times and file names are masked,
and so must the /events stream's order. Also: every rpc("...") in the
port's console page resolves to a port Commands method."""

import http.client
import http.server
import io
import json
import os
import re
import socket
import sys
import threading
import time
import wave
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spittle_tpu.app import actions as j_actions
from spittle_tpu.app import commands as j_commands
from spittle_tpu.app import rpc_server as j_rpc
from spittle_tpu.app import services as j_services
from spittle_tpu.app import ui_state as j_ui
from spittle_tpu.audio import recorder as j_recorder
from spittle_tpu.config import catalog as j_catalog
from spittle_tpu import pipeline as j_pipeline
from spittle_tpu_torch.app import actions as t_actions
from spittle_tpu_torch.app import commands as t_commands
from spittle_tpu_torch.app import rpc_server as t_rpc
from spittle_tpu_torch.app import services as t_services
from spittle_tpu_torch.app import ui_state as t_ui
from spittle_tpu_torch.audio import recorder as t_recorder
from spittle_tpu_torch.config import catalog as t_catalog
from spittle_tpu_torch import pipeline as t_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WEB = os.path.join(REPO, "spittle_tpu_torch", "app", "web")

JAX = SimpleNamespace(actions=j_actions, commands=j_commands, rpc=j_rpc,
                      services=j_services, ui=j_ui, recorder=j_recorder,
                      catalog=j_catalog, pipeline=j_pipeline, kw={})
PORT = SimpleNamespace(actions=t_actions, commands=t_commands, rpc=t_rpc,
                       services=t_services, ui=t_ui, recorder=t_recorder,
                       catalog=t_catalog, pipeline=t_pipeline, kw={"device": "cpu"})

# The /events names of one push-to-talk cycle on the post-process binding
# with a UI bundle, from the press to the pipeline's end: the overlay and
# the tray through recording, transcribing and processing, then hidden
# and idle (the pipeline's hook, then its thread's finally). mic-level
# (one per recorder chunk, timing-bound) and history-updated (written on
# a thread of its own) are left out and checked apart. chip_smoke.py's
# "command surface" phase holds the card's run to the same order.
PTT_EVENTS = ["show-overlay", "tray-state-changed", "tray-state-changed",
              "show-overlay", "show-overlay", "hide-overlay",
              "tray-state-changed", "tray-state-changed"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class PayloadHandler(http.server.BaseHTTPRequestHandler):
    payload = b"W" * 300_000

    def do_GET(self):
        if self.path != "/tiny.bin":
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.payload)))
        self.end_headers()
        self.wfile.write(self.payload)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def model_server():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), PayloadHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


def _request(host, method, path, body=None):
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


class Events:
    """The /events stream read on a thread: (name, payload) pairs."""

    def __init__(self, host):
        self.items, self._lock = [], threading.Lock()
        self._conn = http.client.HTTPConnection(host, timeout=60)
        self._conn.request("GET", "/events")
        self._sock = self._conn.sock  # the response takes it over
        self._resp = self._conn.getresponse()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        name = None
        try:
            for raw in iter(self._resp.fp.readline, b""):
                line = raw.decode().rstrip("\n")
                if line.startswith("event: "):
                    name = line[7:]
                elif line.startswith("data: ") and name:
                    with self._lock:
                        self.items.append((name, json.loads(line[6:])))
                    name = None
        except (OSError, ValueError):
            pass  # the server closed the stream

    def snapshot(self):
        with self._lock:
            return list(self.items)

    def close(self):
        self._sock.shutdown(socket.SHUT_RDWR)
        self._resp.close()
        self._thread.join(timeout=5)


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _collapse(names):
    """Consecutive repeats of a name folded into one."""
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


def session(pkg, data_dir, model_url):
    """The scripted frontend session against one package's server. Returns
    (the masked answers in order, the event pairs, the pasted text, the
    WAV /history_audio served, the sounds played)."""
    catalog = pkg.catalog.ModelCatalog(
        language_groups={"english_only": ["en"]},
        models=[pkg.catalog.ModelCatalogEntry(
            id="tiny-rpc", name="Tiny", description="", filename="tiny.bin",
            url=f"{model_url}/tiny.bin", size_mb=1, is_directory=False,
            engine_type="whisper", accuracy_score=0.5, speed_score=0.9,
            supports_translation=False, is_recommended=False,
            language_group="english_only")])
    src = pkg.recorder.QueueSource(16000)
    services = pkg.services.AppServices(str(data_dir), source_factory=lambda: src,
                                        use_mock_engine=True, catalog=catalog, **pkg.kw)
    played = []
    out = pkg.pipeline.BufferTextOutput()
    actions = pkg.actions.ActionContext(
        services, out, ui=pkg.ui.AppUi(services, player=lambda p, v: played.append(
            (os.path.basename(p), v))))
    server = pkg.rpc.AppRpcServer(pkg.commands.Commands(services, actions))
    server.start()
    host = server.url.split("//")[1]
    answers = []

    def note(status, ctype, body):
        if ctype == "application/json":
            text = body.decode().replace(str(data_dir), "<DATA>")
            text = re.sub(r"rec_\d+_\d+\.wav", "<WAV>", text)
            text = re.sub(r'"timestamp": \d+', '"timestamp": 0', text)
            body = json.loads(text)
        elif ctype == "text/html; charset=utf-8":
            body = len(body)
        answers.append((status, ctype, body))
        return body

    def rpc(cmd, **args):
        return note(*_request(host, "POST", "/rpc", {"cmd": cmd, "args": args}))

    events = None
    try:
        events = Events(host)
        _wait(lambda: server._subscribers, "the event stream")
        for path in ("/healthz", "/bindings", "/settings_schema", "/i18n", "/",
                     "/overlay", "/nope"):
            note(*_request(host, "GET", path))
        rpc("getAppSettings")
        for cmd, args in (("changePttSetting", {"enabled": True}),
                          ("change_audio_feedback_setting", {"enabled": True}),
                          ("changePostProcessEnabledSetting", {"enabled": True}),
                          ("changeSelectedLanguageSetting", {"language": "en"})):
            rpc(cmd, **args)
        rpc("getAvailableModels")
        rpc("downloadModel", model_id="tiny-rpc")
        _wait(lambda: services.models.get_model_path("tiny-rpc"), "the download")
        _wait(lambda: any(n == "model-download-complete" for n, _ in events.snapshot()),
              "the download's last event")
        rpc("hasAnyModelsAvailable")
        rpc("setActiveModel", model_id="tiny-rpc")
        _wait(lambda: any(n == "model-state-changed" and p["event_type"] == "loaded"
                          for n, p in events.snapshot()), "the model load")
        services.transcription._engine.canned_text = "hello from the wire"
        n_before = len(events.snapshot())
        note(*_request(host, "POST", "/shortcut",
                       {"binding_id": "transcribe_with_post_process", "is_pressed": True}))
        rpc("isRecording")
        t = np.arange(24000) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        for i in range(0, len(audio), 480):
            src.push(audio[i:i + 480])
        _wait(lambda: any(n == "mic-level" for n, _ in events.snapshot()[n_before:]),
              "a mic level")
        note(*_request(host, "POST", "/shortcut",
                       {"binding_id": "transcribe_with_post_process", "is_pressed": False}))
        _wait(lambda: services.toggle_state.get("transcribe_with_post_process") is False,
              "the pipeline")
        _wait(lambda: any(n == "history-updated" for n, _ in events.snapshot()[n_before:]),
              "the history row")
        entries = rpc("getHistoryEntries")
        entry_id = entries["result"][0]["id"]
        rpc("toggleHistoryEntrySaved", entry_id=entry_id)
        status, ctype, wav = _request(host, "GET", f"/history_audio?entry_id={entry_id}")
        answers.append((status, ctype, len(wav)))
        note(*_request(host, "GET", "/history_audio?entry_id=99"))
        rpc("noSuchCommand")
        rpc("changeBinding", binding_id="nope", new_binding="x")
        rpc("getTranscriptionModelStatus")
        _wait(lambda: len([n for n, _ in events.snapshot()[n_before:]
                           if n == "tray-state-changed"]) == 4, "the tray's last state")
        ev = events.snapshot()
        return answers, ev, n_before, out.buffer, wav, played
    finally:
        if events is not None:
            events.close()
        server.stop()
        services.shutdown()


def test_scripted_session_matches_the_jax_server(tmp_path, model_server):
    got = session(PORT, tmp_path / "port", model_server)
    want = session(JAX, tmp_path / "jax", model_server)
    answers, ev, n_before, pasted, wav, played = got
    assert answers == want[0]
    assert (pasted, wav, played) == want[3:]

    def order(items):
        return _collapse([n for n, _ in items if n != "mic-level"])

    def payloads(items):
        """All but the download's progress (its count and byte counts follow
        the reads' timing) and the mic levels."""
        return [(n, p) for n, p in items
                if n not in ("mic-level", "model-download-progress")]
    assert order(ev) == order(want[1])
    assert payloads(ev) == payloads(want[1])

    # The cycle: the pinned order, the history row, the paste and sounds.
    for items, start in ((ev, n_before), (want[1], want[2])):
        cycle = [n for n, _ in items[start:] if n not in ("mic-level", "history-updated")]
        assert cycle == PTT_EVENTS
    # One history row saved, then toggled over the wire.
    assert [n for n, _ in ev[n_before:]].count("history-updated") == 2
    assert [n for n, _ in ev[n_before:]].count("mic-level") >= 1
    assert pasted == "hello from the wire"
    assert played == [("marimba_start.wav", 1.0), ("marimba_stop.wav", 1.0)]
    names = [n for n, _ in ev[:n_before]]
    assert names.count("settings-changed") == 4
    assert _collapse(names).count("model-download-progress") == 1
    assert "model-download-complete" in names and "model-state-changed" in names
    # The served WAV holds the recorded samples: 1.5 s of the tone.
    with wave.open(io.BytesIO(wav)) as w:
        assert w.getnframes() == 24000 and w.getframerate() == 16000
    with open(os.path.join(WEB, "index.html"), "rb") as f:
        assert answers[4] == (200, "text/html; charset=utf-8", len(f.read()))
    with open(os.path.join(WEB, "overlay.html"), "rb") as f:
        assert answers[5] == (200, "text/html; charset=utf-8", len(f.read()))
    assert len(answers[1][2]) == 107 and len(answers[3][2]) == 17
    assert answers[6][0] == 404


def test_chip_smoke_pins_the_same_cycle():
    import chip_smoke

    assert chip_smoke.PTT_EVENTS == PTT_EVENTS


def test_console_rpc_calls_resolve_to_commands():
    with open(os.path.join(WEB, "index.html"), encoding="utf-8") as f:
        page = f.read()
    names = sorted(set(re.findall(r"""rpc\(\s*["']([A-Za-z_]+)["']""", page)))
    assert len(names) >= 20, names
    missing = [n for n in names
               if not callable(getattr(t_commands.Commands, t_rpc._camel_to_snake(n)
                                       if "_" not in n and not n.islower() else n, None))]
    assert not missing, missing


def test_web_pages_are_the_jax_packages():
    for page in ("index.html", "overlay.html"):
        with open(os.path.join(WEB, page), "rb") as a, open(
                os.path.join(REPO, "spittle_tpu", "app", "web", page), "rb") as b:
            assert a.read() == b.read(), page


@pytest.mark.parametrize("value", [None, 3, 2.5, "s", [1, (2, 3)], {"k": {1, }},
                                   np.arange(3), np.int64(4), np.float32(0.5)])
def test_jsonify(value):
    assert t_rpc.jsonify(value) == j_rpc.jsonify(value)
