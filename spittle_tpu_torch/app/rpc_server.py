"""Wire transport for the command surface: the Tauri-IPC analog.

Port of spittle_tpu/app/rpc_server.py.

The reference exposes its ~106 commands over Tauri IPC with typed bindings
(`src-tauri/src/lib.rs:254-361`, `src/bindings.ts`) and
pushes events to the webview with `app.emit(...)`. This server exposes the
SAME contract over HTTP so a real frontend (or the preserved bindings.ts
with a fetch-based transport shim) can drive the live services graph:

  POST /rpc        {"cmd": "<snake or camelCase name>", "args": {...}|[...]}
                   -> {"ok": true, "result": ...} | {"ok": false, "error"}
  GET  /events     Server-Sent Events stream of every EventBus emission
                   (`event: <name>`, `data: <json payload>`), the analog of
                   the webview event channel (SURVEY §2.7 names).
  GET  /bindings   the typed command description (bindings_export JSON) —
                   what tauri-specta generates at build time.
  POST /shortcut   {"binding_id", "hotkey", "is_pressed"} — drives
                   handle_shortcut_event, the wire analog of the OS global
                   hotkey (shortcut/handler.rs:28) for remote shells.

stdlib-only (ThreadingHTTPServer); command handlers run on the request
thread, long work (downloads, transcription) happens on the services'
own worker threads exactly as it does under the desktop shell.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import queue
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from .commands import Commands


def jsonify(obj: Any) -> Any:
    """Recursively convert command results to JSON-encodable values
    (dataclasses, enums, numpy, paths)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: jsonify(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {str(k): jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return str(obj)


def _camel_to_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


class AppRpcServer:
    """Serves a Commands instance (and its ActionContext) over HTTP."""

    def __init__(
        self,
        commands: Commands,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.commands = commands
        self.events = commands.services.events
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._subscribers: list[queue.Queue] = []
        self._subs_lock = threading.Lock()
        self._unlisten = self.events.listen_all(self._fanout)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, payload) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> bytes:
                length = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(length)

            def do_GET(self):
                if self.path.startswith("/events"):
                    outer._stream_events(self)
                elif self.path == "/bindings":
                    from .bindings_export import export_json

                    data = export_json().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/settings_schema":
                    from .bindings_export import export_settings_schema

                    data = export_settings_schema().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/i18n":
                    # The full 17-locale app table (392 keys/locale,
                    # config/data/app_i18n.json) localizes the console
                    # (reference src/i18n/locales/*/translation.json).
                    from spittle_tpu_torch.config.i18n import load_app_i18n

                    data = json.dumps(
                        load_app_i18n(), ensure_ascii=False
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/history_audio"):
                    # Serve a history entry's recording for the console's
                    # playback button (reference history UI plays saved
                    # takes). Path validated through the command surface.
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        entry_id = int(q.get("entry_id", ["-1"])[0])
                        path = outer.commands.get_audio_file_path(entry_id)
                        with open(path, "rb") as f:
                            data = f.read()
                    except Exception as e:  # noqa: BLE001
                        self._json(404, {"ok": False, "error": str(e)})
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/healthz":
                    self._json(200, {"ok": True})
                elif self.path in ("/", "/index.html", "/overlay"):
                    # The operator console (web/index.html) and the
                    # dedicated recording-overlay view (web/overlay.html
                    # — the reference renders RecordingOverlay.tsx in
                    # its own webview window, overlay.rs): served over
                    # the same wire they drive.
                    import os as _os

                    page = _os.path.join(
                        _os.path.dirname(_os.path.abspath(__file__)),
                        "web",
                        "overlay.html" if self.path == "/overlay"
                        else "index.html",
                    )
                    try:
                        with open(page, "rb") as f:
                            data = f.read()
                    except OSError:
                        self._json(404, {"ok": False, "error": "no ui"})
                        return
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/html; charset=utf-8"
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._json(404, {"ok": False, "error": "not found"})

            def do_POST(self):
                try:
                    req = json.loads(self._body() or b"{}")
                except json.JSONDecodeError as e:
                    self._json(400, {"ok": False, "error": f"bad json: {e}"})
                    return
                if self.path == "/rpc":
                    outer._dispatch(self, req)
                elif self.path == "/shortcut":
                    try:
                        outer.commands.actions.handle_shortcut_event(
                            req["binding_id"],
                            req.get("hotkey", ""),
                            bool(req["is_pressed"]),
                        )
                        self._json(200, {"ok": True, "result": None})
                    except Exception as e:
                        self._json(
                            500,
                            {"ok": False,
                             "error": f"{type(e).__name__}: {e}"},
                        )
                else:
                    self._json(404, {"ok": False, "error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        # SSE streams hold their handler thread; block_on_close would make
        # shutdown wait on them forever.
        self.httpd.block_on_close = False
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._shutdown = threading.Event()

    # -- event fanout ------------------------------------------------------

    def _fanout(self, event: str, payload: Any) -> None:
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        msg = (seq, event, payload)
        with self._subs_lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(msg)
            except queue.Full:
                pass  # slow consumer drops events rather than blocking emit

    def _stream_events(self, handler) -> None:
        q: queue.Queue = queue.Queue(maxsize=1000)
        with self._subs_lock:
            self._subscribers.append(q)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            # SSE is an unbounded stream: no Content-Length; close delimits.
            handler.send_header("Connection", "close")
            handler.end_headers()
            while not self._shutdown.is_set():
                try:
                    seq, event, payload = q.get(timeout=0.5)
                except queue.Empty:
                    # heartbeat comment keeps proxies from timing out and
                    # surfaces dead sockets
                    handler.wfile.write(b": ping\n\n")
                    handler.wfile.flush()
                    continue
                data = json.dumps(jsonify(payload))
                frame = f"id: {seq}\nevent: {event}\ndata: {data}\n\n"
                handler.wfile.write(frame.encode())
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away
        finally:
            with self._subs_lock:
                if q in self._subscribers:
                    self._subscribers.remove(q)

    # -- command dispatch ---------------------------------------------------

    def _dispatch(self, handler, req: dict) -> None:
        name = req.get("cmd", "")
        snake = name if "_" in name or name.islower() else _camel_to_snake(name)
        fn = getattr(self.commands, snake, None)
        if fn is None or snake.startswith("_") or not callable(fn):
            handler._json(
                404, {"ok": False, "error": f"unknown command: {name}"}
            )
            return
        args = req.get("args", {})
        try:
            if isinstance(args, dict):
                result = fn(**args)
            else:
                result = fn(*args)
            handler._json(200, {"ok": True, "result": jsonify(result)})
        except Exception as e:
            handler._json(
                500, {"ok": False, "error": f"{type(e).__name__}: {e}"}
            )

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self):
        return self.httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        host, port = self.address[:2]
        self.commands.console_url = f"http://{host}:{port}/"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        self._unlisten()
        if self._thread is not None:
            # shutdown() blocks until serve_forever acknowledges — on a
            # never-started server that wait never ends; just close.
            self.httpd.shutdown()
            self._thread.join(timeout=5)
        self.httpd.server_close()
