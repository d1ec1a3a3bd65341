"""Single-instance guard for the desktop app.

Port of spittle_tpu/app/single_instance.py.

The reference registers tauri_plugin_single_instance first in the
plugin stack (src-tauri/src/lib.rs:403-405): a second launch does not
boot — it invokes the callback in the FIRST instance, which shows and
focuses the main window, and the second process exits.

Same contract here via an advisory flock on <data_dir>/app.lock: the
running instance holds the lock for its lifetime and publishes its RPC
port in the lock file; a second launch fails to acquire, reads the
port, asks the running instance to `show_main_window` over the RPC
wire, and reports the console URL instead of booting a duplicate app
graph (duplicate mic capture, duplicate hotkey grabs).
"""

from __future__ import annotations

import fcntl
import json
import os
import urllib.request
from typing import Optional


class SingleInstanceLock:
    def __init__(self, data_dir: str):
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "app.lock")
        self._fh = None

    def acquire(self) -> bool:
        """True if this process is now the single instance. The lock is
        held until release() or process exit (flock dies with the fd, so
        a crashed instance never wedges the next launch)."""
        fh = open(self.path, "a+", encoding="utf-8")
        try:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            fh.close()
            return False
        self._fh = fh
        return True

    def publish(self, port: int) -> None:
        """Record this instance's RPC port for later launches."""
        assert self._fh is not None, "publish() before acquire()"
        self._fh.seek(0)
        self._fh.truncate()
        json.dump({"pid": os.getpid(), "port": port}, self._fh)
        self._fh.flush()

    def peer_port(self) -> Optional[int]:
        try:
            with open(self.path, encoding="utf-8") as f:
                return int(json.load(f)["port"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    def release(self) -> None:
        if self._fh is not None:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None


def notify_running_instance(port: int, timeout: float = 5.0) -> Optional[str]:
    """Second-launch path: tell the running instance to surface its main
    window (the plugin callback's show_main_window(app)). Returns the
    console URL on success, None if the peer did not answer."""
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/rpc",
            data=json.dumps({"cmd": "show_main_window"}).encode(),
        )
        resp = json.loads(urllib.request.urlopen(req, timeout=timeout).read())
        if isinstance(resp, dict) and resp.get("ok"):
            return resp.get("result") or f"http://127.0.0.1:{port}/"
    except (OSError, ValueError):
        # ValueError covers JSONDecodeError: a stale lock file can point
        # at a port now owned by something that answers non-JSON.
        pass
    return None
