"""In-process event bus (port of spittle_tpu/events.py).

Replaces the Tauri event channel (`app.emit(...)` in the reference; event
names inventoried in SURVEY.md §2.7). The desktop shell subscribes and
forwards to its webview; tests subscribe directly.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List

# Event names used across the framework (parity with the reference set).
MODEL_STATE_CHANGED = "model-state-changed"
MODEL_DOWNLOAD_PROGRESS = "model-download-progress"
MODEL_DOWNLOAD_COMPLETE = "model-download-complete"
MODEL_DOWNLOAD_CANCELLED = "model-download-cancelled"
MODEL_DELETED = "model-deleted"
MODEL_EXTRACTION_STARTED = "model-extraction-started"
MODEL_EXTRACTION_COMPLETED = "model-extraction-completed"
MODEL_EXTRACTION_FAILED = "model-extraction-failed"
HISTORY_UPDATED = "history-updated"
SHOW_OVERLAY = "show-overlay"
HIDE_OVERLAY = "hide-overlay"
MIC_LEVEL = "mic-level"
HANDY_KEYS_EVENT = "handy-keys-event"
CHECK_FOR_UPDATES = "check-for-updates"
SETTINGS_CHANGED = "settings-changed"


class EventBus:
    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._all: List[Callable[[str, Any], None]] = []
        self._log: List[tuple] = []

    def listen_all(
        self, handler: Callable[[str, Any], None]
    ) -> Callable[[], None]:
        """Subscribe to every event (the RPC event-stream forwarder — the
        analog of the Tauri webview receiving all app.emit events)."""
        with self._lock:
            self._all.append(handler)

        def unlisten():
            with self._lock:
                if handler in self._all:
                    self._all.remove(handler)

        return unlisten

    def listen(self, event: str, handler: Callable[[Any], None]) -> Callable[[], None]:
        with self._lock:
            self._subs[event].append(handler)

        def unlisten():
            with self._lock:
                if handler in self._subs[event]:
                    self._subs[event].remove(handler)

        return unlisten

    def emit(self, event: str, payload: Any = None) -> None:
        with self._lock:
            handlers = list(self._subs[event])
            all_handlers = list(self._all)
            self._log.append((event, payload))
            if len(self._log) > 1000:
                del self._log[:500]
        for h in handlers:
            try:
                h(payload)
            except Exception:
                pass  # subscriber errors never break the emitter
        for h in all_handlers:
            try:
                h(event, payload)
            except Exception:
                pass

    def recent(self, event: str | None = None) -> List[tuple]:
        with self._lock:
            if event is None:
                return list(self._log)
            return [(e, p) for e, p in self._log if e == event]
