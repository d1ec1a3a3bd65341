"""Thread exception barriers (port of spittle_tpu/utils/threads.py).

Every thread the port spawns goes through :func:`guarded` / :func:`spawn`,
so a crash is (1) logged with a traceback, (2) routed to an
``on_failure`` callback, and (3) never raised through the thread boundary
(pytest's PytestUnhandledThreadExceptionWarning is an error in this
repository's test settings).
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional

from .logging import get_logger

_log = get_logger("threads")


def guarded(
    target: Callable,
    *,
    name: str,
    on_failure: Optional[Callable[[BaseException], None]] = None,
) -> Callable:
    """Wrap ``target`` so exceptions are logged + routed, never raised."""

    @functools.wraps(target)
    def run(*args, **kwargs):
        try:
            return target(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - the barrier's whole job
            _log.exception("worker thread %r died: %s", name, exc)
            if on_failure is not None:
                try:
                    on_failure(exc)
                except Exception:
                    _log.exception("on_failure handler for %r also failed", name)
            return None

    return run


def spawn(
    target: Callable,
    *,
    name: str,
    args: tuple = (),
    on_failure: Optional[Callable[[BaseException], None]] = None,
    daemon: bool = True,
) -> threading.Thread:
    """Start a daemon thread whose body is wrapped in :func:`guarded`."""
    t = threading.Thread(
        target=guarded(target, name=name, on_failure=on_failure),
        args=args,
        name=name,
        daemon=daemon,
    )
    t.start()
    return t
