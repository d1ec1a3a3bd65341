"""The macOS and Windows backends that the port does not carry yet.

The JAX package's shell reaches them only behind a `sys.platform` test
(shell/macos_*.py, shell/windows_*.py). In the port each such branch
raises this error instead: none of them takes the Linux path, a
QueueSource or None in its place. ROADMAP queue 1b item 1 (the
macOS/Windows slice) lists them.
"""

from __future__ import annotations

SLICE = "ROADMAP queue 1b item 1, the macOS/Windows slice"


def unported(backend: str) -> NotImplementedError:
    """The error a macOS or Windows branch raises: `backend` names the
    JAX package's module (e.g. "shell/windows_input.py")."""
    return NotImplementedError(
        f"{backend} is not ported to spittle_tpu_torch yet ({SLICE})")
