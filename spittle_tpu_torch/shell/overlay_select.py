"""Overlay backend selection per session type.

Port of spittle_tpu/shell/overlay_select.py. Its win32 and darwin arms
raise NotImplementedError (shell/unported.py) until the macOS/Windows
slice.

The reference picks its overlay implementation by platform/session
(src-tauri/src/overlay.rs): gtk-layer-shell on Wayland — with a KDE
bailout (:79-84) — and a plain always-on-top window otherwise. Here:

  XDG_SESSION_TYPE=wayland + WAYLAND_DISPLAY -> wlr-layer-shell pill
      (shell/wayland_overlay.py, from-scratch wire client), unless the
      session is KDE/Plasma (reference bailout) — then fall through to
      X11 via XWayland when DISPLAY exists.
  DISPLAY -> X11 override-redirect pill (shell/x11_overlay.py).
  win32 -> topmost popup pill (shell/windows_overlay.py), matching the
      reference's plain always-on-top Windows arm.
  neither -> None (headless: the state-only controller still runs).
"""

from __future__ import annotations

import os
import sys

from spittle_tpu_torch.shell.unported import unported
from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("overlay")


def attach_session_overlay(services):
    from spittle_tpu_torch.shell.wayland_overlay import (
        attach_wayland_overlay,
        session_is_kde_wayland,
    )
    from spittle_tpu_torch.shell.x11_overlay import attach_overlay

    if sys.platform == "win32":
        # Reference Windows arm: plain always-on-top popup (overlay.rs,
        # the windows cfg of create_recording_overlay).
        raise unported("shell/windows_overlay.py (topmost popup overlay)")
    if sys.platform == "darwin":
        # Reference macOS arm: non-activating NSPanel at status-window
        # level, joins all Spaces (overlay.rs:23-31).
        raise unported("shell/macos_overlay.py (NSPanel overlay)")
    if (os.environ.get("XDG_SESSION_TYPE", "").lower() == "wayland"
            and os.environ.get("WAYLAND_DISPLAY")
            and not session_is_kde_wayland()):
        overlay = attach_wayland_overlay(services)
        if overlay is not None:
            _log.info("overlay: wayland layer-shell")
            return overlay
    overlay = attach_overlay(services)
    if overlay is not None:
        _log.info("overlay: x11 override-redirect")
    return overlay
