"""Headless UI state: tray, overlay, audio feedback, platform helpers.

Port of spittle_tpu/app/ui_state.py.

The reference renders these natively (tray.rs, overlay.rs NSPanel/
gtk-layer-shell, audio_feedback.rs rodio, helpers/clamshell.rs,
apple_intelligence.rs). The framework keeps the state machines and
behavior here; a desktop shell subscribes to the event bus and renders.

- TrayController: Idle/Recording/Transcribing icon state + localized menu
  labels (tray i18n data mirrored from the reference locale files).
- OverlayController: show/hide with recording/transcribing/processing
  states and Top/Bottom/None positioning (overlay.rs state surface).
- AudioFeedback: start/stop sound resolution per SoundTheme incl. custom
  WAVs in app data (audio_feedback.rs path logic); playback is a hook.
- clamshell/is_laptop probes (macOS ioreg/pmset; Linux /sys fallbacks).
- Apple Intelligence provider stub (available only on macOS arm64; the
  reference itself stubs it elsewhere, pipeline.rs:852-856).
"""

from __future__ import annotations

import enum
import json
import os
import subprocess
import sys
from typing import Callable, Dict, Optional

from spittle_tpu_torch.config.i18n import get_language_code as _get_language_code
from spittle_tpu_torch.config.i18n import get_locale_table
from spittle_tpu_torch.config.settings import AppSettings, SoundTheme
from spittle_tpu_torch.events import EventBus, HIDE_OVERLAY, SHOW_OVERLAY
from spittle_tpu_torch.shell import apple_llm


class TrayIconState(enum.Enum):
    IDLE = "idle"
    RECORDING = "recording"
    TRANSCRIBING = "transcribing"


def get_language_code(locale: str) -> str:
    return _get_language_code(locale)


def get_tray_translations(locale: Optional[str] = None) -> Dict[str, str]:
    """Localized tray labels from the app-wide 17-locale table; zh-TW
    preserved, otherwise language-code lookup with English fallback
    (tray_i18n.rs:22-36; table: config/data/app_i18n.json "tray")."""
    return dict(get_locale_table(locale)["tray"])


class TrayController:
    """Tray state + menu model (tray.rs surface, render-agnostic)."""

    def __init__(self, events: EventBus, locale: Optional[str] = None):
        self.events = events
        self.state = TrayIconState.IDLE
        self.strings = get_tray_translations(locale)
        self.last_transcript: str = ""

    def set_state(self, state: TrayIconState) -> None:
        self.state = state
        self.events.emit("tray-state-changed", state.value)

    def menu_items(self):
        s = self.strings
        return [
            ("settings", s["settings"]),
            ("check_updates", s["checkUpdates"]),
            ("copy_last_transcript", s["copyLastTranscript"]),
            ("unload_model", s["unloadModel"]),
            ("cancel", s["cancel"]),
            ("quit", s["quit"]),
        ]


class OverlayController:
    """Recording-pill overlay states (overlay.rs: recording/transcribing/
    processing; positions Top/Bottom/None)."""

    def __init__(self, events: EventBus, settings_provider: Callable[[], AppSettings]):
        self.events = events
        self._settings = settings_provider
        self.visible = False
        self.state = "recording"
        events.listen(SHOW_OVERLAY, self._on_show)
        events.listen(HIDE_OVERLAY, self._on_hide)

    @property
    def position(self) -> str:
        return self._settings().overlay_position.value

    def _on_show(self, payload) -> None:
        if self.position == "none":
            return
        self.visible = True
        # Reference payload is the bare state string (overlay.rs:307,
        # show_overlay_state); tolerate the older {"state": ...} dict.
        if isinstance(payload, str) and payload:
            self.state = payload
        elif isinstance(payload, dict) and "state" in payload:
            self.state = payload["state"]

    def _on_hide(self, _payload) -> None:
        self.visible = False


class SoundType(enum.Enum):
    START = "start"
    STOP = "stop"


class AudioFeedback:
    """Sound path resolution + volume; playback via injectable player."""

    def __init__(
        self,
        settings_provider: Callable[[], AppSettings],
        data_dir: str,
        resources_dir: Optional[str] = None,
        player: Optional[Callable[[str, float], None]] = None,
    ):
        self._settings = settings_provider
        self.data_dir = data_dir
        self.resources_dir = resources_dir or os.path.join(data_dir, "resources")
        self._player = player
        self.played = []  # observability for tests/shell

    def sound_path(self, sound: SoundType) -> str:
        s = self._settings()
        theme = s.sound_theme
        if theme is SoundTheme.CUSTOM:
            return os.path.join(
                self.data_dir, "custom_sounds", f"custom_{sound.value}.wav"
            )
        rel = theme.start_path() if sound is SoundType.START else theme.stop_path()
        return os.path.join(self.resources_dir, os.path.basename(rel))

    def play(self, sound: SoundType) -> None:
        s = self._settings()
        if not s.audio_feedback:
            return
        path = self.sound_path(sound)
        self.played.append(path)
        if self._player is not None:
            self._player(path, s.audio_feedback_volume)


class AppUi:
    """Tray + overlay + audio feedback wired to a services graph.

    The lib.rs:160-232 analog: builds the UI controllers over the event
    bus and gives actions one object to drive (tray state transitions
    and feedback sounds around the dictation loop, actions.rs:42-77,
    130-137). `player=None` probes the system (paplay/aplay/afplay via
    shell.audio_out); headless environments get state-only UI with
    sounds recorded in feedback.played.
    """

    def __init__(
        self,
        services,
        locale: Optional[str] = None,
        player: Optional[Callable[[str, float], None]] = None,
        synthesize_sounds: bool = True,
    ):
        from spittle_tpu_torch.shell.audio_out import (
            synthesize_theme_sounds,
            system_player,
        )

        self.tray = TrayController(services.events, locale)
        self.overlay = OverlayController(services.events, services.get_settings)
        self.feedback = AudioFeedback(
            services.get_settings,
            services.data_dir,
            player=player if player is not None else system_player(),
        )
        if synthesize_sounds:
            try:
                synthesize_theme_sounds(self.feedback.resources_dir)
            except OSError:
                pass  # read-only data dir: sound_path misses are non-fatal


# -- platform helpers (helpers/clamshell.rs) --------------------------------


def is_clamshell(run=subprocess.run) -> bool:
    """Lid-closed detection: macOS ioreg AppleClamshellState; Linux
    /proc/acpi/button/lid state; False elsewhere."""
    if sys.platform == "darwin":
        try:
            out = run(["ioreg", "-r", "-k", "AppleClamshellState", "-d", "4"],
                      capture_output=True, timeout=3)
            return b'"AppleClamshellState" = Yes' in out.stdout
        except Exception:
            return False
    if sys.platform == "linux":
        base = "/proc/acpi/button/lid"
        try:
            for lid in os.listdir(base):
                with open(os.path.join(base, lid, "state")) as f:
                    if "closed" in f.read():
                        return True
        except OSError:
            pass
    return False


def is_laptop(run=subprocess.run) -> bool:
    if sys.platform == "darwin":
        try:
            out = run(["pmset", "-g", "batt"], capture_output=True, timeout=3)
            return b"Battery" in out.stdout or b"InternalBattery" in out.stdout
        except Exception:
            return False
    return os.path.exists("/sys/class/power_supply/BAT0")


# -- Apple Intelligence provider (apple_intelligence.rs:23-60) ---------------
#
# Real FFI where the shim dylib exists (macOS arm64, or a fake pointed
# at via SPITTLE_APPLE_LLM_DYLIB in tests); elsewhere these report
# unavailable/raise, matching the reference's off-macOS cfg stubs
# (pipeline.rs:852-856).


def check_apple_intelligence_availability() -> bool:
    client = apple_llm.default_client()
    return client is not None and client.available()


def apple_intelligence_process_text(prompt: str, token_limit: int = 0) -> str:
    client = apple_llm.default_client()
    if client is None:
        raise apple_llm.AppleLLMError(
            "Apple Intelligence is a macOS-arm64-only provider "
            "(no shim dylib on this platform)"
        )
    return client.process_text(prompt, token_limit)
