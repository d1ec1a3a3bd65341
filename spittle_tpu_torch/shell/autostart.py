"""OS autostart entries: launch the app at login.

Port of spittle_tpu/shell/autostart.py. The command the launcher runs is
the port's CLI (`-m spittle_tpu_torch.cli app`); APP_ID and APP_NAME, and
so the entry's path and Name, are the JAX package's.

The reference uses tauri-plugin-autostart: `change_autostart_setting`
stores the flag and immediately enables/disables the OS launcher
(src-tauri/src/shortcut/mod.rs:598-622), and boot reconciles the
launcher with the persisted setting (src-tauri/src/lib.rs:219-228;
plugin init with MacosLauncher::LaunchAgent at lib.rs:415-418).

This is that manager without the plugin: on Linux an XDG autostart
desktop entry (~/.config/autostart/<app>.desktop — the same file the
plugin's auto-launch crate writes), on macOS a LaunchAgent plist with
RunAtLoad. Paths and platform are injectable so tests never touch the
real home directory.
"""

from __future__ import annotations

import os
import plistlib
import sys
from typing import List, Optional

APP_ID = "spittle-tpu"
APP_NAME = "Spittle TPU"


def default_exec_cmd(data_dir: Optional[str] = None) -> List[str]:
    """The command the login launcher runs: the assembled desktop app
    (cli.py `app` subcommand), pinned to the current interpreter."""
    cmd = [sys.executable, "-m", "spittle_tpu_torch.cli", "app"]
    if data_dir:
        cmd += ["--data-dir", data_dir]
    return cmd


class AutostartManager:
    """enable()/disable()/is_enabled() over the platform's login-launch
    registry (tauri_plugin_autostart::ManagerExt::autolaunch analog)."""

    def __init__(
        self,
        exec_cmd: Optional[List[str]] = None,
        *,
        app_id: str = APP_ID,
        home: Optional[str] = None,
        platform: Optional[str] = None,
    ):
        self.exec_cmd = exec_cmd or default_exec_cmd()
        self.app_id = app_id
        self.home = home or os.path.expanduser("~")
        self.platform = platform or sys.platform

    # -- entry location -------------------------------------------------

    def entry_path(self) -> str:
        if self.platform == "darwin":
            return os.path.join(
                self.home, "Library", "LaunchAgents",
                f"com.{self.app_id}.plist",
            )
        # Linux/BSD: XDG autostart. Honour XDG_CONFIG_HOME only when no
        # explicit home was injected (tests pin `home`).
        config = os.environ.get("XDG_CONFIG_HOME") if home_is_real(
            self.home) else None
        config = config or os.path.join(self.home, ".config")
        return os.path.join(config, "autostart", f"{self.app_id}.desktop")

    # -- content --------------------------------------------------------

    def _desktop_entry(self) -> str:
        exec_line = " ".join(_quote_exec(a) for a in self.exec_cmd)
        return (
            "[Desktop Entry]\n"
            "Type=Application\n"
            f"Name={APP_NAME}\n"
            f"Exec={exec_line}\n"
            "Terminal=false\n"
            "X-GNOME-Autostart-enabled=true\n"
        )

    def _launch_agent(self) -> bytes:
        return plistlib.dumps({
            "Label": f"com.{self.app_id}",
            "ProgramArguments": list(self.exec_cmd),
            "RunAtLoad": True,
        })

    # -- ManagerExt surface ---------------------------------------------

    def enable(self) -> None:
        path = self.entry_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if self.platform == "darwin":
            data = self._launch_agent()
            with open(path, "wb") as f:
                f.write(data)
        else:
            with open(path, "w", encoding="utf-8") as f:
                f.write(self._desktop_entry())

    def disable(self) -> None:
        try:
            os.remove(self.entry_path())
        except FileNotFoundError:
            pass

    def is_enabled(self) -> bool:
        return os.path.exists(self.entry_path())

    def reconcile(self, enabled: bool) -> None:
        """Boot-time sync with the persisted setting (lib.rs:219-228:
        enable when opted in, disable otherwise — unconditionally, so a
        stale entry from a previous install is cleaned up)."""
        if enabled:
            self.enable()
        else:
            self.disable()


def home_is_real(home: str) -> bool:
    return home == os.path.expanduser("~")


def _quote_exec(arg: str) -> str:
    # Desktop-entry Exec quoting: double-quote args containing reserved
    # characters, escaping embedded quotes/backslashes.
    if not any(c in arg for c in ' \t"\'\\><~|&;$*?#()`'):
        return arg
    return '"' + arg.replace("\\", "\\\\").replace('"', '\\"') + '"'
