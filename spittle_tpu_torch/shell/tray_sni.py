"""Real system-tray surface: StatusNotifierItem over D-Bus.

Port of spittle_tpu/shell/tray_sni.py.

The reference gets its tray from Tauri's tray binding
(reference: src-tauri/src/tray.rs:9-18 TrayIcon + TrayIconState,
:47-60 per-theme/state icons; menu built in lib.rs from the 17-locale
table). On Linux, Tauri itself speaks the freedesktop
StatusNotifierItem protocol via libappindicator — this module speaks
it directly over the session bus (shell/dbus_client.py, no external
dependencies): an actual icon appears in KDE/GNOME(+extension)/
waybar/etc trays, with the localized menu and live state icons.

Protocol: org.kde.StatusNotifierWatcher registration, an exported
org.kde.StatusNotifierItem (properties + Activate + NewIcon signal),
and com.canonical.dbusmenu for the menu (GetLayout/Event/AboutToShow).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from spittle_tpu_torch.app.ui_state import TrayIconState
from spittle_tpu_torch.shell.dbus_client import (
    DBusConnection,
    ExportedObject,
    Variant,
)
from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("tray")

SNI_IFACE = "org.kde.StatusNotifierItem"
WATCHER_NAME = "org.kde.StatusNotifierWatcher"
WATCHER_PATH = "/StatusNotifierWatcher"
WATCHER_IFACE = "org.kde.StatusNotifierWatcher"
MENU_IFACE = "com.canonical.dbusmenu"

# State -> freedesktop icon name (tray.rs:47-60 ships theme-specific
# PNGs; stock symbolic names render on any icon theme).
STATE_ICONS = {
    TrayIconState.IDLE: "audio-input-microphone",
    TrayIconState.RECORDING: "media-record",
    TrayIconState.TRANSCRIBING: "system-run",
}


class SniTray:
    """A live StatusNotifierItem: icon + localized menu + activation.

    menu_items: [(id, label)] (TrayController.menu_items()).
    on_activate: left-click on the icon (reference: toggles transcribe).
    on_menu: fn(item_id) for menu clicks.
    """

    def __init__(
        self,
        menu_items: List[Tuple[str, str]],
        on_activate: Optional[Callable[[], None]] = None,
        on_menu: Optional[Callable[[str], None]] = None,
        address: Optional[str] = None,
        title: str = "Spittle TPU",
    ):
        self.conn = DBusConnection(address)
        self.menu: List[Tuple[str, str]] = list(menu_items)
        self.on_activate = on_activate or (lambda: None)
        self.on_menu = on_menu or (lambda item_id: None)
        self.state = TrayIconState.IDLE
        self._revision = 1

        self.item = ExportedObject()
        self.item.properties[SNI_IFACE] = {
            "Category": Variant("s", "ApplicationStatus"),
            "Id": Variant("s", "spittle-tpu"),
            "Title": Variant("s", title),
            "Status": Variant("s", "Active"),
            "IconName": Variant("s", STATE_ICONS[self.state]),
            "IconThemePath": Variant("s", ""),
            "Menu": Variant("o", "/MenuBar"),
            "ItemIsMenu": Variant("b", False),
        }
        self.item.methods[(SNI_IFACE, "Activate")] = self._activate
        self.item.methods[(SNI_IFACE, "SecondaryActivate")] = self._activate
        self.item.methods[(SNI_IFACE, "ContextMenu")] = (
            lambda *_a: None
        )
        self.item.methods[(SNI_IFACE, "Scroll")] = lambda *_a: None
        self.conn.export("/StatusNotifierItem", self.item)

        self.menubar = ExportedObject()
        self.menubar.properties[MENU_IFACE] = {
            "Version": Variant("u", 3),
            "Status": Variant("s", "normal"),
        }
        self.menubar.methods[(MENU_IFACE, "GetLayout")] = self._get_layout
        self.menubar.methods[(MENU_IFACE, "Event")] = self._menu_event
        self.menubar.methods[(MENU_IFACE, "EventGroup")] = (
            lambda events: ("ai", ([],))
        )
        self.menubar.methods[(MENU_IFACE, "AboutToShow")] = (
            lambda _id: ("b", (False,))
        )
        self.menubar.methods[(MENU_IFACE, "AboutToShowGroup")] = (
            lambda _ids: ("abab", ([], []))
        )
        self.menubar.methods[(MENU_IFACE, "GetGroupProperties")] = (
            self._get_group_properties
        )
        self.conn.export("/MenuBar", self.menubar)

        # Own a well-known name, then register with the watcher. Per the
        # SNI spec hosts accept either the service name or the unique
        # connection name.
        self.service_name = (
            f"org.kde.StatusNotifierItem-{os.getpid()}-1"
        )
        self.conn.request_name(self.service_name)
        self.registered = self._register()

    # -- watcher ----------------------------------------------------------

    def _register(self) -> bool:
        try:
            self.conn.call(
                WATCHER_NAME, WATCHER_PATH, WATCHER_IFACE,
                "RegisterStatusNotifierItem", "s", (self.service_name,),
            )
            return True
        except Exception as e:  # noqa: BLE001 - no watcher on this desktop
            _log.info("no StatusNotifierWatcher: %s", e)
            return False

    # -- item -------------------------------------------------------------

    def _activate(self, *_xy) -> None:
        self.on_activate()

    def set_state(self, state: TrayIconState) -> None:
        """tray.rs change_tray_icon analog: swap the icon live."""
        self.state = state
        self.item.properties[SNI_IFACE]["IconName"] = Variant(
            "s", STATE_ICONS[state]
        )
        self.conn.emit_signal("/StatusNotifierItem", SNI_IFACE, "NewIcon")

    def set_menu(self, menu_items: List[Tuple[str, str]]) -> None:
        self.menu = list(menu_items)
        self._revision += 1
        self.conn.emit_signal(
            "/MenuBar", MENU_IFACE, "LayoutUpdated", "ui",
            (self._revision, 0),
        )

    # -- dbusmenu ---------------------------------------------------------

    def _item_props(self, label: str) -> Dict[str, Variant]:
        return {"label": Variant("s", label), "enabled": Variant("b", True),
                "visible": Variant("b", True)}

    def _get_layout(self, parent_id: int, _depth: int, _props: List[str]):
        children = [
            Variant(
                "(ia{sv}av)",
                (i + 1, self._item_props(label), []),
            )
            for i, (_id, label) in enumerate(self.menu)
        ]
        root = (0, {"children-display": Variant("s", "submenu")}, children)
        return ("u(ia{sv}av)", (self._revision, root))

    def _get_group_properties(self, ids: List[int], _props: List[str]):
        out = []
        for i in ids:
            if 1 <= i <= len(self.menu):
                out.append((i, self._item_props(self.menu[i - 1][1])))
        return ("a(ia{sv})", (out,))

    def _menu_event(self, item_id: int, event_id: str, _data, _ts) -> None:
        if event_id == "clicked" and 1 <= item_id <= len(self.menu):
            self.on_menu(self.menu[item_id - 1][0])

    def close(self) -> None:
        self.conn.close()


def tray_menu_handler(services, actions, ui, commands=None):
    """The shared tray-menu dispatch (lib.rs menu handlers), used by
    every tray arm (SNI on Linux, NSStatusItem on macOS)."""

    def on_menu(item_id: str) -> None:
        if item_id == "settings":
            # Reference tray settings item shows the main window
            # (lib.rs:164-166); ours surfaces the operator console.
            if commands is not None:
                commands.show_main_window()
        elif item_id == "cancel":
            actions.cancel_current_operation()
        elif item_id == "unload_model":
            services.transcription.unload_model()
        elif item_id == "copy_last_transcript":
            text = ui.tray.last_transcript
            if text:
                import subprocess

                from spittle_tpu_torch.shell.textout import (
                    clipboard_write_command,
                    is_wayland,
                )

                cmd = clipboard_write_command(text, is_wayland())
                if cmd:
                    argv, stdin = cmd
                    subprocess.run(argv, input=stdin, timeout=5,
                                   capture_output=True)
        elif item_id == "check_updates":
            from spittle_tpu_torch.events import CHECK_FOR_UPDATES

            services.events.emit(CHECK_FOR_UPDATES, None)
        elif item_id == "quit":
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGTERM)

    return on_menu


def tray_activate_handler(actions):
    def on_activate() -> None:
        # Left click toggles transcribe, like the reference tray.
        actions.handle_shortcut_event("transcribe", "", True)
        actions.handle_shortcut_event("transcribe", "", False)

    return on_activate


def attach_tray(services, actions, ui, address: Optional[str] = None,
                commands=None):
    """Wire an SniTray to the app graph: TrayController state changes
    drive the live icon, menu clicks drive the real commands
    (lib.rs menu handlers). Returns the tray or None when there is no
    session bus."""
    if address is None and "DBUS_SESSION_BUS_ADDRESS" not in os.environ:
        return None

    on_menu = tray_menu_handler(services, actions, ui, commands)
    on_activate = tray_activate_handler(actions)

    try:
        tray = SniTray(
            ui.tray.menu_items(), on_activate=on_activate,
            on_menu=on_menu, address=address,
        )
    except Exception as e:  # noqa: BLE001 - no/odd bus: headless fallback
        _log.info("tray unavailable: %s", e)
        return None
    services.events.listen(
        "tray-state-changed",
        lambda v: tray.set_state(TrayIconState(v)),
    )
    return tray
