"""The OS shell (port of spittle_tpu/shell): text output, the microphone,
evdev hotkeys, uinput, the D-Bus tray, the X11 and Wayland overlays,
autostart, the Apple Intelligence shim probe, feedback sounds and audio
device listing. The macOS and Windows backends raise NotImplementedError
(shell/unported.py) until the macOS/Windows slice."""

from .textout import SystemTextOutput, choose_typing_tool, get_available_typing_tools

__all__ = [
    "SystemTextOutput",
    "choose_typing_tool",
    "get_available_typing_tools",
]
