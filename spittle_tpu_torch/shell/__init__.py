"""The OS shell (port of spittle_tpu/shell): text output, the microphone,
evdev hotkeys, uinput, the D-Bus tray, the X11 and Wayland overlays,
autostart, the Apple Intelligence shim probe, feedback sounds, audio
device listing, and the macOS (Cocoa, AX, CGEventTap, AudioQueue) and
Windows (clipboard, SendInput, RegisterHotKey, waveIn, the overlay, the
tray, COM mute) backends over ctypes."""

from .textout import SystemTextOutput, choose_typing_tool, get_available_typing_tools

__all__ = [
    "SystemTextOutput",
    "choose_typing_tool",
    "get_available_typing_tools",
]
