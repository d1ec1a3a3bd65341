"""OS text output: paste methods, typing tools, clipboard, diff keystrokes.

Port of spittle_tpu/shell/textout.py. Its Windows clipboard and SendInput
branches and the macOS AX selection raise NotImplementedError
(shell/unported.py) until the macOS/Windows slice.

Behavior-parity rebuild of the reference's clipboard/input layer
(`src-tauri/src/clipboard.rs`, `input.rs`): paste via
save-clipboard -> write -> Ctrl+V / Ctrl+Shift+V / Shift+Insert ->
(restore), or Direct typing through a probed Linux tool chain
(wtype -> kwtype -> dotool -> ydotool -> xdotool; clipboard.rs:205-276),
wl-copy on Wayland else xclip/xsel, and `apply_text_diff` as
ArrowLeft x suffix + Backspace x delete + typed insert
(clipboard.rs:690, the non-AX path).

Command construction is pure (testable); execution goes through an
injectable runner so headless tests never touch the OS.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

from spittle_tpu_torch.config.settings import (
    AppSettings,
    ClipboardHandling,
    PasteMethod,
    TypingTool,
)
from spittle_tpu_torch.shell.unported import unported

TOOL_PRIORITY = ("wtype", "kwtype", "dotool", "ydotool", "xdotool")


def is_wayland() -> bool:
    return bool(os.environ.get("WAYLAND_DISPLAY")) or (
        os.environ.get("XDG_SESSION_TYPE") == "wayland"
    )


def get_available_typing_tools(which=shutil.which) -> List[str]:
    """['auto', ...available tools in priority order] (clipboard.rs:205-223)."""
    return ["auto"] + [t for t in TOOL_PRIORITY if which(t)]


def choose_typing_tool(
    setting: TypingTool, which=shutil.which
) -> Optional[str]:
    if setting is not TypingTool.AUTO:
        return setting.value if which(setting.value) else None
    for t in TOOL_PRIORITY:
        if which(t):
            return t
    return None


# -- pure command construction ---------------------------------------------


def type_command(tool: str, text: str) -> List[str]:
    return {
        "wtype": ["wtype", "--", text],
        "kwtype": ["kwtype", text],
        "dotool": ["dotool"],  # reads "type <text>" on stdin
        "ydotool": ["ydotool", "type", "--", text],
        "xdotool": ["xdotool", "type", "--clearmodifiers", "--", text],
    }[tool]


def type_stdin(tool: str, text: str) -> Optional[bytes]:
    if tool == "dotool":
        return f"type {text}\n".encode()
    return None


def key_command(tool: str, key: str) -> List[str]:
    """key in xdotool syntax (ctrl+v, shift+Insert, Return, Left, BackSpace)."""
    if tool == "xdotool":
        return ["xdotool", "key", "--clearmodifiers", key]
    if tool == "ydotool":
        # ydotool uses key codes via `key`; use its named combo support
        return ["ydotool", "key", key]
    if tool == "wtype":
        parts = key.split("+")
        cmd = ["wtype"]
        for mod in parts[:-1]:
            cmd += ["-M", mod]
        cmd += ["-k", parts[-1]]
        for mod in reversed(parts[:-1]):
            cmd += ["-m", mod]
        return cmd
    if tool == "dotool":
        return ["dotool"]
    if tool == "kwtype":
        return ["kwtype", "-k", key]
    return ["true"]


def key_stdin(tool: str, key: str) -> Optional[bytes]:
    if tool == "dotool":
        return f"key {key}\n".encode()
    return None


def clipboard_write_command(text: str, wayland: bool, which=shutil.which):
    if wayland and which("wl-copy"):
        return ["wl-copy"], text.encode()
    if which("xclip"):
        return ["xclip", "-selection", "clipboard"], text.encode()
    if which("xsel"):
        return ["xsel", "--clipboard", "--input"], text.encode()
    return None, None


def clipboard_read_command(wayland: bool, which=shutil.which):
    if wayland and which("wl-paste"):
        return ["wl-paste", "--no-newline"]
    if which("xclip"):
        return ["xclip", "-selection", "clipboard", "-o"]
    if which("xsel"):
        return ["xsel", "--clipboard", "--output"]
    return None


PASTE_KEYS = {
    PasteMethod.CTRL_V: "ctrl+v",
    PasteMethod.CTRL_SHIFT_V: "ctrl+shift+v",
    PasteMethod.SHIFT_INSERT: "shift+Insert",
}


def _platform_keyboard():
    """Default native keystroke backend for this OS, or None.

    Linux: /dev/uinput (shell/uinput.py, the enigo analog). Windows:
    user32.SendInput with layout-independent VKs (shell/windows_input.py,
    input.rs:28-52). macOS keeps the tool/AX paths.
    """
    if sys.platform == "win32":
        raise unported("shell/windows_input.py (SendInput keystrokes)")
    from .uinput import UinputKeyboard

    if UinputKeyboard.available():
        return UinputKeyboard()
    return None


def _default_runner(cmd: Sequence[str], stdin: Optional[bytes] = None) -> bool:
    try:
        return (
            subprocess.run(cmd, input=stdin, capture_output=True, timeout=10)
            .returncode
            == 0
        )
    except Exception:
        return False


def _default_reader(cmd: Sequence[str]) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.decode(errors="replace")
    except Exception:
        pass
    return None


class SystemTextOutput:
    """TextOutput implementation driving the real OS (Linux-first).

    Uses the settings' paste method / typing tool / clipboard handling and
    paste_delay_ms like the reference paste() (clipboard.rs:567-...).
    """

    def __init__(
        self,
        settings_provider: Callable[[], AppSettings],
        runner=_default_runner,
        reader=_default_reader,
        which=shutil.which,
        ax_backend=None,
        uinput_factory=None,
    ):
        """ax_backend: optional macOS AX selection backend
        (shell/macos_ax.py, not ported yet: apply_text_diff raises when
        one is given or on macOS); None off macOS is the keyboard path.

        uinput_factory: () -> UinputKeyboard-like, or None to probe the
        native Linux backend (shell/uinput.py — the enigo analog,
        input.rs). Keystrokes prefer uinput when /dev/uinput is writable;
        the external-tool chain remains the fallback."""
        self._settings = settings_provider
        self._run = runner
        self._read = reader
        self._which = which
        self._ax_backend = ax_backend
        self._uinput_factory = uinput_factory
        self._uinput = None
        self._uinput_probed = False

    # -- primitives ------------------------------------------------------

    def _tool(self) -> Optional[str]:
        return choose_typing_tool(self._settings().typing_tool, self._which)

    def _kb(self):
        """Lazy uinput keyboard; None when unavailable. Only used under
        TypingTool.AUTO — an explicit tool choice is respected (checked
        BEFORE the probe latch, so switching the setting back to AUTO
        later still probes)."""
        if self._settings().typing_tool is not TypingTool.AUTO:
            return None
        if self._uinput_probed:
            return self._uinput
        self._uinput_probed = True
        try:
            if self._uinput_factory is not None:
                self._uinput = self._uinput_factory()
            else:
                self._uinput = _platform_keyboard()
        except OSError:
            self._uinput = None
        return self._uinput

    @staticmethod
    def _parse_key(key: str):
        """'ctrl+shift+v' -> (mods, 'v') in uinput terms."""
        from .uinput import MOD_ALT, MOD_CTRL, MOD_META, MOD_SHIFT

        names = {
            "Left": "left", "Right": "right", "Up": "up", "Down": "down",
            "BackSpace": "backspace", "Return": "enter", "Tab": "tab",
            "Escape": "escape", "Insert": "insert", "Delete": "delete",
            "Home": "home", "End": "end",
        }
        mod_bits = {
            "ctrl": MOD_CTRL, "shift": MOD_SHIFT, "alt": MOD_ALT,
            "super": MOD_META, "cmd": MOD_META,
        }
        parts = key.split("+")
        mods = 0
        for p in parts[:-1]:
            bit = mod_bits.get(p.lower())
            if bit is None:
                return None
            mods |= bit
        last = parts[-1]
        name = names.get(last, last.lower() if len(last) == 1 else None)
        if name is None:
            return None
        return mods, name

    def _type_text(self, text: str) -> bool:
        kb = self._kb()
        if kb is not None and text.isascii():
            # Known-typable text only: non-ASCII goes wholly to the tool
            # chain rather than splitting a word across two backends.
            typed = kb.type_prefix(text)
            if typed == len(text):
                return True
            # Unexpected mid-write failure: fall back for the REMAINDER
            # only — retyping the whole string would duplicate the
            # already-typed prefix in the focused app.
            text = text[typed:]
        tool = self._tool()
        if tool is None:
            return False
        return self._run(type_command(tool, text), type_stdin(tool, text))

    def _press(self, key: str, count: int = 1) -> bool:
        kb = self._kb()
        if kb is not None:
            parsed = self._parse_key(key)
            if parsed is not None and kb.key(parsed[1], parsed[0], count):
                return True
        tool = self._tool()
        if tool is None:
            return False
        ok = True
        for _ in range(count):
            ok = self._run(key_command(tool, key), key_stdin(tool, key)) and ok
        return ok

    def _clipboard_write(self, text: str) -> bool:
        if sys.platform == "win32":
            raise unported("shell/windows_clipboard.py (clipboard write)")
        cmd, stdin = clipboard_write_command(text, is_wayland(), self._which)
        if cmd is None:
            return False
        return self._run(cmd, stdin)

    def _clipboard_read(self) -> Optional[str]:
        if sys.platform == "win32":
            raise unported("shell/windows_clipboard.py (clipboard read)")
        cmd = clipboard_read_command(is_wayland(), self._which)
        if cmd is None:
            return None
        return self._read(cmd)

    # -- TextOutput ------------------------------------------------------

    def paste_raw(self, text: str) -> None:
        s = self._settings()
        method = s.paste_method
        if method is PasteMethod.NONE:
            if s.clipboard_handling is ClipboardHandling.COPY_TO_CLIPBOARD:
                self._clipboard_write(text)
            return
        if method is PasteMethod.DIRECT:
            self._type_text(text)
            return
        saved = None
        if s.clipboard_handling is ClipboardHandling.DONT_MODIFY:
            saved = self._clipboard_read()
        self._clipboard_write(text)
        time.sleep(s.paste_delay_ms / 1000.0)
        self._press(PASTE_KEYS[method])
        if saved is not None:
            time.sleep(s.paste_delay_ms / 1000.0)
            self._clipboard_write(saved)

    def paste(self, text: str) -> None:
        self.paste_raw(text)

    def apply_text_diff(self, suffix_chars: int, delete_chars: int, insert: str) -> None:
        """Minimal diff apply (clipboard.rs:690-790, the non-AX path):
        ArrowLeft x suffix + Backspace x delete, then type insert,
        ArrowRight back. The macOS AX selection (shell/macos_ax.py), which
        the JAX package tries first on macOS or with an injected backend,
        raises here until the macOS/Windows slice."""
        if self._settings().paste_method is PasteMethod.NONE:
            return  # clipboard.rs:697-700

        if self._ax_backend is not None or sys.platform == "darwin":
            raise unported("shell/macos_ax.py (AX range selection)")
        # Batched movement (input.rs:120-150): one uinput burst per
        # direction instead of one subprocess per keypress.
        if suffix_chars:
            self._press("Left", count=suffix_chars)
        if delete_chars:
            self._press("BackSpace", count=delete_chars)
        if insert:
            self._type_text(insert)
        if suffix_chars:
            self._press("Right", count=suffix_chars)

    def press_key(self, key: str) -> None:
        mapping = {"enter": "Return", "ctrl+enter": "ctrl+Return",
                   "cmd+enter": "super+Return"}
        self._press(mapping.get(key, key))
