"""The port's text output and uinput keyboard (spittle_tpu_torch/shell/
{textout,uinput}.py) against the JAX package's on the CPU, at exact
equality: the pure command functions for every typing tool on Wayland and
on X, the command sequence SystemTextOutput issues through an injected
runner and reader for every paste method and clipboard handling (tool
chain and a recording keyboard), apply_text_diff and press_key, the key
parser, the native library's build into build/spittle_tpu_torch/, and the
Windows (SendInput, clipboard) and macOS (AX selection) branches with
sys.platform patched."""

import importlib
import itertools
import os
import sys

import pytest

from spittle_tpu.config import settings as j_settings
from spittle_tpu.shell import textout as j_textout
from spittle_tpu.shell import uinput as j_uinput
from spittle_tpu_torch.config import settings as t_settings
from spittle_tpu_torch.shell import textout as t_textout
from spittle_tpu_torch.shell import uinput as t_uinput

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_shell_macos import FakeAX  # noqa: E402
from test_torch_shell_windows import FakeClipUser32, FakeKernel32, FakeUser32  # noqa: E402
TEXTS = ("hello world", "naïve café", "a -- b 'q' \"x\"", "")
KEYS = ("ctrl+v", "ctrl+shift+v", "shift+Insert", "Return", "Left",
        "BackSpace", "super+Return", "ctrl+Return", "Tab", "F13", "weird+x")
# Tool sets a machine may have on PATH.
PATHS = ((), ("xclip",), ("xsel",), ("wl-copy", "wl-paste"),
         ("wl-copy", "wl-paste", "xclip", "xsel"), ("xdotool", "xclip"),
         ("wtype", "wl-copy", "wl-paste"), ("dotool", "xsel"),
         ("ydotool", "kwtype", "xclip"))


def _which(tools):
    return lambda name: f"/usr/bin/{name}" if name in tools else None


@pytest.mark.parametrize("tool", j_textout.TOOL_PRIORITY)
def test_typing_tool_commands_match(tool):
    assert t_textout.TOOL_PRIORITY == j_textout.TOOL_PRIORITY
    for text in TEXTS:
        assert t_textout.type_command(tool, text) == j_textout.type_command(tool, text)
        assert t_textout.type_stdin(tool, text) == j_textout.type_stdin(tool, text)
    for key in KEYS:
        assert t_textout.key_command(tool, key) == j_textout.key_command(tool, key)
        assert t_textout.key_stdin(tool, key) == j_textout.key_stdin(tool, key)


@pytest.mark.parametrize("wayland", [False, True], ids=["x11", "wayland"])
def test_clipboard_and_probe_commands_match(wayland):
    for tools in PATHS:
        which = _which(tools)
        for text in TEXTS:
            assert (t_textout.clipboard_write_command(text, wayland, which)
                    == j_textout.clipboard_write_command(text, wayland, which))
        assert (t_textout.clipboard_read_command(wayland, which)
                == j_textout.clipboard_read_command(wayland, which))
        assert (t_textout.get_available_typing_tools(which)
                == j_textout.get_available_typing_tools(which))
        for setting in j_settings.TypingTool:
            assert (t_textout.choose_typing_tool(
                t_settings.TypingTool(setting.value), which)
                == j_textout.choose_typing_tool(setting, which))


def test_is_wayland_matches(monkeypatch):
    for wd, st in itertools.product((None, "wayland-0"), (None, "x11", "wayland")):
        for k, v in (("WAYLAND_DISPLAY", wd), ("XDG_SESSION_TYPE", st)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        assert t_textout.is_wayland() == j_textout.is_wayland()


def test_parse_key_matches():
    for key in KEYS + ("cmd+a", "alt+Delete", "ctrl+alt+shift+super+Home", "End"):
        assert (t_textout.SystemTextOutput._parse_key(key)
                == j_textout.SystemTextOutput._parse_key(key)), key
    assert ((t_uinput.MOD_CTRL, t_uinput.MOD_SHIFT, t_uinput.MOD_ALT, t_uinput.MOD_META)
            == (j_uinput.MOD_CTRL, j_uinput.MOD_SHIFT, j_uinput.MOD_ALT, j_uinput.MOD_META))


class RecordingKeyboard:
    """A UinputKeyboard stand-in that types ASCII only, as the real one."""

    def __init__(self, log):
        self.log = log

    def type_prefix(self, text):
        i = 0
        while i < len(text) and ord(text[i]) < 128:
            i += 1
        if i:
            self.log.append(("kb-type", text[:i]))
        return i

    def key(self, name, mods=0, count=1):
        self.log.append(("kb-key", name, mods, count))
        return True


def _script(textout, settings_mod, method, handling, tool, keyboard, tools, calls):
    """Run one SystemTextOutput through paste/apply_text_diff/press_key;
    returns everything it asked of the OS, in order."""
    log = []
    s = settings_mod.AppSettings()
    s.paste_method = settings_mod.PasteMethod(method)
    s.clipboard_handling = settings_mod.ClipboardHandling(handling)
    s.typing_tool = settings_mod.TypingTool(tool)
    s.paste_delay_ms = 0

    def runner(cmd, stdin=None):
        log.append(("run", tuple(cmd), stdin))
        return True

    def reader(cmd):
        log.append(("read", tuple(cmd)))
        return "saved clipboard"

    def no_keyboard():
        raise OSError("no /dev/uinput")

    out = textout.SystemTextOutput(
        lambda: s, runner=runner, reader=reader, which=_which(tools),
        uinput_factory=(lambda: RecordingKeyboard(log)) if keyboard else no_keyboard)
    for name, args in calls:
        getattr(out, name)(*args)
    return log


CALLS = (("paste", ("hello world",)), ("paste_raw", ("naïve café",)),
         ("apply_text_diff", (7, 3, "fix")), ("apply_text_diff", (0, 2, "")),
         ("apply_text_diff", (4, 0, "ñ")), ("press_key", ("enter",)),
         ("press_key", ("ctrl+enter",)), ("press_key", ("cmd+enter",)),
         ("press_key", ("Tab",)))


@pytest.mark.parametrize("method", [m.value for m in j_settings.PasteMethod])
@pytest.mark.parametrize("handling", [h.value for h in j_settings.ClipboardHandling])
def test_system_text_output_issues_the_jax_commands(method, handling, monkeypatch):
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.delenv("XDG_SESSION_TYPE", raising=False)
    cases = [("auto", True, ("xdotool", "xclip")),
             ("auto", False, ("xdotool", "xclip")),
             ("auto", False, ("wtype", "wl-copy", "wl-paste", "xclip")),
             ("dotool", True, ("dotool", "xsel")),
             ("ydotool", False, ("ydotool", "xsel")),
             ("wtype", False, ()),
             ("auto", False, ())]
    for tool, keyboard, tools in cases:
        want = _script(j_textout, j_settings, method, handling, tool, keyboard,
                       tools, CALLS)
        got = _script(t_textout, t_settings, method, handling, tool, keyboard,
                      tools, CALLS)
        assert got == want, (tool, keyboard, tools)
    monkeypatch.setenv("WAYLAND_DISPLAY", "wayland-0")
    tools = ("wtype", "wl-copy", "wl-paste", "xclip")
    assert (_script(t_textout, t_settings, method, handling, "auto", False, tools, CALLS)
            == _script(j_textout, j_settings, method, handling, "auto", False, tools,
                       CALLS))


def test_native_library_builds_into_the_port_build_dir():
    """g++ builds native/spittle_input.cpp into build/spittle_tpu_torch/
    (the JAX package builds into native/build/), and the library exports
    the keyboard's entry points."""
    assert t_uinput._LIB == os.path.join(REPO, "build", "spittle_tpu_torch",
                                         "libspittle_input.so")
    assert t_uinput._SRC == j_uinput._SRC
    assert t_uinput._build()
    assert os.path.exists(t_uinput._LIB)
    assert not [f for f in os.listdir(os.path.dirname(t_uinput._LIB))
                if f.startswith("libspittle_input.so.") and f.endswith(".tmp")
                and f"{os.getpid()}" in f]
    lib = t_uinput.load_lib()
    assert lib is not None
    for sym in ("spittle_uinput_open", "spittle_uinput_type", "spittle_uinput_key",
                "spittle_uinput_close"):
        assert hasattr(lib, sym), sym


def test_available_probe_builds_nothing(tmp_path, monkeypatch):
    """load_lib(build=False), which available() uses, never runs g++."""
    lib = str(tmp_path / "build" / "libspittle_input.so")
    monkeypatch.setattr(t_uinput, "_LIB", lib)
    monkeypatch.setattr(t_uinput, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_uinput, "_lib", None)
    monkeypatch.setattr(t_uinput, "_build_failed", False)
    monkeypatch.setattr(t_uinput, "_build", lambda: pytest.fail("built"))
    assert t_uinput.load_lib(build=False) is None
    assert not t_uinput._build_failed
    assert not os.path.exists(tmp_path / "build")
    if not (os.path.exists("/dev/uinput") and os.access("/dev/uinput", os.W_OK)):
        assert t_uinput.UinputKeyboard.available() is False


def test_uinput_keyboard_without_a_device_raises(monkeypatch):
    """Opening the keyboard without /dev/uinput write access raises
    OSError, which SystemTextOutput treats as no keyboard."""
    if os.path.exists("/dev/uinput") and os.access("/dev/uinput", os.W_OK):
        pytest.skip("/dev/uinput is writable here")
    with pytest.raises(OSError):
        t_uinput.UinputKeyboard()


def _platform_branch(pkg, branch, monkeypatch):
    """One textout branch of macOS or Windows with sys.platform patched,
    over the fakes of tests/test_torch_shell_{windows,macos}.py: the
    runner's commands, the SendInput arrays' bytes, the clipboard calls
    and memory, and the AX selections."""
    settings = importlib.import_module(f"{pkg}.config.settings")
    s = settings.AppSettings()
    s.paste_delay_ms = 0
    commands = []
    out = importlib.import_module(f"{pkg}.shell.textout").SystemTextOutput(
        lambda: s, runner=lambda c, i=None: commands.append((tuple(c), i)) or True,
        reader=lambda c: "", which=_which(("xclip", "xdotool")))
    if branch == "ax":
        monkeypatch.setattr(sys, "platform", "darwin")
        ax = importlib.import_module(f"{pkg}.shell.macos_ax")
        be = FakeAX(location=30, ax_error=ax.AXError)
        monkeypatch.setattr(ax, "_default", be)  # the platform's default backend
        monkeypatch.setattr(ax, "_default_resolved", True)
        out.apply_text_diff(2, 4, "new")
        out.apply_text_diff(0, 3, "")
        return commands, be.set_calls
    monkeypatch.setattr(sys, "platform", "win32")
    wi = importlib.import_module(f"{pkg}.shell.windows_input")
    wc = importlib.import_module(f"{pkg}.shell.windows_clipboard")
    u32, cu32, k32, sleeps = FakeUser32(), FakeClipUser32(), FakeKernel32(), []
    base, write, read = wi.SendInputKeyboard, wc.clipboard_write, wc.clipboard_read
    monkeypatch.setattr(wi, "SendInputKeyboard", type("SendInputKeyboard", (base,), {
        "__init__": lambda self: base.__init__(self, user32=u32, sleep=sleeps.append)}))
    monkeypatch.setattr(wc, "clipboard_write", lambda t: write(t, user32=cu32, kernel32=k32))
    monkeypatch.setattr(wc, "clipboard_read", lambda: read(user32=cu32, kernel32=k32))
    got = []
    if branch == "keyboard":
        s.paste_method = settings.PasteMethod.DIRECT
        out.paste_raw("hi")
        out.paste_raw("é")  # not ASCII: the tool chain types it
        out.apply_text_diff(1, 1, "x")
        out.press_key("enter")
    elif branch == "clipboard_write":
        s.paste_method = settings.PasteMethod.CTRL_V
        out.paste_raw("hello")
        got.append(out._clipboard_write("again"))
    else:
        s.paste_method = settings.PasteMethod.SHIFT_INSERT
        s.clipboard_handling = settings.ClipboardHandling.DONT_MODIFY
        got.append(out._clipboard_read())
        write("old", user32=cu32, kernel32=k32)
        out.paste_raw("new")
        got.append(out._clipboard_read())
    return (commands, [b[2] for b in u32.batches], sleeps, cu32.calls, k32.contents(),
            got)


@pytest.mark.parametrize("branch", ["keyboard", "clipboard_write", "clipboard_read",
                                    "ax"])
def test_windows_and_macos_branches(branch, monkeypatch):
    """With sys.platform patched, the Windows SendInput and clipboard
    branches and the macOS AX selection reach each package's own module,
    and the port makes the JAX package's calls over the same fakes."""
    got = {pkg: _platform_branch(pkg, branch, monkeypatch)
           for pkg in ("spittle_tpu", "spittle_tpu_torch")}
    assert got["spittle_tpu_torch"] == got["spittle_tpu"]
    if branch == "ax":
        commands, selections = got["spittle_tpu_torch"]
        assert selections == [(24, 4), (27, 3)]
        keys = [" ".join(c) for c, _ in commands]
        assert not any("Left" in k for k in keys)
        assert sum("BackSpace" in k for k in keys) == 1  # clears the second
        return
    commands, batches, sleeps, clip_calls, memory, results = got["spittle_tpu_torch"]
    if branch == "keyboard":
        assert [c[0][:2] for c in commands] == [("xdotool", "type")]
        assert len(batches) == 6 and memory == []
        return
    assert commands == []  # no tool ran: SendInput and the Win32 clipboard
    if branch == "clipboard_write":
        assert results == [True] and len(batches) == 2 and len(sleeps) == 1
        assert memory == [w.encode("utf-16-le") + b"\x00\x00" for w in ("hello", "again")]
    else:
        assert results == [None, "old"]  # the saved text was put back
        assert [m.decode("utf-16-le") for m in memory] == ["old\x00", "new\x00", "old\x00"]
