"""The port's evdev hotkey listener (spittle_tpu_torch/shell/evdev_keys.py)
against the JAX package's on the CPU, at exact equality: the packed
input_event bytes, hotkey normalization, and one byte stream of kernel
key events (chords, a broken chord, autorepeat, a cancel mid-chord, codes
the table lacks, EV_SYN, an event split across writes) through a pipe
into each package's EvdevBackend(fds=[r]): the same chord callbacks in
the same order, and, through each package's ShortcutRegistry in capture
mode, the same FrontendKeyEvents."""

import dataclasses
import os
import time

import pytest

from spittle_tpu.app.shortcuts import ShortcutRegistry as JRegistry
from spittle_tpu.config.settings import KeyboardImplementation as JImpl
from spittle_tpu.events import HANDY_KEYS_EVENT, EventBus as JBus
from spittle_tpu.shell import evdev_keys as j_evdev
from spittle_tpu_torch.app.shortcuts import ShortcutRegistry as TRegistry
from spittle_tpu_torch.config.settings import KeyboardImplementation as TImpl
from spittle_tpu_torch.events import EventBus as TBus
from spittle_tpu_torch.shell import evdev_keys as t_evdev

HOTKEYS = ("ctrl+space", "ctrl+shift+space", "escape", "a", "alt+f4",
           "super+b", "control+option+c")


def test_wire_format_and_tables_match():
    assert (t_evdev.EVENT_FORMAT, t_evdev.EVENT_SIZE, t_evdev.EV_KEY) == (
        j_evdev.EVENT_FORMAT, j_evdev.EVENT_SIZE, j_evdev.EV_KEY)
    assert t_evdev.KEYCODES == j_evdev.KEYCODES
    assert t_evdev.KEY_TO_CODE == j_evdev.KEY_TO_CODE
    assert t_evdev.MODIFIER_KEYS == j_evdev.MODIFIER_KEYS
    for name in j_evdev.KEY_TO_CODE:
        for pressed in (True, False):
            assert t_evdev.pack_key(name, pressed) == j_evdev.pack_key(name, pressed)
    for code, value, ev_type in ((30, 2, 1), (0, 0, 0), (57, 1, 4), (300, -1, 1)):
        assert (t_evdev.pack_event(code, value, ev_type)
                == j_evdev.pack_event(code, value, ev_type))
    for hk in HOTKEYS + ("", "+", "shift+", "hyper+x", "Ctrl + Alt + Del", "cmd+meta+k"):
        assert t_evdev.normalize_hotkey(hk) == j_evdev.normalize_hotkey(hk), hk


def _stream(mod):
    """The key-event byte stream, written in two parts: the second begins
    with the back half of a split event."""
    k, e = mod.pack_key, mod.pack_event
    data = b"".join([
        k("ctrl", True), k("space", True), k("space", False), k("ctrl", False),
        k("ctrl", True), k("shift", True), k("space", True), e(57, 2),
        k("space", False), k("shift", False), k("ctrl", False),
        k("ctrl", True), k("space", True), k("escape", True), k("escape", False),
        k("ctrl", False), k("space", False),  # a broken chord, then the key
        k("space", True), k("space", False),  # no modifier: nothing fires
        e(30, 1), e(30, 2), e(30, 2), e(30, 0),  # autorepeat ignored
        e(0, 0, 0), e(240, 1), e(240, 0),  # EV_SYN, a code the table lacks
        k("alt", True), k("f4", True), k("alt", False), k("f4", False),
        k("super", True), k("b", True), k("b", False), k("super", False),
        k("ctrl", True), k("alt", True), k("c", True), k("c", False),
        k("alt", False), k("ctrl", False),
    ])
    tail = k("shift", True) + k("q", True) + k("q", False) + k("shift", False)
    cut = len(data) + mod.EVENT_SIZE // 2
    whole = data + tail
    return whole[:cut], whole[cut:]


def _drive(evdev, registry_cls, impl, bus_cls):
    """One package's listener over a pipe: the chord callbacks and the
    FrontendKeyEvents of capture mode, in order."""
    r, w = os.pipe()
    be = evdev.EvdevBackend(fds=[r])
    fired, frontend = [], []
    bus = bus_cls()
    bus.listen(HANDY_KEYS_EVENT, frontend.append)
    reg = registry_cls(backends={impl.HANDY_KEYS: be},
                       handler=lambda b, hk, p: fired.append(("registry", b, hk, p)),
                       events=bus, implementation=impl.HANDY_KEYS)
    try:
        for hk in HOTKEYS:
            assert be.register(hk, lambda h, p: fired.append(("backend", h, p)))
        assert reg.register_binding("transcribe", "ctrl+alt+c")
        reg.start_key_capture()
        be.start_capture(reg.feed_captured_key)
        first, second = _stream(evdev)
        os.write(w, first)
        time.sleep(0.05)
        os.write(w, second)
        os.close(w)
        be.listener._thread.join(timeout=10)
        assert not be.listener._thread.is_alive()
    finally:
        be.close()
    return fired, [dataclasses.asdict(ev) for ev in frontend]


def test_pipe_stream_gives_the_jax_events():
    want = _drive(j_evdev, JRegistry, JImpl, JBus)
    got = _drive(t_evdev, TRegistry, TImpl, TBus)
    assert got == want
    fired, frontend = got
    assert ("backend", "ctrl+space", True) in fired
    assert ("backend", "ctrl+shift+space", True) in fired
    assert ("backend", "escape", True) in fired
    # Key capture holds the registry's own bindings back.
    assert not [f for f in fired if f[0] == "registry"]
    assert {"modifiers": ["shift"], "key": "q", "is_key_down": True,
            "hotkey_string": "shift+q"} in frontend


@pytest.mark.parametrize("mod", [j_evdev, t_evdev], ids=["jax", "port"])
def test_no_devices_refuses_registration(mod):
    be = mod.EvdevBackend(fds=[])
    try:
        assert not be.register("ctrl+space", lambda hk, p: None)
        assert be.listener.device_count == 0
    finally:
        be.close()


def test_discovery_matches(tmp_path):
    """discover_keyboards over a pattern with no devices and over files
    that are no input devices: both packages open nothing."""
    (tmp_path / "event0").write_bytes(b"")
    for pattern in (str(tmp_path / "none*"), str(tmp_path / "event*")):
        assert t_evdev.discover_keyboards(pattern) == j_evdev.discover_keyboards(pattern) == []
