"""The port's UI state (spittle_tpu_torch/app/ui_state.py), the i18n table
(config/i18n.py) and the shell modules it reaches (shell/{apple_llm,
audio_out,audio_devices}.py) against the JAX package's on the CPU.

The first test is the shortcut path with a UI bundle: an ActionContext
given AppUi(..., player=<recording>) imported app/ui_state on its first
press, which the port lacked (ModuleNotFoundError). Both packages run
AppServices with the MockEngine; the port's on device="cpu"."""

import time

import numpy as np
import pytest
import torch

from spittle_tpu.app import actions as j_actions
from spittle_tpu.app import services as j_services
from spittle_tpu.app import ui_state as j_ui
from spittle_tpu.audio import recorder as j_recorder
from spittle_tpu.config import i18n as j_i18n
from spittle_tpu.config import settings as j_settings
from spittle_tpu.events import EventBus as JEventBus
from spittle_tpu.shell import apple_llm as j_apple
from spittle_tpu.shell import audio_devices as j_devices
from spittle_tpu.shell import audio_out as j_audio_out
from spittle_tpu import pipeline as j_pipeline
from spittle_tpu_torch.app import actions as t_actions
from spittle_tpu_torch.app import services as t_services
from spittle_tpu_torch.app import ui_state as t_ui
from spittle_tpu_torch.audio import recorder as t_recorder
from spittle_tpu_torch.config import i18n as t_i18n
from spittle_tpu_torch.config import settings as t_settings
from spittle_tpu_torch.events import EventBus as TEventBus
from spittle_tpu_torch.shell import apple_llm as t_apple
from spittle_tpu_torch.shell import audio_devices as t_devices
from spittle_tpu_torch.shell import audio_out as t_audio_out
from spittle_tpu_torch import pipeline as t_pipeline

JAX = (j_actions, j_services, j_ui, j_recorder, j_pipeline, {})
PORT = (t_actions, t_services, t_ui, t_recorder, t_pipeline, {"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _ui_cycle(pkg, data_dir, push_to_talk, always_on):
    """One press/release of "transcribe" through an ActionContext with a UI
    bundle whose player records. Returns the tray states, the sounds
    played (file name, volume), what feedback.played kept, the overlay's
    last state and the pasted text."""
    actions, services, ui_state, recorder, pipeline, kw = pkg
    src = recorder.QueueSource(16000)
    svc = services.AppServices(str(data_dir), source_factory=lambda: src,
                               use_mock_engine=True, **kw)
    try:
        svc.update_settings(audio_feedback=True, audio_feedback_volume=0.5,
                            push_to_talk=push_to_talk, overlay_position="bottom")
        svc.transcription.load_model("mock", "/fake", "whisper")
        svc.transcription._engine.canned_text = "canned words"
        if always_on:
            svc.update_settings(always_on_microphone=True)
            svc.audio.update_mode(True)
        played, trays = [], []
        svc.events.listen("tray-state-changed", trays.append)
        ui = ui_state.AppUi(svc, player=lambda p, v: played.append((p, v)))
        out = pipeline.BufferTextOutput()
        ctx = actions.ActionContext(svc, out, ui=ui)
        ctx.handle_shortcut_event("transcribe", "ctrl+space", True)
        assert svc.audio.is_recording()
        t = np.arange(16000) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        for i in range(0, len(audio), 480):
            src.push(audio[i:i + 480])
        ctx.handle_shortcut_event("transcribe", "ctrl+space", not push_to_talk)
        _wait(lambda: svc.toggle_state.get("transcribe") is False, "the pipeline")
        _wait(lambda: ui.tray.state is ui_state.TrayIconState.IDLE, "the tray")
        rel = [(p[len(str(data_dir)):], v) for p, v in played]
        return (trays, rel, [p[len(str(data_dir)):] for p in ui.feedback.played],
                (ui.overlay.visible, ui.overlay.state), ui.tray.strings, out.buffer)
    finally:
        svc.shutdown()


@pytest.mark.parametrize("push_to_talk,always_on", [(True, False), (False, True)])
def test_action_context_with_a_ui_bundle(tmp_path, push_to_talk, always_on):
    got = _ui_cycle(PORT, tmp_path / "port", push_to_talk, always_on)
    want = _ui_cycle(JAX, tmp_path / "jax", push_to_talk, always_on)
    assert got == want
    trays, played, kept, overlay, _, pasted = got
    assert trays[:2] == ["recording", "transcribing"] and trays[-1] == "idle"
    assert played == [("/resources/marimba_start.wav", 0.5),
                      ("/resources/marimba_stop.wav", 0.5)]
    assert kept == [p for p, _ in played]
    assert overlay == (False, "transcribing") and pasted == "canned words "


def test_theme_sounds_are_byte_equal(tmp_path):
    got = t_audio_out.synthesize_theme_sounds(str(tmp_path / "port"))
    want = j_audio_out.synthesize_theme_sounds(str(tmp_path / "jax"))
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want]
    assert len(got) == 4
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    # A volume-scaled copy for players without a volume flag.
    argv_t, tmp_t = t_audio_out.build_player_cmd("aplay", got[0], 0.5)
    argv_j, tmp_j = j_audio_out.build_player_cmd("aplay", want[0], 0.5)
    with open(tmp_t, "rb") as fa, open(tmp_j, "rb") as fb:
        assert fa.read() == fb.read()
    for tool, volume in (("paplay", 0.25), ("afplay", 0.25), ("pw-play", 1.0)):
        assert (t_audio_out.build_player_cmd(tool, "x.wav", volume)
                == j_audio_out.build_player_cmd(tool, "x.wav", volume))


def test_i18n_tables_are_equal():
    assert t_i18n.load_app_i18n() == j_i18n.load_app_i18n()
    assert t_i18n.available_locales() == j_i18n.available_locales()
    assert len(t_i18n.available_locales()) == 17
    for locale in ("en", "de-DE", "zh-TW", "zh", "pt_BR", "xx", None):
        assert t_i18n.get_locale_table(locale) == j_i18n.get_locale_table(locale)
        assert t_ui.get_tray_translations(locale) == j_ui.get_tray_translations(locale)
        for key in ("tray.settings", "settings.general.language.title", "no.such.key"):
            assert t_i18n.translate(key, locale) == j_i18n.translate(key, locale)


@pytest.mark.parametrize("position", ["none", "top", "bottom"])
def test_tray_and_overlay_controllers(position):
    runs = []
    for ui, settings, bus in ((t_ui, t_settings, TEventBus()),
                              (j_ui, j_settings, JEventBus())):
        s = settings.AppSettings()
        s.overlay_position = settings.OverlayPosition(position)
        seen = []
        bus.listen_all(lambda e, p: seen.append((e, p)))
        tray = ui.TrayController(bus, "de")
        ov = ui.OverlayController(bus, lambda: s)
        states = []
        for payload in ("recording", {"state": "processing"}, None):
            bus.emit("show-overlay", payload)
            states.append((ov.visible, ov.state))
        bus.emit("hide-overlay", None)
        tray.set_state(ui.TrayIconState.TRANSCRIBING)
        runs.append((states, ov.visible, tray.menu_items(), seen))
    assert runs[0] == runs[1]


def test_apple_shim_is_absent_in_both(monkeypatch):
    monkeypatch.delenv(t_apple.DYLIB_ENV, raising=False)
    for apple, ui in ((t_apple, t_ui), (j_apple, j_ui)):
        apple.reset_default_client()
        assert apple.default_client() is None
        assert ui.check_apple_intelligence_availability() is False
        with pytest.raises(apple.AppleLLMError, match="macOS-arm64-only"):
            ui.apple_intelligence_process_text("p", 8)
    assert t_pipeline.PipelineHooks().apple_intelligence_available() is False


PACTL = ("0\talsa_input.usb-mic\tmodule-alsa-card.c\ts16le 1ch 48000Hz\tRUNNING\n"
         "1\talsa_output.hdmi.monitor\tmodule-alsa-card.c\ts16le 2ch\tIDLE\n"
         "2\tbluez_input.headset\tmodule-bluez5\ts16le 1ch 16000Hz\tSUSPENDED\n")
ARECORD = ("**** List of CAPTURE Hardware Devices ****\n"
           "card 0: PCH [HDA Intel PCH], device 0: ALC3246 Analog [ALC3246 Analog]\n"
           "card 2: Mic [USB Mic], device 1: USB Audio [USB Audio]\n")


@pytest.mark.parametrize("tools", [("pactl",), ("arecord", "aplay"), ()])
def test_audio_devices_and_platform_probes(tools):
    def run(cmd):
        if cmd[0] == "pactl":
            return {"get-default-source": "bluez_input.headset\n",
                    "get-default-sink": "alsa_input.usb-mic\n"}.get(cmd[1], PACTL)
        return ARECORD

    def which(tool):
        return tool if tool in tools else None

    def probe_run(argv, **kw):
        class Out:
            stdout = b'"AppleClamshellState" = Yes Now drawing from Battery'
        return Out()

    got = [t_devices.list_input_devices(which, run), t_devices.list_output_devices(which, run),
           t_ui.is_clamshell(probe_run), t_ui.is_laptop(probe_run)]
    want = [j_devices.list_input_devices(which, run), j_devices.list_output_devices(which, run),
            j_ui.is_clamshell(probe_run), j_ui.is_laptop(probe_run)]
    assert [[vars(d) for d in got[0]], [vars(d) for d in got[1]]] + got[2:] == (
        [[vars(d) for d in want[0]], [vars(d) for d in want[1]]] + want[2:])
    if tools:
        assert got[0]
