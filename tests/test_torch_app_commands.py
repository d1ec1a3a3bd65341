"""The port's command surface (spittle_tpu_torch/app/{commands,
bindings_export,shortcuts}.py) against the JAX package's on the CPU: the
command and settings descriptions the bindings export gives, every
settings command of the schema applied to both packages from the same
start (the settings JSON and the settings-changed payloads), the binding
commands and the keyboard-implementation switch over InMemoryBackend
registries, jargon-pack import and export, and prompt CRUD. Both packages
run AppServices with the MockEngine; the port's on device="cpu"."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from spittle_tpu.app import actions as j_actions
from spittle_tpu.app import bindings_export as j_export
from spittle_tpu.app import commands as j_commands
from spittle_tpu.app import rpc_server as j_rpc
from spittle_tpu.app import services as j_services
from spittle_tpu.app import shortcuts as j_shortcuts
from spittle_tpu.audio import recorder as j_recorder
from spittle_tpu.config import settings as j_settings
from spittle_tpu import pipeline as j_pipeline
from spittle_tpu_torch.app import actions as t_actions
from spittle_tpu_torch.app import bindings_export as t_export
from spittle_tpu_torch.app import commands as t_commands
from spittle_tpu_torch.app import rpc_server as t_rpc
from spittle_tpu_torch.app import services as t_services
from spittle_tpu_torch.app import shortcuts as t_shortcuts
from spittle_tpu_torch.audio import recorder as t_recorder
from spittle_tpu_torch.config import settings as t_settings
from spittle_tpu_torch import pipeline as t_pipeline
from _fresh_sources import FreshSources  # noqa: E402

JAX = SimpleNamespace(actions=j_actions, export=j_export, commands=j_commands,
                      rpc=j_rpc, services=j_services, shortcuts=j_shortcuts,
                      recorder=j_recorder, settings=j_settings,
                      pipeline=j_pipeline, kw={})
PORT = SimpleNamespace(actions=t_actions, export=t_export, commands=t_commands,
                       rpc=t_rpc, services=t_services, shortcuts=t_shortcuts,
                       recorder=t_recorder, settings=t_settings,
                       pipeline=t_pipeline, kw={"device": "cpu"})

# The arguments each settings command of the schema is given: a value off
# the default, of the field's kind. Every field the schema maps to a
# command has an entry (test_every_schema_command_has_a_case).
SETTINGS_CASES = {
    "bindings": ("change_binding", ("transcribe", "ctrl+f13")),
    "push_to_talk": ("change_ptt_setting", (False,)),
    "audio_feedback": ("change_audio_feedback_setting", (True,)),
    "audio_feedback_volume": ("change_audio_feedback_volume_setting", (0.25,)),
    "sound_theme": ("change_sound_theme_setting", ("pop",)),
    "start_hidden": ("change_start_hidden_setting", (True,)),
    "autostart_enabled": ("change_autostart_setting", (True,)),
    "update_checks_enabled": ("change_update_checks_setting", (False,)),
    "selected_model": ("set_active_model", ("small",)),  # not downloaded: raises
    "always_on_microphone": ("update_microphone_mode", (True,)),
    "selected_microphone": ("set_selected_microphone", ("USB Mic",)),
    "clamshell_microphone": ("set_clamshell_microphone", ("Built-in",)),
    "selected_output_device": ("set_selected_output_device", ("Speakers",)),
    "translate_to_english": ("change_translate_to_english_setting", (True,)),
    "selected_language": ("change_selected_language_setting", ("de",)),
    "overlay_position": ("change_overlay_position_setting", ("bottom",)),
    "debug_mode": ("change_debug_mode_setting", (True,)),
    "log_level": ("set_log_level", ("warn",)),
    "custom_words": ("update_custom_words", (["Kubernetes", "gRPC"],)),
    "model_unload_timeout": ("set_model_unload_timeout", ("min5",)),
    "word_correction_threshold": ("change_word_correction_threshold_setting", (0.42,)),
    "history_limit": ("update_history_limit", (3,)),
    "recording_retention_period": ("update_recording_retention_period", ("days3",)),
    "paste_method": ("change_paste_method_setting", ("ctrl_v",)),
    "clipboard_handling": ("change_clipboard_handling_setting", ("copy_to_clipboard",)),
    "auto_submit": ("change_auto_submit_setting", (True,)),
    "auto_submit_key": ("change_auto_submit_key_setting", ("ctrl_enter",)),
    "post_process_enabled": ("change_post_process_enabled_setting", (True,)),
    "post_process_auto_prompt_selection":
        ("change_post_process_auto_prompt_selection_setting", (True,)),
    "post_process_provider_id": ("set_post_process_provider", ("anthropic",)),
    "post_process_providers": ("set_post_process_provider", ("groq",)),
    "post_process_api_keys": ("change_post_process_api_key_setting", ("openai", "sk-1")),
    "post_process_models": ("change_post_process_model_setting", ("openai", "gpt-x")),
    "post_process_prompts": ("update_post_process_prompt",
                             ("default_improve_transcriptions", "Mine", "Fix: ${output}")),
    "post_process_selected_prompt_id": ("set_post_process_selected_prompt", ("p1",)),
    "mute_while_recording": ("change_mute_while_recording_setting", (True,)),
    "audio_segment_size_seconds": ("change_audio_segment_size_seconds_setting", (2.5,)),
    "append_trailing_space": ("change_append_trailing_space_setting", (True,)),
    "app_language": ("change_app_language_setting", ("zh-TW",)),
    "experimental_enabled": ("change_experimental_enabled_setting", (True,)),
    "keyboard_implementation": ("change_keyboard_implementation_setting", ("handy_keys",)),
    "show_tray_icon": ("change_show_tray_icon_setting", (False,)),
    "typing_tool": ("change_typing_tool_setting", ("xdotool",)),
    "at_file_expansion_enabled": ("change_at_file_expansion_setting", (True,)),
    "jargon_enabled_profiles": ("update_jargon_profiles", (["web_dev"],)),
    "jargon_custom_terms": ("update_jargon_custom_terms", (["Pallas", "wgmma"],)),
    "jargon_custom_corrections": ("update_jargon_custom_corrections",
                                  ([{"from": "pallas", "to": "Pallas"}],)),
    "domain_selector_enabled": ("update_domain_selector_enabled_setting", (True,)),
    "domain_selector_timeout_ms": ("update_domain_selector_timeout_ms_setting", (250,)),
    "domain_selector_top_k": ("update_domain_selector_top_k_setting", (3,)),
    "domain_selector_min_score": ("update_domain_selector_min_score_setting", (0.3,)),
    "domain_selector_hysteresis": ("update_domain_selector_hysteresis_setting", (0.2,)),
    "domain_selector_blend_manual_profiles":
        ("update_domain_selector_blend_manual_profiles_setting", (False,)),
    "jargon_packs": ("update_jargon_packs", ([{"id": "p1", "label": "Pack", "terms": ["X"],
                                               "corrections": [{"from": "ex", "to": "X"}]}],)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class App:
    """One package's services, actions and Commands over a QueueSource and
    the MockEngine, with every settings-changed payload recorded."""

    def __init__(self, pkg, data_dir):
        self.pkg = pkg
        self.src = FreshSources(pkg.recorder.QueueSource)
        self.services = pkg.services.AppServices(
            str(data_dir), source_factory=self.src, use_mock_engine=True,
            **pkg.kw)
        self.out = pkg.pipeline.BufferTextOutput()
        self.actions = pkg.actions.ActionContext(self.services, self.out)
        self.cmds = pkg.commands.Commands(self.services, self.actions)
        self.changed = []
        self.services.events.listen(
            "settings-changed", lambda p: self.changed.append(pkg.rpc.jsonify(p)))

    def call(self, name, *args):
        """(result as JSON, or the exception's type and message)."""
        try:
            return ("ok", self.pkg.rpc.jsonify(getattr(self.cmds, name)(*args)))
        except Exception as exc:  # both packages must raise alike
            return ("raised", type(exc).__name__, str(exc))

    def settings_json(self):
        """(the settings file's JSON, None before the first write; the live
        settings as the RPC wire serializes them)."""
        path = os.path.join(self.services.data_dir, "settings_store.json")
        stored = None
        if os.path.exists(path):
            with open(path) as f:
                stored = json.load(f)
        return stored, self.pkg.rpc.jsonify(self.cmds.get_app_settings())

    def close(self):
        self.services.shutdown()


@pytest.fixture
def apps(tmp_path):
    made = [App(JAX, tmp_path / "jax"), App(PORT, tmp_path / "port")]
    yield made
    for app in made:
        app.close()


def _mask(obj):
    """The bindings export with the package names masked."""
    return json.loads(json.dumps(obj).replace("spittle_tpu_torch", "PKG")
                      .replace("spittle_tpu", "PKG"))


@pytest.mark.parametrize("describe", ["describe_commands", "describe_settings",
                                      "describe_types", "export_dts"])
def test_bindings_export_equals_the_jax_packages(describe):
    got = _mask(getattr(t_export, describe)())
    assert got == _mask(getattr(j_export, describe)())
    if describe == "describe_commands":
        public = sorted(n for n, f in vars(t_commands.Commands).items()
                        if not n.startswith("_") and callable(f))
        assert [c["name"] for c in got] == public and len(public) == 107


def test_every_schema_command_has_a_case():
    mapped = {s["name"]: s["command"] for s in t_export.describe_settings()
              if s["command"] is not None}
    assert {k: v[0] for k, v in SETTINGS_CASES.items()} == mapped


@pytest.mark.parametrize("field", sorted(SETTINGS_CASES))
def test_settings_command_matches_the_jax_package(apps, field):
    name, args = SETTINGS_CASES[field]
    results = [(app.call(name, *args), app.settings_json(), app.changed)
               for app in apps]
    assert results[0] == results[1]
    result, (stored, live), _ = results[1]
    if name == "set_active_model":
        assert result[:2] == ("raised", "FileNotFoundError")
        return
    assert result[0] == "ok", result
    # The command moved its field off the default (set_post_process_provider
    # moves the provider id; the schema maps the provider list to it too).
    default = t_rpc.jsonify(t_settings.get_default_settings())
    moved = sorted(k for k in live if live[k] != default[k])
    want = "post_process_provider_id" if field == "post_process_providers" else field
    assert want in moved, (field, moved)
    assert stored is not None and stored[want] is not None


def _registry(pkg, app, fail_handy=False):
    KI = pkg.settings.KeyboardImplementation
    backends = {KI.TAURI: pkg.shortcuts.InMemoryBackend(),
                KI.HANDY_KEYS: pkg.shortcuts.InMemoryBackend(fail_register=fail_handy)}
    fired = []
    reg = pkg.shortcuts.ShortcutRegistry(
        backends, lambda b, hk, pressed: fired.append((b, hk, pressed)),
        events=app.services.events,
        persist_implementation=lambda impl: app.services.update_settings(
            keyboard_implementation=impl))
    app.actions.registry = reg
    return reg, backends, fired


@pytest.mark.parametrize("fail_handy", [False, True])
def test_binding_commands_and_keyboard_switch(apps, fail_handy):
    """change/reset/suspend/resume_binding, the implementation switch (an
    invalid value, an unavailable backend, a backend that rejects every
    hotkey), key capture and its handy-keys events, over InMemoryBackend
    registries: the same results, registrations and settings."""
    runs = []
    for app in apps:
        pkg = app.pkg
        reg, backends, fired = _registry(pkg, app, fail_handy)
        KI = pkg.settings.KeyboardImplementation
        keys = []
        app.services.events.listen("handy-keys-event",
                                   lambda p: keys.append(pkg.rpc.jsonify(p)))
        for bid, b in app.services.get_settings().bindings.items():
            reg.register_binding(bid, b.current_binding)
        steps = [
            app.call("change_binding", "transcribe", "ctrl+f13"),
            app.call("change_binding", "nope", "x"),
            app.call("reset_binding", "transcribe"),
            app.call("suspend_binding", "transcribe"),
            sorted(backends[KI.TAURI].registered),
            app.call("resume_binding", "transcribe"),
            app.call("start_handy_keys_recording", "transcribe"),
            app.call("change_keyboard_implementation_setting", "bogus"),
            app.call("change_keyboard_implementation_setting", "handy_keys"),
            app.call("get_keyboard_implementation"),
            (sorted(backends[KI.TAURI].registered),
             sorted(backends[KI.HANDY_KEYS].registered)),
            app.call("start_handy_keys_recording", "transcribe"),
        ]
        reg.feed_captured_key("k", True, ["ctrl", "shift"])
        steps.append(app.call("stop_handy_keys_recording"))
        reg.feed_captured_key("j", True)  # capture off: no event
        for hk in sorted(reg.backend.registered):
            reg.backend.fire(hk, True)
        steps += [app.call("change_keyboard_implementation_setting", "tauri"),
                  app.call("get_keyboard_implementation")]
        del reg.backends[KI.HANDY_KEYS]
        steps.append(app.call("change_keyboard_implementation_setting", "handy_keys"))
        runs.append((steps, fired, keys, app.changed, app.settings_json()))
    assert runs[0] == runs[1]
    steps, fired, keys = runs[1][:3]
    assert steps[1][:2] == ("raised", "KeyError")
    assert steps[7] == ("ok", {"success": False, "reset_bindings": []})
    assert keys == [{"modifiers": ["ctrl", "shift"], "key": "k", "is_key_down": True,
                     "hotkey_string": "ctrl+shift+k"}]


def test_jargon_packs_and_prompt_crud(apps):
    payload = json.dumps([{"id": "p1", "label": "Pack", "terms": ["X"],
                           "corrections": [{"from": "ex", "to": "X"}]},
                          {"id": "p2", "label": "Two", "terms": []}])
    runs = []
    for app in apps:
        steps = [
            app.call("import_jargon_packs_json", payload),
            app.call("import_jargon_packs_json", payload),  # deduplicated by id
            app.call("import_jargon_packs_json", json.dumps({"id": "p3", "label": "3"})),
            app.call("export_jargon_packs_json"),
            app.call("get_jargon_packs"),
            app.call("get_jargon_builtin_profiles"),
            app.call("add_post_process_prompt", "mine", "Mine", "Do ${output}"),
            app.call("update_post_process_prompt", "mine", "Mine2", "Do it: ${output}"),
            app.call("set_post_process_selected_prompt", "mine"),
            app.call("delete_post_process_prompt", "mine"),
            app.call("change_post_process_base_url_setting", "custom", "http://127.0.0.1:1/v1"),
            app.call("change_post_process_base_url_setting", "openai", "http://x"),
            app.call("fetch_post_process_models", "nope"),
        ]
        runs.append((steps, app.changed, app.settings_json()))
    assert runs[0] == runs[1]
    steps = runs[1][0]
    assert [s[1] for s in steps[:3]] == [2, 0, 1]
    assert [p["id"] for p in json.loads(steps[3][1])] == ["p1", "p2", "p3"]
    assert steps[11][:2] == ("raised", "PermissionError")
    assert runs[1][2][1]["post_process_selected_prompt_id"] is None
