"""Command surface: the typed API the desktop front end calls.

Port of spittle_tpu/app/commands.py.

Mirrors the reference's Tauri command registry — the ~106 commands exported
through tauri-specta into `src/bindings.ts` (`src-tauri/src/lib.rs:254-361`,
`src-tauri/src/commands/`, `shortcut/mod.rs` settings commands). Every
binding has a snake_case method here with the same semantics; the desktop
shell maps its RPC layer onto this class 1:1. OS-only commands (opening
folders, enigo/shortcut runtime init, Apple Intelligence checks) are
documented no-ops or hook points so the surface stays complete.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from spittle_tpu_torch.config.settings import (
    AppSettings,
    JargonCorrection,
    JargonPack,
    KeyboardImplementation,
    LLMPrompt,
    get_default_settings,
)
from spittle_tpu_torch.events import CHECK_FOR_UPDATES, SETTINGS_CHANGED
from spittle_tpu_torch.text.jargon import builtin_profiles
from spittle_tpu_torch import llm_client
from . import ui_state
from .actions import ActionContext
from .services import AppServices


class Commands:
    """One method per bindings.ts command."""

    def __init__(self, services: AppServices, actions: ActionContext):
        self.services = services
        self.actions = actions
        # Console URL of the serving RPC front; set by AppRpcServer on
        # start. show_main_window (single-instance callback target)
        # reports it.
        self.console_url: str = ""

    # -- settings helpers -------------------------------------------------

    def _update(self, **changes) -> None:
        self.services.update_settings(**changes)
        # Reference wire shape (shortcut/mod.rs:566-636): one
        # settings-changed event per field, {"setting": name, "value": v}.
        for setting, value in changes.items():
            self.services.events.emit(
                SETTINGS_CHANGED, {"setting": setting, "value": value}
            )

    # -- bindings ---------------------------------------------------------

    def change_binding(self, binding_id: str, new_binding: str) -> None:
        s = self.services.get_settings()
        if binding_id not in s.bindings:
            raise KeyError(binding_id)
        s.bindings[binding_id].current_binding = new_binding
        self.services.write_settings(s)

    def reset_binding(self, binding_id: str) -> None:
        s = self.services.get_settings()
        b = s.bindings[binding_id]
        b.current_binding = b.default_binding
        self.services.write_settings(s)

    def suspend_binding(self, binding_id: str) -> None:
        """Stop routing a binding's actions and unregister its OS hotkey
        until resumed (shortcut/mod.rs:214-238 — the UI suspends the
        binding it is re-recording)."""
        self.actions.suspended.add(binding_id)
        if self.actions.registry is not None:
            self.actions.registry.suspend_binding(binding_id)

    def resume_binding(self, binding_id: str) -> None:
        self.actions.suspended.discard(binding_id)
        if self.actions.registry is not None:
            self.actions.registry.resume_binding(binding_id)

    # -- simple settings mutations ---------------------------------------

    def change_ptt_setting(self, enabled: bool) -> None:
        self._update(push_to_talk=enabled)

    def change_audio_feedback_setting(self, enabled: bool) -> None:
        self._update(audio_feedback=enabled)

    def change_audio_feedback_volume_setting(self, volume: float) -> None:
        self._update(audio_feedback_volume=volume)

    def change_sound_theme_setting(self, theme) -> None:
        self._update(sound_theme=theme)

    def change_start_hidden_setting(self, enabled: bool) -> None:
        self._update(start_hidden=enabled)

    def change_autostart_setting(self, enabled: bool) -> None:
        # Store, then apply to the OS launcher immediately
        # (shortcut/mod.rs:598-622: autolaunch enable/disable in the
        # same command).
        self._update(autostart_enabled=enabled)
        mgr = getattr(self.services, "autostart", None)
        if mgr is not None:
            if enabled:
                mgr.enable()
            else:
                mgr.disable()

    def change_update_checks_setting(self, enabled: bool) -> None:
        self._update(update_checks_enabled=enabled)

    def change_translate_to_english_setting(self, enabled: bool) -> None:
        self._update(translate_to_english=enabled)

    def change_selected_language_setting(self, language: str) -> None:
        self._update(selected_language=language)

    def change_overlay_position_setting(self, position) -> None:
        self._update(overlay_position=position)

    def change_debug_mode_setting(self, enabled: bool) -> None:
        self._update(debug_mode=enabled)

    def change_word_correction_threshold_setting(self, threshold: float) -> None:
        self._update(word_correction_threshold=threshold)

    def change_paste_method_setting(self, method) -> None:
        self._update(paste_method=method)

    def change_typing_tool_setting(self, tool) -> None:
        self._update(typing_tool=tool)

    def change_clipboard_handling_setting(self, handling) -> None:
        self._update(clipboard_handling=handling)

    def change_auto_submit_setting(self, enabled: bool) -> None:
        self._update(auto_submit=enabled)

    def change_auto_submit_key_setting(self, key) -> None:
        self._update(auto_submit_key=key)

    def change_mute_while_recording_setting(self, enabled: bool) -> None:
        self._update(mute_while_recording=enabled)

    def change_audio_segment_size_seconds_setting(self, seconds: float) -> None:
        self._update(audio_segment_size_seconds=seconds)

    def change_append_trailing_space_setting(self, enabled: bool) -> None:
        self._update(append_trailing_space=enabled)

    def change_at_file_expansion_setting(self, enabled: bool) -> None:
        self._update(at_file_expansion_enabled=enabled)

    def change_app_language_setting(self, language: str) -> None:
        self._update(app_language=language)

    def change_experimental_enabled_setting(self, enabled: bool) -> None:
        self._update(experimental_enabled=enabled)

    def change_keyboard_implementation_setting(self, impl) -> Dict:
        """Runtime keyboard-implementation switch (shortcut/mod.rs:255-314):
        moves registered hotkeys to the new backend, resetting any the
        backend rejects to their defaults. Returns the reference's
        ImplementationChangeResult {success, reset_bindings}; invalid or
        unavailable implementations fail structurally BEFORE any hotkey is
        unregistered so a bad value can never strand the app shortcut-less."""
        try:
            new_impl = (
                impl
                if isinstance(impl, KeyboardImplementation)
                else KeyboardImplementation(impl)
            )
        except ValueError:
            return {"success": False, "reset_bindings": []}
        s = self.services.get_settings()
        if s.keyboard_implementation == new_impl:
            return {"success": True, "reset_bindings": []}
        reset: List[str] = []
        dropped: List[str] = []
        if self.actions.registry is not None:
            if new_impl not in self.actions.registry.backends:
                # Validate availability up front: switch_implementation would
                # raise KeyError only after the old backend was torn down.
                return {"success": False, "reset_bindings": []}
            defaults = {bid: b.default_binding for bid, b in s.bindings.items()}
            result = self.actions.registry.switch_implementation(new_impl, defaults)
            reset, dropped = result.reset, result.dropped
        self.services.update_settings(keyboard_implementation=new_impl)
        if reset:
            # Persist new current_binding only for bindings that actually
            # ended up registered on their default; dropped ids keep their
            # stored hotkey (no OS registration — surfaced below).
            s2 = self.services.get_settings()
            for bid in reset:
                if bid in s2.bindings:
                    s2.bindings[bid].current_binding = s2.bindings[bid].default_binding
            self.services.write_settings(s2)
        self.services.events.emit(
            SETTINGS_CHANGED,
            {
                "setting": "keyboard_implementation",
                "value": new_impl.value,
                "reset_bindings": reset,
                "dropped_bindings": dropped,
            },
        )
        return {"success": True, "reset_bindings": reset, "dropped_bindings": dropped}

    def get_keyboard_implementation(self):
        return self.services.get_settings().keyboard_implementation

    def change_show_tray_icon_setting(self, enabled: bool) -> None:
        self._update(show_tray_icon=enabled)

    def update_custom_words(self, words: List[str]) -> None:
        self._update(custom_words=list(words))

    def set_model_unload_timeout(self, timeout) -> None:
        self._update(model_unload_timeout=timeout)

    def update_history_limit(self, limit: int) -> None:
        self._update(history_limit=limit)
        self.services.history.apply_retention()

    def update_recording_retention_period(self, period) -> None:
        self._update(recording_retention_period=period)
        self.services.history.apply_retention()

    # -- post-processing --------------------------------------------------

    def change_post_process_enabled_setting(self, enabled: bool) -> None:
        self._update(post_process_enabled=enabled)

    def change_post_process_auto_prompt_selection_setting(self, enabled: bool) -> None:
        self._update(post_process_auto_prompt_selection=enabled)

    def set_post_process_provider(self, provider_id: str) -> None:
        self._update(post_process_provider_id=provider_id)

    def change_post_process_base_url_setting(self, provider_id: str, base_url: str) -> None:
        s = self.services.get_settings()
        for p in s.post_process_providers:
            if p.id == provider_id:
                if not p.allow_base_url_edit:
                    raise PermissionError(provider_id)
                p.base_url = base_url
        self.services.write_settings(s)

    def change_post_process_api_key_setting(self, provider_id: str, api_key: str) -> None:
        s = self.services.get_settings()
        s.post_process_api_keys[provider_id] = api_key
        self.services.write_settings(s)

    def change_post_process_model_setting(self, provider_id: str, model: str) -> None:
        s = self.services.get_settings()
        s.post_process_models[provider_id] = model
        self.services.write_settings(s)

    def fetch_post_process_models(self, provider_id: str) -> List[str]:
        s = self.services.get_settings()
        provider = next(
            (p for p in s.post_process_providers if p.id == provider_id), None
        )
        if provider is None:
            raise KeyError(provider_id)
        return llm_client.fetch_models(
            provider, s.post_process_api_keys.get(provider_id, "")
        )

    def add_post_process_prompt(self, id: str, name: str, prompt: str) -> None:
        s = self.services.get_settings()
        s.post_process_prompts.append(LLMPrompt(id, name, prompt))
        self.services.write_settings(s)

    def update_post_process_prompt(self, id: str, name: str, prompt: str) -> None:
        s = self.services.get_settings()
        for p in s.post_process_prompts:
            if p.id == id:
                p.name, p.prompt = name, prompt
        self.services.write_settings(s)

    def delete_post_process_prompt(self, id: str) -> None:
        s = self.services.get_settings()
        s.post_process_prompts = [p for p in s.post_process_prompts if p.id != id]
        if s.post_process_selected_prompt_id == id:
            s.post_process_selected_prompt_id = None
        self.services.write_settings(s)

    def set_post_process_selected_prompt(self, id: Optional[str]) -> None:
        self._update(post_process_selected_prompt_id=id)

    # -- jargon / domain selector ----------------------------------------

    def update_jargon_profiles(self, profile_ids: List[str]) -> None:
        self._update(jargon_enabled_profiles=list(profile_ids))

    def update_jargon_custom_terms(self, terms: List[str]) -> None:
        self._update(jargon_custom_terms=list(terms))

    def update_jargon_custom_corrections(self, corrections: List[Dict]) -> None:
        self._update(
            jargon_custom_corrections=[
                JargonCorrection(from_=c.get("from", c.get("from_")), to=c["to"])
                for c in corrections
            ]
        )

    def get_jargon_builtin_profiles(self) -> Dict[str, Dict]:
        return {
            pid: {
                "label": p.label,
                "terms": list(p.terms),
                "corrections": [{"from": c.from_, "to": c.to} for c in p.corrections],
            }
            for pid, p in builtin_profiles().items()
        }

    def get_jargon_packs(self) -> List[Dict]:
        return [
            {
                "id": p.id, "label": p.label, "terms": list(p.terms),
                "corrections": [{"from": c.from_, "to": c.to} for c in p.corrections],
            }
            for p in self.services.get_settings().jargon_packs
        ]

    def update_jargon_packs(self, packs: List[Dict]) -> None:
        self._update(
            jargon_packs=[
                JargonPack(
                    id=p["id"], label=p["label"], terms=p.get("terms", []),
                    corrections=[
                        JargonCorrection(
                            from_=c.get("from", c.get("from_")), to=c["to"]
                        )
                        for c in p.get("corrections", [])
                    ],
                )
                for p in packs
            ]
        )

    def import_jargon_packs_json(self, payload: str) -> int:
        packs = json.loads(payload)
        existing = self.get_jargon_packs()
        have = {p["id"] for p in existing}
        added = 0
        for p in packs if isinstance(packs, list) else [packs]:
            if p["id"] not in have:
                existing.append(p)
                added += 1
        self.update_jargon_packs(existing)
        return added

    def export_jargon_packs_json(self) -> str:
        return json.dumps(self.get_jargon_packs(), indent=2, ensure_ascii=False)

    def update_domain_selector_enabled_setting(self, enabled: bool) -> None:
        self._update(domain_selector_enabled=enabled)

    def update_domain_selector_timeout_ms_setting(self, timeout_ms: int) -> None:
        self._update(domain_selector_timeout_ms=timeout_ms)

    def update_domain_selector_top_k_setting(self, top_k: int) -> None:
        self._update(domain_selector_top_k=top_k)

    def update_domain_selector_min_score_setting(self, min_score: float) -> None:
        self._update(domain_selector_min_score=min_score)

    def update_domain_selector_hysteresis_setting(self, hysteresis: float) -> None:
        self._update(domain_selector_hysteresis=hysteresis)

    def update_domain_selector_blend_manual_profiles_setting(self, blend: bool) -> None:
        self._update(domain_selector_blend_manual_profiles=blend)

    # -- app/meta ---------------------------------------------------------

    def get_app_settings(self) -> AppSettings:
        return self.services.get_settings()

    def get_default_settings(self) -> AppSettings:
        return get_default_settings()

    def get_app_dir_path(self) -> str:
        return self.services.data_dir

    def get_log_dir_path(self) -> str:
        return os.path.join(self.services.data_dir, "logs")

    def set_log_level(self, level) -> None:
        self._update(log_level=level)

    def trigger_update_check(self) -> None:
        self.services.events.emit(CHECK_FOR_UPDATES, None)

    def cancel_operation(self) -> None:
        self.actions.cancel_current_operation()

    def is_recording(self) -> bool:
        return self.services.audio.is_recording()

    # OS-integration commands: surface kept, behavior delegated to the shell.
    def open_recordings_folder(self) -> str:
        return self.services.history.recordings_dir

    def open_log_dir(self) -> str:
        return self.get_log_dir_path()

    def open_app_data_dir(self) -> str:
        return self.services.data_dir

    def show_main_window(self) -> str:
        """Surface the main UI (lib.rs:96 show_main_window — the
        single-instance plugin's callback and the tray's settings item
        both route here). Our main window is the operator console:
        best-effort open it with the system opener and return its URL."""
        url = self.console_url
        if url:
            import shutil
            import subprocess

            opener = shutil.which("xdg-open") or shutil.which("open")
            if opener:
                try:
                    subprocess.Popen(
                        [opener, url],
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL,
                    )
                except OSError:
                    pass
        return url

    def check_apple_intelligence_available(self) -> bool:
        # Real FFI probe where the shim dylib exists (macOS arm64 or a
        # test fake); False elsewhere (commands/mod.rs counterpart).
        return ui_state.check_apple_intelligence_availability()

    def initialize_enigo(self) -> None:
        pass  # keyboard runtime is owned by the desktop shell

    def initialize_shortcuts(self) -> None:
        pass  # hotkey registration is owned by the desktop shell

    def start_handy_keys_recording(self, binding_id: str = "") -> None:
        """Enter key-capture mode: raw key events stream to the UI as
        handy-keys-event while the user records a new hotkey for
        binding_id (spittle-keys.rs:524-534 — errors unless handy-keys
        is the active implementation)."""
        settings = self.services.get_settings()
        if settings.keyboard_implementation != KeyboardImplementation.HANDY_KEYS:
            raise ValueError(
                "handy-keys is not the active keyboard implementation")
        if self.actions.registry is None:
            raise ValueError("shortcut registry not initialized")
        self.actions.registry.start_key_capture()

    def stop_handy_keys_recording(self) -> None:
        """Leave key-capture mode (spittle-keys.rs:539-549)."""
        settings = self.services.get_settings()
        if settings.keyboard_implementation != KeyboardImplementation.HANDY_KEYS:
            raise ValueError(
                "handy-keys is not the active keyboard implementation")
        if self.actions.registry is None:
            raise ValueError("shortcut registry not initialized")
        self.actions.registry.stop_key_capture()

    def get_available_typing_tools(self) -> List[str]:
        import shutil

        return [t for t in ("wtype", "kwtype", "dotool", "ydotool", "xdotool")
                if shutil.which(t)]

    def is_laptop(self) -> bool:
        return os.path.exists("/sys/class/power_supply/BAT0")

    # -- models -----------------------------------------------------------

    def get_available_models(self):
        return self.services.models.get_available_models()

    def get_model_info(self, model_id: str):
        for m in self.services.models.get_available_models():
            if m.id == model_id:
                return m
        return None

    def download_model(self, model_id: str) -> str:
        return self.services.models.download_model(model_id)

    def delete_model(self, model_id: str) -> None:
        if self.services.transcription.get_current_model() == model_id:
            self.services.transcription.unload_model()
        self.services.models.delete_model(model_id)

    def cancel_download(self, model_id: str) -> None:
        self.services.models.cancel_download(model_id)

    def set_active_model(self, model_id: str) -> None:
        self.services.set_active_model(model_id)

    def get_current_model(self) -> str:
        return self.services.get_settings().selected_model

    def get_transcription_model_status(self) -> Dict[str, Any]:
        return {
            "loaded": self.services.transcription.is_model_loaded,
            "model_id": self.services.transcription.get_current_model(),
        }

    def is_model_loading(self) -> bool:
        return self.services.transcription._loading.is_set()

    def get_model_load_status(self) -> bool:
        return self.services.transcription.is_model_loaded

    def unload_model_manually(self) -> None:
        self.services.transcription.unload_model()

    def has_any_models_available(self) -> bool:
        return any(m.is_downloaded for m in self.services.models.get_available_models())

    def has_any_models_or_downloads(self) -> bool:
        return self.has_any_models_available()

    # -- audio devices ----------------------------------------------------

    def update_microphone_mode(self, always_on: bool) -> None:
        self._update(always_on_microphone=always_on)
        self.services.audio.update_mode(always_on)

    def get_microphone_mode(self) -> bool:
        return self.services.get_settings().always_on_microphone

    def get_available_microphones(self) -> List[str]:
        from spittle_tpu_torch.shell.audio_devices import list_input_devices

        return [d.name for d in list_input_devices()]

    def set_selected_microphone(self, name: Optional[str]) -> None:
        self._update(selected_microphone=name)

    def get_selected_microphone(self) -> Optional[str]:
        return self.services.get_settings().selected_microphone

    def get_available_output_devices(self) -> List[str]:
        from spittle_tpu_torch.shell.audio_devices import list_output_devices

        return [d.name for d in list_output_devices()]

    def set_selected_output_device(self, name: Optional[str]) -> None:
        self._update(selected_output_device=name)

    def get_selected_output_device(self) -> Optional[str]:
        return self.services.get_settings().selected_output_device

    def set_clamshell_microphone(self, name: Optional[str]) -> None:
        self._update(clamshell_microphone=name)

    def get_clamshell_microphone(self) -> Optional[str]:
        return self.services.get_settings().clamshell_microphone

    def play_test_sound(self) -> None:
        pass  # audio feedback playback is owned by the desktop shell

    def check_custom_sounds(self) -> bool:
        theme_dir = os.path.join(self.services.data_dir, "custom_sounds")
        return (
            os.path.exists(os.path.join(theme_dir, "custom_start.wav"))
            and os.path.exists(os.path.join(theme_dir, "custom_stop.wav"))
        )

    # -- history ----------------------------------------------------------

    def get_history_entries(self, limit: Optional[int] = None):
        return self.services.history.get_history_entries(limit)

    def toggle_history_entry_saved(self, entry_id: int) -> bool:
        return self.services.history.toggle_saved_status(entry_id)

    def get_audio_file_path(self, entry_id: int) -> Optional[str]:
        for e in self.services.history.get_history_entries():
            if e.id == entry_id:
                return self.services.history.recording_path(e)
        return None

    def delete_history_entry(self, entry_id: int) -> None:
        self.services.history.delete_entry(entry_id)
