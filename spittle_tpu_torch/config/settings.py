"""Application settings: schema, defaults, and JSON store.

Port of spittle_tpu/config/settings.py.

Field-for-field port of the reference settings surface
(`src-tauri/src/settings.rs:287-397` and its enums at
:110-285), with the same forward-compatibility semantics: every field has a
default, unknown keys are ignored, and loading merges stored values over
defaults (settings.rs:831-856,993-1016). Builtin post-process prompt
templates live in data/builtin_prompts.json (extracted configuration data).
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import json
import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

APPLE_INTELLIGENCE_PROVIDER_ID = "apple_intelligence"
APPLE_INTELLIGENCE_DEFAULT_MODEL_ID = "Apple Intelligence"


class LogLevel(str, enum.Enum):
    TRACE = "trace"
    DEBUG = "debug"
    INFO = "info"
    WARN = "warn"
    ERROR = "error"

    @classmethod
    def parse(cls, value) -> "LogLevel":
        # Legacy numeric 1-5 format accepted like the reference's custom
        # deserializer (settings.rs:22-66).
        if isinstance(value, int):
            return [cls.TRACE, cls.DEBUG, cls.INFO, cls.WARN, cls.ERROR][value - 1]
        return cls(str(value).lower())


class OverlayPosition(str, enum.Enum):
    NONE = "none"
    TOP = "top"
    BOTTOM = "bottom"


class ModelUnloadTimeout(str, enum.Enum):
    NEVER = "never"
    IMMEDIATELY = "immediately"
    MIN2 = "min2"
    MIN5 = "min5"
    MIN10 = "min10"
    MIN15 = "min15"
    HOUR1 = "hour1"
    SEC5 = "sec5"  # debug mode only

    def to_seconds(self) -> Optional[int]:
        return {
            ModelUnloadTimeout.NEVER: None,
            ModelUnloadTimeout.IMMEDIATELY: 0,
            ModelUnloadTimeout.SEC5: 5,
            ModelUnloadTimeout.MIN2: 120,
            ModelUnloadTimeout.MIN5: 300,
            ModelUnloadTimeout.MIN10: 600,
            ModelUnloadTimeout.MIN15: 900,
            ModelUnloadTimeout.HOUR1: 3600,
        }[self]


class PasteMethod(str, enum.Enum):
    CTRL_V = "ctrl_v"
    DIRECT = "direct"
    NONE = "none"
    SHIFT_INSERT = "shift_insert"
    CTRL_SHIFT_V = "ctrl_shift_v"


class ClipboardHandling(str, enum.Enum):
    DONT_MODIFY = "dont_modify"
    COPY_TO_CLIPBOARD = "copy_to_clipboard"


class AutoSubmitKey(str, enum.Enum):
    ENTER = "enter"
    CTRL_ENTER = "ctrl_enter"
    CMD_ENTER = "cmd_enter"


class RecordingRetentionPeriod(str, enum.Enum):
    NEVER = "never"
    PRESERVE_LIMIT = "preserve_limit"
    DAYS3 = "days3"
    WEEKS2 = "weeks2"
    MONTHS3 = "months3"


class KeyboardImplementation(str, enum.Enum):
    TAURI = "tauri"
    HANDY_KEYS = "handy_keys"


class SoundTheme(str, enum.Enum):
    MARIMBA = "marimba"
    POP = "pop"
    CUSTOM = "custom"

    def start_path(self) -> str:
        return f"resources/{self.value}_start.wav"

    def stop_path(self) -> str:
        return f"resources/{self.value}_stop.wav"


class TypingTool(str, enum.Enum):
    AUTO = "auto"
    WTYPE = "wtype"
    KWTYPE = "kwtype"
    DOTOOL = "dotool"
    YDOTOOL = "ydotool"
    XDOTOOL = "xdotool"


@dataclass
class ShortcutBinding:
    id: str
    name: str
    description: str
    default_binding: str
    current_binding: str


@dataclass
class LLMPrompt:
    id: str
    name: str
    prompt: str


@dataclass
class JargonCorrection:
    from_: str
    to: str


@dataclass
class JargonPack:
    id: str
    label: str
    terms: List[str] = field(default_factory=list)
    corrections: List[JargonCorrection] = field(default_factory=list)


@dataclass
class PostProcessProvider:
    id: str
    label: str
    base_url: str
    allow_base_url_edit: bool = False
    models_endpoint: Optional[str] = None


def default_post_process_providers(
    platform: str = sys.platform, arch: str = os.uname().machine
) -> List[PostProcessProvider]:
    providers = [
        PostProcessProvider("openai", "OpenAI", "https://api.openai.com/v1",
                            False, "/models"),
        PostProcessProvider("openrouter", "OpenRouter",
                            "https://openrouter.ai/api/v1", False, "/models"),
        PostProcessProvider("anthropic", "Anthropic",
                            "https://api.anthropic.com/v1", False, "/models"),
        PostProcessProvider("groq", "Groq", "https://api.groq.com/openai/v1",
                            False, "/models"),
        PostProcessProvider("cerebras", "Cerebras", "https://api.cerebras.ai/v1",
                            False, "/models"),
    ]
    if platform == "darwin" and arch == "arm64":
        providers.append(
            PostProcessProvider(APPLE_INTELLIGENCE_PROVIDER_ID,
                                "Apple Intelligence",
                                "apple-intelligence://local", False, None)
        )
    providers.append(
        PostProcessProvider("custom", "Custom", "http://localhost:11434/v1",
                            True, "/models")
    )
    return providers


def builtin_post_process_prompts() -> List[LLMPrompt]:
    with open(os.path.join(_DATA_DIR, "builtin_prompts.json")) as f:
        return [LLMPrompt(**p) for p in json.load(f)]


def _default_bindings(platform: str) -> Dict[str, ShortcutBinding]:
    primary = {"win32": "ctrl+space", "darwin": "option+space",
               "linux": "ctrl+space"}.get(platform, "alt+space")
    with_pp = {"win32": "ctrl+shift+space", "darwin": "option+shift+space",
               "linux": "ctrl+shift+space"}.get(platform, "alt+shift+space")
    return {
        "transcribe": ShortcutBinding(
            "transcribe", "Transcribe", "Converts your speech into text.",
            primary, primary),
        "transcribe_with_post_process": ShortcutBinding(
            "transcribe_with_post_process", "Transcribe with Post-Processing",
            "Converts your speech into text and applies AI post-processing.",
            with_pp, with_pp),
        "cancel": ShortcutBinding(
            "cancel", "Cancel", "Cancels the current recording.",
            "escape", "escape"),
    }


_FIELD_CONVERTERS = {
    "sound_theme": lambda v: SoundTheme(v),
    "overlay_position": lambda v: OverlayPosition(v),
    "model_unload_timeout": lambda v: ModelUnloadTimeout(v),
    "recording_retention_period": lambda v: RecordingRetentionPeriod(v),
    "paste_method": lambda v: PasteMethod(v),
    "clipboard_handling": lambda v: ClipboardHandling(v),
    "auto_submit_key": lambda v: AutoSubmitKey(v),
    "keyboard_implementation": lambda v: KeyboardImplementation(v),
    "typing_tool": lambda v: TypingTool(v),
    "log_level": lambda v: LogLevel.parse(v),
}


def coerce_setting(key: str, value):
    """Coerce a raw wire value to the field's typed form — the UPDATE
    path analog of from_dict's converters. An RPC setter passing
    "never" must store RecordingRetentionPeriod.NEVER, not a str:
    identity checks like `period is RecordingRetentionPeriod.NEVER`
    (managers/history.apply_retention) silently misbehave on raw
    strings."""
    if value is None or isinstance(value, enum.Enum):
        return value
    conv = _FIELD_CONVERTERS.get(key)
    return conv(value) if conv else value


@dataclass
class AppSettings:
    """~55 fields mirroring settings.rs:287-397; defaults match the
    reference's default_* functions (linux-flavored platform defaults)."""

    bindings: Dict[str, ShortcutBinding] = field(
        default_factory=lambda: _default_bindings(sys.platform))
    push_to_talk: bool = True
    audio_feedback: bool = False
    audio_feedback_volume: float = 1.0
    sound_theme: SoundTheme = SoundTheme.MARIMBA
    start_hidden: bool = False
    autostart_enabled: bool = False
    update_checks_enabled: bool = True
    selected_model: str = ""
    always_on_microphone: bool = False
    selected_microphone: Optional[str] = None
    clamshell_microphone: Optional[str] = None
    selected_output_device: Optional[str] = None
    translate_to_english: bool = False
    selected_language: str = "auto"
    overlay_position: OverlayPosition = (
        OverlayPosition.NONE if sys.platform == "linux" else OverlayPosition.BOTTOM
    )
    debug_mode: bool = False
    log_level: LogLevel = LogLevel.DEBUG
    custom_words: List[str] = field(default_factory=list)
    model_unload_timeout: ModelUnloadTimeout = ModelUnloadTimeout.NEVER
    word_correction_threshold: float = 0.18
    history_limit: int = 5
    recording_retention_period: RecordingRetentionPeriod = (
        RecordingRetentionPeriod.PRESERVE_LIMIT
    )
    paste_method: PasteMethod = (
        PasteMethod.DIRECT if sys.platform == "linux" else PasteMethod.CTRL_V
    )
    clipboard_handling: ClipboardHandling = ClipboardHandling.DONT_MODIFY
    auto_submit: bool = False
    auto_submit_key: AutoSubmitKey = AutoSubmitKey.ENTER
    post_process_enabled: bool = False
    post_process_auto_prompt_selection: bool = False
    post_process_provider_id: str = "openai"
    post_process_providers: List[PostProcessProvider] = field(
        default_factory=default_post_process_providers)
    post_process_api_keys: Dict[str, str] = field(
        default_factory=lambda: {
            p.id: "" for p in default_post_process_providers()})
    post_process_models: Dict[str, str] = field(
        default_factory=lambda: {
            p.id: (APPLE_INTELLIGENCE_DEFAULT_MODEL_ID
                   if p.id == APPLE_INTELLIGENCE_PROVIDER_ID else "")
            for p in default_post_process_providers()})
    post_process_prompts: List[LLMPrompt] = field(
        default_factory=builtin_post_process_prompts)
    post_process_selected_prompt_id: Optional[str] = None
    mute_while_recording: bool = False
    audio_segment_size_seconds: float = 0.0
    append_trailing_space: bool = False
    app_language: str = "en"
    experimental_enabled: bool = False
    keyboard_implementation: KeyboardImplementation = (
        KeyboardImplementation.HANDY_KEYS if sys.platform == "darwin"
        else KeyboardImplementation.TAURI
    )
    show_tray_icon: bool = True
    paste_delay_ms: int = 60
    typing_tool: TypingTool = TypingTool.AUTO
    at_file_expansion_enabled: bool = False
    recent_workspace_roots: List[str] = field(default_factory=list)
    jargon_enabled_profiles: List[str] = field(default_factory=list)
    jargon_custom_terms: List[str] = field(default_factory=list)
    jargon_custom_corrections: List[JargonCorrection] = field(default_factory=list)
    domain_selector_enabled: bool = False
    domain_selector_timeout_ms: int = 120
    domain_selector_top_k: int = 2
    domain_selector_min_score: float = 0.1
    domain_selector_hysteresis: float = 0.08
    domain_selector_blend_manual_profiles: bool = True
    jargon_packs: List[JargonPack] = field(default_factory=list)

    # -- serde-like (de)serialization with default merging ---------------

    def to_dict(self) -> Dict[str, Any]:
        def conv(v):
            if isinstance(v, enum.Enum):
                return v.value
            if dataclasses.is_dataclass(v):
                return {
                    ("from" if f.name == "from_" else f.name):
                        conv(getattr(v, f.name))
                    for f in dataclasses.fields(v)
                }
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return {f.name: conv(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "AppSettings":
        """Merge stored values over defaults; unknown keys ignored."""
        s = cls()
        converters = _FIELD_CONVERTERS
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key, value in data.items():
            if key not in field_names:
                continue  # forward compatibility
            try:
                if key in converters:
                    value = converters[key](value)
                elif key == "bindings":
                    value = {k: ShortcutBinding(**v) for k, v in value.items()}
                elif key == "post_process_providers":
                    value = [PostProcessProvider(**p) for p in value]
                elif key == "post_process_prompts":
                    value = [LLMPrompt(**p) for p in value]
                elif key == "jargon_custom_corrections":
                    value = [JargonCorrection(from_=c.get("from", c.get("from_")),
                                              to=c["to"]) for c in value]
                elif key == "jargon_packs":
                    value = [
                        JargonPack(
                            id=p["id"], label=p["label"],
                            terms=p.get("terms", []),
                            corrections=[
                                JargonCorrection(
                                    from_=c.get("from", c.get("from_")),
                                    to=c["to"])
                                for c in p.get("corrections", [])
                            ],
                        )
                        for p in value
                    ]
                setattr(s, key, value)
            except (ValueError, KeyError, TypeError):
                continue  # bad stored value: keep the default
        s._ensure_post_process_defaults()
        return s

    def _ensure_post_process_defaults(self) -> None:
        """Make sure builtin providers/prompts exist after a load (the
        reference's ensure_post_process_defaults, settings.rs:693-...)."""
        have = {p.id for p in self.post_process_providers}
        for p in default_post_process_providers():
            if p.id not in have:
                self.post_process_providers.append(p)
            self.post_process_api_keys.setdefault(p.id, "")
            self.post_process_models.setdefault(
                p.id,
                APPLE_INTELLIGENCE_DEFAULT_MODEL_ID
                if p.id == APPLE_INTELLIGENCE_PROVIDER_ID else "")
        have_prompts = {p.id for p in self.post_process_prompts}
        for p in builtin_post_process_prompts():
            if p.id not in have_prompts:
                self.post_process_prompts.append(p)


def get_default_settings() -> AppSettings:
    return AppSettings()


class SettingsStore:
    """JSON-file settings store (tauri-plugin-store analog,
    settings.rs:807,1018-1040). Thread-safe; loads merge defaults."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def load(self) -> AppSettings:
        with self._lock:
            if not os.path.exists(self.path):
                return get_default_settings()
            try:
                with open(self.path, encoding="utf-8") as f:
                    data = json.load(f)
            except (json.JSONDecodeError, OSError):
                return get_default_settings()
            return AppSettings.from_dict(data)

    def save(self, settings: AppSettings) -> None:
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(settings.to_dict(), f, indent=2, ensure_ascii=False)
            os.replace(tmp, self.path)

    def update(self, **changes) -> AppSettings:
        s = self.load()
        for k, v in changes.items():
            if not hasattr(s, k):
                raise KeyError(k)
            setattr(s, k, v)
        self.save(s)
        return s
