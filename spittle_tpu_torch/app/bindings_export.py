"""Typed command-surface export (tauri-specta analog).

Port of spittle_tpu/app/bindings_export.py.

The reference generates `src/bindings.ts` from its command registry at
build time (lib.rs:254-369). This module introspects the Commands class
and emits the same kind of typed surface for shell implementers: a JSON
description (name, parameters, annotations, doc) and a TypeScript
declaration rendering. The export is deterministic, so shells can diff it
across versions.
"""

from __future__ import annotations

import inspect
import json
import re
from typing import Any, Dict, List

from .commands import Commands

_TS_TYPES = {
    "bool": "boolean",
    "int": "number",
    "float": "number",
    "str": "string",
    "None": "void",
    "NoneType": "void",
}


def _annotation_to_ts(ann: Any) -> str:
    if ann is inspect.Parameter.empty:
        return "unknown"
    name = getattr(ann, "__name__", None) or str(ann)
    name = str(name)
    # Optional[str] / List[str] / Dict[...] best-effort rendering
    m = re.match(r"typing\.Optional\[(.+)\]", name)
    if m:
        return f"{_TS_TYPES.get(m.group(1), m.group(1))} | null"
    m = re.match(r"(?:typing\.)?List\[(.+)\]", name)
    if m:
        return f"{_TS_TYPES.get(m.group(1), 'unknown')}[]"
    if name.startswith("Optional["):
        inner = name[9:-1]
        return f"{_TS_TYPES.get(inner, inner)} | null"
    return _TS_TYPES.get(name, name)


def describe_commands() -> List[Dict[str, Any]]:
    out = []
    for name, fn in sorted(vars(Commands).items()):
        if name.startswith("_") or not callable(fn):
            continue
        sig = inspect.signature(fn)
        params = []
        for pname, p in sig.parameters.items():
            if pname == "self":
                continue
            params.append({
                "name": pname,
                "type": _annotation_to_ts(p.annotation),
                "optional": p.default is not inspect.Parameter.empty,
            })
        out.append({
            "name": name,
            "camelName": re.sub(r"_(\w)", lambda m: m.group(1).upper(), name),
            "params": params,
            "returns": _annotation_to_ts(sig.return_annotation),
            "doc": (inspect.getdoc(fn) or "").split("\n")[0],
        })
    return out


def export_json() -> str:
    return json.dumps(describe_commands(), indent=2)


def _py_type_to_ts(tp: Any) -> str:
    import typing

    origin = typing.get_origin(tp)
    if origin in (list, typing.List):
        (inner,) = typing.get_args(tp) or (Any,)
        return f"{_py_type_to_ts(inner)}[]"
    if origin in (dict, typing.Dict):
        args = typing.get_args(tp)
        v = _py_type_to_ts(args[1]) if len(args) == 2 else "unknown"
        return f"Record<string, {v}>"
    if origin is typing.Union:
        parts = [
            _py_type_to_ts(a) for a in typing.get_args(tp)
            if a is not type(None)
        ]
        if len(parts) < len(typing.get_args(tp)):
            parts.append("null")
        return " | ".join(dict.fromkeys(parts))
    name = getattr(tp, "__name__", str(tp))
    import enum as _enum

    if isinstance(tp, type) and issubclass(tp, _enum.Enum):
        return " | ".join(json.dumps(m.value) for m in tp)
    import dataclasses as _dc

    if _dc.is_dataclass(tp):
        return name
    return _TS_TYPES.get(name, _TS_TYPES.get(str(tp), name))


def describe_types() -> List[str]:
    """TS interfaces for the shared types the reference's bindings.ts
    carries (AppSettings, the catalog model entry, HistoryEntry,
    ShortcutBinding)."""
    import dataclasses as _dc
    import typing

    from spittle_tpu_torch.config.catalog import ModelCatalogEntry
    from spittle_tpu_torch.config.settings import AppSettings, ShortcutBinding
    from spittle_tpu_torch.managers.history import HistoryEntry

    out = []
    for cls in (ShortcutBinding, ModelCatalogEntry, HistoryEntry,
                AppSettings):
        hints = typing.get_type_hints(cls)
        lines = [f"export interface {cls.__name__} {{"]
        for f in _dc.fields(cls):
            lines.append(f"  {f.name}: {_py_type_to_ts(hints[f.name])};")
        lines.append("}")
        out.append("\n".join(lines))
    return out


def export_dts() -> str:
    """TypeScript declaration of the command surface."""
    lines = [
        "// Auto-generated from spittle_tpu_torch.app.commands (bindings export).",
        "// Counterpart of the reference's tauri-specta src/bindings.ts.",
    ]
    lines.extend(describe_types())
    lines.append("export interface SpittleCommands {")
    for cmd in describe_commands():
        params = ", ".join(
            f"{p['name']}{'?' if p['optional'] else ''}: {p['type']}"
            for p in cmd["params"]
        )
        ret = cmd["returns"]
        ret = "void" if ret in ("unknown", "None") else ret
        if cmd["doc"]:
            lines.append(f"  /** {cmd['doc']} */")
        lines.append(f"  {cmd['camelName']}({params}): Promise<{ret}>;")
    lines.append("}")
    return "\n".join(lines) + "\n"


# AppSettings fields whose reference UI string lives under a different
# key than camelCase(field) (src/components/settings/ naming drift).
_SETTINGS_I18N_ALIASES: Dict[str, str] = {
    "autostart_enabled": "settings.advanced.autostart",
    "update_checks_enabled": "settings.debug.updateChecks",
    "selected_microphone": "settings.sound.microphone",
    "selected_output_device": "settings.sound.outputDevice",
    "selected_language": "settings.general.language",
    "overlay_position": "settings.advanced.overlay",
    "model_unload_timeout": "settings.advanced.modelUnload",
    "recording_retention_period": "settings.debug.recordingRetention",
    "audio_feedback_volume": "settings.sound.volume",
    "experimental_enabled": "settings.advanced.experimentalToggle",
    "paste_delay_ms": "settings.debug.pasteDelay",
    "at_file_expansion_enabled": "settings.advanced.atFileExpansion",
    "jargon_custom_terms": "settings.jargon.customTerms",
    "jargon_custom_corrections": "settings.jargon.customCorrections",
    "post_process_enabled": "settings.debug.postProcessingToggle",
    "post_process_prompts": "settings.postProcessing.prompts",
    "post_process_selected_prompt_id":
        "settings.postProcessing.prompts.selectedPrompt",
    "post_process_api_keys": "settings.postProcessing.api.apiKey",
    "post_process_models": "settings.postProcessing.api.model",
    "post_process_provider_id": "settings.postProcessing.api.provider",
    "audio_segment_size_seconds": "settings.general.segmentOnSilence",
    "auto_submit_key": "settings.advanced.autoSubmit",
    "app_language": "appLanguage",
    "debug_mode": "settings.debug",
}


def _settings_i18n_keys() -> Dict[str, str]:
    """field name -> dot-path into the app i18n table whose node carries
    the reference's label/title (+ description) for that setting. Exact
    camelCase matches resolve automatically; naming drift goes through
    _SETTINGS_I18N_ALIASES; unmatched fields get no key (the console
    shows the raw field name, same as a reference-less setting)."""
    from spittle_tpu_torch.config.i18n import load_app_i18n

    en = load_app_i18n()["en"]
    index: Dict[str, str] = {}

    def walk(tree: Dict[str, Any], path: str) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                if "label" in v or "title" in v:
                    index.setdefault(k, path + k)
                walk(v, path + k + ".")

    walk(en["settings"], "settings.")

    import dataclasses as _dc

    from spittle_tpu_torch.config.settings import AppSettings

    out: Dict[str, str] = {}
    for f in _dc.fields(AppSettings):
        if f.name in _SETTINGS_I18N_ALIASES:
            out[f.name] = _SETTINGS_I18N_ALIASES[f.name]
            continue
        parts = f.name.split("_")
        camel = parts[0] + "".join(p.title() for p in parts[1:])
        if camel in index:
            out[f.name] = index[camel]
    return out


def describe_settings() -> List[Dict[str, Any]]:
    """Settings-field schema for UI generation: every AppSettings field
    with its kind (bool/int/float/str/enum/json), enum choices, default
    value, and the Commands method that updates it (resolved by scanning
    each command's source for `_update(<field>=`) — the reference's
    per-setting React components (src/components/settings/, 60+ files)
    reduced to data the console renders from. Fields with no mapped
    command get kind "json" + command null (display-only)."""
    import dataclasses as _dc
    import enum as _enum
    import typing

    from spittle_tpu_torch.config.settings import AppSettings, get_default_settings

    # field -> command mapping from the command implementations themselves.
    field_cmd: Dict[str, str] = {}
    for name, fn in sorted(vars(Commands).items()):
        if name.startswith("_") or not callable(fn):
            continue
        try:
            src = inspect.getsource(fn)
        except OSError:
            continue
        for m in re.finditer(r"_update\(\s*(\w+)\s*=", src):
            field_cmd.setdefault(m.group(1), name)
    # Fields updated through richer commands than a plain field setter
    # (dedicated editors in the console, like the reference's dedicated
    # components for bindings/prompts/providers).
    field_cmd.update({
        # Runtime switch with reset-to-defaults semantics, not a plain
        # field setter (shortcut/mod.rs:255-314).
        "keyboard_implementation": "change_keyboard_implementation_setting",
        "bindings": "change_binding",
        "selected_model": "set_active_model",
        "post_process_providers": "set_post_process_provider",
        "post_process_api_keys": "change_post_process_api_key_setting",
        "post_process_models": "change_post_process_model_setting",
        "post_process_prompts": "update_post_process_prompt",
    })

    defaults = get_default_settings()
    hints = typing.get_type_hints(AppSettings)
    i18n_keys = _settings_i18n_keys()

    def _jsonify(v):
        if isinstance(v, _enum.Enum):
            return v.value
        if _dc.is_dataclass(v) and not isinstance(v, type):
            return {f.name: _jsonify(getattr(v, f.name))
                    for f in _dc.fields(v)}
        if isinstance(v, dict):
            return {k: _jsonify(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_jsonify(x) for x in v]
        return v

    out = []
    for f in _dc.fields(AppSettings):
        tp = hints[f.name]
        origin = typing.get_origin(tp)
        if origin is typing.Union:  # Optional[T]
            args = [a for a in typing.get_args(tp) if a is not type(None)]
            tp = args[0] if len(args) == 1 else tp
            origin = typing.get_origin(tp)
        choices = None
        if isinstance(tp, type) and issubclass(tp, _enum.Enum):
            kind = "enum"
            choices = [m.value for m in tp]
        elif tp is bool:
            kind = "bool"
        elif tp is int:
            kind = "int"
        elif tp is float:
            kind = "float"
        elif tp is str:
            kind = "str"
        else:
            kind = "json"
        out.append({
            "name": f.name,
            "kind": kind,
            "choices": choices,
            "default": _jsonify(getattr(defaults, f.name)),
            "command": field_cmd.get(f.name),
            "i18n": i18n_keys.get(f.name),
        })
    return out


def export_settings_schema() -> str:
    return json.dumps(describe_settings(), indent=2)
