"""The engine factory (port of spittle_tpu/app/services.py:
default_engine_factory): a catalog engine_type -> one of the port's engines.

The app layer takes it unchanged, `AppServices(engine_factory=...)`; this
module imports nothing of the app.
"""

from __future__ import annotations

import os


def default_engine_factory(engine_type: str, device="cuda"):
    """whisper / parakeet / moonshine / sense_voice -> the port's engine on
    `device` (the card by default; it raises without one).

    Whisper takes its serving options from the environment
    (WhisperEngine.from_env: SPITTLE_QUANTIZE_DECODER,
    SPITTLE_QUANTIZE_ENCODER, SPITTLE_QUANTIZE_CACHE, SPITTLE_WIRE), and
    SPITTLE_DRAFT_MODEL=<path> loads a speculative draft after the main
    model. Any other engine_type raises ValueError (the JAX factory hands
    back its canned-text MockEngine, which the port does not carry)."""
    if engine_type == "whisper":
        from .whisper_engine import WhisperEngine

        engine = WhisperEngine.from_env(device=device)
        draft = os.environ.get("SPITTLE_DRAFT_MODEL")
        if draft:
            _load = engine.load_model

            def load_with_draft(path, _load=_load, _draft=draft):
                _load(path)
                engine.load_draft_model(_draft)

            engine.load_model = load_with_draft  # type: ignore[method-assign]
        return engine
    if engine_type == "parakeet":
        from .parakeet_engine import ParakeetEngine

        return ParakeetEngine(device=device)
    if engine_type == "moonshine":
        from .moonshine_engine import MoonshineEngine

        return MoonshineEngine(device=device)
    if engine_type == "sense_voice":
        from .sensevoice_engine import SenseVoiceEngine

        return SenseVoiceEngine(device=device)
    raise ValueError(
        f"unknown engine_type {engine_type!r}: expected whisper, parakeet, "
        "moonshine or sense_voice")
