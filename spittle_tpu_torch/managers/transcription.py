"""Transcription manager: engine lifecycle + the synchronous hot path.

Port of spittle_tpu/managers/transcription.py.

Behavior-parity rebuild of `src-tauri/src/managers/
transcription.rs`: engine dispatch by catalog engine_type (:29-34,262-339),
background model loading with a loading gate the hot path waits on
(:374-391,420-424), the idle-unload watcher polling every 10 s against
model_unload_timeout (:108-165), and the transcribe chain (:398-605):
engine -> apply_custom_words -> filter_transcription_output -> jargon
corrections (with optional domain-selector profile routing), emitting
model-state-changed events throughout.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from spittle_tpu_torch.config.settings import AppSettings, ModelUnloadTimeout
from spittle_tpu_torch.engine.base import TranscribeParams, TranscriptionEngine
from spittle_tpu_torch.events import EventBus, MODEL_STATE_CHANGED
from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger
from spittle_tpu_torch.text.filters import apply_custom_words, filter_transcription_output
from spittle_tpu_torch.text.jargon import (
    JargonCorrection,
    JargonSettings,
    apply_corrections,
    build_initial_prompt,
    compute_active_dictionary,
)
from spittle_tpu_torch.utils.tracing import span
from .domain_selector import DomainContext, DomainSelectorManager, build_profile_map

IDLE_POLL_SECONDS = 10.0

_log = get_logger("transcription")


class TranscriptionManager:
    """Owns the loaded engine; synchronous transcribe under an engine lock."""

    def __init__(
        self,
        engine_factory: Callable[[str], TranscriptionEngine],
        settings_provider: Callable[[], AppSettings],
        events: Optional[EventBus] = None,
        domain_selector: Optional[DomainSelectorManager] = None,
        idle_poll_seconds: float = IDLE_POLL_SECONDS,
    ):
        """engine_factory(engine_type) -> engine for 'whisper'/'parakeet'/
        'moonshine'/'sense_voice' (LoadedEngine dispatch, :29-34)."""
        self._engine_factory = engine_factory
        self._settings = settings_provider
        self.events = events or EventBus()
        self._domain_selector = domain_selector
        # Resolves model_id -> display name for ModelStateEvent payloads
        # (the reference passes model_info.name, transcription.rs:250);
        # wired by AppServices once the ModelManager exists.
        self.model_name_lookup: Optional[Callable[[str], Optional[str]]] = None

        self._engine: Optional[TranscriptionEngine] = None
        self._engine_lock = threading.Lock()
        self._loading = threading.Event()
        self._loaded_cv = threading.Condition()
        self._current_model: Optional[str] = None
        self._last_activity = time.monotonic()
        self._shutdown = threading.Event()
        self._idle_poll = idle_poll_seconds
        self._watcher = threading.Thread(target=self._idle_watch, daemon=True)
        self._watcher.start()

    # -- model lifecycle -------------------------------------------------

    def _emit_state(
        self,
        event_type: str,
        model_id: Optional[str] = None,
        error: Optional[str] = None,
    ) -> None:
        """Emit the reference's ModelStateEvent wire shape
        (domain/events.rs:23-44): event_type in {loading_started,
        loading_failed, loaded, unloaded} plus model_id / model_name /
        error, on "model-state-changed" (transcription.rs:228-236,356)."""
        mid = model_id or self._current_model
        name = None
        if mid is not None and self.model_name_lookup is not None:
            try:
                name = self.model_name_lookup(mid)
            except Exception:
                name = None
        self.events.emit(
            MODEL_STATE_CHANGED,
            {
                "event_type": event_type,
                "model_id": mid,
                "model_name": name,
                "error": error,
            },
        )

    def load_model(self, model_id: str, model_path: str, engine_type: str) -> None:
        """Synchronous load (callers use initiate_model_load for async)."""
        with self._loaded_cv:
            if self._loading.is_set():
                # Another load in flight; wait for it then re-check.
                self._loaded_cv.wait_for(lambda: not self._loading.is_set())
            if self._current_model == model_id and self._engine is not None:
                return
            self._loading.set()
        self._emit_state("loading_started", model_id)
        try:
            engine = self._engine_factory(engine_type)
            with span("model.load", model_id=model_id, engine=engine_type):
                engine.load_model(model_path)
            with self._engine_lock:
                if self._engine is not None:
                    self._engine.unload_model()
                self._engine = engine
                self._current_model = model_id
            self._emit_state("loaded", model_id)
        except Exception as exc:
            self._emit_state("loading_failed", model_id, error=str(exc))
            raise
        finally:
            with self._loaded_cv:
                self._loading.clear()
                self._loaded_cv.notify_all()
            self._last_activity = time.monotonic()

    def initiate_model_load(
        self, model_id: str, model_path: str, engine_type: str
    ) -> threading.Thread:
        """Background load kick (transcription.rs:374-391)."""
        # Barrier: load_model emits the "error" state before re-raising;
        # the thread wrapper logs the traceback instead of letting it
        # escape as an unhandled thread exception.
        return threads.spawn(
            lambda: self.load_model(model_id, model_path, engine_type),
            name=f"model-load:{model_id}",
        )

    def unload_model(self) -> None:
        with self._engine_lock:
            if self._engine is not None:
                self._engine.unload_model()
                self._engine = None
                model = self._current_model
                self._current_model = None
            else:
                return
        self._emit_state("unloaded", model)

    def maybe_unload_immediately(self) -> None:
        timeout = self._settings().model_unload_timeout
        if timeout is ModelUnloadTimeout.IMMEDIATELY:
            self.unload_model()

    @property
    def is_model_loaded(self) -> bool:
        with self._engine_lock:
            return self._engine is not None

    def get_current_model(self) -> Optional[str]:
        return self._current_model

    def shutdown(self) -> None:
        self._shutdown.set()

    def _idle_watch(self) -> None:
        """Unload after model_unload_timeout of inactivity (:108-165)."""
        while not self._shutdown.wait(min(self._idle_poll, 1.0)):
            try:
                seconds = self._settings().model_unload_timeout.to_seconds()
                if seconds is None or seconds == 0:
                    continue
                if not self.is_model_loaded:
                    continue
                if time.monotonic() - self._last_activity > seconds:
                    self.unload_model()
            except Exception:
                # Exception barrier: one bad tick must not kill the
                # idle-unload watcher for the process lifetime.
                _log.exception("idle-unload tick failed")

    # -- the hot path ----------------------------------------------------

    def transcribe(self, samples: np.ndarray) -> str:
        """Synchronous whole-utterance transcription + text post chain."""
        # Wait for any in-flight load (loading condvar, :420-424).
        with self._loaded_cv:
            self._loaded_cv.wait_for(
                lambda: not self._loading.is_set(), timeout=120.0
            )
        settings = self._settings()
        with self._engine_lock:
            if self._engine is None:
                raise RuntimeError("no model loaded")
            params = self._build_params(settings)
            with span("transcribe.engine", samples=len(samples)):
                result = self._engine.transcribe_samples(
                    np.asarray(samples, np.float32), params
                )
        text = result.text
        with span("transcribe.text_chain"):
            text = self._post_process_text(text, settings)
        self._last_activity = time.monotonic()
        self.maybe_unload_immediately()
        return text

    def _build_params(self, settings: AppSettings) -> TranscribeParams:
        language = settings.selected_language
        if language in ("", "auto"):
            language = None
        initial_prompt = None
        jargon = self._jargon_settings(settings)
        if jargon.enabled_profiles or jargon.custom_terms:
            dictionary = compute_active_dictionary(
                jargon, build_profile_map(settings)
            )
            prompt = build_initial_prompt(dictionary)
            initial_prompt = prompt or None
        return TranscribeParams(
            language=language,
            translate=settings.translate_to_english,
            initial_prompt=initial_prompt,
        )

    @staticmethod
    def _jargon_settings(settings: AppSettings) -> JargonSettings:
        return JargonSettings(
            enabled_profiles=list(settings.jargon_enabled_profiles),
            custom_terms=list(settings.jargon_custom_terms),
            custom_corrections=[
                JargonCorrection(from_=c.from_, to=c.to)
                for c in settings.jargon_custom_corrections
            ],
        )

    def _post_process_text(self, text: str, settings: AppSettings) -> str:
        """Custom words -> filler/hallucination filter -> jargon corrections
        (transcription.rs:537-580)."""
        if settings.custom_words:
            text = apply_custom_words(
                text, settings.custom_words, settings.word_correction_threshold
            )
        text = filter_transcription_output(text)
        if not text:
            return text

        jargon = self._jargon_settings(settings)
        enabled = list(jargon.enabled_profiles)
        if self._domain_selector is not None and settings.domain_selector_enabled:
            selected = self._domain_selector.select_profiles_with_timeout(
                settings, DomainContext(text=text)
            )
            if selected:
                if settings.domain_selector_blend_manual_profiles:
                    enabled = list(dict.fromkeys(enabled + selected))
                else:
                    enabled = selected
        jargon.enabled_profiles = enabled
        if jargon.enabled_profiles or jargon.custom_corrections:
            dictionary = compute_active_dictionary(
                jargon, build_profile_map(settings)
            )
            text = apply_corrections(text, dictionary.corrections)
        return text
