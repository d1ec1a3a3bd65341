"""Application service container (port of spittle_tpu/app/services.py).

Analog of the reference's AppServices wiring
(`src-tauri/src/application/services.rs:22-52`): constructs
and connects the managers (audio, model, transcription, history, domain
selector) around a shared settings store and event bus. The desktop shell
owns one AppServices; tests build them with injected fakes.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Dict, Optional

from spittle_tpu_torch.audio.recorder import AudioSource, QueueSource
from spittle_tpu_torch.audio.vad.silero import SileroVad
from spittle_tpu_torch.audio.vad.smoothed import SmoothedVad
from spittle_tpu_torch.config.catalog import load_model_catalog
from spittle_tpu_torch.config.settings import AppSettings, SettingsStore
from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.engine.factory import default_engine_factory
from spittle_tpu_torch.engine.mock import MockEngine
from spittle_tpu_torch.events import EventBus
from spittle_tpu_torch.managers.audio import AudioRecordingManager
from spittle_tpu_torch.managers.domain_selector import DomainSelectorManager
from spittle_tpu_torch.managers.history import HistoryManager
from spittle_tpu_torch.managers.model import ModelManager
from spittle_tpu_torch.managers.transcription import TranscriptionManager


def default_vad_factory(threshold: float = 0.3, device="cuda"):
    """Production VAD chain: Silero(0.3) in Smoothed(15,15,2)
    (managers/audio.rs:127-151), Silero on `device` (the card by default;
    it raises without one). Its frames carry the port's VadFrame, which
    the port's recorder tests."""
    return SmoothedVad(SileroVad(threshold=threshold, device=device))


class AppServices:
    """Builds and owns the manager graph."""

    def __init__(
        self,
        data_dir: str,
        source_factory: Optional[Callable[[], AudioSource]] = None,
        engine_factory: Optional[Callable[[str], object]] = None,
        vad_factory: Optional[Callable[[], object]] = None,
        events: Optional[EventBus] = None,
        use_mock_engine: bool = False,
        catalog=None,
        device="cuda",
    ):
        """device: where the default engine factory puts its engines (the
        card unless the caller passes "cpu"; "cuda" raises here without
        one). vad_factory None records without a VAD gate, as the
        reference's does; default_vad_factory is the production chain."""
        device = resolve_device(device)
        os.makedirs(data_dir, exist_ok=True)
        self.data_dir = data_dir
        self.events = events or EventBus()
        self.settings_store = SettingsStore(
            os.path.join(data_dir, "settings_store.json")
        )
        self._settings_lock = threading.Lock()
        self._settings = self.settings_store.load()

        self.domain_selector = DomainSelectorManager()
        if use_mock_engine:
            engine_factory = lambda et: MockEngine()  # noqa: E731
        self.transcription = TranscriptionManager(
            engine_factory=engine_factory or functools.partial(
                default_engine_factory, device=device),
            settings_provider=self.get_settings,
            events=self.events,
            domain_selector=self.domain_selector,
        )
        self.models = ModelManager(
            models_dir=os.path.join(data_dir, "models"),
            catalog=catalog or load_model_catalog(),
            events=self.events,
            selected_model_getter=lambda: self.get_settings().selected_model,
            selected_model_setter=self._set_selected_model,
        )
        # ModelStateEvent payloads carry the catalog display name
        # (transcription.rs:250 passes model_info.name).
        self.transcription.model_name_lookup = self._model_display_name
        self.history = HistoryManager(
            data_dir,
            events=self.events,
            retention_getter=lambda: self.get_settings().recording_retention_period,
            history_limit_getter=lambda: self.get_settings().history_limit,
        )
        self.audio = AudioRecordingManager(
            source_factory=source_factory or self._default_source_factory(),
            vad_factory=vad_factory,
            events=self.events,
            always_on=self._settings.always_on_microphone,
            mute_while_recording=self._settings.mute_while_recording,
        )
        # Toggle-mode state shared by shortcut handling (lib.rs ManagedToggleState)
        self.toggle_state: Dict[str, bool] = {}
        self.toggle_lock = threading.Lock()

    def _default_source_factory(self):
        """A QueueSource: the microphone (spittle_tpu/shell/mic.py, chosen
        there by the selected-microphone setting) comes with the port's
        shell slice. Headless and test runs push their audio into it."""
        return lambda: QueueSource()

    # -- settings --------------------------------------------------------

    def get_settings(self) -> AppSettings:
        with self._settings_lock:
            return self._settings

    def write_settings(self, settings: AppSettings) -> None:
        with self._settings_lock:
            self._settings = settings
        self.settings_store.save(settings)

    def update_settings(self, **changes) -> AppSettings:
        from spittle_tpu_torch.config.settings import coerce_setting

        with self._settings_lock:
            for k, v in changes.items():
                if not hasattr(self._settings, k):
                    raise KeyError(k)
                setattr(self._settings, k, coerce_setting(k, v))
            settings = self._settings
        self.settings_store.save(settings)
        return settings

    def _set_selected_model(self, model_id: str) -> None:
        self.update_settings(selected_model=model_id)

    def _model_display_name(self, model_id: str) -> Optional[str]:
        entry = self.models.catalog.by_id(model_id)
        if entry is not None:
            return entry.name
        info = next(
            (m for m in self.models.get_available_models() if m.id == model_id),
            None,
        )
        return info.name if info is not None else None

    # -- model use-case glue (application/model_service.rs) --------------

    def set_active_model(self, model_id: str) -> None:
        entry = self.models.catalog.by_id(model_id)
        path = self.models.get_model_path(model_id)
        if path is None:
            raise FileNotFoundError(f"model {model_id} not downloaded")
        engine_type = entry.engine_type if entry else "whisper"
        self.update_settings(selected_model=model_id)
        self.transcription.initiate_model_load(model_id, path, engine_type)

    def shutdown(self) -> None:
        self.audio.shutdown()
        self.transcription.shutdown()
