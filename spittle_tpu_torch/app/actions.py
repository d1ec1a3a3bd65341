"""Shortcut actions + shared event handler.

Port of spittle_tpu/app/actions.py.

Behavior-parity rebuild of `src-tauri/src/actions.rs`
(ShortcutAction trait + ACTION_MAP) and `shortcut/handler.rs`
(handle_shortcut_event): cancel fires only while recording; push-to-talk
starts on press / stops on release; toggle mode flips per-binding state
under a lock that is released before invoking the action (deadlock
discipline, handler.rs:63-90). TranscribeAction kicks a background model
load, starts/stops the recorder, and runs the pipeline.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from spittle_tpu_torch.events import HIDE_OVERLAY, SHOW_OVERLAY
from spittle_tpu_torch.pipeline import PipelineHooks, TranscriptionPipeline, TextOutput
from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger
from .services import AppServices

_log = get_logger("actions")


class StreamingSession:
    """Segment-on-silence session: transcribes emitted segments in order on
    a worker thread and pastes them live (revives the reference's dormant
    streaming mode; recorder.rs:306-313, pipeline.rs pasted_segments)."""

    def __init__(self, services: AppServices, output):
        import queue as _q

        self.services = services
        self.output = output
        self.texts = []  # pasted segments incl. trailing space
        self._q: "_q.Queue" = _q.Queue()
        self._worker = threads.spawn(self._run, name="streaming-session")

    def submit(self, samples) -> None:
        self._q.put(samples)

    def _run(self) -> None:
        while True:
            samples = self._q.get()
            if samples is None:
                return
            try:
                text = self.services.transcription.transcribe(samples)
                if text:
                    self.output.paste(text)
                    self.texts.append(text + " ")
            except Exception:
                # Fail open per segment (pipeline.rs:888-899): log and keep
                # consuming — and task_done below must always run, or
                # finish()'s q.join() would deadlock on a failed segment.
                _log.exception("streaming segment failed")
            finally:
                self._q.task_done()

    def finish(self):
        """Drain pending segments; returns the pasted segment texts."""
        self._q.join()
        self._q.put(None)
        return list(self.texts)


class TranscribeAction:
    def __init__(self, post_process: bool):
        self.post_process = post_process

    def start(self, app: "ActionContext", binding_id: str) -> None:
        services = app.services
        settings = services.get_settings()
        if settings.audio_segment_size_seconds > 0:
            app.streaming_session = StreamingSession(services, app.output)
        else:
            app.streaming_session = None
        # Background model load (actions.rs:33-35)
        model_id = settings.selected_model
        if model_id:
            path = services.models.get_model_path(model_id)
            entry = services.models.catalog.by_id(model_id)
            if path:
                services.transcription.initiate_model_load(
                    model_id, path,
                    entry.engine_type if entry else "whisper",
                )
        # Reference payload is the bare state string (overlay.rs:291-313).
        services.events.emit(SHOW_OVERLAY, "recording")
        ui = app.ui
        if ui is not None:
            from .ui_state import SoundType, TrayIconState

            ui.tray.set_state(TrayIconState.RECORDING)
            # actions.rs:47-77 timing: OnDemand plays the start sound
            # BEFORE the stream opens (so it isn't recorded); AlwaysOn
            # streams already, so play after the start commits.
            if not settings.always_on_microphone:
                ui.feedback.play(SoundType.START)
        started = services.audio.try_start_recording(binding_id)
        if started and ui is not None and settings.always_on_microphone:
            from .ui_state import SoundType

            ui.feedback.play(SoundType.START)
        if not started:
            # Roll stale toggle state back (actions.rs:87-94)
            with services.toggle_lock:
                services.toggle_state[binding_id] = False
            if ui is not None:
                from .ui_state import TrayIconState

                ui.tray.set_state(TrayIconState.IDLE)

    def stop(self, app: "ActionContext", binding_id: str) -> None:
        services = app.services
        ui = app.ui
        if ui is not None:
            # actions.rs:130-137: tray -> Transcribing, stop sound, before
            # the async transcription task.
            from .ui_state import SoundType, TrayIconState

            ui.tray.set_state(TrayIconState.TRANSCRIBING)
            ui.feedback.play(SoundType.STOP)
        # The overlay stays up through transcription in the reference
        # (actions.rs:131 show_transcribing_overlay); it is hidden by the
        # pipeline's terminal states, never here.
        services.events.emit(SHOW_OVERLAY, "transcribing")
        samples = services.audio.stop_recording(binding_id)
        session = getattr(app, "streaming_session", None)
        app.streaming_session = None
        pasted_segments = session.finish() if session is not None else []
        if (samples is None or not len(samples)) and not pasted_segments:
            self._clear_toggle(services, binding_id)
            # No pipeline thread will run, so the overlay/tray reset that
            # usually lives in the pipeline must happen here
            # (actions.rs:179-180 ignored-stop branch).
            services.events.emit(HIDE_OVERLAY, None)
            if ui is not None:
                ui.tray.set_state(TrayIconState.IDLE)
            return

        def run():
            settings = services.get_settings()
            pipeline = TranscriptionPipeline(
                samples=samples if samples is not None else np.zeros(0, np.float32),
                pasted_segments=pasted_segments,
                settings=settings,
                post_process=self.post_process,
                binding_id=binding_id,
                transcribe=services.transcription.transcribe,
                output=app.output,
                hooks=app.pipeline_hooks(samples),
                domain_selector=services.domain_selector,
            )
            try:
                pipeline.run()
            finally:
                self._clear_toggle(services, binding_id)
                ui2 = app.ui
                if ui2 is not None:
                    from .ui_state import TrayIconState

                    ui2.tray.set_state(TrayIconState.IDLE)

        def on_failure(_exc: BaseException) -> None:
            # A dead pipeline must not strand the overlay in processing
            # state (utils.rs:17-46 reset semantics); tray + toggle were
            # already reset in run()'s finally.
            services.events.emit(HIDE_OVERLAY, None)

        threads.spawn(run, name="transcription-pipeline", on_failure=on_failure)

    @staticmethod
    def _clear_toggle(services: AppServices, binding_id: str) -> None:
        with services.toggle_lock:
            services.toggle_state[binding_id] = False


class CancelAction:
    def start(self, app: "ActionContext", binding_id: str) -> None:
        app.cancel_current_operation()

    def stop(self, app: "ActionContext", binding_id: str) -> None:
        pass


class TestAction:
    """Debug binding: records invocations (reference "test" slot)."""

    def __init__(self):
        self.events = []

    def start(self, app, binding_id):
        self.events.append(("start", binding_id))

    def stop(self, app, binding_id):
        self.events.append(("stop", binding_id))


class ActionContext:
    """Everything actions need: services, text output, UI hooks.

    The desktop shell supplies a real TextOutput; tests a buffer.
    """

    def __init__(
        self,
        services: AppServices,
        output: TextOutput,
        hooks_factory: Optional[Callable[[np.ndarray], PipelineHooks]] = None,
        ui=None,  # Optional[ui_state.AppUi]: tray/overlay/feedback bundle
    ):
        self.services = services
        self.output = output
        self._hooks_factory = hooks_factory
        self.ui = ui
        self.streaming_session: Optional[StreamingSession] = None
        # Suspended bindings don't route actions (shortcut/mod.rs:214-238);
        # an attached ShortcutRegistry also unregisters the OS hotkey.
        self.suspended: set = set()
        self.registry = None  # Optional[ShortcutRegistry], shell-attached
        # Route recorder segment emissions into the active session.
        services.audio._on_segment = self._on_segment
        services.audio._segment_size = (
            lambda: services.get_settings().audio_segment_size_seconds
        )
        self.action_map: Dict[str, object] = {
            "transcribe": TranscribeAction(post_process=False),
            "transcribe_with_post_process": TranscribeAction(post_process=True),
            "cancel": CancelAction(),
            "test": TestAction(),
        }

    def _on_segment(self, samples: np.ndarray) -> None:
        session = self.streaming_session
        if session is not None:
            session.submit(samples)

    def pipeline_hooks(self, samples: np.ndarray) -> PipelineHooks:
        if self._hooks_factory is not None:
            return self._hooks_factory(samples)
        services = self.services

        def save_history(samples_, raw, post, prompt):
            title = raw[:64] if raw else "Transcription"
            services.history.save_transcription(samples_, title, raw, post, prompt)

        from spittle_tpu_torch.text.zh_convert import convert_chinese_variant

        def set_tray_idle():
            if self.ui is not None:
                from .ui_state import TrayIconState

                self.ui.tray.set_state(TrayIconState.IDLE)

        return PipelineHooks(
            save_history=save_history,
            # Overlay follows the pipeline's states like the reference:
            # "processing" while post-processing (pipeline.rs:259), hidden
            # at every terminal state (pipeline.rs:281-522).
            show_processing_overlay=lambda: self.services.events.emit(
                SHOW_OVERLAY, "processing"
            ),
            hide_overlay=lambda: self.services.events.emit(HIDE_OVERLAY, None),
            set_tray_idle=set_tray_idle,
            # Real zh-Hans/zh-Hant conversion in the default-assembled app
            # (pipeline.rs:330-332 wires maybe_convert_chinese_variant).
            convert_chinese=convert_chinese_variant,
        )

    def cancel_current_operation(self) -> None:
        """Centralized cancel (utils.rs:17-46): reset toggles, recording,
        overlay; optionally unload the model immediately."""
        with self.services.toggle_lock:
            for k in self.services.toggle_state:
                self.services.toggle_state[k] = False
        self.services.audio.cancel_recording()
        self.services.events.emit(HIDE_OVERLAY, None)
        if self.ui is not None:
            from .ui_state import TrayIconState

            self.ui.tray.set_state(TrayIconState.IDLE)
        self.services.transcription.maybe_unload_immediately()

    # -- the shared shortcut event entry point ---------------------------

    def handle_shortcut_event(
        self, binding_id: str, hotkey: str, is_pressed: bool
    ) -> None:
        settings = self.services.get_settings()
        action = self.action_map.get(binding_id)
        if action is None or binding_id in self.suspended:
            return

        if binding_id == "cancel":
            if self.services.audio.is_recording() and is_pressed:
                action.start(self, binding_id)
            return

        if settings.push_to_talk:
            if is_pressed:
                action.start(self, binding_id)
            else:
                action.stop(self, binding_id)
            return

        if is_pressed:
            with self.services.toggle_lock:
                active = self.services.toggle_state.get(binding_id, False)
                should_start = not active
                self.services.toggle_state[binding_id] = should_start
            # Lock released before invoking the action (handler.rs:63-90).
            if should_start:
                action.start(self, binding_id)
            else:
                action.stop(self, binding_id)
