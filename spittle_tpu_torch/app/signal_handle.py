"""SIGUSR2 headless trigger.

Port of spittle_tpu/app/signal_handle.py.

Port of `src-tauri/src/signal_handle.rs`: receiving SIGUSR2
toggles the `transcribe` action, so scripts can drive dictation without the
UI. The toggle-lock discipline matches the shortcut handler: state is
updated under the lock, the action is invoked after releasing it
(signal_handle.rs:29-53).
"""

from __future__ import annotations

import signal
import threading

from spittle_tpu_torch.utils import threads

from .actions import ActionContext


class SignalHandler:
    def __init__(self, actions: ActionContext, binding_id: str = "transcribe"):
        self.actions = actions
        self.binding_id = binding_id
        self._installed = False

    def install(self) -> None:
        if not hasattr(signal, "SIGUSR2"):
            return  # platform without SIGUSR2
        signal.signal(signal.SIGUSR2, self._on_signal)
        self._installed = True

    def _on_signal(self, signum, frame) -> None:
        # Do the real work off the signal frame.
        threads.spawn(self.trigger, name="sigusr2-trigger")

    def trigger(self) -> None:
        """Toggle the transcribe action exactly like a toggle-mode press."""
        services = self.actions.services
        with services.toggle_lock:
            active = services.toggle_state.get(self.binding_id, False)
            should_start = not active
            services.toggle_state[self.binding_id] = should_start
        action = self.actions.action_map[self.binding_id]
        if should_start:
            action.start(self.actions, self.binding_id)
        else:
            action.stop(self.actions, self.binding_id)
