"""Shortcut registration: backend abstraction, fallback, key capture.

Port of spittle_tpu/app/shortcuts.py.

Port of the reference's shortcut layer structure (`src-tauri/src/shortcut/
mod.rs`, `tauri_impl.rs`, `spittle-keys.rs`): a registry maps binding ids to
hotkey strings through an injectable backend (the desktop shell provides
the OS hook — tauri-plugin-global-shortcut or the handy-keys thread). The
framework keeps the runtime-switchable implementation with persist-on-
fallback (mod.rs:33-56), dynamic cancel-hotkey register/unregister, hotkey
string validation, and the key-capture recording mode that streams
FrontendKeyEvents to the UI (spittle-keys.rs:263-380).
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol

from spittle_tpu_torch.config.settings import KeyboardImplementation
from spittle_tpu_torch.events import EventBus, HANDY_KEYS_EVENT

MODIFIERS = {"ctrl", "control", "alt", "option", "shift", "cmd", "super", "meta"}
_KEY_RE = re.compile(r"^[a-z0-9]+$|^f[0-9]{1,2}$|^escape$|^space$|^tab$|"
                     r"^enter$|^return$|^backspace$|^delete$|^home$|^end$|"
                     r"^pageup$|^pagedown$|^(up|down|left|right)$")


def validate_hotkey(hotkey: str) -> bool:
    """ctrl+shift+space style strings: 0+ modifiers then one key."""
    if not hotkey:
        return False
    parts = [p.strip().lower() for p in hotkey.split("+")]
    if not parts or not all(parts):
        return False
    *mods, key = parts
    return all(m in MODIFIERS for m in mods) and bool(_KEY_RE.match(key))


class ShortcutBackend(Protocol):
    """OS hook: register/unregister return success (shell implements)."""

    def register(self, hotkey: str, callback: Callable[[str, bool], None]) -> bool: ...

    def unregister(self, hotkey: str) -> bool: ...


class InMemoryBackend:
    """Testing/headless backend; `fire` simulates OS key events."""

    def __init__(self, fail_register: bool = False):
        self.registered: Dict[str, Callable] = {}
        self.fail_register = fail_register

    def register(self, hotkey, callback) -> bool:
        if self.fail_register:
            return False
        self.registered[hotkey] = callback
        return True

    def unregister(self, hotkey) -> bool:
        return self.registered.pop(hotkey, None) is not None

    def fire(self, hotkey: str, is_pressed: bool) -> None:
        cb = self.registered.get(hotkey)
        if cb:
            cb(hotkey, is_pressed)


@dataclass
class ImplementationSwitchResult:
    """Outcome of a runtime backend switch: `reset` ids re-registered on
    their default hotkey; `dropped` ids the new backend rejected entirely
    (no OS registration remains — callers must not persist a binding for
    these)."""

    reset: List[str]
    dropped: List[str]


@dataclass
class FrontendKeyEvent:
    """Key-capture stream payload — the reference's FrontendKeyEvent
    (spittle-keys.rs:77-85): modifiers, the non-modifier key (if any),
    key-down flag, and the assembled hotkey string the UI displays."""

    modifiers: List[str]
    key: Optional[str]
    is_key_down: bool
    hotkey_string: str


class ShortcutRegistry:
    """Binding-id -> hotkey registration with implementation fallback."""

    def __init__(
        self,
        backends: Dict[KeyboardImplementation, ShortcutBackend],
        handler: Callable[[str, str, bool], None],
        events: Optional[EventBus] = None,
        implementation: KeyboardImplementation = KeyboardImplementation.TAURI,
        persist_implementation: Optional[Callable[[KeyboardImplementation], None]] = None,
    ):
        """handler(binding_id, hotkey, is_pressed) — the shared shortcut
        event entry point (app.actions.handle_shortcut_event)."""
        self.backends = backends
        self.handler = handler
        self.events = events or EventBus()
        self.implementation = implementation
        self._persist = persist_implementation or (lambda impl: None)
        self._bindings: Dict[str, str] = {}
        self._suspended: Dict[str, str] = {}  # binding_id -> hotkey to restore
        self._capture_active = False
        self._lock = threading.Lock()

    @property
    def backend(self) -> ShortcutBackend:
        return self.backends[self.implementation]

    def _fallback(self) -> bool:
        """HandyKeys -> Tauri fallback, persisted (shortcut/mod.rs:42-55)."""
        order = [KeyboardImplementation.HANDY_KEYS, KeyboardImplementation.TAURI]
        for impl in order:
            if impl != self.implementation and impl in self.backends:
                self.implementation = impl
                self._persist(impl)
                return True
        return False

    def register_binding(self, binding_id: str, hotkey: str) -> bool:
        if not validate_hotkey(hotkey):
            raise ValueError(f"invalid hotkey: {hotkey!r}")
        with self._lock:
            cb = lambda hk, pressed: self._on_event(binding_id, hk, pressed)  # noqa: E731
            if not self.backend.register(hotkey, cb):
                if not self._fallback() or not self.backend.register(hotkey, cb):
                    return False
            old = self._bindings.get(binding_id)
            if old and old != hotkey:
                self.backend.unregister(old)
            self._bindings[binding_id] = hotkey
            self._suspended.pop(binding_id, None)  # re-register clears suspend
            return True

    def unregister_binding(self, binding_id: str) -> bool:
        with self._lock:
            hotkey = self._bindings.pop(binding_id, None)
            if hotkey is None:
                return False
            return self.backend.unregister(hotkey)

    def switch_implementation(
        self,
        new_impl: KeyboardImplementation,
        defaults: Optional[Dict[str, str]] = None,
    ) -> "ImplementationSwitchResult":
        """Runtime implementation switch (shortcut/mod.rs:255-314):
        unregister everything from the old backend, move to the new one,
        and re-register each binding — any the new backend rejects is
        reset to its default hotkey; if even the default fails the
        binding is dropped from the registry and reported so callers
        don't persist settings for a binding with no OS registration.
        Suspended bindings (UI mid-capture) are left suspended — they
        are re-registered on the new backend by resume_binding."""
        defaults = defaults or {}
        with self._lock:
            if new_impl == self.implementation:
                return ImplementationSwitchResult([], [])
            if new_impl not in self.backends:
                raise KeyError(f"no backend for {new_impl}")
            old_backend = self.backend
            for bid, hotkey in self._bindings.items():
                if bid in self._suspended:
                    continue  # already unregistered while suspended
                old_backend.unregister(hotkey)
            self.implementation = new_impl
            self._persist(new_impl)
            reset: List[str] = []
            dropped: List[str] = []
            for bid, hotkey in list(self._bindings.items()):
                if bid in self._suspended:
                    continue  # stays suspended; resume_binding targets the new backend
                cb = lambda hk, pressed, b=bid: self._on_event(b, hk, pressed)  # noqa: E731
                if self.backend.register(hotkey, cb):
                    continue
                # Invalid for the new implementation: reset to default
                # (register_all_shortcuts_for_implementation semantics).
                default = defaults.get(bid)
                if default and default != hotkey and self.backend.register(default, cb):
                    self._bindings[bid] = default
                    reset.append(bid)
                else:
                    del self._bindings[bid]
                    dropped.append(bid)
            return ImplementationSwitchResult(reset, dropped)

    def suspend_binding(self, binding_id: str) -> bool:
        """Temporarily unregister the OS hotkey but remember it
        (shortcut/mod.rs:214-238 — used while the UI records a new
        hotkey so the old one doesn't fire)."""
        with self._lock:
            hotkey = self._bindings.get(binding_id)
            if hotkey is None or binding_id in self._suspended:
                return False
            self._suspended[binding_id] = hotkey
            self.backend.unregister(hotkey)
            return True

    def resume_binding(self, binding_id: str) -> bool:
        with self._lock:
            hotkey = self._suspended.pop(binding_id, None)
        if hotkey is None:
            return False
        return self.register_binding(binding_id, hotkey)

    def is_suspended(self, binding_id: str) -> bool:
        with self._lock:
            return binding_id in self._suspended

    def register_cancel(self, hotkey: str = "escape") -> bool:
        """Dynamic cancel hotkey while recording (tauri_impl.rs)."""
        return self.register_binding("cancel", hotkey)

    def unregister_cancel(self) -> bool:
        return self.unregister_binding("cancel")

    def _on_event(self, binding_id: str, hotkey: str, is_pressed: bool) -> None:
        if self._capture_active:
            return  # capture mode swallows action routing
        self.handler(binding_id, hotkey, is_pressed)

    # -- key-capture recording mode (spittle-keys.rs:263-380) -------------

    def start_key_capture(self) -> None:
        self._capture_active = True

    def stop_key_capture(self) -> None:
        self._capture_active = False

    def feed_captured_key(self, key: str, is_pressed: bool,
                          modifiers: Optional[List[str]] = None) -> None:
        """Raw key events stream to the UI while capture is active."""
        if not self._capture_active:
            return
        mods = list(modifiers or [])
        hotkey_string = "+".join(mods + ([key] if key else []))
        self.events.emit(
            HANDY_KEYS_EVENT,
            FrontendKeyEvent(modifiers=mods, key=key or None,
                             is_key_down=is_pressed,
                             hotkey_string=hotkey_string),
        )
