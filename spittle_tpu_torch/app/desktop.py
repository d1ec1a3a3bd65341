"""Desktop app assembly: the full hotkey -> record -> transcribe ->
paste loop with zero external shell.

Port of spittle_tpu/app/desktop.py. The engine runs on the card unless
the caller passes device="cpu" (AppServices raises without one). On
macOS and Windows build_app raises NotImplementedError (shell/unported.py):
their key backends and trays come with the macOS/Windows slice.

The lib.rs `run()` analog (reference: src-tauri/src/lib.rs:160-320
builds managers, registers shortcuts, installs the signal handler, and
hands the webview its IPC): builds AppServices + ActionContext + AppUi,
wires a ShortcutRegistry whose HANDY_KEYS backend is the Linux evdev
listener (shell/evdev_keys.py — the framework HEARS global hotkeys
itself), registers the bindings from settings, installs SIGUSR2, and
serves the RPC/web console. `python -m spittle_tpu_torch.cli app` runs
this.
"""

from __future__ import annotations

import dataclasses
import sys

from spittle_tpu_torch.config.settings import KeyboardImplementation
from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.shell.unported import unported

from .actions import ActionContext
from .commands import Commands
from .rpc_server import AppRpcServer
from .services import AppServices
from .shortcuts import InMemoryBackend, ShortcutRegistry
from .signal_handle import SignalHandler
from .ui_state import AppUi


@dataclasses.dataclass
class DesktopApp:
    services: AppServices
    actions: ActionContext
    ui: AppUi
    registry: ShortcutRegistry
    rpc: AppRpcServer
    signals: SignalHandler
    tray: object = None     # SniTray when a session bus exists
    overlay: object = None  # X11Overlay when a display exists

    def shutdown(self) -> None:
        try:
            self.rpc.stop()
        finally:
            for surface in (self.tray, self.overlay):
                if surface is not None:
                    try:
                        surface.close()
                    except Exception:
                        pass
            for be in self.registry.backends.values():
                close = getattr(be, "close", None)
                if close:
                    close()
            self.services.shutdown()


def build_app(
    data_dir: str,
    *,
    port: int = 47890,
    output=None,
    source_factory=None,
    engine_factory=None,
    use_mock_engine: bool = False,
    backends=None,
    player=None,
    autostart=None,
    vad_factory=None,
    device="cuda",
) -> DesktopApp:
    """Assemble the complete app graph. Every seam is injectable for
    tests; production defaults are the real OS surfaces (system text
    output, mic subprocess capture, evdev hotkeys when /dev/input
    exists, in-process fallback backend otherwise). device and
    vad_factory go to AppServices: the engines' device (the card unless
    "cpu") and the recorder's VAD chain (None records ungated, as the
    JAX app does; app.services.default_vad_factory is Silero).

    On macOS and Windows it raises NotImplementedError before it builds
    anything: the JAX app takes its hotkeys and its tray there from
    shell/{macos,windows}_{keys,tray}.py, which the port lacks."""
    if sys.platform == "darwin":
        # CGEventTap hotkeys (shortcut/tauri_impl.rs's macOS monitor
        # analog) and the NSStatusItem tray.
        raise unported("shell/macos_keys.py and shell/macos_tray.py")
    if sys.platform == "win32":
        # RegisterHotKey hotkeys (tauri_impl.rs:108-109) and the
        # Shell_NotifyIcon tray.
        raise unported("shell/windows_keys.py and shell/windows_tray.py")
    services = AppServices(
        data_dir,
        source_factory=source_factory,
        engine_factory=engine_factory,
        vad_factory=vad_factory,
        use_mock_engine=use_mock_engine,
        device=device,
    )
    if output is None:
        from spittle_tpu_torch.shell.textout import SystemTextOutput

        output = SystemTextOutput(services.get_settings)

    ui = AppUi(services, player=player)
    actions = ActionContext(services, output, ui=ui)

    if backends is None:
        from spittle_tpu_torch.shell.evdev_keys import EvdevBackend

        backends = {KeyboardImplementation.TAURI: InMemoryBackend()}
        if EvdevBackend.available():
            backends[KeyboardImplementation.HANDY_KEYS] = EvdevBackend()

    settings = services.get_settings()
    impl = settings.keyboard_implementation
    if impl not in backends:
        impl = next(iter(backends))

    registry = ShortcutRegistry(
        backends,
        handler=actions.handle_shortcut_event,
        events=services.events,
        implementation=impl,
        persist_implementation=lambda i: services.update_settings(
            keyboard_implementation=i
        ),
    )
    actions.registry = registry

    # Evdev key-capture feeds the registry's FrontendKeyEvent stream
    # (spittle-keys.rs recording mode).
    for be in backends.values():
        start_capture = getattr(be, "start_capture", None)
        if start_capture:
            start_capture(registry.feed_captured_key)

    # Register the bindings persisted in settings (lib.rs boot).
    for binding in settings.bindings.values():
        try:
            registry.register_binding(binding.id, binding.current_binding)
        except ValueError:
            pass  # invalid persisted hotkey: leave unbound, UI can fix

    signals = SignalHandler(actions)
    signals.install()

    # Real OS surfaces when the desktop offers them: the tray
    # (StatusNotifierItem on the session bus; tray.rs builds the same
    # tray on every platform) and the session's recording overlay
    # (overlay.rs analog, arm picked by session type).
    from spittle_tpu_torch.shell.overlay_select import attach_session_overlay
    from spittle_tpu_torch.shell.tray_sni import attach_tray

    commands = Commands(services, actions)
    tray = attach_tray(services, actions, ui, commands=commands)
    overlay = attach_session_overlay(services)

    # OS login launcher, reconciled with the persisted setting at boot
    # (lib.rs:219-228) and applied immediately by
    # change_autostart_setting (shortcut/mod.rs:598-622).
    from spittle_tpu_torch.shell.autostart import AutostartManager, default_exec_cmd

    if autostart is None:
        autostart = AutostartManager(default_exec_cmd(data_dir))
    services.autostart = autostart
    try:
        autostart.reconcile(settings.autostart_enabled)
    except OSError:
        pass  # unwritable config dir: the setting still persists

    rpc = AppRpcServer(commands, port=port)
    return DesktopApp(
        services=services, actions=actions, ui=ui,
        registry=registry, rpc=rpc, signals=signals,
        tray=tray, overlay=overlay,
    )


def run_app(data_dir: str, port: int = 47890,
            use_mock_engine: bool = False, device="cuda") -> int:
    """Blocking entry point for `python -m spittle_tpu_torch.cli app`.
    Without a card it raises unless device is "cpu", before it looks for
    a running instance."""
    import signal
    import threading

    from .single_instance import SingleInstanceLock, notify_running_instance

    resolve_device(device)

    # Single-instance guard (lib.rs:403-405 tauri_plugin_single_instance):
    # a second launch surfaces the running instance's console and exits
    # instead of double-grabbing the mic and the hotkeys.
    lock = SingleInstanceLock(data_dir)
    if not lock.acquire():
        peer = lock.peer_port()
        url = notify_running_instance(peer) if peer else None
        print("spittle-tpu app: already running"
              + (f" — console at {url}" if url else ""))
        return 0

    app = build_app(data_dir, port=port, use_mock_engine=use_mock_engine,
                    device=device)
    app.rpc.start()
    lock.publish(app.rpc.address[1])
    stop = threading.Event()

    def on_term(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGINT, on_term)
    signal.signal(signal.SIGTERM, on_term)
    host, bound_port = app.rpc.address
    print(f"spittle-tpu app: console at http://{host}:{bound_port}/ "
          f"(data dir {data_dir})")
    try:
        stop.wait()
    finally:
        app.shutdown()
        lock.release()
    return 0
