"""The headless app: services, shortcut actions, UI state and the command
surface with its RPC server (port of spittle_tpu/app)."""

from .services import AppServices

__all__ = ["AppServices"]
