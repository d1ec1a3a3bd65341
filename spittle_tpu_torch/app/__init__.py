"""The headless app: services and shortcut actions (port of
spittle_tpu/app)."""

from .services import AppServices

__all__ = ["AppServices"]
