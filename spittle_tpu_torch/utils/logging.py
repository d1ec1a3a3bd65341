"""The port's loggers (the part of spittle_tpu/utils/logging.py that the
serving path uses): children of the "spittle_tpu_torch" logger. Handlers
and levels are the application's to set."""

from __future__ import annotations

import logging


def get_logger(name: str = "") -> logging.Logger:
    base = logging.getLogger("spittle_tpu_torch")
    return base.getChild(name) if name else base
