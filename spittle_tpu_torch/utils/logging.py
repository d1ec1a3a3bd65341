"""Logging: console + rotating file targets with a run-time level (port of
spittle_tpu/utils/logging.py).

A console target filtered by an env spec (SPITTLE_LOG: trace, debug,
info, warning, error), a file target whose level is adjustable at run
time from settings or the UI, and 500 KB rotation keeping one backup. The
port's loggers are children of "spittle_tpu_torch"; handlers are set only
by init_logging, otherwise the application's.
"""

from __future__ import annotations

import enum
import logging
import logging.handlers
import os
import threading
from typing import Optional

FILE_MAX_BYTES = 500_000
FILE_BACKUPS = 1
ROOT = "spittle_tpu_torch"


class LogLevel(str, enum.Enum):
    """The settings' log levels (the port's copy of
    spittle_tpu/config/settings.py:LogLevel)."""

    TRACE = "trace"
    DEBUG = "debug"
    INFO = "info"
    WARN = "warn"
    ERROR = "error"


_LEVELS = {
    LogLevel.TRACE: 5,
    LogLevel.DEBUG: logging.DEBUG,
    LogLevel.INFO: logging.INFO,
    LogLevel.WARN: logging.WARNING,
    LogLevel.ERROR: logging.ERROR,
}

logging.addLevelName(5, "TRACE")


class _RuntimeLevelFilter(logging.Filter):
    """The file target's level, changed at run time under a lock."""

    def __init__(self):
        super().__init__()
        self._level = logging.DEBUG
        self._lock = threading.Lock()

    def set_level(self, level: int) -> None:
        with self._lock:
            self._level = level

    def filter(self, record: logging.LogRecord) -> bool:
        with self._lock:
            return record.levelno >= self._level


class LogSystem:
    def __init__(self, log_dir: str, console_env: str = "SPITTLE_LOG"):
        os.makedirs(log_dir, exist_ok=True)
        self.logger = logging.getLogger(ROOT)
        self.logger.setLevel(5)
        self.logger.propagate = False
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")

        console = logging.StreamHandler()
        env_level = os.environ.get(console_env, "info").upper()
        console.setLevel(
            5 if env_level == "TRACE" else
            getattr(logging, env_level, logging.INFO)
        )
        console.setFormatter(fmt)
        self.logger.addHandler(console)

        self.log_path = os.path.join(log_dir, f"{ROOT}.log")
        file_handler = logging.handlers.RotatingFileHandler(
            self.log_path, maxBytes=FILE_MAX_BYTES, backupCount=FILE_BACKUPS
        )
        file_handler.setLevel(5)
        file_handler.setFormatter(fmt)
        self._file_filter = _RuntimeLevelFilter()
        file_handler.addFilter(self._file_filter)
        self.logger.addHandler(file_handler)

    def set_file_level(self, level: LogLevel) -> None:
        """Change the file target's level at run time."""
        self._file_filter.set_level(_LEVELS[level])


_system: Optional[LogSystem] = None


def init_logging(log_dir: str) -> LogSystem:
    global _system
    _system = LogSystem(log_dir)
    return _system


def get_logger(name: str = "") -> logging.Logger:
    base = logging.getLogger(ROOT)
    return base.getChild(name) if name else base
