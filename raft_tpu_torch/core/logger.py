"""Logging (port of ``raft_tpu.core.logger``).

Counterpart of the reference's spdlog-backed singleton logger with a callback
sink so host applications can capture log records
(cpp/include/raft/core/logger.hpp:36,118-180; core/detail/callback_sink.hpp).

Implemented over :mod:`logging` with the same surface: settable level/pattern,
an optional callback sink, and ``RAFT_LOG_*``-style helpers.  The port logs
under its own logger name, ``"raft_tpu_torch"``: a process that imports both
packages keeps two loggers, each with its own handlers and level.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

OFF = logging.CRITICAL + 10
CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARN = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
TRACE = logging.DEBUG - 5

logging.addLevelName(TRACE, "TRACE")

_DEFAULT_PATTERN = "[%(levelname)s] [%(asctime)s] %(message)s"


class _CallbackHandler(logging.Handler):
    """Routes records to a user callback (reference: callback_sink.hpp)."""

    def __init__(self, callback: Callable[[int, str], None],
                 flush: Optional[Callable[[], None]] = None):
        super().__init__()
        self._callback = callback
        self._flush = flush

    def emit(self, record: logging.LogRecord) -> None:
        self._callback(record.levelno, self.format(record))

    def flush(self) -> None:
        if self._flush is not None:
            self._flush()


class Logger:
    """Singleton logger (reference: ``raft::logger``, core/logger.hpp:118)."""

    _instance: Optional["Logger"] = None

    def __init__(self) -> None:
        self._logger = logging.getLogger("raft_tpu_torch")
        self._logger.propagate = False
        self._stream = logging.StreamHandler(sys.stderr)
        self._formatter = logging.Formatter(_DEFAULT_PATTERN)
        self._stream.setFormatter(self._formatter)
        self._logger.addHandler(self._stream)
        self._logger.setLevel(INFO)
        self._callback_handler: Optional[_CallbackHandler] = None

    @classmethod
    def get(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = Logger()
        return cls._instance

    def set_level(self, level: int) -> None:
        self._logger.setLevel(level)

    def get_level(self) -> int:
        return self._logger.level

    def should_log_for(self, level: int) -> bool:
        return self._logger.isEnabledFor(level)

    def set_pattern(self, pattern: str) -> None:
        self._formatter = logging.Formatter(pattern)
        for h in self._logger.handlers:
            h.setFormatter(self._formatter)

    def set_callback(self, callback: Optional[Callable[[int, str], None]],
                     flush: Optional[Callable[[], None]] = None) -> None:
        """Install (or clear) a callback sink replacing stderr output."""
        if self._callback_handler is not None:
            self._logger.removeHandler(self._callback_handler)
            self._callback_handler = None
            if self._stream not in self._logger.handlers:
                self._logger.addHandler(self._stream)
        if callback is not None:
            self._logger.removeHandler(self._stream)
            self._callback_handler = _CallbackHandler(callback, flush)
            self._callback_handler.setFormatter(self._formatter)
            self._logger.addHandler(self._callback_handler)

    def log(self, level: int, msg: str, *args) -> None:
        self._logger.log(level, msg, *args)

    def flush(self) -> None:
        for h in self._logger.handlers:
            h.flush()


def log_trace(msg: str, *args) -> None:
    Logger.get().log(TRACE, msg, *args)


def log_debug(msg: str, *args) -> None:
    Logger.get().log(DEBUG, msg, *args)


def log_info(msg: str, *args) -> None:
    Logger.get().log(INFO, msg, *args)


def log_warn(msg: str, *args) -> None:
    Logger.get().log(WARN, msg, *args)


def log_error(msg: str, *args) -> None:
    Logger.get().log(ERROR, msg, *args)
