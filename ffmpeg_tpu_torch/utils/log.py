"""Leveled, context-scoped logging (the port's copy of
ffmpeg_tpu/utils/log.py; analog of libavutil/log.{c,h}).

The reference attaches an AVClass to every context and logs through
av_log(ctx, level, ...) (log.h:76-130). Here every framework object exposes
a `.log(level, msg)` via LogMixin; the global level gates output, and a
machine-readable hook supports the `-report`/FFREPORT equivalent.
"""

from __future__ import annotations

import os
import sys
import time
from enum import IntEnum
from typing import Callable, Optional


class LogLevel(IntEnum):
    QUIET = -8
    PANIC = 0
    FATAL = 8
    ERROR = 16
    WARNING = 24
    INFO = 32
    VERBOSE = 40
    DEBUG = 48
    TRACE = 56


_NAMES = {
    LogLevel.PANIC: "panic",
    LogLevel.FATAL: "fatal",
    LogLevel.ERROR: "error",
    LogLevel.WARNING: "warning",
    LogLevel.INFO: "info",
    LogLevel.VERBOSE: "verbose",
    LogLevel.DEBUG: "debug",
    LogLevel.TRACE: "trace",
}

_level = LogLevel(int(os.environ.get("FFTPU_LOGLEVEL", LogLevel.INFO)))
_callback: Optional[Callable[[object, int, str], None]] = None
_report_file = None


def set_level(level: int | str) -> None:
    global _level
    if isinstance(level, str):
        by_name = {v: k for k, v in _NAMES.items()}
        level = by_name[level.lower()]
    _level = LogLevel(level)


def get_level() -> LogLevel:
    return _level


def set_callback(cb: Optional[Callable[[object, int, str], None]]) -> None:
    """Equivalent of av_log_set_callback."""
    global _callback
    _callback = cb


def enable_report(path: str | None = None) -> None:
    """FFREPORT analog: tee all log lines to a file (cmdutils.c:516)."""
    global _report_file
    path = path or time.strftime("fftpu-%Y%m%d-%H%M%S.log")
    _report_file = open(path, "a", buffering=1)


def log(ctx: object, level: int, msg: str) -> None:
    if _callback is not None:
        _callback(ctx, level, msg)
    if _report_file is not None and level <= LogLevel.DEBUG:
        name = getattr(ctx, "log_name", ctx.__class__.__name__ if ctx else "")
        _report_file.write(f"[{name}] {msg}\n")
    if level > _level:
        return
    name = getattr(ctx, "log_name", ctx.__class__.__name__ if ctx is not None else "")
    prefix = f"[{name}] " if name else ""
    stream = sys.stderr
    stream.write(f"{prefix}{msg}\n")


class LogMixin:
    """Gives any context object AVClass-style scoped logging."""

    log_name: str = ""

    def log(self, level: int, msg: str) -> None:
        log(self, level, msg)

    def trace(self, msg: str) -> None:
        log(self, LogLevel.TRACE, msg)

    def debug(self, msg: str) -> None:
        log(self, LogLevel.DEBUG, msg)

    def info(self, msg: str) -> None:
        log(self, LogLevel.INFO, msg)

    def warning(self, msg: str) -> None:
        log(self, LogLevel.WARNING, msg)

    def error(self, msg: str) -> None:
        log(self, LogLevel.ERROR, msg)
