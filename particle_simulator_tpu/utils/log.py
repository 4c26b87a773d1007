"""stderr logging with file:line prefixes — the log.hpp analog.

The reference's entire logging system is a macro printing ``[file:line]`` to
stderr (cuda_simulator/src/lib/log.hpp:3-8). Same surface here, plus level
filtering via the PS_LOG env var (debug|info|warn|error, default info).
"""

from __future__ import annotations

import inspect
import os
import sys

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_THRESHOLD = _LEVELS.get(os.environ.get("PS_LOG", "info").lower(), 20)


def _emit(level: str, *args) -> None:
    if _LEVELS[level] < _THRESHOLD:
        return
    frame = inspect.stack()[2]
    loc = f"{os.path.basename(frame.filename)}:{frame.lineno}"
    print(f"[{loc}]", *args, file=sys.stderr)


def debug(*args) -> None:
    _emit("debug", *args)


def log(*args) -> None:
    """info-level, the reference macro's name."""
    _emit("info", *args)


def warn(*args) -> None:
    _emit("warn", *args)


def error(*args) -> None:
    _emit("error", *args)
