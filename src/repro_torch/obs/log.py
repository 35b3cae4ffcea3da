"""Structured logger for the launch CLIs.

Replaces the bare ``print`` calls across ``launch/``: by default a
message renders exactly as the old prints did (bare text to stdout, so
CSV-shaped progress lines and shell pipelines keep working), but every
message ALSO lands in the obs event stream as a ``log`` event whenever
``REPRO_OBS`` is not ``off`` — so a JSONL trace interleaves spans with
the progress lines that narrate them.

``set_quiet(True)`` (the ``--quiet`` flag of the training CLIs)
suppresses info-level terminal output; warnings/errors still print (to
stderr), and the event stream is unaffected — quiet is a terminal
concern, not a telemetry one.

Copied from ``src/repro/obs/log.py``.
"""
from __future__ import annotations

import sys
from typing import Dict

_QUIET = False


def set_quiet(quiet: bool) -> None:
    global _QUIET
    _QUIET = bool(quiet)


def quiet() -> bool:
    return _QUIET


class Logger:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def info(self, msg: str = "", **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str = "", **fields) -> None:
        self._emit("warning", msg, fields)

    def error(self, msg: str = "", **fields) -> None:
        self._emit("error", msg, fields)

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        from repro_torch import obs      # deferred: obs re-exports this module
        event = {"type": "log", "level": level, "logger": self.name,
                 "msg": msg}
        if fields:
            event["fields"] = fields
        obs.emit_event(event)
        if level == "info" and _QUIET:
            return
        line = msg
        if fields:
            tail = " ".join(f"{k}={v}" for k, v in fields.items())
            line = f"{msg} {tail}" if msg else tail
        print(line, file=sys.stdout if level == "info" else sys.stderr,
              flush=True)


_LOGGERS: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    return _LOGGERS.setdefault(name, Logger(name))
