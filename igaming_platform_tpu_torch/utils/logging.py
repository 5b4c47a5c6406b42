"""Structured JSON logging — the slog equivalent.

The port's copy of ``igaming_platform_tpu/utils/logging.py`` (pure Python, kept apart so
the port imports nothing of the JAX package); JSON lines also carry the
active span's ``trace_id`` (obs/tracing.py), so a log line joins its flight
entry.

The reference logs structured JSON with env-driven levels and debug-mode
source locations (risk/cmd/main.go:278-299). `setup_logging` configures
the stdlib logger the same way; `log_context` attaches key-value pairs
that ride every record in scope (request ids, account ids).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import sys
import time

_context: contextvars.ContextVar[dict] = contextvars.ContextVar("log_context", default={})

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class JSONFormatter(logging.Formatter):
    def __init__(self, include_source: bool = False):
        super().__init__()
        self.include_source = include_source

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        entry.update(_context.get())
        from igaming_platform_tpu_torch.obs import tracing

        active = tracing.current_span()
        if active is not None:
            entry.setdefault("trace_id", active.trace_id)
        extra = getattr(record, "kv", None)
        if extra:
            entry.update(extra)
        if self.include_source:
            entry["source"] = f"{record.pathname}:{record.lineno}"
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def setup_logging(level: str = "info", *, json_output: bool = True, debug_source: bool = False) -> None:
    root = logging.getLogger()
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    if json_output:
        handler.setFormatter(JSONFormatter(include_source=debug_source))
    else:
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    root.handlers = [handler]


@contextlib.contextmanager
def log_context(**kv):
    """Attach key-value pairs to every record emitted in this scope."""
    current = dict(_context.get())
    current.update(kv)
    token = _context.set(current)
    try:
        yield
    finally:
        _context.reset(token)


def kv(logger: logging.Logger, level: int, msg: str, **pairs) -> None:
    """Log with structured key-value pairs (slog-style)."""
    logger.log(level, msg, extra={"kv": pairs})
