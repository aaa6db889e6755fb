"""Daemon logging: stderr or rotating files, and throttled retry logs.

Mirrors arrow_ballista_tpu/utils/logsetup.py: daemons log to stderr by
default, or to ``<log_dir>/<prefix>.log`` with time-based rotation
(minutely, hourly, daily or never).  One daemon per (log_dir, prefix): the
rollover rename is not multi-process safe.

Log and trace correlation: ``log_scope(job_id=..., trace_id=...,
span_id=...)`` sets a thread-ambient context, and ``ContextFilter`` stamps
those fields onto every record emitted inside it.  The text format
appends ``[job=... trace=...]`` when present; ``fmt="json"`` (or
``BALLISTA_LOG_FORMAT=json``) writes one JSON object per line.

``ThrottledLogger`` lets a retry loop log at most once an interval per
kind, counting what it suppressed (the executor server's heartbeat,
status-report and poll loops).
"""
from __future__ import annotations

import contextlib
import json
import logging
import logging.handlers
import os
import threading
import time
from typing import Callable, Dict, Optional

ROTATION_POLICIES = ("minutely", "hourly", "daily", "never")
LOG_FORMATS = ("text", "json")

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

# thread-ambient correlation fields (job_id / trace_id / span_id)
_log_ctx = threading.local()

_CTX_FIELDS = ("job_id", "trace_id", "span_id")


@contextlib.contextmanager
def log_scope(job_id: str = "", trace_id: str = "", span_id: str = ""):
    """Stamp records emitted on this thread (via ``ContextFilter``) with
    the given correlation ids.  Nests: the previous scope is restored on
    exit."""
    prev = getattr(_log_ctx, "fields", None)
    _log_ctx.fields = {"job_id": job_id, "trace_id": trace_id,
                       "span_id": span_id}
    try:
        yield
    finally:
        _log_ctx.fields = prev


class ContextFilter(logging.Filter):
    """Copies the ambient ``log_scope`` fields onto every record (empty
    strings outside any scope), so formatters and downstream handlers can
    rely on the attributes existing."""

    def filter(self, record: logging.LogRecord) -> bool:
        fields = getattr(_log_ctx, "fields", None)
        for k in _CTX_FIELDS:
            setattr(record, k, fields.get(k, "") if fields else "")
        return True


class TextFormatter(logging.Formatter):
    """The classic text format plus a ``[job=... trace=...]`` suffix when
    the record carries correlation ids."""

    def format(self, record: logging.LogRecord) -> str:
        s = super().format(record)
        job_id = getattr(record, "job_id", "")
        if job_id:
            trace_id = getattr(record, "trace_id", "")
            s += f" [job={job_id}" \
                 + (f" trace={trace_id}" if trace_id else "") + "]"
        return s


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/message plus any
    correlation fields that are set (log aggregators join on job_id or
    trace_id against the span store / flight recorder)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {"ts": round(record.created, 3),
               "level": record.levelname,
               "logger": record.name,
               "message": record.getMessage()}
        for k in _CTX_FIELDS:
            v = getattr(record, k, "")
            if v:
                out[k] = v
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def _make_formatter(fmt: str) -> logging.Formatter:
    if fmt not in LOG_FORMATS:
        raise ValueError(f"unknown log format {fmt!r}; "
                         f"expected one of {LOG_FORMATS}")
    return JsonFormatter() if fmt == "json" else TextFormatter(_FORMAT)


def init_logging(level: str = "INFO", log_dir: Optional[str] = None,
                 file_prefix: str = "ballista", rotation: str = "daily",
                 fmt: Optional[str] = None) -> None:
    """Configure the root logger.  ``log_dir=None`` -> stderr only.
    ``fmt``: "text" (default) or "json"; None reads
    ``BALLISTA_LOG_FORMAT`` (daemons pass ``ballista.log.format``)."""
    if rotation not in ROTATION_POLICIES:
        raise ValueError(f"unknown rotation policy {rotation!r}; "
                         f"expected one of {ROTATION_POLICIES}")
    if fmt is None:
        fmt = os.environ.get("BALLISTA_LOG_FORMAT", "text")
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    formatter = _make_formatter(fmt)
    ctx_filter = ContextFilter()
    if log_dir is None:
        h: logging.Handler = logging.StreamHandler()
        h.setFormatter(formatter)
        h.addFilter(ctx_filter)
        root.addHandler(h)
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{file_prefix}.log")
    if rotation == "never":
        h = logging.FileHandler(path)
    else:
        when = {"minutely": "M", "hourly": "H", "daily": "midnight"}[rotation]
        h = logging.handlers.TimedRotatingFileHandler(
            path, when=when, interval=1, backupCount=72)
    h.setFormatter(formatter)
    h.addFilter(ctx_filter)
    root.addHandler(h)
    # operational errors still surface on the console while normal flow
    # goes to the file (same split as the reference's print_thread_info
    # stdout diagnostics next to file tracing)
    console = logging.StreamHandler()
    console.setLevel(logging.WARNING)
    console.setFormatter(formatter)
    console.addFilter(ctx_filter)
    root.addHandler(console)


class ThrottledLogger:
    """At most one record per ``interval_s`` per *key* (interval-class).

    Retry loops that log every iteration flood the log exactly when the
    operator needs it readable (scheduler down => one status-report warning
    per second per executor).  Suppressed occurrences are counted and the
    count is appended to the next record that does get through.
    """

    def __init__(self, logger: logging.Logger, interval_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self._logger = logger
        self.interval_s = float(interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_emit: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}

    def log(self, level: int, key: str, msg: str, *args,
            exc_info=False) -> bool:
        now = self._clock()
        with self._lock:
            last = self._last_emit.get(key)
            if last is not None and now - last < self.interval_s:
                self._suppressed[key] = self._suppressed.get(key, 0) + 1
                return False
            n = self._suppressed.pop(key, 0)
            self._last_emit[key] = now
        if n:
            msg = f"{msg} ({n} similar suppressed in the last " \
                  f"{self.interval_s:.0f}s)"
        self._logger.log(level, msg, *args, exc_info=exc_info)
        return True

    def warning(self, key: str, msg: str, *args, **kw) -> bool:
        return self.log(logging.WARNING, key, msg, *args, **kw)

    def error(self, key: str, msg: str, *args, **kw) -> bool:
        return self.log(logging.ERROR, key, msg, *args, **kw)
