"""Structured (JSON-lines) logging with request-id correlation.

The JAX package's ``obs/logging.py``, stdlib only.  Every log record can
carry a ``request_id``/``trace_id`` pair propagated through
:mod:`contextvars`, so one slow query is greppable across the aio front end,
the route handler, and the MicroBatcher wave that served it.  The ring
hangs on the port's package logger (``predictionio_tpu_torch``).

Three pieces:

- contextvar helpers (:func:`set_request_context` / :func:`get_request_id`)
  that the HTTP front ends set per request and everything else reads;
- :class:`JsonLineFormatter`, a collector-parseable one-JSON-object-per-line
  formatter that folds in the context ids and any ``extra=`` fields;
- :class:`LogRing`, a bounded in-process ring of recent records served at
  ``GET /logs.json`` so "what did the server just log" is answerable without
  shipping logs anywhere.

:func:`configure_logging` is the single entry point the ``pio`` CLI and the
standalone servers adopt (replacing ad-hoc ``logging.basicConfig`` calls):
JSON lines to stderr by default (``PIO_LOG_FORMAT=text`` for humans), ring
always attached.  Everything is stdlib-only.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import random
import secrets
import sys
import threading
import time
from collections import deque
from typing import Any, TextIO

#: per-request correlation ids; set by the HTTP front ends, read everywhere
_request_id_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pio_request_id", default=None
)
_trace_id_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pio_trace_id", default=None
)

#: header under which request ids travel (request and response)
REQUEST_ID_HEADER = "X-Pio-Request-Id"


#: request-id generator: seeded once from the OS, then pure userspace, as
#: the span ids are (obs/disttrace.py).  The JAX package draws each id from
#: ``secrets.token_hex``, an ``os.urandom`` syscall per request, which the
#: event loop makes between one query's submit and the next: the syscall
#: releases the interpreter lock, the micro-batcher's worker takes it and
#: dispatches the queries queued so far, and waves shrink (the same reason
#: the span ids avoid it).  Request ids need uniqueness, not cryptographic
#: strength.
_rand = random.Random(secrets.randbits(64) ^ (os.getpid() << 16))


def new_request_id() -> str:
    """Mint a 16-hex-char request id (collision-safe at fleet scale)."""
    return f"{_rand.getrandbits(64):016x}"


def set_request_context(
    request_id: str | None, trace_id: str | None = None
) -> tuple[contextvars.Token, contextvars.Token]:
    """Bind correlation ids to the current context; returns reset tokens."""
    return (
        _request_id_var.set(request_id),
        _trace_id_var.set(trace_id or request_id),
    )


def reset_request_context(
    tokens: tuple[contextvars.Token, contextvars.Token]
) -> None:
    _request_id_var.reset(tokens[0])
    _trace_id_var.reset(tokens[1])


def get_request_id() -> str | None:
    return _request_id_var.get()


def get_trace_id() -> str | None:
    return _trace_id_var.get()


#: LogRecord attributes that are plumbing, not user-supplied extras
_RESERVED = frozenset(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


def record_fields(record: logging.LogRecord) -> dict[str, Any]:
    """A log record as a flat JSON-safe dict: timestamp, level, logger,
    message, the contextvar correlation ids, and any ``extra=`` fields."""
    fields: dict[str, Any] = {
        "ts": round(record.created, 6),
        "level": record.levelname,
        "logger": record.name,
        "message": record.getMessage(),
    }
    rid = _request_id_var.get()
    if rid:
        fields["request_id"] = rid
    tid = _trace_id_var.get()
    if tid and tid != rid:
        fields["trace_id"] = tid
    for k, v in record.__dict__.items():
        if k not in _RESERVED and not k.startswith("_"):
            fields[k] = v
    if record.exc_info and record.exc_info[0] is not None:
        fields["exc"] = logging.Formatter().formatException(record.exc_info)
    return fields


class JsonLineFormatter(logging.Formatter):
    """One JSON object per line — what a log collector actually wants."""

    def format(self, record: logging.LogRecord) -> str:
        return json.dumps(record_fields(record), default=str, sort_keys=True)


class LogRing(logging.Handler):
    """Bounded ring of recent structured records, served at /logs.json.

    ``emit`` stores the flat field dict (not the formatted string) so the
    HTTP route can filter by ``request_id``/``level`` without re-parsing.
    Uses the Handler's own lock for the deque so readers never race emit.
    """

    def __init__(self, maxlen: int = 1024, level: int = logging.DEBUG):
        super().__init__(level=level)
        self._ring: deque[dict[str, Any]] = deque(maxlen=maxlen)

    def emit(self, record: logging.LogRecord) -> None:
        if getattr(record, "_pio_ring_skip", False):
            return  # already ring_append()ed directly — no duplicate
        try:
            fields = record_fields(record)
        except Exception:  # telemetry must never break the caller
            return
        with self.lock:
            self._ring.append(fields)

    def append_fields(self, fields: dict[str, Any]) -> None:
        """Direct append, bypassing the logging pipeline (see ring_debug)."""
        with self.lock:
            self._ring.append(fields)

    def records(
        self,
        limit: int = 100,
        request_id: str | None = None,
        min_level: str | None = None,
    ) -> list[dict[str, Any]]:
        """Most recent matching records, newest first."""
        with self.lock:
            items = list(self._ring)
        if request_id is not None:
            items = [
                f
                for f in items
                if f.get("request_id") == request_id
                or request_id in (f.get("request_ids") or ())
            ]
        if min_level is not None:
            threshold = logging.getLevelName(min_level.upper())
            if isinstance(threshold, int):
                items = [
                    f
                    for f in items
                    if logging.getLevelName(f.get("level", "NOTSET"))
                    >= threshold
                ]
        return items[::-1][: max(limit, 0)]

    def clear(self) -> None:
        with self.lock:
            self._ring.clear()


_state_lock = threading.Lock()
_ring: LogRing | None = None


def ensure_ring(maxlen: int = 1024) -> LogRing:
    """Attach the process log ring to the package logger (idempotent).

    Deliberately does NOT touch logger levels: forcing the package logger
    to DEBUG would leak debug records through any embedding application's
    level-less root handlers (``logging.basicConfig`` users).  The ring
    sees whatever the host's logging config lets through; correlation-
    critical lines use :func:`ring_debug`, which reaches the ring
    unconditionally.  :func:`configure_logging` (the CLI / standalone-
    server path, where we own the handlers) opens the package logger to
    DEBUG so the ring captures everything.
    """
    global _ring
    with _state_lock:
        if _ring is None:
            _ring = LogRing(maxlen=maxlen)
            logging.getLogger("predictionio_tpu_torch").addHandler(_ring)
        return _ring


def get_log_ring() -> LogRing:
    return ensure_ring()


def ring_debug(logger: logging.Logger, message: str, **fields: Any) -> None:
    """Emit a correlation record that ALWAYS reaches the /logs.json ring,
    regardless of the host's logging configuration, and flows through
    normal logging at DEBUG only when the logger is enabled for it (flagged
    so the ring handler doesn't record it twice).  Used for the
    request-correlation lines — e.g. the MicroBatcher's per-wave
    request_ids — whose whole purpose is being findable later."""
    entry: dict[str, Any] = {
        "ts": round(time.time(), 6),
        "level": "DEBUG",
        "logger": logger.name,
        "message": message,
    }
    rid = _request_id_var.get()
    if rid:
        entry["request_id"] = rid
    entry.update(fields)
    ensure_ring().append_fields(entry)
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug(message, extra={**fields, "_pio_ring_skip": True})


def configure_logging(
    level: str | int | None = None,
    stream: TextIO | None = None,
    fmt: str | None = None,
    ring_size: int = 1024,
) -> LogRing:
    """Process-wide logging setup for the CLI and standalone servers.

    JSON lines (default) or classic text (``fmt="text"`` /
    ``PIO_LOG_FORMAT=text``) to ``stream`` (default stderr) at ``level``
    (default ``PIO_LOG_LEVEL`` or INFO; a typo'd env var must not crash
    every verb), plus the bounded ring at DEBUG.  Idempotent: calling again
    replaces the handler this function installed, never third-party ones.
    """
    if level is None:
        level = os.environ.get("PIO_LOG_LEVEL", "INFO").upper()
    if isinstance(level, str):
        resolved = getattr(logging, level.upper(), None)
        level = resolved if isinstance(resolved, int) else logging.INFO
    fmt = (fmt or os.environ.get("PIO_LOG_FORMAT", "json")).lower()
    ring = ensure_ring(ring_size)
    # we own the handler levels from here on, so opening the package logger
    # to DEBUG feeds the ring everything without spamming the console
    logging.getLogger("predictionio_tpu_torch").setLevel(logging.DEBUG)
    root = logging.getLogger()
    for h in list(root.handlers):
        if getattr(h, "_pio_structured", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setLevel(level)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        if fmt == "text"
        else JsonLineFormatter()
    )
    handler._pio_structured = True  # type: ignore[attr-defined]
    root.addHandler(handler)
    root.setLevel(level)
    return ring
