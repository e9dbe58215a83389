"""Flight recorder: keep the requests worth debugging.

A metrics histogram tells you p99 moved; it cannot tell you *which* request
moved it.  The flight recorder retains full per-request records — span tree,
queue-wait/device split, payload sizes, error text — for the N slowest
requests plus every errored one, served at ``GET /debug/flight.json``.
Bounded memory: a min-heap of the slowest N and a ring of recent errors.

Handlers attach request-scoped detail (the MicroBatcher's per-item timing,
wave size) through :func:`annotate`, a contextvar dict the HTTP front end
folds into the entry when the request finishes — no plumbing through return
values.
"""

from __future__ import annotations

import contextvars
import heapq
import threading
import time
from collections import deque
from typing import Any

#: request-scoped annotations merged into the flight entry at finish
_annotations_var: contextvars.ContextVar[dict[str, Any] | None] = (
    contextvars.ContextVar("pio_flight_annotations", default=None)
)


def begin_annotations() -> contextvars.Token:
    """Open a fresh annotation scope for the current request."""
    return _annotations_var.set({})


def end_annotations(token: contextvars.Token) -> None:
    _annotations_var.reset(token)


def annotate(**fields: Any) -> None:
    """Attach fields to the in-flight request's flight entry (no-op when no
    request scope is open, e.g. unit-testing a handler directly)."""
    d = _annotations_var.get()
    if d is not None:
        d.update(fields)


def current_annotations() -> dict[str, Any]:
    return dict(_annotations_var.get() or {})


class FlightRecorder:
    """Retain the slowest and the errored requests, bounded.

    ``record(entry)`` takes a flat dict (request_id, route, status,
    duration_s, span, ...).  Entries with status >= 500 or an ``error``
    field land in the error ring (newest evicts oldest); every entry
    competes for the slowest-N heap by ``duration_s``.
    """

    def __init__(self, keep_slowest: int = 32, keep_errors: int = 64):
        self.keep_slowest = keep_slowest
        self._lock = threading.Lock()
        #: min-heap of (duration_s, seq, entry) — root is the fastest of
        #: the slow set, so a new slower entry replaces it in O(log N)
        self._slowest: list[tuple[float, int, dict[str, Any]]] = []
        self._errors: deque[dict[str, Any]] = deque(maxlen=keep_errors)
        self._seq = 0
        self._total = 0

    def would_retain(self, duration_s: float) -> bool:
        """Lock-free pre-check: would a non-errored entry of this duration
        enter the slowest-N heap?  Callers use it to skip building the
        (span-tree-serializing) entry for unremarkable requests; the answer
        is approximate under concurrency, which only risks one extra build.
        """
        slowest = self._slowest
        return len(slowest) < self.keep_slowest or duration_s > slowest[0][0]

    def record(self, entry: dict[str, Any]) -> None:
        duration = float(entry.get("duration_s") or 0.0)
        errored = entry.get("error") is not None or (
            int(entry.get("status") or 0) >= 500
        )
        with self._lock:
            self._seq += 1
            self._total += 1
            entry.setdefault("time", round(time.time(), 3))
            if errored:
                self._errors.append(entry)
            item = (duration, self._seq, entry)
            if len(self._slowest) < self.keep_slowest:
                heapq.heappush(self._slowest, item)
            elif duration > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, item)

    def snapshot(
        self,
        request_id: str | None = None,
        limit: int | None = None,
        trace_id: str | None = None,
    ) -> dict[str, Any]:
        """Slowest (descending duration) and errored (newest first);
        ``trace_id`` filters to one cross-process trace's entries (the
        click-through from an SLO exemplar or an assembled timeline)."""
        with self._lock:
            slowest = [e for _, _, e in sorted(self._slowest, reverse=True)]
            errors = list(self._errors)[::-1]
            total = self._total
        if request_id is not None:
            slowest = [e for e in slowest if e.get("request_id") == request_id]
            errors = [e for e in errors if e.get("request_id") == request_id]
        if trace_id is not None:
            slowest = [e for e in slowest if e.get("trace_id") == trace_id]
            errors = [e for e in errors if e.get("trace_id") == trace_id]
        if limit is not None:
            slowest, errors = slowest[:limit], errors[:limit]
        return {"recorded_total": total, "slowest": slowest, "errors": errors}

    def clear(self) -> None:
        with self._lock:
            self._slowest.clear()
            self._errors.clear()
            self._total = 0


#: process-default recorder (apps may hold their own for test isolation)
FLIGHT = FlightRecorder()
