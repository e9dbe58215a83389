"""Decision provenance: explain any answer the server gave.

The JAX package's ``obs/provenance.py`` without its lifecycle half.
Metrics say p99 moved, traces say where the time went — neither says
*why* an answer came out as it did: which generation, which route through
the engine, which factor-cache rows, which filters, which wave.  The
:class:`ProvenanceStore` keeps a bounded ring of per-answer
**ProvenanceRecord** dicts — engine instance, variant/role, the engine
path, factor-cache hit/miss counts, degraded fallbacks, filters applied,
wave id/size/seq, the event-history watermark consulted, and the returned
item ids with raw scores — captured on every answered request by both HTTP
front ends and served at ``GET /explain.json``.

Two capture levels:

- **cheap** (always on): bounded dicts and counts, no per-item filter
  contents;
- **deep** (opt-in per request via the ``X-Pio-Explain: 1`` header): adds
  filter item lists and wave-mate request ids.

Handlers and engines attach detail through :func:`note` / :func:`note_deep`
— contextvar scopes exactly like ``obs.flight.annotate``: a request scope
the front ends open, plus a wave scope ``_serve_wave`` binds on the
MicroBatcher's worker/finalizer threads (where the request scope is not
visible).  The record is assembled once, at request finish, by
:func:`finalize_record` (called from ``record_request_outcome``).

Not here: the generation manifest's identity (checksum, shard axes) and
``replay_request`` (``pio replay-request``), which need the lifecycle's
generation store; the port has none yet.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Any, Mapping

#: per-request opt-in for deep capture
EXPLAIN_HEADER = "X-Pio-Explain"

#: answers retained by the always-on ring (newest evict oldest)
RECORD_CAPACITY = 1024

#: deep-capture list fields are clipped to this many entries
DEEP_LIST_CAP = 64

#: request-scoped capture state: {"deep": bool, "notes": {}, "deep_notes": {}}
_scope_var: contextvars.ContextVar[dict[str, Any] | None] = (
    contextvars.ContextVar("pio_provenance_scope", default=None)
)

#: wave-scoped collector bound by the MicroBatcher wave (worker/finalizer
#: threads, where the request scope is invisible); takes precedence
_wave_var: contextvars.ContextVar[dict[str, Any] | None] = (
    contextvars.ContextVar("pio_provenance_wave", default=None)
)


def wants_deep(headers: Mapping[str, str] | None) -> bool:
    """Did the request opt into deep capture?  Case-tolerant header lookup
    (the threaded server hands an email.Message, aio a lower-cased dict)."""
    if not headers:
        return False
    v = headers.get(EXPLAIN_HEADER) or headers.get(EXPLAIN_HEADER.lower()) or ""
    return v in ("1", "true", "yes")


def begin_capture(deep: bool = False) -> contextvars.Token:
    """Open a fresh provenance scope for the current request."""
    return _scope_var.set({"deep": deep, "notes": {}, "deep_notes": {}})


def end_capture(token: contextvars.Token) -> None:
    _scope_var.reset(token)


def note(**fields: Any) -> None:
    """Attach cheap (always-retained) fields to the in-flight answer's
    provenance record.  Inside a wave scope the fields collect wave-side
    and reach each member through the wave's per-item result; otherwise
    they land on the open request scope (no-op when neither is open)."""
    w = _wave_var.get()
    if w is not None:
        w.update(fields)
        return
    s = _scope_var.get()
    if s is not None:
        s["notes"].update(fields)


def note_deep(**fields: Any) -> None:
    """Attach deep-capture fields: kept only for requests that presented
    ``X-Pio-Explain``.  Wave scopes collect them unconditionally (the wave
    cannot see which members opted in); the request scope filters."""
    w = _wave_var.get()
    if w is not None:
        w.setdefault("_deep", {}).update(fields)
        return
    s = _scope_var.get()
    if s is not None and s["deep"]:
        s["deep_notes"].update(fields)


def begin_wave() -> contextvars.Token:
    """Bind a wave collector (MicroBatcher worker/finalizer threads)."""
    return _wave_var.set({})


def end_wave(token: contextvars.Token) -> dict[str, Any]:
    """Close the wave collector and return what it gathered."""
    collected = _wave_var.get() or {}
    _wave_var.reset(token)
    return collected


def clip(items: Any, cap: int = DEEP_LIST_CAP) -> list:
    """Bound a deep-capture list field (sets/tuples accepted)."""
    return list(items)[:cap]


def item_scores(rendered: Any) -> list[dict[str, Any]] | None:
    """The (item id, raw score) pairs of a rendered prediction, or None
    when the answer has no ``itemScores`` shape (marker/test engines)."""
    if not isinstance(rendered, dict):
        return None
    scores = rendered.get("itemScores")
    if not isinstance(scores, list):
        return None
    return [
        {"item": d.get("item"), "score": d.get("score")}
        for d in scores
        if isinstance(d, dict)
    ]


def note_answer(rendered: Any) -> None:
    """Record what was returned: ``items`` (ids + raw scores) for
    itemScores-shaped answers; the whole rendered body otherwise (those
    engines' answers are small — the ring stays bounded either way)."""
    items = item_scores(rendered)
    if items is not None:
        note(items=items)
    else:
        note(answer=rendered)


def binding_fields(deployed: Any, binding: Any) -> dict[str, Any]:
    """The cheap per-answer binding identity: which generation answered and
    on which side.  The port serves one live generation (no canary yet),
    so ``role`` is ``"live"`` and ``variant`` the instance's engine
    variant, as the JAX package labels a live binding."""
    instance = binding.instance
    fields: dict[str, Any] = {
        "instance_id": instance.id,
        "variant": getattr(instance, "engine_variant", None) or "default",
        "role": getattr(binding, "role", "live"),
    }
    factory = getattr(instance, "engine_factory", None)
    if factory:
        fields["engine_factory"] = factory
    return fields


# -- the bounded record store ------------------------------------------------


class ProvenanceStore:
    """Bounded ring of per-answer provenance records, indexed by request
    id.  Crash-tolerant by construction: capture never raises into the
    request path (the front ends guard the finalize call) and the ring
    evicts oldest-first, so a hot server holds the last N decisions and
    nothing more."""

    def __init__(self, capacity: int = RECORD_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._by_rid: dict[str, dict[str, Any]] = {}
        self._total = 0

    def record(self, entry: dict[str, Any]) -> None:
        rid = entry.get("request_id")
        with self._lock:
            self._total += 1
            if len(self._ring) == self.capacity:
                evicted = self._ring[0]
                old_rid = evicted.get("request_id")
                if old_rid is not None and (
                    self._by_rid.get(old_rid) is evicted
                ):
                    del self._by_rid[old_rid]
            self._ring.append(entry)
            if rid is not None:
                self._by_rid[rid] = entry

    def get(self, request_id: str) -> dict[str, Any] | None:
        with self._lock:
            return self._by_rid.get(request_id)

    def snapshot(self, limit: int = 50) -> dict[str, Any]:
        with self._lock:
            records = list(self._ring)[-limit:][::-1]
            total = self._total
        return {
            "recorded_total": total,
            "capacity": self.capacity,
            "records": records,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_rid.clear()
            self._total = 0


def finalize_record(
    store: ProvenanceStore,
    server_name: str,
    req: Any,
    resp: Any,
    duration_s: float,
    span: Any,
) -> None:
    """Assemble + store the answer's record from the open capture scope.
    Requests where nothing noted provenance (status pages, admin verbs)
    leave no record; called from ``record_request_outcome`` under the
    front ends' telemetry guard, so a capture bug can't fail a request."""
    scope = _scope_var.get()
    if scope is None or not scope["notes"]:
        return
    entry: dict[str, Any] = {
        "request_id": getattr(span, "request_id", None),
        "trace_id": getattr(span, "trace_id", None),
        "ts": round(time.time(), 3),
        "server": server_name,
        "path": req.path,
        "status": resp.status,
        "duration_s": round(duration_s, 6),
        "capture": "deep" if scope["deep"] else "cheap",
    }
    entry.update(scope["notes"])
    if scope["deep"] and scope["deep_notes"]:
        entry["deep"] = dict(scope["deep_notes"])
    store.record(entry)
