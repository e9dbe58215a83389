"""Cross-process distributed tracing: context propagation + span fragments.

The JAX package's ``obs/disttrace.py``, stdlib only.  Every request has a
correlation id and every wave a device-time split, but a request that
crosses processes would still yield per-process span trees stitched only by
grepping a request id.  This module is the propagation half:

- W3C-traceparent-style headers, ``X-Pio-Trace-Id`` (one id for the whole
  cross-process request) and ``X-Pio-Parent-Span`` (the caller's span id, so
  a callee's root span parents correctly instead of orphaning);
- per-span identity: every :class:`~predictionio_tpu_torch.obs.tracing.Span`
  mints a span id and records a wall-clock start, so finished span trees
  flatten into *fragments* — flat parent-linked records a collector can
  merge across processes;
- a bounded per-process :class:`FragmentStore` served at
  ``GET /spans.json?trace_id=`` (obs/http.py), which is what a cross-process
  assembler fetches and clock-aligns (the JAX package's ``pio trace``; the
  port has no assembler yet).

Propagation rides the existing contextvar machinery: the HTTP front ends
adopt the incoming headers (:func:`adopt_trace_context` +
:func:`bind_parent_span`), and the MicroBatcher re-binds the first wave
member's context (:func:`current_trace_context`) around ``batch_fn`` so a
wave's log records and outbound calls join that request's trace.  The
outbound half (the JAX package's ``propagation_headers``) comes with the
port's first cross-process client, its remote storage.  Everything is stdlib-only and never raises into the
caller — telemetry must not break serving.
"""

from __future__ import annotations

import contextvars
import os
import random
import secrets
import threading
import time
from collections import OrderedDict
from typing import Any, Mapping

from predictionio_tpu_torch.obs.contention import ContendedLock
from predictionio_tpu_torch.obs.logging import get_trace_id

#: headers under which trace context travels (request and response)
TRACE_ID_HEADER = "X-Pio-Trace-Id"
PARENT_SPAN_HEADER = "X-Pio-Parent-Span"

#: hostile-header bound: ids longer than this are truncated/dropped so one
#: crafted request cannot bloat every fragment it touches
_ID_MAX = 64

#: span-id generator: seeded once from the OS, then pure userspace.
#: secrets.token_hex would cost an os.urandom syscall PER SPAN on the
#: serving hot path — and a syscall releases the GIL mid-submission, which
#: measurably breaks MicroBatcher wave coalescing under concurrency.  Span
#: ids need per-process uniqueness, not cryptographic strength.
_rand = random.Random(secrets.randbits(64) ^ (os.getpid() << 16))


def new_span_id() -> str:
    """Mint a 16-hex span id (the W3C parent-id width)."""
    return f"{_rand.getrandbits(64):016x}"


#: the caller's span id adopted from X-Pio-Parent-Span — what this
#: process's ROOT spans parent to (None = this process starts the trace)
_parent_span_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pio_parent_span", default=None
)


#: whether this context's finished root spans and wave events become
#: cross-process fragments.  The front ends clear it for a request whose
#: caller sent no ``X-Pio-Trace-Id``: no other process assembles that trace
#: (the port has no ``pio trace``), and collecting it was the largest
#: per-request cost of the layer on the solo path
_fragments_var: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "pio_trace_fragments", default=True
)


def bind_fragments(on: bool) -> contextvars.Token:
    return _fragments_var.set(on)


def reset_fragments(token: contextvars.Token) -> None:
    _fragments_var.reset(token)


def fragments_wanted() -> bool:
    return _fragments_var.get()


def _header(headers: Mapping[str, str] | None, name: str) -> str:
    """Case-tolerant header lookup (email.Message, lower-cased dicts, and
    plain test dicts) — local so httpd can import this module."""
    if not headers:
        return ""
    return headers.get(name) or headers.get(name.lower()) or ""


def adopt_trace_context(
    headers: Mapping[str, str] | None, request_id: str
) -> tuple[str, str | None]:
    """The front-end half of propagation: ``(trace_id, parent_span_id)``
    from the incoming headers.  A request without a trace header starts a
    new trace under its request id (so trace id == request id for edge
    requests, and every request is traceable without opt-in)."""
    tid = _header(headers, TRACE_ID_HEADER).strip() or request_id
    if len(tid) > _ID_MAX:
        tid = tid[:_ID_MAX]
    parent = _header(headers, PARENT_SPAN_HEADER).strip() or None
    if parent and len(parent) > _ID_MAX:
        parent = None
    return tid, parent


def bind_parent_span(parent: str | None) -> contextvars.Token:
    return _parent_span_var.set(parent)


def reset_parent_span(token: contextvars.Token) -> None:
    _parent_span_var.reset(token)


def get_parent_span() -> str | None:
    return _parent_span_var.get()


def current_trace_context() -> tuple[str | None, str | None]:
    """(trace_id, span-id-to-parent-under) of the current context: the
    innermost open span when there is one, else the adopted parent.  What
    the MicroBatcher captures at submit so the wave worker can re-bind it."""
    tid = get_trace_id()
    if tid is None:
        return None, None
    from predictionio_tpu_torch.obs.tracing import current_span

    sp = current_span()
    sid = getattr(sp, "span_id", None) or _parent_span_var.get()
    return tid, sid


# ---------------------------------------------------------------------------
# process identity

_process_name: str | None = None
_process_lock = threading.Lock()


def set_process_name(name: str, overwrite: bool = False) -> None:
    """Name this process's fragments (first server wins: a `pio deploy`
    with an embedded event server stays "predictionserver")."""
    global _process_name
    with _process_lock:
        if _process_name is None or overwrite:
            _process_name = name


def process_label() -> str:
    """``name:pid`` — what distinguishes fragment sets in the assembler."""
    return f"{_process_name or 'pio'}:{os.getpid()}"


# ---------------------------------------------------------------------------
# fragment store


class FragmentStore:
    """Bounded per-process store of finished span fragments, by trace id.

    LRU over traces (newest-touched kept) with a per-trace span cap, so a
    hot serving process holds the last ~``max_traces`` requests' fragments
    in constant memory.  ``snapshot(trace_id=...)`` is the
    ``GET /spans.json`` body the cross-process assembler fetches.
    """

    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 512):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        # every finished traced root span collects here; metered so a
        # /spans.json scrape stalling the serving path is attributable
        self._lock = ContendedLock("fragment_store")
        self._traces: OrderedDict[str, list[dict[str, Any]]] = OrderedDict()

    def add(self, trace_id: str, fragment: dict[str, Any]) -> None:
        self.add_many(trace_id, (fragment,))

    def add_many(
        self, trace_id: str, fragments: Any
    ) -> None:
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                spans = self._traces[trace_id] = []
            else:
                self._traces.move_to_end(trace_id)
            for f in fragments:
                if len(spans) >= self.max_spans_per_trace:
                    break
                spans.append(f)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def fragments(self, trace_id: str) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> list[str]:
        """Known trace ids, newest-touched first."""
        with self._lock:
            return list(reversed(self._traces))

    def snapshot(
        self, trace_id: str | None = None, limit: int = 50
    ) -> dict[str, Any]:
        """The ``/spans.json`` body: process identity + wall clock (the
        assembler's coarse alignment hint) + either one trace's fragments
        or a listing of known trace ids."""
        body: dict[str, Any] = {
            "process": process_label(),
            "pid": os.getpid(),
            "now": round(time.time(), 6),
        }
        if trace_id is not None:
            body["trace_id"] = trace_id
            body["spans"] = self.fragments(trace_id)
        else:
            with self._lock:
                ids = list(reversed(self._traces))
                body["traces"] = {
                    tid: len(self._traces[tid])
                    for tid in ids[: max(limit, 0)]
                }
        return body

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


#: process-default store (tests may hold their own for isolation)
FRAGMENTS = FragmentStore()


def collect(root_span: Any, store: FragmentStore | None = None) -> None:
    """Flatten one finished ROOT span tree into fragments.

    Called by ``tracing.trace.__exit__`` for roots that carry a trace id;
    children parent to their tree parent's span id, the root to the
    cross-process parent adopted from ``X-Pio-Parent-Span``."""
    tid = getattr(root_span, "trace_id", None)
    if not tid:
        return
    proc = process_label()
    out: list[dict[str, Any]] = []
    stack: list[tuple[Any, str | None]] = [
        (root_span, getattr(root_span, "parent_id", None))
    ]
    while stack:
        s, parent = stack.pop()
        frag: dict[str, Any] = {
            "trace_id": tid,
            "span_id": s.span_id,
            "name": s.name,
            "process": proc,
            "start_ts": round(s.start_ts, 6),
            "duration_s": round(s.duration_s, 9),
        }
        if parent:
            frag["parent_id"] = parent
        if s.request_id:
            frag["request_id"] = s.request_id
        if s.tags:
            frag["tags"] = dict(s.tags)
        if s.error:
            frag["error"] = s.error
        out.append(frag)
        for c in s.children:
            stack.append((c, s.span_id))
    (store or FRAGMENTS).add_many(tid, out)


def _fragment(
    tid: str,
    name: str,
    start_ts: float,
    duration_s: float,
    process: str,
    parent_id: str | None = None,
    span_id: str | None = None,
    track: str | None = None,
    tags: Mapping[str, Any] | None = None,
    error: str | None = None,
) -> dict[str, Any]:
    """One fragment record (the shape ``collect`` gives a span)."""
    frag: dict[str, Any] = {
        "trace_id": tid,
        "span_id": span_id or new_span_id(),
        "name": name,
        "process": process,
        "start_ts": round(float(start_ts), 6),
        "duration_s": round(float(duration_s), 9),
    }
    if parent_id:
        frag["parent_id"] = parent_id
    if track:
        frag["track"] = track
    if tags:
        frag["tags"] = {k: v for k, v in tags.items() if v is not None}
    if error:
        frag["error"] = error
    return frag


def record_fragment(
    name: str,
    start_ts: float,
    duration_s: float,
    *,
    trace_id: str | None = None,
    parent_id: str | None = None,
    span_id: str | None = None,
    track: str | None = None,
    tags: Mapping[str, Any] | None = None,
    error: str | None = None,
    store: FragmentStore | None = None,
) -> dict[str, Any] | None:
    """Record a synthetic fragment (device-stage events, training
    iterations, a test client's root) outside any span tree.  ``track``
    names the timeline lane the Perfetto export puts it on (default: the
    process's span lane).  No-op without a trace id."""
    tid = trace_id or get_trace_id()
    if not tid:
        return None
    frag = _fragment(tid, name, start_ts, duration_s, process_label(),
                     parent_id, span_id, track, tags, error)
    (store or FRAGMENTS).add(tid, frag)
    return frag


#: the order the wave stages execute in (the 4-way device_s split) —
#: durations are measured per stage; the timeline lays them end to end
_WAVE_STAGE_ORDER = ("host_gather", "h2d", "compute", "d2h")


def note_wave_events(
    meta: Mapping[str, Any] | None,
    parent: Any = None,
    store: FragmentStore | None = None,
) -> None:
    """Turn one MicroBatcher wave's per-item meta into device-track
    fragments: the stage breakdown laid end to end from the wave's
    dispatch timestamp (stages are measured as durations; the end-to-end
    layout reflects their execution order, not sub-stage gaps).  Called by
    the serving handler after the wave resolves, inside the request context
    so the fragments key to the request's trace.  (The JAX package adds
    one per-shard settle event per device of a sharded wave; the port
    serves on one device.)"""
    if not meta:
        return
    t0 = meta.get("wave_t0")
    if t0 is None or get_trace_id() is None or not fragments_wanted():
        return
    try:
        _emit_wave_events(meta, parent, store, t0)
    except Exception:
        pass  # telemetry must never fail the request that asked for it


def _emit_wave_events(
    meta: Mapping[str, Any],
    parent: Any,
    store: FragmentStore | None,
    t0: float,
) -> None:
    """The wave's fragments, built and stored in one ``add_many`` (a wave
    answers every one of its requests: one store update each, not one per
    stage)."""
    tid = get_trace_id()
    proc = process_label()
    parent_id = getattr(parent, "span_id", None)
    device = str(meta.get("wave_device") or "host")
    wave_tags = {
        "wave_seq": meta.get("wave_seq"),
        "wave_size": meta.get("wave_size"),
    }
    breakdown = meta.get("device_breakdown") or {}
    frags: list[dict[str, Any]] = []
    cursor = float(t0)
    for stage in _WAVE_STAGE_ORDER:
        dur = float(breakdown.get(stage) or 0.0)
        if dur <= 0.0:
            continue
        frags.append(_fragment(
            tid, f"wave.{stage}", cursor, dur, proc, parent_id,
            track=f"device:{device}",
            tags={**wave_tags, "device": device, "stage": stage},
        ))
        cursor += dur
    other = float(breakdown.get("other") or 0.0)
    if other > 0.0 and cursor == float(t0):
        # an engine that marks no stages still gets ONE device event so
        # the timeline shows where device_s went
        frags.append(_fragment(
            tid, "wave.device", cursor, other, proc, parent_id,
            track=f"device:{device}", tags={**wave_tags, "device": device},
        ))
    if frags:
        (store or FRAGMENTS).add_many(tid, frags)
