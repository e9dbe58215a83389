"""Lightweight per-stage spans feeding the metrics registry.

``trace("stage")`` is a context manager that times its block, records the
duration into the ``pio_span_seconds{span="stage"}`` histogram, and builds a
parent/child tree through a context-local span stack — nested ``trace``
blocks become children of the enclosing one.  Finished ROOT spans
additionally land in a bounded ring buffer (:func:`recent_traces`) so "what
did the last train run spend its time on" is answerable without a metrics
backend.

This is deliberately not OpenTelemetry: no export, no sampling — a span is a
(name, duration, children) record and one histogram observation.  Spans DO
carry the contextvar ``request_id`` (obs/logging.py) when one is bound, so a
``/traces.json`` entry correlates with the ``X-Pio-Request-Id`` response
header and the matching ``/logs.json`` lines.  The HTTP front ends open one
cheap unrecorded root span per request (``record=False``: ring only, no
histogram); the second-scale stages — DASE train stages, kernel builds,
batch predict — use recorded spans.  The JAX package's ``obs/tracing.py``;
its compile listener becomes :func:`observe_kernel_build`.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Any

from predictionio_tpu_torch.obs.disttrace import (
    collect as _collect_fragments,
    fragments_wanted,
    get_parent_span,
    new_span_id,
)
from predictionio_tpu_torch.obs.logging import get_request_id, get_trace_id
from predictionio_tpu_torch.obs.metrics import (
    REGISTRY,
    STAGE_BUCKETS,
    TRAIN_BUCKETS,
    MetricsRegistry,
)

#: the span stack is a ContextVar (not a threading.local) so nesting is
#: correct both across threads AND across interleaved asyncio tasks — two
#: concurrent requests on one event loop must not adopt each other's spans
_stack_var: contextvars.ContextVar[list["Span"] | None] = (
    contextvars.ContextVar("pio_span_stack", default=None)
)

#: ring of the most recent finished root spans (as dicts), newest last
_ring: deque[dict[str, Any]] = deque(maxlen=256)
_ring_lock = threading.Lock()


class Span:
    """One timed block.  ``duration_s`` is valid after the block exits."""

    __slots__ = (
        "name", "start_s", "duration_s", "children", "error",
        "request_id", "tags", "span_id", "parent_id", "trace_id",
        "start_ts",
    )

    def __init__(self, name: str):
        self.name = name
        self.start_s = 0.0
        self.duration_s = 0.0
        self.children: list[Span] = []
        self.error: str | None = None
        #: correlation id captured from the request context at entry
        self.request_id: str | None = None
        #: small free-form annotations (route, status, ...) — keep it small;
        #: every root span's dict lands in the trace ring
        self.tags: dict[str, Any] | None = None
        #: distributed-tracing identity (obs/disttrace.py): a per-span id,
        #: the cross-process parent (root spans adopt X-Pio-Parent-Span),
        #: the trace this span belongs to, and a wall-clock start so
        #: fragments from different processes align on one timeline
        self.span_id: str = ""
        self.parent_id: str | None = None
        self.trace_id: str | None = None
        self.start_ts: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "duration_s": round(self.duration_s, 9),
        }
        if self.request_id:
            d["request_id"] = self.request_id
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.tags:
            d.update(self.tags)
        if self.error:
            d["error"] = self.error
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def breakdown(self) -> dict[str, float]:
        """Flat child-name → seconds map (duplicate names accumulate)."""
        out: dict[str, float] = {}
        for c in self.children:
            out[c.name] = out.get(c.name, 0.0) + c.duration_s
        return out


class trace:
    """Context manager: ``with trace("train.prepare") as span: ...``

    ``record=False`` skips the span-duration histogram; ``ring=False``
    keeps a ROOT span out of the recent-traces ring (for high-volume
    infrastructure spans like storage round trips that would otherwise
    evict real request traces from ``/traces.json``) — cross-process
    fragment collection is unaffected by either."""

    __slots__ = ("span", "_registry", "_record", "_ring")

    def __init__(
        self,
        name: str,
        registry: MetricsRegistry | None = None,
        record: bool = True,
        ring: bool = True,
    ):
        self.span = Span(name)
        self._registry = registry or REGISTRY
        self._record = record
        self._ring = ring

    def __enter__(self) -> Span:
        stack = _stack_var.get()
        if stack is None:
            stack = []
            _stack_var.set(stack)
        span = self.span
        span.request_id = get_request_id()
        span.trace_id = get_trace_id()
        span.span_id = new_span_id()
        if not stack:
            # a ROOT span parents to the cross-process caller (the span id
            # adopted from X-Pio-Parent-Span); children parent in-tree
            span.parent_id = get_parent_span()
        stack.append(span)
        span.start_ts = time.time()
        span.start_s = time.perf_counter()
        return span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.duration_s = time.perf_counter() - self.span.start_s
        if exc is not None:
            self.span.error = f"{type(exc).__name__}: {exc}"
        stack = _stack_var.get() or []
        stack.pop()
        if stack:
            stack[-1].children.append(self.span)
        else:
            if self._ring:
                with _ring_lock:
                    _ring.append(self.span.to_dict())
            if self.span.trace_id and fragments_wanted():
                try:
                    # flatten the finished tree into cross-process fragments
                    # (bounded per-process store served at /spans.json)
                    _collect_fragments(self.span)
                except Exception:
                    pass  # telemetry must never break the traced block
        if self._record:
            observe_span(self.span.name, self.span.duration_s, self._registry)
        return None


def current_span() -> Span | None:
    stack = _stack_var.get()
    return stack[-1] if stack else None


def observe_span(
    name: str, seconds: float, registry: MetricsRegistry | None = None
) -> None:
    """Record an externally-timed duration as if it were a span: the
    ``pio_span_seconds{span=name}`` histogram a finished span feeds."""
    (registry or REGISTRY).histogram(
        "pio_span_seconds",
        "Duration of named stages (trace spans)",
        labelnames=("span",),
        buckets=TRAIN_BUCKETS,
    ).labels(name).observe(seconds)


def recent_traces(n: int = 20) -> list[dict[str, Any]]:
    """The most recent finished root spans, newest first."""
    with _ring_lock:
        items = list(_ring)
    return items[::-1][:n]


def clear_traces() -> None:
    with _ring_lock:
        _ring.clear()


def observe_kernel_build(
    source: str, seconds: float, registry: MetricsRegistry | None = None
) -> None:
    """Record one ``nvcc`` build of a kernel source: the port's counterpart
    of the JAX package's compile listener (``install_jax_compile_listener``,
    which forwards XLA compile events).  The build is a compile, so it
    lands under the listener's metric names with ``event="nvcc/<source>"``:
    ``pio_jax_compile_seconds`` and ``pio_jax_compile_total``.  The build as
    a whole is a recorded ``kernel.build`` span (``ops/_kernels.py``)."""
    reg = registry or REGISTRY
    event = f"nvcc/{source}"
    reg.histogram(
        "pio_jax_compile_seconds",
        "Compile time by compile event (nvcc/<source>: one kernel build)",
        labelnames=("event",),
        buckets=STAGE_BUCKETS,
    ).labels(event).observe(seconds)
    reg.counter(
        "pio_jax_compile_total",
        "Compile events by event name (nvcc/<source>: one kernel build)",
        labelnames=("event",),
    ).labels(event).inc()
