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
histogram); the second-scale stages use recorded spans: ``pio train``'s
``workflow.run_train`` root over ``train.datasource.read``,
``train.preparator.prepare``, ``train.algorithm.<name>`` and
``train.persist.save_models`` (the JAX package's names; ``run_train`` logs
the root's breakdown), ``pio eval``'s ``eval.*`` stages, kernel builds and
the remote storage's round trips.  The JAX package's ``obs/tracing.py``;
its compile listener becomes :func:`observe_kernel_build`.

**Capture.**  While a capture is on, every span (and every wave stage of
``obs/device.py``, as ``wave.<stage>``) also opens a profiler range under
its name (:func:`open_range`), so a profile's host timeline names the
program's stages, and adds its host seconds to the capture store
(:func:`capture_totals`).  :class:`device_span` adds the
device time of its block: a CUDA-event pair on the current stream, read
when the totals are read; the host span on the CPU.  A capture is on in a
thread that ``torch.profiler`` records (``torch.autograd.
_profiler_enabled()``), and in every thread inside :func:`process_capture`
(``POST /debug/profile``, whose profiler runs on a thread of its own).
With no capture a span costs one check more than its timing: no range, no
event, no store update.  torch is read only when it is already imported.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
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

    __slots__ = ("span", "_registry", "_record", "_ring", "_range")

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
        self._range = _OFF

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
        if capturing():
            self._range = open_range(span.name)
        span.start_ts = time.time()
        span.start_s = time.perf_counter()
        return span

    def __exit__(self, exc_type, exc, tb) -> None:
        self.span.duration_s = time.perf_counter() - self.span.start_s
        if self._range is not _OFF:
            close_range(self._range, self.span.name, self.span.duration_s)
            self._range = _OFF
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


# ---------------------------------------------------------------------------
# capture: profiler ranges and per-name totals while a capture is on

#: a span opened outside any capture
_OFF = object()

#: captures in flight that hold every thread on (process_capture)
_process_captures = 0
#: ``torch.autograd._profiler_enabled``, bound once torch is imported
_profiler_enabled = None

_capture_lock = threading.Lock()
#: name -> [host seconds, count, device seconds]
_totals: dict[str, list] = {}
#: device spans whose CUDA events are not read yet: (name, start, end)
_pending: deque[tuple] = deque()
#: most device spans held unread; past it the oldest are waited for
MAX_PENDING = 4096


def capturing() -> bool:
    """Whether spans opened in this thread now are captured: a
    ``torch.profiler`` capture records the thread, or a
    :func:`process_capture` is in flight."""
    global _profiler_enabled
    if _process_captures:
        return True
    fn = _profiler_enabled
    if fn is None:
        torch = sys.modules.get("torch")
        fn = getattr(getattr(torch, "autograd", None), "_profiler_enabled", None)
        if fn is None:
            return False
        _profiler_enabled = fn
    return fn()


@contextlib.contextmanager
def process_capture():
    """Capture the spans of every thread for the block (a profiler started
    on one thread sees no other thread's ``_profiler_enabled``)."""
    global _process_captures
    with _capture_lock:
        _process_captures += 1
    try:
        yield
    finally:
        with _capture_lock:
            _process_captures -= 1


def open_range(name: str):
    """Open a profiler range named ``name`` (None when torch is not
    imported or has no such range); close it with :func:`close_range`.

    The range is a function-scope record (``_RecordFunctionFast``), not
    ``torch.profiler.record_function``: the profiler keeps it as a host
    operation like an aten op, where it projects a ``record_function``
    user annotation onto the device timeline as a device operation of the
    range's name, which would count the range's kernels twice in any sum
    of the device's operations.  It also costs a tenth as much."""
    fast = getattr(getattr(sys.modules.get("torch"), "_C", None),
                   "_profiler", None)
    fast = getattr(fast, "_RecordFunctionFast", None)
    if fast is None:
        return None
    rng = fast(name)
    rng.__enter__()
    return rng


def close_range(rng, name: str, host_s: float, device_s: float = 0.0) -> None:
    """Close a range of :func:`open_range` and add the span to the totals."""
    if rng is not None:
        rng.__exit__(None, None, None)
    _add(name, host_s, device_s)


def _entry(name: str) -> list:
    """The totals of ``name``; called with the lock held."""
    t = _totals.get(name)
    if t is None:
        t = _totals[name] = [0.0, 0, 0.0]
    return t


def _add(name: str, host_s: float, device_s: float) -> None:
    with _capture_lock:
        t = _entry(name)
        t[0] += host_s
        t[1] += 1
        t[2] += device_s


def _settle(limit: int) -> None:
    """Add the device time of every pending pair whose end has completed,
    then wait for the oldest until at most ``limit`` remain.  Called with
    the lock held."""
    global _pending
    keep: deque[tuple] = deque()
    for item in _pending:
        if item[2].query():
            _entry(item[0])[2] += item[1].elapsed_time(item[2]) / 1e3
        else:
            keep.append(item)
    while len(keep) > limit:
        name, start, end = keep.popleft()
        end.synchronize()
        _entry(name)[2] += start.elapsed_time(end) / 1e3
    _pending = keep


class device_span:
    """Context manager: ``with device_span("ncf.step.forward", device):``.

    Under a capture: a range and the block's host seconds as a span's,
    and its device seconds: on a CUDA ``device`` the time between two
    events recorded on its current stream around the block (read when the
    totals are read, once both have completed), elsewhere the host span.
    Outside a capture it records nothing."""

    __slots__ = ("name", "device", "_range", "_t0", "_events")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self._range = _OFF

    def __enter__(self) -> "device_span":
        if not capturing():
            return self
        self._range = open_range(self.name)
        self._events = None
        if getattr(self.device, "type", None) == "cuda":
            cuda = sys.modules["torch"].cuda
            stream = cuda.current_stream(self.device)
            start = cuda.Event(enable_timing=True)
            start.record(stream)
            self._events = (start, stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._range is _OFF:
            return None
        host_s = time.perf_counter() - self._t0
        if self._events is None:
            close_range(self._range, self.name, host_s, host_s)
        else:
            start, stream = self._events
            end = sys.modules["torch"].cuda.Event(enable_timing=True)
            end.record(stream)
            close_range(self._range, self.name, host_s)
            with _capture_lock:
                _pending.append((self.name, start, end))
                if len(_pending) > MAX_PENDING:
                    _settle(MAX_PENDING // 2)
        self._range = _OFF
        return None


def capture_totals() -> dict[str, dict[str, float]]:
    """Every captured span name's ``host_s``, ``count`` and ``device_s``
    since :func:`clear_capture_totals`.  Device spans whose events have not
    completed yet are left out of ``device_s`` until a later read:
    synchronize the device first for a whole window."""
    with _capture_lock:
        _settle(len(_pending))
        return {
            name: {"host_s": t[0], "count": t[1], "device_s": t[2]}
            for name, t in _totals.items()
        }


def clear_capture_totals() -> None:
    global _pending
    with _capture_lock:
        _totals.clear()
        _pending = deque()
