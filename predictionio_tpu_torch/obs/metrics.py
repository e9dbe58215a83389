"""Dependency-free metrics registry.

The JAX package's ``obs/metrics.py`` families: thread-safe ``Counter`` /
``Gauge`` / ``Histogram`` children keyed by label values, collected in a
``MetricsRegistry``.  The serving front end records into it under the JAX
package's names (``pio_microbatch_*``, ``pio_shed_total``,
``pio_inflight_requests``, ``pio_request_latency_seconds``,
``pio_degraded_total``, ``pio_factor_cache_*``).  The
exposition routes (``/metrics``, ``/metrics.json``), the scrape history and
lock-wait metering come with the port's observability slice.

Histograms are log-bucketed over FIXED boundaries (``LATENCY_BUCKETS``,
10 µs – 10 s, four buckets per decade); size-shaped quantities (batch
sizes, queue depths) use the power-of-two ``SIZE_BUCKETS``.  A family's
buckets are fixed at creation so every child shares them.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any

#: Fixed log-spaced bucket upper bounds in seconds: 10 µs .. 10 s, four per
#: decade.  Shared by every latency histogram.
LATENCY_BUCKETS: tuple[float, ...] = tuple(
    round(10.0 ** (e + f / 4.0), 12) for e in range(-5, 1) for f in range(4)
) + (10.0,)

#: Power-of-two bounds for size-shaped histograms (batch size, queue depth).
SIZE_BUCKETS: tuple[float, ...] = tuple(float(2**i) for i in range(13))


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value that can go up and down."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative log-bucketed histogram over fixed bounds: ``counts[i]``
    counts observations ``<= bounds[i]``; the final slot is +Inf."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: tuple[float, ...] = LATENCY_BUCKETS):
        self._lock = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum


_KINDS = {"counter": Counter, "gauge": Gauge}


class MetricFamily:
    """One named metric with a fixed label schema and per-label children."""

    def __init__(
        self,
        kind: str,
        name: str,
        help: str,
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
    ):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def labels(self, *values: Any) -> Any:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {key}"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = (
                    Histogram(self.buckets)
                    if self.kind == "histogram"
                    else _KINDS[self.kind]()
                )
                self._children[key] = child
        return child


class MetricsRegistry:
    """Thread-safe name -> :class:`MetricFamily` registry.  Re-declaring a
    family with the same (kind, labelnames, buckets) returns the existing
    one, so call sites declare their metrics where they are built."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, MetricFamily] = {}

    def _family(
        self,
        kind: str,
        name: str,
        help: str,
        labelnames: tuple[str, ...],
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
    ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not {kind}{labelnames}"
                    )
                if kind == "histogram" and fam.buckets != buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets"
                    )
                return fam
            fam = MetricFamily(kind, name, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str = "", labelnames: tuple[str, ...] = ()
    ):
        fam = self._family("counter", name, help, tuple(labelnames))
        return fam if fam.labelnames else fam.labels()

    def gauge(
        self, name: str, help: str = "", labelnames: tuple[str, ...] = ()
    ):
        fam = self._family("gauge", name, help, tuple(labelnames))
        return fam if fam.labelnames else fam.labels()

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
    ):
        fam = self._family(
            "histogram", name, help, tuple(labelnames), tuple(buckets)
        )
        return fam if fam.labelnames else fam.labels()

    def get(self, name: str) -> MetricFamily | None:
        with self._lock:
            return self._families.get(name)


#: Process-global default registry — what servers and the MicroBatcher
#: record into unless handed an explicit registry.
REGISTRY = MetricsRegistry()
