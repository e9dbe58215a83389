"""Admission control: a per-server in-flight cap.

Unbounded concurrency is how overload becomes collapse: every accepted
request adds queueing delay for all of them until everything times out at
once.  An :class:`AdmissionController` bounds in-flight (non-probe)
requests; past the cap the front ends answer ``503 + Retry-After``
immediately — cheap to produce, honest to the client, and the admitted
requests keep their latency.

``try_acquire``/``release`` are O(1) under one lock; the in-flight count
is exported as ``pio_inflight_requests`` and sheds as
``pio_shed_total{reason="inflight"}``.
"""

from __future__ import annotations

import threading

from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry


def shed_counter(registry: MetricsRegistry | None = None):
    """The one shed counter family shared by every shedding site (the
    admission cap, the micro-batch queue bound), labeled by reason."""
    return (registry or REGISTRY).counter(
        "pio_shed_total",
        "Requests shed with 503 + Retry-After instead of queuing, by reason",
        labelnames=("reason",),
    )


class AdmissionController:
    """Bounded in-flight request counter for one server."""

    def __init__(
        self,
        max_inflight: int,
        retry_after_s: float = 1.0,
        registry: MetricsRegistry | None = None,
        reason: str = "inflight",
    ):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s
        reg = registry or REGISTRY
        self._lock = threading.Lock()
        self._inflight = 0
        self._m_inflight = reg.gauge(
            "pio_inflight_requests",
            "Requests currently admitted and executing, by admission gate",
            labelnames=("reason",),
        ).labels(reason)
        self._m_shed = shed_counter(reg).labels(reason)

    def try_acquire(self) -> bool:
        with self._lock:
            if self._inflight >= self.max_inflight:
                self._m_shed.inc()
                return False
            self._inflight += 1
            self._m_inflight.set(self._inflight)
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)
            self._m_inflight.set(self._inflight)

    @property
    def inflight(self) -> int:
        return self._inflight
