"""Circuit breakers: fail fast when a dependency is down.

The JAX package's ``resilience/breaker.py``, copied, on the port's metrics
registry.

Per-endpoint closed→open→half-open state machine (the Nygard pattern).
Closed counts consecutive failures; at ``failure_threshold`` it opens and
every call is rejected in ~0 ms (a :class:`CircuitOpen` with a
``retry_after_s`` hint) instead of paying a connect timeout.  After
``reset_timeout_s`` the breaker half-opens and admits ``half_open_max``
trial calls; one success closes it, one failure re-opens it and restarts
the clock.

State is exported as a ``pio_breaker_state{endpoint=...}`` gauge
(0 = closed, 1 = half-open, 2 = open) on the process registry, folded into
``/readyz`` (prediction server), ``/slo.json``, and ``pio status --url``.

``_now`` is module-level so tests drive transitions with a frozen clock
instead of real sleeps.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from predictionio_tpu_torch.obs.metrics import REGISTRY

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"

#: gauge encoding of the states (ordered by "how broken")
BREAKER_STATES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _now() -> float:
    """Monotonic clock — module-level so tests can freeze it."""
    return time.monotonic()


class CircuitOpen(Exception):
    """Call rejected because the breaker is open (or half-open with its
    trial slots taken).  ``retry_after_s`` hints when to try again."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """One endpoint's breaker.  Thread-safe: every transition happens
    inline under one lock (and is mirrored to the state gauge, which locks
    internally)."""

    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        reset_timeout_s: float = 5.0,
        half_open_max: int = 1,
        registry=None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = half_open_max
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._trials = 0  # in-flight trial calls while half-open
        self._opened_total = 0
        reg = registry or REGISTRY
        self._gauge = reg.gauge(
            "pio_breaker_state",
            "Circuit breaker state by endpoint (0 closed, 1 half-open, 2 open)",
            labelnames=("endpoint",),
        ).labels(name)
        self._m_rejected = reg.counter(
            "pio_breaker_rejected_total",
            "Calls rejected in ~0 ms because the breaker was not closed",
            labelnames=("endpoint",),
        ).labels(name)
        self._gauge.set(BREAKER_STATES[CLOSED])

    def allow(self) -> bool:
        """True when a call may proceed.  Half-open trial slots are
        consumed here and released by record_success/record_failure."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if _now() - self._opened_at < self.reset_timeout_s:
                    self._m_rejected.inc()
                    return False
                self._state = HALF_OPEN
                self._trials = 0
                self._gauge.set(BREAKER_STATES[HALF_OPEN])
            # HALF_OPEN: admit up to half_open_max concurrent trials
            if self._trials < self.half_open_max:
                self._trials += 1
                return True
            self._m_rejected.inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == HALF_OPEN:
                self._trials = max(self._trials - 1, 0)
                self._state = CLOSED
                self._gauge.set(BREAKER_STATES[CLOSED])

    def reset(self) -> None:
        """Force-close on out-of-band positive proof of health (the fleet
        prober's successful /readyz probe): the reset window exists to
        pace blind retries, not to overrule an actual observed answer —
        without this a revived replica can sit unroutable (breaker open)
        while its /readyz already says ready."""
        with self._lock:
            self._failures = 0
            self._trials = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._gauge.set(BREAKER_STATES[CLOSED])

    def release_trial(self) -> None:
        """A half-open trial ended with neither a success nor an endpoint
        failure (e.g. the caller's deadline ran out mid-call): free the
        slot so recovery probing can continue.  Without this, an abandoned
        trial would wedge the breaker half-open with no slots forever."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._trials = max(self._trials - 1, 0)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the trial failed: straight back to open, clock restarts
                self._trials = max(self._trials - 1, 0)
                self._opened_at = _now()
                self._opened_total += 1
                self._state = OPEN
                self._gauge.set(BREAKER_STATES[OPEN])
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._opened_at = _now()
                self._opened_total += 1
                self._state = OPEN
                self._gauge.set(BREAKER_STATES[OPEN])

    def guard(self, what: str = "call") -> None:
        """Raise :class:`CircuitOpen` when the breaker rejects the call."""
        if not self.allow():
            retry_after = self.retry_after_s()
            raise CircuitOpen(
                f"{what} rejected: circuit {self.name!r} is {self.state} "
                f"(retry in ~{retry_after:.1f}s)",
                retry_after_s=retry_after,
            )

    # -- introspection -------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            # an expired open window *reads* as half-open so /readyz and
            # pio status report recoverability without waiting for traffic
            if (
                self._state == OPEN
                and _now() - self._opened_at >= self.reset_timeout_s
            ):
                return HALF_OPEN
            return self._state

    def retry_after_s(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(self.reset_timeout_s - (_now() - self._opened_at), 0.0)

    def snapshot(self) -> dict[str, Any]:
        state = self.state
        with self._lock:
            return {
                "state": state,
                "failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
                "opened_total": self._opened_total,
            }


#: process-wide breakers by endpoint name, so every RemoteClient pointed at
#: the same daemon shares one view of its health
_BREAKERS: dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = threading.Lock()


def get_breaker(name: str, **kwargs: Any) -> CircuitBreaker:
    """Get-or-create the process-wide breaker for ``name``.  First creation
    fixes the parameters; later callers share the instance."""
    with _BREAKERS_LOCK:
        br = _BREAKERS.get(name)
        if br is None:
            br = CircuitBreaker(name, **kwargs)
            _BREAKERS[name] = br
        return br


def breaker_states() -> dict[str, dict[str, Any]]:
    """Snapshot of every registered breaker (for /slo.json + pio status)."""
    with _BREAKERS_LOCK:
        items = list(_BREAKERS.items())
    return {name: br.snapshot() for name, br in items}


def reset_breakers() -> None:
    """Drop all registered breakers (test isolation)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()
