"""Rolling-window SLO tracking with burn-rate computation.

Feeds the pager-facing surface: ``GET /healthz`` (process liveness, always
ungated so load balancers can probe), ``GET /readyz`` (dependency checks —
model loaded, batcher not draining, stores reachable), and ``GET /slo.json``
(availability + latency objectives over a rolling window, with burn rates).

Burn rate is the SRE-workbook number: observed bad-fraction divided by the
error budget (1 - target).  1.0 means the budget burns exactly as fast as it
accrues; a sustained rate above 1 means the objective will be missed — the
tracker flags the window "degraded" past :data:`DEGRADED_BURN_RATE`.

The window is a ring of coarse time buckets (default 60 × 10 s): ``record``
is O(1) under one lock, ``snapshot`` sums at most ``len(ring)`` buckets, and
idle buckets age out without a background thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Mapping

#: a window is "degraded" when either burn rate crosses this
DEGRADED_BURN_RATE = 1.0

#: SLO-breach exemplars retained (newest evict oldest)
EXEMPLAR_CAPACITY = 16


def _now() -> float:
    """Monotonic clock — module-level so tests can freeze it."""
    return time.monotonic()


class SLOTracker:
    """Availability + latency SLO over a rolling bucketed window.

    - availability objective: fraction of requests answering below 500
      must be >= ``availability_target``;
    - latency objective: fraction of requests faster than
      ``latency_threshold_s`` must be >= ``latency_target``.
    """

    def __init__(
        self,
        window_s: float = 600.0,
        bucket_s: float = 10.0,
        availability_target: float = 0.999,
        latency_threshold_s: float = 0.5,
        latency_target: float = 0.99,
    ):
        if window_s < bucket_s:
            raise ValueError("window_s must cover at least one bucket")
        self.window_s = float(window_s)
        self.bucket_s = float(bucket_s)
        self.availability_target = availability_target
        self.latency_threshold_s = latency_threshold_s
        self.latency_target = latency_target
        self._lock = threading.Lock()
        n = int(window_s / bucket_s)
        #: ring of [bucket_index, total, errors, slow]
        self._buckets: list[list[float]] = [[-1, 0, 0, 0] for _ in range(n)]
        #: trace-id exemplars of recent SLO-breaching requests — the jump
        #: from "p99 moved" straight to ONE assembled cross-process trace
        self._exemplars: deque[dict[str, Any]] = deque(
            maxlen=EXEMPLAR_CAPACITY
        )
        self._started = _now()

    def record(
        self,
        ok: bool,
        duration_s: float,
        trace_id: str | None = None,
        request_id: str | None = None,
    ) -> None:
        idx = int(_now() / self.bucket_s)
        slot = self._buckets[idx % len(self._buckets)]
        slow = duration_s > self.latency_threshold_s
        with self._lock:
            if slot[0] != idx:  # ring slot holds an expired window: reset
                slot[0], slot[1], slot[2], slot[3] = idx, 0, 0, 0
            slot[1] += 1
            if not ok:
                slot[2] += 1
            if slow:
                slot[3] += 1
            if trace_id and (slow or not ok):
                exemplar = {
                    "trace_id": trace_id,
                    "reason": "error" if not ok else "slow",
                    "duration_s": round(duration_s, 6),
                    "ts": round(time.time(), 3),
                }
                if request_id:
                    # the join key incident bundles use to embed the
                    # breaching answers' provenance records
                    exemplar["request_id"] = request_id
                self._exemplars.append(exemplar)

    def _window_counts(self) -> tuple[int, int, int]:
        horizon = int(_now() / self.bucket_s) - len(self._buckets)
        total = errors = slow = 0
        with self._lock:
            for idx, t, e, s in self._buckets:
                if idx > horizon:
                    total += int(t)
                    errors += int(e)
                    slow += int(s)
        return total, errors, slow

    @staticmethod
    def _burn_rate(bad: int, total: int, target: float) -> float:
        if total == 0:
            return 0.0
        budget = 1.0 - target
        if budget <= 0:
            return float("inf") if bad else 0.0
        return (bad / total) / budget

    def snapshot(self) -> dict[str, Any]:
        total, errors, slow = self._window_counts()
        availability = 1.0 if total == 0 else 1.0 - errors / total
        latency_ok = 1.0 if total == 0 else 1.0 - slow / total
        error_burn = self._burn_rate(errors, total, self.availability_target)
        latency_burn = self._burn_rate(slow, total, self.latency_target)
        degraded = max(error_burn, latency_burn) > DEGRADED_BURN_RATE
        with self._lock:
            exemplars = list(self._exemplars)[::-1]
        return {
            "exemplars": exemplars,
            "window_s": self.window_s,
            "requests": total,
            "errors": errors,
            "slow_requests": slow,
            "availability": round(availability, 6),
            "availability_target": self.availability_target,
            "latency_threshold_s": self.latency_threshold_s,
            "latency_ok_ratio": round(latency_ok, 6),
            "latency_target": self.latency_target,
            "error_burn_rate": round(error_burn, 4),
            "latency_burn_rate": round(latency_burn, 4),
            "status": "degraded" if degraded else "ok",
            "uptime_s": round(_now() - self._started, 3),
        }

    def healthz(self) -> dict[str, Any]:
        """Liveness: the process answers, full stop.  SLO state rides along
        as an advisory field but never flips liveness — restart loops from
        a burning error budget would only make the outage worse."""
        return {
            "status": "alive",
            "uptime_s": round(_now() - self._started, 3),
            "slo_status": self.snapshot()["status"],
        }


def run_readiness(
    checks: Mapping[str, Callable[[], bool]]
) -> tuple[bool, dict[str, bool]]:
    """Evaluate readiness checks; a raising check counts as not ready."""
    results: dict[str, bool] = {}
    for name, fn in checks.items():
        try:
            results[name] = bool(fn())
        except Exception:
            results[name] = False
    return all(results.values()), results
