"""Canary rollout: deterministic traffic split, guardrails, and the
promote-or-rollback decision.

The JAX package's ``lifecycle/canary.py``, whole: the same split (10,000
buckets of :func:`~predictionio_tpu_torch.data.storage.base.entity_shard`
under ``"pio_canary"``), the same guardrails and verdicts, so one user
lands on the same side and one set of stats gives the same decision in
either package.

A staged generation serves a fixed *entity-hash fraction* of traffic: the
query's joinable entity id (the same field the quality joiner keys on)
hashes through ``entity_shard``, so one user consistently lands on one side of the split — their feedback
events join back to the variant that actually served them, and repeated
flips cannot bounce a user between models mid-session.  Queries with no
entity id always serve live (the safe default: they cannot be joined, so
they cannot inform the decision either).

Guardrails (checked by :meth:`CanaryDecider.evaluate`):

- **auto-abort** — once the canary has ``min_requests`` answers, an error
  rate above ``max_error_rate`` or a p95 latency beyond
  ``latency_ratio`` x the live p95 rolls it back immediately;
- **promotion** — only after ``min_joined`` feedback events joined to the
  canary variant show its online metric within ``max_metric_regression``
  of live does the canary promote; a canary that cannot gather evidence
  inside ``max_canary_s`` rolls back (fail-safe: the burden of proof is on
  the NEW model).

Everything is clock-injected so tests run it on a frozen clock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

from predictionio_tpu_torch.data.storage.base import entity_shard

#: hash-space granularity of the traffic split (0.01% steps)
_SPLIT_BUCKETS = 10_000

#: variant label canary predictions are logged under in the QualityMonitor
CANARY_VARIANT = "canary"


def in_canary_fraction(entity: str | None, fraction: float) -> bool:
    """Deterministic split: the same entity id always lands on the same
    side for a given fraction.  No entity -> live."""
    if not entity or fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    bucket = entity_shard("pio_canary", str(entity), _SPLIT_BUCKETS)
    return bucket < int(fraction * _SPLIT_BUCKETS)


@dataclass(frozen=True)
class CanaryPolicy:
    """Rollout knobs (``LifecyclePolicy.from_env`` reads them from
    ``PIO_CANARY_*``)."""

    #: entity-hash fraction of traffic the canary serves
    fraction: float = 0.1
    #: answers required before the error/latency guardrails judge
    min_requests: int = 50
    #: 5xx fraction that aborts the canary outright
    max_error_rate: float = 0.05
    #: canary p95 may be at most this multiple of the live p95
    latency_ratio: float = 3.0
    #: joined feedback samples required before promotion
    min_joined: int = 20
    #: online metric compared between variants
    metric: str = "hit_rate"
    #: allowed fractional drop of the canary metric vs live
    max_metric_regression: float = 0.10
    #: canary lifetime bound; undecided past this -> rollback (fail-safe)
    max_canary_s: float = 3600.0


class VariantStats:
    """Per-variant request counters + a bounded latency reservoir."""

    __slots__ = ("requests", "errors", "_lat", "_cap")

    def __init__(self, cap: int = 1024):
        self.requests = 0
        self.errors = 0
        self._lat: list[float] = []
        self._cap = cap

    def observe(self, status: int, seconds: float) -> None:
        self.requests += 1
        if status >= 500:
            self.errors += 1
        if len(self._lat) >= self._cap:
            # overwrite round-robin: O(1), keeps a rolling window
            self._lat[self.requests % self._cap] = seconds
        else:
            self._lat.append(seconds)

    def error_rate(self) -> float:
        return self.errors / self.requests if self.requests else 0.0

    def p95(self) -> float | None:
        if not self._lat:
            return None
        ordered = sorted(self._lat)
        return ordered[min(int(0.95 * len(ordered)), len(ordered) - 1)]

    def to_dict(self) -> dict[str, Any]:
        p95 = self.p95()
        return {
            "requests": self.requests,
            "errors": self.errors,
            "error_rate": round(self.error_rate(), 6),
            "p95_s": round(p95, 6) if p95 is not None else None,
        }


class CanaryTracker:
    """Live + canary request stats for ONE rollout attempt.

    The serving handlers call :meth:`observe` per answer (a few counter
    bumps under one lock); the controller reads the aggregate.  ``reset``
    starts a fresh attempt so a new canary never inherits the error budget
    of the previous one.
    """

    def __init__(self, clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._live = VariantStats()
        self._canary = VariantStats()
        self.started_at: float | None = None

    def start(self) -> None:
        with self._lock:
            self._live = VariantStats()
            self._canary = VariantStats()
            self.started_at = self._clock()

    def stop(self) -> None:
        with self._lock:
            self.started_at = None

    def observe(self, is_canary: bool, status: int, seconds: float) -> None:
        with self._lock:
            (self._canary if is_canary else self._live).observe(
                status, seconds
            )

    def age_s(self) -> float | None:
        with self._lock:
            if self.started_at is None:
                return None
            return self._clock() - self.started_at

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "started_at": self.started_at,
                "live": self._live.to_dict(),
                "canary": self._canary.to_dict(),
            }


#: evaluate() verdicts
CONTINUE, PROMOTE, ROLLBACK = "continue", "promote", "rollback"


class CanaryDecider:
    """The promote-or-rollback judgment, pure function of the stats."""

    def __init__(self, policy: CanaryPolicy):
        self.policy = policy

    def evaluate(
        self,
        tracker_snapshot: dict[str, Any],
        quality_comparison: dict[str, Any] | None,
        age_s: float | None,
    ) -> tuple[str, str]:
        """Returns ``(verdict, reason)``.

        ``quality_comparison`` is
        :meth:`QualityMonitor.compare_variants` output (live/canary metric
        values + the canary joined count), or None when no monitor feeds
        the rollout.
        """
        p = self.policy
        canary = tracker_snapshot["canary"]
        live = tracker_snapshot["live"]
        # guardrail 1: error-rate burn, judged as soon as the sample is big
        # enough to mean something
        if canary["requests"] >= p.min_requests:
            if canary["error_rate"] > p.max_error_rate:
                return ROLLBACK, (
                    f"canary error rate {canary['error_rate']:.3f} exceeds "
                    f"guardrail {p.max_error_rate:.3f} over "
                    f"{canary['requests']} requests"
                )
            # guardrail 2: latency SLO burn relative to live
            if (
                canary["p95_s"] is not None
                and live["p95_s"] is not None
                and live["p95_s"] > 0
                and canary["p95_s"] > live["p95_s"] * p.latency_ratio
            ):
                return ROLLBACK, (
                    f"canary p95 {canary['p95_s']:.4f}s exceeds "
                    f"{p.latency_ratio:g}x live p95 {live['p95_s']:.4f}s"
                )
        # promotion: enough joined evidence and no online-metric regression
        if canary["requests"] >= p.min_requests:
            joined = (quality_comparison or {}).get("canary_joined", 0)
            if p.min_joined <= 0 or joined >= p.min_joined:
                regressed, why = self._metric_regressed(quality_comparison)
                if regressed:
                    return ROLLBACK, why
                return PROMOTE, (
                    f"no regression after {canary['requests']} requests"
                    + (f", {joined} joined samples" if joined else "")
                )
        # fail-safe: a canary that cannot prove itself does not linger
        if age_s is not None and age_s > p.max_canary_s:
            return ROLLBACK, (
                f"canary undecided after {age_s:.0f}s "
                f"(max {p.max_canary_s:.0f}s) — burden of proof not met"
            )
        return CONTINUE, "gathering evidence"

    def _metric_regressed(
        self, comparison: dict[str, Any] | None
    ) -> tuple[bool, str]:
        p = self.policy
        if not comparison:
            return False, ""
        live_v = comparison.get("live_value")
        canary_v = comparison.get("canary_value")
        if live_v is None or canary_v is None or live_v <= 0:
            return False, ""  # nothing comparable yet
        floor = live_v * (1.0 - p.max_metric_regression)
        if canary_v < floor:
            return True, (
                f"online {p.metric} regressed: canary {canary_v:.4f} < "
                f"{floor:.4f} ({p.max_metric_regression:.0%} under live "
                f"{live_v:.4f})"
            )
        return False, ""
