"""Solo-path host-stage attribution: where a single request's time goes.

The JAX package's ``obs/hotpath.py``, stdlib only.  The request latency
histogram is one opaque number, so "optimize the solo path" needs a
breakdown to start from.  This module decomposes every non-batched request
into
named HOST stages, measured contiguously so they account for (almost) all
of the request's wall time:

========================  ==================================================
stage                     meaning
========================  ==================================================
``parse``                 body JSON decode + query-class extraction
``route``                 binding selection / canary split / handler prep
``queue_wait``            submit-to-dispatch wait behind the in-flight wave
                          (micro-batched front end only)
``entity_gather``         host-side feature/factor gather (``supplement``
                          and any engine ``host_gather`` marks)
``h2d``                   host→device transfer the engine marked
``compute``               device compute the engine marked
``d2h``                   device→host readback the engine marked
``dispatch``              the unattributed interior of the predict window:
                          kernel-launch / dev-tunnel overhead on device
                          engines, host scoring on host-replica engines
``block_until_ready``     event-loop wakeup + future resolution after the
                          wave finished (micro-batched front end only)
``serialize``             render, plugins/feedback, response build + encode
========================  ==================================================

Each stage lands in ``pio_hotpath_stage_seconds{stage}`` and in a
per-tracker mean table; ``GET /hotpath.json`` serves p50/p99-per-stage with
a ``coverage_frac`` — the fraction of solo wall time the named stages
explain, which the tests hold at ≥95 %.  The stages are measured with one
:class:`StageClock` per request: consecutive ``lap()`` marks, so the only
unattributed time is the slivers between marks.

**Overlap semantics (pipelined dispatch):** once waves pipeline,
stage durations stop summing naively — a request's ``queue_wait`` can
overlap the previous wave's ``compute``, and the wave's device stages are
measured on the worker/finalizer clocks while the request's wall runs on
its own.  Coverage stays honest by construction: per request the
attributed total is clamped to the wall (``min(attributed, total)``), so
``coverage_frac`` can never exceed 1.0, and the clamped excess is
surfaced as ``overlap_frac`` — the fraction of attributed stage time that
ran CONCURRENTLY with other stages.  A rising ``overlap_frac`` with a
falling total p50 is the pipeline working; the ≥95 % coverage assertion
holds under overlap because clamping only ever discards double-counted
time, never real wall time.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping

from predictionio_tpu_torch.obs.metrics import (
    REGISTRY,
    MetricsRegistry,
    quantile_from_buckets,
)

#: canonical stage order for rendering (unknown stages append after)
STAGE_ORDER: tuple[str, ...] = (
    "parse",
    "route",
    "queue_wait",
    "entity_gather",
    "h2d",
    "compute",
    "d2h",
    "dispatch",
    "block_until_ready",
    "serialize",
)

#: map the wave timeline's device-breakdown keys onto hotpath stage names
WAVE_STAGE_MAP: Mapping[str, str] = {
    "host_gather": "entity_gather",
    "h2d": "h2d",
    "compute": "compute",
    "d2h": "d2h",
    "other": "dispatch",
}


class StageClock:
    """Consecutive stage marks for one request.

    ``lap(name)`` attributes everything since the previous mark to
    ``name``; ``add(name, seconds)`` folds in a single externally-measured
    duration while advancing the mark by the same amount, so
    externally-attributed time is never double counted by the next
    ``lap``; ``split(parts, remainder)`` does the same for a whole window
    of external measurements at once (how the serving front ends fold in
    the MicroBatcher's ``queue_wait_s``/device-breakdown meta).
    """

    __slots__ = ("t0", "_mark", "stages")

    def __init__(self):
        self.t0 = self._mark = time.perf_counter()
        self.stages: dict[str, float] = {}

    def lap(self, stage: str) -> float:
        now = time.perf_counter()
        dt = now - self._mark
        self._mark = now
        if dt > 0:
            self.stages[stage] = self.stages.get(stage, 0.0) + dt
        return dt

    def add(self, stage: str, seconds: float) -> None:
        if seconds and seconds > 0:
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds
            self._mark += seconds

    def split(self, parts: Mapping[str, float], remainder: str) -> None:
        """Attribute the time since the previous mark: the named ``parts``
        first, whatever is left to ``remainder`` (clamped at zero — parts
        measured on another clock can slightly exceed the window)."""
        now = time.perf_counter()
        window = now - self._mark
        self._mark = now
        attributed = 0.0
        for name, seconds in parts.items():
            if seconds and seconds > 0:
                self.stages[name] = self.stages.get(name, 0.0) + seconds
                attributed += seconds
        left = window - attributed
        if left > 0:
            self.stages[remainder] = self.stages.get(remainder, 0.0) + left

    def total(self) -> float:
        return time.perf_counter() - self.t0


class HotPathTracker:
    """Aggregate per-stage durations + coverage for one serving app.

    ``observe`` is the per-request write (a handful of histogram
    observations plus two float adds under one lock); ``snapshot`` is the
    ``/hotpath.json`` body.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry or REGISTRY
        self._fam = reg.histogram(
            "pio_hotpath_stage_seconds",
            "Solo-request host time by named hot-path stage",
            labelnames=("stage",),
        )
        self._total_hist = reg.histogram(
            "pio_hotpath_total_seconds",
            "Solo-request wall time covered by hot-path attribution",
        )
        #: stage -> its histogram child, resolved once (a request observes
        #: up to ten stages)
        self._children: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._n = 0
        self._total_sum = 0.0
        self._attributed_sum = 0.0
        self._overlap_sum = 0.0
        self._stage_sums: dict[str, float] = {}

    def observe(self, total_s: float, stages: Mapping[str, float]) -> None:
        if total_s <= 0:
            return
        attributed = 0.0
        children = self._children
        for name, seconds in stages.items():
            if seconds and seconds > 0:
                child = children.get(name)
                if child is None:
                    child = children[name] = self._fam.labels(name)
                child.observe(seconds)
                attributed += seconds
        self._total_hist.observe(total_s)
        with self._lock:
            self._n += 1
            self._total_sum += total_s
            # clamp: pipelined stages measured on other clocks can overlap
            # the request's own wall — coverage must never read >100 %
            self._attributed_sum += min(attributed, total_s)
            self._overlap_sum += max(attributed - total_s, 0.0)
            for name, seconds in stages.items():
                if seconds and seconds > 0:
                    self._stage_sums[name] = (
                        self._stage_sums.get(name, 0.0) + seconds
                    )

    def observe_clock(self, clock: StageClock) -> None:
        self.observe(clock.total(), clock.stages)

    def snapshot(self) -> dict[str, Any]:
        """Per-stage p50/p99/mean/share table + the coverage fraction the
        acceptance gate holds at ≥0.95."""
        with self._lock:
            n = self._n
            total_sum = self._total_sum
            attributed_sum = self._attributed_sum
            overlap_sum = self._overlap_sum
            stage_sums = dict(self._stage_sums)
        fam = self._fam
        order = {s: i for i, s in enumerate(STAGE_ORDER)}
        stages: dict[str, Any] = {}
        for name in sorted(
            stage_sums, key=lambda s: (order.get(s, len(order)), s)
        ):
            child = fam.labels(name)
            counts, _, count = child.snapshot()
            stages[name] = {
                "count": count,
                "seconds_total": round(stage_sums[name], 6),
                "share_frac": round(
                    stage_sums[name] / total_sum if total_sum else 0.0, 4
                ),
                "p50_s": round(
                    quantile_from_buckets(child.bounds, counts, count, 0.50), 9
                ),
                "p99_s": round(
                    quantile_from_buckets(child.bounds, counts, count, 0.99), 9
                ),
                "mean_s": round(
                    stage_sums[name] / count if count else 0.0, 9
                ),
            }
        tcounts, _, tcount = self._total_hist.snapshot()
        return {
            "requests": n,
            "coverage_frac": round(
                attributed_sum / total_sum if total_sum else 0.0, 4
            ),
            # stage time that ran concurrently with other stages (pipelined
            # dispatch): attributed-beyond-wall, as a fraction of wall
            "overlap_frac": round(
                overlap_sum / total_sum if total_sum else 0.0, 4
            ),
            "total": {
                "sum_s": round(total_sum, 6),
                "p50_s": round(
                    quantile_from_buckets(
                        self._total_hist.bounds, tcounts, tcount, 0.50
                    ),
                    9,
                ),
                "p99_s": round(
                    quantile_from_buckets(
                        self._total_hist.bounds, tcounts, tcount, 0.99
                    ),
                    9,
                ),
            },
            "stages": stages,
        }


def render_hotpath_text(snap: Mapping[str, Any]) -> str:
    """One-screen stage table over a ``/hotpath.json`` body."""
    lines = [
        f"requests: {snap.get('requests', 0)}   "
        f"coverage: {snap.get('coverage_frac', 0.0):.1%}   "
        f"total p50 {snap.get('total', {}).get('p50_s', 0.0) * 1e3:.3f} ms / "
        f"p99 {snap.get('total', {}).get('p99_s', 0.0) * 1e3:.3f} ms",
        f"{'stage':<18} {'share':>7} {'p50 ms':>10} {'p99 ms':>10}",
    ]
    for name, row in snap.get("stages", {}).items():
        lines.append(
            f"{name:<18} {row['share_frac']:>6.1%} "
            f"{row['p50_s'] * 1e3:>10.3f} {row['p99_s'] * 1e3:>10.3f}"
        )
    return "\n".join(lines)
