"""Device-efficiency observability on CUDA: the live roofline from CUDA
events and least-work costs, launch-shape churn, and the wave timeline.

The counterpart of the JAX package's ``obs/device.py``, rethought for a
card whose work is asynchronous:

- :func:`device_peaks` keys :data:`PEAK_TABLE` on the card's name as
  ``torch.cuda.get_device_name`` gives it (lower-cased, the most specific
  prefix wins), overridable per deployment with ``PIO_DEVICE_PEAK_GBPS`` /
  ``PIO_DEVICE_PEAK_TFLOPS``.  The rows are HBM GB/s and fp32 TFLOP/s
  outside the tensor cores: none of the port's kernels uses them, and the
  same rates are the denominators of the kernels' least-work bounds.
- :class:`EfficiencyTracker` joins a per-call cost with a measured time and
  exports the JAX package's gauges (``pio_device_achieved_gbps{fn}``,
  ``pio_device_achieved_tflops{fn}``, ``pio_device_utilization_frac{fn,
  resource}``; ``resource`` keeps the JAX labels ``hbm`` and ``mxu``, the
  latter the card's fp32 arithmetic here).  There is no XLA cost model:
  every cost is installed from the port's own least-work counts
  (``source="least_work"``: ``ops.topk.fused_topk_least_work``,
  ``ops.als_accum.als_accum_least_work`` and
  ``segment_accum_least_work``).  The time a serving wave observes is its
  kernel's CUDA-event time, read after the wave's own fence; a host wait is
  never kernel time (on a pipelined wave it can be near zero).  Each ``fn``
  label names the JAX entry point it stands for (``als.fused_topk``,
  ``als.batch_topk``, ``als.pallas_step``).
- :class:`RecompileTracker` counts distinct launch signatures per ``fn``
  (batch, k, table and factor shapes) and flags a *storm*: many of them
  inside a sliding window, i.e. traffic churning launch shapes.  A first
  ``nvcc`` build is a span (``obs.tracing.observe_kernel_build``), not a
  recompile.  The JAX metric names are kept (``pio_jax_recompile_total``,
  ``pio_recompile_storm_total``).
- a contextvar *wave timeline* (:func:`wave_timeline` / :func:`wave_stage`)
  splits a MicroBatcher wave's ``device_s`` into ``host_gather`` / ``h2d``
  / ``compute`` / ``d2h`` plus ``other``.  These stages are HOST time, as
  in the JAX package: ``h2d`` is the enqueue of the upload, ``compute`` the
  wait in the fence, ``d2h`` the read of the pinned result.  On a card the
  split says where the host waited, not where the card worked; the card's
  own time rides beside it as the wave's ``kernel_s``.

Import-light: servers that never touch the card (the event server) import
this module through ``obs.http``.  Nothing here imports torch at module
scope, and the card's name is read only when torch already initialized
CUDA in this process (no scrape creates a CUDA context).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Mapping

from predictionio_tpu_torch.obs.metrics import (
    REGISTRY,
    STAGE_BUCKETS,
    MetricsRegistry,
)

log = logging.getLogger("predictionio_tpu_torch.device")

# ---------------------------------------------------------------------------
# peak table

#: Peak HBM bandwidth (GB/s) and fp32 throughput outside the tensor cores
#: (TFLOP/s) per device-name prefix, most specific prefix wins.  The CPU row
#: is a DDR-class placeholder so utilization fractions stay meaningful (and
#: test-assertable) on the CPU; ``gpu`` is the JAX package's row for a card
#: that matches no named row.  Override per deployment with
#: PIO_DEVICE_PEAK_GBPS / PIO_DEVICE_PEAK_TFLOPS.
PEAK_TABLE: dict[str, tuple[float, float]] = {
    "nvidia h100 80gb hbm3": (3350.0, 67.0),  # SXM
    "nvidia h100 pcie": (2000.0, 51.0),
    "nvidia h100 nvl": (3900.0, 60.0),
    "cpu": (25.0, 0.5),
    "gpu": (900.0, 100.0),
}


@dataclass(frozen=True)
class DevicePeaks:
    """Peak rates one ``achieved / peak`` division away from a fraction."""

    hbm_gbps: float
    tflops: float
    source: str  # table key, "env", or "default"


def _platform_kind() -> str:
    """The card's lower-cased name, WITHOUT initializing CUDA: torch is only
    consulted when this process already initialized it.  A card that
    matches no named row reads as ``gpu``."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "cpu"
    try:
        if not torch.cuda.is_initialized():
            return "cpu"
        name = torch.cuda.get_device_name(torch.cuda.current_device()).lower()
    except Exception:
        return "cpu"
    if any(name.startswith(p) for p in PEAK_TABLE):
        return name
    return "gpu"


def device_peaks(kind: str | None = None) -> DevicePeaks:
    """Resolve the peak row for ``kind`` (default: the live card).

    ``PIO_DEVICE_PEAK_GBPS`` / ``PIO_DEVICE_PEAK_TFLOPS`` override the table
    per deployment, read at call time so an operator can correct a
    down-clocked or power-capped card without a restart."""
    kind = (kind or _platform_kind()).lower()
    gbps = tflops = None
    source = "default"
    for prefix in sorted(PEAK_TABLE, key=len, reverse=True):
        if kind.startswith(prefix):
            gbps, tflops = PEAK_TABLE[prefix]
            source = prefix
            break
    if gbps is None:
        gbps, tflops = PEAK_TABLE["cpu"]
    env_gbps = os.environ.get("PIO_DEVICE_PEAK_GBPS")
    env_tflops = os.environ.get("PIO_DEVICE_PEAK_TFLOPS")
    if env_gbps or env_tflops:
        # source flips to "env" only when an override actually parsed — a
        # typo'd value must not make the snapshot claim a correction that
        # was silently ignored
        try:
            gbps = float(env_gbps) if env_gbps else gbps
            source = "env" if env_gbps else source
        except ValueError:
            pass
        try:
            tflops = float(env_tflops) if env_tflops else tflops
            source = "env" if env_tflops else source
        except ValueError:
            pass
    return DevicePeaks(hbm_gbps=float(gbps), tflops=float(tflops),
                       source=source)


def achieved_gbps(bytes_moved: float, seconds: float) -> float:
    """Achieved HBM bandwidth in GB/s for ``bytes_moved`` over ``seconds``."""
    return bytes_moved / seconds / 1e9 if seconds > 0 else 0.0


def achieved_tflops(flops: float, seconds: float) -> float:
    """Achieved TFLOP/s for ``flops`` executed over ``seconds``."""
    return flops / seconds / 1e12 if seconds > 0 else 0.0


def utilization_frac(achieved: float, peak: float) -> float:
    """``achieved / peak`` with a zero-peak guard (fractions, not %)."""
    return achieved / peak if peak > 0 else 0.0


def device_label(x: Any) -> str:
    """``type:index`` label of the device holding ``x`` (a torch tensor:
    ``cuda:0``, ``cpu:0``), or ``"host"`` for anything without a device
    (numpy arrays)."""
    dev = getattr(x, "device", None)
    if dev is None or not hasattr(dev, "type"):
        return "host"
    return f"{dev.type}:{dev.index or 0}"


# ---------------------------------------------------------------------------
# efficiency tracker


class EfficiencyTracker:
    """Join per-fn costs with measured device seconds.

    ``record_cost`` stores FLOPs/bytes per (fn, signature) — the port's
    least-work counts — and ``observe`` converts one timed execution into
    achieved-vs-peak gauges plus cumulative FLOP/byte counters.  All state
    under one lock; the observe path is two dict reads and four gauge sets.
    The arithmetic is the JAX package's, term for term."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        peaks: DevicePeaks | None = None,
    ):
        self._lock = threading.Lock()
        self._registry = registry or REGISTRY
        self._peaks = peaks
        #: (fn, signature) -> {"flops", "bytes", "source"}
        self._costs: dict[tuple[str, tuple], dict[str, Any]] = {}
        #: fn -> the signature of the most recent record/observe
        self._last_sig: dict[str, tuple] = {}
        #: fn -> {"calls", "seconds", "flops", "bytes"} cumulative
        self._totals: dict[str, dict[str, float]] = {}
        reg = self._registry
        self._g_gbps = reg.gauge(
            "pio_device_achieved_gbps",
            "Achieved HBM bandwidth per entry point (GB/s)",
            labelnames=("fn",),
        )
        self._g_tflops = reg.gauge(
            "pio_device_achieved_tflops",
            "Achieved fp32 throughput per entry point (TFLOP/s)",
            labelnames=("fn",),
        )
        self._g_util = reg.gauge(
            "pio_device_utilization_frac",
            "Achieved / peak fraction per entry point and resource",
            labelnames=("fn", "resource"),
        )
        self._c_flops = reg.counter(
            "pio_device_flops_total",
            "Cumulative FLOPs executed per entry point (least work)",
            labelnames=("fn",),
        )
        self._c_bytes = reg.counter(
            "pio_device_bytes_total",
            "Cumulative bytes accessed per entry point (least work)",
            labelnames=("fn",),
        )

    def record_cost(
        self,
        fn: str,
        flops: float,
        nbytes: float,
        signature: tuple = (),
        source: str = "least_work",
    ) -> None:
        """Install the per-call cost of ``fn`` at ``signature``."""
        with self._lock:
            self._costs[(fn, signature)] = {
                "flops": float(flops),
                "bytes": float(nbytes),
                "source": source,
            }
            self._last_sig[fn] = signature

    def cached_cost(self, fn: str, signature: tuple) -> dict | None:
        """The recorded cost for (fn, signature), if there is one."""
        with self._lock:
            cost = self._costs.get((fn, signature))
            return dict(cost) if cost is not None else None

    def observe(
        self, fn: str, seconds: float, signature: tuple | None = None
    ) -> None:
        """One timed execution of ``fn``: update achieved/utilization gauges
        and cumulative counters using the cost recorded for ``signature``
        (default: the most recent one for ``fn``).  No-op without a cost —
        timing alone cannot place a point on the roofline."""
        if seconds <= 0:
            return
        with self._lock:
            sig = self._last_sig.get(fn) if signature is None else signature
            cost = self._costs.get((fn, sig if sig is not None else ()))
            if cost is None:
                return
            totals = self._totals.setdefault(
                fn, {"calls": 0.0, "seconds": 0.0, "flops": 0.0, "bytes": 0.0}
            )
            totals["calls"] += 1
            totals["seconds"] += seconds
            totals["flops"] += cost["flops"]
            totals["bytes"] += cost["bytes"]
        gbps = achieved_gbps(cost["bytes"], seconds)
        tflops = achieved_tflops(cost["flops"], seconds)
        peaks = self._peaks or device_peaks()
        self._g_gbps.labels(fn).set(gbps)
        self._g_tflops.labels(fn).set(tflops)
        self._g_util.labels(fn, "hbm").set(
            utilization_frac(gbps, peaks.hbm_gbps)
        )
        self._g_util.labels(fn, "mxu").set(
            utilization_frac(tflops, peaks.tflops)
        )
        self._c_flops.labels(fn).inc(cost["flops"])
        self._c_bytes.labels(fn).inc(cost["bytes"])

    def snapshot(self) -> dict[str, Any]:
        """Per-fn costs, cumulative achieved rates, and utilization — the
        ``/efficiency.json`` body."""
        peaks = self._peaks or device_peaks()
        with self._lock:
            costs = {k: dict(v) for k, v in self._costs.items()}
            totals = {k: dict(v) for k, v in self._totals.items()}
        fns: dict[str, Any] = {}
        for (fn, _sig), cost in costs.items():
            entry = fns.setdefault(
                fn,
                {
                    "signatures": 0,
                    "flops_per_call": 0.0,
                    "bytes_per_call": 0.0,
                    "source": cost["source"],
                },
            )
            entry["signatures"] += 1
            # the largest signature's cost is the representative one
            entry["flops_per_call"] = max(
                entry["flops_per_call"], cost["flops"]
            )
            entry["bytes_per_call"] = max(
                entry["bytes_per_call"], cost["bytes"]
            )
        for fn, t in totals.items():
            entry = fns.setdefault(fn, {"signatures": 0, "source": "?"})
            gbps = achieved_gbps(t["bytes"], t["seconds"])
            tflops = achieved_tflops(t["flops"], t["seconds"])
            entry.update(
                calls=int(t["calls"]),
                seconds_total=round(t["seconds"], 6),
                flops_total=t["flops"],
                bytes_total=t["bytes"],
                achieved_gbps=round(gbps, 3),
                achieved_tflops=round(tflops, 6),
                utilization_hbm=round(
                    utilization_frac(gbps, peaks.hbm_gbps), 6
                ),
                utilization_mxu=round(
                    utilization_frac(tflops, peaks.tflops), 6
                ),
            )
        return {
            "platform": _platform_kind(),
            "peaks": {
                "hbm_gbps": peaks.hbm_gbps,
                "tflops": peaks.tflops,
                "source": peaks.source,
            },
            "functions": fns,
        }


# ---------------------------------------------------------------------------
# launch-shape churn


class RecompileTracker:
    """Launches keyed by (fn, launch signature), with a storm detector: N
    distinct signatures for one fn inside a sliding window means traffic is
    churning launch shapes.  The JAX package counts XLA compiles this way;
    a hand-written kernel compiles once, so here the tracker reads shape
    churn — each new (batch, k, table, rank) a wave brings.

    Thresholds come from ``PIO_RECOMPILE_STORM_N`` (distinct signatures,
    default 4) and ``PIO_RECOMPILE_STORM_WINDOW_S`` (default 60) at
    construction.  ``now`` parameters exist so tests drive a frozen clock.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        storm_threshold: int | None = None,
        window_s: float | None = None,
    ):
        self._lock = threading.Lock()
        if storm_threshold is None:
            storm_threshold = int(
                os.environ.get("PIO_RECOMPILE_STORM_N", "4")
            )
        if window_s is None:
            window_s = float(
                os.environ.get("PIO_RECOMPILE_STORM_WINDOW_S", "60")
            )
        self.storm_threshold = max(storm_threshold, 2)
        self.window_s = window_s
        #: fn -> every signature ever seen
        self._seen: dict[str, set] = {}
        #: fn -> deque of (t, signature) for NEW signatures in the window
        self._recent: dict[str, deque] = {}
        #: fn -> storm-active-until timestamp
        self._storm_until: dict[str, float] = {}
        reg = registry or REGISTRY
        self._c_recompiles = reg.counter(
            "pio_jax_recompile_total",
            "New (fn, launch shape) signatures seen",
            labelnames=("fn",),
        )
        self._c_storms = reg.counter(
            "pio_recompile_storm_total",
            "Launch-shape storms detected (distinct signatures over "
            "threshold inside the window)",
            labelnames=("fn",),
        )

    def note_signature(
        self, fn: str, signature: tuple, now: float | None = None
    ) -> bool:
        """Record a launch signature; returns True when it is NEW for
        ``fn``.  Trips the storm counter + a structured warning when
        distinct new signatures inside the window reach the threshold."""
        t = time.monotonic() if now is None else now
        with self._lock:
            seen = self._seen.setdefault(fn, set())
            if signature in seen:
                return False
            seen.add(signature)
            recent = self._recent.setdefault(fn, deque())
            recent.append((t, signature))
            while recent and recent[0][0] < t - self.window_s:
                recent.popleft()
            distinct = len(recent)
            storming = distinct >= self.storm_threshold
            was_storming = self._storm_until.get(fn, 0.0) > t
            if storming:
                self._storm_until[fn] = t + self.window_s
        self._c_recompiles.labels(fn).inc()
        if storming and not was_storming:
            self._c_storms.labels(fn).inc()
            log.warning(
                "launch-shape storm: %d distinct launch signatures for %s "
                "inside %.0fs — traffic is churning shapes (batch, k, "
                "table); pad inputs to a fixed menu of shapes",
                distinct,
                fn,
                self.window_s,
                extra={
                    "fn": fn,
                    "distinct_signatures": distinct,
                    "window_s": self.window_s,
                },
            )
        return True

    def active_storms(self, now: float | None = None) -> dict[str, Any]:
        """Functions currently inside a storm window.  ``signatures`` is the
        in-window distinct count the storm was detected on;
        ``total_signatures`` the lifetime tally."""
        t = time.monotonic() if now is None else now
        with self._lock:
            return {
                fn: {
                    "until_s": round(until - t, 3),
                    "signatures": len(
                        [1 for ts, _ in self._recent.get(fn, ())
                         if ts >= t - self.window_s]
                    ),
                    "total_signatures": len(self._seen.get(fn, ())),
                }
                for fn, until in self._storm_until.items()
                if until > t
            }

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        with self._lock:
            fns = {
                fn: {
                    "signatures": len(sigs),
                    "recent_window": len(self._recent.get(fn, ())),
                }
                for fn, sigs in self._seen.items()
            }
        return {
            "threshold": self.storm_threshold,
            "window_s": self.window_s,
            "functions": fns,
            "active_storms": self.active_storms(now),
        }


# ---------------------------------------------------------------------------
# wave timeline: the 4-way device_s split

#: the stages a wave decomposes into; anything unattributed lands in "other"
WAVE_STAGES: tuple[str, ...] = ("host_gather", "h2d", "compute", "d2h")


class WaveTimeline:
    """Per-wave accumulator engines mark stages into (contextvar-scoped)."""

    __slots__ = (
        "stages", "device", "fn", "flops", "bytes", "transfers",
        "kernel_s", "cache_hits", "cache_misses", "cache_miss_bytes",
    )

    def __init__(self):
        #: host seconds per stage (wave_stage marks)
        self.stages: dict[str, float] = {}
        self.device: str = "host"
        self.fn: str | None = None
        self.flops: float = 0.0
        self.bytes: float = 0.0
        self.transfers: dict[str, float] = {}
        #: the wave's device time: the kernel's CUDA-event time on a card
        #: (recorded by its launcher), the host span on the CPU
        #: (note_wave_kernel)
        self.kernel_s: float = 0.0
        #: factor-cache hits inside this wave (note_cache_hit): a repeat
        #: entity whose gather was skipped
        self.cache_hits: int = 0
        #: ... and the misses, with the bytes their resolving fetch moved
        self.cache_misses: int = 0
        self.cache_miss_bytes: float = 0.0

    def merge(self, other: "WaveTimeline") -> None:
        """Fold another scope's marks into this one: a pipelined wave's
        dispatch half (worker thread) into its finalize half (finalizer
        thread), so one breakdown covers both."""
        for stage, seconds in other.stages.items():
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds
        if self.fn is None:
            self.fn, self.flops, self.bytes = other.fn, other.flops, other.bytes
        if self.device == "host" and other.device != "host":
            self.device = other.device
        for direction, nbytes in other.transfers.items():
            self.transfers[direction] = (
                self.transfers.get(direction, 0.0) + nbytes
            )
        self.kernel_s += other.kernel_s
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.cache_miss_bytes += other.cache_miss_bytes


_timeline_var: contextvars.ContextVar[WaveTimeline | None] = (
    contextvars.ContextVar("pio_wave_timeline", default=None)
)

#: process-cumulative transfer byte tallies (mirrored to gauges on scrape by
#: obs.profiler.sample_runtime_gauges so isolated registries see them too)
_transfer_lock = threading.Lock()
_transfer_totals: dict[str, float] = {"h2d": 0.0, "d2h": 0.0}


@contextlib.contextmanager
def wave_timeline():
    """Open a wave scope; the MicroBatcher wraps ``batch_fn`` in one so the
    engine's :func:`wave_stage` marks land on the dispatching wave."""
    tl = WaveTimeline()
    token = _timeline_var.set(tl)
    try:
        yield tl
    finally:
        _timeline_var.reset(token)


@contextlib.contextmanager
def wave_stage(name: str):
    """Time a block of HOST work into the current wave's ``name`` stage
    (no-op without an open timeline, e.g. a ``batch_predict`` called
    outside serving)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tl = _timeline_var.get()
        if tl is not None:
            tl.stages[name] = (
                tl.stages.get(name, 0.0) + time.perf_counter() - t0
            )


def note_wave_device(label: str) -> None:
    """Attach the executing device's label to the current wave."""
    tl = _timeline_var.get()
    if tl is not None:
        tl.device = label


def note_wave_kernel(seconds: float) -> None:
    """Attach the wave's device time (CUDA-event time on a card) to the
    current wave; it flows into per-item meta as ``wave_kernel_s``."""
    tl = _timeline_var.get()
    if tl is not None:
        tl.kernel_s += float(seconds)


def note_cache_hit(n: int = 1) -> None:
    """Record ``n`` factor-cache hits on the current wave (no-op outside a
    wave scope) — the per-request twin of pio_factor_cache_hits_total."""
    tl = _timeline_var.get()
    if tl is not None:
        tl.cache_hits += n


def note_cache_miss(n: int = 1) -> None:
    """Record ``n`` factor-cache misses on the current wave — each one paid
    the real gather its hit-twin skipped."""
    tl = _timeline_var.get()
    if tl is not None:
        tl.cache_misses += n


def note_cache_fill(nbytes: float) -> None:
    """Record the bytes a cache-miss fetch moved into the cache on the
    current wave."""
    tl = _timeline_var.get()
    if tl is not None:
        tl.cache_miss_bytes += float(nbytes)


def note_wave_cost(fn: str, cost: Mapping[str, float] | None) -> None:
    """Attach the wave's entry-point name and per-call cost (flows into the
    flight-recorder entry of any slow/errored request the wave served)."""
    tl = _timeline_var.get()
    if tl is not None:
        tl.fn = fn
        if cost:
            tl.flops = float(cost.get("flops", 0.0))
            tl.bytes = float(cost.get("bytes", 0.0))


def note_transfer(
    direction: str, nbytes: int, registry: MetricsRegistry | None = None
) -> None:
    """Account ``nbytes`` moved host<->device (``h2d`` / ``d2h``): bumps the
    process tally + the registry counter, and the current wave's split."""
    with _transfer_lock:
        _transfer_totals[direction] = (
            _transfer_totals.get(direction, 0.0) + nbytes
        )
    (registry or REGISTRY).counter(
        "pio_device_transfer_bytes_total",
        "Cumulative host<->device transfer bytes by direction",
        labelnames=("direction",),
    ).labels(direction).inc(nbytes)
    tl = _timeline_var.get()
    if tl is not None:
        tl.transfers[direction] = tl.transfers.get(direction, 0.0) + nbytes


def transfer_totals() -> dict[str, float]:
    """Process-cumulative h2d/d2h byte tallies (scrape-time mirror)."""
    with _transfer_lock:
        return dict(_transfer_totals)


def split_breakdown(
    tl: WaveTimeline | None, device_s: float
) -> dict[str, float]:
    """Decompose ``device_s`` into the 4 marked stages plus ``other`` (the
    unattributed remainder, clamped at zero) — the parts sum to ``device_s``
    whenever the marked stages fit inside it, which they do by construction
    (stages are timed inside the batch_fn window ``device_s`` brackets).
    Every part is host time: on a card, where the host waited."""
    stages = dict(tl.stages) if tl is not None else {}
    out = {name: round(stages.get(name, 0.0), 6) for name in WAVE_STAGES}
    marked = sum(stages.get(name, 0.0) for name in WAVE_STAGES)
    out["other"] = round(max(device_s - marked, 0.0), 6)
    return out


# ---------------------------------------------------------------------------
# process defaults + the /efficiency.json body

#: process-global trackers: device telemetry is per-process like the
#: kernel libraries — servers with isolated registries still share the card
DEVICE_EFFICIENCY = EfficiencyTracker()
RECOMPILES = RecompileTracker()


def default_efficiency() -> EfficiencyTracker:
    return DEVICE_EFFICIENCY


def default_recompiles() -> RecompileTracker:
    return RECOMPILES


def device_snapshot(
    efficiency: EfficiencyTracker | None = None,
    recompiles: RecompileTracker | None = None,
) -> dict[str, Any]:
    """The ``GET /efficiency.json`` body: achieved-vs-peak per entry point
    (with the peak row used), launch-shape accounting (with any active
    storm) and the transfer tallies.  The JAX package's per-device shard
    attribution waits for the port's multi-device slice."""
    snap = (efficiency or DEVICE_EFFICIENCY).snapshot()
    snap["recompiles"] = (recompiles or RECOMPILES).snapshot()
    snap["transfers"] = {
        f"{k}_bytes": v for k, v in transfer_totals().items()
    }
    return snap


#: buckets for the per-stage wave histograms — reuse the stage range
WAVE_STAGE_BUCKETS = STAGE_BUCKETS
