"""Capacity / headroom model: observed load → "how much more can this
replica take, and how many replicas should exist".

The JAX package's ``obs/capacity.py``, stdlib only: the join that turns
the raw observability (SLO burn rates, wave throughput, admission) into an
autoscaling signal.  Inputs, all already metered:

- **device throughput** — ``pio_microbatch_batch_size`` ÷
  ``pio_microbatch_device_seconds`` (histogram sums): queries the device
  path completes per busy second.  The MicroBatcher serializes waves on one
  worker, so this is the per-replica device ceiling.
- **admission ceiling** — Little's law over the in-flight cap:
  ``max_inflight / mean request latency`` is the arrival rate past which
  admission control starts shedding.
- **queue occupancy** — ``pio_microbatch_queue_depth`` against the queue
  bound: standing backlog means the ceiling is already being paid in
  latency.
- **observed load + SLO burn** — the rolling SLO window's request rate and
  burn rates (obs/slo.py).

Outputs: ``max_sustainable_qps`` (the binding ceiling and which input
binds), ``headroom_frac`` (1 − load/ceiling, clamped to [-1, 1]), and a
``recommended_replicas`` integer sized so the fleet would run at
:data:`TARGET_UTILIZATION` of its ceiling — the input a horizontal
autoscaler (or an operator reading the dashboard Capacity panel) acts on.

Estimates are cheap arithmetic over already-collected counters — a scrape,
not a load test — and honest about their blind spots: with no device
traffic yet there is no device ceiling, and the snapshot says so in
``caveats`` instead of inventing one.
"""

from __future__ import annotations

import math
from typing import Any

from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

#: fleet sizing targets this utilization of the binding ceiling — the
#: standard "scale before the knee" margin
TARGET_UTILIZATION = 0.7

#: burn rate past which the model stops trusting its own headroom math and
#: recommends scaling regardless (the SLO is ALREADY burning)
BURN_LIMIT = 1.0


def _family_totals(
    registry: MetricsRegistry, name: str
) -> tuple[float, float]:
    """(sum, count) across every series of one histogram family."""
    fam = registry.get(name)
    if fam is None or fam.kind != "histogram":
        return 0.0, 0.0
    total_sum = 0.0
    total_count = 0.0
    for _, child in fam.series():
        _, s, c = child.snapshot()
        total_sum += s
        total_count += c
    return total_sum, total_count


def _gauge_value(registry: MetricsRegistry, name: str) -> float | None:
    fam = registry.get(name)
    if fam is None or fam.kind == "histogram":
        return None
    series = fam.series()
    if not series:
        return None
    return float(sum(child.value for _, child in series))


def capacity_snapshot(app: Any, registry: MetricsRegistry | None = None) -> dict:
    """The ``/capacity.json`` body for one serving app (``app`` may be None
    for a process-local `pio capacity` dump — admission/SLO inputs are then
    simply absent)."""
    reg = registry or REGISTRY
    caveats: list[str] = []

    # -- device ceiling: queries per device-busy second ----------------------
    size_sum, _ = _family_totals(reg, "pio_microbatch_batch_size")
    dev_sum, dev_waves = _family_totals(reg, "pio_microbatch_device_seconds")
    device_qps = size_sum / dev_sum if dev_sum > 0 else None
    if device_qps is None:
        caveats.append("no micro-batched waves observed yet: no device ceiling")

    # -- observed load + latency --------------------------------------------
    lat_sum, lat_count = _family_totals(reg, "pio_request_latency_seconds")
    mean_latency_s = lat_sum / lat_count if lat_count > 0 else None
    slo = getattr(app, "slo", None) if app is not None else None
    observed_qps = None
    burn = {}
    if slo is not None:
        snap = slo.snapshot()
        window = min(snap["window_s"], max(snap["uptime_s"], 1e-9))
        observed_qps = snap["requests"] / window if window > 0 else None
        burn = {
            "error_burn_rate": snap["error_burn_rate"],
            "latency_burn_rate": snap["latency_burn_rate"],
            "slo_status": snap["status"],
        }
    else:
        caveats.append("no SLO tracker: observed load unknown")

    # -- admission ceiling (Little's law over the in-flight cap) -------------
    admission = getattr(app, "admission", None) if app is not None else None
    admission_qps = None
    inflight = None
    max_inflight = None
    if admission is not None:
        max_inflight = admission.max_inflight
        inflight = admission.inflight
        if mean_latency_s and mean_latency_s > 0:
            admission_qps = max_inflight / mean_latency_s
        else:
            caveats.append(
                "no request latency observed yet: admission ceiling unknown"
            )
    else:
        caveats.append("no admission cap configured: admission ceiling unbounded")

    # -- queue occupancy -----------------------------------------------------
    queue_depth = _gauge_value(reg, "pio_microbatch_queue_depth") or 0.0
    batcher = getattr(app, "microbatcher", None) if app is not None else None
    max_queue = getattr(batcher, "max_queue", None)
    # with no bound, occupancy is unknowable — a transient depth of 1
    # between submit and dispatch must NOT read as a full queue
    queue_frac = queue_depth / max_queue if max_queue else None
    if max_queue is None and queue_depth:
        caveats.append("queue unbounded: occupancy fraction not computable")

    # -- the join ------------------------------------------------------------
    ceilings: dict[str, float] = {}
    if device_qps is not None:
        ceilings["device"] = round(device_qps, 3)
    if admission_qps is not None:
        ceilings["admission"] = round(admission_qps, 3)
    binding = min(ceilings, key=ceilings.get) if ceilings else None
    max_qps = ceilings[binding] if binding else None

    headroom = None
    if max_qps is not None and observed_qps is not None and max_qps > 0:
        headroom = max(min(1.0 - observed_qps / max_qps, 1.0), -1.0)
    burning = max(
        burn.get("error_burn_rate", 0.0), burn.get("latency_burn_rate", 0.0)
    ) > BURN_LIMIT
    if burning and headroom is not None:
        # the SLO is already missing: whatever the arithmetic says, this
        # replica has no spendable headroom
        headroom = min(headroom, 0.0)

    recommended = None
    if max_qps is not None and observed_qps is not None and max_qps > 0:
        recommended = max(
            1, math.ceil(observed_qps / (TARGET_UTILIZATION * max_qps))
        )
        if burning:
            recommended += 1

    scale_hint = "unknown"
    if burning:
        # the SLO is ALREADY burning: even with no computable ceiling the
        # signal must not go dark at the exact moment it matters most
        scale_hint = "up"
        if headroom is None:
            caveats.append(
                "SLO burning with no computable ceiling: scale up on burn "
                "rate alone"
            )
    elif headroom is not None:
        if headroom <= 0.0 or (queue_frac is not None and queue_frac > 0.5):
            scale_hint = "up"
        elif headroom > 1.0 - TARGET_UTILIZATION:
            scale_hint = "hold_or_down"
        else:
            scale_hint = "hold"

    return {
        "inputs": {
            "device_items_per_busy_second": (
                round(device_qps, 3) if device_qps is not None else None
            ),
            "device_busy_seconds": round(dev_sum, 6),
            "waves": int(dev_waves),
            "mean_request_latency_s": (
                round(mean_latency_s, 6) if mean_latency_s is not None else None
            ),
            "observed_qps": (
                round(observed_qps, 3) if observed_qps is not None else None
            ),
            "inflight": inflight,
            "max_inflight": max_inflight,
            "queue_depth": queue_depth,
            "max_queue": max_queue,
            "queue_occupancy_frac": (
                round(queue_frac, 4) if queue_frac is not None else None
            ),
            **burn,
        },
        "ceilings_qps": ceilings,
        "binding_ceiling": binding,
        "max_sustainable_qps": max_qps,
        "headroom_frac": round(headroom, 4) if headroom is not None else None,
        "recommended_replicas": recommended,
        "scale_hint": scale_hint,
        "target_utilization": TARGET_UTILIZATION,
        "caveats": caveats,
    }
