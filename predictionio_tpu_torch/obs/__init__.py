"""Observability of the port: metrics with Prometheus and JSON exposition
(metrics.py), spans with a recent-trace ring (tracing.py), cross-process
fragments (disttrace.py) and their assembly into one timeline
(timeline.py), request-id-correlated JSON-lines logging with an in-process
ring (logging.py), the flight recorder (flight.py), rolling SLO tracking
and readiness (slo.py), lock-wait metering (contention.py), the device
roofline from CUDA events and least-work costs, launch-shape churn and the
wave timeline (device.py), ``torch.profiler`` capture and the card's memory
gauges (profiler.py), the host stack sampler (sampling.py), solo-path stage
attribution (hotpath.py), the headroom model (capacity.py), decision
provenance and its replay (provenance.py), online model quality and drift
(quality.py), the per-app cost ledger (costs.py), the watch loop: alert
rules (alerts.py) whose firing transitions record forensic incident
bundles (incident.py), the metrics sniffer plugin (plugin.py), and the
HTTP routes for all of it (http.py).

The JAX package's ``obs/`` under the same metric names, routes and JSON
shapes.  Not here yet: the verdict module (with the production-day
harness).  Dependency-free apart from torch, which only device.py and
profiler.py read, and only when the process already uses it.
"""

from predictionio_tpu_torch.obs.alerts import (
    AlertEvaluator,
    AlertRule,
    default_rule_pack,
    resolve_rules,
)
from predictionio_tpu_torch.obs.costs import (
    CostLedger,
    RequestCost,
    current_cost,
    default_ledger,
    note_storage_read,
    request_cost,
)
from predictionio_tpu_torch.obs.incident import IncidentRecorder, load_bundle

__all__ = [
    "AlertEvaluator",
    "AlertRule",
    "CostLedger",
    "IncidentRecorder",
    "RequestCost",
    "current_cost",
    "default_ledger",
    "default_rule_pack",
    "load_bundle",
    "note_storage_read",
    "request_cost",
    "resolve_rules",
]
