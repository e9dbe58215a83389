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
shapes, and its exports but the two that read JAX's compiler
(``jit_cost_analysis``, ``install_jax_compile_listener``).  The alert rules,
the cost ledger and the incident recorder import eagerly, as before; every
other export loads its module on first access, so a process that imports
``obs`` for its metrics pays for no more.  Dependency-free apart from
torch, which only device.py and profiler.py read, and only when the process
already uses it.
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
from predictionio_tpu_torch.utils.lazy import lazy_exports

__all__ = [
    "AlertEvaluator",
    "AlertRule",
    "DEVICE_EFFICIENCY",
    "DevicePeaks",
    "EfficiencyTracker",
    "FLIGHT",
    "FlightRecorder",
    "IncidentRecorder",
    "JsonLineFormatter",
    "LATENCY_BUCKETS",
    "LogRing",
    "PROFILER",
    "REGISTRY",
    "REQUEST_ID_HEADER",
    "SIZE_BUCKETS",
    "SLOTracker",
    "STAGE_BUCKETS",
    "TRAIN_BUCKETS",
    "CostLedger",
    "Counter",
    "DriftDetector",
    "Gauge",
    "Histogram",
    "HistogramSketch",
    "MetricsHistory",
    "MetricsRegistry",
    "QualityMonitor",
    "RECOMPILES",
    "RecompileTracker",
    "RequestCost",
    "Span",
    "annotate",
    "clear_traces",
    "compare_bench",
    "configure_logging",
    "current_cost",
    "current_span",
    "default_ledger",
    "default_quality",
    "default_registry",
    "default_rule_pack",
    "load_bundle",
    "resolve_rules",
    "device_peaks",
    "device_snapshot",
    "get_log_ring",
    "get_request_id",
    "new_request_id",
    "note_storage_read",
    "observe_span",
    "request_cost",
    "quantile_from_buckets",
    "recent_traces",
    "reset_request_context",
    "sample_runtime_gauges",
    "set_request_context",
    "trace",
    "wave_stage",
    "wave_timeline",
]

__getattr__, __dir__ = lazy_exports(
    __name__,
    {
        "predictionio_tpu_torch.obs.device": (
            "DEVICE_EFFICIENCY",
            "RECOMPILES",
            "DevicePeaks",
            "EfficiencyTracker",
            "RecompileTracker",
            "compare_bench",
            "device_peaks",
            "device_snapshot",
            "wave_stage",
            "wave_timeline",
        ),
        "predictionio_tpu_torch.obs.flight": (
            "FLIGHT",
            "FlightRecorder",
            "annotate",
        ),
        "predictionio_tpu_torch.obs.logging": (
            "REQUEST_ID_HEADER",
            "JsonLineFormatter",
            "LogRing",
            "configure_logging",
            "get_log_ring",
            "get_request_id",
            "new_request_id",
            "reset_request_context",
            "set_request_context",
        ),
        "predictionio_tpu_torch.obs.metrics": (
            "LATENCY_BUCKETS",
            "REGISTRY",
            "SIZE_BUCKETS",
            "STAGE_BUCKETS",
            "TRAIN_BUCKETS",
            "Counter",
            "Gauge",
            "Histogram",
            "MetricsHistory",
            "MetricsRegistry",
            "default_registry",
            "quantile_from_buckets",
        ),
        "predictionio_tpu_torch.obs.profiler": (
            "PROFILER",
            "sample_runtime_gauges",
        ),
        "predictionio_tpu_torch.obs.quality": (
            "DriftDetector",
            "HistogramSketch",
            "QualityMonitor",
            "default_quality",
        ),
        "predictionio_tpu_torch.obs.slo": (
            "SLOTracker",
        ),
        "predictionio_tpu_torch.obs.tracing": (
            "Span",
            "clear_traces",
            "current_span",
            "observe_span",
            "recent_traces",
            "trace",
        ),
    },
)
