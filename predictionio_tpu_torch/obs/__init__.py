"""Observability of the port: metrics with Prometheus and JSON exposition
(metrics.py), spans with a recent-trace ring (tracing.py) and cross-process
fragments (disttrace.py), request-id-correlated JSON-lines logging with an
in-process ring (logging.py), the flight recorder (flight.py), rolling SLO
tracking and readiness (slo.py), lock-wait metering (contention.py), the
device roofline from CUDA events and least-work costs, launch-shape churn
and the wave timeline (device.py), ``torch.profiler`` capture and the card's
memory gauges (profiler.py), the host stack sampler (sampling.py), solo-path
stage attribution (hotpath.py), the headroom model (capacity.py), decision
provenance and its replay (provenance.py), online model quality and drift
(quality.py), and the HTTP routes for all of it (http.py).

The JAX package's ``obs/`` under the same metric names, routes and JSON
shapes.  Not here yet: the cost ledger, alerts, incidents,
the cross-process trace assembler, the verdict module and the sniffer
plugin.  Dependency-free apart from torch, which only device.py and
profiler.py read, and only when the process already uses it.
"""
