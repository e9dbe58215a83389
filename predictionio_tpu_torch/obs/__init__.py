"""Observability of the port: the metrics registry (``obs/metrics.py``).
Exposition routes, device timelines and profiling come with the port's
observability slice."""
