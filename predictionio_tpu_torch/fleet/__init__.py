"""Horizontal fleet layer: router + replica membership + autoscaler.

The JAX package's ``fleet/`` on the port: a consistent-hash router in front
of N ``pio deploy`` replicas, each its own process with its own CUDA
context on the card, while the router holds none.  The capacity model
(obs/capacity.py) emits ``recommended_replicas``; this package is the
consumer.  Four pieces:

- :mod:`~predictionio_tpu_torch.fleet.membership` — the :class:`FleetState`
  replica registry: health probing off each replica's ``/readyz``,
  per-replica circuit breakers, ``/capacity.json`` scrapes, and the
  consistent-hash (rendezvous over the HBEventsUtil md5 hash) entity
  affinity the router routes by;
- :mod:`~predictionio_tpu_torch.fleet.router` — a thin CPU-tier HTTP front end
  proxying ``/queries.json`` to N prediction-server replicas with
  deadline-bounded retry-on-another-replica, serving ``/fleet.json`` and
  the fleet-aggregated ``/capacity.json``;
- :mod:`~predictionio_tpu_torch.fleet.autoscaler` — the controller loop that
  closes the capacity loop: scrape → aggregate → hysteresis/cooldown →
  spawn or drain replica processes through the ``pio deploy`` machinery;
- :mod:`~predictionio_tpu_torch.fleet.federation` — fleet-wide telemetry
  fan-in: the router's federated ``/metrics`` (every replica's families
  merged with a ``replica`` label) and fleet ``/alerts.json``, so one
  scrape watches the whole fleet.
"""

from predictionio_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
    LocalProcessSpawner,
    ReplicaSpawner,
)
from predictionio_tpu_torch.fleet.federation import (
    federated_alerts,
    federated_costs,
    federated_metrics_text,
    scrape_replicas,
)
from predictionio_tpu_torch.fleet.membership import (
    FleetState,
    Replica,
    fleet_capacity,
)
from predictionio_tpu_torch.fleet.router import create_router_app

__all__ = [
    "Autoscaler",
    "AutoscalerPolicy",
    "FleetState",
    "LocalProcessSpawner",
    "Replica",
    "ReplicaSpawner",
    "create_router_app",
    "federated_alerts",
    "federated_costs",
    "federated_metrics_text",
    "fleet_capacity",
    "scrape_replicas",
]
