"""Fleet-wide telemetry federation: one scrape sees the whole fleet.

The router makes N replicas one *routing* domain; this module makes them
one *telemetry* domain, so a Prometheus scraper (or an operator's
``pio metrics --url``) need not know every replica URL, and an alert firing
on replica 3 is visible from the router.  The router aggregates its
replicas'

- ``GET /metrics`` — every replica's metric families merged into one
  Prometheus exposition with a ``replica`` label per series (the router's
  own families ride along as ``replica="router"``), plus a synthesized
  ``pio_federation_up{replica}`` gauge so a dead replica is a *visible
  zero*, not a silent absence;
- ``GET /alerts.json`` — per-replica alert evaluator states merged into
  one body: fleet-wide firing/pending totals, every non-ok instance tagged
  with its replica, per-replica summaries, and the router's own local
  alerts;
- ``GET /costs.json`` — every replica's cost ledger, replica-tagged, with
  the fleet-wide sums per (app, route, variant).

The text and JSON are the JAX package's byte for byte on the same replica
bodies.

Scrapes run concurrently with a bounded per-replica timeout, so one dead
replica costs its rows plus a named ``source_errors`` entry — never a
hang.  The router caches each aggregation like its ``/capacity.json``
scrape (:data:`CACHE_TTL_S`), so a tight external scrape loop cannot
amplify into N×QPS internal traffic.
"""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.fleet.membership import FleetState
from predictionio_tpu_torch.obs.metrics import (
    MetricsRegistry,
    _fmt,
    _labels_text,
)

#: how long a federated aggregation is served from cache (the same knob as
#: the router's /capacity.json scrape reuse)
CACHE_TTL_S = 5.0

#: per-replica fetch timeout — a dead replica costs one bounded wait
#: (fetches run concurrently, so the total wait is the slowest source)
FETCH_TIMEOUT_S = 3.0


def scrape_replicas(
    fleet: FleetState,
    path: str,
    timeout: float = FETCH_TIMEOUT_S,
) -> tuple[dict[str, Any], dict[str, str]]:
    """Fetch ``path`` from every non-draining replica concurrently.
    Returns ``({replica_id: parsed JSON body}, {replica_id: error})`` — a
    replica that is down, 401s, or answers garbage lands in the error map
    with its reason and is simply absent from the bodies (replica ids
    contain colons, so errors stay structured rather than string-joined)."""
    reps = [r for r in fleet.replicas() if not r.draining]
    bodies: dict[str, Any] = {}
    errors: dict[str, str] = {}
    if not reps:
        return bodies, errors

    def fetch(rep) -> Any:
        headers = {}
        if fleet.access_key:
            headers["Authorization"] = f"Bearer {fleet.access_key}"
        req = urllib.request.Request(rep.url + path, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode("utf-8"))

    with ThreadPoolExecutor(
        max_workers=min(len(reps), 8), thread_name_prefix="pio-federate"
    ) as pool:
        futures = [(rep, pool.submit(fetch, rep)) for rep in reps]
        for rep, fut in futures:
            try:
                bodies[rep.replica_id] = fut.result()
            except Exception as e:
                errors[rep.replica_id] = f"{type(e).__name__}: {e}"
    return bodies, errors


# ---------------------------------------------------------------------------
# /metrics federation


def _render_series(
    out: list[str],
    name: str,
    kind: str,
    labels: Mapping[str, str],
    series: Mapping[str, Any],
    bounds: list[float] | None,
) -> None:
    names = tuple(labels)
    values = tuple(str(v) for v in labels.values())
    base = _labels_text(names, values)
    if kind in ("counter", "gauge"):
        v = series.get("value")
        if isinstance(v, (int, float)):
            out.append(f"{name}{base} {_fmt(float(v))}")
        return
    counts = series.get("buckets")
    if not isinstance(counts, list) or bounds is None:
        return
    cum = 0
    for bound, c in zip(list(bounds) + [math.inf], counts):
        try:
            cum += int(c)
        except (TypeError, ValueError):
            return
        le = _labels_text(names + ("le",), values + (_fmt(float(bound)),))
        out.append(f"{name}_bucket{le} {cum}")
    out.append(f"{name}_sum{base} {repr(float(series.get('sum') or 0.0))}")
    out.append(f"{name}_count{base} {int(series.get('count') or 0)}")


def federated_metrics_text(
    bodies: Mapping[str, Mapping[str, Any]],
    errors: Mapping[str, str],
    local_registry: MetricsRegistry | None = None,
    local_label: str = "router",
) -> str:
    """Merge ``/metrics.json`` bodies into ONE Prometheus text exposition,
    every series gaining a ``replica`` label.  The local registry (the
    router's own forwards/retries/latency families) joins under
    ``local_label``; ``pio_federation_up{replica}`` reports 1 per scraped
    replica and 0 per failed one, and failures are also named in comment
    lines so a text-only scrape still shows WHICH source died."""
    merged: dict[str, dict[str, Any]] = {}

    def fold(replica: str, body: Mapping[str, Any]) -> None:
        for name, fam in body.items():
            if not isinstance(fam, Mapping):
                continue
            kind = fam.get("type")
            if kind not in ("counter", "gauge", "histogram"):
                continue
            entry = merged.setdefault(
                name,
                {
                    "type": kind,
                    "help": fam.get("help") or "",
                    "bounds": fam.get("bounds"),
                    "rows": [],
                },
            )
            if entry["type"] != kind:
                continue  # conflicting declarations: first replica wins
            if entry.get("bounds") is None and fam.get("bounds"):
                entry["bounds"] = fam.get("bounds")
            for s in fam.get("series") or ():
                labels = {"replica": replica}
                for k, v in (s.get("labels") or {}).items():
                    k = str(k)
                    if k == "replica":
                        # the router's own per-replica families (e.g.
                        # pio_router_forwards_total{replica=...}) must not
                        # clobber the federation label — the Prometheus
                        # federation idiom: exported_<label>
                        k = "exported_replica"
                    labels[k] = str(v)
                entry["rows"].append((labels, s))

    if local_registry is not None:
        fold(local_label, local_registry.render_json())
    for replica in sorted(bodies):
        fold(replica, bodies[replica])

    out: list[str] = []
    for rid in sorted(errors):
        out.append(f"# federation source error: {rid}: {errors[rid]}")
    out.append(
        "# HELP pio_federation_up Whether the last federated scrape of a "
        "replica succeeded"
    )
    out.append("# TYPE pio_federation_up gauge")
    for replica in sorted(bodies):
        out.append(f'pio_federation_up{{replica="{replica}"}} 1')
    for rid in sorted(errors):
        out.append(f'pio_federation_up{{replica="{rid}"}} 0')
    for name in sorted(merged):
        entry = merged[name]
        out.append(f"# HELP {name} {entry['help']}")
        out.append(f"# TYPE {name} {entry['type']}")
        for labels, series in entry["rows"]:
            _render_series(
                out, name, entry["type"], labels, series, entry.get("bounds")
            )
    return "\n".join(out) + "\n" if out else ""


# ---------------------------------------------------------------------------
# /alerts.json federation


def federated_alerts(
    bodies: Mapping[str, Mapping[str, Any]],
    errors: Mapping[str, str],
    local_snapshot: Mapping[str, Any] | None = None,
    local_label: str = "router",
) -> dict[str, Any]:
    """Merge ``/alerts.json`` bodies into one fleet body: every non-ok
    instance tagged with its replica, fleet-wide firing/pending totals,
    per-replica summaries (None for a replica whose scrape failed — its
    reason is in ``source_errors``), and the most recent transitions
    interleaved newest-first."""
    sources: list[tuple[str, Mapping[str, Any]]] = []
    if local_snapshot is not None:
        sources.append((local_label, local_snapshot))
    sources.extend((rid, bodies[rid]) for rid in sorted(bodies))
    alerts: list[dict[str, Any]] = []
    recent: list[dict[str, Any]] = []
    replicas: dict[str, dict[str, Any] | None] = {}
    for rid, body in sources:
        rows = body.get("alerts") or ()
        replicas[rid] = {
            "firing": int(body.get("firing") or 0),
            "pending": int(body.get("pending") or 0),
            "ticks": body.get("ticks"),
            "last_tick_at": body.get("last_tick_at"),
        }
        for a in rows:
            alerts.append({**a, "replica": rid})
        for e in body.get("recent") or ():
            recent.append({**e, "replica": rid})
    for rid in errors:
        replicas[rid] = None
    alerts.sort(
        key=lambda a: (
            0 if a.get("state") == "firing" else 1,
            -(a.get("age_s") or 0.0),
        )
    )
    recent.sort(key=lambda e: -(e.get("at") or 0.0))
    return {
        "fleet": True,
        "alerts": alerts,
        "firing": sum(1 for a in alerts if a.get("state") == "firing"),
        "pending": sum(1 for a in alerts if a.get("state") == "pending"),
        "recent": recent[:64],
        "replicas": replicas,
        "source_errors": [
            f"{rid}: {errors[rid]}" for rid in sorted(errors)
        ],
    }


# ---------------------------------------------------------------------------
# /costs.json federation


def federated_costs(
    bodies: Mapping[str, Mapping[str, Any]],
    errors: Mapping[str, str],
    local_snapshot: Mapping[str, Any] | None = None,
    local_label: str = "router",
) -> dict[str, Any]:
    """Merge ``/costs.json`` bodies into one fleet body: every replica's
    per-(app, route, variant) total rides replica-tagged in ``totals``
    (``pio costs`` renders them as ``app@replica``), and ``merged`` sums
    the same keys fleet-wide — the substrate a fleet-level quota or the
    ``cost_skew`` question "who costs what, anywhere" reads.  A replica
    whose scrape failed is named in ``source_errors`` and simply absent
    from the rows."""
    from predictionio_tpu_torch.obs.costs import COST_FIELDS

    sources: list[tuple[str, Mapping[str, Any]]] = []
    if local_snapshot is not None:
        sources.append((local_label, local_snapshot))
    sources.extend((rid, bodies[rid]) for rid in sorted(bodies))
    rows: list[dict[str, Any]] = []
    merged: dict[tuple[str, str, str], dict[str, float]] = {}
    replicas: list[str] = []
    budgets: dict[str, Any] = {"per_app": {}, "default_device_s_per_min": None}
    for rid, body in sources:
        replicas.append(rid)
        b = body.get("budgets") or {}
        budgets["per_app"].update(b.get("per_app") or {})
        if budgets["default_device_s_per_min"] is None:
            budgets["default_device_s_per_min"] = b.get(
                "default_device_s_per_min"
            )
        for row in body.get("totals") or ():
            rows.append({**row, "replica": rid})
            key = (
                str(row.get("app", "?")),
                str(row.get("route", "")),
                str(row.get("variant", "")),
            )
            agg = merged.setdefault(key, dict.fromkeys(COST_FIELDS, 0.0))
            for f in COST_FIELDS:
                try:
                    agg[f] += float(row.get(f, 0.0) or 0.0)
                except (TypeError, ValueError):
                    pass
    rows.sort(key=lambda r: -float(r.get("device_s", 0.0) or 0.0))
    merged_rows = [
        {"app": k[0], "route": k[1], "variant": k[2], **agg}
        for k, agg in sorted(
            merged.items(), key=lambda kv: -kv[1]["device_s"]
        )
    ]
    return {
        "fleet": True,
        "replicas": replicas,
        "totals": rows,
        "merged": merged_rows,
        "budgets": budgets,
        "source_errors": {rid: errors[rid] for rid in sorted(errors)},
    }


class FederationCache:
    """One cached aggregation per key, rebuilt at most every
    :data:`CACHE_TTL_S`, with SINGLE-FLIGHT rebuilds — the router's
    serving threads must never fan out N scrapes per external request,
    and k concurrent requests arriving at TTL expiry must run ONE build
    (the followers wait for the builder's result), not k×N internal
    fetches."""

    def __init__(
        self,
        ttl_s: float = CACHE_TTL_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._cache: dict[str, tuple[float, Any]] = {}
        #: per-key build mutex: held by the one thread rebuilding that key
        self._building: dict[str, threading.Lock] = {}

    def _fresh(self, key: str) -> tuple[bool, Any]:
        hit = self._cache.get(key)
        if hit is not None and self._clock() - hit[0] <= self.ttl_s:
            return True, hit[1]
        return False, None

    def get(self, key: str, build: Callable[[], Any]) -> Any:
        with self._lock:
            fresh, value = self._fresh(key)
            if fresh:
                return value
            gate = self._building.get(key)
            if gate is None:
                gate = self._building[key] = threading.Lock()
        # serialize builds per key OUTSIDE the cache lock (a build fans
        # out HTTP calls); a follower blocks here for at most one build,
        # then finds the builder's fresh entry
        with gate:
            with self._lock:
                fresh, value = self._fresh(key)
                if fresh:
                    return value
            value = build()  # raising leaves no entry: followers rebuild
            with self._lock:
                self._cache[key] = (self._clock(), value)
            return value
