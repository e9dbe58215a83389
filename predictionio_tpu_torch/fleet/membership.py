"""Fleet membership: who the replicas are, which of them are routable, and
what each one last said about its own capacity.

:class:`FleetState` is the one registry the router and the autoscaler both
read.  Per replica it tracks:

- **health** — a ``/readyz`` prober (daemon thread, test-driven
  :meth:`FleetState.probe_once`) ejects a replica after
  ``eject_after`` consecutive failed probes and re-admits it on the first
  healthy one, so a crashed replica stops receiving traffic within one
  probe interval and a revived one rejoins without operator action;
- **breaker state** — each replica gets a process-global
  :class:`~predictionio_tpu_torch.resilience.breaker.CircuitBreaker`
  (``replica:<url>``), tripped by the router's forwarding failures:
  ejection-by-breaker reacts in milliseconds, the prober in seconds;
- **in-flight count** — router-side concurrent forwards, for /fleet.json
  and the dashboard panel;
- **capacity** — the last ``/capacity.json`` scrape, the autoscaler's
  input (:func:`fleet_capacity` aggregates them fleet-wide).

Replica affinity is rendezvous (highest-random-weight) hashing over the
same md5 hash family as
:func:`~predictionio_tpu_torch.data.storage.base.entity_shard` — the
HBEventsUtil row-key hash the canary split and the event-store scan
sharding already key on, so the port's order is the JAX package's order,
entity for entity.  One entity consistently lands on one replica
(keeping any per-user device caches warm), membership changes only move
the keys of the replicas that changed, and because the canary split hashes
the same entity id *inside* each replica, canary assignment is coherent
fleet-wide no matter which replica answers.

The membership source is a static URL list, refreshable from a file
(``PIO_FLEET_FILE``: JSON list or one URL per line — re-read when its
mtime changes) or the ``PIO_FLEET_REPLICAS`` comma list.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Iterable, Mapping

from predictionio_tpu_torch.data.storage.base import entity_shard
from predictionio_tpu_torch.obs.capacity import TARGET_UTILIZATION
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.resilience.breaker import CircuitBreaker, get_breaker

log = logging.getLogger("predictionio_tpu_torch.fleet")

#: rendezvous-hash score space (any large modulus works; this one keeps the
#: md5-derived scores comfortably away from collisions at fleet sizes)
_HASH_SPACE = 1 << 31

#: response header naming the replica that answered a routed request
REPLICA_HEADER = "X-Pio-Replica"


def replica_id_of(url: str) -> str:
    """A compact stable id for a replica URL (host:port)."""
    trimmed = url.split("://", 1)[-1].rstrip("/")
    return trimmed


class Replica:
    """One replica's registry record.  All fields are guarded by the owning
    :class:`FleetState`'s lock; reads for display go through
    :meth:`FleetState.snapshot`."""

    def __init__(self, url: str, breaker: CircuitBreaker):
        self.url = url.rstrip("/")
        self.replica_id = replica_id_of(url)
        self.breaker = breaker
        #: /readyz verdict; a fresh replica starts routable so a static
        #: fleet works before the first probe completes
        self.healthy = True
        #: quiesced by the autoscaler: routing stops, in-flight work drains
        self.draining = False
        self.consecutive_probe_failures = 0
        self.ejections_total = 0
        self.inflight = 0
        self.last_probe_at: float | None = None
        self.last_probe_error: str | None = None
        self.last_capacity: dict | None = None
        self.last_capacity_at: float | None = None

    def routable(self) -> bool:
        return self.healthy and not self.draining and self.breaker.state != "open"


class FleetState:
    """The replica registry: membership + health + capacity, one lock.

    ``start()`` runs the /readyz prober on a daemon thread; tests drive
    :meth:`probe_once` / :meth:`scrape_capacity_once` directly (the
    LifecycleController idiom).
    """

    def __init__(
        self,
        replicas: Iterable[str] = (),
        name: str = "fleet",
        registry: MetricsRegistry | None = None,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 2.0,
        eject_after: int = 2,
        source_file: str | None = None,
        access_key: str | None = None,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 2.0,
    ):
        self.name = name
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.eject_after = max(int(eject_after), 1)
        self.source_file = source_file
        self.access_key = access_key
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._rr = 0  # round-robin cursor for entity-less queries
        self._last_capacity_scrape_at: float | None = None
        self._source_mtime: float | None = None
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._stopping = False
        reg = registry or REGISTRY
        self._m_replicas = reg.gauge(
            "pio_fleet_replicas",
            "Fleet replica counts by state",
            labelnames=("state",),
        )
        self._m_ejections = reg.counter(
            "pio_fleet_ejections_total",
            "Replicas ejected from routing by the /readyz prober",
            labelnames=("replica",),
        )
        for url in replicas:
            self._add_locked_free(url)
        self._update_gauges()

    @classmethod
    def from_env(
        cls, env: Mapping[str, str] | None = None, **kwargs: Any
    ) -> "FleetState":
        """Build from ``PIO_FLEET_REPLICAS`` (comma-separated URLs) and/or
        ``PIO_FLEET_FILE`` (JSON list or one-URL-per-line; re-read on
        mtime change by :meth:`refresh`)."""
        e = env or os.environ
        urls = [
            u.strip()
            for u in e.get("PIO_FLEET_REPLICAS", "").split(",")
            if u.strip()
        ]
        kwargs.setdefault("source_file", e.get("PIO_FLEET_FILE") or None)
        fleet = cls(urls, **kwargs)
        fleet.refresh()
        return fleet

    # -- membership ----------------------------------------------------------

    def _add_locked_free(self, url: str) -> Replica:
        """Create the record WITHOUT holding the lock (get_breaker locks
        internally); callers insert under the lock."""
        url = url.rstrip("/")
        breaker = get_breaker(
            f"replica:{replica_id_of(url)}",
            failure_threshold=self._breaker_threshold,
            reset_timeout_s=self._breaker_reset_s,
        )
        rep = Replica(url, breaker)
        with self._lock:
            existing = self._replicas.get(url)
            if existing is not None:
                return existing
            self._replicas[url] = rep
        return rep

    def add(self, url: str) -> Replica:
        rep = self._add_locked_free(url)
        self._update_gauges()
        return rep

    def remove(self, url: str) -> None:
        with self._lock:
            self._replicas.pop(url.rstrip("/"), None)
        self._update_gauges()

    def set_replicas(self, urls: Iterable[str]) -> None:
        """Reconcile membership to exactly ``urls`` (file/env refresh):
        new URLs join, missing ones leave, existing records keep their
        health/breaker history."""
        want = {u.rstrip("/") for u in urls if u.strip()}
        with self._lock:
            have = set(self._replicas)
        for url in want - have:
            self._add_locked_free(url)
        with self._lock:
            for url in have - want:
                self._replicas.pop(url, None)
        self._update_gauges()

    def refresh(self) -> bool:
        """Re-read the source file when its mtime changed; True when
        membership was reconciled.  A file we cannot read or parse keeps
        the CURRENT membership (and keeps retrying: the mtime is only
        recorded after a successful apply) — a half-written or malformed
        file must never be applied as a full fleet drain."""
        path = self.source_file
        if not path:
            return False
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return False
        with self._lock:
            if self._source_mtime == mtime:
                return False
        try:
            text = open(path, encoding="utf-8").read()
        except OSError as e:
            log.warning("fleet source file %s unreadable: %s", path, e)
            return False
        try:
            parsed = json.loads(text)
            if not isinstance(parsed, list) or not all(
                isinstance(u, str) for u in parsed
            ):
                log.warning(
                    "fleet source file %s is JSON but not a list of URL "
                    "strings; keeping current membership", path,
                )
                return False
            urls = parsed
        except ValueError:
            urls = [ln.strip() for ln in text.splitlines() if ln.strip()]
        self.set_replicas(urls)
        with self._lock:
            self._source_mtime = mtime
        log.info("fleet membership refreshed from %s: %d replicas", path, len(urls))
        return True

    # -- reads ---------------------------------------------------------------

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def get(self, url: str) -> Replica | None:
        with self._lock:
            return self._replicas.get(url.rstrip("/"))

    def routable(self) -> list[Replica]:
        with self._lock:
            return [r for r in self._replicas.values() if r.routable()]

    def active_count(self) -> int:
        """Replicas the autoscaler counts as 'current size': everything
        not already draining (an unhealthy replica is still fleet capacity
        being paid for — the autoscaler must not double-spawn over a blip)."""
        with self._lock:
            return sum(1 for r in self._replicas.values() if not r.draining)

    def route_order(self, entity: str | None) -> list[Replica]:
        """Routing order for one query: rendezvous hashing over the
        ``entity_shard`` md5 family — descending score, so the head is the
        entity's home replica and the tail is the deterministic failover
        order (retry-elsewhere walks it).  Entity-less queries rotate
        round-robin (nothing to be affine to)."""
        reps = self.routable()
        if len(reps) <= 1:
            return reps
        if entity:
            return sorted(
                reps,
                key=lambda r: entity_shard(
                    f"pio_fleet:{r.replica_id}", str(entity), _HASH_SPACE
                ),
                reverse=True,
            )
        with self._lock:
            self._rr += 1
            i = self._rr % len(reps)
        return reps[i:] + reps[:i]

    # -- router-side accounting ----------------------------------------------

    def note_inflight(self, replica: Replica, delta: int) -> None:
        with self._lock:
            replica.inflight = max(replica.inflight + delta, 0)

    def quiesce(self, url: str) -> Replica | None:
        """Stop routing to a replica (the first half of a drain); returns
        the record so the caller can wait on its in-flight work."""
        with self._lock:
            rep = self._replicas.get(url.rstrip("/"))
            if rep is not None:
                rep.draining = True
        self._update_gauges()
        return rep

    # -- probing -------------------------------------------------------------

    def _fetch_json(self, url: str, timeout: float) -> tuple[int, Any]:
        headers = {}
        if self.access_key:
            headers["Authorization"] = f"Bearer {self.access_key}"
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read().decode("utf-8"))
            except ValueError:
                return e.code, None

    def probe_once(self) -> dict[str, bool]:
        """One /readyz pass over the whole fleet; returns {url: healthy}.
        Ejection needs ``eject_after`` consecutive failures (one flaky
        probe must not flap routing); re-admission is immediate — a
        replica that answers ready IS ready."""
        out: dict[str, bool] = {}
        for rep in self.replicas():
            ok = False
            err: str | None = None
            try:
                status, _body = self._fetch_json(
                    rep.url + "/readyz", self.probe_timeout_s
                )
                ok = status == 200
                if not ok:
                    err = f"/readyz answered {status}"
            except Exception as e:  # unreachable / refused / timeout
                err = f"unreachable: {e}"
            now = time.monotonic()
            with self._lock:
                rep.last_probe_at = now
                rep.last_probe_error = err
                if ok:
                    if not rep.healthy:
                        log.info("replica %s re-admitted", rep.replica_id)
                    rep.consecutive_probe_failures = 0
                    rep.healthy = True
                    # a ready answer is positive proof of liveness: close
                    # the replica's breaker NOW instead of waiting out its
                    # reset window — "a replica that answers ready IS
                    # ready" must hold for routable(), not just healthy
                    rep.breaker.reset()
                else:
                    rep.consecutive_probe_failures += 1
                    if (
                        rep.healthy
                        and rep.consecutive_probe_failures >= self.eject_after
                    ):
                        rep.healthy = False
                        rep.ejections_total += 1
                        self._m_ejections.labels(rep.replica_id).inc()
                        log.warning(
                            "replica %s ejected (%s)", rep.replica_id, err
                        )
            out[rep.url] = ok
        self._update_gauges()
        return out

    def note_forward_success(self, replica: Replica) -> None:
        """The router got an HTTP answer from the replica: it is alive.
        Resets the failure streak so interleaved transient transport
        errors can never accumulate to an ejection."""
        with self._lock:
            replica.consecutive_probe_failures = 0
        self._update_gauges()

    def note_forward_failure(self, replica: Replica) -> None:
        """The router saw a transport failure: count it like a probe
        failure so a corpse is ejected by traffic even between probes (the
        breaker already stops routing in the meantime).  Ejection here
        requires the prober loop to be RUNNING — only a healthy probe
        re-admits, so without one (static/bench fleets) a couple of
        transient errors would eject a live replica forever; in that mode
        the breaker alone governs, and it recovers on its own through
        half-open trials."""
        with self._lock:
            replica.consecutive_probe_failures += 1
            prober_running = self._thread is not None
            if (
                prober_running
                and replica.healthy
                and replica.consecutive_probe_failures >= self.eject_after
            ):
                replica.healthy = False
                replica.ejections_total += 1
                self._m_ejections.labels(replica.replica_id).inc()
                log.warning(
                    "replica %s ejected (forward failures)", replica.replica_id
                )
        self._update_gauges()

    def scrape_capacity_once(self) -> dict[str, dict | None]:
        """One /capacity.json pass over the healthy replicas — the
        autoscaler's input.  A failed scrape clears nothing: the last
        snapshot stays (staleness is visible via last_capacity_at)."""
        out: dict[str, dict | None] = {}
        for rep in self.replicas():
            with self._lock:
                skip = not rep.healthy
            if skip:
                out[rep.url] = None
                continue
            body: dict | None = None
            try:
                status, payload = self._fetch_json(
                    rep.url + "/capacity.json", self.probe_timeout_s
                )
                if status == 200 and isinstance(payload, dict):
                    body = payload
            except Exception as e:
                log.debug("capacity scrape of %s failed: %s", rep.replica_id, e)
            if body is not None:
                with self._lock:
                    rep.last_capacity = body
                    rep.last_capacity_at = time.monotonic()
            out[rep.url] = body
        with self._lock:
            self._last_capacity_scrape_at = time.monotonic()
        return out

    def capacity_scrape_stale(self, max_age_s: float) -> bool:
        """True when no scrape pass finished within ``max_age_s`` — lets a
        serving-path reader (the router's /capacity.json) reuse the cached
        reports instead of re-fanning N HTTP calls per request while an
        autoscaler or watcher already scrapes on a cadence."""
        with self._lock:
            at = self._last_capacity_scrape_at
        return at is None or time.monotonic() - at > max_age_s

    # -- the probe loop ------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="pio-fleet-prober", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            thread = self._thread
            self._thread = None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
            try:
                self.refresh()
                self.probe_once()
            except Exception:
                log.exception("fleet probe pass failed")
            self._wake.wait(self.probe_interval_s)
            self._wake.clear()

    # -- exposition ----------------------------------------------------------

    def _update_gauges(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
            healthy = sum(1 for r in reps if r.healthy and not r.draining)
            ejected = sum(1 for r in reps if not r.healthy)
            draining = sum(1 for r in reps if r.draining)
        self._m_replicas.labels("healthy").set(healthy)
        self._m_replicas.labels("ejected").set(ejected)
        self._m_replicas.labels("draining").set(draining)

    def capacity_reports(self) -> list[tuple[Replica, dict | None]]:
        """(replica, last /capacity.json body) pairs, read under the lock —
        the :func:`fleet_capacity` input."""
        with self._lock:
            return [(r, r.last_capacity) for r in self._replicas.values()]

    def snapshot(self) -> dict[str, Any]:
        """The /fleet.json body."""
        rows = []
        with self._lock:
            for r in self._replicas.values():
                cap = r.last_capacity or {}
                rows.append({
                    "replica": r.replica_id,
                    "url": r.url,
                    "healthy": r.healthy,
                    "draining": r.draining,
                    "routable": r.routable(),
                    "breaker": r.breaker.state,
                    "inflight": r.inflight,
                    "consecutive_probe_failures": r.consecutive_probe_failures,
                    "ejections_total": r.ejections_total,
                    "last_probe_error": r.last_probe_error,
                    "capacity": {
                        "max_sustainable_qps": cap.get("max_sustainable_qps"),
                        "headroom_frac": cap.get("headroom_frac"),
                        "recommended_replicas": cap.get("recommended_replicas"),
                        "scale_hint": cap.get("scale_hint"),
                    }
                    if cap
                    else None,
                })
        return {
            "name": self.name,
            "replicas": rows,
            "total": len(rows),
            "healthy": sum(1 for r in rows if r["healthy"] and not r["draining"]),
            "routable": sum(1 for r in rows if r["routable"]),
            "source_file": self.source_file,
        }


def fleet_capacity(fleet: FleetState, scrape: bool = True) -> dict[str, Any]:
    """The fleet-aggregated ``/capacity.json`` body: sum of the replica
    ceilings, the worst (minimum) headroom, and a fleet-level recommended
    replica count — what ``pio capacity --url <router>`` reads and the
    autoscaler acts on.

    Fleet sizing: ``ceil(total observed QPS / (TARGET_UTILIZATION × mean
    per-replica ceiling))`` — the per-replica ``recommended_replicas``
    assumes that replica's OWN load continues, which under a balanced
    router is total/N, so summing or maxing them would mis-size the fleet.
    A replica whose SLO is burning adds one (the same escape hatch the
    single-replica model uses).
    """
    if scrape:
        fleet.scrape_capacity_once()
    per_replica: dict[str, dict | None] = {}
    ceilings: list[float] = []
    observed: list[float] = []
    headrooms: list[float] = []
    burning = False
    caveats: list[str] = []
    for rep, cap in fleet.capacity_reports():
        per_replica[rep.replica_id] = (
            {
                "max_sustainable_qps": cap.get("max_sustainable_qps"),
                "observed_qps": (cap.get("inputs") or {}).get("observed_qps"),
                "headroom_frac": cap.get("headroom_frac"),
                "recommended_replicas": cap.get("recommended_replicas"),
                "scale_hint": cap.get("scale_hint"),
            }
            if cap
            else None
        )
        if not cap:
            caveats.append(f"no capacity scrape from {rep.replica_id} yet")
            continue
        if isinstance(cap.get("max_sustainable_qps"), (int, float)):
            ceilings.append(float(cap["max_sustainable_qps"]))
        obs = (cap.get("inputs") or {}).get("observed_qps")
        if isinstance(obs, (int, float)):
            observed.append(float(obs))
        if isinstance(cap.get("headroom_frac"), (int, float)):
            headrooms.append(float(cap["headroom_frac"]))
        if cap.get("scale_hint") == "up" and cap.get("headroom_frac") is None:
            burning = True  # burn-only scale signal (no computable ceiling)
        inputs = cap.get("inputs") or {}
        if (
            max(
                inputs.get("error_burn_rate", 0.0) or 0.0,
                inputs.get("latency_burn_rate", 0.0) or 0.0,
            )
            > 1.0
        ):
            burning = True
    total_ceiling = sum(ceilings) if ceilings else None
    total_observed = sum(observed) if observed else None
    min_headroom = min(headrooms) if headrooms else None
    recommended = None
    if ceilings and total_observed is not None:
        import math

        mean_ceiling = total_ceiling / len(ceilings)
        recommended = max(
            1,
            math.ceil(total_observed / (TARGET_UTILIZATION * mean_ceiling)),
        )
        if burning:
            recommended += 1
    scale_hint = "unknown"
    n_active = fleet.active_count()
    if burning or (min_headroom is not None and min_headroom <= 0.0):
        scale_hint = "up"
    elif recommended is not None:
        if recommended < n_active and (
            min_headroom is None or min_headroom > 1.0 - TARGET_UTILIZATION
        ):
            scale_hint = "hold_or_down"
        else:
            scale_hint = "hold"
    return {
        "fleet": {
            "name": fleet.name,
            "replicas": len(per_replica),
            "active": n_active,
            "routable": len(fleet.routable()),
            "per_replica": per_replica,
        },
        "inputs": {
            "observed_qps": (
                round(total_observed, 3) if total_observed is not None else None
            ),
            "replicas_reporting": len(ceilings),
        },
        "ceilings_qps": (
            {"fleet": round(total_ceiling, 3)} if total_ceiling is not None else {}
        ),
        "binding_ceiling": "fleet" if total_ceiling is not None else None,
        "max_sustainable_qps": (
            round(total_ceiling, 3) if total_ceiling is not None else None
        ),
        "headroom_frac": (
            round(min_headroom, 4) if min_headroom is not None else None
        ),
        "recommended_replicas": recommended,
        "scale_hint": scale_hint,
        "target_utilization": TARGET_UTILIZATION,
        "caveats": caveats,
    }
