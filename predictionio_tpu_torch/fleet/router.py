"""The fleet router: a thin CPU-tier HTTP front end in front of N
prediction-server replicas.

Proxies ``POST /queries.json`` with:

- **entity affinity** — the query's joinable entity id (the same fields
  the quality joiner and the canary split key on) picks a home replica by
  rendezvous hashing (:meth:`FleetState.route_order`), so one user lands
  on one replica — any per-user device caches stay warm and the canary
  hash-split (computed from the same entity id inside each replica) is
  coherent fleet-wide;
- **per-replica circuit breakers** — a dead replica costs ~0 ms once its
  breaker opens; /readyz-driven ejection and re-admission ride the
  :class:`~predictionio_tpu_torch.fleet.membership.FleetState` prober;
- **deadline-bounded retry-elsewhere** — a transport failure or a 503
  shed from one replica retries on the next replica in the rendezvous
  order, as long as the request's ``X-Pio-Deadline`` budget has time left
  and the shared :class:`~predictionio_tpu_torch.resilience.retry.RetryBudget`
  has tokens (retries must not amplify an outage);
- **propagation** — ``X-Pio-Request-Id``, ``X-Pio-Trace-Id`` /
  ``X-Pio-Parent-Span`` (the forward runs under a ``fleet.forward`` span,
  so the replica's spans parent under the router hop and ``pio trace``
  shows the extra lane), and ``X-Pio-Deadline`` decremented by the budget
  already spent.  The answering replica is echoed in ``X-Pio-Replica``.

The router also serves ``GET /fleet.json`` (the membership registry), a
fleet-aggregated ``GET /capacity.json`` (sum max-QPS, min headroom, fleet
recommended replicas), a **federated** ``GET /metrics`` (every replica's
families merged with a ``replica`` label — fleet/federation.py; pass
``?local=1`` for the router's own process registry), and a fleet
``GET /alerts.json`` (every replica's firing/pending alerts replica-tagged
next to the router's own) so ``pio capacity --url <router>``,
``pio status --url <router>``, and one Prometheus scrape read the whole
fleet.
"""

from __future__ import annotations

import http.client
import logging
import threading
import time
from typing import Any

from predictionio_tpu_torch.fleet.membership import (
    REPLICA_HEADER,
    FleetState,
    Replica,
    fleet_capacity,
)
from predictionio_tpu_torch.obs.disttrace import propagation_headers
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.obs.logging import REQUEST_ID_HEADER, get_request_id
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.quality import DEFAULT_ENTITY_FIELDS
from predictionio_tpu_torch.obs.tracing import trace
from predictionio_tpu_torch.resilience.admission import AdmissionController
from predictionio_tpu_torch.resilience.deadline import DEADLINE_HEADER, remaining
from predictionio_tpu_torch.resilience.retry import RetryBudget
from predictionio_tpu_torch.server.httpd import (
    HTTPApp,
    Request,
    Response,
    error_response,
    json_response,
    key_matches,
    shed_response,
)

log = logging.getLogger("predictionio_tpu_torch.fleet")

#: replica response headers the router passes through to the client
_PASSTHROUGH_HEADERS = (
    "X-Pio-Engine-Instance",
    "X-Pio-Variant",
    "X-Pio-App",
    "X-Pio-Shed-Reason",
    "X-Pio-Degraded",
    "Retry-After",
)

#: transport-level failures that trigger retry-elsewhere
_NET_ERRORS = (
    http.client.HTTPException,
    ConnectionError,
    BrokenPipeError,
    TimeoutError,
    OSError,
)


class _ReplicaConnections:
    """Per-thread keep-alive connections to each replica: the router's
    serving threads are long-lived, so re-connecting per forward would pay
    a connect round trip per request."""

    #: drop a keep-alive connection idle longer than this before reuse
    _MAX_IDLE_S = 10.0

    def __init__(self):
        self._local = threading.local()

    def _pool(self) -> dict:
        pool = getattr(self._local, "pool", None)
        if pool is None:
            pool = {}
            self._local.pool = pool
        return pool

    def connection(
        self, replica: Replica, timeout: float
    ) -> http.client.HTTPConnection:
        pool = self._pool()
        entry = pool.get(replica.url)
        now = time.monotonic()
        if entry is not None and now - entry[1] > self._MAX_IDLE_S:
            self.drop(replica)
            entry = None
        if entry is None:
            trimmed = replica.url.split("://", 1)[-1]
            host, _, port = trimmed.partition(":")
            conn = http.client.HTTPConnection(
                host, int(port or 80), timeout=timeout
            )
            pool[replica.url] = (conn, now)
        else:
            conn = entry[0]
            pool[replica.url] = (conn, now)
        conn.timeout = timeout
        sock = getattr(conn, "sock", None)
        if sock is not None:
            sock.settimeout(timeout)
        return conn

    def drop(self, replica: Replica) -> None:
        entry = self._pool().pop(replica.url, None)
        if entry is not None:
            try:
                entry[0].close()
            except OSError:
                pass


def _payload_entity(payload: Any) -> str | None:
    """The joinable entity id of a query payload — the same fields the
    quality joiner and DeployedEngine.payload_entity key on, so router
    affinity, canary split, and feedback joins all agree on who 'the
    user' is."""
    if isinstance(payload, dict):
        for f in DEFAULT_ENTITY_FIELDS:
            v = payload.get(f)
            if v is not None:
                return str(v)
    return None


def _request_app(req: Any) -> str | None:
    """The tenant (app) a request names, if any: X-Pio-App header or
    ``?app=`` query."""
    headers = getattr(req, "headers", None) or {}
    for k, v in headers.items():
        if k.lower() == "x-pio-app" and v:
            return str(v)
    q = getattr(req, "query", None) or {}
    v = q.get("app")
    return str(v) if v else None


def create_router_app(
    fleet: FleetState,
    access_key: str | None = None,
    registry: MetricsRegistry | None = None,
    #: in-flight cap at the router's own admission gate (None = uncapped)
    max_inflight: int | None = None,
    #: default per-request budget, overridable via X-Pio-Deadline
    default_deadline_s: float | None = None,
    #: per-forward socket timeout (always additionally capped by the
    #: remaining deadline budget)
    forward_timeout_s: float = 10.0,
    #: distinct replicas tried per request (first + retries-elsewhere)
    max_attempts: int = 3,
    retry_budget: RetryBudget | None = None,
    autoscaler: Any | None = None,
    on_stop: Any | None = None,
    alerts: Any | None = None,
    incidents: Any | None = None,
) -> HTTPApp:
    """Build the router HTTPApp over a :class:`FleetState`.

    ``alerts`` (an AlertEvaluator over the router's registry — its default
    breaker rule watches the per-replica breakers) and ``incidents`` ride
    onto the observability surface; the federated ``/alerts.json`` always
    aggregates the replicas' evaluators, folding the router's own local
    snapshot in when one is attached."""
    from predictionio_tpu_torch.fleet.federation import (
        FederationCache,
        federated_alerts,
        federated_costs,
        federated_metrics_text,
        scrape_replicas,
    )
    from predictionio_tpu_torch.obs.http import PROMETHEUS_CONTENT_TYPE

    app = HTTPApp("router")
    app.default_deadline_s = default_deadline_s
    if max_inflight is not None:
        app.admission = AdmissionController(
            max_inflight, registry=registry or REGISTRY
        )
    app.fleet = fleet
    app.autoscaler = autoscaler
    reg = registry or REGISTRY
    budget = retry_budget if retry_budget is not None else RetryBudget()
    pool = _ReplicaConnections()

    m_forwards = reg.counter(
        "pio_router_forwards_total",
        "Requests forwarded to replicas, by replica and outcome",
        labelnames=("replica", "outcome"),
    )
    m_retries = reg.counter(
        "pio_router_retry_elsewhere_total",
        "Forwards retried on another replica, by trigger",
        labelnames=("reason",),
    )
    m_forward_seconds = reg.histogram(
        "pio_router_forward_seconds",
        "Router->replica forward latency (successful forwards)",
        labelnames=("replica",),
    )

    def _authorized(req: Request) -> bool:
        return access_key is None or key_matches(req, access_key)

    def _forward_once(
        replica: Replica, req: Request, deadline_left: float | None
    ) -> tuple[int, bytes, dict[str, str]]:
        """One router->replica round trip.  Raises a ``_NET_ERRORS`` member
        on transport failure (the retry-elsewhere trigger)."""
        headers = {"Content-Type": "application/json"}
        rid = get_request_id()
        if rid:
            headers[REQUEST_ID_HEADER] = rid
        headers.update(propagation_headers())
        # the tenant identity travels with the forward: the replica's
        # per-tenant gate needs to know WHO is asking, whichever replica
        # the rendezvous order lands on
        tenant_app = _request_app(req)
        if tenant_app:
            headers["X-Pio-App"] = tenant_app
        timeout = forward_timeout_s
        if deadline_left is not None:
            # decrement the forwarded budget by what this hop already
            # spent, and never sit in a socket past the client's deadline
            headers[DEADLINE_HEADER] = f"{max(deadline_left, 0.001):.6f}"
            timeout = max(min(timeout, deadline_left), 0.001)
        conn = pool.connection(replica, timeout)
        try:
            conn.request("POST", req.path, body=req.body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except _NET_ERRORS:
            pool.drop(replica)
            raise
        return resp.status, data, {k: v for k, v in resp.getheaders()}

    @app.route("POST", "/queries\\.json")
    def queries(req: Request) -> Response:
        try:
            payload = req.json()
            if not isinstance(payload, dict):
                raise ValueError("query must be a JSON object")
        except Exception as e:
            return error_response(400, f"invalid query: {e}")
        # affinity keys on (app, entity): two tenants sharing an entity id
        # space must NOT share per-user cache/canary homes — tenant A's
        # "user1" and tenant B's "user1" are different people
        entity = _payload_entity(payload)
        tenant_app = _request_app(req)
        affinity = (
            f"{tenant_app}|{entity}"
            if tenant_app and entity is not None
            else entity
        )
        order = fleet.route_order(affinity)
        if not order:
            return shed_response("no routable replicas", 1.0)
        last_shed: Response | None = None
        last_error: Exception | None = None
        attempts = 0
        for replica in order:
            if attempts >= max_attempts:
                break
            deadline_left = remaining()
            if deadline_left is not None and deadline_left <= 0:
                break  # the budget died mid-retry: answer 504 below
            br = replica.breaker
            if not br.allow():
                # open breaker: skip in ~0 ms, the next replica in the
                # rendezvous order is this entity's deterministic failover
                continue
            if attempts > 0 and not budget.try_spend():
                # a retry needs a budget token (retries must not amplify
                # an outage); the consumed half-open trial is returned
                br.release_trial()
                m_retries.labels("budget_exhausted").inc()
                break
            attempts += 1
            fleet.note_inflight(replica, +1)
            t0 = time.perf_counter()
            try:
                # the forward runs under its own span so the assembled
                # trace shows the router lane, with the replica's spans
                # parented under this hop (storage.remote's idiom)
                with trace("fleet.forward", record=False, ring=False) as sp:
                    sp.tags = {"replica": replica.replica_id}
                    status, data, rheaders = _forward_once(
                        replica, req, deadline_left
                    )
            except _NET_ERRORS as e:
                br.record_failure()
                fleet.note_forward_failure(replica)
                m_forwards.labels(replica.replica_id, "transport_error").inc()
                m_retries.labels("transport_error").inc()
                last_error = e
                continue
            finally:
                fleet.note_inflight(replica, -1)
            # an HTTP answer means the replica is alive, whatever the code
            br.record_success()
            fleet.note_forward_success(replica)
            if status == 503:
                # the replica shed: its queue/admission is full, not down.
                # Another replica may have room — retry elsewhere inside
                # the deadline budget.
                m_forwards.labels(replica.replica_id, "shed").inc()
                m_retries.labels("shed").inc()
                last_shed = _passthrough(status, data, rheaders, replica)
                continue
            budget.record_call()
            m_forwards.labels(replica.replica_id, "ok").inc()
            m_forward_seconds.labels(replica.replica_id).observe(
                time.perf_counter() - t0
            )
            return _passthrough(status, data, rheaders, replica)
        # every eligible replica failed, shed, or the budget ran out
        deadline_left = remaining()
        if deadline_left is not None and deadline_left <= 0:
            return error_response(
                504, "deadline exceeded while retrying across replicas"
            )
        if last_shed is not None:
            return last_shed
        return shed_response(
            f"no replica answered ({attempts} tried"
            + (f"; last error: {last_error}" if last_error else "")
            + ")",
            1.0,
        )

    def _passthrough(
        status: int, data: bytes, rheaders: dict[str, str], replica: Replica
    ) -> Response:
        resp = Response(
            status,
            data,
            content_type=rheaders.get("Content-Type")
            or rheaders.get("content-type")
            or "application/json; charset=utf-8",
        )
        for name in _PASSTHROUGH_HEADERS:
            v = rheaders.get(name) or rheaders.get(name.lower())
            if v:
                resp.headers[name] = v
        resp.headers[REPLICA_HEADER] = replica.replica_id
        return resp

    # -- fleet surfaces ------------------------------------------------------
    # registered BEFORE add_observability_routes so the fleet-aggregated
    # /capacity.json, /metrics, and /alerts.json win over the
    # process-local ones (first match routes)

    fed_cache = FederationCache()

    @app.route("GET", "/metrics")
    def federated_metrics(req: Request) -> Response:
        """The federated exposition: one scrape sees the fleet.  The
        process-local registry remains reachable via ``?local=1`` (and its
        families are folded into the federation as replica="router")."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        if req.query.get("local") in ("1", "true"):
            reg.history.sample(reg)
            return Response(
                200,
                reg.render_prometheus(),
                content_type=PROMETHEUS_CONTENT_TYPE,
            )

        def build() -> str:
            bodies, errors = scrape_replicas(fleet, "/metrics.json")
            return federated_metrics_text(
                bodies, errors, local_registry=reg, local_label="router"
            )

        return Response(
            200,
            fed_cache.get("metrics", build),
            content_type=PROMETHEUS_CONTENT_TYPE,
        )

    @app.route("GET", "/alerts\\.json")
    def federated_alerts_json(req: Request) -> Response:
        """Every replica's alert state, replica-tagged, in one body (the
        `pio status --url <router>` fold and the dashboard's fleet Alerts
        panel read this)."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")

        def build() -> dict:
            bodies, errors = scrape_replicas(fleet, "/alerts.json")
            return federated_alerts(
                bodies,
                errors,
                local_snapshot=(
                    alerts.snapshot() if alerts is not None else None
                ),
                local_label="router",
            )

        return json_response(200, fed_cache.get("alerts", build))

    @app.route("GET", "/costs\\.json")
    def federated_costs_json(req: Request) -> Response:
        """Every replica's cost ledger in one body: replica-tagged rows
        plus fleet-wide merged per-(app, route, variant) sums — the
        `pio costs --url <router>` and `pio top` fold."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")

        def build() -> dict:
            bodies, errors = scrape_replicas(fleet, "/costs.json")
            local = getattr(app, "costs", None)
            return federated_costs(
                bodies,
                errors,
                local_snapshot=(
                    local.snapshot() if local is not None else None
                ),
                local_label="router",
            )

        return json_response(200, fed_cache.get("costs", build))

    @app.route("GET", "/fleet\\.json")
    def fleet_json(req: Request) -> Response:
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        fleet.refresh()
        body = fleet.snapshot()
        if autoscaler is not None:
            body["autoscaler"] = autoscaler.snapshot()
        return json_response(200, body)

    @app.route("GET", "/capacity\\.json")
    def capacity_json(req: Request) -> Response:
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        # serve the cached scrape when fresh: the autoscaler (or a watch)
        # already fans out N replica calls on a cadence, and re-scraping
        # per request would block this handler thread for up to
        # N×probe_timeout on a hung replica
        return json_response(
            200,
            fleet_capacity(
                fleet, scrape=fleet.capacity_scrape_stale(max_age_s=5.0)
            ),
        )

    @app.route("POST", "/fleet/scale")
    def fleet_scale(req: Request) -> Response:
        """Operator override: pin the fleet size (the `pio fleet scale`
        target).  ``?replicas=N`` pins, ``?replicas=auto`` un-pins."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        if autoscaler is None:
            return json_response(
                501, {"message": "no autoscaler attached to this router"}
            )
        raw = req.query.get("replicas", "")
        if raw == "auto":
            autoscaler.set_target(None)
            return json_response(200, {"target": None, "mode": "auto"})
        try:
            n = int(raw)
            if n < 1:
                raise ValueError
        except ValueError:
            return json_response(
                400, {"message": "replicas must be a positive integer or 'auto'"}
            )
        autoscaler.set_target(n)
        return json_response(200, {"target": n, "mode": "pinned"})

    @app.route("POST", "/stop")
    def stop(req: Request) -> Response:
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        if on_stop is not None:
            threading.Thread(target=on_stop, daemon=True).start()
        return json_response(200, {"message": "Shutting down."})

    def _replicas_routable() -> bool:
        return len(fleet.routable()) > 0

    add_observability_routes(
        app,
        reg,
        access_key=access_key,
        readiness={"replicas_routable": _replicas_routable},
        alerts=alerts,
        incidents=incidents,
    )
    return app
