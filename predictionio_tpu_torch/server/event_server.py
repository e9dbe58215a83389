"""Event collection REST server (:7070).

The port of the JAX package's ``server/event_server.py``, with route
parity with data/api/EventServer.scala:

  GET  /                       liveness {"status": "alive"}
  POST /events.json            insert one event -> 201 {"eventId"}
  GET  /events.json            query (startTime/untilTime/entityType/entityId/
                               event/targetEntityType/targetEntityId/limit/
                               reversed; default limit 20)
  GET  /events/<id>.json       fetch by id
  DELETE /events/<id>.json     delete by id
  POST /batch/events.json      <=50 events, per-item status list
  GET  /plugins.json           registered plugins
  GET  /plugins/<type>/<name>/...  a plugin's own REST handler
  GET  /stats.json             hourly counters (requires --stats)
  POST/GET /webhooks/<w>.json  JSON webhook connectors (segmentio)
  POST/GET /webhooks/<w>.form  form webhook connectors (mailchimp)

Auth mirrors EventServer.scala:92-130: ``accessKey`` query param (with
optional ``channel`` name) or HTTP Basic Authorization whose username is the
key.  An access key with a non-empty ``events`` list only accepts those event
names (403 otherwise).

Every route that writes the event store passes the ingest gate first: past
``max_write_inflight`` writes in flight it answers 503 + ``Retry-After``
(``pio_shed_total{reason="eventstore"}``).  A store that raises
``RemoteStorageError`` (a storage daemon down, or its circuit breaker
open), ``ConnectionError`` or ``TimeoutError`` answers 503 +
``Retry-After`` too.
Accepted events count in ``pio_events_ingested_total{event}``.

The observability routes are the JAX package's (``obs.http``): without an
operator key only the scrape surface (``/metrics``, ``/metrics.json``,
``/traces.json``, ``/spans.json``) and the health routes (``/healthz``,
``/readyz`` probing the event and metadata stores, ``/slo.json``) answer,
unauthenticated; with ``obs_access_key`` (or ``PIO_OBS_ACCESS_KEY``) the
debug routes exist too and the key gates everything but ``/healthz``.
The server never touches the card: a scrape creates no CUDA context.

Each insert passes the ``eventstore.write`` fault seam first
(``resilience.faults``).  Each accepted event whose name is a feedback
event (``PIO_FEEDBACK_EVENTS``, default rate/buy/click/like/view/
conversion) is joined back to a logged prediction of the quality monitor
(``obs.quality``; the process default, which a ``deploy --event-port``
shares with its prediction server): by the ``X-Pio-Request-Id`` the client
echoed, then by the event's ``prId`` or ``pioRequestId`` property, then by
entity within the join window.

Ingest bills the per-app cost ledger (``obs.costs``; the process default,
which a ``deploy --event-port`` shares with its prediction server): every
authenticated call runs under a bound ``RequestCost`` keyed
``app:<id>`` / route / ``ingest``, so the parquet log's storage reads bill
to the calling app, and a shed before auth bills the ``unknown`` row.
"""

from __future__ import annotations

import base64
import os
from dataclasses import dataclass
from typing import Any

from predictionio_tpu_torch.data.datamap import parse_event_time
from predictionio_tpu_torch.data.event import Event, EventValidationError
from predictionio_tpu_torch.data.storage.base import EventFilter
from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage
from predictionio_tpu_torch.data.storage.remote_backend import RemoteStorageError
from predictionio_tpu_torch.data.webhooks import (
    ConnectorException,
    form_connectors,
    json_connectors,
    to_event,
)
from predictionio_tpu_torch.obs.costs import (
    CostLedger,
    default_ledger,
    request_cost,
)
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.obs.logging import get_request_id
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.quality import QualityMonitor, default_quality
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.resilience.admission import AdmissionController
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    error_response,
    json_response,
    shed_response,
)
from predictionio_tpu_torch.server.plugins import PluginContext
from predictionio_tpu_torch.server.stats import HourlyStats


@dataclass
class AuthData:
    """Resolved access key (EventServer.scala AuthData)."""

    app_id: int
    channel_id: int | None
    events: tuple[str, ...]


class AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


#: event-store failures that mean "temporarily unavailable, retry later":
#: ingest answers 503 + Retry-After, so SDK clients back off and retry
#: instead of dropping events (a storage daemon's ``StorageUnavailable``
#: carries the breaker's reset hint as ``retry_after_s``)
_STORE_UNAVAILABLE = (RemoteStorageError, ConnectionError, TimeoutError)

#: past this many distinct event names, new names count under "_other":
#: names are client-supplied and registry children are never evicted
_MAX_EVENT_LABELS = 100


def _unavailable_response(e: Exception) -> Response:
    return shed_response(
        f"event store unavailable: {e}", getattr(e, "retry_after_s", 1.0)
    )


def _authenticate(storage: StorageRuntime, req: Request) -> AuthData:
    key = req.query.get("accessKey")
    if key is None:
        header = req.headers.get("Authorization", "")
        if header.startswith("Basic "):
            try:
                decoded = base64.b64decode(header[len("Basic "):]).decode()
            except Exception:
                raise AuthError(401, "Invalid accessKey.") from None
            key = decoded.strip().split(":")[0]
        else:
            raise AuthError(401, "Missing accessKey.")
    k = storage.access_keys().get(key)
    if k is None:
        raise AuthError(401, "Invalid accessKey.")
    channel_id = None
    channel = req.query.get("channel")
    if channel is not None:
        by_name = {
            c.name: c.id for c in storage.channels().get_by_appid(k.appid)
        }
        if channel not in by_name:
            raise AuthError(401, f"Invalid channel '{channel}'.")
        channel_id = by_name[channel]
    return AuthData(app_id=k.appid, channel_id=channel_id, events=tuple(k.events))


def create_event_server_app(
    storage: StorageRuntime | None = None,
    stats: bool = False,
    plugins: PluginContext | None = None,
    registry: MetricsRegistry | None = None,
    max_write_inflight: int | None = None,
    obs_access_key: str | None = None,
    quality: QualityMonitor | None = None,
    #: the per-app cost ledger: None = the process default on the default
    #: registry, so a single-process deploy bills ingest and serving into
    #: one rollup
    costs: CostLedger | None = None,
) -> HTTPApp:
    """The event server's routes over ``storage`` (default: the process
    storage).  ``max_write_inflight`` bounds the event-store writes in
    flight (default ``PIO_EVENT_MAX_INFLIGHT`` or 256; 0 = no bound).
    ``obs_access_key`` (default ``PIO_OBS_ACCESS_KEY``) opens the debug
    observability routes behind that key.  ``quality`` is the monitor
    feedback events join (default: the process default on the default
    registry, else a monitor of the given registry's own)."""
    storage = storage or get_storage()
    app = HTTPApp("eventserver")
    hourly = HourlyStats() if stats else None
    levents = storage.l_events()
    plugins = plugins or PluginContext.from_env()
    registry = registry or REGISTRY
    if quality is None:
        quality = (
            default_quality()
            if registry is REGISTRY
            else QualityMonitor(registry=registry)
        )
    # the cost ledger bills ingest by access-key app id; id-bearing paths
    # collapse so ledger keys stay low-cardinality
    if costs is None:
        costs = (
            default_ledger()
            if registry is REGISTRY
            else CostLedger(registry=registry)
        )
    app.costs = costs

    def _cost_route(path: str) -> str:
        path = path.split("?", 1)[0]
        if path.startswith("/events/"):
            return "/events/*.json"
        if path.startswith("/webhooks/"):
            return "/webhooks/*"
        return path

    if max_write_inflight is None:
        try:
            max_write_inflight = int(os.environ.get("PIO_EVENT_MAX_INFLIGHT", 256))
        except ValueError:
            max_write_inflight = 256
    ingest_gate = (
        AdmissionController(
            max_write_inflight, registry=registry, reason="eventstore"
        )
        if max_write_inflight and max_write_inflight > 0
        else None
    )

    def gated_write(handler):
        """503 + Retry-After while the write queue is full; applied to every
        route that writes the event store, before auth, so a slow store
        sheds before its writes pile up as blocked handler threads."""

        def wrapped(req: Request) -> Response:
            if ingest_gate is None:
                return handler(req)
            if not ingest_gate.try_acquire():
                # shed before auth: no app identity yet, so the ledger
                # carries it under the shared "unknown" row
                costs.note_shed("unknown", _cost_route(req.path), "ingest")
                return shed_response(
                    "event-store write queue saturated; retry later",
                    ingest_gate.retry_after_s,
                )
            try:
                return handler(req)
            finally:
                ingest_gate.release()

        return wrapped

    m_ingested = registry.counter(
        "pio_events_ingested_total",
        "Events accepted by the event server, by event name",
        labelnames=("event",),
    )

    def authed(handler):
        def wrapped(req: Request) -> Response:
            try:
                auth = _authenticate(storage, req)
            except AuthError as e:
                return error_response(e.status, str(e))
            except _STORE_UNAVAILABLE as e:
                # the key lookup needs the metadata store: down -> retryable
                return _unavailable_response(e)
            # every authenticated call runs under a bound RequestCost, so
            # the parquet log's note_storage_read bills its reads to the
            # calling app
            with request_cost(
                f"app:{auth.app_id}",
                _cost_route(req.path),
                "ingest",
                ledger=costs,
            ):
                return handler(req, auth)

        return wrapped

    seen_event_labels: set[str] = set()

    def bookkeep(auth: AuthData, status: int, event: Event) -> None:
        name = event.event
        if name not in seen_event_labels:
            if len(seen_event_labels) >= _MAX_EVENT_LABELS:
                name = "_other"
            else:
                seen_event_labels.add(name)
        m_ingested.labels(name).inc()
        if quality.is_feedback(event.event):
            # the join key preference order: the X-Pio-Request-Id the
            # client echoed on this ingest call (bound to the request
            # context by the front end), then the event's own prId /
            # pioRequestId, then entity id within the join window
            quality.observe_feedback(
                event, request_id=get_request_id(), app=auth.app_id
            )
        if hourly is not None:
            hourly.update(
                auth.app_id,
                status,
                event.entity_type,
                event.target_entity_type,
                event.event,
            )

    def _store_seam(app_id: int) -> None:
        """The ``eventstore.write`` fault seam, checked before each insert
        with the write's ingest-gate slot held: a latency rule stalls
        exactly like a slow store; raising kinds surface as the store
        being down (``ConnectionError``/``TimeoutError`` -> 503)."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("eventstore.write", str(app_id))

    def insert(auth: AuthData, event: Event) -> Response:
        """Plugins, then the store, then the books: the single-event
        routes' shared tail."""
        try:
            plugins.process_input(auth.app_id, auth.channel_id, event)
        except Exception as e:  # an input blocker rejected the event
            return error_response(403, f"rejected by plugin: {e}")
        try:
            _store_seam(auth.app_id)
            event_id = levents.insert(event, auth.app_id, auth.channel_id)
        except _STORE_UNAVAILABLE as e:
            return _unavailable_response(e)
        bookkeep(auth, 201, event)
        return json_response(201, {"eventId": event_id})

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        return json_response(200, {"status": "alive"})

    # -- single event CRUD ---------------------------------------------------
    @app.route("POST", "/events\\.json")
    @gated_write
    @authed
    def post_event(req: Request, auth: AuthData) -> Response:
        try:
            payload = req.json()
            if not isinstance(payload, dict):
                raise EventValidationError("request body must be a JSON object")
            event = Event.from_api_dict(payload)
        except EventValidationError as e:
            return error_response(400, str(e))
        except Exception as e:
            return error_response(400, f"invalid JSON: {e}")
        if auth.events and event.event not in auth.events:
            return error_response(403, f"{event.event} events are not allowed")
        return insert(auth, event)

    @app.route("GET", "/events\\.json")
    @authed
    def get_events(req: Request, auth: AuthData) -> Response:
        q = req.query
        reversed_ = q.get("reversed", "false").lower() == "true"
        if reversed_ and not (q.get("entityType") and q.get("entityId")):
            return error_response(
                400,
                "the parameter reversed can only be used with both entityType "
                "and entityId specified.",
            )
        try:
            filt = EventFilter(
                start_time=(
                    parse_event_time(q["startTime"]) if "startTime" in q else None
                ),
                until_time=(
                    parse_event_time(q["untilTime"]) if "untilTime" in q else None
                ),
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=(q["event"],) if "event" in q else None,
                target_entity_type=q.get("targetEntityType"),
                target_entity_id=q.get("targetEntityId"),
                limit=int(q.get("limit", 20)),
                reversed=reversed_,
            )
        except Exception as e:
            return error_response(400, str(e))
        events = list(levents.find(auth.app_id, auth.channel_id, filt))
        if not events:
            return error_response(404, "Not Found")
        return json_response(200, [e.to_api_dict() for e in events])

    @app.route("GET", "/events/(?P<event_id>[^/]+)\\.json")
    @authed
    def get_event(req: Request, auth: AuthData) -> Response:
        e = levents.get(req.params["event_id"], auth.app_id, auth.channel_id)
        if e is None:
            return error_response(404, "Not Found")
        return json_response(200, e.to_api_dict())

    @app.route("DELETE", "/events/(?P<event_id>[^/]+)\\.json")
    @gated_write
    @authed
    def delete_event(req: Request, auth: AuthData) -> Response:
        found = levents.delete(req.params["event_id"], auth.app_id, auth.channel_id)
        if found:
            return json_response(200, {"message": "Found"})
        return error_response(404, "Not Found")

    # -- batch ---------------------------------------------------------------
    @app.route("POST", "/batch/events\\.json")
    @gated_write
    @authed
    def post_batch(req: Request, auth: AuthData) -> Response:
        try:
            payload = req.json()
        except Exception as e:
            return error_response(400, f"invalid JSON: {e}")
        if not isinstance(payload, list):
            return error_response(400, "request body must be a JSON array")
        if len(payload) > 50:
            return error_response(
                400,
                "Batch request must have less than or equal to 50 events",
            )
        results: list[dict[str, Any]] = []
        for item in payload:
            try:
                event = Event.from_api_dict(item)
            except Exception as e:
                # any undeserializable item -> per-item 400, batch still 200
                results.append({"status": 400, "message": str(e)})
                continue
            if auth.events and event.event not in auth.events:
                results.append(
                    {
                        "status": 403,
                        "message": f"{event.event} events are not allowed",
                    }
                )
                continue
            try:
                plugins.process_input(auth.app_id, auth.channel_id, event)
            except Exception as e:
                results.append(
                    {"status": 403, "message": f"rejected by plugin: {e}"}
                )
                continue
            try:
                _store_seam(auth.app_id)
                event_id = levents.insert(event, auth.app_id, auth.channel_id)
            except _STORE_UNAVAILABLE as e:
                # per-item 503: one status per event, and a store that is
                # down is retryable, not a 500
                results.append({"status": 503, "message": str(e)})
                continue
            except Exception as e:
                results.append({"status": 500, "message": str(e)})
                continue
            bookkeep(auth, 201, event)
            results.append({"status": 201, "eventId": event_id})
        return json_response(200, results)

    # -- plugins (EventServer.scala:154-206) ---------------------------------
    @app.route("GET", "/plugins\\.json")
    @authed
    def list_plugins(req: Request, auth: AuthData) -> Response:
        return json_response(200, {"plugins": plugins.descriptions()})

    @app.route(
        "GET",
        "/plugins/(?P<ptype>[^/]+)/(?P<pname>[^/]+)(?P<rest>/.*)?",
    )
    @authed
    def plugin_rest(req: Request, auth: AuthData) -> Response:
        return plugins.rest_response(
            req.params["ptype"], req.params["pname"],
            req.params.get("rest") or "/", req.query,
        )

    # -- stats ---------------------------------------------------------------
    @app.route("GET", "/stats\\.json")
    @authed
    def get_stats(req: Request, auth: AuthData) -> Response:
        if hourly is None:
            return error_response(
                404,
                "To see stats, launch Event Server with --stats argument.",
            )
        return json_response(200, hourly.get(auth.app_id))

    # -- webhooks ------------------------------------------------------------
    _json_connectors = json_connectors()
    _form_connectors = form_connectors()

    def _unsupported(web: str) -> Response:
        return error_response(404, f"webhooks connection for {web} is not supported.")

    @app.route("POST", "/webhooks/(?P<web>[^/]+)\\.json")
    @gated_write
    @authed
    def post_webhook_json(req: Request, auth: AuthData) -> Response:
        connector = _json_connectors.get(req.params["web"])
        if connector is None:
            return _unsupported(req.params["web"])
        try:
            payload = req.json()
            if not isinstance(payload, dict):
                raise ConnectorException("payload must be a JSON object")
            event = to_event(connector, payload)
        except ConnectorException as e:
            return error_response(400, str(e))
        except Exception as e:
            return error_response(400, f"invalid JSON: {e}")
        return insert(auth, event)

    @app.route("GET", "/webhooks/(?P<web>[^/]+)\\.json")
    @authed
    def get_webhook_json(req: Request, auth: AuthData) -> Response:
        if req.params["web"] not in _json_connectors:
            return _unsupported(req.params["web"])
        return json_response(200, {"message": "Ok"})

    @app.route("POST", "/webhooks/(?P<web>[^/]+)\\.form")
    @gated_write
    @authed
    def post_webhook_form(req: Request, auth: AuthData) -> Response:
        connector = _form_connectors.get(req.params["web"])
        if connector is None:
            return _unsupported(req.params["web"])
        try:
            event = to_event(connector, req.form())
        except ConnectorException as e:
            return error_response(400, str(e))
        except UnicodeDecodeError as e:
            return error_response(400, f"invalid form body: {e}")
        return insert(auth, event)

    @app.route("GET", "/webhooks/(?P<web>[^/]+)\\.form")
    @authed
    def get_webhook_form(req: Request, auth: AuthData) -> Response:
        if req.params["web"] not in _form_connectors:
            return _unsupported(req.params["web"])
        return json_response(200, {"message": "Ok"})

    def _event_store_ready() -> bool:
        # live probe, not a captured handle: run_readiness treats a raise
        # as not-ready, so a backend that dies after startup flips /readyz
        return storage.l_events() is not None

    def _metadata_ready() -> bool:
        storage.access_keys().get("__readyz_probe__")
        return True

    # Without an operator key, only the scrape surface and health are
    # exposed, unauthenticated like GET / — scrapers and load balancers
    # carry no per-app access keys, and the registry holds no event
    # payloads.  The debug surface (/logs.json, /debug/flight.json,
    # /debug/profile ...) leaks log lines and error bodies and arms the
    # profiler, so on this anonymous-facing ingest port it only exists
    # behind an operator key, which then gates everything but /healthz.
    obs_access_key = obs_access_key or os.environ.get("PIO_OBS_ACCESS_KEY")
    add_observability_routes(
        app,
        registry,
        access_key=obs_access_key,
        debug_routes=obs_access_key is not None,
        readiness={
            "event_store": _event_store_ready,
            "metadata_store": _metadata_ready,
        },
        quality=quality,
        costs=costs,
    )
    return app


def create_event_server(
    host: str = "0.0.0.0",
    port: int = 7070,
    storage: StorageRuntime | None = None,
    stats: bool = False,
    plugins: PluginContext | None = None,
) -> AppServer:
    """Bind the event server on the threaded front end
    (EventServer.createEventServer:528); port 0 takes a free port
    (``server.port``)."""
    return AppServer(
        create_event_server_app(storage, stats=stats, plugins=plugins), host, port
    )
