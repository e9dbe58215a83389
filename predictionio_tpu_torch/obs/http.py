"""Observability routes for any :class:`HTTPApp`.

The JAX package's ``obs/http.py``.  ``add_observability_routes(app)``
wires the request-lifecycle surface onto a server, under the JAX package's
paths, status codes and JSON shapes:

  GET  /metrics             Prometheus text format 0.0.4 (runtime gauges are
                            re-sampled on each scrape)
  GET  /metrics.json        the JSON shape (adds p50/p95/p99 per histogram)
  GET  /traces.json         recent finished root spans (ring buffer)
  GET  /spans.json          cross-process span fragments (?trace_id=)
  GET  /logs.json           recent structured log records (?request_id=&
                            limit=&level=)
  GET  /debug/flight.json   flight recorder: N slowest + errored requests
  POST /debug/profile       start a torch.profiler capture (?seconds=N&dir=)
  GET  /debug/profile       capture status (running / last)
  GET  /debug/stacks.json   the continuous host stack sampler
  GET  /efficiency.json     device efficiency: achieved-vs-peak roofline per
                            entry point (CUDA-event kernel time over the
                            least-work cost), launch-shape accounting,
                            transfer tallies
  GET  /locks.json          runtime lock-order witness: executed lock-edge
                            set + observed inversions (PIO_LOCK_WITNESS=1;
                            {"enabled": false} otherwise)
  GET  /hotpath.json        solo-path host-stage attribution
  GET  /capacity.json       the headroom model
  GET  /explain.json        decision provenance: per-answer records of
                            which generation answered, through which engine
                            path and filters, with item ids + raw scores
                            (?request_id= for one)
  GET  /healthz             liveness — ALWAYS ungated (load balancers carry
                            no keys); advisory SLO status rides along
  GET  /readyz              readiness checks (model loaded, stores up, ...)
  GET  /slo.json            rolling-window SLO + burn rates

Not here yet, each with its module: ``/costs.json`` (``obs/costs.py``),
``/quality.json`` (``obs/quality.py``), ``/alerts.json`` and
``/incidents*`` (``obs/alerts.py``, ``obs/incident.py``),
``/tenants.json`` (tenancy), ``/shards.json`` (multi-device).

Auth: pass ``access_key`` to gate everything here except ``/healthz``; apps
with an app-level ``HTTPApp(access_key=...)`` gate these like every other
route, with ``/healthz`` registered as a public route that bypasses the
app-level key.  ``POST /debug/profile`` additionally REQUIRES some key to be
configured (route-level or app-level) — an anonymous client must never be
able to arm the profiler.

Both HTTP front ends call :func:`record_request_outcome` after each request
to feed the SLO tracker, the provenance ring and the flight recorder
(observability routes themselves are excluded so scrapes and probes don't
pollute the SLO window).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.obs.capacity import capacity_snapshot
from predictionio_tpu_torch.obs.device import device_snapshot
from predictionio_tpu_torch.obs.disttrace import FRAGMENTS, set_process_name
from predictionio_tpu_torch.obs.flight import FlightRecorder, current_annotations
from predictionio_tpu_torch.obs.logging import get_log_ring
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.profiler import (
    PROFILER,
    ProfilerBusy,
    ProfilerUnsupported,
    sample_runtime_gauges,
)
from predictionio_tpu_torch.obs.provenance import ProvenanceStore, finalize_record
from predictionio_tpu_torch.obs.sampling import SAMPLER
from predictionio_tpu_torch.obs.slo import SLOTracker, run_readiness
from predictionio_tpu_torch.obs.tracing import recent_traces

#: Prometheus text exposition content type.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: observability/probe paths excluded from SLO + flight accounting
_OBS_PATHS = frozenset(
    (
        "/metrics",
        "/metrics.json",
        "/traces.json",
        "/spans.json",
        "/logs.json",
        "/quality.json",
        "/efficiency.json",
        "/shards.json",
        "/hotpath.json",
        "/capacity.json",
        "/fleet.json",
        "/alerts.json",
        "/incidents.json",
        "/costs.json",
        "/eventstore.json",
        "/locks.json",
        "/explain.json",
        "/tenants.json",
        "/healthz",
        "/readyz",
        "/slo.json",
    )
)


def is_observability_path(path: str) -> bool:
    return (
        path in _OBS_PATHS
        or path.startswith("/debug/")
        or path.startswith("/incidents/")
    )


def record_request_outcome(app, req, resp, duration_s: float, span) -> None:
    """Feed the app's SLO tracker, provenance ring and flight recorder with
    one finished request.  Called by both HTTP front ends; cheap no-op for
    apps without observability routes and for the observability routes
    themselves."""
    if is_observability_path(req.path):
        return
    trace_id = getattr(span, "trace_id", None)
    slo: SLOTracker | None = getattr(app, "slo", None)
    if slo is not None:
        # the trace id rides along as the SLO-breach exemplar: one slow or
        # errored request links straight to its trace (and the request id,
        # to the decision's provenance record)
        slo.record(
            resp.status < 500,
            duration_s,
            trace_id=trace_id,
            request_id=getattr(span, "request_id", None),
        )
    provenance: ProvenanceStore | None = getattr(app, "provenance", None)
    if provenance is not None:
        # assemble the answer's decision record from the capture scope the
        # front end opened; the caller's telemetry guard means a capture
        # bug can never fail the request
        finalize_record(provenance, app.name, req, resp, duration_s, span)
    flight: FlightRecorder | None = getattr(app, "flight", None)
    if flight is None:
        return
    if resp.status < 500 and not flight.would_retain(duration_s):
        return  # fast path: skip span serialization for unremarkable wins
    entry: dict[str, Any] = {
        "request_id": span.request_id,
        "server": app.name,
        "method": req.method,
        "path": req.path,
        "status": resp.status,
        "duration_s": round(duration_s, 6),
        "payload_bytes": len(req.body or b""),
        "response_bytes": len(resp.encoded()[0]),
        "span": span.to_dict(),
    }
    if trace_id:
        entry["trace_id"] = trace_id
    ann = current_annotations()
    if ann:
        entry.update(ann)
    if resp.status >= 500:
        try:
            body = resp.body
            message = (
                body.get("message") if isinstance(body, dict) else None
            )
            entry["error"] = str(message if message is not None else body)[
                :500
            ]
        except Exception:
            entry["error"] = "unrenderable error body"
    flight.record(entry)


def add_observability_routes(
    app,
    registry: MetricsRegistry | None = None,
    access_key: str | None = None,
    readiness: Mapping[str, Callable[[], bool]] | None = None,
    slo: SLOTracker | None = None,
    flight: FlightRecorder | None = None,
    debug_routes: bool = True,
    hotpath: Any | None = None,
    provenance: ProvenanceStore | None = None,
):
    """The observability surface: metrics + logs + flight + profiler +
    health.  Installs ``app.slo`` / ``app.flight`` / ``app.provenance`` /
    ``app.readiness`` so the HTTP front ends can reach them.

    ``access_key`` gates every route here EXCEPT ``/healthz`` — on apps
    whose ``HTTPApp(access_key=...)`` already gates globally, ``/healthz``
    is registered public so load balancers can always probe liveness.

    ``debug_routes=False`` skips every route but the scrape surface
    (``/metrics``, ``/metrics.json``, ``/traces.json``, ``/spans.json``) and
    the health routes: servers that must stay open to anonymous clients
    (the event server's ingest port) expose the scrape surface but not log
    contents, error bodies, or an anonymous profiler trigger.

    ``hotpath`` (a :class:`~predictionio_tpu_torch.obs.hotpath.HotPathTracker`)
    installs ``app.hotpath`` and, on debug-route servers, serves the
    solo-path stage table at ``GET /hotpath.json``; a route whose object is
    not passed is not registered.  ``POST /debug/profile`` profiles CUDA
    activity when the app says its model lives on the card
    (``app.profile_cuda``), CPU activity only otherwise.
    """
    from predictionio_tpu_torch.server.httpd import (
        Request,
        Response,
        error_response,
        json_response,
        key_matches,
    )

    # name this process's trace fragments after its first server (a `pio
    # deploy` with an embedded event server stays "predictionserver")
    set_process_name(app.name)
    reg = registry or REGISTRY
    app.slo = slo or SLOTracker()
    # no flight recorder without its route: the event server's ingest path
    # must not pay per-request entry construction for records nothing serves
    app.flight = (flight or FlightRecorder()) if debug_routes else None
    # decision provenance, same contract: the ring exists exactly when its
    # /explain.json surface does
    app.provenance = (
        (provenance or ProvenanceStore()) if debug_routes else None
    )
    app.readiness = dict(readiness or {})
    if hotpath is not None:
        app.hotpath = hotpath
    ring = get_log_ring()

    original_route = app.route

    if access_key is not None:

        def route(method: str, pattern: str, public: bool = False):
            """Wrap handlers with the route-level key check (Bearer header
            or ?accessKey=), leaving public routes open."""
            def deco(fn):
                if public:
                    return original_route(method, pattern, public=True)(fn)

                def guarded(req: Request) -> Response:
                    if not key_matches(req, access_key):
                        return error_response(401, "Invalid accessKey.")
                    return fn(req)

                return original_route(method, pattern)(guarded)

            return deco

    else:
        route = original_route

    # -- metrics + traces (gated when a key is configured) -------------------
    def _prescrape() -> None:
        """Freshen scrape-time state: the runtime gauges (the card's memory,
        the transfer tallies), THEN the sparkline ring so it samples the
        refreshed numbers."""
        sample_runtime_gauges(reg)
        reg.history.sample(reg)

    @route("GET", "/metrics")
    def metrics(req: Request) -> Response:
        _prescrape()
        return Response(
            200,
            reg.render_prometheus(),
            content_type=PROMETHEUS_CONTENT_TYPE,
        )

    @route("GET", "/metrics\\.json")
    def metrics_json(req: Request) -> Response:
        _prescrape()
        return json_response(200, reg.render_json())

    @route("GET", "/traces\\.json")
    def traces_json(req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", 20))
        except ValueError:
            return json_response(400, {"message": "limit must be an integer"})
        return json_response(
            200, {"traces": recent_traces(min(max(limit, 0), 256))}
        )

    # -- cross-process span fragments ----------------------------------------
    # what a cross-process trace assembler fetches from every participating
    # daemon; gated like /traces.json
    @route("GET", "/spans\\.json")
    def spans_json(req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", 50))
        except ValueError:
            return json_response(400, {"message": "limit must be an integer"})
        return json_response(
            200,
            FRAGMENTS.snapshot(
                trace_id=req.query.get("trace_id"),
                limit=min(max(limit, 0), 256),
            ),
        )

    if not debug_routes:
        _add_health_routes(app, route)
        return app

    # -- structured log ring -------------------------------------------------
    @route("GET", "/logs\\.json")
    def logs_json(req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", 100))
        except ValueError:
            return json_response(400, {"message": "limit must be an integer"})
        records = ring.records(
            limit=min(max(limit, 0), 1024),
            request_id=req.query.get("request_id"),
            min_level=req.query.get("level"),
        )
        return Response(
            200,
            json.dumps({"logs": records}, default=str),
            content_type="application/json; charset=utf-8",
        )

    # -- device efficiency ---------------------------------------------------
    # debug-gated like the flight recorder: per-fn cost tables and storm
    # state describe the serving program, not the request — the event
    # server's anonymous ingest port must not leak them.  The time behind
    # each fn's share is the card's own (CUDA events), never a host wait
    @route("GET", "/efficiency\\.json")
    def efficiency_json(req: Request) -> Response:
        return json_response(200, device_snapshot())

    # -- runtime lock-order witness ------------------------------------------
    # the executed lock-edge set + any order inversions seen by the
    # LockWitness (PIO_LOCK_WITNESS=1); debug-gated like the flight
    # recorder — held-lock stacks describe the serving program's internals
    @route("GET", "/locks\\.json")
    def locks_json(req: Request) -> Response:
        from predictionio_tpu_torch.obs.contention import witness_snapshot

        return json_response(200, witness_snapshot())

    # -- solo-path host-stage attribution ------------------------------------
    if hotpath is not None:

        @route("GET", "/hotpath\\.json")
        def hotpath_json(req: Request) -> Response:
            return json_response(200, app.hotpath.snapshot())

    # -- capacity / headroom model -------------------------------------------
    # the autoscaling input: observed load vs the device + admission
    # ceilings, joined with SLO burn (obs/capacity.py)
    @route("GET", "/capacity\\.json")
    def capacity_json(req: Request) -> Response:
        return json_response(200, capacity_snapshot(app, reg))

    # -- continuous host stack sampler ---------------------------------------
    # always-available host profiling: the first request arms the process
    # sampler; subsequent requests read the running aggregation.
    # ``?reset=1`` clears the aggregation first (keeps sampling) so a
    # bounded capture reads a fresh N-second window instead of everything
    # since the sampler was armed.
    # Debug-gated like the flight recorder — stack contents describe the
    # program.
    @route("GET", "/debug/stacks\\.json")
    def stacks_json(req: Request) -> Response:
        SAMPLER.start()
        if req.query.get("reset") in ("1", "true"):
            SAMPLER.reset()
        fmt = req.query.get("format", "json")
        if fmt == "speedscope":
            return json_response(200, SAMPLER.speedscope())
        if fmt == "collapsed":
            return Response(
                200,
                SAMPLER.collapsed(),
                content_type="text/plain; charset=utf-8",
            )
        if fmt != "json":
            return json_response(
                400, {"message": "format must be json|collapsed|speedscope"}
            )
        body = SAMPLER.snapshot()
        body["collapsed"] = SAMPLER.collapsed()
        return json_response(200, body)

    # -- decision provenance -------------------------------------------------
    # per-answer decision records (generation, variant, cache, filters,
    # items + raw scores) — debug-gated like the flight recorder: records
    # name entities, payloads, and what they were answered
    @route("GET", "/explain\\.json")
    def explain_json(req: Request) -> Response:
        rid = req.query.get("request_id")
        if rid:
            rec = app.provenance.get(rid)
            if rec is None:
                return json_response(
                    404,
                    {
                        "message": f"no provenance record for request "
                        f"{rid!r} (ring capacity "
                        f"{app.provenance.capacity})"
                    },
                )
            return json_response(200, {"record": rec})
        limit = 50
        if "limit" in req.query:
            try:
                limit = int(req.query["limit"])
            except ValueError:
                return json_response(
                    400, {"message": "limit must be an integer"}
                )
        return json_response(
            200, app.provenance.snapshot(limit=min(max(limit, 0), 256))
        )

    # -- flight recorder -----------------------------------------------------
    @route("GET", "/debug/flight\\.json")
    def flight_json(req: Request) -> Response:
        limit = None
        if "limit" in req.query:
            try:
                limit = int(req.query["limit"])
            except ValueError:
                return json_response(
                    400, {"message": "limit must be an integer"}
                )
        snap = app.flight.snapshot(
            request_id=req.query.get("request_id"),
            trace_id=req.query.get("trace_id"),
            limit=limit,
        )
        return Response(
            200,
            json.dumps(snap, default=str),
            content_type="application/json; charset=utf-8",
        )

    # -- on-demand profiler --------------------------------------------------
    # arming a capture is privileged even on otherwise-open servers: without
    # ANY configured key (route-level or app-level), repeated anonymous
    # 300 s captures are a disk-fill + overhead DoS on the serving port
    profile_protected = access_key is not None or app.access_key is not None

    @route("POST", "/debug/profile")
    def profile_start(req: Request) -> Response:
        if not profile_protected:
            return json_response(
                403,
                {
                    "message": "profiling requires an access key; start the "
                    "server with an access key (--accesskey / --access-key "
                    "/ PIO_OBS_ACCESS_KEY) to enable /debug/profile"
                },
            )
        try:
            seconds = float(req.query.get("seconds", 5))
        except ValueError:
            return json_response(400, {"message": "seconds must be a number"})
        try:
            started = PROFILER.start(
                seconds,
                req.query.get("dir"),
                cuda=bool(getattr(app, "profile_cuda", False)),
            )
        except ValueError as e:
            return json_response(400, {"message": str(e)})
        except ProfilerBusy as e:
            return json_response(409, {"message": str(e)})
        except ProfilerUnsupported as e:
            # 501: the verb is understood, the profiler can't do it here
            # (CUPTI refused the card, or no device events were recorded)
            return json_response(501, {"message": str(e)})
        return json_response(202, started)

    @route("GET", "/debug/profile")
    def profile_status(req: Request) -> Response:
        return json_response(200, PROFILER.status())

    _add_health_routes(app, route)
    return app


def _add_health_routes(app, route) -> None:
    """/healthz (public), /readyz, /slo.json — shared by both the full and
    the no-debug-routes variants of the observability surface."""
    from predictionio_tpu_torch.server.httpd import Request, Response, json_response

    @route("GET", "/healthz", public=True)
    def healthz(req: Request) -> Response:
        return json_response(200, app.slo.healthz())

    @route("GET", "/readyz")
    def readyz(req: Request) -> Response:
        ready, results = run_readiness(app.readiness)
        return json_response(
            200 if ready else 503, {"ready": ready, "checks": results}
        )

    @route("GET", "/slo\\.json")
    def slo_json(req: Request) -> Response:
        # the JAX package adds its circuit breakers' states here; the port
        # has no breaker until its remote storage backend
        return json_response(200, app.slo.snapshot())
