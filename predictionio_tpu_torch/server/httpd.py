"""Minimal threaded HTTP routing layer shared by both front ends.

The JAX package's ``server/httpd.py`` request/response model
(``Request``, ``Response``, ``HTTPApp``), its admission and deadline
wiring (``admit_request``, ``request_budget``, ``exception_response``:
``LoadShed`` and the circuit breaker's ``CircuitOpen`` -> 503 +
Retry-After, ``DeadlineExceeded`` -> 504) and its
thread-per-connection front end (``AppServer``).  The asyncio front end
(``server/aio.py``) routes through the same ``HTTPApp.match`` and
``auth_error``, and handles each request inside the same
``RequestScope``, so the two cannot drift: a request id
(``X-Pio-Request-Id``, adopted or minted), admission, the deadline, the
adopted trace context, one unrecorded root span and the
flight-annotation and provenance scopes; its outcome feeds the SLO
tracker, the provenance ring and the flight recorder
(``obs.http.record_request_outcome``).
Handlers are plain functions, so route logic is testable without sockets.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import ssl
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping
from urllib.parse import parse_qs, unquote, urlsplit

from predictionio_tpu_torch.obs.disttrace import (
    TRACE_ID_HEADER,
    adopt_trace_context,
    bind_fragments,
    bind_parent_span,
    reset_fragments,
    reset_parent_span,
)
from predictionio_tpu_torch.obs.flight import begin_annotations, end_annotations
from predictionio_tpu_torch.obs.http import (
    is_observability_path,
    record_request_outcome,
)
from predictionio_tpu_torch.obs.logging import (
    REQUEST_ID_HEADER,
    new_request_id,
    reset_request_context,
    set_request_context,
)
from predictionio_tpu_torch.obs.provenance import (
    begin_capture,
    end_capture,
    wants_deep,
)
from predictionio_tpu_torch.obs.tracing import trace
from predictionio_tpu_torch.resilience import LoadShed
from predictionio_tpu_torch.resilience.breaker import CircuitOpen
from predictionio_tpu_torch.resilience.deadline import (
    DEADLINE_HEADER,
    DeadlineExceeded,
    deadline_scope,
    parse_budget,
)


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: Mapping[str, str]
    body: bytes = b""
    #: named groups captured from the route pattern
    params: dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> dict[str, str]:
        """The urlencoded form body, first value of each field."""
        data = parse_qs(self.body.decode("utf-8"), keep_blank_values=True)
        return {k: v[0] for k, v in data.items()}


@dataclass
class Response:
    status: int = 200
    body: Any = None  # dict/list -> JSON; str -> text/html; bytes raw
    content_type: str | None = None
    headers: dict[str, str] = field(default_factory=dict)

    def encoded(self) -> tuple[bytes, str]:
        # memoized: the observability layer measures response_bytes and the
        # front end then encodes for the wire — JSON-serializing a large
        # prediction body twice per request would be measurable
        cached = getattr(self, "_encoded_cache", None)
        if cached is not None:
            return cached
        if isinstance(self.body, bytes):
            out = self.body, self.content_type or "application/octet-stream"
        elif isinstance(self.body, str):
            out = self.body.encode("utf-8"), self.content_type or (
                "text/html; charset=utf-8"
            )
        else:
            out = (
                json.dumps(self.body).encode("utf-8"),
                self.content_type or "application/json; charset=utf-8",
            )
        self._encoded_cache = out
        return out


Handler = Callable[[Request], Response]


def unquote_groups(m: re.Match) -> dict[str, str]:
    """Percent-decode captured route params AFTER matching, so an encoded
    '/' (%2F) stays inside one segment."""
    return {
        k: (unquote(v) if v is not None else v) for k, v in m.groupdict().items()
    }


def json_response(status: int, body: Any) -> Response:
    return Response(status=status, body=body)


def error_response(status: int, message: str) -> Response:
    return Response(status=status, body={"message": message})


def shed_response(message: str, retry_after_s: float = 1.0) -> Response:
    """503 with a ``Retry-After`` hint — the load-shedding answer: back off
    and retry, rather than queue behind a saturated server."""
    resp = error_response(503, message)
    resp.headers["Retry-After"] = str(max(int(math.ceil(retry_after_s)), 1))
    return resp


def exception_response(e: Exception) -> Response:
    """Map a handler exception to its HTTP shape: deadline errors are 504,
    shed and breaker rejections are 503 + Retry-After, anything else is
    500.  Shared by both front ends and ``HTTPApp.handle``."""
    if isinstance(e, DeadlineExceeded):
        return error_response(504, f"deadline exceeded: {e}")
    if isinstance(e, (LoadShed, CircuitOpen)):
        return shed_response(str(e), e.retry_after_s)
    return error_response(500, f"{type(e).__name__}: {e}")


def header_get(headers: Mapping[str, str] | None, name: str) -> str:
    """Case-tolerant header lookup: the threaded server hands out an
    email.Message (case-insensitive), the aio front end a lower-cased dict,
    and tests pass plain dicts."""
    if not headers:
        return ""
    return headers.get(name) or headers.get(name.lower()) or ""


def request_budget(app: "HTTPApp", req: Request) -> float | None:
    """The request's time budget in seconds: the ``X-Pio-Deadline`` header
    when present (malformed values are ignored, not 500s), else the
    request's tenant's deadline default (stamped on ``req`` by the
    admission gate), else the server's ``default_deadline_s`` (None = no
    deadline)."""
    budget = parse_budget(header_get(req.headers, DEADLINE_HEADER))
    if budget is None:
        tenant = getattr(req, "tenant", None)
        if tenant is not None and tenant.default_deadline_s is not None:
            budget = tenant.default_deadline_s
        else:
            budget = getattr(app, "default_deadline_s", None)
    return budget


def _record_slo_failure(app: "HTTPApp") -> None:
    """Admission rejections (sheds, expired budgets) are user-visible
    failures: they must burn SLO error budget so overload pages someone."""
    slo = getattr(app, "slo", None)
    if slo is not None:
        slo.record(False, 0.0)


class _CompositeRelease:
    """Release both the server-wide admission slot and the per-tenant one
    in one ``release()``: what ``admit_request`` hands the front ends when
    a tenant registry is configured."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = [p for p in parts if p is not None]

    def release(self) -> None:
        for p in self._parts:
            p.release()


def admit_request(app: "HTTPApp", req: Request | None = None):
    """The admission gate shared by both front ends: the server-wide
    in-flight cap, then (when ``app.tenants`` is a ``TenantRegistry`` and
    the request is given) the per-tenant gate: its quota token bucket and
    its in-flight cap, shed with ``reason=tenant_quota`` /
    ``tenant_inflight`` before the query reaches the micro-batcher.

    Returns ``(releaser, None)`` when admitted (``releaser`` is what the
    caller must ``release()`` in its finally; None when no cap is
    configured) or ``(None, 503 shed response)`` when rejected: past a
    cap, shedding now is cheaper for everyone than queueing into a
    timeout."""
    adm = getattr(app, "admission", None)
    if adm is not None and not adm.try_acquire():
        _record_slo_failure(app)
        return None, shed_response(
            "server over capacity; retry later", adm.retry_after_s
        )
    tenants = getattr(app, "tenants", None)
    if tenants is None or req is None:
        return adm, None
    tenant, releaser, shed = tenants.gate(req)
    if shed is not None:
        # the tenant's own SLO burned inside gate(); the server-wide SLO
        # does not burn for a per-tenant shed, so one flooding tenant
        # cannot page the whole replica
        if adm is not None:
            adm.release()
        return None, shed
    return _CompositeRelease(adm, releaser), None


def admission_expired_response(app: "HTTPApp") -> Response:
    """504 for a request whose budget was already gone at admission —
    answering now beats doing work nobody will read."""
    _record_slo_failure(app)
    return error_response(504, "deadline expired at admission")


def presented_key(req: Request) -> str:
    """The access key a request presents: ``Authorization: Bearer <key>``
    preferred, ``?accessKey=`` kept for dashboard-link parity."""
    auth = header_get(req.headers, "Authorization")
    if auth.startswith("Bearer "):
        return auth[len("Bearer "):]
    return req.query.get("accessKey", "")


def key_matches(req: Request, key: str) -> bool:
    """Constant-time check of the presented key against ``key``."""
    import hmac

    # bytes, not str: compare_digest raises TypeError on non-ASCII str
    return hmac.compare_digest(
        presented_key(req).encode("utf-8"), key.encode("utf-8")
    )


class HTTPApp:
    """Route table: (method, compiled path regex) -> handler.

    ``access_key``, when set, gates every route not registered
    ``public=True`` behind the presented key (401 otherwise).  Servers with
    per-route key checks leave it unset.
    """

    def __init__(self, name: str = "server", access_key: str | None = None):
        self.name = name
        self.access_key = access_key
        self._routes: list[tuple[str, re.Pattern, Handler]] = []

    def route(self, method: str, pattern: str, public: bool = False):
        """Register a handler; ``pattern`` is a path regex with named groups,
        anchored at both ends.  ``public=True`` exempts the route from the
        app-level ``access_key`` gate."""
        compiled = re.compile("^" + pattern + "$")

        def deco(fn: Handler) -> Handler:
            if public:
                fn._pio_public = True  # type: ignore[attr-defined]
            self._routes.append((method.upper(), compiled, fn))
            return fn

        return deco

    def match(self, req: Request) -> tuple[Handler | None, re.Match | None, int]:
        """Resolve a request to (handler, match, status): status is 200 when
        a handler matched, else the 404/405 to answer with."""
        path_matched = False
        for method, pattern, fn in self._routes:
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            return fn, m, 200
        return None, None, 405 if path_matched else 404

    def auth_error(self, req: Request, fn: Handler | None) -> Response | None:
        """App-level key gate for a resolved handler; public routes bypass
        it.  None means authorized (or no key configured)."""
        if self.access_key is None:
            return None
        if fn is not None and getattr(fn, "_pio_public", False):
            return None
        if key_matches(req, self.access_key):
            return None
        return error_response(401, "Invalid accessKey.")

    def handle(self, req: Request) -> Response:
        fn, m, status = self.match(req)
        denied = self.auth_error(req, fn)
        if denied is not None:
            return denied
        if fn is None:
            return error_response(
                status, "Method Not Allowed" if status == 405 else "Not Found"
            )
        req.params = unquote_groups(m)
        try:
            return fn(req)
        except Exception as e:  # the exceptionHandler analog
            return exception_response(e)


class RequestScope:
    """One request's lifecycle, shared by both front ends (``with`` around
    the handler call; the handler itself, sync or awaited, stays with each
    front end).  Entering mints or adopts the request id, admits the
    request, binds its deadline budget, adopts the trace headers, and
    opens the logging context, the parent span, the flight-annotation and
    the provenance scopes; ``early`` is then the answer that skips the
    handler (503 shed, 504 budget already spent) or ``None``.  The handler
    runs inside :meth:`handling` (the deadline and one unrecorded root
    span) and hands its response to ``resp``; :meth:`finish` feeds
    ``record_request_outcome`` and stamps ``X-Pio-Request-Id`` and
    ``X-Pio-Trace-Id``.  Observability and probe paths skip everything but
    the request id, so scrapes never pollute the trace ring or the SLO
    window.

    Cross-process span fragments (``/spans.json``) are kept for requests
    whose caller sent ``X-Pio-Trace-Id`` (``disttrace.bind_fragments``).
    A request that opened no trace still answers ``X-Pio-Trace-Id`` (its
    request id), and its trace id still tags its log records, SLO exemplar
    and flight entry."""

    __slots__ = (
        "app", "req", "rid", "t0", "observed", "early", "resp", "span",
        "tid", "_budget", "_adm", "_tokens",
    )

    def __init__(self, app: "HTTPApp", req: Request):
        self.app = app
        self.req = req
        self.t0 = time.perf_counter()
        self.rid = header_get(req.headers, REQUEST_ID_HEADER) or new_request_id()
        self.observed = not is_observability_path(req.path)
        self.early: Response | None = None
        self.resp: Response | None = None
        self.span = None
        self.tid: str | None = None
        self._budget: float | None = None
        self._adm = None
        self._tokens: tuple | None = None

    def __enter__(self) -> "RequestScope":
        if not self.observed:
            return self
        self._adm, self.early = admit_request(self.app, self.req)
        if self.early is not None:
            return self
        req = self.req
        self._budget = request_budget(self.app, req)
        self.tid, parent_span = adopt_trace_context(req.headers, self.rid)
        joined = bool((header_get(req.headers, TRACE_ID_HEADER) or "").strip())
        self._tokens = (
            set_request_context(self.rid, self.tid),
            bind_parent_span(parent_span),
            bind_fragments(joined),
            begin_annotations(),
            # decision provenance: cheap capture always, deep on X-Pio-Explain
            begin_capture(deep=wants_deep(req.headers)),
        )
        if self._budget is not None and self._budget <= 0:
            self.early = admission_expired_response(self.app)
        return self

    @contextlib.contextmanager
    def handling(self):
        """The handler's block: the request's deadline and its root span
        (tagged with the status of ``resp``, which the block sets)."""
        if not self.observed:
            yield
            return
        with deadline_scope(budget_s=self._budget):
            with trace(f"http.{self.app.name}", record=False) as span:
                self.span = span
                yield
                span.tags = {
                    "method": self.req.method,
                    "path": self.req.path,
                    "status": self.resp.status,
                }

    def finish(self) -> Response:
        """The answer, accounted and stamped (call inside the ``with``)."""
        resp = self.early or self.resp
        if self.span is not None:
            try:
                record_request_outcome(
                    self.app, self.req, resp,
                    time.perf_counter() - self.t0, self.span,
                )
            except Exception:  # telemetry must never fail the request
                pass
        resp.headers.setdefault(REQUEST_ID_HEADER, self.rid)
        if self.tid is not None:
            resp.headers.setdefault(TRACE_ID_HEADER, self.tid)
        return resp

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._adm is not None:
            self._adm.release()
        if self._tokens is not None:
            request, parent, fragments, annotations, capture = self._tokens
            end_capture(capture)
            end_annotations(annotations)
            reset_fragments(fragments)
            reset_parent_span(parent)
            reset_request_context(request)


def observe_request(
    app: HTTPApp, req: Request, call: Callable[[Request], Response]
) -> Response:
    """The threaded front end's request: ``call`` inside one
    :class:`RequestScope` (the asyncio front end awaits its handler inside
    the same scope)."""
    with RequestScope(app, req) as scope:
        if scope.early is None:
            with scope.handling():
                scope.resp = call(req)
        return scope.finish()


def _make_handler_class(app: HTTPApp):
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = f"predictionio-tpu-torch/{app.name}"
        # the headers and the body go out as two writes: with Nagle's
        # algorithm the body waits for the client's delayed ACK of the
        # headers, ~40 ms per request on a keep-alive connection
        disable_nagle_algorithm = True

        def _dispatch(self, method: str) -> None:
            split = urlsplit(self.path)
            q = parse_qs(split.query, keep_blank_values=True)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            req = Request(
                method=method,
                path=split.path,
                query={k: v[0] for k, v in q.items()},
                headers=self.headers,
                body=body,
            )
            resp = observe_request(app, req, app.handle)
            payload, ctype = resp.encoded()
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def do_PUT(self):
            self._dispatch("PUT")

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return _Handler


def server_ssl_context(
    certfile: str | None = None, keyfile: str | None = None
) -> ssl.SSLContext | None:
    """The TLS context of a front end: PEM files given, else
    ``PIO_SSL_CERTFILE`` / ``PIO_SSL_KEYFILE`` from the environment (the
    reference's SSLConfiguration, SSLConfiguration.scala:28, with PEM files
    in place of a JKS keystore); None, plain HTTP, when no certificate is
    named."""
    certfile = certfile or os.environ.get("PIO_SSL_CERTFILE")
    keyfile = keyfile or os.environ.get("PIO_SSL_KEYFILE")
    if not certfile:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


class AppServer:
    """Bind an HTTPApp on host:port (thread per connection) with a
    background serve thread; TLS as :func:`server_ssl_context` says."""

    def __init__(
        self,
        app: HTTPApp,
        host: str = "0.0.0.0",
        port: int = 8000,
        ssl_certfile: str | None = None,
        ssl_keyfile: str | None = None,
    ):
        self.app = app
        self.httpd = ThreadingHTTPServer((host, port), _make_handler_class(app))
        ctx = server_ssl_context(ssl_certfile, ssl_keyfile)
        if ctx is not None:
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        self._serving = False
        self._closed = False

    def _start_app_daemons(self) -> None:
        """Per-app daemons (the alert evaluator) start when the app starts
        SERVING: constructing an app stays thread-free, so a process that
        builds many (tests, tooling) accumulates no watchers."""
        alerts = getattr(self.app, "alerts", None)
        if alerts is not None and getattr(
            self.app, "alerts_autostart", False
        ):
            alerts.start()

    def start_background(self) -> "AppServer":
        self._start_app_daemons()
        self._serving = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name=f"{self.app.name}-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._start_app_daemons()
        self._serving = True
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Stop serving and close the socket; safe to call twice, and on a
        server that never served (``HTTPServer.shutdown`` alone would wait
        forever for a loop that never ran)."""
        if self._closed:
            return
        self._closed = True
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # the lifecycle controller's thread dies with the server: a stopped
        # deploy must not go on retraining
        lifecycle = getattr(self.app, "lifecycle", None)
        if lifecycle is not None:
            lifecycle.stop()
        batcher = getattr(self.app, "microbatcher", None)
        if batcher is not None:
            batcher.close()
        alerts = getattr(self.app, "alerts", None)
        if alerts is not None:
            alerts.stop()
