"""Minimal threaded HTTP routing layer shared by both front ends.

The JAX package's ``server/httpd.py`` request/response model
(``Request``, ``Response``, ``HTTPApp``), its admission and deadline
wiring (``admit_request``, ``request_budget``, ``exception_response``:
``LoadShed`` -> 503 + Retry-After, ``DeadlineExceeded`` -> 504) and its
thread-per-connection front end (``AppServer``).  The asyncio front end
(``server/aio.py``) routes through the same ``HTTPApp.match`` and
``auth_error`` so the two cannot drift.  Tracing, SLO accounting and the
flight recorder come with the observability slice; the circuit breaker's
``CircuitOpen`` mapping comes with the remote storage backend it guards.
Handlers are plain functions, so route logic is testable without sockets.
"""

from __future__ import annotations

import json
import math
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping
from urllib.parse import parse_qs, unquote, urlsplit

from predictionio_tpu_torch.resilience import LoadShed
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
        if isinstance(self.body, bytes):
            return self.body, self.content_type or "application/octet-stream"
        if isinstance(self.body, str):
            return self.body.encode("utf-8"), self.content_type or (
                "text/html; charset=utf-8"
            )
        return (
            json.dumps(self.body).encode("utf-8"),
            self.content_type or "application/json; charset=utf-8",
        )


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
    sheds are 503 + Retry-After, anything else is 500.  Shared by both
    front ends and ``HTTPApp.handle``."""
    if isinstance(e, DeadlineExceeded):
        return error_response(504, f"deadline exceeded: {e}")
    if isinstance(e, LoadShed):
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
    server's ``default_deadline_s`` (None = no deadline)."""
    budget = parse_budget(header_get(req.headers, DEADLINE_HEADER))
    if budget is None:
        budget = getattr(app, "default_deadline_s", None)
    return budget


def admit_request(app: "HTTPApp"):
    """The server-wide in-flight cap, shared by both front ends.  Returns
    ``(releaser, None)`` when admitted (``releaser`` is what the caller
    must ``release()`` in its finally; None when no cap is configured) or
    ``(None, 503 shed response)`` when rejected: past the cap, shedding
    now is cheaper for everyone than queueing into a timeout."""
    adm = getattr(app, "admission", None)
    if adm is not None and not adm.try_acquire():
        return None, shed_response(
            "server over capacity; retry later", adm.retry_after_s
        )
    return adm, None


def admission_expired_response() -> Response:
    """504 for a request whose budget was already gone at admission —
    answering now beats doing work nobody will read."""
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


def observe_request(
    app: HTTPApp, req: Request, call: Callable[[Request], Response]
) -> Response:
    """The threaded front end's request lifecycle (mirrored in async form
    by ``server/aio.py``): the admission gate, then the request's deadline
    bound around the handler; a budget already spent answers 504."""
    adm, shed = admit_request(app)
    if shed is not None:
        return shed
    try:
        budget = request_budget(app, req)
        if budget is not None and budget <= 0:
            return admission_expired_response()
        with deadline_scope(budget_s=budget):
            return call(req)
    finally:
        if adm is not None:
            adm.release()


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

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return _Handler


class AppServer:
    """Bind an HTTPApp on host:port (thread per connection) with a
    background serve thread."""

    def __init__(self, app: HTTPApp, host: str = "0.0.0.0", port: int = 8000):
        self.app = app
        self.httpd = ThreadingHTTPServer((host, port), _make_handler_class(app))
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None
        self._serving = False
        self._closed = False

    def start_background(self) -> "AppServer":
        self._serving = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name=f"{self.app.name}-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
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
        batcher = getattr(self.app, "microbatcher", None)
        if batcher is not None:
            batcher.close()
