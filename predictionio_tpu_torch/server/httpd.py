"""Minimal threaded HTTP routing layer.

The JAX package's ``server/httpd.py`` request/response model and threaded
front end (``Request``, ``Response``, ``HTTPApp``, ``AppServer``), without
its admission control, deadlines, circuit breakers and tracing, which
arrive with later slices.  Handlers are plain functions, so route logic is
testable without sockets.
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping
from urllib.parse import parse_qs, unquote, urlsplit


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


def json_response(status: int, body: Any) -> Response:
    return Response(status=status, body=body)


def error_response(status: int, message: str) -> Response:
    return Response(status=status, body={"message": message})


def key_matches(req: Request, key: str) -> bool:
    """Constant-time check of the presented key (``Authorization: Bearer``
    or ``?accessKey=``) against ``key``."""
    import hmac

    auth = req.headers.get("Authorization") or ""
    presented = (
        auth[len("Bearer "):]
        if auth.startswith("Bearer ")
        else req.query.get("accessKey", "")
    )
    return hmac.compare_digest(presented.encode("utf-8"), key.encode("utf-8"))


class HTTPApp:
    """Route table: (method, compiled path regex) -> handler."""

    def __init__(self, name: str = "server"):
        self.name = name
        self._routes: list[tuple[str, re.Pattern, Handler]] = []

    def route(self, method: str, pattern: str):
        """Register a handler; ``pattern`` is a path regex with named groups,
        anchored at both ends."""
        compiled = re.compile("^" + pattern + "$")

        def deco(fn: Handler) -> Handler:
            self._routes.append((method.upper(), compiled, fn))
            return fn

        return deco

    def handle(self, req: Request) -> Response:
        path_matched = False
        for method, pattern, fn in self._routes:
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            # percent-decode captured params AFTER matching, so an encoded
            # '/' stays inside one segment
            req.params = {
                k: (unquote(v) if v is not None else v)
                for k, v in m.groupdict().items()
            }
            try:
                return fn(req)
            except Exception as e:  # the exceptionHandler analog
                return error_response(500, f"{type(e).__name__}: {e}")
        if path_matched:
            return error_response(405, "Method Not Allowed")
        return error_response(404, "Not Found")


def _make_handler_class(app: HTTPApp):
    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = f"predictionio-tpu-torch/{app.name}"

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
            resp = app.handle(req)
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

    def start_background(self) -> "AppServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name=f"{self.app.name}-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
