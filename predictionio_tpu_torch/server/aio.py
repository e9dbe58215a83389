"""Asyncio HTTP server front end for an :class:`HTTPApp`.

The JAX package's ``server/aio.py``: the serving-latency-critical
replacement for the thread-per-connection ``AppServer`` (httpd.py).  One
event loop multiplexes every connection, async handlers await the query
:class:`~predictionio_tpu_torch.server.microbatch.MicroBatcher`, and sync
handlers are pushed to the default executor (with the request's context
copied, so its deadline travels) so storage I/O never blocks the loop.
Stdlib only, HTTP/1.1 with keep-alive.

``HTTPApp`` routes work unchanged; handlers that are coroutine functions
(``async def``) are awaited on the loop.  The same app object therefore
serves under both front ends.  Each request runs inside the threaded
front end's ``httpd.RequestScope`` (request id and trace context, the
flight-annotation and provenance scopes, admission, the deadline, one
unrecorded root span, and the SLO / provenance / flight accounting of
``obs.http.record_request_outcome``), its handler awaited.  Every request
is timed into ``pio_http_request_seconds{server,method,status}``.
"""

from __future__ import annotations

import asyncio
import contextvars
import http
import inspect
import logging
import threading
import time
from urllib.parse import parse_qs, urlsplit

from predictionio_tpu_torch.obs.metrics import REGISTRY
from predictionio_tpu_torch.server.httpd import (
    HTTPApp,
    Request,
    RequestScope,
    Response,
    error_response,
    exception_response,
    server_ssl_context,
    unquote_groups,
)

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 64 * 1024 * 1024


#: whole-server request timing (handler + executor hop), coarse labels only —
#: per-route latency belongs to the app's own pio_request_latency_seconds
_m_http = REGISTRY.histogram(
    "pio_http_request_seconds",
    "Async front-end request handling time by server/method/status",
    labelnames=("server", "method", "status"),
)

#: label-cardinality guard: the method token is client-controlled (any word
#: parses), so unknown verbs collapse to OTHER instead of minting unbounded
#: histogram children in the process-global registry
_KNOWN_METHODS = frozenset(
    ("GET", "POST", "PUT", "DELETE", "HEAD", "OPTIONS", "PATCH")
)

log = logging.getLogger("predictionio_tpu_torch.aio")


async def _handle_app_request(app: HTTPApp, req: Request) -> Response:
    """Route like HTTPApp.handle inside the threaded front end's
    ``RequestScope``, the handler awaited; every request, observability
    paths too, is timed into ``pio_http_request_seconds``."""
    with RequestScope(app, req) as scope:
        if scope.early is None:
            with scope.handling():
                scope.resp = await _route_app_request(app, req)
        resp = scope.finish()
    method = req.method if req.method in _KNOWN_METHODS else "OTHER"
    _m_http.labels(app.name, method, str(resp.status)).observe(
        time.perf_counter() - scope.t0
    )
    return resp


async def _route_app_request(app: HTTPApp, req: Request) -> Response:
    fn, m, status = app.match(req)
    denied = app.auth_error(req, fn)
    if denied is not None:
        return denied
    if fn is None:
        return error_response(
            status, "Method Not Allowed" if status == 405 else "Not Found"
        )
    req.params = unquote_groups(m)
    try:
        if inspect.iscoroutinefunction(fn):
            return await fn(req)
        loop = asyncio.get_running_loop()
        # copy_context: run_in_executor does not propagate contextvars, and
        # sync handlers must still see the request's deadline, request id
        # and annotation scope
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(None, ctx.run, fn, req)
    except Exception as e:
        return exception_response(e)


async def _read_request(reader: asyncio.StreamReader) -> Request | None:
    """Parse one HTTP/1.1 request; None on clean EOF before a request."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise
    except asyncio.LimitOverrunError:
        raise ValueError("request head too large")
    if len(head) > _MAX_HEADER_BYTES:
        raise ValueError("request head too large")
    lines = head.decode("latin-1").split("\r\n")
    method, target, _version = lines[0].split(" ", 2)
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length") or 0)
    if length > _MAX_BODY_BYTES:
        raise ValueError("request body too large")
    body = await reader.readexactly(length) if length else b""
    if "?" in target:
        split = urlsplit(target)
        q = parse_qs(split.query, keep_blank_values=True)
        path, query = split.path, {k: v[0] for k, v in q.items()}
    else:  # hot path: no query string to parse
        path, query = target, {}
    return Request(
        method=method.upper(), path=path, query=query, headers=headers, body=body
    )


def _encode_response(resp: Response, keep_alive: bool) -> bytes:
    payload, ctype = resp.encoded()
    lines = [
        f"HTTP/1.1 {resp.status} {_reason(resp.status)}",
        f"Content-Type: {ctype}",
        f"Content-Length: {len(payload)}",
        f"Connection: {'keep-alive' if keep_alive else 'close'}",
    ]
    lines += [f"{k}: {v}" for k, v in resp.headers.items()]
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return head + payload


def _reason(status: int) -> str:
    try:
        return http.HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class AsyncAppServer:
    """Bind an HTTPApp on host:port under an asyncio event loop.

    Mirrors the AppServer surface (``start_background`` / ``serve_forever``
    / ``shutdown``, ``.host``/``.port``) so callers can swap front ends.
    ``shutdown`` closes the app's micro-batcher before the loop dies, so
    queued queries are answered (500) instead of hanging.  TLS comes from
    the same ``PIO_SSL_CERTFILE`` / ``PIO_SSL_KEYFILE`` variables or paths
    (``httpd.server_ssl_context``); the loop does each handshake.
    """

    def __init__(
        self,
        app: HTTPApp,
        host: str = "0.0.0.0",
        port: int = 8000,
        ssl_certfile: str | None = None,
        ssl_keyfile: str | None = None,
    ):
        self.app = app
        self._req_host = host
        self._req_port = port
        self._ssl_ctx = server_ssl_context(ssl_certfile, ssl_keyfile)
        self.host: str = host
        self.port: int = port
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.Server | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._startup_error: BaseException | None = None

    async def _client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ):
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except (ValueError, asyncio.IncompleteReadError) as e:
                    writer.write(
                        _encode_response(
                            error_response(400, f"bad request: {e}"), False
                        )
                    )
                    await writer.drain()
                    return
                if req is None:
                    return
                resp = await _handle_app_request(self.app, req)
                keep = req.headers.get("connection", "keep-alive") != "close"
                writer.write(_encode_response(resp, keep))
                await writer.drain()
                if not keep:
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._client, self._req_host, self._req_port, ssl=self._ssl_ctx
        )
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        self._started.set()
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

    def _run_loop(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        except asyncio.CancelledError:
            pass
        except BaseException as e:  # surface bind errors to the caller
            self._startup_error = e
            raise
        finally:
            self._started.set()  # unblock start_background on failure too
            try:
                self._loop.run_until_complete(self._loop.shutdown_asyncgens())
            finally:
                self._loop.close()
                self._stopped.set()

    def _start_app_daemons(self) -> None:
        """Per-app daemons (the alert evaluator) start when the app starts
        SERVING: constructing an app stays thread-free, so a process that
        builds many (tests, tooling) accumulates no watchers."""
        alerts = getattr(self.app, "alerts", None)
        if alerts is not None and getattr(
            self.app, "alerts_autostart", False
        ):
            alerts.start()

    def start_background(self) -> "AsyncAppServer":
        self._start_app_daemons()
        self._thread = threading.Thread(
            target=self._run_loop, name=f"{self.app.name}-aio", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("async server failed to start within 10s")
        if self._startup_error is not None:
            raise RuntimeError(
                f"async server failed to start: {self._startup_error}"
            ) from self._startup_error
        return self

    def serve_forever(self) -> None:
        self._start_app_daemons()
        self._run_loop()

    def join(self) -> None:
        """Block until a ``start_background`` server stops serving."""
        while not self._stopped.wait(timeout=0.5):
            pass

    def shutdown(self) -> None:
        loop, server = self._loop, self._server
        if loop is None or server is None:
            return

        def _cancel_all():
            for task in asyncio.all_tasks(loop):
                task.cancel()

        def _stop():
            server.close()  # stop accepting; give in-flight responses
            loop.call_later(0.3, _cancel_all)  # a beat to flush (/stop ack)

        try:
            loop.call_soon_threadsafe(_stop)
        except RuntimeError:
            pass  # the loop already stopped (an earlier shutdown)
        # the lifecycle controller's thread dies with the server: a stopped
        # deploy must not go on retraining
        lifecycle = getattr(self.app, "lifecycle", None)
        if lifecycle is not None:
            lifecycle.stop()
        # close the micro-batcher BEFORE the loop dies: queued submits get
        # failed while their futures can still be delivered (handlers answer
        # 500 instead of hanging), and its worker thread is released
        batcher = getattr(self.app, "microbatcher", None)
        if batcher is not None:
            batcher.close()
        alerts = getattr(self.app, "alerts", None)
        if alerts is not None:
            alerts.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        else:
            self._stopped.wait(timeout=5)
