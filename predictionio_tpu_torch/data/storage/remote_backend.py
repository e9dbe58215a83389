"""Remote storage backend: DAO clients that talk to the storage daemon.

The JAX package's ``data/storage/remote_backend.py``, ported whole: the
same routes, wire formats (JSON for metadata and row events, the PIOF1
frame for bulk scans) and replay rules, so a port client talks to a JAX
daemon and a JAX client to a port daemon.  The reference's Elasticsearch
source implements every DAO trait against a remote REST server
(storage/elasticsearch/.../ESLEvents.scala:41, ESApps.scala,
ESEngineInstances.scala, ESPEvents.scala:42) so one storage fleet serves
all processes; ``Remote*`` classes implement the contracts of
``data/storage/base.py`` over HTTP against ``server/storage_server.py``.

Configure with::

    PIO_STORAGE_SOURCES_REMOTE_TYPE=remote
    PIO_STORAGE_SOURCES_REMOTE_URL=http://storage-host:7072
    PIO_STORAGE_SOURCES_REMOTE_AUTHKEY=...          # optional
    PIO_STORAGE_SOURCES_REMOTE_TIMEOUT=120          # seconds, default 30
    PIO_STORAGE_SOURCES_REMOTE_VERIFY=false         # TLS verify, default on
    PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE=REMOTE

Bulk scans (the PEvents side) move as the PIOF1 binary columnar frame
(``frame_codec.py``), shard-addressed so multi-host trainers fetch
disjoint entity-hash ranges: the remote flavor of
``ParquetPEvents.iter_shards``.

Connections are keep-alive ``http.client`` handles, one per thread (the
serving hot path is threaded).  Transport failures go through a bounded
retry policy behind a per-endpoint circuit breaker, every socket timeout
is capped by the request's deadline, and the ``remote.send`` /
``remote.response`` fault seams sit on the send and response phases.
"""

from __future__ import annotations

import http.client
import json
import random
import ssl
import threading
import time

import numpy as np
from datetime import datetime
from typing import Any, Iterator, Sequence
from urllib.parse import quote, urlencode, urlsplit

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import EventFilter, EventFrame
from predictionio_tpu_torch.data.storage.frame_codec import decode_frame, encode_frame
from predictionio_tpu_torch.obs.disttrace import propagation_headers
from predictionio_tpu_torch.obs.logging import REQUEST_ID_HEADER, get_request_id
from predictionio_tpu_torch.obs.tracing import trace
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.resilience.breaker import CircuitBreaker, CircuitOpen, get_breaker
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded, expired, remaining
from predictionio_tpu_torch.resilience.retry import RetryBudget, RetryPolicy


class RemoteStorageError(Exception):
    """Transport- or server-side failure from the storage daemon."""


class StorageUnavailable(RemoteStorageError):
    """The daemon is known-unreachable right now (circuit breaker open or
    every transport attempt failed).  Carries a ``retry_after_s`` hint so
    callers (the event server's ingest surface) can answer
    ``503 + Retry-After`` instead of a 500 traceback."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


# ---------------------------------------------------------------------------
# Wire codecs shared with the daemon (server/storage_server.py imports these
# so the format is defined exactly once)
# ---------------------------------------------------------------------------

_INSTANCE_MS = ("start_time", "end_time")


def _ms_to_dt(ms: int) -> datetime:
    from datetime import timezone

    return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)


def _inst_to_dict(i) -> dict:
    import dataclasses

    d = dataclasses.asdict(i)
    for k in _INSTANCE_MS:
        d[k] = int(d[k].timestamp() * 1000)
    return d


def engine_instance_to_dict(i: base.EngineInstance) -> dict:
    return _inst_to_dict(i)


def engine_instance_from_dict(d: dict) -> base.EngineInstance:
    d = dict(d)
    for k in _INSTANCE_MS:
        d[k] = _ms_to_dt(d[k])
    return base.EngineInstance(**d)


def evaluation_instance_to_dict(i: base.EvaluationInstance) -> dict:
    return _inst_to_dict(i)


def evaluation_instance_from_dict(d: dict) -> base.EvaluationInstance:
    d = dict(d)
    for k in _INSTANCE_MS:
        d[k] = _ms_to_dt(d[k])
    return base.EvaluationInstance(**d)


def filter_from_dict(d: dict | None) -> EventFilter | None:
    """Inverse of ``filter_to_dict`` (used by the daemon)."""
    if not d:
        return None
    return EventFilter(
        start_time=_ms_to_dt(d["startMs"]) if "startMs" in d else None,
        until_time=_ms_to_dt(d["untilMs"]) if "untilMs" in d else None,
        entity_type=d.get("entityType"),
        entity_id=d.get("entityId"),
        event_names=tuple(d["eventNames"]) if "eventNames" in d else None,
        target_entity_type=d.get("targetEntityType"),
        target_entity_id=d.get("targetEntityId"),
        limit=d.get("limit"),
        reversed=d.get("reversed", False),
    )


def filter_to_dict(f: EventFilter | None) -> dict | None:
    """Wire encoding of the find() filter algebra.  None-valued fields are
    omitted so "" (match events with NO target) survives the trip."""
    if f is None:
        return None
    d: dict[str, Any] = {}
    if f.start_time is not None:
        d["startMs"] = int(f.start_time.timestamp() * 1000)
    if f.until_time is not None:
        d["untilMs"] = int(f.until_time.timestamp() * 1000)
    if f.entity_type is not None:
        d["entityType"] = f.entity_type
    if f.entity_id is not None:
        d["entityId"] = f.entity_id
    if f.event_names is not None:
        d["eventNames"] = list(f.event_names)
    if f.target_entity_type is not None:
        d["targetEntityType"] = f.target_entity_type
    if f.target_entity_id is not None:
        d["targetEntityId"] = f.target_entity_id
    if f.limit is not None:
        d["limit"] = f.limit
    if f.reversed:
        d["reversed"] = True
    return d or None


#: default replay policy by method when the caller does not declare one:
#: POST is excluded because a blind replay can duplicate server-minted rows;
#: POST call sites that ARE replay-safe (id-carrying upserts) opt in via
#: ``idempotent=True``.
_IDEMPOTENT = frozenset({"GET", "PUT", "DELETE"})


class RemoteClient:
    """Thread-local keep-alive HTTP client for the storage daemon.

    TLS certificate verification is ON by default; pass ``verify=False``
    (PIO_STORAGE_SOURCES_<name>_VERIFY=false) only for self-signed dev
    certs — with it off, an on-path attacker can read the access key and
    all stored data.

    Resilience: transport failures go through a
    bounded :class:`RetryPolicy` (decorrelated-jitter backoff, retry
    budget) behind a per-endpoint :class:`CircuitBreaker` — a dead daemon
    costs ~0 ms per call once the breaker opens, instead of a connect
    timeout per serving thread.  A request-context deadline caps every
    socket timeout to the remaining budget.
    """

    def __init__(
        self,
        url: str,
        auth_key: str | None = None,
        timeout: float = 30.0,
        verify: bool = True,
        retry: RetryPolicy | None = None,
        retry_budget: RetryBudget | None = None,
        breaker: CircuitBreaker | None | str = "auto",
        breaker_threshold: int = 5,
        breaker_reset_s: float = 5.0,
    ):
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"storage daemon URL must be http(s): {url!r}")
        self.scheme = parts.scheme
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or (443 if self.scheme == "https" else 7072)
        self.auth_key = auth_key
        self.timeout = timeout
        self.verify = verify
        #: one retry by default — the legacy behavior, now policy-shaped
        self.retry = retry or RetryPolicy(max_attempts=2)
        self.retry_budget = (
            retry_budget if retry_budget is not None else RetryBudget()
        )
        if breaker == "auto":
            # endpoint-keyed: every client pointed at this daemon shares
            # one view of its health (first creation fixes the params)
            breaker = get_breaker(
                f"storage:{self.host}:{self.port}",
                failure_threshold=breaker_threshold,
                reset_timeout_s=breaker_reset_s,
            )
        self.breaker: CircuitBreaker | None = breaker
        self._retry_rng = random.Random()
        self._local = threading.local()

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            if self.scheme == "https":
                ctx = (
                    ssl.create_default_context()
                    if self.verify
                    else ssl._create_unverified_context()
                )
                conn = http.client.HTTPSConnection(
                    self.host, self.port, timeout=self.timeout, context=ctx
                )
            else:
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout
                )
            self._local.conn = conn
            self._local.last_used = time.monotonic()
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None

    #: drop a keep-alive connection idle longer than this before reuse —
    #: shrinks the window where the daemon's idle-close races our send
    _MAX_IDLE_S = 10.0

    #: transport-level failures eligible for retry/breaker accounting
    _NET_ERRORS = (
        http.client.HTTPException,
        ConnectionError,
        BrokenPipeError,
        TimeoutError,
        OSError,
    )

    def _cap_timeout(self, conn: http.client.HTTPConnection) -> None:
        """Bound this call's socket timeout by the remaining request
        budget: a request with 200 ms left must not sit in a 30 s connect."""
        t = self.timeout
        rem = remaining()
        if rem is not None:
            t = max(min(t, rem), 0.001)
        conn.timeout = t
        sock = getattr(conn, "sock", None)
        if sock is not None:
            sock.settimeout(t)

    def request(
        self,
        method: str,
        path: str,
        params: dict | None = None,
        body: bytes | None = None,
        content_type: str = "application/json",
        idempotent: bool | None = None,
    ) -> tuple[int, bytes]:
        """One HTTP round trip.  ``idempotent`` declares whether a REPLAY of
        this exact request is safe (server upserts / overwrite semantics);
        None falls back to the method class (_IDEMPOTENT).  Replays happen
        only when the response was lost after a full send; send-phase
        failures retry regardless (the daemon never saw a complete framed
        request).  Attempts are bounded by the retry policy + budget, gated
        by the endpoint breaker, and capped by the request deadline."""
        q = dict(params or {})
        if q:
            path = f"{path}?{urlencode(q)}"
        headers = {"Content-Type": content_type} if body is not None else {}
        rid = get_request_id()
        if rid:
            # cross-daemon correlation: forward the originating request's id
            # so the daemon's /logs.json and flight entries carry it — the
            # daemon's front end adopts any incoming X-Pio-Request-Id, so
            # without this the id dies at the process boundary
            headers[REQUEST_ID_HEADER] = rid
        if self.auth_key is not None:
            # header, not query param: keys in URLs land in proxy/access
            # logs; the daemon accepts both but prefers Authorization
            headers["Authorization"] = f"Bearer {self.auth_key}"
        if idempotent is None:
            idempotent = method in _IDEMPOTENT
        label = f"{method} {path.split('?')[0]}"
        # the round trip runs under its own (unrecorded, ring-skipped) span
        # so the assembled cross-process timeline shows storage time as a
        # named lane entry with the daemon's spans parented UNDER it —
        # without a storage call made off-request (worker threads, pollers)
        # evicting real request traces from the recent-traces ring
        with trace("storage.remote", record=False, ring=False) as sp:
            sp.tags = {"call": label}
            # ... and the span context rides next to the request id
            # (X-Pio-Trace-Id + THIS span as X-Pio-Parent-Span), so the
            # daemon's spans parent under the call site instead of
            # orphaning (obs/disttrace.py)
            headers.update(propagation_headers())
            # deadline admission: no budget left means no call at all
            rem = remaining()
            if rem is not None and rem <= 0:
                raise DeadlineExceeded(
                    f"storage call {label} abandoned: request deadline "
                    "exceeded"
                )
            # circuit breaker: a dead daemon costs ~0 ms once open
            br = self.breaker
            if br is not None:
                try:
                    br.guard(f"storage call {label}")
                except CircuitOpen as e:
                    raise StorageUnavailable(
                        str(e), retry_after_s=e.retry_after_s
                    ) from e
            try:
                result = self._attempt(
                    method, path, body, headers, idempotent, label
                )
            except RemoteStorageError:
                if br is not None:
                    br.record_failure()
                raise
            except BaseException:
                # a deadline expiry (or anything non-transport) says nothing
                # about the ENDPOINT's health: release a consumed half-open
                # trial slot instead of leaking it, which would wedge the
                # breaker half-open with no slots until process restart
                if br is not None:
                    br.release_trial()
                raise
            if br is not None:
                br.record_success()
            if self.retry_budget is not None:
                self.retry_budget.record_call()
            return result

    def _attempt(
        self,
        method: str,
        path: str,
        body: bytes | None,
        headers: dict,
        idempotent: bool,
        label: str,
    ) -> tuple[int, bytes]:
        """The bounded attempt loop (breaker accounting happens above)."""
        if (
            getattr(self._local, "conn", None) is not None
            and time.monotonic() - getattr(self._local, "last_used", 0.0)
            > self._MAX_IDLE_S
        ):
            self._drop_connection()
        policy = self.retry
        attempt = 0
        backoff = 0.0
        # the time.sleep below is jittered retry BACKOFF between bounded
        # attempts (the whole point is to wait), not a busy-wait poll —
        # there is no event a producer could signal across processes
        # pio: ignore[PIO-CONC002]
        while True:
            conn = self._connection()
            self._cap_timeout(conn)
            sent = False
            try:
                # Send phase.  A failure here (connect refused, pipe broken
                # mid-send) means the daemon never saw a complete framed
                # request, so a retry is safe for every method.  Response
                # phase: the request was fully sent, the daemon may have
                # processed it even though the response was lost, so only
                # declared-idempotent requests may replay — callers that
                # need replay safety make themselves idempotent (event
                # inserts mint ids client-side so a replay upserts).
                if faults.ACTIVE is not None:
                    faults.ACTIVE.check("remote.send", label)
                conn.request(method, path, body=body, headers=headers)
                sent = True
                if faults.ACTIVE is not None:
                    faults.ACTIVE.check("remote.response", label)
                resp = conn.getresponse()
                status, data = resp.status, resp.read()
                self._local.last_used = time.monotonic()
                return status, data
            except self._NET_ERRORS as e:
                self._drop_connection()
                if expired():
                    # the socket timeout was the deadline, not the daemon:
                    # report a budget failure, not an endpoint failure
                    raise DeadlineExceeded(
                        f"storage call {label} ran out of request budget: {e}"
                    ) from e
                attempt += 1
                retryable = (not sent) or idempotent
                if (
                    not retryable
                    or attempt >= policy.max_attempts
                    or not self._spend_retry()
                ):
                    if sent:
                        raise RemoteStorageError(
                            f"{label} to storage daemon failed after send: {e}"
                        ) from e
                    raise StorageUnavailable(
                        f"storage daemon unreachable at "
                        f"{self.scheme}://{self.host}:{self.port}: {e}"
                    ) from e
                backoff = policy.backoff_s(backoff, self._retry_rng)
                rem = remaining()
                if rem is not None:
                    # never sleep past the deadline; a shaved backoff still
                    # gets the attempt in under budget
                    backoff = min(backoff, max(rem - 0.001, 0.0))
                if backoff > 0:
                    time.sleep(backoff)

    def _spend_retry(self) -> bool:
        return self.retry_budget is None or self.retry_budget.try_spend()

    def json(
        self,
        method: str,
        path: str,
        params: dict | None = None,
        payload: Any = None,
        ok_404: bool = False,
        idempotent: bool | None = None,
    ) -> Any:
        body = (
            json.dumps(payload).encode("utf-8") if payload is not None else None
        )
        status, raw = self.request(
            method, path, params, body, idempotent=idempotent
        )
        if status == 404 and ok_404:
            return None
        if status >= 400:
            raise RemoteStorageError(
                f"{method} {path} -> {status}: {raw[:200].decode('utf-8', 'replace')}"
            )
        return json.loads(raw) if raw else None

    def close(self) -> None:
        self._drop_connection()


# ---------------------------------------------------------------------------
# Metadata DAOs
# ---------------------------------------------------------------------------


class RemoteApps(base.Apps):
    def __init__(self, client: RemoteClient):
        self.client = client

    def insert(self, app: base.App) -> int | None:
        # a duplicate name comes back in-band as {"id": null}; transport and
        # auth failures must surface, not masquerade as "duplicate".  Not
        # replay-safe: the server mints the id row.
        return self.client.json(
            "POST",
            "/v1/apps",
            payload={"id": app.id, "name": app.name, "description": app.description},
            idempotent=False,
        )["id"]

    def get(self, app_id: int) -> base.App | None:
        d = self.client.json("GET", f"/v1/apps/id/{app_id}", ok_404=True)
        return base.App(**d) if d else None

    def get_by_name(self, name: str) -> base.App | None:
        d = self.client.json("GET", f"/v1/apps/name/{quote(name, safe='')}", ok_404=True)
        return base.App(**d) if d else None

    def get_all(self) -> list[base.App]:
        return [base.App(**d) for d in self.client.json("GET", "/v1/apps")]

    def update(self, app: base.App) -> bool:
        return self.client.json(
            "PUT",
            f"/v1/apps/id/{app.id}",
            payload={"name": app.name, "description": app.description},
        )["ok"]

    def delete(self, app_id: int) -> bool:
        return self.client.json("DELETE", f"/v1/apps/id/{app_id}")["ok"]


class RemoteAccessKeys(base.AccessKeys):
    def __init__(self, client: RemoteClient):
        self.client = client

    @staticmethod
    def _parse(d: dict) -> base.AccessKey:
        return base.AccessKey(
            key=d["key"], appid=d["appid"], events=tuple(d.get("events", ()))
        )

    def insert(self, k: base.AccessKey) -> str | None:
        return self.client.json(
            "POST",
            "/v1/accesskeys",
            payload={"key": k.key, "appid": k.appid, "events": list(k.events)},
            # never replayed: the server's key insert is a plain INSERT
            # (duplicate -> null), so a replay of a committed insert would
            # misreport success as a duplicate failure; an empty key would
            # even mint a second key row
            idempotent=False,
        )["key"]

    def get(self, key: str) -> base.AccessKey | None:
        d = self.client.json("GET", f"/v1/accesskeys/{quote(key, safe='')}", ok_404=True)
        return self._parse(d) if d else None

    def get_by_appid(self, appid: int) -> list[base.AccessKey]:
        rows = self.client.json("GET", "/v1/accesskeys", params={"appid": appid})
        return [self._parse(d) for d in rows]

    def get_all(self) -> list[base.AccessKey]:
        return [self._parse(d) for d in self.client.json("GET", "/v1/accesskeys")]

    def update(self, k: base.AccessKey) -> bool:
        return self.client.json(
            "PUT",
            f"/v1/accesskeys/{quote(k.key, safe='')}",
            payload={"appid": k.appid, "events": list(k.events)},
        )["ok"]

    def delete(self, key: str) -> bool:
        return self.client.json("DELETE", f"/v1/accesskeys/{quote(key, safe='')}")["ok"]


class RemoteChannels(base.Channels):
    def __init__(self, client: RemoteClient):
        self.client = client

    def insert(self, channel: base.Channel) -> int | None:
        return self.client.json(
            "POST",
            "/v1/channels",
            payload={
                "id": channel.id,
                "name": channel.name,
                "appid": channel.appid,
            },
            idempotent=False,
        )["id"]

    def get(self, channel_id: int) -> base.Channel | None:
        d = self.client.json("GET", f"/v1/channels/{channel_id}", ok_404=True)
        return base.Channel(**d) if d else None

    def get_by_appid(self, appid: int) -> list[base.Channel]:
        rows = self.client.json("GET", "/v1/channels", params={"appid": appid})
        return [base.Channel(**d) for d in rows]

    def delete(self, channel_id: int) -> bool:
        return self.client.json("DELETE", f"/v1/channels/{channel_id}")["ok"]


class RemoteEngineInstances(base.EngineInstances):
    def __init__(self, client: RemoteClient):
        self.client = client
        self._enc, self._dec = engine_instance_to_dict, engine_instance_from_dict

    def insert(self, i: base.EngineInstance) -> str:
        return self.client.json(
            "POST",
            "/v1/engine_instances",
            payload=self._enc(i),
            idempotent=bool(i.id),  # caller-supplied id -> server upserts
        )["id"]

    def get(self, instance_id: str) -> base.EngineInstance | None:
        d = self.client.json(
            "GET", f"/v1/engine_instances/{quote(instance_id, safe='')}", ok_404=True
        )
        return self._dec(d) if d else None

    def get_all(self) -> list[base.EngineInstance]:
        return [
            self._dec(d) for d in self.client.json("GET", "/v1/engine_instances")
        ]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> base.EngineInstance | None:
        rows = self.client.json(
            "GET",
            "/v1/engine_instances",
            params={
                "engine_id": engine_id,
                "engine_version": engine_version,
                "engine_variant": engine_variant,
                "latest": 1,
            },
        )
        return self._dec(rows[0]) if rows else None

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[base.EngineInstance]:
        rows = self.client.json(
            "GET",
            "/v1/engine_instances",
            params={
                "engine_id": engine_id,
                "engine_version": engine_version,
                "engine_variant": engine_variant,
            },
        )
        return [self._dec(d) for d in rows]

    def update(self, i: base.EngineInstance) -> bool:
        return self.client.json(
            "PUT", f"/v1/engine_instances/{quote(i.id, safe='')}", payload=self._enc(i)
        )["ok"]

    def delete(self, instance_id: str) -> bool:
        return self.client.json(
            "DELETE", f"/v1/engine_instances/{quote(instance_id, safe='')}"
        )["ok"]


class RemoteEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: RemoteClient):
        self.client = client
        self._enc, self._dec = (
            evaluation_instance_to_dict,
            evaluation_instance_from_dict,
        )

    def insert(self, i: base.EvaluationInstance) -> str:
        return self.client.json(
            "POST",
            "/v1/evaluation_instances",
            payload=self._enc(i),
            idempotent=bool(i.id),
        )["id"]

    def get(self, instance_id: str) -> base.EvaluationInstance | None:
        d = self.client.json(
            "GET", f"/v1/evaluation_instances/{quote(instance_id, safe='')}", ok_404=True
        )
        return self._dec(d) if d else None

    def get_all(self) -> list[base.EvaluationInstance]:
        return [
            self._dec(d)
            for d in self.client.json("GET", "/v1/evaluation_instances")
        ]

    def get_completed(self) -> list[base.EvaluationInstance]:
        rows = self.client.json(
            "GET", "/v1/evaluation_instances", params={"completed": 1}
        )
        return [self._dec(d) for d in rows]

    def update(self, i: base.EvaluationInstance) -> bool:
        return self.client.json(
            "PUT", f"/v1/evaluation_instances/{quote(i.id, safe='')}", payload=self._enc(i)
        )["ok"]

    def delete(self, instance_id: str) -> bool:
        return self.client.json(
            "DELETE", f"/v1/evaluation_instances/{quote(instance_id, safe='')}"
        )["ok"]


class RemoteModels(base.Models):
    """Blob store over the daemon; the multipart (sharded-checkpoint)
    layout rides the base-class keyed-blob mapping, so every part is one
    PUT — the HDFS/S3 remote-model-store role (HDFSModels.scala:31)."""

    def __init__(self, client: RemoteClient):
        self.client = client

    def insert(self, instance_id: str, blob: bytes) -> None:
        status, raw = self.client.request(
            "PUT",
            f"/v1/models/{quote(instance_id, safe='')}",
            body=blob,
            content_type="application/octet-stream",
        )
        if status >= 400:
            raise RemoteStorageError(f"model PUT -> {status}")

    def get(self, instance_id: str) -> bytes | None:
        status, raw = self.client.request("GET", f"/v1/models/{quote(instance_id, safe='')}")
        if status == 404:
            return None
        if status >= 400:
            raise RemoteStorageError(f"model GET -> {status}")
        return raw

    def delete(self, instance_id: str) -> bool:
        return self.client.json("DELETE", f"/v1/models/{quote(instance_id, safe='')}")["ok"]


# ---------------------------------------------------------------------------
# Event DAOs
# ---------------------------------------------------------------------------


def _chan_params(channel_id: int | None, extra: dict | None = None) -> dict:
    p = dict(extra or {})
    if channel_id is not None:
        p["channel"] = channel_id
    return p


def _filter_params(
    channel_id: int | None, filter: EventFilter | None
) -> dict:
    p = _chan_params(channel_id)
    d = filter_to_dict(filter)
    if d:
        p["filter"] = json.dumps(d, separators=(",", ":"))
    return p


class RemoteLEvents(base.LEvents):
    def __init__(self, client: RemoteClient):
        self.client = client

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        return self.client.json(
            "POST", f"/v1/apps/{app_id}/init", params=_chan_params(channel_id)
        )["ok"]

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        return self.client.json(
            "POST", f"/v1/apps/{app_id}/remove", params=_chan_params(channel_id)
        )["ok"]

    def close(self) -> None:
        self.client.close()

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        # Mint event ids CLIENT-side (the LEvents contract makes inserts
        # with an id upsert), so this POST is replay-safe: if the response
        # is lost after the daemon committed, the retry writes the same
        # rows instead of duplicating them under fresh server ids.
        events = [e if e.event_id else e.with_id() for e in events]
        return self.client.json(
            "POST",
            f"/v1/apps/{app_id}/events",
            params=_chan_params(channel_id),
            payload=[e.to_api_dict() for e in events],
            idempotent=True,
        )["ids"]

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        d = self.client.json(
            "GET",
            f"/v1/apps/{app_id}/events/{quote(event_id, safe='')}",
            params=_chan_params(channel_id),
            ok_404=True,
        )
        return Event.from_api_dict(d) if d else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        return self.client.json(
            "DELETE",
            f"/v1/apps/{app_id}/events/{quote(event_id, safe='')}",
            params=_chan_params(channel_id),
        )["ok"]

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> Iterator[Event]:
        rows = self.client.json(
            "GET",
            f"/v1/apps/{app_id}/events",
            params=_filter_params(channel_id, filter),
        )
        return iter([Event.from_api_dict(d) for d in rows])


class RemotePEvents(base.PEvents):
    def __init__(self, client: RemoteClient):
        self.client = client

    def n_shards(self, app_id: int, channel_id: int | None = None) -> int:
        return self.client.json(
            "GET",
            f"/v1/apps/{app_id}/shards",
            params=_chan_params(channel_id),
        )["n_shards"]

    def _fetch_frame(self, app_id: int, params: dict) -> EventFrame:
        status, raw = self.client.request(
            "GET", f"/v1/apps/{app_id}/frame", params=params
        )
        if status >= 400:
            raise RemoteStorageError(f"frame scan -> {status}")
        return decode_frame(raw)

    def iter_shards(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
        shards: Sequence[int] | None = None,
    ) -> Iterator[tuple[int, EventFrame]]:
        """Shard-addressed bulk scan.  The whole requested shard set moves
        in ONE grouped fetch (SQL-backed daemons split a single table scan
        host-side, so per-shard requests would cost one full scan each) and
        is re-split locally by the same entity-hash function the layouts
        use.  Callers needing memory-bounded streaming can pass singleton
        ``shards`` lists per call."""
        from predictionio_tpu_torch.data.storage.base import frame_shard_of

        if shards is not None and len(shards) == 1:
            # singleton fast path: no /shards round trip, no local re-split
            k = list(shards)[0]
            yield k, self._fetch_frame(
                app_id, _filter_params(channel_id, filter) | {"shards": k}
            )
            return
        n = self.n_shards(app_id, channel_id)
        want = list(shards) if shards is not None else list(range(n))
        frame = self._fetch_frame(
            app_id,
            _filter_params(channel_id, filter)
            | {"shards": ",".join(str(k) for k in want)},
        )
        shard_of = frame_shard_of(frame.entity_type, frame.entity_id, n)
        for k in want:
            yield k, frame.take(shard_of == k)

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> EventFrame:
        return self._fetch_frame(app_id, _filter_params(channel_id, filter))

    def write(
        self, frame: EventFrame, app_id: int, channel_id: int | None = None
    ) -> None:
        replay_safe = frame.event_id is not None and not any(
            v is None for v in frame.event_id
        )  # id-carrying rows upsert on replay; id-less rows would duplicate
        status, _ = self.client.request(
            "POST",
            f"/v1/apps/{app_id}/frame",
            params=_chan_params(channel_id),
            body=encode_frame(frame),
            content_type="application/x-pio-frame",
            idempotent=replay_safe,
        )
        if status >= 400:
            raise RemoteStorageError(f"frame write -> {status}")

    def delete(
        self, event_ids: Sequence[str], app_id: int, channel_id: int | None = None
    ) -> None:
        self.client.json(
            "POST",
            f"/v1/apps/{app_id}/frame_delete",
            params=_chan_params(channel_id),
            payload={"ids": list(event_ids)},
        )

    def compact(self, app_id: int, channel_id: int | None = None) -> int | None:
        """Daemon-side segment compaction (idempotent: folding twice is a
        no-op, so a lost response may replay).  None when the daemon's
        event store rewrites in place (nothing to fold) — mirrors the
        local convention of the method being absent."""
        d = self.client.json(
            "POST",
            f"/v1/apps/{app_id}/compact",
            params=_chan_params(channel_id),
            idempotent=True,
        )
        return d["rows"] if d.get("supported", True) else None

    def status(self, app_id: int, channel_id: int | None = None) -> dict:
        """Daemon-side event-store layout stats (segment counts, backlog,
        watermark lag) — the ``pio eventstore status`` surface."""
        return self.client.json(
            "GET",
            f"/v1/apps/{app_id}/eventstore_status",
            params=_chan_params(channel_id),
        )


# ---------------------------------------------------------------------------
# Multi-daemon fan-out: parallel sharded ingest across a storage fleet
# ---------------------------------------------------------------------------
#
# One storage daemon owns one parquet root.  To scale the (cheap, CPU-bound)
# event tier horizontally — arXiv 2509.14920's cost split — a source may
# name SEVERAL daemon URLs (comma-separated).  Entity-hash shard k lives on
# daemon k % D: the same md5 family that lays out each daemon's parquet
# shards routes rows between daemons, so an entity's whole history stays on
# one daemon and per-entity reads touch exactly one host.  Writes partition
# the batch by home daemon and fan out concurrently; scans fan in.


def _fanout_pool() -> "ThreadPoolExecutor":
    from concurrent.futures import ThreadPoolExecutor

    global _FANOUT_POOL
    with _FANOUT_POOL_LOCK:  # two first-callers must not leak a pool
        if _FANOUT_POOL is None:
            _FANOUT_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="pio-fanout"
            )
        return _FANOUT_POOL


_FANOUT_POOL = None
_FANOUT_POOL_LOCK = threading.Lock()


def _run_all(calls):
    """Run per-daemon thunks concurrently on the shared fan-out pool
    (join-all + first-error semantics live in base.run_concurrent)."""
    return base.run_concurrent(_fanout_pool(), calls)


class _ShardCountCache:
    """Per-(app, channel) n_shards memo: the value is fixed at app init,
    so the serving-path point reads must not pay a /shards round trip to
    daemon 0 per call."""

    def __init__(self, pevents: "RemotePEvents"):
        self._pe = pevents
        self._cache: dict[tuple[int, int | None], int] = {}
        self._lock = threading.Lock()

    def get(self, app_id: int, channel_id: int | None) -> int:
        key = (app_id, channel_id)
        with self._lock:
            n = self._cache.get(key)
        if n is None:
            n = self._pe.n_shards(app_id, channel_id)
            with self._lock:
                self._cache[key] = n
        return n


class FanoutLEvents(base.LEvents):
    """Row DAO over D storage daemons, routed by entity-hash shard."""

    def __init__(self, clients: Sequence[RemoteClient]):
        self.subs = [RemoteLEvents(c) for c in clients]
        self._pevents = [RemotePEvents(c) for c in clients]
        self._shards = _ShardCountCache(self._pevents[0])

    def _n_shards(self, app_id: int, channel_id: int | None) -> int:
        return self._shards.get(app_id, channel_id)

    def _home(
        self, app_id: int, channel_id: int | None, entity_type: str, entity_id: str
    ) -> "RemoteLEvents":
        n = self._n_shards(app_id, channel_id)
        shard = base.entity_shard(entity_type, entity_id, n)
        return self.subs[shard % len(self.subs)]

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        return all(_run_all([
            (lambda s=s: s.init(app_id, channel_id)) for s in self.subs
        ]))

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        return any(_run_all([
            (lambda s=s: s.remove(app_id, channel_id)) for s in self.subs
        ]))

    def close(self) -> None:
        for s in self.subs:
            s.close()

    def insert(
        self, event: Event, app_id: int, channel_id: int | None = None
    ) -> str:
        return self._home(
            app_id, channel_id, event.entity_type, event.entity_id
        ).insert(event, app_id, channel_id)

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        if not events:
            return []
        n = self._n_shards(app_id, channel_id)
        d = len(self.subs)
        groups: dict[int, list[int]] = {}
        for i, e in enumerate(events):
            home = base.entity_shard(e.entity_type, e.entity_id, n) % d
            groups.setdefault(home, []).append(i)
        ids: list[str | None] = [None] * len(events)

        def send(home: int, idx: list[int]):
            got = self.subs[home].insert_batch(
                [events[i] for i in idx], app_id, channel_id
            )
            for i, eid in zip(idx, got):
                ids[i] = eid

        _run_all([
            (lambda h=h, ix=ix: send(h, ix)) for h, ix in groups.items()
        ])
        return ids  # type: ignore[return-value]

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        # the id alone does not name a home daemon: probe all concurrently
        for got in _run_all([
            (lambda s=s: s.get(event_id, app_id, channel_id))
            for s in self.subs
        ]):
            if got is not None:
                return got
        return None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        return any(_run_all([
            (lambda s=s: s.delete(event_id, app_id, channel_id))
            for s in self.subs
        ]))

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> Iterator[Event]:
        from heapq import merge as heap_merge

        if (
            filter is not None
            and filter.entity_type is not None
            and filter.entity_id is not None
        ):
            # entity-pinned: one daemon holds the whole history
            sub = self._home(
                app_id, channel_id, filter.entity_type, filter.entity_id
            )
            return sub.find(app_id, channel_id, filter)
        rows = _run_all([
            (lambda s=s: list(s.find(app_id, channel_id, filter)))
            for s in self.subs
        ])
        reverse = filter is not None and filter.reversed
        limit = filter.limit if filter is not None else None

        def gen():
            count = 0
            key = (
                (lambda e: -e.event_time.timestamp())
                if reverse
                else (lambda e: e.event_time.timestamp())
            )
            for e in heap_merge(*rows, key=key):
                if limit is not None and 0 <= limit <= count:
                    return
                count += 1
                yield e

        return gen()

    def find_by_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int | None = None,
        **kwargs,
    ) -> Iterator[Event]:
        return self._home(
            app_id, channel_id, entity_type, entity_id
        ).find_by_entity(
            app_id, entity_type, entity_id, channel_id=channel_id, **kwargs
        )


class FanoutPEvents(base.PEvents):
    """Bulk columnar DAO over D storage daemons (shard k -> daemon k%D)."""

    def __init__(self, clients: Sequence[RemoteClient]):
        self.subs = [RemotePEvents(c) for c in clients]
        self._shards = _ShardCountCache(self.subs[0])

    def n_shards(self, app_id: int, channel_id: int | None = None) -> int:
        return self._shards.get(app_id, channel_id)

    def write(
        self, frame: EventFrame, app_id: int, channel_id: int | None = None
    ) -> None:
        if not len(frame):
            return
        n = self.n_shards(app_id, channel_id)
        d = len(self.subs)
        shard_of = base.frame_shard_of(frame.entity_type, frame.entity_id, n)
        home = shard_of % d
        calls = []
        for h in range(d):
            mask = home == h
            if mask.any():
                sub_frame = frame.take(mask)
                calls.append(
                    lambda h=h, f=sub_frame: self.subs[h].write(
                        f, app_id, channel_id
                    )
                )
        _run_all(calls)

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> EventFrame:
        from predictionio_tpu_torch.data.storage.base import concat_frames

        if (
            filter is not None
            and filter.entity_type is not None
            and filter.entity_id is not None
        ):
            n = self.n_shards(app_id, channel_id)
            shard = base.entity_shard(filter.entity_type, filter.entity_id, n)
            return self.subs[shard % len(self.subs)].find(
                app_id, channel_id, filter
            )
        frames = _run_all([
            (lambda s=s: s.find(app_id, channel_id, filter))
            for s in self.subs
        ])
        out = concat_frames(frames)
        # each daemon answers time-sorted; the concatenation must be
        # re-sorted (and re-limited) to keep the find() contract
        order = np.argsort(out.event_time_ms, kind="stable")
        if filter is not None and filter.reversed:
            order = order[::-1]
        out = out.take(order)
        if filter is not None and filter.limit is not None and filter.limit >= 0:
            out = out.take(np.arange(min(filter.limit, len(out))))
        return out

    def iter_shards(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
        shards: Sequence[int] | None = None,
    ) -> Iterator[tuple[int, EventFrame]]:
        n = self.n_shards(app_id, channel_id)
        want = list(shards) if shards is not None else list(range(n))
        d = len(self.subs)
        by_daemon: dict[int, list[int]] = {}
        for k in want:
            by_daemon.setdefault(k % d, []).append(k)
        results = _run_all([
            (
                lambda h=h, ks=ks: list(
                    self.subs[h].iter_shards(
                        app_id, channel_id, filter, shards=ks
                    )
                )
            )
            for h, ks in by_daemon.items()
        ])
        got = {k: f for part in results for k, f in part}
        for k in want:
            if k in got:
                yield k, got[k]

    def delete(
        self, event_ids: Sequence[str], app_id: int, channel_id: int | None = None
    ) -> None:
        if not event_ids:
            return
        # ids alone don't name a home daemon; a tombstone for an absent id
        # is harmless, so broadcast
        _run_all([
            (lambda s=s: s.delete(event_ids, app_id, channel_id))
            for s in self.subs
        ])

    def compact(self, app_id: int, channel_id: int | None = None) -> int | None:
        rows = _run_all([
            (lambda s=s: s.compact(app_id, channel_id)) for s in self.subs
        ])
        if all(r is None for r in rows):
            return None
        return sum(r or 0 for r in rows)

    def status(self, app_id: int, channel_id: int | None = None) -> dict:
        parts = _run_all([
            (lambda s=s: s.status(app_id, channel_id)) for s in self.subs
        ])
        out = dict(parts[0])
        out["daemons"] = len(parts)
        for p in parts[1:]:
            for key in (
                "segments_hot",
                "segments_compacted",
                "backlog_segments",
                "backlog_bytes",
                "bytes",
                "rows_hint",
            ):
                out[key] = out.get(key, 0) + p.get(key, 0)
            lags = [
                x.get("watermark_lag_s")
                for x in (out, p)
                if x.get("watermark_lag_s") is not None
            ]
            out["watermark_lag_s"] = max(lags) if lags else None
        return out
