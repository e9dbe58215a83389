"""The one traffic generator.

The port's counterpart of the JAX package's ``replay/workload.py``, with
the same public names and the same schedules:

- the **production-day harness** (``pio day``) uses :class:`OpenLoopRunner`
  over seeded :class:`PhaseSchedule` s — open-loop paced arrivals with
  bounded in-flight, Zipf entity skew that works unchanged over millions
  of distinct entities, mixed reads + event-server writes, and one
  outcome record per request (status, latency, replica/instance/variant
  headers, request id) that the verdict engine joins against scraped
  telemetry;
- :func:`measure_closed_loop` is the sequential keep-alive measure loop;
- :func:`run_load_rounds` is the asyncio concurrent client, also run as a
  subprocess (``python -m predictionio_tpu_torch.replay.workload PORT
  CONNS PER_CONN NUM_USERS ROUNDS``), one JSON line per round.

Determinism contract: a schedule is a pure function of (phase
parameters, seed).  Same seed ⇒ byte-identical arrival times, kinds and
entities — :func:`schedule_digest` is the proof the tests pin.  The
schedule stays numpy (``PCG64([seed, phase_index])``): both packages build
the same bytes from the same scenario and seed.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable
from urllib.parse import urlsplit

import numpy as np

__all__ = [
    "PhaseSchedule",
    "build_phase_schedule",
    "schedule_digest",
    "zipf_entities",
    "OpenLoopRunner",
    "measure_closed_loop",
    "run_load_rounds",
]


# ---------------------------------------------------------------------------
# seeded schedules
# ---------------------------------------------------------------------------


def zipf_entities(
    rng: np.random.Generator,
    n: int,
    num_entities: int,
    exponent: float = 1.1,
    offset: int = 0,
) -> np.ndarray:
    """``n`` entity indices Zipf-skewed over ``num_entities`` distinct
    entities, O(1) memory in the population size (inverse of the
    continuous power-law CDF, so "millions of distinct users" costs the
    same as twelve).  ``offset`` rotates which entities form the hot head
    — the scenario's query-distribution-shift knob."""
    if num_entities <= 1:
        return np.zeros(n, dtype=np.int64) + offset
    u = rng.random(n)
    s = float(exponent)
    if abs(s - 1.0) < 1e-9:
        rank = np.exp(u * np.log(num_entities))
    else:
        rank = ((num_entities ** (1.0 - s) - 1.0) * u + 1.0) ** (1.0 / (1.0 - s))
    # rank is 1-based (rank 1 = hottest); floor and shift to 0-based
    idx = np.minimum(rank.astype(np.int64) - 1, num_entities - 1)
    return (idx + offset) % num_entities


@dataclass(frozen=True)
class PhaseSchedule:
    """One phase's fully-materialized request schedule: parallel arrays
    of dispatch offsets (seconds from *day* start), read/write flags and
    entity indices, plus the phase parameters the verdict engine echoes
    back as evidence."""

    name: str
    index: int
    start_s: float
    duration_s: float
    qps: float
    read_frac: float
    p99_ms: float | None
    entity_offset: int
    at: np.ndarray  # float64, offsets from day start, sorted
    is_read: np.ndarray  # bool
    entity: np.ndarray  # int64

    def __len__(self) -> int:
        return len(self.at)

    def request_id(self, i: int, run: str) -> str:
        return f"{run}-p{self.index}-{i}"


def build_phase_schedule(
    *,
    name: str,
    index: int,
    start_s: float,
    duration_s: float,
    qps: float,
    read_frac: float,
    num_entities: int,
    zipf_exponent: float = 1.1,
    entity_offset: int = 0,
    p99_ms: float | None = None,
    seed: int = 0,
) -> PhaseSchedule:
    """Materialize one phase deterministically.  The per-phase RNG is
    derived from (seed, index) so reordering or editing one phase never
    perturbs another's schedule."""
    rng = np.random.Generator(np.random.PCG64([int(seed), int(index)]))
    n = int(round(qps * duration_s))
    # paced arrivals: one request per 1/qps slot, uniformly jittered
    # inside its slot — open-loop (the schedule never waits on responses)
    at = np.sort((np.arange(n) + rng.random(n)) / qps) + start_s
    is_read = rng.random(n) < read_frac
    entity = zipf_entities(rng, n, num_entities, zipf_exponent, entity_offset)
    return PhaseSchedule(
        name=name,
        index=index,
        start_s=float(start_s),
        duration_s=float(duration_s),
        qps=float(qps),
        read_frac=float(read_frac),
        p99_ms=p99_ms,
        entity_offset=int(entity_offset),
        at=at,
        is_read=is_read,
        entity=entity.astype(np.int64),
    )


def schedule_digest(schedules: list[PhaseSchedule]) -> str:
    """sha256 over the packed schedule arrays — the byte-identity the
    determinism tests pin (same scenario + seed ⇒ same digest)."""
    h = hashlib.sha256()
    for s in schedules:
        h.update(s.name.encode("utf-8"))
        h.update(struct.pack("<ddd", s.start_s, s.duration_s, s.qps))
        h.update(s.at.astype("<f8").tobytes())
        h.update(s.is_read.astype("u1").tobytes())
        h.update(s.entity.astype("<i8").tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the open-loop runner (pio day)
# ---------------------------------------------------------------------------


def _split_hostport(url: str) -> tuple[str, int]:
    parts = urlsplit(url)
    return parts.hostname or "127.0.0.1", parts.port or 80


@dataclass
class _Conns(threading.local):
    """Per-worker-thread keep-alive connections, keyed by (host, port)."""

    by_target: dict = field(default_factory=dict)


class OpenLoopRunner:
    """Dispatch a :class:`PhaseSchedule` against the fleet.

    Open-loop: requests launch at their scheduled time regardless of
    earlier completions, bounded by ``max_inflight`` (at the bound the
    dispatcher blocks, and the outcome's ``sched_lag_ms`` records how
    late the launch was).  Reads POST ``/queries.json`` at ``query_url``
    (through the router); writes POST ``/events.json`` at ``event_url``.
    Every request carries ``X-Pio-Request-Id`` and yields exactly one
    outcome dict — the half of the evidence the generator itself owns.
    """

    def __init__(
        self,
        query_url: str,
        event_url: str | None = None,
        access_key: str | None = None,
        *,
        run: str = "day",
        max_inflight: int = 64,
        timeout_s: float = 30.0,
        entity_prefix: str = "u",
        item_prefix: str = "m",
        num_items: int = 100,
        query_num: int = 4,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.query_target = _split_hostport(query_url)
        self.event_target = _split_hostport(event_url) if event_url else None
        self.event_path = (
            f"/events.json?accessKey={access_key}" if access_key else "/events.json"
        )
        self.run = run
        self.max_inflight = int(max_inflight)
        self.timeout_s = float(timeout_s)
        self.entity_prefix = entity_prefix
        self.item_prefix = item_prefix
        self.num_items = max(int(num_items), 1)
        self.query_num = int(query_num)
        self._clock = clock
        self._local = _Conns()
        self._lock = threading.Lock()
        self.outcomes: list[dict[str, Any]] = []
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_inflight, thread_name_prefix="pio-replay"
        )
        self._sem = threading.Semaphore(self.max_inflight)

    # -- one request ---------------------------------------------------------

    def _conn(self, target: tuple[str, int]) -> http.client.HTTPConnection:
        conn = self._local.by_target.get(target)
        if conn is None:
            conn = http.client.HTTPConnection(
                target[0], target[1], timeout=self.timeout_s
            )
            self._local.by_target[target] = conn
        return conn

    def _drop_conn(self, target: tuple[str, int]) -> None:
        conn = self._local.by_target.pop(target, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def _post(
        self, target: tuple[str, int], path: str, body: bytes, rid: str
    ) -> tuple[int | None, dict[str, str], str | None]:
        """One keep-alive POST; one silent reconnect for a stale pooled
        connection, then errors surface as (None, {}, error)."""
        headers = {
            "Content-Type": "application/json",
            "X-Pio-Request-Id": rid,
        }
        for attempt in (0, 1):
            conn = self._conn(target)
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                resp.read()
                return resp.status, {k.lower(): v for k, v in resp.getheaders()}, None
            except Exception as e:
                self._drop_conn(target)
                if attempt == 1:
                    return None, {}, f"{type(e).__name__}: {e}"
        return None, {}, "unreachable"

    def _one(self, sched: PhaseSchedule, i: int, t0: float) -> None:
        rid = sched.request_id(i, self.run)
        entity = int(sched.entity[i])
        started = self._clock()
        if sched.is_read[i] or self.event_target is None:
            kind = "read"
            body = json.dumps(
                {"user": f"{self.entity_prefix}{entity}", "num": self.query_num}
            ).encode()
            status, headers, error = self._post(
                self.query_target, "/queries.json", body, rid
            )
        else:
            kind = "write"
            body = json.dumps(
                {
                    "event": "rate",
                    "entityType": "user",
                    "entityId": f"{self.entity_prefix}{entity}",
                    "targetEntityType": "item",
                    "targetEntityId": f"{self.item_prefix}{entity % self.num_items}",
                    "properties": {"rating": float(1 + entity % 5)},
                }
            ).encode()
            status, headers, error = self._post(
                self.event_target, self.event_path, body, rid
            )
        done = self._clock()
        outcome = {
            "id": rid,
            "phase": sched.name,
            "phase_index": sched.index,
            "kind": kind,
            "sched_s": round(float(sched.at[i]), 6),
            "start_s": round(started - t0, 6),
            "sched_lag_ms": round((started - t0 - float(sched.at[i])) * 1000, 3),
            "latency_ms": round((done - started) * 1000, 3),
            "status": status,
            "replica": headers.get("x-pio-replica"),
            "instance": headers.get("x-pio-engine-instance"),
            "variant": headers.get("x-pio-variant"),
            "error": error,
        }
        with self._lock:
            self.outcomes.append(outcome)

    # -- one phase -----------------------------------------------------------

    def run_phase(self, sched: PhaseSchedule, t0: float) -> list[dict[str, Any]]:
        """Dispatch one phase (offsets are relative to the day start
        ``t0``, from ``self._clock()``); blocks until every outcome for
        the phase has been recorded (bounded by the request timeout)."""
        before = len(self.outcomes)
        futures = []
        for i in range(len(sched)):
            delay = t0 + float(sched.at[i]) - self._clock()
            if delay > 0:
                time.sleep(delay)
            self._sem.acquire()

            def task(i=i):
                try:
                    self._one(sched, i, t0)
                finally:
                    self._sem.release()

            futures.append(self._pool.submit(task))
        wait(futures, timeout=self.timeout_s + 10.0)
        with self._lock:
            return self.outcomes[before:]

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


# ---------------------------------------------------------------------------
# the closed-loop measure loop
# ---------------------------------------------------------------------------


def measure_closed_loop(
    host: str,
    port: int,
    n: int,
    num_users: int,
    *,
    path: str = "/queries.json",
    num: int = 10,
    entity_prefix: str = "",
    timeout_s: float = 30.0,
) -> list[float]:
    """Sequential keep-alive POST loop: ``n`` queries round-robin over
    ``num_users`` entities on ONE connection; returns sorted latencies in
    milliseconds.  Asserts every response is 200 — a closed-loop measure
    loop has no business averaging over failures."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    lats = []
    try:
        for q in range(n):
            body = json.dumps(
                {"user": f"{entity_prefix}{q % num_users}", "num": num}
            ).encode()
            t0 = time.perf_counter()
            conn.request(
                "POST", path, body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = resp.read()
            lats.append((time.perf_counter() - t0) * 1000)
            assert resp.status == 200, (resp.status, data[:200])
    finally:
        conn.close()
    return sorted(lats)


# ---------------------------------------------------------------------------
# the asyncio concurrent client (the `-m` entry point)
# ---------------------------------------------------------------------------


def _req_bytes(uid: int, num: int = 10) -> bytes:
    body = b'{"user": "%d", "num": %d}' % (uid, num)
    return (
        b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
        b"Content-Type: application/json\r\n"
        b"Content-Length: %d\r\n\r\n%s" % (len(body), body)
    )


def run_load_rounds(
    port: int,
    conns: int,
    per_conn: int,
    num_users: int,
    rounds: int,
    *,
    host: str = "127.0.0.1",
) -> list[dict[str, float]]:
    """``rounds`` independent rounds of ``conns`` concurrent keep-alive
    connections sending ``per_conn`` pre-encoded requests each with
    hand-rolled response framing (every microsecond of client overhead
    inflates the server's measured latency when they share a core).
    Returns one ``{"p50_ms", "p99_ms"}`` dict per round."""
    import asyncio

    async def client(cid: int, lats: list) -> None:
        reader, writer = await asyncio.open_connection(host, port)
        for q in range(per_conn):
            payload = _req_bytes((cid * per_conn + q) % num_users)
            t0 = time.perf_counter()
            writer.write(payload)
            head = await reader.readuntil(b"\r\n\r\n")
            clen = int(
                head.lower().split(b"content-length:")[1].split(b"\r\n")[0]
            )
            body = await reader.readexactly(clen)
            lats.append(time.perf_counter() - t0)
            assert head.startswith(b"HTTP/1.1 200"), head[:80] + body[:200]
        writer.close()

    async def one_round() -> list[float]:
        lats: list[float] = []
        await asyncio.gather(*(client(c, lats) for c in range(conns)))
        return lats

    results = []
    for _ in range(rounds):
        lats = sorted(asyncio.run(one_round()))
        results.append(
            {
                "p50_ms": lats[len(lats) // 2] * 1000,
                "p99_ms": lats[int(len(lats) * 0.99)] * 1000,
            }
        )
    return results


def main(argv: list[str]) -> int:
    """``python -m predictionio_tpu_torch.replay.workload PORT CONNS
    PER_CONN NUM_USERS ROUNDS`` — one JSON result line per round."""
    port, conns, per_conn, num_users, rounds = (int(a) for a in argv[:5])
    for res in run_load_rounds(port, conns, per_conn, num_users, rounds):
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised as a subprocess
    import sys

    raise SystemExit(main(sys.argv[1:]))
