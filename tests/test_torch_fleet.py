"""The port's fleet layer against the JAX package's: membership and the
consistent-hash order, the router, capacity aggregation, federation, the
autoscaler and the fleet verbs.

In-process stub replicas (real HTTP servers with scripted ``/readyz``,
``/capacity.json``, ``/queries.json`` and, when set, ``/metrics.json``,
``/alerts.json`` and ``/costs.json``) stand behind both packages' routers
at once, so every answer, status code and header of the port's router is
held to the JAX router's on the same replicas.  The port's
``route_order`` is held to the JAX package's over 10,000 entities; the
federated ``/metrics`` text byte for byte; the autoscaler's actions tick
for tick under one scripted capacity timeline and a frozen clock.  Each
case of the JAX package's ``tests/test_fleet.py`` runs on the port.  Two
cases cross the packages: the port's router in front of a JAX replica,
and the JAX router in front of a port replica (``device="cpu"``); one
spawns a port ``deploy`` subprocess so the router's lane crosses a
process boundary.  Servers bind port 0; every client call has a timeout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.fleet import autoscaler as jax_autoscaler
from predictionio_tpu.fleet import federation as jax_federation
from predictionio_tpu.fleet import membership as jax_membership
from predictionio_tpu.fleet.router import create_router_app as jax_create_router_app
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxMetricsRegistry
from predictionio_tpu.resilience.breaker import reset_breakers as jax_reset_breakers
from predictionio_tpu.server.httpd import AppServer as JaxAppServer
from predictionio_tpu_torch.fleet import federation as pt_federation
from predictionio_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
    ReplicaSpawner,
)
from predictionio_tpu_torch.fleet.membership import (
    REPLICA_HEADER,
    FleetState,
    fleet_capacity,
    replica_id_of,
)
from predictionio_tpu_torch.fleet.router import create_router_app
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience.breaker import reset_breakers
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Response,
    json_response,
)
from predictionio_tpu_torch.tools.cli import main as cli_main

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 30


@pytest.fixture(autouse=True)
def _isolate_breakers():
    reset_breakers()
    jax_reset_breakers()
    yield
    reset_breakers()
    jax_reset_breakers()


def _post(url: str, payload, headers: dict | None = None, timeout=TIMEOUT):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            parsed = json.loads(body)
        except ValueError:
            parsed = {"raw": body.decode("utf-8", "replace")}
        return e.code, parsed, dict(e.headers)


def _get(url: str, timeout=TIMEOUT):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, None


class StubReplica:
    """A scriptable replica: answers /queries.json naming itself, /readyz
    per the ``ready`` flag, /capacity.json from the ``capacity`` dict, the
    telemetry routes from ``metrics`` / ``alerts`` / ``costs`` when set
    (404 otherwise), and records the headers of every forwarded query."""

    def __init__(self, name: str, shed: bool = False):
        self.name = name
        self.ready = True
        self.shed = shed
        self.capacity: dict = {}
        self.metrics: dict | None = None
        self.alerts: dict | None = None
        self.costs: dict | None = None
        self.seen_headers: list[dict] = []
        self.hold: threading.Event | None = None
        app = HTTPApp(f"stub-{name}")

        @app.route("POST", "/queries\\.json")
        def queries(req):
            self.seen_headers.append(dict(req.headers))
            if self.hold is not None:
                self.hold.wait(30)
            if self.shed:
                resp = json_response(503, {"message": "shedding"})
                resp.headers["Retry-After"] = "1"
                return resp
            resp = json_response(200, {"replica": self.name, "echo": req.json()})
            resp.headers["X-Pio-Engine-Instance"] = f"inst-{self.name}"
            resp.headers["X-Pio-Variant"] = "default"
            return resp

        @app.route("GET", "/capacity\\.json")
        def capacity(req):
            return json_response(200, self.capacity)

        for path, attr in (("/metrics\\.json", "metrics"),
                           ("/alerts\\.json", "alerts"),
                           ("/costs\\.json", "costs")):
            def route(req, attr=attr):
                body = getattr(self, attr)
                if body is None:
                    return json_response(404, {"message": "Not Found"})
                return json_response(200, body)
            app.route("GET", path)(route)

        @app.route("GET", "/readyz", public=True)
        def readyz(req):
            return Response(200 if self.ready else 503, {"ready": self.ready})

        self.server = AppServer(app, "127.0.0.1", 0).start_background()
        self.url = f"http://127.0.0.1:{self.server.port}"

    def shutdown(self):
        self.server.shutdown()


def saturated_capacity(observed=150.0, ceiling=100.0, recommended=3):
    return {
        "max_sustainable_qps": ceiling,
        "headroom_frac": round(1.0 - observed / ceiling, 4),
        "recommended_replicas": recommended,
        "scale_hint": "up",
        "inputs": {"observed_qps": observed},
    }


def idle_capacity(observed=5.0, ceiling=100.0):
    return {
        "max_sustainable_qps": ceiling,
        "headroom_frac": round(1.0 - observed / ceiling, 4),
        "recommended_replicas": 1,
        "scale_hint": "hold_or_down",
        "inputs": {"observed_qps": observed},
    }


# ---------------------------------------------------------------------------
# membership + consistent hashing
# ---------------------------------------------------------------------------


def _urls(n: int) -> list[str]:
    return [f"http://10.0.{i}.7:{8100 + 3 * i}" for i in range(n)]


@pytest.mark.parametrize("n", [2, 3, 5])
def test_route_order_equals_jax_for_10000_entities(n):
    """The fleet's affinity and its failover order are contracts: the
    port's rendezvous order is the JAX package's, entity for entity and
    position for position."""
    urls = _urls(n)
    port = FleetState(urls, registry=MetricsRegistry())
    ref = jax_membership.FleetState(urls, registry=JaxMetricsRegistry())
    entities = [f"user-{k}" for k in range(9990)] + [
        "app|u1", "tenant-b|user1", "ü-unicode", "0", "42", " ", "a" * 300,
        "u3", "u21", "i1",
    ]
    for entity in entities:
        got = [r.url for r in port.route_order(entity)]
        want = [r.url for r in ref.route_order(entity)]
        assert got == want, entity
    assert len(entities) == 10000


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_entityless_rotation_equals_jax(n):
    port = FleetState(_urls(n), registry=MetricsRegistry())
    ref = jax_membership.FleetState(_urls(n), registry=JaxMetricsRegistry())
    for _ in range(3 * n + 1):
        assert [r.url for r in port.route_order(None)] == [
            r.url for r in ref.route_order(None)
        ]
        assert [r.url for r in port.route_order("")] == [
            r.url for r in ref.route_order("")
        ]


class TestMembership:
    def test_replica_id_strips_scheme(self):
        assert replica_id_of("http://10.0.0.5:8101/") == "10.0.0.5:8101"
        for url in ("http://10.0.0.5:8101/", "https://h:1", "h:2", "http://x"):
            assert replica_id_of(url) == jax_membership.replica_id_of(url)

    def test_route_order_is_deterministic_per_entity(self):
        fleet = FleetState(
            [f"http://127.0.0.1:{8100 + i}" for i in range(4)],
            registry=MetricsRegistry(),
        )
        orders = {
            tuple(r.replica_id for r in fleet.route_order("user-42"))
            for _ in range(20)
        }
        assert len(orders) == 1

    def test_entities_spread_across_replicas(self):
        fleet = FleetState(
            [f"http://127.0.0.1:{8100 + i}" for i in range(4)],
            registry=MetricsRegistry(),
        )
        homes = {fleet.route_order(f"user-{u}")[0].replica_id for u in range(200)}
        assert len(homes) == 4

    def test_rendezvous_minimal_disruption(self):
        urls = [f"http://127.0.0.1:{8100 + i}" for i in range(4)]
        fleet = FleetState(urls, registry=MetricsRegistry())
        before = {f"u{u}": fleet.route_order(f"u{u}")[0].url for u in range(300)}
        victim = urls[2]
        fleet.remove(victim)
        for entity, home in before.items():
            after = fleet.route_order(entity)[0].url
            if home == victim:
                assert after != victim
            else:
                assert after == home, f"{entity} moved without cause"

    def test_entityless_queries_rotate(self):
        fleet = FleetState(
            [f"http://127.0.0.1:{8100 + i}" for i in range(3)],
            registry=MetricsRegistry(),
        )
        heads = {fleet.route_order(None)[0].replica_id for _ in range(9)}
        assert len(heads) == 3

    def test_set_replicas_reconciles_preserving_state(self):
        fleet = FleetState(
            ["http://127.0.0.1:8100", "http://127.0.0.1:8101"],
            registry=MetricsRegistry(),
        )
        rep = fleet.get("http://127.0.0.1:8100")
        fleet.note_inflight(rep, +3)
        fleet.set_replicas(["http://127.0.0.1:8100", "http://127.0.0.1:8102"])
        assert fleet.get("http://127.0.0.1:8101") is None
        assert fleet.get("http://127.0.0.1:8102") is not None
        assert fleet.get("http://127.0.0.1:8100").inflight == 3

    def test_refresh_from_file_on_mtime_change(self, tmp_path):
        source = tmp_path / "replicas.json"
        source.write_text(json.dumps(["http://127.0.0.1:8100"]))
        fleet = FleetState(source_file=str(source), registry=MetricsRegistry())
        assert fleet.refresh() is True
        assert [r.url for r in fleet.replicas()] == ["http://127.0.0.1:8100"]
        assert fleet.refresh() is False
        source.write_text("http://127.0.0.1:8100\nhttp://127.0.0.1:8101\n")
        os.utime(source, (time.time() + 2, time.time() + 2))
        assert fleet.refresh() is True
        assert len(fleet.replicas()) == 2

    def test_from_env_reads_list_and_file(self, tmp_path):
        source = tmp_path / "replicas.txt"
        source.write_text("http://127.0.0.1:8102\n")
        env = {"PIO_FLEET_REPLICAS": "http://127.0.0.1:8100, http://127.0.0.1:8101,",
               "PIO_FLEET_FILE": str(source)}
        port = FleetState.from_env(env, registry=MetricsRegistry())
        ref = jax_membership.FleetState.from_env(env, registry=JaxMetricsRegistry())
        assert [r.url for r in port.replicas()] == [r.url for r in ref.replicas()]
        assert port.snapshot() == ref.snapshot()

    def test_refresh_rejects_malformed_json_keeping_membership(self, tmp_path):
        source = tmp_path / "replicas.json"
        source.write_text(json.dumps(["http://127.0.0.1:8100"]))
        fleet = FleetState(source_file=str(source), registry=MetricsRegistry())
        assert fleet.refresh() is True
        assert len(fleet.replicas()) == 1
        source.write_text(json.dumps({"replicas": ["http://127.0.0.1:9999"]}))
        os.utime(source, (time.time() + 2, time.time() + 2))
        assert fleet.refresh() is False
        assert [r.url for r in fleet.replicas()] == ["http://127.0.0.1:8100"]
        source.write_text(json.dumps(["http://127.0.0.1:9999"]))
        os.utime(source, (time.time() + 4, time.time() + 4))
        assert fleet.refresh() is True
        assert [r.url for r in fleet.replicas()] == ["http://127.0.0.1:9999"]

    def test_forward_failures_do_not_eject_without_prober(self):
        fleet = FleetState(
            ["http://127.0.0.1:8100"], registry=MetricsRegistry(), eject_after=2
        )
        rep = fleet.replicas()[0]
        for _ in range(5):
            fleet.note_forward_failure(rep)
        assert fleet.routable(), "ejected with no path back to routing"

    def test_forward_success_resets_failure_streak(self):
        fleet = FleetState(
            ["http://127.0.0.1:8100"], registry=MetricsRegistry(), eject_after=3
        )
        fleet._thread = threading.current_thread()
        rep = fleet.replicas()[0]
        for _ in range(4):
            fleet.note_forward_failure(rep)
            fleet.note_forward_success(rep)
        with fleet._lock:
            streak = rep.consecutive_probe_failures
        assert streak == 0
        assert rep.healthy
        for _ in range(3):
            fleet.note_forward_failure(rep)
        assert not rep.healthy

    def test_probe_ejects_after_patience_and_readmits(self):
        stub = StubReplica("a")
        try:
            fleet = FleetState([stub.url], registry=MetricsRegistry(), eject_after=2)
            assert fleet.probe_once()[stub.url] is True
            stub.ready = False
            fleet.probe_once()
            assert fleet.routable(), "one failed probe must not eject"
            fleet.probe_once()
            assert not fleet.routable(), "second failed probe ejects"
            assert fleet.snapshot()["replicas"][0]["ejections_total"] == 1
            stub.ready = True
            fleet.probe_once()
            assert fleet.routable(), "readmission is immediate"
        finally:
            stub.shutdown()

    def test_ready_probe_closes_an_open_breaker(self):
        stub = StubReplica("a")
        try:
            fleet = FleetState(
                [stub.url], registry=MetricsRegistry(), eject_after=2,
                breaker_reset_s=3600.0,
            )
            rep = fleet.replicas()[0]
            for _ in range(5):
                rep.breaker.record_failure()
            assert rep.breaker.state == "open"
            assert not fleet.routable()
            assert fleet.probe_once()[stub.url] is True
            assert rep.breaker.state == "closed"
            assert fleet.routable()
        finally:
            stub.shutdown()

    def test_unreachable_replica_is_ejected(self):
        fleet = FleetState(
            ["http://127.0.0.1:1"], registry=MetricsRegistry(), eject_after=1
        )
        fleet.probe_once()
        assert not fleet.routable()
        snap = fleet.snapshot()["replicas"][0]
        assert "unreachable" in snap["last_probe_error"]

    def test_prober_thread_ejects_and_stops(self):
        stub = StubReplica("a")
        try:
            fleet = FleetState([stub.url], registry=MetricsRegistry(),
                               eject_after=1, probe_interval_s=0.05)
            fleet.start()
            stub.ready = False
            deadline = time.monotonic() + TIMEOUT
            while fleet.routable() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert not fleet.routable()
            fleet.stop()
            assert fleet._thread is None
        finally:
            stub.shutdown()

    def test_probe_and_gauges_equal_jax(self):
        """One probe pass over the same replicas leaves both packages'
        registries with the same /fleet.json body and the same gauges."""
        up, down = StubReplica("up"), StubReplica("down")
        down.ready = False
        try:
            urls = [up.url, down.url, "http://127.0.0.1:1"]
            preg, jreg = MetricsRegistry(), JaxMetricsRegistry()
            port = FleetState(urls, registry=preg, eject_after=1)
            ref = jax_membership.FleetState(urls, registry=jreg, eject_after=1)
            assert port.probe_once() == ref.probe_once()
            a, b = port.snapshot(), ref.snapshot()
            for body in (a, b):
                for row in body["replicas"]:
                    row["last_probe_error"] = (row["last_probe_error"] or "")[:13]
            assert a == b
            assert preg.render_json()["pio_fleet_replicas"] == (
                jreg.render_json()["pio_fleet_replicas"])
            assert preg.render_json()["pio_fleet_ejections_total"] == (
                jreg.render_json()["pio_fleet_ejections_total"])
        finally:
            up.shutdown()
            down.shutdown()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@pytest.fixture()
def duo():
    """Two stub replicas behind the port's router, probed healthy."""
    a, b = StubReplica("a"), StubReplica("b")
    registry = MetricsRegistry()
    fleet = FleetState([a.url, b.url], registry=registry)
    fleet.probe_once()
    router = AppServer(
        create_router_app(fleet, registry=registry), "127.0.0.1", 0
    ).start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        yield a, b, fleet, base, registry
    finally:
        router.shutdown()
        a.shutdown()
        b.shutdown()


class TestRouter:
    def test_affinity_and_replica_header(self, duo):
        a, b, fleet, base, _ = duo
        seen = set()
        for _ in range(10):
            status, body, headers = _post(base + "/queries.json", {"user": "u42", "num": 1})
            assert status == 200
            seen.add((body["replica"], headers[REPLICA_HEADER]))
        assert len(seen) == 1
        name, rid = seen.pop()
        assert rid.endswith(str((a if name == "a" else b).server.port))

    def test_passthrough_headers(self, duo):
        _a, _b, _fleet, base, _ = duo
        status, body, headers = _post(base + "/queries.json", {"user": "u1"})
        assert status == 200
        assert headers["X-Pio-Engine-Instance"] == f"inst-{body['replica']}"
        assert headers["X-Pio-Variant"] == "default"

    def test_propagation_headers_forwarded(self, duo):
        a, b, _fleet, base, _ = duo
        _post(
            base + "/queries.json",
            {"user": "u1"},
            {"X-Pio-Request-Id": "ridabc", "X-Pio-Trace-Id": "tracexyz",
             "X-Pio-Deadline": "5.0", "X-Pio-App": "shop"},
        )
        seen = (a.seen_headers or b.seen_headers)[-1]
        lower = {k.lower(): v for k, v in seen.items()}
        assert lower["x-pio-request-id"] == "ridabc"
        assert lower["x-pio-trace-id"] == "tracexyz"
        assert lower["x-pio-parent-span"]
        assert lower["x-pio-app"] == "shop"
        assert 0 < float(lower["x-pio-deadline"]) <= 5.0

    def test_bad_payload_400_without_forward(self, duo):
        a, b, _fleet, base, _ = duo
        status, _body, _ = _post(base + "/queries.json", ["not", "a", "dict"])
        assert status == 400
        assert not a.seen_headers and not b.seen_headers

    def test_no_replicas_sheds_503(self):
        registry = MetricsRegistry()
        fleet = FleetState(registry=registry)
        router = AppServer(
            create_router_app(fleet, registry=registry), "127.0.0.1", 0
        ).start_background()
        try:
            status, _body, headers = _post(
                f"http://127.0.0.1:{router.port}/queries.json", {"user": "u"}
            )
            assert status == 503
            assert "Retry-After" in headers
        finally:
            router.shutdown()

    def test_dead_replica_retries_elsewhere_zero_5xx(self, duo):
        a, b, fleet, base, registry = duo
        home = fleet.route_order("u42")[0]
        victim = a if home.url == a.url else b
        survivor = b if victim is a else a
        victim.shutdown()
        for _ in range(10):
            status, body, _headers = _post(
                base + "/queries.json", {"user": "u42"}, {"X-Pio-Deadline": "10"}
            )
            assert status == 200
            assert body["replica"] == survivor.name
        fam = registry.get("pio_router_retry_elsewhere_total")
        retries = {labels[0]: c.value for labels, c in fam.series()}
        assert retries.get("transport_error", 0) >= 1

    def test_shedding_replica_retries_elsewhere(self):
        shedder = StubReplica("shedder", shed=True)
        ok = StubReplica("ok")
        registry = MetricsRegistry()
        fleet = FleetState([shedder.url, ok.url], registry=registry)
        fleet.probe_once()
        router = AppServer(
            create_router_app(fleet, registry=registry), "127.0.0.1", 0
        ).start_background()
        base = f"http://127.0.0.1:{router.port}"
        try:
            for u in range(8):
                status, body, _ = _post(base + "/queries.json", {"user": f"u{u}"})
                assert status == 200
                assert body["replica"] == "ok"
        finally:
            router.shutdown()
            shedder.shutdown()
            ok.shutdown()

    def test_all_replicas_shedding_returns_replica_503(self):
        shedders = [StubReplica(f"s{i}", shed=True) for i in range(2)]
        registry = MetricsRegistry()
        fleet = FleetState([s.url for s in shedders], registry=registry)
        fleet.probe_once()
        router = AppServer(
            create_router_app(fleet, registry=registry), "127.0.0.1", 0
        ).start_background()
        try:
            status, _body, headers = _post(
                f"http://127.0.0.1:{router.port}/queries.json", {"user": "u"}
            )
            assert status == 503
            assert headers.get("Retry-After")
            assert headers.get(REPLICA_HEADER)
        finally:
            router.shutdown()
            for s in shedders:
                s.shutdown()

    def test_expired_budget_is_504_not_a_retry_storm(self, duo):
        a, b, _fleet, base, _ = duo
        status, _body, _ = _post(
            base + "/queries.json", {"user": "u1"}, {"X-Pio-Deadline": "0"}
        )
        assert status == 504
        assert not a.seen_headers and not b.seen_headers

    def test_fleet_json_and_aggregated_capacity(self, duo):
        a, b, _fleet, base, _ = duo
        a.capacity = saturated_capacity(observed=60.0, ceiling=100.0)
        b.capacity = idle_capacity(observed=10.0, ceiling=80.0)
        status, body = _get(base + "/fleet.json")
        assert status == 200
        assert body["total"] == 2 and body["routable"] == 2
        status, cap = _get(base + "/capacity.json")
        assert status == 200
        assert cap["max_sustainable_qps"] == pytest.approx(180.0)
        assert cap["headroom_frac"] == pytest.approx(0.4, abs=1e-6)
        assert cap["fleet"]["replicas"] == 2
        assert set(cap["fleet"]["per_replica"]) == {
            replica_id_of(a.url), replica_id_of(b.url),
        }

    def test_capacity_route_serves_cached_scrape_when_fresh(self, duo):
        a, b, _fleet, base, _ = duo
        a.capacity = idle_capacity(observed=10.0, ceiling=100.0)
        b.capacity = idle_capacity(observed=10.0, ceiling=100.0)
        status, cap1 = _get(base + "/capacity.json")
        assert status == 200
        assert cap1["max_sustainable_qps"] == pytest.approx(200.0)
        a.capacity = idle_capacity(observed=10.0, ceiling=500.0)
        status, cap2 = _get(base + "/capacity.json")
        assert status == 200
        assert cap2["max_sustainable_qps"] == pytest.approx(200.0)

    def test_access_key_gates_fleet_surfaces(self):
        stub = StubReplica("a")
        registry = MetricsRegistry()
        fleet = FleetState([stub.url], registry=registry)
        fleet.probe_once()
        router = AppServer(
            create_router_app(fleet, registry=registry, access_key="sekret"),
            "127.0.0.1", 0,
        ).start_background()
        base = f"http://127.0.0.1:{router.port}"
        try:
            for path in ("/fleet.json", "/capacity.json", "/metrics",
                         "/alerts.json", "/costs.json"):
                assert _get(base + path)[0] == 401, path
            assert _post(base + "/fleet/scale?replicas=2", {})[0] == 401
            assert _post(base + "/stop", {})[0] == 401
            assert _get(base + "/fleet.json?accessKey=sekret")[0] == 200
            assert _get(base + "/healthz")[0] == 200
            assert _post(base + "/queries.json", {"user": "u"})[0] == 200
        finally:
            router.shutdown()
            stub.shutdown()

    def test_router_readyz_follows_fleet(self, duo):
        a, b, fleet, base, _ = duo
        assert _get(base + "/readyz")[0] == 200
        a.ready = False
        b.ready = False
        fleet.probe_once()
        fleet.probe_once()
        assert _get(base + "/readyz")[0] == 503

    def test_scale_without_autoscaler_is_501_and_stop_calls_back(self):
        stub = StubReplica("a")
        registry = MetricsRegistry()
        fleet = FleetState([stub.url], registry=registry)
        stopped = threading.Event()
        router = AppServer(
            create_router_app(fleet, registry=registry, on_stop=stopped.set),
            "127.0.0.1", 0,
        ).start_background()
        base = f"http://127.0.0.1:{router.port}"
        try:
            assert _post(base + "/fleet/scale?replicas=2", {})[0] == 501
            status, body, _ = _post(base + "/stop", {})
            assert status == 200 and body == {"message": "Shutting down."}
            assert stopped.wait(TIMEOUT)
        finally:
            router.shutdown()
            stub.shutdown()

    def test_router_admission_gate_sheds(self):
        stub = StubReplica("a")
        stub.hold = threading.Event()
        registry = MetricsRegistry()
        fleet = FleetState([stub.url], registry=registry)
        router = AppServer(
            create_router_app(fleet, registry=registry, max_inflight=1),
            "127.0.0.1", 0,
        ).start_background()
        base = f"http://127.0.0.1:{router.port}"
        held: list = []
        t = threading.Thread(
            target=lambda: held.append(_post(base + "/queries.json", {"user": "u"})))
        try:
            t.start()
            deadline = time.monotonic() + TIMEOUT
            while not stub.seen_headers and time.monotonic() < deadline:
                time.sleep(0.01)
            status, _body, headers = _post(base + "/queries.json", {"user": "v"})
            assert status == 503 and headers.get("Retry-After")
        finally:
            stub.hold.set()
            t.join(TIMEOUT)
            router.shutdown()
            stub.shutdown()
        assert held and held[0][0] == 200


# ---------------------------------------------------------------------------
# the port's router against the JAX router on the same replicas
# ---------------------------------------------------------------------------

#: the response headers a client of the router sees that both packages set
_COMPARED_HEADERS = (REPLICA_HEADER, "X-Pio-Engine-Instance", "X-Pio-Variant",
                     "Retry-After", "Content-Type")


def _comparable(resp):
    status, body, headers = resp
    return status, body, {h: headers.get(h) for h in _COMPARED_HEADERS}


class _TwoRouters:
    """The port's router and the JAX router over the same replica URLs."""

    def __init__(self, urls, **kw):
        self.port_fleet = FleetState(urls, registry=MetricsRegistry())
        self.jax_fleet = jax_membership.FleetState(urls, registry=JaxMetricsRegistry())
        self.port_fleet.probe_once()
        self.jax_fleet.probe_once()
        self.port_server = AppServer(
            create_router_app(self.port_fleet, registry=MetricsRegistry(), **kw),
            "127.0.0.1", 0).start_background()
        self.jax_server = JaxAppServer(
            jax_create_router_app(self.jax_fleet, registry=JaxMetricsRegistry(), **kw),
            "127.0.0.1", 0).start_background()
        self.bases = (f"http://127.0.0.1:{self.port_server.port}",
                      f"http://127.0.0.1:{self.jax_server.port}")

    def post(self, path, payload, headers=None):
        port, ref = (_comparable(_post(b + path, payload, headers)) for b in self.bases)
        assert port == ref, (path, payload, headers)
        return port

    def get(self, path):
        port, ref = (_get(b + path) for b in self.bases)
        assert port == ref, path
        return port

    def shutdown(self):
        self.port_server.shutdown()
        self.jax_server.shutdown()


def test_router_answers_equal_jax_router():
    """Answers, status codes and headers of the port's router equal the
    JAX router's request for request: affinity by user and by (app, user),
    the entity-less rotation, bad payloads, an expired budget, the fleet
    surfaces, a dead replica's failover and every replica shedding."""
    stubs = [StubReplica(n) for n in ("a", "b", "c")]
    stubs[0].capacity = saturated_capacity(observed=60.0, ceiling=100.0)
    stubs[1].capacity = idle_capacity(observed=10.0, ceiling=80.0)
    routers = _TwoRouters([s.url for s in stubs])
    try:
        homes = set()
        for u in range(30):
            status, body, headers = routers.post("/queries.json", {"user": f"u{u}", "num": 2})
            assert status == 200
            homes.add(headers[REPLICA_HEADER])
        assert len(homes) == 3
        for entity in ({"userId": "x1"}, {"user_id": 7}, {"entityId": "e"},
                       {"items": ["i1"]}):
            routers.post("/queries.json", entity)
        for app in ("shop", "news"):
            routers.post("/queries.json", {"user": "u1"}, {"X-Pio-App": app})
            routers.post(f"/queries.json?app={app}", {"user": "u2"})
        assert routers.post("/queries.json", ["not", "a", "dict"])[0] == 400
        assert routers.post("/queries.json", {"user": "u1"}, {"X-Pio-Deadline": "0"})[0] == 504
        assert routers.get("/fleet.json")[0] == 200
        assert routers.get("/capacity.json")[0] == 200
        assert routers.get("/readyz")[0] == 200
        assert routers.post("/fleet/scale?replicas=2", {})[0] == 501
        # u's home dies: both routers fail over to the same survivor
        victim = routers.port_fleet.route_order("u5")[0].url
        next(s for s in stubs if s.url == victim).shutdown()
        for _ in range(4):
            status, _body, headers = routers.post(
                "/queries.json", {"user": "u5"}, {"X-Pio-Deadline": "10"})
            assert status == 200 and headers[REPLICA_HEADER] != replica_id_of(victim)
        for s in stubs:
            s.shed = True
        status, _body, headers = routers.post("/queries.json", {"user": "u7"})
        assert status == 503 and headers["Retry-After"]
    finally:
        routers.shutdown()
        for s in stubs:
            s.shutdown()


def test_router_federated_routes_equal_jax_router():
    """``/alerts.json`` and ``/costs.json`` of both routers over replicas
    with and without those routes give the same JSON (a replica without
    the route is a named source error)."""
    stubs = [StubReplica(n) for n in ("a", "b")]
    stubs[0].alerts = ALERT_BODIES["r1"]
    stubs[0].costs = COST_BODIES["r1"]
    routers = _TwoRouters([s.url for s in stubs])
    try:
        status, alerts = routers.get("/alerts.json")
        assert status == 200 and alerts["fleet"] is True
        assert alerts["firing"] == 1 and len(alerts["source_errors"]) == 1
        status, costs = routers.get("/costs.json")
        assert status == 200 and len(costs["source_errors"]) == 1
    finally:
        routers.shutdown()
        for s in stubs:
            s.shutdown()


# ---------------------------------------------------------------------------
# fleet capacity aggregation
# ---------------------------------------------------------------------------


def _with_caps(cls, registry_cls, caps):
    fleet = cls([f"http://127.0.0.1:{8100 + i}" for i in range(len(caps))],
                registry=registry_cls())
    for rep, cap in zip(fleet.replicas(), caps):
        with fleet._lock:
            rep.last_capacity = cap
    return fleet


def _burning():
    cap = saturated_capacity(observed=60.0, ceiling=100.0)
    cap["inputs"]["error_burn_rate"] = 2.0
    return cap


CAPACITY_SCRIPTS = {
    "saturated_and_idle": [saturated_capacity(), idle_capacity(observed=30.0)],
    "no_scrapes": [None, None],
    "burning": [_burning()],
    "idle_three": [idle_capacity(), idle_capacity(), idle_capacity()],
    "burn_only": [{"scale_hint": "up", "headroom_frac": None, "inputs": {}}],
    "mixed_none": [idle_capacity(observed=50.0, ceiling=60.0), None,
                   {"max_sustainable_qps": "n/a", "inputs": {"observed_qps": 3}}],
    "latency_burn": [dict(idle_capacity(), inputs={"observed_qps": 5.0,
                                                   "latency_burn_rate": 1.5})],
}


@pytest.mark.parametrize("script", sorted(CAPACITY_SCRIPTS))
def test_fleet_capacity_equals_jax(script):
    caps = CAPACITY_SCRIPTS[script]
    port = fleet_capacity(_with_caps(FleetState, MetricsRegistry, caps), scrape=False)
    ref = jax_membership.fleet_capacity(
        _with_caps(jax_membership.FleetState, JaxMetricsRegistry, caps), scrape=False)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)


class TestFleetCapacity:
    def test_sums_min_and_recommendation(self):
        fleet = _with_caps(FleetState, MetricsRegistry, [
            saturated_capacity(observed=150.0, ceiling=100.0),
            idle_capacity(observed=30.0, ceiling=100.0),
        ])
        cap = fleet_capacity(fleet, scrape=False)
        assert cap["max_sustainable_qps"] == pytest.approx(200.0)
        assert cap["headroom_frac"] == pytest.approx(-0.5)
        assert cap["recommended_replicas"] == 3
        assert cap["scale_hint"] == "up"

    def test_no_scrapes_yet_is_honest(self):
        cap = fleet_capacity(_with_caps(FleetState, MetricsRegistry, [None, None]),
                             scrape=False)
        assert cap["max_sustainable_qps"] is None
        assert cap["recommended_replicas"] is None
        assert len(cap["caveats"]) == 2

    def test_burning_replica_adds_one(self):
        cap = fleet_capacity(_with_caps(FleetState, MetricsRegistry, [_burning()]),
                             scrape=False)
        assert cap["recommended_replicas"] == 2


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------


def _fake_spawner(base):
    class FakeSpawner(base):
        def __init__(self, fail: bool = False):
            self.fail = fail
            self.spawned: list[str] = []
            self.drained: list[str] = []

        def spawn(self) -> str:
            if self.fail:
                raise RuntimeError("no capacity on this host")
            url = f"http://127.0.0.1:{9100 + len(self.spawned)}"
            self.spawned.append(url)
            return url

        def drain(self, url: str) -> None:
            self.drained.append(url)

    return FakeSpawner


FakeSpawner = _fake_spawner(ReplicaSpawner)
JaxFakeSpawner = _fake_spawner(jax_autoscaler.ReplicaSpawner)


def _autoscaler(fleet_cls, auto_cls, policy_cls, registry_cls, spawner, caps,
                policy=None):
    fleet = _with_caps(fleet_cls, registry_cls, caps)
    fleet.scrape_capacity_once = lambda: {}  # capacities are scripted
    clock = [0.0]
    auto = auto_cls(
        fleet, spawner,
        policy or policy_cls(min_replicas=1, max_replicas=3, scale_up_patience=2,
                             scale_down_patience=2, cooldown_s=10.0),
        registry=registry_cls(), clock=lambda: clock[0],
    )
    return fleet, auto, clock


class TestAutoscaler:
    def _setup(self, caps, policy=None, spawner=None):
        return _autoscaler(FleetState, Autoscaler, AutoscalerPolicy,
                           MetricsRegistry, spawner or FakeSpawner(), caps, policy)

    def test_scale_up_needs_patience(self):
        fleet, auto, _clock = self._setup([saturated_capacity(observed=150.0)])
        assert auto.tick() is None
        assert auto.tick() == "scale_up"
        assert fleet.active_count() == 2

    def test_cooldown_spaces_actions(self):
        fleet, auto, clock = self._setup([saturated_capacity(observed=300.0)])
        auto.tick()
        assert auto.tick() == "scale_up"
        assert auto.tick() is None
        assert auto.tick() is None
        assert fleet.active_count() == 2
        clock[0] += 11.0
        assert auto.tick() == "scale_up"
        assert fleet.active_count() == 3

    def test_max_replicas_caps_growth(self):
        fleet, auto, clock = self._setup(
            [saturated_capacity(observed=900.0, recommended=9)])
        for _ in range(10):
            auto.tick()
            clock[0] += 11.0
        assert fleet.active_count() == 3

    def test_scale_down_quiesces_then_drains_then_removes(self):
        spawner = FakeSpawner()
        fleet, auto, _clock = self._setup(
            [idle_capacity(), idle_capacity(), idle_capacity()], spawner=spawner)
        events: list[str] = []
        orig_quiesce = fleet.quiesce

        def spying_quiesce(url):
            events.append(f"quiesce:{url}")
            return orig_quiesce(url)

        fleet.quiesce = spying_quiesce
        orig_drain = spawner.drain

        def spying_drain(url):
            events.append(f"drain:{url}")
            rep = fleet.get(url)
            assert rep is not None and rep.draining
            orig_drain(url)

        spawner.drain = spying_drain
        assert auto.tick() is None
        assert auto.tick() == "scale_down"
        assert fleet.active_count() == 2
        victim = spawner.drained[0]
        assert events == [f"quiesce:{victim}", f"drain:{victim}"]
        assert fleet.get(victim) is None

    def test_min_replicas_floor(self):
        fleet, auto, clock = self._setup([idle_capacity()])
        for _ in range(6):
            auto.tick()
            clock[0] += 11.0
        assert fleet.active_count() == 1

    def test_pinned_target_skips_hysteresis(self):
        fleet, auto, _clock = self._setup([idle_capacity()])
        auto.set_target(3)
        assert auto.tick() == "scale_up"
        assert auto.tick() == "scale_up"
        assert fleet.active_count() == 3
        auto.set_target(None)
        assert auto.snapshot()["target_override"] is None

    def test_spawn_failure_is_contained(self):
        fleet, auto, _clock = self._setup(
            [saturated_capacity()], spawner=FakeSpawner(fail=True))
        auto.tick()
        assert auto.tick() is None
        assert fleet.active_count() == 1
        assert auto.snapshot()["last_event"]["event"] == "spawn_failed"

    def test_no_signal_holds(self):
        fleet, auto, _clock = self._setup([None])
        assert auto.tick() is None
        assert fleet.active_count() == 1

    def test_policy_from_env_equals_jax(self):
        env = {"PIO_FLEET_MIN_REPLICAS": "2", "PIO_FLEET_MAX_REPLICAS": "7",
               "PIO_FLEET_UP_PATIENCE": "1", "PIO_FLEET_DOWN_PATIENCE": "5",
               "PIO_FLEET_COOLDOWN_S": "2.5", "PIO_FLEET_TICK_S": "0.5",
               "PIO_FLEET_DRAIN_TIMEOUT_S": "9"}
        for e in (env, {}):
            port = AutoscalerPolicy.from_env(e)
            ref = jax_autoscaler.AutoscalerPolicy.from_env(e)
            assert port.__dict__ == ref.__dict__

    def test_loop_thread_ticks_and_stops(self):
        fleet, auto, _clock = self._setup(
            [saturated_capacity()],
            policy=AutoscalerPolicy(scale_up_patience=1, cooldown_s=0.0,
                                    tick_interval_s=0.02, max_replicas=2))
        auto.start()
        deadline = time.monotonic() + TIMEOUT
        while fleet.active_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        auto.stop()
        assert fleet.active_count() == 2 and auto._thread is None


#: (capacities written on every replica before the tick, clock advance,
#: pin) per tick: a saturated burst, a pin, idle drains to the floor
ACTION_SCRIPT = (
    [("sat", 0.0, None)] * 3
    + [("sat", 11.0, None)] * 2
    + [("sat900", 11.0, None)] * 3
    + [("idle", 0.0, None)] * 2
    + [("idle", 11.0, None)] * 4
    + [("idle", 1.0, 4), ("idle", 1.0, 2), ("idle", 0.0, "auto")]
    + [(None, 11.0, None)] * 2
    + [("burn_only", 11.0, None)] * 3
    + [("idle", 11.0, None)] * 6
)

_CAPS = {
    "sat": lambda: saturated_capacity(observed=150.0),
    "sat900": lambda: saturated_capacity(observed=900.0, recommended=9),
    "idle": idle_capacity,
    "burn_only": lambda: {"scale_hint": "up", "headroom_frac": None, "inputs": {}},
    None: lambda: None,
}


def _run_action_script(fleet_cls, auto_cls, policy_cls, registry_cls, spawner_cls):
    spawner = spawner_cls()
    fleet, auto, clock = _autoscaler(
        fleet_cls, auto_cls, policy_cls, registry_cls, spawner, [idle_capacity()],
        policy=policy_cls(min_replicas=1, max_replicas=4, scale_up_patience=2,
                          scale_down_patience=3, cooldown_s=10.0))
    log = []
    for cap, advance, pin in ACTION_SCRIPT:
        clock[0] += advance
        if pin == "auto":
            auto.set_target(None)
        elif pin is not None:
            auto.set_target(pin)
        for rep in fleet.replicas():
            with fleet._lock:
                rep.last_capacity = _CAPS[cap]()
        action = auto.tick()
        snap = auto.snapshot()
        log.append((action, fleet.active_count(), snap["up_streak"],
                    snap["down_streak"], snap["last_event"]))
    return log, spawner.spawned, spawner.drained, [r.url for r in fleet.replicas()]


def test_autoscaler_action_sequence_equals_jax():
    """Under one scripted capacity timeline, frozen clock and pins, the
    port's autoscaler takes the JAX one's action on every tick, spawns and
    drains the same replicas, and ends with the same membership."""
    port = _run_action_script(FleetState, Autoscaler, AutoscalerPolicy,
                              MetricsRegistry, FakeSpawner)
    ref = _run_action_script(jax_membership.FleetState, jax_autoscaler.Autoscaler,
                             jax_autoscaler.AutoscalerPolicy, JaxMetricsRegistry,
                             JaxFakeSpawner)
    assert port == ref
    actions = [entry[0] for entry in port[0]]
    assert actions.count("scale_up") >= 3 and actions.count("scale_down") >= 2


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------


def _metrics_body(seed: int, registry_cls=MetricsRegistry) -> dict:
    reg = registry_cls()
    c = reg.counter("pio_requests_total", "Requests served", labelnames=("route", "replica"))
    c.labels("/queries.json", "inner").inc(3 + seed)
    g = reg.gauge("pio_queue_depth", "Queue depth")
    g.set(0.5 * seed)
    h = reg.histogram("pio_request_latency_seconds", "Latency", labelnames=("route",))
    for v in (0.001, 0.004 * (seed + 1), 0.3, 7.0):
        h.labels("/queries.json").observe(v)
    return reg.render_json()


ALERT_BODIES = {
    "r1": {"alerts": [{"rule": "slo_burn", "state": "firing", "age_s": 3.0,
                       "key": "", "severity": "critical", "value": 2.5},
                      {"rule": "queue", "state": "pending", "age_s": 9.0,
                       "key": "q", "severity": "warning", "value": 1.0}],
           "firing": 1, "pending": 1, "ticks": 4, "last_tick_at": 12.5,
           "recent": [{"at": 5.0, "rule": "slo_burn", "event": "firing"}]},
    "r2": {"alerts": [{"rule": "breaker_open", "state": "firing", "age_s": 30.0,
                       "key": "storage", "severity": "warning", "value": 1}],
           "firing": 1, "pending": 0, "ticks": 2, "last_tick_at": 11.0,
           "recent": [{"at": 7.0, "rule": "breaker_open", "event": "firing"},
                      {"at": 1.0, "rule": "queue", "event": "resolved"}]},
}

COST_BODIES = {
    "r1": {"totals": [{"app": "shop", "route": "/queries.json", "variant": "live",
                       "requests": 10, "device_s": 0.25, "flops": 1e9,
                       "hbm_bytes": 2e6, "storage_bytes": 0, "queue_s": 0.1,
                       "cache_hits": 0, "cache_misses": 3, "sheds": 1}],
           "budgets": {"per_app": {"shop": 2.0}, "default_device_s_per_min": None}},
    "r2": {"totals": [{"app": "shop", "route": "/queries.json", "variant": "live",
                       "requests": 4, "device_s": 0.75, "flops": 5e8,
                       "hbm_bytes": "x", "queue_s": 0.0},
                      {"app": "news", "route": "/queries.json", "variant": "canary",
                       "requests": 1, "device_s": 0.01}],
           "budgets": {"per_app": {"news": 1.0}, "default_device_s_per_min": 3.0}},
}


@pytest.mark.parametrize("with_local", [False, True])
def test_federated_metrics_text_byte_equal(with_local):
    bodies = {"127.0.0.1:9001": _metrics_body(1), "127.0.0.1:9000": _metrics_body(2),
              "127.0.0.1:9002": {"bogus": 1, "pio_x": {"type": "summary"}}}
    errors = {"127.0.0.1:9003": "URLError: refused", "127.0.0.1:9004": "HTTPError: 401"}
    port = pt_federation.federated_metrics_text(
        bodies, errors,
        local_registry=MetricsRegistry() if not with_local else _local_registry(MetricsRegistry))
    ref = jax_federation.federated_metrics_text(
        bodies, errors,
        local_registry=JaxMetricsRegistry() if not with_local else _local_registry(JaxMetricsRegistry))
    assert port == ref
    assert 'pio_federation_up{replica="127.0.0.1:9003"} 0' in port
    assert 'replica="127.0.0.1:9000",route="/queries.json",exported_replica="inner"' in port
    assert pt_federation.federated_metrics_text({}, {}) == jax_federation.federated_metrics_text({}, {})


def _local_registry(cls):
    reg = cls()
    reg.counter("pio_router_forwards_total", "Forwards",
                labelnames=("replica", "outcome")).labels("127.0.0.1:9000", "ok").inc(5)
    reg.histogram("pio_router_forward_seconds", "Forward latency",
                  labelnames=("replica",)).labels("127.0.0.1:9000").observe(0.002)
    return reg


def test_federated_alerts_and_costs_equal_jax():
    from predictionio_tpu.obs.costs import COST_FIELDS as JAX_COST_FIELDS
    from predictionio_tpu_torch.obs.costs import COST_FIELDS

    assert COST_FIELDS == JAX_COST_FIELDS
    errors = {"127.0.0.1:9003": "URLError: refused"}
    local = {"alerts": [{"rule": "breaker_open", "state": "firing", "age_s": 1.0}],
             "firing": 1, "pending": 0, "recent": []}
    for lo in (None, local):
        port = pt_federation.federated_alerts(ALERT_BODIES, errors, local_snapshot=lo)
        ref = jax_federation.federated_alerts(ALERT_BODIES, errors, local_snapshot=lo)
        assert json.dumps(port) == json.dumps(ref)
    assert port["firing"] == 3 and port["replicas"]["127.0.0.1:9003"] is None
    local_costs = {"totals": [{"app": "router", "route": "r", "variant": "",
                               "device_s": 0.0, "requests": 2}]}
    for lo in (None, local_costs):
        port = pt_federation.federated_costs(COST_BODIES, errors, local_snapshot=lo)
        ref = jax_federation.federated_costs(COST_BODIES, errors, local_snapshot=lo)
        assert json.dumps(port) == json.dumps(ref)
    merged = {(r["app"], r["variant"]): r for r in port["merged"]}
    assert merged[("shop", "live")]["device_s"] == pytest.approx(1.0)
    assert merged[("shop", "live")]["requests"] == 14


def test_scrape_replicas_names_failures():
    up, no_route = StubReplica("up"), StubReplica("no_route")
    up.metrics = _metrics_body(0)
    try:
        urls = [up.url, no_route.url, "http://127.0.0.1:1"]
        fleet = FleetState(urls, registry=MetricsRegistry())
        fleet.quiesce(urls[2])  # a draining replica is not scraped
        bodies, errors = pt_federation.scrape_replicas(fleet, "/metrics.json", timeout=3)
        assert list(bodies) == [replica_id_of(up.url)]
        assert list(errors) == [replica_id_of(no_route.url)]
        assert errors[replica_id_of(no_route.url)].startswith("HTTPError")
        ref = jax_membership.FleetState(urls, registry=JaxMetricsRegistry())
        ref.quiesce(urls[2])
        assert jax_federation.scrape_replicas(ref, "/metrics.json", timeout=3) == (
            bodies, errors)
    finally:
        up.shutdown()
        no_route.shutdown()


def test_federation_cache_single_flight():
    clock = [0.0]
    cache = pt_federation.FederationCache(ttl_s=5.0, clock=lambda: clock[0])
    builds = []
    gate = threading.Event()

    def build():
        builds.append(1)
        gate.wait(TIMEOUT)
        return len(builds)

    got: list = []
    threads = [threading.Thread(target=lambda: got.append(cache.get("k", build)))
               for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(TIMEOUT)
    assert got == [1] * 6 and len(builds) == 1
    clock[0] += 6.0
    assert cache.get("k", build) == 2

    def boom():
        raise RuntimeError("scrape failed")

    clock[0] += 6.0
    with pytest.raises(RuntimeError):
        cache.get("k", boom)
    assert cache.get("k", build) == 3


def test_router_federated_metrics_carry_every_replica():
    a, b = StubReplica("a"), StubReplica("b")
    a.metrics, b.metrics = _metrics_body(1), _metrics_body(2)
    registry = MetricsRegistry()
    fleet = FleetState([a.url, b.url], registry=registry)
    fleet.probe_once()
    router = AppServer(create_router_app(fleet, registry=registry),
                       "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        _post(base + "/queries.json", {"user": "u1"})
        with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT) as r:
            text = r.read().decode()
        for s in (a, b):
            assert f'pio_federation_up{{replica="{replica_id_of(s.url)}"}} 1' in text
        assert 'pio_router_forwards_total{replica="router"' in text
        with urllib.request.urlopen(base + "/metrics?local=1", timeout=TIMEOUT) as r:
            local = r.read().decode()
        assert "pio_federation_up" not in local and "pio_router_forwards_total" in local
    finally:
        router.shutdown()
        a.shutdown()
        b.shutdown()


# ---------------------------------------------------------------------------
# CLI surfaces
# ---------------------------------------------------------------------------


class TestFleetCLI:
    @pytest.fixture()
    def router_stack(self):
        a, b = StubReplica("a"), StubReplica("b")
        registry = MetricsRegistry()
        fleet = FleetState([a.url, b.url], registry=registry)
        fleet.probe_once()
        auto = Autoscaler(fleet, FakeSpawner(), AutoscalerPolicy(),
                          registry=MetricsRegistry())
        router = AppServer(
            create_router_app(fleet, registry=registry, autoscaler=auto),
            "127.0.0.1", 0,
        ).start_background()
        base = f"http://127.0.0.1:{router.port}"
        try:
            yield a, b, fleet, auto, base
        finally:
            router.shutdown()
            a.shutdown()
            b.shutdown()

    def test_fleet_status_text_and_json(self, router_stack, capsys):
        from predictionio_tpu.tools.cli import main as jax_cli_main

        _a, _b, _fleet, _auto, base = router_stack
        assert cli_main(["fleet", "status", "--url", base]) == 0
        out = capsys.readouterr().out
        assert "2 replicas" in out and "2 routable" in out
        assert jax_cli_main(["fleet", "status", "--url", base]) == 0
        assert capsys.readouterr().out == out  # the JAX CLI's rendering
        assert cli_main(["fleet", "status", "--url", base, "--json"]) == 0
        body = json.loads(capsys.readouterr().out)
        assert body["total"] == 2
        assert body["autoscaler"]["enabled"] is True

    def test_fleet_status_exit_1_when_dead(self, router_stack, capsys):
        a, b, fleet, _auto, base = router_stack
        a.ready = False
        b.ready = False
        fleet.probe_once()
        fleet.probe_once()
        assert cli_main(["fleet", "status", "--url", base]) == 1
        assert "zero routable" in capsys.readouterr().err

    def test_fleet_scale_pins_target(self, router_stack, capsys):
        _a, _b, _fleet, auto, base = router_stack
        assert cli_main(["fleet", "scale", "3", "--url", base]) == 0
        assert auto.snapshot()["target_override"] == 3
        assert "fleet target: 3 (pinned)" in capsys.readouterr().out
        assert cli_main(["fleet", "scale", "auto", "--url", base]) == 0
        assert auto.snapshot()["target_override"] is None
        assert cli_main(["fleet", "scale", "0", "--url", base]) == 1
        assert cli_main(["fleet", "scale", "2", "--url", "http://127.0.0.1:1"]) == 1
        capsys.readouterr()

    def test_fleet_watch_bounded(self, router_stack, capsys):
        _a, _b, _fleet, _auto, base = router_stack
        assert cli_main(["fleet", "watch", "--url", base, "--watch", "0.05",
                         "--watch-count", "2"]) == 0
        assert capsys.readouterr().out.count("2 replicas") == 2

    def test_pio_capacity_url_renders_fleet(self, router_stack, capsys):
        a, b, _fleet, _auto, base = router_stack
        a.capacity = saturated_capacity(observed=60.0, ceiling=100.0)
        b.capacity = idle_capacity(observed=10.0, ceiling=80.0)
        assert cli_main(["capacity", "--url", base]) == 0
        out = capsys.readouterr().out
        assert "fleet:" in out
        assert "180 qps" in out

    def test_pio_status_url_folds_fleet(self, router_stack, capsys):
        a, b, fleet, _auto, base = router_stack
        assert cli_main(["status", "--url", base, "--no-quality"]) == 0
        capsys.readouterr()
        a.ready = False
        fleet.probe_once()
        fleet.probe_once()
        assert cli_main(["status", "--url", base, "--no-quality"]) == 0
        captured = capsys.readouterr()
        assert "WARNING: replica" in captured.err
        assert json.loads(captured.out)["fleet"]["healthy"] == 1
        b.ready = False
        fleet.probe_once()
        fleet.probe_once()
        assert cli_main(["status", "--url", base, "--no-quality"]) == 1
        capsys.readouterr()

    def test_alerts_costs_and_top_federate_through_the_router(self, router_stack, capsys):
        a, b, _fleet, _auto, base = router_stack
        a.alerts, b.alerts = ALERT_BODIES["r1"], ALERT_BODIES["r2"]
        a.costs, b.costs = COST_BODIES["r1"], COST_BODIES["r2"]
        assert cli_main(["alerts", "--url", base]) == 1  # firing
        out = capsys.readouterr().out
        assert "slo_burn" in out and "breaker_open" in out
        assert cli_main(["costs", "--url", base]) == 0
        out = capsys.readouterr().out
        assert out.startswith("fleet costs across 2 replica(s)")
        assert "news@127.0.0.1" in out and "canary" in out
        assert cli_main(["top", "--url", base, "--once"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("fleet: 2 replica(s)")
        assert f"news@{replica_id_of(b.url)}" in out
        assert f"slo_burn@{replica_id_of(a.url)}" in out


# ---------------------------------------------------------------------------
# across the packages, and across a process boundary
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_trained_home(tmp_path_factory):
    """A recommendation model trained by the JAX package (rank 4), which
    both packages' deploys bind."""
    from predictionio_tpu.core.base import EngineContext as JaxEngineContext
    from predictionio_tpu.core.engine import resolve_engine_factory
    from predictionio_tpu.core.workflow import run_train
    from predictionio_tpu.data.datamap import DataMap as JaxDataMap
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
    from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
    from predictionio_tpu.models.recommendation import engine as _jax_rec  # noqa: F401
    from predictionio_tpu.tools import commands as jax_cmd

    path = tmp_path_factory.mktemp("torch_fleet") / "pio_home"
    storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(path)}))
    app = jax_cmd.app_new(storage, "fl").app
    rng = np.random.default_rng(3)
    storage.l_events().insert_batch([
        JaxEvent(event="rate", entity_type="user", entity_id=f"u{n % 16}",
                 target_entity_type="item", target_entity_id=f"i{n % 23}",
                 properties=JaxDataMap({"rating": float(rng.integers(1, 6))}))
        for n in range(240)], app.id)
    engine = resolve_engine_factory("recommendation")()
    params = engine.params_from_json({
        "datasource": {"name": "ratings", "params": {"appName": "fl"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}],
    })
    run_train(engine, params, ctx=JaxEngineContext(storage=storage, mode="train"),
              engine_factory="recommendation", storage=storage)
    storage.close()
    return path


def test_routers_across_the_packages_give_the_same_answers(jax_trained_home):
    """The port's router in front of a JAX replica, and the JAX router in
    front of a port replica (``device="cpu"``), answer every user as the
    replicas answer directly, item for item and score for score."""
    from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
    from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
    from predictionio_tpu.server import prediction_server as jax_server
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.server import prediction_server as pt_server

    env = {"PIO_HOME": str(jax_trained_home)}
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    pt_storage = StorageRuntime(StorageConfig.from_env(env))
    jax_rep = JaxAppServer(jax_server.create_prediction_server_app(
        jax_server.deploy_engine("recommendation", storage=jax_storage),
        registry=JaxMetricsRegistry(), use_microbatch=False),
        "127.0.0.1", 0).start_background()
    pt_rep = AppServer(pt_server.create_prediction_server_app(
        pt_server.deploy_engine("recommendation", storage=pt_storage, device="cpu"),
        registry=MetricsRegistry(), use_microbatch=False),
        "127.0.0.1", 0).start_background()
    jax_url = f"http://127.0.0.1:{jax_rep.port}"
    pt_url = f"http://127.0.0.1:{pt_rep.port}"
    pt_fleet = FleetState([jax_url], registry=MetricsRegistry())
    jax_fleet = jax_membership.FleetState([pt_url], registry=JaxMetricsRegistry())
    port_router = AppServer(create_router_app(pt_fleet, registry=MetricsRegistry()),
                            "127.0.0.1", 0).start_background()
    jax_router = JaxAppServer(jax_create_router_app(jax_fleet, registry=JaxMetricsRegistry()),
                              "127.0.0.1", 0).start_background()
    try:
        for u in list(range(16)) + [99]:
            q = {"user": f"u{u}", "num": 5}
            direct = [_post(url + "/queries.json", q) for url in (jax_url, pt_url)]
            routed = [_post(f"http://127.0.0.1:{r.port}/queries.json", q)
                      for r in (port_router, jax_router)]
            assert all(s == 200 for s, _, _ in direct + routed)
            assert direct[0][1] == direct[1][1], u  # the replicas agree
            assert routed[0][1] == direct[0][1] and routed[1][1] == direct[1][1]
            assert routed[0][2][REPLICA_HEADER] == replica_id_of(jax_url)
            assert routed[1][2][REPLICA_HEADER] == replica_id_of(pt_url)
    finally:
        for s in (port_router, jax_router, jax_rep, pt_rep):
            s.shutdown()
        jax_storage.close()
        pt_storage.close()


def _spawn_port_deploy(home, extra_env=None) -> tuple[subprocess.Popen, int]:
    """A port ``deploy --device cpu`` subprocess on a free port; returns
    (process, port) once it prints its bound line."""
    env = dict(os.environ, PIO_HOME=str(home), PIO_ALERTS="0", **(extra_env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "deploy",
         "--engine", "recommendation", "--device", "cpu", "--ip", "127.0.0.1",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
        env=env,
    )
    line: list[str] = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(timeout=120)
    if not line or "Engine deployed on http://" not in line[0]:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
        raise RuntimeError(f"deploy did not bind: {line}")
    return proc, int(line[0].split("http://127.0.0.1:")[1].split()[0])


def test_router_lane_appears_in_assembled_trace(jax_trained_home, tmp_path):
    """A traced request through the port's router -> a port ``deploy``
    subprocess assembles into one tree whose lanes show the router hop:
    http.router -> fleet.forward -> (other process) http.predictionserver."""
    import shutil

    from predictionio_tpu_torch.obs import timeline as tlm

    home = tmp_path / "pio_home"
    shutil.copytree(jax_trained_home, home)
    srv, port = _spawn_port_deploy(home)
    router = None
    try:
        registry = MetricsRegistry()
        fleet = FleetState([f"http://127.0.0.1:{port}"], registry=registry)
        fleet.probe_once()
        router = AppServer(create_router_app(fleet, registry=registry),
                           "127.0.0.1", 0).start_background()
        tid = "fleetlane01"
        status, _body, headers = _post(
            f"http://127.0.0.1:{router.port}/queries.json",
            {"user": "u7", "num": 3}, {"X-Pio-Trace-Id": tid})
        assert status == 200
        assert headers["X-Pio-Trace-Id"] == tid
        deadline = time.monotonic() + TIMEOUT
        tl = None
        while time.monotonic() < deadline:
            tl = tlm.collect_trace(tid, urls=[f"http://127.0.0.1:{port}"],
                                   include_local=True, timeout=3.0)
            if "http.predictionserver" in {n.name for n in tl.nodes.values()}:
                break
            time.sleep(0.2)
        txt = tl.render_text()
        assert "http.router" in txt and "fleet.forward" in txt
        assert "http.predictionserver" in txt
        forward = next(n for n in tl.nodes.values() if n.name == "fleet.forward")
        assert "http.predictionserver" in {c.name for c in forward.children}
        assert len({n.process for n in tl.nodes.values()}) >= 2
    finally:
        if router is not None:
            router.shutdown()
        srv.kill()
        srv.wait(timeout=TIMEOUT)


def test_fleet_package_exports_the_jax_names():
    import predictionio_tpu.fleet as jax_fleet
    import predictionio_tpu_torch.fleet as pt_fleet

    assert set(jax_fleet.__all__) <= set(pt_fleet.__all__)
    assert REPLICA_HEADER == jax_membership.REPLICA_HEADER
