"""The port's fleet under chaos, and the autoscaler closing its loop, on
the CPU (the cases of the JAX package's ``tests/test_fleet_chaos.py``):

- **SIGKILL a replica mid-traffic**: the port's router in front of three
  port ``deploy --device cpu`` subprocesses serving one trained model.
  Entity affinity holds across 100 requests; the fixed entity's home is
  SIGKILLed under four clients: no non-200 for requests with deadline
  budget left, a bounded p99, the corpse ejected, the same answer bytes,
  variant and canary side from the survivor; the revived replica rejoins
  through the prober and gets its entities back.
- **Scale up, then drain without dropping a request**: in-process port
  replicas with real generation refcounts; ``tick()`` grows 1 -> 3 on a
  saturated signal and drains 3 -> 1 on an idle one, the drain waiting on
  the victim's in-flight request.
- **The drain poll** of ``LocalProcessSpawner`` over ``/status.json``.
- **``fleet deploy --device cpu --autoscale``** as a subprocess of the
  port's CLI: two replica daemons (the port's ``deploy``, never the JAX
  package's), queries through the router, ``fleet scale 3`` then ``2``
  (a respawn, then a drain), ``POST /stop``: every replica stopped and
  every pidfile gone.

Every server binds port 0 (the replica daemons ephemeral ports), every
client call has a timeout, and every process is stopped in ``finally``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.lifecycle.canary import in_canary_fraction as jax_in_canary_fraction
from predictionio_tpu.resilience.breaker import reset_breakers as jax_reset_breakers
from predictionio_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
    LocalProcessSpawner,
    ReplicaSpawner,
)
from predictionio_tpu_torch.fleet.membership import REPLICA_HEADER, FleetState
from predictionio_tpu_torch.fleet.router import create_router_app
from predictionio_tpu_torch.lifecycle.canary import in_canary_fraction
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience.breaker import reset_breakers
from predictionio_tpu_torch.server.httpd import AppServer

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


def _post(url, payload, headers=None, timeout=TIMEOUT):
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


def _get(url, timeout=TIMEOUT):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, None


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def trained_home(tmp_path_factory):
    """Events + one recommendation generation trained by the port on the
    CPU (rank 4) in a fresh PIO_HOME."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.tools import commands as pt_cmd

    home = tmp_path_factory.mktemp("torch_fleet_chaos") / "pio_home"
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    app = pt_cmd.app_new(storage, "fleet").app
    rng = np.random.default_rng(5)
    storage.l_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"m{i}",
              properties=DataMap({"rating": float(rng.uniform(1, 5))}))
        for u in range(12) for i in range(10) if rng.random() < 0.8
    ], app.id)
    engine = resolve_engine_factory("recommendation")()
    params = engine.params_from_json({
        "datasource": {"name": "ratings", "params": {"appName": "fleet"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}],
    })
    run_train(engine, params, ctx=EngineContext(storage=storage, device="cpu"),
              engine_factory="recommendation", storage=storage)
    storage.close()
    return home


def _env(home):
    return dict(os.environ, PIO_HOME=str(home), PIO_ALERTS="0")


def _spawn_replica(home, port):
    return subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "deploy",
         "--engine", "recommendation", "--device", "cpu", "--ip", "127.0.0.1",
         "--port", str(port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=_env(home),
        cwd=REPO,
    )


def _wait_ready(port, proc, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            code, _ = _get(f"http://127.0.0.1:{port}/readyz", timeout=2)
            if code == 200:
                return
        except Exception:
            pass
        if proc is not None and proc.poll() is not None:
            raise RuntimeError("replica subprocess died at boot")
        time.sleep(0.25)
    raise TimeoutError(f"replica on :{port} never became ready")


class TestSigkillReplicaMidTraffic:
    N = 3

    @pytest.fixture()
    def stack(self, trained_home):
        ports = [_free_port() for _ in range(self.N)]
        procs = [_spawn_replica(trained_home, p) for p in ports]
        router = None
        fleet = None
        try:
            for port, proc in zip(ports, procs):
                _wait_ready(port, proc)
            registry = MetricsRegistry()
            fleet = FleetState([f"http://127.0.0.1:{p}" for p in ports],
                               registry=registry, eject_after=2)
            fleet.probe_once()
            assert len(fleet.routable()) == self.N
            router = AppServer(create_router_app(fleet, registry=registry),
                               "127.0.0.1", 0).start_background()
            yield ports, procs, fleet, f"http://127.0.0.1:{router.port}"
        finally:
            if router is not None:
                router.shutdown()
            if fleet is not None:
                fleet.stop()
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=10)

    def test_affinity_failover_and_rejoin(self, trained_home, stack):
        ports, procs, fleet, base = stack
        query = {"user": "u3", "num": 5}

        # -- phase 1: entity affinity across 100 requests ----------------
        homes = set()
        baseline_body = baseline_variant = None
        for _ in range(100):
            status, body, headers = _post(base + "/queries.json", query)
            assert status == 200
            homes.add(headers[REPLICA_HEADER])
            baseline_body = body
            baseline_variant = headers.get("X-Pio-Variant")
        assert len(homes) == 1, f"affinity broke: {homes}"
        home_rid = homes.pop()
        assert home_rid == fleet.route_order("u3")[0].replica_id
        spread = set()
        for u in range(30):
            status, _body, headers = _post(base + "/queries.json",
                                           {"user": f"u{u % 12}", "num": 3})
            assert status == 200
            spread.add(headers[REPLICA_HEADER])
        assert len(spread) > 1
        canary_before = in_canary_fraction("u3", 0.3)
        assert canary_before == jax_in_canary_fraction("u3", 0.3)

        # -- phase 2: SIGKILL the fixed entity's home mid-traffic --------
        victim_port = int(home_rid.rsplit(":", 1)[1])
        victim_proc = procs[ports.index(victim_port)]
        results: list[tuple[int, float]] = []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    status, _b, _h = _post(base + "/queries.json", query,
                                           {"X-Pio-Deadline": "15"}, timeout=20)
                except Exception:
                    status = -1
                results.append((status, time.perf_counter() - t0))

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        os.kill(victim_proc.pid, signal.SIGKILL)
        victim_proc.wait(timeout=10)
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        statuses = [s for s, _ in results]
        assert len(statuses) > 20
        assert set(statuses) == {200}, f"non-200 under kill: {sorted(set(statuses))}"
        lats = sorted(d for _, d in results)
        p99 = lats[int(len(lats) * 0.99)]
        assert p99 < 10.0, f"p99 {p99:.1f}s unbounded under replica kill"

        # -- phase 3: the corpse is ejected ------------------------------
        fleet.probe_once()
        fleet.probe_once()
        snap = fleet.snapshot()
        dead = [r for r in snap["replicas"] if r["replica"] == home_rid]
        assert dead and not dead[0]["healthy"]
        assert snap["routable"] == self.N - 1

        # -- phase 4: answers + canary assignment coherent post-failover -
        status, body, headers = _post(base + "/queries.json", query)
        assert status == 200
        assert headers[REPLICA_HEADER] != home_rid
        assert headers[REPLICA_HEADER] == fleet.route_order("u3")[0].replica_id
        assert body == baseline_body
        assert headers.get("X-Pio-Variant") == baseline_variant
        assert in_canary_fraction("u3", 0.3) == canary_before

        # -- phase 5: revival rejoins via /readyz ------------------------
        revived = _spawn_replica(trained_home, victim_port)
        procs.append(revived)
        _wait_ready(victim_port, revived)
        fleet.probe_once()
        assert fleet.snapshot()["routable"] == self.N
        status, body, headers = _post(base + "/queries.json", query)
        assert status == 200
        assert headers[REPLICA_HEADER] == home_rid
        assert body == baseline_body


# ---------------------------------------------------------------------------
# the autoscaler loop: scale 1 -> N, drain N -> 1 without dropping a request
# ---------------------------------------------------------------------------


def make_inprocess_replica(home):
    """A real port prediction server (threaded front end, a real
    ``DeployedEngine`` with its generation refcounts, ``device="cpu"``)
    whose algorithm blocks on ``gate`` when one is armed: the in-flight
    request a drain must wait for."""
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server_app,
        deploy_engine,
    )

    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    deployed = deploy_engine("recommendation", storage=storage, device="cpu")
    algo = deployed.algorithms[0]
    hold = {"gate": None}
    predict = algo.predict

    def held_predict(model, query):
        gate = hold["gate"]
        if gate is not None:
            gate.wait(30)
        return predict(model, query)

    algo.predict = held_predict
    registry = MetricsRegistry()
    app = create_prediction_server_app(deployed, use_microbatch=False, registry=registry,
                                       alerts_autostart=False)
    server = AppServer(app, "127.0.0.1", 0).start_background()
    return server, deployed, hold, storage


class InProcessSpawner(ReplicaSpawner):
    """Real in-process port replicas; drain() waits on the victim's REAL
    generation refcount before shutting its server down."""

    def __init__(self, home):
        self.home = home
        self.live: dict[str, tuple] = {}
        self.drain_waited_on: list[str] = []

    def spawn(self) -> str:
        server, deployed, hold, storage = make_inprocess_replica(self.home)
        url = f"http://127.0.0.1:{server.port}"
        self.live[url] = (server, deployed, hold, storage)
        return url

    def drain(self, url: str) -> None:
        server, deployed, _hold, storage = self.live.pop(url)
        drained = deployed.wait_drained(deployed.instance.id, timeout=25.0)
        assert drained, "drain timed out with a request still in flight"
        self.drain_waited_on.append(url)
        server.shutdown()
        storage.close()


def saturated():
    return {"max_sustainable_qps": 100.0, "headroom_frac": -0.5,
            "recommended_replicas": 3, "scale_hint": "up",
            "inputs": {"observed_qps": 150.0}}


def idle():
    return {"max_sustainable_qps": 100.0, "headroom_frac": 0.95,
            "recommended_replicas": 1, "scale_hint": "hold_or_down",
            "inputs": {"observed_qps": 5.0}}


class TestAutoscalerClosesTheLoop:
    def test_scale_up_then_drain_without_dropping_inflight(self, trained_home):
        spawner = InProcessSpawner(trained_home)
        registry = MetricsRegistry()
        fleet = FleetState(registry=registry, eject_after=3)
        fleet.scrape_capacity_once = lambda: {}
        clock = [0.0]
        auto = Autoscaler(
            fleet, spawner,
            AutoscalerPolicy(min_replicas=1, max_replicas=3, scale_up_patience=1,
                             scale_down_patience=1, cooldown_s=5.0,
                             drain_timeout_s=30.0),
            registry=MetricsRegistry(), clock=lambda: clock[0],
        )
        fleet.add(spawner.spawn())
        router = AppServer(create_router_app(fleet, registry=registry, autoscaler=auto),
                           "127.0.0.1", 0).start_background()
        base = f"http://127.0.0.1:{router.port}"
        try:
            fleet.probe_once()

            def set_caps(cap):
                for rep in fleet.replicas():
                    with fleet._lock:
                        rep.last_capacity = dict(cap)

            set_caps(saturated())
            assert auto.tick() == "scale_up"
            clock[0] += 6.0
            set_caps(saturated())
            assert auto.tick() == "scale_up"
            assert fleet.active_count() == 3
            fleet.probe_once()
            assert len(fleet.routable()) == 3
            served_by = set()
            answers = {}
            for u in range(40):
                status, body, headers = _post(base + "/queries.json",
                                              {"user": f"u{u % 12}", "num": 3})
                assert status == 200
                served_by.add(headers[REPLICA_HEADER])
                answers.setdefault(u % 12, body)
                assert answers[u % 12] == body  # one model on every replica
            assert len(served_by) == 3

            set_caps(idle())
            clock[0] += 6.0
            victim_url = fleet.replicas()[-1].url
            _server, victim_deployed, victim_hold, _s = spawner.live[victim_url]
            gate = threading.Event()
            victim_hold["gate"] = gate
            inflight_result: list = []
            t = threading.Thread(target=lambda: inflight_result.append(
                _post(victim_url + "/queries.json", {"user": "u1"}, timeout=40)))
            t.start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not victim_deployed.inflight_snapshot():
                time.sleep(0.02)
            assert victim_deployed.inflight_snapshot(), "held request never took a slot"

            tick_result: list = []
            tick_thread = threading.Thread(target=lambda: tick_result.append(auto.tick()))
            tick_thread.start()
            time.sleep(1.0)
            assert tick_thread.is_alive(), "drain did not wait for refcount"
            assert fleet.get(victim_url).draining
            assert not inflight_result
            gate.set()
            t.join(timeout=30)
            tick_thread.join(timeout=30)
            assert tick_result == ["scale_down"]
            status, _body, _headers = inflight_result[0]
            assert status == 200, "the in-flight request was dropped"
            assert spawner.drain_waited_on == [victim_url]
            assert fleet.active_count() == 2
            assert victim_url not in spawner.live

            set_caps(idle())
            clock[0] += 6.0
            assert auto.tick() == "scale_down"
            assert fleet.active_count() == 1
            clock[0] += 6.0
            assert auto.tick() is None
            status, _b, _h = _post(base + "/queries.json", {"user": "z"})
            assert status == 200
        finally:
            router.shutdown()
            for server, _d, hold, storage in spawner.live.values():
                if hold["gate"] is not None:
                    hold["gate"].set()
                server.shutdown()
                storage.close()


class TestLocalProcessSpawnerDrainPoll:
    def test_wait_replica_drained_reads_status_surface(self, trained_home):
        server, deployed, hold, storage = make_inprocess_replica(trained_home)
        url = f"http://127.0.0.1:{server.port}"
        spawner = LocalProcessSpawner([], drain_timeout_s=5.0, poll_interval_s=0.05)
        try:
            assert spawner.wait_replica_drained(url) is True
            gate = threading.Event()
            hold["gate"] = gate
            result: list = []
            t = threading.Thread(target=lambda: result.append(
                _post(url + "/queries.json", {"user": "u2"}, timeout=40)))
            t.start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not deployed.inflight_snapshot():
                time.sleep(0.02)
            assert spawner.wait_replica_drained(url, timeout_s=0.5) is False
            gate.set()
            t.join(timeout=30)
            assert spawner.wait_replica_drained(url, timeout_s=5.0) is True
            assert result and result[0][0] == 200
            server.shutdown()
            assert spawner.wait_replica_drained(url, timeout_s=2.0) is True
        finally:
            hold["gate"] = None
            server.shutdown()
            storage.close()


# ---------------------------------------------------------------------------
# `fleet deploy` of the port's CLI, end to end
# ---------------------------------------------------------------------------


def _cmdline(pid: int) -> str:
    return Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode()


def _read_lines(proc, n, timeout_s=120) -> list[str]:
    lines: list[str] = []

    def read():
        while len(lines) < n:
            line = proc.stdout.readline()
            if not line:
                return
            lines.append(line.strip())

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout_s)
    return lines


def test_fleet_deploy_spawns_port_replicas_scales_and_stops(trained_home, tmp_path):
    """`fleet deploy --device cpu --autoscale` spawns the port's `deploy`
    (never the JAX package's) as pidfile daemons, routes through them, grows
    to a pinned 3 (a respawn) and drains back to 2 through `fleet scale`,
    and `POST /stop` stops the router and every replica."""
    import shutil

    from predictionio_tpu_torch.tools import daemon
    from predictionio_tpu_torch.tools.cli import main as cli_main

    home = tmp_path / "pio_home"
    shutil.copytree(trained_home, home)
    env = dict(_env(home), PIO_FLEET_TICK_S="0.2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "fleet", "deploy",
         "--engine", "recommendation", "--device", "cpu", "--replicas", "2",
         "--autoscale", "--ip", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
        cwd=REPO,
    )
    try:
        lines = _read_lines(proc, 3)
        assert len(lines) == 3 and lines[2].startswith("Router on http://"), lines
        assert lines[0].startswith("replica 1/2 ready at http://127.0.0.1:")
        assert lines[0].endswith(" s)")
        base = lines[2].split()[2]
        pidfiles = sorted((home / "pids").glob("replica-*.pid"))
        assert len(pidfiles) == 2
        for pf in pidfiles:
            pid = daemon.read_pidfile(pf)
            assert daemon.pid_alive(pid)
            cmd = _cmdline(pid)
            assert "-m predictionio_tpu_torch.tools.cli deploy" in cmd
            assert "--device cpu" in cmd
        homes = set()
        for u in range(12):
            status, _body, headers = _post(base + "/queries.json", {"user": f"u{u}", "num": 3})
            assert status == 200
            homes.add(headers[REPLICA_HEADER])
        assert len(homes) == 2

        def wait_total(n):
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                body = _get(base + "/fleet.json")[1]
                if body["total"] == n and body["routable"] == n:
                    return body
                time.sleep(0.2)
            raise TimeoutError(f"fleet never reached {n}: {body}")

        assert cli_main(["fleet", "scale", "3", "--url", base]) == 0
        body = wait_total(3)
        assert body["autoscaler"]["last_event"]["event"] == "scale_up"
        assert len(list((home / "pids").glob("replica-*.pid"))) == 3
        assert cli_main(["fleet", "status", "--url", base]) == 0
        assert cli_main(["fleet", "scale", "2", "--url", base]) == 0
        body = wait_total(2)
        assert body["autoscaler"]["last_event"]["event"] == "scale_down"
        assert len(list((home / "pids").glob("replica-*.pid"))) == 2
        live = [daemon.read_pidfile(pf) for pf in (home / "pids").glob("replica-*.pid")]
        status, _b, _h = _post(base + "/stop", {})
        assert status == 200
        assert proc.wait(timeout=60) == 0
        assert not list((home / "pids").glob("replica-*.pid"))
        assert not any(daemon.pid_alive(pid) for pid in live)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        for pf in (home / "pids").glob("*.pid"):
            daemon.stop_pidfile(pf, timeout=2.0)
