"""The port's watch loop end to end, on the CPU: a two-tenant deploy over
a storage daemon, every answer billed, rules watching, bundles recorded
and a trace assembled across processes.

A ``storageserver`` process (parquet events) holds every repository.  Two
small ALS models (rank 4) are trained through it, deployed as tenants
``one`` and ``two`` (``deploy_tenant_engines`` + the multi-tenant app,
``device="cpu"``, feedback on) with the watch loop on (the default pack on
a frozen clock, an incident recorder into the test's directory), served
by the asyncio front end with waves of up to 1,024.  Then:

- 1,024 queries for ``one`` queue behind a held wave and go as one wave
  (the device route: at least 512 known users, the plain top-k on the
  CPU); ``two`` gets 16 one at a time.  The ledger's device seconds over
  all apps equal the batcher's ``pio_microbatch_device_seconds`` sum
  within 1e-6 of it, every answer is billed to its tenant, and
  ``cost_skew`` fires for ``one`` within ``for_s`` and two ticks;
- a query sent with ``X-Pio-Trace-Id`` writes its feedback event through
  the daemon, and ``pio trace`` over the deploy and the daemon joins both
  processes, with the wave's stages on a ``device:`` lane;
- the daemon is SIGKILLed: the next answer's feedback write fails and
  opens the breaker, ``breaker_open`` fires on the next tick, one bundle
  is written for it, ``status --url`` exits 1 naming it, and the ``costs``,
  ``alerts``, ``top``, ``capacity`` and ``incident`` verbs read the
  deploy; a wave still answers.

Every server binds port 0 and is shut down in ``finally``; every client
call has a timeout.
"""

from __future__ import annotations

import asyncio
import contextlib
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs.alerts import AlertEvaluator
from predictionio_tpu_torch.obs.costs import CostLedger
from predictionio_tpu_torch.obs.incident import IncidentRecorder, load_bundle
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience import breaker as pt_breaker
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tools import cli as pt_cli
from predictionio_tpu_torch.tools import commands as pt_cmd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 20
N_USERS, N_ITEMS, N_EVENTS = 600, 40, 3000
WAVE = 1024


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _spawn_daemon(root) -> tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
         "storageserver", "--ip", "127.0.0.1", "--port", "0",
         "--root", str(root), "--events", "parquet", "--no-compact"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
    )
    line: list[str] = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(timeout=60)
    if not line or "Storage daemon on http://" not in line[0]:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
        raise RuntimeError(f"storage daemon did not bind: {line}")
    return proc, int(line[0].split("http://127.0.0.1:")[1].split()[0])


def _train(storage, app_name: str, seed: int, engine_id: str):
    app = pt_cmd.app_new(storage, app_name).app
    rng = np.random.default_rng(seed)
    storage.l_events().insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{n % N_USERS}",
              target_entity_type="item",
              target_entity_id=f"i{int(rng.integers(0, N_ITEMS))}",
              properties=DataMap({"rating": float(rng.integers(1, 6))}))
        for n in range(N_EVENTS)], app.id)
    engine = resolve_engine_factory("recommendation")()
    params = engine.params_from_json({
        "datasource": {"name": "ratings", "params": {"appName": app_name}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}],
    })
    inst = run_train(engine, params, ctx=EngineContext(storage=storage, device="cpu"),
                     engine_factory="recommendation", engine_id=engine_id,
                     storage=storage)
    assert inst is not None and inst.status == "COMPLETED"
    return app, inst


def _post(port, payload, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/queries.json", json.dumps(payload),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


async def _aio_post(port, payload, headers):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    head = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    writer.write(
        (f"POST /queries.json HTTP/1.1\r\nHost: x\r\nContent-Type: "
         f"application/json\r\nContent-Length: {len(body)}\r\n{head}"
         "Connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout=120)
    writer.close()
    return int(raw.split(b" ", 2)[1])


def _burst(app, port, n, tenant):
    """``n`` queries for ``tenant`` queued behind a held wave, so the next
    wave takes them all; returns their status codes."""
    batcher = app.microbatcher
    real = batcher.batch_fn
    gate = threading.Event()
    held = threading.Event()

    def gated(items):
        if not held.is_set():
            held.set()
            gate.wait(60)
        return real(items)

    batcher.batch_fn = gated
    try:
        hold = threading.Thread(target=_post, args=(port, {"user": "u0", "num": 4},
                                                    {"X-Pio-App": tenant}))
        hold.start()
        assert held.wait(TIMEOUT)

        async def go():
            tasks = [asyncio.ensure_future(_aio_post(
                port, {"user": f"u{i % N_USERS}", "num": 4}, {"X-Pio-App": tenant}))
                for i in range(n)]
            for _ in range(600):
                if len(batcher._pending) >= n:
                    break
                await asyncio.sleep(0.05)
            gate.set()
            return await asyncio.gather(*tasks)

        codes = asyncio.run(go())
        hold.join(TIMEOUT)
        return codes
    finally:
        gate.set()
        batcher.batch_fn = real


def _cli(argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pt_cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _device_seconds(reg) -> tuple[float, int]:
    fam = reg.get("pio_microbatch_device_seconds")
    total, count = 0.0, 0
    for _, child in fam.series():
        total += child.sum
        count += child.count
    return total, count


@pytest.fixture(autouse=True)
def _isolate_breakers():
    pt_breaker.reset_breakers()
    yield
    pt_breaker.reset_breakers()


def test_two_tenants_billed_watched_traced_and_recorded(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_INCIDENT_DIR", str(tmp_path / "incidents"))
    proc, dport = _spawn_daemon(tmp_path / "root")
    daemon = f"http://127.0.0.1:{dport}"
    storage = StorageRuntime(StorageConfig.from_env({
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_SOURCES_R_TYPE": "remote",
        "PIO_STORAGE_SOURCES_R_URL": daemon,
        "PIO_STORAGE_SOURCES_R_TIMEOUT": "30",
        "PIO_STORAGE_SOURCES_R_RETRIES": "1",
        "PIO_STORAGE_SOURCES_R_BREAKER_THRESHOLD": "1",
        "PIO_STORAGE_SOURCES_R_BREAKER_RESET_S": "600",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R",
    }))
    server = None
    try:
        app_one, inst_one = _train(storage, "one", 0, "default")
        _, inst_two = _train(storage, "two", 1, "two")
        tenants = pt_server.deploy_tenant_engines([
            {"app": "one", "engine_factory": "recommendation",
             "engine_instance_id": inst_one.id},
            {"app": "two", "engine_factory": "recommendation", "engine_id": "two",
             "engine_instance_id": inst_two.id},
        ], storage=storage, device="cpu")
        reg = MetricsRegistry()
        clock = Clock()
        ledger = CostLedger(window_s=3600.0, registry=reg)
        incidents = IncidentRecorder(str(tmp_path / "incidents"), registry=reg,
                                     min_interval_s=0.0, stack_burst_s=0.05)
        alerts = AlertEvaluator(registry=reg, clock=clock, incidents=incidents)
        app = pt_server.create_multi_tenant_server_app(
            tenants, use_microbatch=True, max_batch=WAVE, max_queue=0,
            registry=reg, costs=ledger, alerts=alerts, incidents=incidents,
            alerts_autostart=False,
            feedback=pt_server.FeedbackConfig(enabled=True, app_id=app_one.id),
        )
        assert app.alerts is alerts and alerts.app is app
        # the held burst is slow by construction: the latency objective
        # must not page for it (slo_burn is critical)
        app.slo.latency_threshold_s = 600.0
        server = pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
        url = f"http://127.0.0.1:{server.port}"

        # -- the billed burst and the skew ---------------------------------
        codes = _burst(app, server.port, WAVE, "one")
        assert codes == [200] * WAVE
        for i in range(16):
            assert _post(server.port, {"user": f"u{i}", "num": 4},
                         {"X-Pio-App": "two"})[0] == 200
        sizes = app.microbatcher.wave_sizes
        assert max(sizes) == WAVE, sizes
        snap = ledger.snapshot()
        by_app = {}
        for row in snap["totals"]:
            agg = by_app.setdefault(row["app"], [0.0, 0.0])
            agg[0] += row["requests"]
            agg[1] += row["device_s"]
        assert by_app["one"][0] == WAVE + 1 and by_app["two"][0] == 16
        dev_total, waves = _device_seconds(reg)
        billed = sum(v[1] for v in by_app.values())
        assert waves == sum(sizes.values())
        assert abs(billed - dev_total) <= 1e-6 * dev_total, (billed, dev_total)
        assert by_app["one"][1] / billed > 0.75
        assert alerts.tick()["pending"] >= 1
        clock.advance(alerts.interval_s)
        alerts.tick()
        clock.advance(alerts.interval_s)
        alerts.tick()
        skew = [a for a in alerts.firing() if a["rule"] == "cost_skew"]
        assert [a["key"] for a in skew] == ["app=one"]
        rc, _, err = _cli(["status", "--url", url])
        assert rc == 0 and "cost_skew" in err

        # -- a trace across the deploy and the daemon ------------------------
        tid = "watchtrace01"
        status, headers, _ = _post(server.port, {"user": "u3", "num": 4},
                                   {"X-Pio-App": "one", "X-Pio-Trace-Id": tid})
        assert status == 200 and headers["X-Pio-Trace-Id"] == tid
        rc, out, err = _cli(["trace", tid, "--from", f"{url},{daemon}", "--json"])
        assert rc == 0, err
        tl = json.loads(out)
        assert len(tl["processes"]) >= 2, tl["processes"]
        assert any(p.startswith("storage-server:") for p in tl["processes"]), tl["processes"]

        def lanes(nodes):
            for n in nodes:
                yield n.get("track", "spans")
                yield from lanes(n.get("children", ()))

        assert any(t.startswith("device:") for t in lanes(tl["spans"]))

        # -- the daemon dies --------------------------------------------------
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=TIMEOUT)
        assert _post(server.port, {"user": "u5", "num": 4},
                     {"X-Pio-App": "one"})[0] == 200
        assert any(s.get("state") == "open"
                   for s in pt_breaker.breaker_states().values())
        clock.advance(alerts.interval_s)
        alerts.tick()
        fired = {a["rule"]: a for a in alerts.firing()}
        assert fired["breaker_open"]["severity"] == "critical"
        rows = incidents.list()
        assert [r["rule"] for r in rows].count("breaker_open") == 1
        bundle = load_bundle(rows[0]["path"])
        assert any(b["state"] == "open" for b in bundle["breakers"].values())
        rc, out, err = _cli(["status", "--url", url])
        assert rc == 1 and "WARNING: alert breaker_open" in err
        # a wave still answers (its feedback write fails, the answer does not)
        codes = _burst(app, server.port, 64, "two")
        assert codes == [200] * 64

        # -- the read-only verbs against the deploy --------------------------
        rc, out, _ = _cli(["alerts", "--url", url])
        assert rc == 1 and "breaker_open" in out
        rc, out, _ = _cli(["costs", "--url", url, "--json"])
        assert rc == 0 and {r["app"] for r in json.loads(out)["totals"]} >= {"one", "two"}
        rc, out, _ = _cli(["top", "--url", url, "--once"])
        assert rc == 0 and "alerts:" in out and "one" in out
        rc, out, _ = _cli(["capacity", "--url", url])
        assert rc == 0 and "device ceiling" in out
        rc, out, _ = _cli(["incident", "list", "--url", url])
        assert rc == 0 and rows[0]["id"] in out
        rc, out, _ = _cli(["incident", "show", rows[0]["id"], "--url", url])
        assert rc == 0 and "breaker_open" in out
    finally:
        if server is not None:
            server.shutdown()
        storage.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=TIMEOUT)
