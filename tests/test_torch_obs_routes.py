"""The observability routes of the port's deploy and event server against
the JAX package's, on the CPU, request for request.

One JAX-trained explicit-ALS model (rank 4) is deployed by both packages
from the same sqlite file and served through their own micro-batched
``create_prediction_server_app`` under their own ``AsyncAppServer``; both
event servers serve the same app under the threaded ``AppServer``.  The
same requests go to both:

- the same observability route set, status codes and key gating (with and
  without the access key; ``/healthz`` always public; ``POST
  /debug/profile`` refused without any key), less the routes of the
  modules the port leaves out (:data:`LEFT_OUT_ROUTES`);
- the same JSON top-level keys on every JSON route, less the named
  left-out keys;
- the port's ``/metrics`` families equal the JAX package's after the same
  traffic, less :data:`LEFT_OUT_FAMILY_PREFIXES` and
  :data:`LEFT_OUT_FAMILIES` (each named with its module);
- ``X-Pio-Request-Id`` adopted or minted and echoed, then found in
  ``/logs.json`` (the wave's log line) and ``/explain.json`` (the answer's
  items, exactly as answered), and the flight recorder keeping the
  answer's wave meta;
- a forced device wave of 520 queries whose five-way host split sums to
  each item's ``device_s``, with the same meta keys as the JAX wave's less
  the named ones, and ``als.fused_topk`` on ``/efficiency.json``;
- ``/readyz`` 200 with every check true, then 503 once the batcher closes
  (``draining``);
- on the port's two front ends, ``/spans.json`` keeping a request's
  fragments when its caller sent ``X-Pio-Trace-Id``, and none otherwise;
- the event servers' scrape surface without an operator key and the debug
  surface behind one, ``pio_events_ingested_total`` counting the accepted
  events, ``/readyz`` probing the event and metadata stores.

Every server binds port 0 and is shut down in ``finally``; every client
call has a timeout of 10 s.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import re
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import (
    resolve_engine_factory as jax_resolve_engine_factory,
)
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.data.datamap import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.obs import http as jax_obs_http
from predictionio_tpu.obs import sampling as jax_sampling
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import event_server as jax_es
from predictionio_tpu.server import httpd as jax_httpd
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs import device as pt_device
from predictionio_tpu_torch.obs import http as pt_obs_http
from predictionio_tpu_torch.obs import sampling as pt_sampling
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import event_server as pt_es
from predictionio_tpu_torch.server import httpd as pt_httpd
from predictionio_tpu_torch.server import prediction_server as pt_server

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 20, 30, 300
#: a wave past both packages' device floor (the engine modules imported
#: above also register the "recommendation" factory)
WAVE = pt_rec.ALSAlgorithm.DEVICE_BATCH_MIN + 8
assert WAVE == jax_rec.ALSAlgorithm.DEVICE_BATCH_MIN + 8 == 520
TIMEOUT = 10
KEY = "obs-key"

#: deploy routes of JAX modules the port leaves out (each with its module)
LEFT_OUT_ROUTES: set[str] = set()

#: /metrics families of the JAX deploy that the port does not register,
#: by the left-out module that registers them
LEFT_OUT_FAMILY_PREFIXES = (
    "pio_jax_live_buffer_",   # jax.live_arrays: no torch counterpart
    "pio_jax_pjit_cache_",    # the jit cache: no torch counterpart
)

#: and single families, each with why the port's CPU deploy has none
LEFT_OUT_FAMILIES = {
    # the port reads device memory only in a process that initialized
    # CUDA (a CPU deploy has no card); JAX registers it on every scrape
    "pio_jax_device_memory_bytes",
}

#: top-level JSON keys of JAX routes that the port leaves out
LEFT_OUT_KEYS = {
    # each package's breakers are process-wide and show only once one
    # exists: another test file in this worker may have made a JAX one
    "/slo.json": {"breakers"},
}

#: readiness checks of the JAX deploy the port leaves out
LEFT_OUT_CHECKS: set[str] = set()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One JAX-trained model, deployed by both packages from its PIO_HOME,
    and the access key of its app."""
    home = tmp_path_factory.mktemp("torch_obs_routes") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    desc = jax_cmd.app_new(jax_storage, "obsapp")
    rng = np.random.default_rng(0)
    levents = jax_storage.l_events()
    for n in range(N_EVENTS):
        levents.insert(
            JaxEvent(
                event="rate", entity_type="user", entity_id=f"u{n % N_USERS}",
                target_entity_type="item", target_entity_id=f"i{n % N_ITEMS}",
                properties=JaxDataMap({"rating": float(rng.integers(1, 6))}),
            ),
            desc.app.id,
        )
    engine = jax_resolve_engine_factory("recommendation")()
    params = engine.params_from_json(
        {
            "datasource": {"name": "ratings", "params": {"appName": "obsapp"}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}],
        }
    )
    instance = run_train(
        engine, params, ctx=JaxEngineContext(storage=jax_storage, mode="train"),
        engine_factory="recommendation", storage=jax_storage,
    )
    assert instance is not None and instance.status == "COMPLETED"
    port_storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    yield {
        "jax_storage": jax_storage,
        "port_storage": port_storage,
        "instance": instance,
        "key": desc.keys[0].key,
        "jax": jax_server.deploy_engine(
            "recommendation", storage=jax_storage, engine_instance_id=instance.id
        ),
        "port": pt_server.deploy_engine(
            "recommendation", storage=port_storage,
            engine_instance_id=instance.id, device="cpu",
        ),
    }
    for sampler in (jax_sampling.SAMPLER, pt_sampling.SAMPLER):
        sampler.stop()  # armed by /debug/stacks.json
    port_storage.close()
    jax_storage.close()


def _request(port, method, path, body=None, headers=None):
    """(status, headers, raw body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _json(raw):
    try:
        return json.loads(raw)
    except ValueError:
        return None


def _deploys(trained, **kw):
    """(name, app, server) of both packages' micro-batched deploys with the
    access key, each on its own fresh registry, started on port 0."""
    jax_app = jax_server.create_prediction_server_app(
        trained["jax"], use_microbatch=True, registry=JaxRegistry(),
        enable_alerts=False, access_key=KEY, **kw,
    )
    pt_app = pt_server.create_prediction_server_app(
        trained["port"], use_microbatch=True, registry=MetricsRegistry(),
        enable_alerts=False, access_key=KEY, **kw,
    )
    return [
        ("jax", jax_app, jax_aio.AsyncAppServer(jax_app, "127.0.0.1", 0).start_background()),
        ("port", pt_app, pt_aio.AsyncAppServer(pt_app, "127.0.0.1", 0).start_background()),
    ]


def _obs_routes(app, is_obs) -> set[tuple[str, str]]:
    """(method, path) of the app's observability routes."""
    out = set()
    for method, pattern, _ in app._routes:
        path = re.sub(r"\\(.)", r"\1", pattern.pattern.strip("^$"))
        if is_obs(path):
            out.add((method, path))
    return out


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}


GET_ROUTES = [
    "/metrics", "/metrics.json", "/traces.json", "/spans.json", "/logs.json",
    "/efficiency.json", "/locks.json", "/hotpath.json", "/capacity.json",
    "/debug/stacks.json", "/explain.json", "/debug/flight.json",
    "/debug/profile", "/healthz", "/readyz", "/slo.json", "/quality.json",
    "/tenants.json", "/costs.json", "/shards.json",
]


def test_deploy_routes_codes_gating_and_keys(trained):
    servers = _deploys(trained)
    try:
        routes = {n: _obs_routes(app, mod.is_observability_path)
                  for (n, app, _), mod in zip(servers, (jax_obs_http, pt_obs_http))}
        jax_paths = {p for _, p in routes["jax"]}
        assert routes["port"] <= routes["jax"]
        assert {p for _, p in routes["jax"] - routes["port"]} == (
            LEFT_OUT_ROUTES & jax_paths
        )
        assert {p for _, p in routes["port"]} == set(GET_ROUTES) | {"/debug/profile"}
        got = {}
        for name, _, server in servers:
            rows = []
            for path in GET_ROUTES:
                anon = _request(server.port, "GET", path)
                keyed = _request(server.port, "GET", path,
                                 headers={"Authorization": f"Bearer {KEY}"})
                body = _json(keyed[2])
                keys = None
                if isinstance(body, dict) and path != "/metrics.json":
                    keys = set(body) - LEFT_OUT_KEYS.get(path, set())
                rows.append((path, anon[0], keyed[0], keys,
                             "X-Pio-Request-Id" in keyed[1]))
            for query in ("?seconds=0", "?seconds=x", ""):
                rows.append(("POST /debug/profile" + query,
                             _request(server.port, "POST", "/debug/profile" + query)[0]))
            rows.append(("POST bad", _request(
                server.port, "POST", "/debug/profile?seconds=0",
                headers={"Authorization": f"Bearer {KEY}"})[0]))
            ready = _json(_request(server.port, "GET", "/readyz",
                                   headers={"Authorization": f"Bearer {KEY}"})[2])
            rows.append(("checks", {k: v for k, v in ready["checks"].items()
                                    if k not in LEFT_OUT_CHECKS}))
            got[name] = rows
        assert got["port"] == got["jax"]
        codes = {r[0]: r[1:3] for r in got["port"] if len(r) == 5}
        assert codes["/healthz"] == (200, 200)
        assert all(v == (401, 200) for p, v in codes.items() if p != "/healthz")
        assert got["port"][-1] == ("checks", {
            "model_loaded": True, "microbatcher": True, "event_store": True,
            "storage_breakers": True,
        })
    finally:
        for _, _, server in servers:
            server.shutdown()


def test_readyz_is_503_while_draining(trained):
    servers = _deploys(trained)
    try:
        out = {}
        for name, app, server in servers:
            before = _request(server.port, "GET", "/readyz",
                              headers={"Authorization": f"Bearer {KEY}"})
            app.microbatcher.close()
            after = _request(server.port, "GET", "/readyz",
                             headers={"Authorization": f"Bearer {KEY}"})
            body = _json(after[2])
            out[name] = (before[0], after[0], body["ready"],
                         body["checks"]["microbatcher"])
        assert out["port"] == out["jax"] == (200, 503, False, False)
    finally:
        for _, _, server in servers:
            server.shutdown()


def _query(port, user, rid=None, num=4):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Pio-Request-Id"] = rid
    return _request(port, "POST", "/queries.json",
                    json.dumps({"user": user, "num": num}), headers)


def test_metrics_families_match_after_the_same_traffic(trained):
    servers = _deploys(trained)
    try:
        fams = {}
        for name, _, server in servers:
            for i in range(12):
                assert _query(server.port, f"u{i % N_USERS}")[0] == 200
            assert _query(server.port, "nobody")[0] == 200
            assert _request(server.port, "POST", "/queries.json", b"[1]")[0] == 400
            status, headers, raw = _request(
                server.port, "GET", "/metrics",
                headers={"Authorization": f"Bearer {KEY}"})
            assert status == 200
            assert headers["Content-Type"] == jax_obs_http.PROMETHEUS_CONTENT_TYPE
            fams[name] = _families(raw.decode())
        jax_only = {f for f in fams["jax"] - fams["port"]
                    if not f.startswith(LEFT_OUT_FAMILY_PREFIXES)}
        assert jax_only == LEFT_OUT_FAMILIES
        assert fams["port"] - fams["jax"] == set()
        for must in ("pio_request_latency_seconds", "pio_microbatch_stage_seconds",
                     "pio_hotpath_stage_seconds", "pio_device_transfer_bytes",
                     "pio_runtime_sample_seconds", "pio_lock_wait_seconds"):
            assert must in fams["port"], must
    finally:
        for _, _, server in servers:
            server.shutdown()


def test_request_ids_reach_logs_explain_and_flight(trained):
    servers = _deploys(trained)
    auth = {"Authorization": f"Bearer {KEY}"}
    try:
        out = {}
        for name, _, server in servers:
            status, headers, raw = _query(server.port, "u3", rid="rid-given-1")
            assert status == 200 and headers["X-Pio-Request-Id"] == "rid-given-1"
            assert headers["X-Pio-Trace-Id"] == "rid-given-1"
            status, headers, raw2 = _query(server.port, "u5")
            minted = headers["X-Pio-Request-Id"]
            assert status == 200 and re.fullmatch(r"[0-9a-f]{16}", minted)
            rows = []
            for rid, answer in (("rid-given-1", raw), (minted, raw2)):
                logs = _json(_request(server.port, "GET",
                                      f"/logs.json?request_id={rid}", headers=auth)[2])
                assert any(rid in (r.get("request_ids") or ())
                           for r in logs["logs"]), (name, rid)
                rec = _json(_request(server.port, "GET",
                                     f"/explain.json?request_id={rid}",
                                     headers=auth)[2])["record"]
                items = [{"item": d["item"], "score": d["score"]}
                         for d in _json(answer)["itemScores"]]
                assert rec["items"] == items
                assert rec["request_id"] == rid and rec["status"] == 200
                rows.append(set(rec))
            missing = _request(server.port, "GET",
                               "/explain.json?request_id=nope", headers=auth)
            flight = _json(_request(server.port, "GET",
                                    "/debug/flight.json?request_id=rid-given-1",
                                    headers=auth)[2])
            entry = flight["slowest"][0]
            assert entry["wave_size"] >= 1 and "device_breakdown" in entry
            assert entry["instance_id"] == trained["instance"].id
            out[name] = (rows, missing[0], set(entry))
        assert out["port"][1] == out["jax"][1] == 404
        # the JAX record adds the generation manifest's identity, its app
        # and the canary variant machinery; nothing the port records is
        # missing from the JAX record
        for port_keys, jax_keys in zip(out["port"][0], out["jax"][0]):
            assert port_keys <= jax_keys, port_keys - jax_keys
            # "cache": the JAX host replica reads user rows through the
            # factor cache; the port's ALS host replica reads them directly
            assert jax_keys - port_keys <= {"generation", "app", "cache"}
        assert out["port"][2] - {"wave_kernel_s", "wave_transfers"} <= out["jax"][2]
    finally:
        for _, _, server in servers:
            server.shutdown()


@pytest.mark.parametrize("kind", ["aio", "threaded"])
def test_spans_kept_for_a_trace_the_caller_opened(trained, kind):
    # the port keeps cross-process fragments for a request that came with
    # X-Pio-Trace-Id (its root span, and on the micro-batched route its
    # wave's device track); a request that opened no trace leaves none,
    # and still answers its request id as X-Pio-Trace-Id
    app = pt_server.create_prediction_server_app(
        trained["port"], use_microbatch=kind == "aio",
        registry=MetricsRegistry(), access_key=KEY)
    server = (pt_aio.AsyncAppServer if kind == "aio" else pt_httpd.AppServer)(
        app, "127.0.0.1", 0).start_background()
    auth = {"Authorization": f"Bearer {KEY}"}
    try:
        tid = f"trace-opened-{kind}"
        status, headers, _ = _request(
            server.port, "POST", "/queries.json",
            json.dumps({"user": "u2", "num": 4}),
            {"Content-Type": "application/json", "X-Pio-Trace-Id": tid})
        assert status == 200 and headers["X-Pio-Trace-Id"] == tid
        spans = _json(_request(server.port, "GET", f"/spans.json?trace_id={tid}",
                               headers=auth)[2])["spans"]
        names = {f["name"] for f in spans}
        assert "http.predictionserver" in names, names
        if kind == "aio":
            assert any(n.startswith("wave.") for n in names), names
        status, headers, _ = _query(server.port, "u3")
        rid = headers["X-Pio-Request-Id"]
        assert status == 200 and headers["X-Pio-Trace-Id"] == rid
        body = _json(_request(server.port, "GET", f"/spans.json?trace_id={rid}",
                              headers=auth)[2])
        assert body["spans"] == []
        # its request id still finds it
        rec = _json(_request(server.port, "GET", f"/explain.json?request_id={rid}",
                             headers=auth)[2])
        assert rec["record"]["request_id"] == rid
    finally:
        server.shutdown()
        if kind == "aio":
            app.microbatcher.close()


def _burst(batcher, items, metas):
    """Every item queued while a first wave holds the worker, so the next
    wave takes them all at once; then the answers in order."""
    real = batcher.batch_fn
    gate = threading.Event()

    def gated(batch):
        if batch == ["hold"]:
            gate.wait(TIMEOUT)
            return ["held"]
        return real(batch)

    batcher.batch_fn = gated

    async def burst():
        hold = asyncio.ensure_future(batcher.submit("hold"))
        while not batcher._in_wave:
            await asyncio.sleep(0.001)
        futs = [asyncio.ensure_future(batcher.submit(it, m))
                for it, m in zip(items, metas)]
        await asyncio.sleep(0)  # every submit has queued its item
        assert len(batcher._pending) == len(futs)
        gate.set()
        assert await hold == "held"
        return await asyncio.gather(*futs)

    try:
        return asyncio.run(asyncio.wait_for(burst(), timeout=120))
    finally:
        batcher.batch_fn = real


def test_forced_device_wave_split_sums_to_device_s(trained):
    users = [f"u{i % N_USERS}" for i in range(WAVE)]
    jax_app = jax_server.create_prediction_server_app(
        trained["jax"], use_microbatch=True, registry=JaxRegistry(),
        enable_alerts=False, max_batch=WAVE, max_queue=0,
    )
    pt_app = pt_server.create_prediction_server_app(
        trained["port"], use_microbatch=True, registry=MetricsRegistry(),
        max_batch=WAVE, max_queue=0,
    )
    eff = pt_device.default_efficiency()
    calls0 = eff.snapshot()["functions"].get("als.fused_topk", {}).get("calls", 0)
    try:
        jax_metas = [{} for _ in users]
        _burst(jax_app.microbatcher,
               [(jax_app.tenants.default, {"user": u, "num": 4}) for u in users],
               jax_metas)
        pt_metas = [{} for _ in users]
        results = _burst(pt_app.microbatcher,
                         [pt_server.QueuedQuery({"user": u, "num": 4}) for u in users],
                         pt_metas)
    finally:
        jax_app.microbatcher.close()
        pt_app.microbatcher.close()
    assert {r[0] for r in results} == {"ok"}
    for metas in (jax_metas, pt_metas):
        for m in metas:
            assert m["wave_size"] == WAVE and m["wave_fn"] == "als.fused_topk"
            split = m["device_breakdown"]
            assert set(split) == {"host_gather", "h2d", "compute", "d2h", "other"}
            assert abs(sum(split.values()) - m["device_s"]) <= max(
                0.01 * m["device_s"], 5e-6
            ), m
    assert set(pt_metas[0]) - set(jax_metas[0]) == {"wave_kernel_s"}
    assert set(jax_metas[0]) - set(pt_metas[0]) == set()
    m = pt_metas[0]
    assert m["pipelined"] and m["wave_device"] == "cpu:0"
    assert 0 < m["wave_kernel_s"] <= m["device_s"]
    assert m["device_breakdown"]["compute"] > 0
    assert m["wave_request_ids"] == []  # submitted outside any request
    fn = eff.snapshot()["functions"]["als.fused_topk"]
    assert fn["calls"] == calls0 + 1 and fn["source"] == "least_work"
    assert fn["utilization_hbm"] > 0


def _event_servers(trained, obs_key):
    """Both packages' event servers over the same storage, threaded front
    end, port 0."""
    return [
        ("jax", jax_httpd.AppServer(
            jax_es.create_event_server_app(
                trained["jax_storage"], registry=JaxRegistry(),
                obs_access_key=obs_key,
            ), "127.0.0.1", 0).start_background()),
        ("port", pt_httpd.AppServer(
            pt_es.create_event_server_app(
                trained["port_storage"], registry=MetricsRegistry(),
                obs_access_key=obs_key,
            ), "127.0.0.1", 0).start_background()),
    ]


@pytest.mark.parametrize("obs_key", [None, "ops-key"])
def test_event_server_routes_and_ingest_count(trained, obs_key, monkeypatch):
    monkeypatch.delenv("PIO_OBS_ACCESS_KEY", raising=False)
    servers = _event_servers(trained, obs_key)
    auth = {"Authorization": f"Bearer {obs_key}"} if obs_key else {}
    try:
        out = {}
        for name, server in servers:
            rows = []
            for path in GET_ROUTES:
                anon = _request(server.port, "GET", path)
                keyed = _request(server.port, "GET", path, headers=auth)
                body = _json(keyed[2])
                keys = None
                if isinstance(body, dict) and path != "/metrics.json":
                    keys = set(body) - LEFT_OUT_KEYS.get(path, set())
                rows.append((path, anon[0], keyed[0], keys))
            rows.append(("POST /debug/profile",
                         _request(server.port, "POST", "/debug/profile?seconds=0",
                                  headers=auth)[0]))
            accepted = 0
            for i in range(5):
                status, _, _ = _request(
                    server.port, "POST", f"/events.json?accessKey={trained['key']}",
                    json.dumps({"event": "view", "entityType": "user",
                                "entityId": f"x{i}", "targetEntityType": "item",
                                "targetEntityId": "i1"}),
                    {"Content-Type": "application/json"})
                accepted += status == 201
            metrics = _request(server.port, "GET", "/metrics", headers=auth)[2].decode()
            ingested = [ln for ln in metrics.splitlines()
                        if ln.startswith("pio_events_ingested_total{")]
            ready = _json(_request(server.port, "GET", "/readyz", headers=auth)[2])
            out[name] = (rows, accepted, ingested, ready)
        assert out["port"] == out["jax"]
        rows, accepted, ingested, ready = out["port"]
        assert accepted == 5 and ingested == ['pio_events_ingested_total{event="view"} 5']
        assert ready == {"ready": True,
                         "checks": {"event_store": True, "metadata_store": True}}
        codes = {r[0]: r[1:3] for r in rows if len(r) == 4}
        assert codes["/healthz"] == (200, 200)
        scrape = {"/metrics", "/metrics.json", "/traces.json", "/spans.json",
                  "/readyz", "/slo.json", "/costs.json"}
        for path, (anon, keyed) in codes.items():
            if path == "/healthz":
                continue
            if path in ("/hotpath.json", "/tenants.json"):
                # no hot-path tracker and no tenant registry on ingest
                assert (anon, keyed) == (404, 404)
            elif obs_key is None:
                assert (anon, keyed) == ((200, 200) if path in scrape else (404, 404))
            else:
                assert (anon, keyed) == (401, 200), path
    finally:
        for _, server in servers:
            server.shutdown()
