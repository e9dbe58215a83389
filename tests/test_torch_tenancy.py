"""The port's multi-tenant serving against the JAX package's.

``tenancy`` (the token bucket on a frozen clock, the stored-bytes
bin-packer over one stored blob, admission and its refusal, the snapshot
and its text), the per-tenant gate in ``httpd.admit_request`` (quota and
in-flight sheds, an unknown app), ``deploy_tenant_engines`` and
``create_multi_tenant_server_app``, ``deploy --app`` and ``tenants
--url``; and the slice as a whole: small ALS models trained by the JAX
package into one ``PIO_HOME`` (two generations of one engine, and a second
engine under other coordinates), served by both packages as two tenants
with a canary at 0.5 on the first, and one queued wave through each
package's micro-batcher.  Each query gets the same tenant and the same
variant in both, and the same answer: rendered bit for bit on the host
replica, and on the device route (the device floor patched down; the
port's plain top-k, the JAX package's Pallas kernel in interpret mode)
ids equal outside near ties and scores within rtol 1e-5, the serving
tests' tolerance.

Every server binds port 0 and is shut down in ``finally``; every client
call has a timeout of 10 s.
"""

from __future__ import annotations

import asyncio
import http.client
import json
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
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tenancy import quota as jax_quota
from predictionio_tpu.tenancy import registry as jax_registry
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tenancy import quota as pt_quota
from predictionio_tpu_torch.tenancy import registry as pt_registry
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 20, 30, 300
RTOL = 1e-5
TIMEOUT = 10


class Clock:
    """A frozen clock the test moves by hand."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _rate_events(storage, app_name: str, seed: int):
    app = jax_cmd.app_new(storage, app_name).app
    rng = np.random.default_rng(seed)
    levents = storage.l_events()
    for n in range(N_EVENTS):
        levents.insert(
            JaxEvent(
                event="rate", entity_type="user", entity_id=f"u{n % N_USERS}",
                target_entity_type="item", target_entity_id=f"i{n % N_ITEMS}",
                properties=JaxDataMap({"rating": float(rng.integers(1, 6))}),
            ),
            app.id,
        )


def _train(storage, app_name: str, iterations: int, engine_id="default"):
    engine = jax_resolve_engine_factory("recommendation")()
    params = engine.params_from_json({
        "datasource": {"name": "ratings", "params": {"appName": app_name}},
        "algorithms": [{"name": "als",
                        "params": {"rank": 4, "numIterations": iterations}}],
    })
    instance = run_train(
        engine, params, ctx=JaxEngineContext(storage=storage, mode="train"),
        engine_factory="recommendation", engine_id=engine_id, storage=storage,
    )
    assert instance is not None and instance.status == "COMPLETED"
    return instance


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """One PIO_HOME: generations A and B of the default engine (app
    ``one``) and C of engine ``two`` (app ``two``), all JAX-trained."""
    path = tmp_path_factory.mktemp("torch_tenancy") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(path)}))
    _rate_events(jax_storage, "one", 0)
    _rate_events(jax_storage, "two", 1)
    out = {
        "A": _train(jax_storage, "one", 2),
        "B": _train(jax_storage, "one", 3),
        "C": _train(jax_storage, "two", 2, engine_id="two"),
        "jax_storage": jax_storage,
        "port_storage": StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(path)})),
        "path": path,
    }
    yield out
    out["port_storage"].close()
    jax_storage.close()


def _specs(home, **extra):
    return [
        {"app": "one", "engine_factory": "recommendation",
         "engine_instance_id": home["A"].id, **extra.get("one", {})},
        {"app": "two", "engine_factory": "recommendation", "engine_id": "two",
         "engine_instance_id": home["C"].id, **extra.get("two", {})},
    ]


def _tenant_apps(home, fraction=0.5, **kw):
    """Both packages' two-tenant apps, the canary B staged on ``one``."""
    jt = jax_server.deploy_tenant_engines(
        _specs(home, **kw.pop("spec_extra", {})), storage=home["jax_storage"],
        registry=JaxRegistry())
    pt = pt_server.deploy_tenant_engines(
        _specs(home), storage=home["port_storage"], registry=MetricsRegistry(),
        device="cpu")
    if fraction:
        jt.get("one").deployed.stage_canary(home["B"], fraction)
        pt.get("one").deployed.stage_canary(home["B"], fraction)
    japp = jax_server.create_multi_tenant_server_app(
        jt, use_microbatch=True, registry=JaxRegistry(), enable_alerts=False, **kw)
    papp = pt_server.create_multi_tenant_server_app(
        pt, use_microbatch=True, registry=MetricsRegistry(), **kw)
    return jt, japp, pt, papp


def _burst(batcher, items):
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

    async def run():
        hold = asyncio.ensure_future(batcher.submit("hold"))
        while not batcher._in_wave:
            await asyncio.sleep(0.001)
        futs = [asyncio.ensure_future(batcher.submit(it)) for it in items]
        await asyncio.sleep(0)  # every submit has queued its item
        gate.set()
        await hold
        return await asyncio.gather(*futs)

    try:
        return asyncio.run(asyncio.wait_for(run(), timeout=120))
    finally:
        batcher.batch_fn = real


def _pairs(rendered):
    return [(x["item"], x["score"]) for x in rendered["itemScores"]]


def _hold_to(got, want, what):
    """Ids equal except inside a near tie of ``want``; scores within RTOL."""
    assert len(got) == len(want), what
    gi, gs = [x for x, _ in got], np.asarray([s for _, s in got])
    wi, ws = [x for x, _ in want], np.asarray([s for _, s in want])
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6, err_msg=str(what))
    for j in np.flatnonzero(np.asarray(gi) != np.asarray(wi)):
        gap = min(abs(ws[j] - ws[x]) for x in (j - 1, j + 1) if 0 <= x < len(ws))
        assert gap <= RTOL * abs(ws[j]) + 1e-6, (what, j)


def _wave(n_one=48, n_two=40):
    rng = np.random.default_rng(7)
    out = [("one", {"user": f"u{rng.integers(N_USERS)}", "num": 4})
           for _ in range(n_one)]
    out += [("two", {"user": f"u{rng.integers(N_USERS)}", "num": 5})
            for _ in range(n_two)]
    out.append(("one", {"user": "nobody", "num": 4}))
    out.append(("two", {"user": 3}))  # not a string: the extractor refuses it
    rng.shuffle(out)
    return out


# -- the slice as a whole: one partitioned wave through both packages --------


@pytest.mark.parametrize("route", ["host", "device"])
def test_partitioned_wave_equals_jax(home, monkeypatch, route):
    if route == "device":
        for cls in (jax_rec.ALSAlgorithm, pt_rec.ALSAlgorithm):
            monkeypatch.setattr(cls, "DEVICE_BATCH_MIN", 8)
    jt, japp, pt, papp = _tenant_apps(home, max_batch=256, max_queue=0)
    wave = _wave()
    try:
        jres = _burst(japp.microbatcher,
                      [(jt.get(app), payload) for app, payload in wave])
        items = [pt_server.QueuedQuery(payload, pt.get(app)) for app, payload in wave]
        pres = _burst(papp.microbatcher, items)
    finally:
        japp.microbatcher.close()
        papp.microbatcher.close()
    assert len(jres) == len(pres) == len(wave)
    parts = {}
    for (app, payload), j, p, it in zip(wave, jres, pres, items):
        jtag, jval, _, (jiid, jvariant), jprov = j
        ptag, pval, piid = p
        assert (ptag, piid, it.variant, it.prov["app"]) == (
            jtag, jiid, jvariant, jprov["app"]), (app, payload)
        assert it.prov["app"] == app and it.partition["app"] == app
        assert it.partition["variant"] == it.variant
        if ptag != "ok":
            assert ptag == "bad" and payload == {"user": 3}
            continue
        if route == "host":
            assert json.dumps(pval, sort_keys=True) == json.dumps(jval, sort_keys=True)
        else:
            _hold_to(_pairs(pval), _pairs(jval), payload)
        parts[(app, it.variant)] = it.partition
    # two tenants, the first split live/canary; every partition took its
    # own route: the device at or above the (patched) floor
    assert set(parts) == {("one", "default"), ("one", "canary"), ("two", "default")}
    for rec in parts.values():
        assert rec["on_device"] is (route == "device"), rec
        assert rec["size"] >= 8 and rec["split_s"] >= 0
        assert rec["dispatch_s"] >= 0 and rec["finalize_s"] >= 0
    variants = {(it.tenant.name, it.variant) for it in items}
    iids = {(it.variant, r[2]) for it, r in zip(items, pres) if it.tenant.name == "one"}
    assert variants == set(parts)
    assert iids == {("default", home["A"].id), ("canary", home["B"].id)}
    assert pt.get("one").deployed.inflight_snapshot() == {}


def test_poison_partition_fails_alone(home, monkeypatch):
    """A tenant whose generation fails every predict fails only its own
    partition; the other tenant's queries of the same wave answer."""
    jt, japp, pt, papp = _tenant_apps(home, fraction=0, max_batch=256, max_queue=0)
    broken = pt.get("two").deployed

    def boom(binding, queries, force=False):
        raise RuntimeError("tenant two's generation is corrupt")

    monkeypatch.setattr(broken, "predict_batch_bound", lambda b, q: boom(b, q))
    monkeypatch.setattr(broken, "dispatch_batch_bound", boom)
    wave = _wave(n_one=24, n_two=24)
    try:
        items = [pt_server.QueuedQuery(payload, pt.get(app)) for app, payload in wave]
        pres = _burst(papp.microbatcher, items)
    finally:
        japp.microbatcher.close()
        papp.microbatcher.close()
    by_app = {}
    for (app, _), r in zip(wave, pres):
        by_app.setdefault(app, set()).add(r[0])
    assert by_app["one"] == {"ok"}
    assert by_app["two"] <= {"err", "bad"} and "err" in by_app["two"]


# -- HTTP: the gate, headers, /tenants.json ----------------------------------


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = raw.decode()
        return resp.status, dict(resp.getheaders()), parsed
    finally:
        conn.close()


KEPT = ("X-Pio-App", "X-Pio-Variant", "X-Pio-Engine-Instance", "Retry-After",
        "X-Pio-Shed-Reason")


def test_gate_and_headers_match_jax(home):
    jt, japp, pt, papp = _tenant_apps(
        home, max_batch=32,
        spec_extra={"two": {"quota_rps": 0.001, "quota_burst": 2}})
    # the same quota on the port's tenant two
    pt.get("two").quota = pt_quota.TokenBucket(0.001, 2)
    servers = [jax_aio.AsyncAppServer(japp, "127.0.0.1", 0).start_background(),
               pt_aio.AsyncAppServer(papp, "127.0.0.1", 0).start_background()]
    calls = [
        ({"user": "u1", "num": 3}, {}),
        ({"user": "u2", "num": 3}, {"X-Pio-App": "one"}),
        ({"user": "u2", "num": 3}, {"X-Pio-App": "two"}),
        ({"user": "u3", "num": 3}, {"X-Pio-App": "two"}),
        ({"user": "u4", "num": 3}, {"X-Pio-App": "two"}),  # over quota: 503
        ({"user": "u4", "num": 3}, {"X-Pio-App": "nope"}),  # not resident: 404
        ({"user": "nobody", "num": 3}, {"X-Pio-App": "one"}),
    ]
    try:
        got = []
        for server in servers:
            rows = []
            for body, headers in calls:
                status, h, b = _request(server.port, "POST", "/queries.json",
                                        json.dumps(body), headers)
                rows.append((status, {k: h[k] for k in KEPT if k in h},
                             b if status == 200 else None))
            snap = _request(server.port, "GET", "/tenants.json")[2]
            one = _request(server.port, "GET", "/tenants.json?app=one")[2]
            missing = _request(server.port, "GET", "/tenants.json?app=zz")
            rows.append((sorted(snap), [t["app"] for t in snap["tenants"]],
                         [t["app"] for t in one["tenants"]], missing[0],
                         [t["quota"]["denied"] if t["quota"] else None
                          for t in snap["tenants"]]))
            status_json = _request(server.port, "GET", "/status.json")[2]
            rows.append(status_json["apps"])
            got.append(rows)
    finally:
        for server in servers:
            server.shutdown()
    assert got[1] == got[0]
    statuses = [r[0] for r in got[1][:len(calls)]]
    assert statuses == [200, 200, 200, 200, 503, 404, 200]
    assert got[1][4][1]["X-Pio-Shed-Reason"] == "tenant_quota"
    assert {r[1]["X-Pio-App"] for r in got[1][:4]} == {"one", "two"}
    assert got[1][-1] == ["one", "two"]


def test_tenants_cli_and_status_fold(home, capsys):
    _, japp, _, papp = _tenant_apps(home, fraction=0)
    japp.microbatcher.close()
    server = pt_aio.AsyncAppServer(papp, "127.0.0.1", 0).start_background()
    url = f"http://127.0.0.1:{server.port}"
    try:
        outs = []
        for main in (pt_cli.main, jax_cli.main):
            assert main(["tenants", "--url", url]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert outs[0].startswith("tenants: 2 resident")
        assert pt_cli.main(["tenants", "--url", url, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert [t["app"] for t in doc["tenants"]] == ["one", "two"]
        assert "device_memory" not in doc  # the CPU has no card to read
        assert pt_cli.main(["status", "--url", url]) == 0
        report = json.loads(capsys.readouterr().out)
        assert [r["app"] for r in report["tenants"]["rows"]] == ["one", "two"]
        assert pt_cli.main(["tenants", "--url", url, "--watch", "0.01",
                            "--watch-count", "2"]) == 0
        assert capsys.readouterr().out.count("--- pio tenants @") == 2
    finally:
        server.shutdown()


# -- tenancy's parts on the same inputs ---------------------------------------


def _bucket_trace(mod, ops):
    clock = Clock()
    bucket = mod.TokenBucket(2.0, 3, clock=clock)
    out = []
    for op, arg in ops:
        if op == "tick":
            clock.t += arg
            continue
        if op == "spend":
            out.append(bucket.try_spend(arg))
        elif op == "debit":
            bucket.debit(arg)
        out.append((round(bucket.tokens, 9), bucket.retry_after_s(), bucket.snapshot()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_equal_on_a_frozen_clock(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        kind = rng.choice(["spend", "spend", "debit", "tick"])
        arg = float(rng.choice([0.5, 1.0, 2.0])) if kind != "tick" else float(
            rng.uniform(0, 1.5))
        ops.append((str(kind), arg))
    assert _bucket_trace(pt_quota, ops) == _bucket_trace(jax_quota, ops)


@pytest.mark.parametrize("rate,burst", [(0, None), (-1, 2), (1, 0)])
def test_token_bucket_refuses_the_same_arguments(rate, burst):
    for mod in (pt_quota, jax_quota):
        with pytest.raises(ValueError):
            mod.TokenBucket(rate, burst)


def test_hbm_footprint_equal_on_the_same_blob(home):
    for name in ("A", "B", "C"):
        iid = home[name].id
        want = jax_registry.hbm_footprint(home["jax_storage"].models(), iid)
        assert pt_registry.hbm_footprint(home["port_storage"].models(), iid) == want > 0
    assert pt_registry.hbm_footprint(None, "x") == jax_registry.hbm_footprint(None, "x") == 0
    assert pt_registry.hbm_footprint(home["port_storage"].models(), "none") == 0


class _Stub:
    """A deployed-engine stand-in: the registry reads only these."""

    def __init__(self, iid):
        self.instance = type("I", (), {"id": iid})()
        self.variant_label = "default"


def _admission_trace(mod, budget):
    reg = mod.TenantRegistry(hbm_budget_bytes=budget,
                             registry=(JaxRegistry if mod is jax_registry
                                       else MetricsRegistry)())
    out = []
    for name, size in (("a", 400), ("b", 300), ("c", 400), ("d", 300), ("a", 1)):
        try:
            reg.admit(mod.Tenant(name, _Stub(name), hbm_bytes=size,
                                 access_key=f"k-{name}"))
            out.append(("admitted", name))
        except mod.TenantAdmissionError as e:
            out.append(("refused", e.to_dict(), str(e)))
        except ValueError as e:
            out.append(("duplicate", str(e)))
    snap = reg.snapshot()
    for t in snap["tenants"]:
        t.pop("slo")
    out.append((snap, mod.render_tenants_text(reg.snapshot()), reg.apps(),
                reg.resident_bytes(), reg.default.name))
    evicted = reg.evict("b")
    out.append((evicted.name if evicted else None, reg.apps(), reg.resident_bytes()))
    return out


@pytest.mark.parametrize("budget", [None, 700, 1000, 1100])
def test_admission_and_refusal_equal(budget):
    assert _admission_trace(pt_registry, budget) == _admission_trace(jax_registry, budget)


def test_resolve_equal():
    out = []
    for mod in (pt_registry, jax_registry):
        reg = mod.TenantRegistry(registry=(JaxRegistry if mod is jax_registry
                                           else MetricsRegistry)())
        for name in ("a", "b"):
            reg.admit(mod.Tenant(name, _Stub(name), hbm_bytes=1, access_key=f"k-{name}"))
        req = type("R", (), {})
        got = []
        for headers, query in (({}, {}), ({"X-Pio-App": "b"}, {}), ({}, {"app": "b"}),
                               ({"Authorization": "Bearer k-b"}, {}),
                               ({"X-Pio-App": "zz"}, {}), ({}, {"accessKey": "k-a"})):
            r = req()
            r.headers, r.query = headers, query
            t = reg.resolve(r)
            got.append(t.name if t else None)
        out.append(got)
    assert out[0] == out[1] == ["a", "b", "b", "b", None, "a"]


def test_refused_tenant_touches_nothing(home):
    """A third tenant is deployed, then refused by the budget: the
    residents answer before and after and the refusal names its
    shortfall; both packages refuse with the same structured reason."""
    sizes = {n: pt_registry.hbm_footprint(home["port_storage"].models(), home[n].id)
             for n in ("A", "B", "C")}
    budget = sizes["A"] + sizes["C"] + sizes["B"] // 2
    refusals = []
    for mod, server_mod, storage, reg_cls, kw in (
        (pt_registry, pt_server, home["port_storage"], MetricsRegistry, {"device": "cpu"}),
        (jax_registry, jax_server, home["jax_storage"], JaxRegistry, {}),
    ):
        tenants = server_mod.deploy_tenant_engines(
            _specs(home), storage=storage, hbm_budget_bytes=budget,
            registry=reg_cls(), **kw)
        dep = server_mod.deploy_engine(
            "recommendation", storage=storage, engine_instance_id=home["B"].id, **kw)
        before = [t.deployed.predict(t.deployed.extract_query({"user": "u1", "num": 3}))
                  for t in tenants]
        with pytest.raises(mod.TenantAdmissionError) as err:
            tenants.admit(mod.Tenant("three", dep))
        refusals.append(err.value.to_dict())
        after = [t.deployed.predict(t.deployed.extract_query({"user": "u1", "num": 3}))
                 for t in tenants]
        assert [a[1] for a in after] == [b[1] for b in before]
        assert tenants.apps() == ["one", "two"]
    assert refusals[0] == refusals[1]
    assert refusals[0]["shortfall_bytes"] == sizes["B"] - sizes["B"] // 2


def test_deploy_tenant_engines_refuses_past_the_budget(home):
    budget = pt_registry.hbm_footprint(home["port_storage"].models(), home["A"].id)
    with pytest.raises(pt_registry.TenantAdmissionError) as err:
        pt_server.deploy_tenant_engines(
            _specs(home), storage=home["port_storage"], hbm_budget_bytes=budget,
            registry=MetricsRegistry(), device="cpu")
    assert err.value.app == "two" and err.value.resident == ("one",)


@pytest.mark.parametrize("spec", [
    "name=a,engine=recommendation",
    "name=b,engine=recommendation,engine_id=x,engine_version=2,variant=v,"
    "quota_rps=5,quota_burst=7,max_inflight=3,deadline_s=0.5,access_key=K",
    "name=c,engine=e2,engine_instance_id=abc,",
])
def test_app_spec_parses_as_jax(spec):
    assert pt_cli._parse_tenant_spec(spec) == jax_cli._parse_tenant_spec(spec)


@pytest.mark.parametrize("spec", ["engine=recommendation", "name=a,engine"])
def test_bad_app_spec_refused(spec, capsys):
    assert pt_cli.main(["deploy", "--app", spec, "--device", "cpu"]) == 1
    assert "--app spec" in capsys.readouterr().err


def test_deploy_app_flags_reach_the_tenant_deploy(home, monkeypatch, capsys):
    """``deploy --app ... --hbm-budget-bytes`` deploys the tenants on the
    given device against the budget; a refusal exits 1 with the
    bin-packer's reason."""
    seen = {}

    def fake(specs, storage=None, hbm_budget_bytes=None, registry=None, device=None):
        seen.update(specs=specs, budget=hbm_budget_bytes, device=device)
        raise pt_registry.TenantAdmissionError("b", 10, 4, 20, ("a",))

    monkeypatch.setattr(pt_server, "deploy_tenant_engines", fake)
    rc = pt_cli.main(["deploy", "--app", "name=a,engine=recommendation",
                      "--app", "name=b,engine=recommendation,quota_rps=2",
                      "--hbm-budget-bytes", "20", "--port", "0", "--device", "cpu"])
    assert rc == 1
    assert json.loads(capsys.readouterr().err)["shortfall_bytes"] == 6
    assert [s["app"] for s in seen["specs"]] == ["a", "b"]
    assert (seen["budget"], seen["device"], seen["specs"][1]["quota_rps"]) == (
        20, "cpu", 2.0)
