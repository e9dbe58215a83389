"""The port's canary and lifecycle controller against the JAX package's.

``data.storage.base.entity_shard`` and ``lifecycle.canary`` on 10,000
ids at several fractions; ``CanaryDecider``, ``VariantStats`` /
``CanaryTracker`` and ``LifecyclePolicy.from_env`` on frozen clocks and
the same inputs; ``_rollback_label``; then both packages' deploys of one
JAX-trained store on the CPU, each driven by its own
``LifecycleController`` under the same frozen clock: a stale live
generation triggers a warm-start retrain (the port's ``run_train`` on the
CPU, warm from the live instance), the result is staged as the canary on
an entity-hash half of the traffic, and the next tick promotes it; a
canary whose every answer raises at the ``canary.predict`` fault seam
is rolled back by the error guardrail while the live answers stay the
same.  Also ``/lifecycle.json``'s controller and canary keys, the factor
caches a canary flip drops, ``deploy --lifecycle`` and ``lifecycle
--watch``.
"""

from __future__ import annotations

import http.client
import json
import time

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
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.lifecycle import canary as jax_canary
from predictionio_tpu.lifecycle import controller as jax_controller
from predictionio_tpu.models.recommendation import engine as jax_rec  # noqa: F401 (registers)
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch import lifecycle as pt_lifecycle
from predictionio_tpu_torch.data.storage import base as pt_base
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.lifecycle import canary as pt_canary
from predictionio_tpu_torch.lifecycle import controller as pt_controller
from predictionio_tpu_torch.models.recommendation import engine as pt_rec  # noqa: F401
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.parallel import device_cache
from predictionio_tpu_torch.resilience import faults as pt_faults
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 20, 30, 300
IDS = [f"u{i}" for i in range(10_000)]
TIMEOUT = 10


class Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the split ----------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 7, 64, 10_000])
@pytest.mark.parametrize("entity_type", ["user", "pio_canary"])
def test_entity_shard_equal(n_shards, entity_type):
    got = [pt_base.entity_shard(entity_type, e, n_shards) for e in IDS]
    assert got == [jax_base.entity_shard(entity_type, e, n_shards) for e in IDS]
    assert max(got) < n_shards


@pytest.mark.parametrize("fraction", [0.0, 0.0001, 0.1, 0.25, 0.5, 0.9, 1.0, 1.5, -1])
def test_in_canary_fraction_equal(fraction):
    got = [pt_canary.in_canary_fraction(e, fraction) for e in IDS + [None, ""]]
    assert got == [jax_canary.in_canary_fraction(e, fraction) for e in IDS + [None, ""]]
    if 0 < fraction < 1:
        assert abs(sum(got) / len(IDS) - fraction) < 0.02


# -- guardrails and verdicts on frozen clocks ----------------------------------


def _stats_trace(mod, stream):
    clock = Clock(100.0)
    tracker = mod.CanaryTracker(clock=clock)
    out = [tracker.age_s(), tracker.snapshot()]
    tracker.start()
    for is_canary, status, seconds in stream:
        tracker.observe(is_canary, status, seconds)
        clock.t += 0.5
    out += [tracker.age_s(), tracker.snapshot()]
    stats = mod.VariantStats(cap=8)
    for _, status, seconds in stream[:40]:
        stats.observe(status, seconds)
    out += [stats.to_dict(), stats.p95(), stats.error_rate()]
    tracker.stop()
    out.append(tracker.age_s())
    return out


@pytest.mark.parametrize("seed", range(3))
def test_tracker_and_variant_stats_equal(seed):
    rng = np.random.default_rng(seed)
    stream = [(bool(rng.integers(2)), int(rng.choice([200, 200, 400, 500])),
               float(rng.exponential(0.01))) for _ in range(300)]
    assert _stats_trace(pt_canary, stream) == _stats_trace(jax_canary, stream)


def _snap(live, canary):
    def side(requests, errors, p95):
        return {"requests": requests, "errors": errors,
                "error_rate": errors / requests if requests else 0.0, "p95_s": p95}

    return {"started_at": 0.0, "live": side(*live), "canary": side(*canary)}


DECISIONS = [
    # (tracker snapshot, quality comparison, age)
    (_snap((100, 0, 0.01), (10, 5, 0.01)), None, 5.0),          # too few to judge
    (_snap((100, 0, 0.01), (60, 6, 0.01)), None, 5.0),          # error rate
    (_snap((100, 0, 0.01), (60, 0, 0.05)), None, 5.0),          # latency
    (_snap((100, 0, 0.01), (60, 0, 0.02)), None, 5.0),          # promote? no joins
    (_snap((100, 0, 0.01), (60, 0, 0.02)),
     {"live_value": 0.5, "canary_value": 0.3, "canary_joined": 25}, 5.0),
    (_snap((100, 0, 0.01), (60, 0, 0.02)),
     {"live_value": 0.5, "canary_value": 0.48, "canary_joined": 25}, 5.0),
    (_snap((100, 0, 0.01), (60, 0, 0.02)),
     {"live_value": None, "canary_value": 0.4, "canary_joined": 30}, 5.0),
    (_snap((100, 0, 0.01), (10, 0, 0.02)), None, 7200.0),       # timeout
    (_snap((100, 0, None), (60, 0, 0.02)), None, None),
]


@pytest.mark.parametrize("min_joined", [0, 20])
@pytest.mark.parametrize("case", range(len(DECISIONS)))
def test_decider_equal(case, min_joined):
    snap, comparison, age = DECISIONS[case]
    got = pt_canary.CanaryDecider(
        pt_canary.CanaryPolicy(min_joined=min_joined)
    ).evaluate(snap, comparison, age)
    want = jax_canary.CanaryDecider(
        jax_canary.CanaryPolicy(min_joined=min_joined)
    ).evaluate(snap, comparison, age)
    assert got == want


@pytest.mark.parametrize("env", [
    {},
    {"PIO_CANARY_FRACTION": "0.5", "PIO_CANARY_MIN_REQUESTS": "7",
     "PIO_CANARY_MAX_ERROR_RATE": "0.2", "PIO_CANARY_MIN_JOINED": "0",
     "PIO_CANARY_METRIC": "precision_at_k", "PIO_CANARY_MAX_REGRESSION": "0.3",
     "PIO_CANARY_MAX_S": "60", "PIO_LIFECYCLE_STALENESS_S": "5",
     "PIO_LIFECYCLE_RETRAIN_ON_DRIFT": "off", "PIO_LIFECYCLE_COOLDOWN_S": "9",
     "PIO_LIFECYCLE_INTERVAL_S": "0.5"},
])
def test_policy_from_env_equal(env):
    got = pt_controller.LifecyclePolicy.from_env(env)
    want = jax_controller.LifecyclePolicy.from_env(env)
    assert repr(got).replace("predictionio_tpu_torch", "x") == repr(want).replace(
        "predictionio_tpu", "x")


@pytest.mark.parametrize("reason", [
    "canary error rate 0.5 exceeds guardrail", "canary p95 0.1s exceeds 3x",
    "online hit_rate regressed: canary", "canary undecided after 10s — burden of proof",
    "something else",
])
def test_rollback_label_equal(reason):
    assert pt_controller._rollback_label(reason) == jax_controller._rollback_label(reason)


def test_lifecycle_exports_match_jax():
    import predictionio_tpu.lifecycle as jax_lifecycle

    assert sorted(pt_lifecycle.__all__) == sorted(jax_lifecycle.__all__)
    assert pt_canary.CANARY_VARIANT == jax_canary.CANARY_VARIANT == "canary"


# -- both packages' deploys under their controllers ---------------------------


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """One JAX-trained generation A of the default engine on app ``lc``."""
    path = tmp_path_factory.mktemp("torch_lifecycle") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(path)}))
    app = jax_cmd.app_new(jax_storage, "lc").app
    rng = np.random.default_rng(0)
    for n in range(N_EVENTS):
        jax_storage.l_events().insert(
            JaxEvent(
                event="rate", entity_type="user", entity_id=f"u{n % N_USERS}",
                target_entity_type="item", target_entity_id=f"i{n % N_ITEMS}",
                properties=JaxDataMap({"rating": float(rng.integers(1, 6))}),
            ),
            app.id,
        )
    engine = jax_resolve_engine_factory("recommendation")()
    params = engine.params_from_json({
        "datasource": {"name": "ratings", "params": {"appName": "lc"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}],
    })
    instance = run_train(
        engine, params, ctx=JaxEngineContext(storage=jax_storage, mode="train"),
        engine_factory="recommendation", storage=jax_storage,
    )
    yield {"path": path, "A": instance, "jax_storage": jax_storage}
    jax_storage.close()


def _fresh_home(home, tmp_path):
    """Two copies of the trained home, one per package, so each test's
    manifests start clean and neither controller sees the other's."""
    import shutil

    dst = {}
    for name in ("jax", "port"):
        dst[name] = tmp_path / name / "pio_home"
        shutil.copytree(home["path"], dst[name])
    return (
        jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(dst["jax"])})),
        StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(dst["port"])})),
    )


POLICY = dict(staleness_s=10.0, cooldown_s=1e9, retrain_on_drift=False)


def _controllers(home, tmp_path, fraction=0.5):
    jax_storage, port_storage = _fresh_home(home, tmp_path)
    clock = Clock(time.time() + 3600.0)  # the live generation is an hour old
    jdep = jax_server.deploy_engine("recommendation", storage=jax_storage)
    pdep = pt_server.deploy_engine("recommendation", storage=port_storage, device="cpu")
    out = []
    for mod, dep, reg in ((jax_controller, jdep, JaxRegistry()),
                          (pt_controller, pdep, MetricsRegistry())):
        canary = (jax_canary if mod is jax_controller else pt_canary).CanaryPolicy(
            fraction=fraction, min_requests=20, min_joined=0)
        policy = mod.LifecyclePolicy(canary=canary, **POLICY)
        out.append(mod.LifecycleController(
            dep, dep.generation_store, policy=policy, registry=reg, clock=clock))
    return out, clock, (jax_storage, port_storage)


def _manifest(store, first):
    return [("A" if g.instance_id == first else "new", g.status)
            for g in store.generations()]


def test_tick_retrains_warm_then_promotes(home, tmp_path):
    (jc, pc), clock, storages = _controllers(home, tmp_path)
    try:
        trace = {}
        for name, c in (("jax", jc), ("port", pc)):
            first = c.deployed.instance.id
            steps = [c.tick()]
            staged = c.deployed.canary_instance
            assert staged is not None and staged.id != first
            event = c.last_event
            steps.append((event["event"], event["warm_start_from"] == first
                          if "warm_start_from" in event else None))
            retrain = dict(c.snapshot(), last_event=None, canary_instance=None,
                           canary_stats=None)
            steps.append(retrain)
            steps.append(_manifest(c.store, first))
            # the guardrails see 30 clean answers a side, then a tick
            for _ in range(30):
                c.tracker.observe(False, 200, 0.01)
                c.tracker.observe(True, 200, 0.012)
            steps.append(c.tick())
            steps.append((c.deployed.instance.id == staged.id,
                          c.deployed.canary_instance))
            steps.append(_manifest(c.store, first))
            # the cooldown holds the next retrain back
            clock.t += 60
            steps.append(c.tick())
            trace[name] = steps
        assert trace["port"] == trace["jax"]
        assert trace["port"][0] == "retrain" and trace["port"][4] == "promote"
        assert trace["port"][1] == ("canary_started", None)
        assert pc.store.live().instance_id == pc.deployed.instance.id
    finally:
        for s in storages:
            s.close()


def test_retrain_is_warm_from_the_live_generation(home, tmp_path, monkeypatch):
    """The controller's retrain reads the live generation's models as its
    warm start, on the deploy's device."""
    from predictionio_tpu_torch.core import workflow

    (_, pc), _, storages = _controllers(home, tmp_path)
    seen = []
    real = workflow.run_train

    def spy(engine, params, ctx=None, **kw):
        seen.append((kw.get("warm_start_from"), str(ctx.device)))
        return real(engine, params, ctx=ctx, **kw)

    monkeypatch.setattr(workflow, "run_train", spy)
    try:
        first = pc.deployed.instance.id
        assert pc.tick() == "retrain"
        assert seen == [(first, "cpu")]
        assert pc.last_event["event"] == "canary_started"
    finally:
        for s in storages:
            s.close()


def _query(port, user):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/queries.json", json.dumps({"user": user, "num": 4}))
        resp = conn.getresponse()
        return resp.status, resp.getheader("X-Pio-Variant"), json.loads(resp.read())
    finally:
        conn.close()


@pytest.mark.parametrize("microbatch", [False, True])
def test_canary_fault_rolls_back_and_live_answers_stay(home, tmp_path, microbatch):
    (jc, pc), _, storages = _controllers(home, tmp_path)
    users = [f"u{i}" for i in range(N_USERS)] * 3
    outcomes = {}
    try:
        for name, c, faults, aio, server_mod, reg in (
            ("jax", jc, jax_faults, jax_aio, jax_server, JaxRegistry),
            ("port", pc, pt_faults, pt_aio, pt_server, MetricsRegistry),
        ):
            kw = {"enable_alerts": False} if name == "jax" else {}
            app = server_mod.create_prediction_server_app(
                c.deployed, use_microbatch=microbatch, registry=reg(),
                lifecycle=c, lifecycle_autostart=False, **kw)
            server = aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
            try:
                before = [_query(server.port, u) for u in users[:N_USERS]]
                assert c.tick() == "retrain"
                canary_id = c.deployed.canary_instance.id
                faults.install([{"seam": "canary.predict", "kind": "error"}])
                try:
                    during = [_query(server.port, u) for u in users]
                finally:
                    faults.clear()
                verdict = c.tick()
                lc = json.loads(urllib_get(server.port, "/lifecycle.json"))
                after = [_query(server.port, u) for u in users[:N_USERS]]
            finally:
                server.shutdown()
            live_during = [d for d in during if d[1] != "canary"]
            assert {d[0] for d in live_during} == {200}
            assert {d[0] for d in during if d[1] == "canary"} == {500}
            # live answers never change: not during the canary, not after
            # its rollback
            by_user = dict(zip(users[:N_USERS], before))
            for u, d in zip(users, during):
                if d[1] != "canary":
                    assert d == by_user[u]
            assert after == before
            outcomes[name] = (
                [d[:2] for d in during], verdict,
                c.store.get(canary_id).status, c.deployed.canary_instance,
                sorted(lc), lc["canary_in_progress"], lc["controller"]["enabled"],
                c.last_event["event"],
            )
        assert outcomes["port"] == outcomes["jax"]
        assert outcomes["port"][1] == "rollback"
        assert outcomes["port"][2] == "rolled_back"
    finally:
        for s in storages:
            s.close()


def urllib_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return r.read().decode()


def test_lifecycle_json_names_the_canary(home, tmp_path):
    (_, pc), _, storages = _controllers(home, tmp_path, fraction=0.25)
    app = pt_server.create_prediction_server_app(
        pc.deployed, registry=MetricsRegistry(), lifecycle=pc,
        lifecycle_autostart=False)
    server = pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    try:
        idle = json.loads(urllib_get(server.port, "/lifecycle.json"))
        assert pc.tick() == "retrain"
        staged = json.loads(urllib_get(server.port, "/lifecycle.json"))
    finally:
        server.shutdown()
        for s in storages:
            s.close()
    assert idle["canary_in_progress"] is False and "canary_instance" not in idle
    assert idle["controller"]["enabled"] is True
    assert idle["controller"]["policy"]["fraction"] == 0.25
    assert staged["canary_in_progress"] is True
    assert staged["canary_fraction"] == 0.25
    assert staged["canary_instance"] == pc.deployed.canary_instance.id
    assert staged["manifest"]["canary"] == staged["canary_instance"]
    assert staged["controller"]["last_event"]["event"] == "canary_started"


def test_canary_flips_drop_factor_caches(home, tmp_path, monkeypatch):
    (_, pc), _, storages = _controllers(home, tmp_path)
    reasons = []
    monkeypatch.setattr(device_cache, "invalidate_model_caches",
                        lambda models, reason: reasons.append(reason))
    dep = pc.deployed
    try:
        dep.stage_canary(pc.deployed.instance, 0.5)   # nothing replaced
        dep.stage_canary(pc.deployed.instance, 0.5)   # replaces a canary
        dep.clear_canary()                            # drops one
        dep.clear_canary()                            # nothing to drop
        dep.stage_canary(pc.deployed.instance, 0.5)
        dep.promote_canary()                          # the live one retires
    finally:
        for s in storages:
            s.close()
    assert reasons == ["canary_flip", "canary_flip", "swap"]
    assert dep.canary_split() == (None, 0.0)
    with pytest.raises(RuntimeError):
        dep.promote_canary()


def test_binding_for_entity_follows_the_split(home, tmp_path):
    (jc, pc), _, storages = _controllers(home, tmp_path)
    try:
        for c in (jc, pc):
            c.deployed.stage_canary(c.deployed.instance, 0.5)
        sides = {}
        for name, c in (("jax", jc), ("port", pc)):
            dep = c.deployed
            sides[name] = [
                dep.binding_label(dep.binding_for_entity(dep.payload_entity(p)))
                for p in ([{"user": u} for u in IDS[:500]]
                          + [{"userId": "x"}, {"item": "i"}, [1], {"user": None}])
            ]
        assert sides["port"] == sides["jax"]
        assert set(sides["port"]) == {"default", "canary"}
    finally:
        for s in storages:
            s.close()


def test_deploy_lifecycle_flag_reaches_the_server(monkeypatch, capsys):
    seen = {}

    class Stop(Exception):
        pass

    def fake(factory, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(pt_server, "create_prediction_server", fake)
    for argv, want in ((["--lifecycle"], True), ([], None)):
        with pytest.raises(Stop):
            pt_cli.main(["deploy", "--engine", "recommendation", "--port", "0",
                         "--device", "cpu", *argv])
        assert seen["enable_lifecycle"] is want


def test_lifecycle_cli_watch_and_text_match_jax(home, tmp_path, capsys):
    (_, pc), _, storages = _controllers(home, tmp_path)
    app = pt_server.create_prediction_server_app(
        pc.deployed, registry=MetricsRegistry(), lifecycle=pc,
        lifecycle_autostart=False)
    server = pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    url = f"http://127.0.0.1:{server.port}"
    try:
        assert pc.tick() == "retrain"
        outs = []
        for main in (pt_cli.main, jax_cli.main):
            assert main(["lifecycle", "--url", url]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert "canary: " in outs[0] and "(50% of traffic)" in outs[0]
        assert "last event: canary_started" in outs[0]
        assert pt_cli.main(["lifecycle", "--url", url, "--watch", "0.01",
                            "--watch-count", "3"]) == 0
        assert capsys.readouterr().out.count("--- pio lifecycle @") == 3
    finally:
        server.shutdown()
        for s in storages:
            s.close()
    dead = f"http://127.0.0.1:{server.port}"
    assert pt_cli.main(["lifecycle", "--url", dead]) == 1
    assert "scrape failed" in capsys.readouterr().err


def test_server_shutdown_stops_the_controller(home, tmp_path):
    (_, pc), _, storages = _controllers(home, tmp_path)
    pc.policy = pt_controller.LifecyclePolicy(check_interval_s=3600.0)
    app = pt_server.create_prediction_server_app(
        pc.deployed, registry=MetricsRegistry(), lifecycle=pc)
    server = pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    try:
        assert pc._thread is not None and pc._thread.is_alive()
        thread = pc._thread
    finally:
        server.shutdown()
        for s in storages:
            s.close()
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive() and pc._thread is None
