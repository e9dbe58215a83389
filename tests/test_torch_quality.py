"""The port's online model quality against the JAX package's.

``obs.quality`` on the same seeded inputs: the histogram sketch and the
PSI / KS statistics, ``DriftDetector`` (its windows, state machine and
thresholds), the online metrics, the payload summaries, and
``QualityMonitor`` fed one prediction and feedback stream under a frozen
clock (every join route: the echoed request id, ``prId``,
``pioRequestId``, the entity inside and outside the join window, an
unjoined and a non-feedback event), whose snapshots, comparisons,
records, drift state, text and exported metrics are equal.  Then both
packages' deploys of one JAX-trained model beside their event servers,
sharing a monitor as ``deploy --event-port`` does: every answer of either
front end is logged under the variant that answered (a canary staged at
0.5), feedback POSTed with the echoed ``X-Pio-Request-Id`` joins, and
``/quality.json``, ``quality --url`` and ``--watch`` read it.
"""

from __future__ import annotations

import http.client
import json
import math

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
from predictionio_tpu.models.recommendation import engine as jax_rec  # noqa: F401
from predictionio_tpu.obs import quality as jax_quality
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import event_server as jax_es
from predictionio_tpu.server import httpd as jax_httpd
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec  # noqa: F401
from predictionio_tpu_torch.obs import quality as pt_quality
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import event_server as pt_es
from predictionio_tpu_torch.server import httpd as pt_httpd
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 20, 30, 300
TIMEOUT = 10
MODS = {"jax": jax_quality, "port": pt_quality}


# -- sketches, statistics, drift ---------------------------------------------


def _sample(rng, kind, n):
    if kind == "same":
        return rng.normal(0.0, 1.0, n)
    if kind == "shift":
        return rng.normal(1.5, 1.0, n)
    if kind == "scale":
        return rng.normal(0.0, 3.0, n)
    return np.concatenate([rng.normal(0, 1, n // 2), rng.normal(40, 1, n - n // 2)])


@pytest.mark.parametrize("kind", ["same", "shift", "scale", "outside"])
@pytest.mark.parametrize("bins", [1, 10, 32])
def test_sketch_psi_ks_equal(kind, bins):
    rng = np.random.default_rng(bins)
    ref, cur = rng.normal(0, 1, 256), _sample(rng, kind, 256)
    out = {}
    for name, mod in MODS.items():
        a, b = mod.HistogramSketch(-3, 3, bins), mod.HistogramSketch(-3, 3, bins)
        for v in ref:
            a.update(float(v))
        for v in cur:
            b.update(float(v))
        out[name] = (a.counts, b.counts, a.probabilities(0.5), mod.psi_statistic(a, b),
                     mod.psi_statistic(a, b, alpha=0.1), mod.ks_statistic(a, b))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("lo,hi,bins", [(1, 1, 4), (2, 1, 4), (0, 1, 0)])
def test_sketch_refuses_the_same_bounds(lo, hi, bins):
    for mod in MODS.values():
        with pytest.raises(ValueError):
            mod.HistogramSketch(lo, hi, bins)


def _drift_trace(mod, values, window, patience):
    det = mod.DriftDetector("d", window=window, patience=patience)
    return [det.update(v) for v in values], det.to_dict(), det.state


@pytest.mark.parametrize("kind", ["same", "shift", "scale", "outside", "back"])
@pytest.mark.parametrize("window,patience", [(64, 1), (128, 2), (256, 3)])
def test_drift_detector_equal(kind, window, patience):
    rng = np.random.default_rng(window + patience)
    values = list(rng.normal(0, 1, window * 2))
    if kind == "back":  # drift, then recover: the hysteresis path
        values += list(_sample(rng, "shift", window * 4)) + list(rng.normal(0, 1, window * 6))
    else:
        values += list(_sample(rng, kind, window * 6))
    values = [float(v) for v in values] + [math.nan, math.inf]
    want = _drift_trace(jax_quality, values, window, patience)
    assert _drift_trace(pt_quality, values, window, patience) == want
    if kind == "shift":
        assert want[2] == jax_quality.DRIFTING


def test_drift_detector_refuses_a_tiny_window():
    for mod in MODS.values():
        with pytest.raises(ValueError):
            mod.DriftDetector("d", window=1)


# -- online metrics and summaries --------------------------------------------


def _fold(rng):
    recs = []
    for _ in range(40):
        top = tuple(f"i{j}" for j in rng.permutation(20)[:10])
        scores = {t: float(rng.uniform(1, 5)) for t in top}
        actual = {f"i{j}": (float(rng.integers(1, 6)) if rng.random() < 0.7 else None)
                  for j in rng.permutation(20)[: rng.integers(0, 4)]}
        recs.append(({}, {"top": top, "scores": scores}, actual))
    return [(None, recs)]


@pytest.mark.parametrize("k", [1, 5, 10])
def test_online_metrics_equal(k):
    fold = _fold(np.random.default_rng(k))
    for cls in ("OnlineHitRate", "OnlinePrecisionAtK"):
        want = getattr(jax_quality, cls)(k=k)
        got = getattr(pt_quality, cls)(k=k)
        assert (got.header(), got.calculate(fold)) == (want.header(), want.calculate(fold))
    got, want = pt_quality.OnlineRatingMAE(), jax_quality.OnlineRatingMAE()
    assert (got.calculate(fold), got.comparison(1.0, 2.0)) == (
        want.calculate(fold), want.comparison(1.0, 2.0))


SUMMARIZED = [
    ({"user": "u1", "num": 4}, {"itemScores": [{"item": "i1", "score": 2.5},
                                               {"item": "i2", "score": 1}]}),
    ({"userId": 7, "a": 1.5, "b": True, "c": "x"}, {"item_scores": [{"item": 3}]}),
    ({f"f{i}": i for i in range(12)}, {"label": "yes", "probability": 0.75}),
    ([1, 2], {"rating": 4.0, "score": 3.5}),
    ({"entityId": None, "user_id": "z"}, "not a dict"),
    ({"user": "u"}, {"itemScores": "broken"}),
]


@pytest.mark.parametrize("case", range(len(SUMMARIZED)))
@pytest.mark.parametrize("k", [1, 10])
def test_summaries_equal(case, k):
    payload, rendered = SUMMARIZED[case]
    assert pt_quality.summarize_query(payload) == jax_quality.summarize_query(payload)
    assert pt_quality.summarize_prediction(rendered, k) == (
        jax_quality.summarize_prediction(rendered, k))


# -- the monitor on one stream -----------------------------------------------


def _stream(seed):
    """(kind, args) steps: predictions of two variants, feedback joined by
    every route, clock moves."""
    rng = np.random.default_rng(seed)
    steps = []
    for n in range(600):
        user = f"u{rng.integers(40)}"
        variant = "canary" if rng.random() < 0.3 else "default"
        top = [f"i{j}" for j in rng.permutation(30)[:10]]
        pred = {"itemScores": [{"item": t, "score": float(rng.uniform(0, 5 + n / 100))}
                               for t in top]}
        steps.append(("predict", (f"r{n}", {"user": user, "num": 10, "x": float(
            rng.normal(n / 200, 1))}, pred, variant)))
        if rng.random() < 0.4:
            how = rng.choice(["rid", "prid", "prop", "entity", "none", "other"])
            item = top[rng.integers(10)] if rng.random() < 0.5 else "zz"
            steps.append(("feedback", (str(how), f"r{n}", user, item,
                                       float(rng.integers(1, 6)))))
        steps.append(("tick", float(rng.uniform(0, 3))))
    return steps


def _monitor_trace(mod, event_cls, datamap, steps, monkeypatch):
    now = [1_000_000.0]
    monkeypatch.setattr(mod, "_now", lambda: now[0])
    registry = (JaxRegistry if mod is jax_quality else MetricsRegistry)()
    q = mod.QualityMonitor(registry=registry, capacity=256, join_window_s=120.0,
                           metrics_window=64, drift_window=64)
    joins = []
    for kind, args in steps:
        if kind == "tick":
            now[0] += args
        elif kind == "predict":
            q.observe_prediction(*args[:3], variant=args[3], wave_size=8, wave_seq=1)
        else:
            how, rid, user, item, rating = args
            props = {"rating": rating}
            if how == "prop":
                props["pioRequestId"] = rid
            ev = event_cls(event="view" if how == "other" else "rate",
                           entity_type="user", entity_id=user,
                           target_entity_type="item", target_entity_id=item,
                           properties=datamap(props),
                           pr_id=rid if how == "prid" else None)
            if how == "other":
                ev = event_cls(event="$set", entity_type="user", entity_id=user)
            joins.append(q.observe_feedback(
                ev, request_id=rid if how == "rid" else "minted-" + rid, app=3))
    snap = q.snapshot()
    text = mod.render_quality_text(snap)
    families = sorted(
        line for line in registry.render_prometheus().splitlines()
        if line.startswith(("pio_quality_", "pio_online_metric", "pio_drift_"))
    )
    return (joins, snap, text, q.compare_variants("default", "canary"),
            q.compare_variants("default", "canary", metric="rating_mae"),
            q.variant_metrics("canary"), q.variant_metrics("nope"), q.drift_state(),
            q.record_for("r5"), q.record_for("r599"), families)


@pytest.mark.parametrize("seed", range(3))
def test_monitor_snapshots_equal(seed, monkeypatch):
    steps = _stream(seed)
    want = _monitor_trace(jax_quality, JaxEvent, JaxDataMap, steps, monkeypatch)
    got = _monitor_trace(pt_quality, Event, DataMap, steps, monkeypatch)
    assert got == want
    assert any(want[0]) and not all(want[0])
    assert set(want[1]["variants"]) == {"default", "canary"}


def test_monitor_feedback_names(monkeypatch):
    monkeypatch.setenv("PIO_FEEDBACK_EVENTS", "buy, like ,")
    assert sorted(pt_quality.QualityMonitor(registry=MetricsRegistry()).feedback_events) == (
        sorted(jax_quality.QualityMonitor(registry=JaxRegistry()).feedback_events)
    ) == ["buy", "like"]


# -- both tails and the event server's join over HTTP ---------------------------


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_quality") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(path)}))
    desc = jax_cmd.app_new(jax_storage, "qa")
    rng = np.random.default_rng(0)
    for n in range(N_EVENTS):
        jax_storage.l_events().insert(
            JaxEvent(event="rate", entity_type="user", entity_id=f"u{n % N_USERS}",
                     target_entity_type="item", target_entity_id=f"i{n % N_ITEMS}",
                     properties=JaxDataMap({"rating": float(rng.integers(1, 6))})),
            desc.app.id,
        )
    engine = jax_resolve_engine_factory("recommendation")()
    out = {}
    for name, iterations in (("A", 2), ("B", 3)):
        params = engine.params_from_json({
            "datasource": {"name": "ratings", "params": {"appName": "qa"}},
            "algorithms": [{"name": "als",
                            "params": {"rank": 4, "numIterations": iterations}}],
        })
        out[name] = run_train(
            engine, params, ctx=JaxEngineContext(storage=jax_storage, mode="train"),
            engine_factory="recommendation", storage=jax_storage)
    out.update(key=desc.keys[0].key, jax_storage=jax_storage,
               port_storage=StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(path)})))
    yield out
    out["port_storage"].close()
    jax_storage.close()


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _loop(home, name, microbatch):
    """One package's deploy (canary B at 0.5) and event server over one
    monitor; (answers, feedback statuses, /quality.json, monitor)."""
    if name == "jax":
        reg = JaxRegistry()
        monitor = jax_quality.QualityMonitor(registry=reg)
        dep = jax_server.deploy_engine("recommendation", storage=home["jax_storage"],
                                       engine_instance_id=home["A"].id)
        app = jax_server.create_prediction_server_app(
            dep, use_microbatch=microbatch, registry=reg, quality=monitor,
            enable_alerts=False)
        es_app = jax_es.create_event_server_app(home["jax_storage"], registry=reg,
                                                quality=monitor)
        aio, httpd = jax_aio, jax_httpd
    else:
        reg = MetricsRegistry()
        monitor = pt_quality.QualityMonitor(registry=reg)
        dep = pt_server.deploy_engine("recommendation", storage=home["port_storage"],
                                      engine_instance_id=home["A"].id, device="cpu")
        app = pt_server.create_prediction_server_app(
            dep, use_microbatch=microbatch, registry=reg, quality=monitor)
        es_app = pt_es.create_event_server_app(home["port_storage"], registry=reg,
                                               quality=monitor)
        aio, httpd = pt_aio, pt_httpd
    dep.stage_canary(home["B"], 0.5)
    server = aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    events = httpd.AppServer(es_app, "127.0.0.1", 0).start_background()
    answers, fb = [], []
    try:
        for n in range(2 * N_USERS):
            user = f"u{n % N_USERS}"
            status, headers, body = _call(server.port, "POST", "/queries.json",
                                          json.dumps({"user": user, "num": 5}))
            rid = headers["X-Pio-Request-Id"]
            variant = headers["X-Pio-Variant"]
            answers.append((status, variant, [x["item"] for x in body["itemScores"]]))
            record = monitor.record_for(rid)
            assert record["variant"] == variant, (name, rid)
            assert record["top"] == tuple(answers[-1][2])
            if n % 3:
                item = body["itemScores"][n % 5]["item"] if n % 2 else "i-none"
                fb.append(_call(events.port, "POST",
                                f"/events.json?accessKey={home['key']}",
                                json.dumps({"event": "buy", "entityType": "user",
                                            "entityId": user,
                                            "targetEntityType": "item",
                                            "targetEntityId": item}),
                                {"X-Pio-Request-Id": rid})[0])
        snap = _call(server.port, "GET", "/quality.json")[2]
    finally:
        server.shutdown()
        events.shutdown()
    return answers, fb, snap, monitor


@pytest.mark.parametrize("microbatch", [False, True])
def test_feedback_joins_per_variant_as_jax(home, microbatch):
    out = {name: _loop(home, name, microbatch) for name in ("jax", "port")}
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1] == [201] * len(out["jax"][1])
    views = {}
    for name, (_, _, snap, _) in out.items():
        views[name] = (
            sorted(snap), snap["feedback_events"], snap["top_k"],
            {v: {k: d[k] for k in ("predictions", "feedback_events", "joined")}
             | {"hit_rate": d["metrics"]["hit_rate"]}
             for v, d in snap["variants"].items()},
        )
    assert views["port"] == views["jax"]
    assert set(views["port"][3]) == {"default", "canary"}
    joined = sum(v["joined"] for v in views["port"][3].values())
    assert joined == len(out["port"][1])


def test_quality_cli_reads_the_server(home, capsys):
    _, _, _, monitor = _loop(home, "port", False)
    app = pt_server.create_prediction_server_app(
        pt_server.deploy_engine("recommendation", storage=home["port_storage"],
                                engine_instance_id=home["A"].id, device="cpu"),
        registry=MetricsRegistry(), quality=monitor)
    server = pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    url = f"http://127.0.0.1:{server.port}"
    try:
        outs = []
        for main in (pt_cli.main, jax_cli.main):
            assert main(["quality", "--url", url]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] == pt_quality.render_quality_text(monitor.snapshot()) + "\n"
        assert "variant canary" in outs[0]
        assert pt_cli.main(["quality", "--url", url, "--json"]) == 0
        assert set(json.loads(capsys.readouterr().out)["variants"]) == {"default", "canary"}
        assert pt_cli.main(["quality", "--url", url, "--watch", "0.01",
                            "--watch-count", "2"]) == 0
        assert capsys.readouterr().out.count("--- pio quality @") == 2
    finally:
        server.shutdown()
    assert pt_cli.main(["quality", "--url", url]) == 1
    assert "scrape failed" in capsys.readouterr().err
    assert pt_cli.main(["quality"]) == 0  # this process's monitor
    assert capsys.readouterr().out.startswith("drift: ")
