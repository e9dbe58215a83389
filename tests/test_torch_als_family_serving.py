"""The port's deploy of the ALS family against the JAX package's, on the CPU:
degraded answers, factor caches across a reload, and the batcher's drain.

An ``ecommerce`` and a ``similarproduct`` instance are trained by the JAX
package into a temp ``PIO_HOME``; both packages deploy them from the same
sqlite file (the port on the CPU) and serve them through their own
``create_prediction_server_app`` and ``AsyncAppServer``, micro-batched and
threaded:

- the same queries get the same status codes, ``X-Pio-Engine-Instance``
  and ``X-Pio-Degraded`` headers and answers (ids apart from near ties,
  scores within rtol 1e-5), request for request; with an event store
  whose ``find_by_entity`` raises, every answer is a 200 stamped
  ``seen_filter,unavailable_items`` (``recent_items`` too for a user
  outside the vocabulary), and ``pio_degraded_total`` counts each reason;
- ``/reload`` drops the old generation's ``FactorCache``: no cached row
  of the old model is left;
- ``drain_timeout_s`` reaches both packages' micro-batchers and bounds
  ``close()`` with a wave in flight.

``degraded_scope`` and ``FactorCache`` themselves are held to the JAX
package's on the same sequences of calls.  Every server binds port 0 and
is shut down in ``finally``; every client call has a timeout.
"""

from __future__ import annotations

import contextvars
import gc
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import (
    resolve_engine_factory as jax_resolve_engine_factory,
)
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.datamap import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.models import ecommerce as _jax_ec  # noqa: F401 (registers)
from predictionio_tpu.models import similarproduct as _jax_sp  # noqa: F401
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.parallel import device_cache as jax_cache
from predictionio_tpu.resilience import degrade as jax_degrade
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.parallel import device_cache as pt_cache
from predictionio_tpu_torch.resilience import degrade as pt_degrade
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 10
KEPT_HEADERS = ("X-Pio-Engine-Instance", "X-Pio-Degraded", "Retry-After")

ENGINES = {
    "ecommerce": ("ecom", [{"name": "ecomm", "params": {
        "appName": "shop", "rank": 4, "numIterations": 6}}]),
    "similarproduct": ("sim", [
        {"name": "als", "params": {"rank": 4, "numIterations": 6}},
        {"name": "cooccurrence", "params": {"n": 5}},
    ]),
}


def _events():
    ev = [JaxEvent(event="$set", entity_type="user", entity_id=f"u{u}")
          for u in range(12)]
    ev += [JaxEvent(event="$set", entity_type="item", entity_id=f"i{i}",
                    properties=JaxDataMap({"categories": ["a" if i < 6 else "b"]}))
           for i in range(12)]
    rng = np.random.default_rng(3)
    for u in range(12):
        lo = 0 if u < 6 else 6
        for i in rng.choice(6, 4, replace=False):
            ev.append(JaxEvent(event="view", entity_type="user", entity_id=f"u{u}",
                               target_entity_type="item",
                               target_entity_id=f"i{lo + i}"))
    ev += [JaxEvent(event="buy", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id="i1")
           for u in range(4)]
    ev += [JaxEvent(event="view", entity_type="user", entity_id="coldu",
                    target_entity_type="item", target_entity_id=f"i{i}")
           for i in (7, 8)]
    ev.append(JaxEvent(event="$set", entity_type="constraint",
                       entity_id="unavailableItems",
                       properties=JaxDataMap({"items": ["i9"]})))
    return ev


def _train(jax_storage, factory):
    engine_id, algos = ENGINES[factory]
    engine = jax_resolve_engine_factory(factory)()
    params = engine.params_from_json(
        {"datasource": {"params": {"appName": "shop"}}, "algorithms": algos}
    )
    instance = jax_run_train(
        engine, params, ctx=JaxEngineContext(storage=jax_storage, mode="train"),
        engine_id=engine_id, engine_factory=factory, storage=jax_storage,
    )
    assert instance is not None and instance.status == "COMPLETED"
    return instance


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX-trained ecommerce and similarproduct instances, deployed by both
    packages from one PIO_HOME (the JAX one as the process-wide storage,
    which its ecommerce engine reads at serving time)."""
    home = tmp_path_factory.mktemp("als_family_serving") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    app = jax_cmd.app_new(jax_storage, "shop").app
    jax_storage.l_events().insert_batch(_events(), app.id)
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    out = {"jax_storage": jax_storage, "port_storage": storage, "app_id": app.id}
    for factory in ENGINES:
        inst = _train(jax_storage, factory)
        out[factory] = {
            "instance": inst,
            "jax": jax_server.deploy_engine(factory, storage=jax_storage,
                                            engine_instance_id=inst.id),
            "port": pt_server.deploy_engine(factory, storage=storage,
                                            engine_instance_id=inst.id, device="cpu"),
        }
    yield out
    storage.close()
    jax_storage.close()


def _request(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/queries.json", body=body)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = None
        headers = dict(resp.getheaders())
        return resp.status, {h: headers[h] for h in KEPT_HEADERS if h in headers}, parsed
    finally:
        conn.close()


def _post(port, path, timeout=TIMEOUT):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _server(name, deployed, microbatch, **kw):
    if name == "jax":
        app = jax_server.create_prediction_server_app(
            deployed, use_microbatch=microbatch, registry=JaxRegistry(),
            enable_alerts=False, **kw)
        return jax_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    app = pt_server.create_prediction_server_app(
        deployed, use_microbatch=microbatch, registry=MetricsRegistry(), **kw)
    return pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()


def _hold_answers(got, want, what):
    """Scores within RTOL; ids equal apart from near ties."""
    gi, gs = [x["item"] for x in got], np.asarray([x["score"] for x in got])
    wi, ws = [x["item"] for x in want], np.asarray([x["score"] for x in want])
    assert len(gi) == len(wi), what
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL, err_msg=str(what))
    for j in np.flatnonzero(np.asarray(gi, object) != np.asarray(wi, object)):
        ref = ws[wi.index(gi[j])] if gi[j] in wi else ws[-1]
        assert abs(ws[j] - ref) <= RTOL * abs(ws[j]) + ATOL, (what, j)


QUERIES = {
    "ecommerce": [
        {"user": "u0", "num": 4},
        {"user": "u7", "num": 6, "categories": ["b"]},
        {"user": "u2", "num": 5, "whiteList": ["i3", "i4", "i9"], "blackList": ["i4"]},
        {"user": "coldu", "num": 3},  # not in the vocabulary: recent views
        {"user": "nobody", "num": 4},  # no signal: popularity
        {"num": 4},  # no user: 400
    ],
    "similarproduct": [
        {"items": ["i0"], "num": 4},
        {"items": ["i0", "i7"], "num": 6, "categories": ["b"]},
        {"items": ["i2"], "num": 5, "blackList": ["i3"], "categoryBlackList": ["a"]},
        {"items": ["nope"], "num": 3},
        {"num": 3},  # no items: 400
    ],
}

#: the reasons an ecommerce query is stamped with when find_by_entity
#: raises: a user outside the vocabulary also reads recent views
KNOWN_DEGRADED = "seen_filter,unavailable_items"
COLD_DEGRADED = "seen_filter,unavailable_items,recent_items"


def _boom(*args, **kwargs):
    raise ConnectionError("event store unreachable")


@pytest.mark.parametrize("microbatch", [True, False], ids=["aio", "threaded"])
@pytest.mark.parametrize("factory,failing", [
    ("ecommerce", False), ("ecommerce", True), ("similarproduct", False),
])
def test_both_deploys_answer_alike_with_degraded_headers(
    trained, monkeypatch, factory, failing, microbatch
):
    if failing:
        for st in (trained["jax_storage"], trained["port_storage"]):
            monkeypatch.setattr(st.l_events(), "find_by_entity", _boom)
    counter = REGISTRY.counter(
        "pio_degraded_total", "Requests answered in degraded (fallback) mode, by reason",
        labelnames=("reason",))
    before = {r: counter.labels(r).value
              for r in ("seen_filter", "unavailable_items", "recent_items")}
    results = {}
    for name in ("jax", "port"):
        server = _server(name, trained[factory][name], microbatch)
        try:
            results[name] = [_request(server.port, json.dumps(q))
                             for q in QUERIES[factory]]
        finally:
            server.shutdown()
    iid = trained[factory]["instance"].id
    for q, (ps, ph, pb), (js, jh, jb) in zip(QUERIES[factory], results["port"],
                                            results["jax"]):
        assert (ps, ph) == (js, jh), q
        assert ph.get("X-Pio-Engine-Instance") == iid or ps == 400, (q, ph)
        if ps == 200:
            _hold_answers(pb["itemScores"], jb["itemScores"], q)
        else:
            assert ps == 400 and "user" not in q and "items" not in q, (q, ps)
    degraded = [h.get("X-Pio-Degraded") for s, h, _ in results["port"] if s == 200]
    if not failing:
        assert degraded == [None] * len(degraded)
        return
    users = [q["user"] for q in QUERIES[factory] if "user" in q]
    assert degraded == [COLD_DEGRADED if u in ("coldu", "nobody") else KNOWN_DEGRADED
                        for u in users]
    # the popularity answer of a user with no signal, from the model alone
    assert results["port"][4][2]["itemScores"][0]["item"] == "i1"
    after = {r: counter.labels(r).value - n for r, n in before.items()}
    assert after == {"seen_filter": len(users), "unavailable_items": len(users),
                     "recent_items": 2}  # coldu and nobody fall through


def test_reload_drops_the_old_generations_factor_cache(trained):
    """Known-user queries fill the serving model's cache (device rows); a
    /reload to a new instance drops it (counted), and the new generation
    gathers from its own factors."""
    jax_storage, storage = trained["jax_storage"], trained["port_storage"]
    first = trained["ecommerce"]["instance"]
    dep = pt_server.deploy_engine("ecommerce", storage=storage,
                                  engine_instance_id=first.id, device="cpu")
    old = dep.models[0]
    swaps = REGISTRY.counter(
        "pio_factor_cache_invalidations_total",
        "Factor-cache generation invalidations by reason", labelnames=("reason",),
    ).labels("swap")
    n_swaps = swaps.value
    server = _server("port", dep, True)
    try:
        for u in ("u0", "u1", "u2", "u0"):
            assert _request(server.port, json.dumps({"user": u, "num": 3}))[0] == 200
        cache = pt_cache.model_cache(old)
        assert len(cache) == 3
        row = cache.get("u1")
        assert torch.equal(row, old.user_factors[old.user_vocab.get("u1")])
        second = _train(jax_storage, "ecommerce")
        status, body = _post(server.port, "/reload")
        assert (status, body["engineInstanceId"]) == (200, second.id)
        assert len(cache) == 0
        assert id(old) not in pt_cache._CACHES
        assert swaps.value == n_swaps + 1
        new = dep.models[0]
        assert new is not old
        status, headers, _ = _request(server.port, json.dumps({"user": "u1", "num": 3}))
        assert (status, headers["X-Pio-Engine-Instance"]) == (200, second.id)
        assert torch.equal(pt_cache.model_cache(new).get("u1"),
                           new.user_factors[new.user_vocab.get("u1")])
    finally:
        server.shutdown()


def test_drain_timeout_bounds_close_with_a_wave_in_flight(trained, monkeypatch):
    elapsed, drains = {}, {}
    for name in ("jax", "port"):
        dep = trained["ecommerce"][name]
        entered, release = threading.Event(), threading.Event()
        real = dep.predict_batch_bound

        def held(binding, queries, real=real, entered=entered, release=release):
            entered.set()
            release.wait(TIMEOUT)
            return real(binding, queries)

        monkeypatch.setattr(dep, "predict_batch_bound", held)
        server = _server(name, dep, True, drain_timeout_s=0.3)
        batcher = server.app.microbatcher
        box = []
        client = threading.Thread(
            target=lambda: box.append(
                _request(server.port, json.dumps({"user": "u0", "num": 3}))),
            daemon=True,
        )
        try:
            client.start()
            assert batcher.drain_timeout_s == 0.3
            assert entered.wait(TIMEOUT)
            t0 = time.perf_counter()
            batcher.close()  # the wave is still inside its predict
            elapsed[name] = time.perf_counter() - t0
        finally:
            release.set()
            client.join(TIMEOUT)
            server.shutdown()
        assert not client.is_alive()
        drains[name] = server.app.microbatcher._m_drain_timeout.value
    for name in ("jax", "port"):
        assert 0.25 <= elapsed[name] < 3.0, elapsed
    assert drains == {"jax": 1.0, "port": 1.0}


def test_the_default_drain_timeout_matches_jax(trained):
    dep = trained["ecommerce"]
    apps = [
        jax_server.create_prediction_server_app(
            dep["jax"], use_microbatch=True, registry=JaxRegistry(), enable_alerts=False),
        pt_server.create_prediction_server_app(
            dep["port"], use_microbatch=True, registry=MetricsRegistry()),
    ]
    try:
        assert [a.microbatcher.drain_timeout_s for a in apps] == [5.0, 5.0]
    finally:
        for a in apps:
            a.microbatcher.close()


# -- degraded_scope and FactorCache against the JAX package's --------------------


def _degrade_trace(mod):
    """The reasons each scope saw, over nesting, repeats and a copied
    context (as run_in_executor copies it)."""
    out = []
    mod.mark_degraded("outside")  # no scope: counted only
    out.append(mod.current_degraded())
    with mod.degraded_scope() as outer:
        mod.mark_degraded("a")
        mod.mark_degraded("a")
        with mod.degraded_scope() as inner:
            mod.mark_degraded("b")
            out.append(list(inner))
            out.append(mod.current_degraded())
        mod.mark_degraded("c")
        contextvars.copy_context().run(mod.mark_degraded, "d")
        out.append(list(outer))
    out.append(mod.current_degraded())
    return out


def test_degraded_scopes_match_jax():
    counter = REGISTRY.counter(
        "pio_degraded_total", "Requests answered in degraded (fallback) mode, by reason",
        labelnames=("reason",))
    before = counter.labels("a").value
    assert _degrade_trace(pt_degrade) == _degrade_trace(jax_degrade)
    assert counter.labels("a").value == before + 2


def _cache_trace(mod, row):
    cache = mod.FactorCache(capacity=3)
    out = []
    for key in ("u1", "u2", "u3", "u1", "u4", "u2", "u5"):
        hit = cache.get(key)
        out.append((key, hit is not None, len(cache)))
        if hit is None:
            cache.put(key, row(key))
    out.append(sorted(cache._rows))
    zero = mod.FactorCache(capacity=0)
    zero.put("u1", row("u1"))
    out.append((len(zero), zero.get("u1") is None, cache.clear(), len(cache)))
    return out


def test_factor_cache_matches_jax():
    def row(key):
        return torch.full((4,), float(key[1:]))

    assert _cache_trace(pt_cache, row) == _cache_trace(jax_cache, lambda k: np.full(4, 1.0))
    before = pt_cache.stats()
    cache = pt_cache.FactorCache(capacity=2)
    cache.get("x")
    cache.put("x", row("u7"))
    assert torch.equal(cache.get("x"), row("u7"))
    after = pt_cache.stats()
    assert after["hits_total"] - before["hits_total"] == 1
    assert after["misses_total"] - before["misses_total"] == 1


def test_model_cache_dies_with_its_model():
    class Model:
        pass

    model = Model()
    cache = pt_cache.model_cache(model)
    cache.put("u1", torch.zeros(3))
    assert pt_cache.model_cache(model) is cache
    key = id(model)
    del model
    gc.collect()
    assert key not in pt_cache._CACHES and len(cache) == 0
    other = Model()
    pt_cache.model_cache(other).put("u2", torch.zeros(3))
    assert pt_cache.invalidate_model_caches([other, Model()], "test") == 1
