"""The port's serving front end against the JAX package's, on one model.

A small explicit-ALS model (rank 4, 300 ``rate`` events, as the JAX
package's micro-batched serving fixture trains it) is trained by the JAX
package into a temp ``PIO_HOME``; both packages deploy it from the same
sqlite file, the port on the CPU, and serve it through their own
``create_prediction_server_app(use_microbatch=True)`` and
``AsyncAppServer``:

- a fixed wave renders bit for bit the JAX package's JSON below
  ``DEVICE_BATCH_MIN`` (both on the host replica); at or above it the same
  wave through ``dispatch_batch_bound`` (the port's plain version, the JAX
  package's Pallas kernel in interpret mode) gives the same ids outside
  near-ties and scores within rtol 1e-5;
- concurrent HTTP queries coalesce into waves and each answer equals that
  user's solo answer;
- the same requests get the same status codes and ``Retry-After`` /
  ``X-Pio-Engine-Instance`` headers: 400, 404, 405, 503 (queue bound and
  in-flight cap), 504 (a spent deadline), 401, 409 and 200 on ``/reload``,
  after which ``/status.json`` names the new instance with nothing in
  flight;
- pipelined device waves release their generation once swapped out, and
  ``deploy``'s ``--max-queue``/``--max-inflight``/``--deadline-s`` reach
  ``create_prediction_server``.

Every server binds port 0 and is shut down in ``finally``; every client
call has a timeout of 10 s and every thread is a daemon.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import http.client
import json
import threading
import weakref
from datetime import timedelta

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import (
    resolve_engine_factory as jax_resolve_engine_factory,
)
from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.core.persistence import save_models as jax_save_models
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.data.datamap import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 20, 30, 300
WAVE = pt_rec.ALSAlgorithm.DEVICE_BATCH_MIN + 8
RTOL = 1e-5
TIMEOUT = 10


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One JAX-trained model, deployed by both packages from its PIO_HOME."""
    home = tmp_path_factory.mktemp("torch_serving") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    app = jax_cmd.app_new(jax_storage, "mbq").app
    rng = np.random.default_rng(0)
    levents = jax_storage.l_events()
    for n in range(N_EVENTS):
        levents.insert(
            JaxEvent(
                event="rate",
                entity_type="user",
                entity_id=f"u{n % N_USERS}",
                target_entity_type="item",
                target_entity_id=f"i{n % N_ITEMS}",
                properties=JaxDataMap({"rating": float(rng.integers(1, 6))}),
            ),
            app.id,
        )
    engine = jax_resolve_engine_factory("recommendation")()
    params = engine.params_from_json(
        {
            "datasource": {"name": "ratings", "params": {"appName": "mbq"}},
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
        "jax": jax_server.deploy_engine(
            "recommendation", storage=jax_storage, engine_instance_id=instance.id
        ),
        "port": pt_server.deploy_engine(
            "recommendation", storage=port_storage,
            engine_instance_id=instance.id, device="cpu",
        ),
    }
    port_storage.close()
    jax_storage.close()


def _queries(module, n, seed):
    rng = np.random.default_rng(seed)
    return [
        module.Query(user=f"u{rng.integers(N_USERS)}", num=int(rng.choice([3, 4, 10])))
        for _ in range(n)
    ] + [module.Query(user="nobody", num=4)]


def _rendered(pairs) -> list[str]:
    return [
        json.dumps(jax_server._render_prediction(p), sort_keys=True) for _, p in pairs
    ]


def _pairs(result):
    return [(s.item, s.score) for s in result.item_scores]


def _hold_to(got, want, what):
    """Ids equal except inside a near-tie of ``want``; scores within RTOL.

    ``want`` holds one entry more than ``got`` (an answer of num+1): the
    neighbour of the last position, so that a near tie with the first item
    outside the list is judged as one, not as a wrong id."""
    gi, gs = [x for x, _ in got], np.asarray([s for _, s in got])
    wi, ws = [x for x, _ in want], np.asarray([s for _, s in want])
    n = len(gi)
    assert len(wi) == n + 1 or (n == 0 and not wi), what
    np.testing.assert_allclose(gs, ws[:n], rtol=RTOL, atol=1e-6, err_msg=what)
    for j in np.flatnonzero(np.asarray(gi) != np.asarray(wi[:n])):
        gap = min(abs(ws[j] - ws[x]) for x in (j - 1, j + 1) if 0 <= x <= n)
        assert gap <= RTOL * abs(ws[j]) + 1e-6, (what, j)


# -- a fixed wave ---------------------------------------------------------------


def test_fixed_host_wave_renders_bit_equal(trained):
    jax_d, port_d = trained["jax"], trained["port"]
    want = jax_d.predict_batch_bound(jax_d.live_binding(), _queries(jax_rec, 48, 1))
    got = port_d.predict_batch_bound(port_d.live_binding(), _queries(pt_rec, 48, 1))
    assert len(got) == len(want) == 49
    assert _rendered(got) == _rendered(want)
    # below DEVICE_BATCH_MIN the wave declines the device dispatch
    assert port_d.dispatch_batch_bound(
        port_d.live_binding(), _queries(pt_rec, 48, 1)
    ) is None


def test_device_wave_dispatch_matches_jax(trained):
    jax_d, port_d = trained["jax"], trained["port"]
    # the reference's wave asks num+1 of each query: the last position's
    # neighbour
    wider = [dataclasses.replace(q, num=q.num + 1) for q in _queries(jax_rec, WAVE, 2)]
    jfin = jax_d.dispatch_batch_bound(jax_d.live_binding(), wider)
    pfin = port_d.dispatch_batch_bound(port_d.live_binding(), _queries(pt_rec, WAVE, 2))
    assert jfin is not None and pfin is not None
    want, got = jfin(), pfin()
    assert len(got) == len(want) == WAVE + 1
    for i, ((gq, gp), (wq, wp)) in enumerate(zip(got, want)):
        assert (gq.user, gq.num + 1) == (wq.user, wq.num)
        _hold_to(_pairs(gp), _pairs(wp), i)
    assert _pairs(got[-1][1]) == []


# -- HTTP ---------------------------------------------------------------------


def _request(port, method, path, body=None, headers=None):
    """(status, headers, JSON body or None) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = None
        return resp.status, dict(resp.getheaders()), parsed
    finally:
        conn.close()


def _query(port, user, num=4, headers=None):
    return _request(
        port, "POST", "/queries.json", json.dumps({"user": user, "num": num}), headers
    )


def _in_threads(fn, args, n_threads):
    """``fn`` over ``args`` on ``n_threads`` daemon threads, results in
    order."""
    out = [None] * len(args)
    nxt = iter(range(len(args)))
    lock = threading.Lock()

    def run():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            out[i] = fn(args[i])

    threads = [threading.Thread(target=run, daemon=True) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    return out


def _jax_app(deployed, **kw):
    return jax_server.create_prediction_server_app(
        deployed, use_microbatch=True, registry=JaxRegistry(),
        enable_alerts=False, **kw,
    )


def _port_app(deployed, **kw):
    return pt_server.create_prediction_server_app(
        deployed, use_microbatch=True, registry=MetricsRegistry(), **kw
    )


def _servers(trained, **kw):
    """(name, server, deployed) for both packages, started on port 0."""
    return [
        ("jax", jax_aio.AsyncAppServer(_jax_app(trained["jax"], **kw), "127.0.0.1", 0)
         .start_background(), trained["jax"]),
        ("port", pt_aio.AsyncAppServer(_port_app(trained["port"], **kw), "127.0.0.1", 0)
         .start_background(), trained["port"]),
    ]


def _slow_waves(deployed, monkeypatch, seconds):
    real = deployed.predict_batch_bound

    def slow(binding, queries):
        threading.Event().wait(seconds)
        return real(binding, queries)

    monkeypatch.setattr(deployed, "predict_batch_bound", slow)


#: the pair of this data whose scores tie within 1e-5 at adjacent ranks: item
#: n % 30 is rated by user n % 20, so i1 and i21 are rated by the same users
#: and their factors nearly coincide (as in ``tests/test_torch_replay.py``)
NEAR_TIE = frozenset({"i1", "i21"})


def _near_tie_swap(got: list, want: list, solo: list) -> bool:
    """True when ``got`` and ``want`` (item ids of one answer) differ by
    exactly the NEAR_TIE pair swapped at adjacent ranks ``k`` and ``k + 1``,
    their scores in ``solo`` (the answer of num+1, as (item, score)) within
    1e-5 of each other.  At the last rank the pair's other member is
    ``solo``'s extra item, outside both lists."""
    diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    n = len(got)
    if len(got) != len(want) or not diff:
        return False
    k = diff[0]
    if diff == [k, k + 1]:
        pair_ok = (got[k], got[k + 1]) == (want[k + 1], want[k])
    elif diff == [n - 1]:
        k = n - 1
        pair_ok = True
    else:
        return False
    ids = [x for x, _ in solo]
    return (pair_ok and {got[k], want[k]} == NEAR_TIE
            and set(ids[k:k + 2]) == NEAR_TIE
            and abs(solo[k][1] - solo[k + 1][1]) <= 1e-5)


@pytest.mark.parametrize("got,want,swap", [
    (["i3", "i1", "i21", "i4"], ["i3", "i21", "i1", "i4"], True),
    (["i3", "i4", "i5", "i1"], ["i3", "i4", "i5", "i21"], True),
    (["i3", "i1", "i4", "i21"], ["i3", "i21", "i4", "i1"], False),
    (["i3", "i1", "i21", "i4"], ["i3", "i1", "i21", "i4"], False),
    (["i3", "i4", "i5", "i1"], ["i3", "i4", "i5", "i7"], False),
    (["i1", "i21", "i5", "i4"], ["i21", "i1", "i5", "i4"], False),
])
def test_only_the_near_tie_counts_as_the_swap(got, want, swap):
    """The cross-package difference the concurrent answers may show is that
    pair at adjacent ranks with scores within 1e-5, and nothing else."""
    solos = {
        1: [("i3", 0.9), ("i1", 0.5), ("i21", 0.5 - 4e-6), ("i4", 0.1), ("i5", 0.05)],
        3: [("i3", 0.9), ("i4", 0.8), ("i5", 0.7), ("i21", 0.5), ("i1", 0.5 - 4e-6)],
        0: [("i1", 0.9), ("i21", 0.5), ("i5", 0.4), ("i4", 0.1), ("i3", 0.05)],
    }
    diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    solo = solos.get(diff[0] if diff else 1, solos[1])
    assert _near_tie_swap(got, want, solo) is swap


def test_concurrent_http_answers_equal_solo_answers(trained, monkeypatch):
    users = [f"u{i % N_USERS}" for i in range(48)]
    answers = {}
    solos = {}
    servers = []
    try:
        for name, dep in (("jax", trained["jax"]), ("port", trained["port"])):
            # each wave takes 10 ms: the other 15 clients' queries queue
            # behind it and coalesce
            _slow_waves(dep, monkeypatch, 0.01)
        servers = _servers(trained)
        for name, server, dep in servers:
            got = _in_threads(lambda u: _query(server.port, u), users, 16)
            mod = jax_rec if name == "jax" else pt_rec
            for u, (status, headers, body) in zip(users, got):
                assert status == 200, (name, u, body)
                assert headers["X-Pio-Engine-Instance"] == trained["instance"].id
                _, solo = dep.predict(mod.Query(user=u, num=5))
                solo = [(s.item, s.score) for s in solo.item_scores]
                solos.setdefault(name, {})[u] = solo
                _hold_to([(x["item"], x["score"]) for x in body["itemScores"]],
                         solo, (name, u))
            waves = server.app.microbatcher.wave_histogram()
            assert sum(k * v for k, v in waves.items()) == 48, name
            assert max(waves) > 1, (name, waves)
            answers[name] = [[x["item"] for x in b["itemScores"]] for _, _, b in got]
    finally:
        for _, server, _ in servers:
            server.shutdown()
    # each package forms its waves by thread timing: across the packages the
    # ids are equal but for the adjacent swap of the near tie, and nothing else
    for u, got, want in zip(users, answers["port"], answers["jax"]):
        assert got == want or _near_tie_swap(got, want, solos["jax"][u]), (u, got, want)


# -- status codes and headers ----------------------------------------------------

KEPT_HEADERS = ("Retry-After", "X-Pio-Engine-Instance")


def _shape(result):
    status, headers, _ = result
    return status, {h: headers[h] for h in KEPT_HEADERS if h in headers}


def _hold_waves(deployed, monkeypatch):
    """Hold the next wave inside its predict until ``release`` is set."""
    entered, release = threading.Event(), threading.Event()
    real = deployed.predict_batch_bound

    def held(binding, queries):
        entered.set()
        release.wait(TIMEOUT)
        return real(binding, queries)

    monkeypatch.setattr(deployed, "predict_batch_bound", held)
    return entered, release


def _background(fn, *args):
    box = []
    t = threading.Thread(target=lambda: box.append(fn(*args)), daemon=True)
    t.start()
    return t, box


def _wait(pred):
    ev = threading.Event()
    for _ in range(1000):
        if pred():
            return
        ev.wait(0.005)
    raise AssertionError("condition not reached")


def _bad_requests(server, dep, monkeypatch):
    p = server.port
    return [
        _request(p, "POST", "/queries.json", b"{not json"),
        _request(p, "POST", "/queries.json", b"[1, 2]"),
        _request(p, "POST", "/queries.json", b'"u1"'),
        _request(p, "GET", "/nope"),
        _request(p, "GET", "/queries.json"),
        _query(p, "u1", headers={"X-Pio-Deadline": "0"}),
        _query(p, "u1", headers={"X-Pio-Deadline": "-1"}),
        _query(p, "u1", headers={"X-Pio-Deadline": "soon"}),  # ignored
        _query(p, "u1", headers={"X-Pio-Deadline": "30"}),
    ]


def _queue_bound(server, dep, monkeypatch):
    entered, release = _hold_waves(dep, monkeypatch)
    t1, first = _background(_query, server.port, "u1")
    _wait(entered.is_set)  # wave 1 held inside the worker
    t2, second = _background(_query, server.port, "u2")
    _wait(lambda: len(server.app.microbatcher._pending) == 1)
    shed = _query(server.port, "u3")
    release.set()
    t1.join(TIMEOUT)
    t2.join(TIMEOUT)
    return [shed, first[0], second[0]]


def _inflight_cap(server, dep, monkeypatch):
    entered, release = _hold_waves(dep, monkeypatch)
    t1, first = _background(_query, server.port, "u1")
    _wait(entered.is_set)
    shed = _query(server.port, "u2")
    release.set()
    t1.join(TIMEOUT)
    return [shed, first[0], _query(server.port, "u2")]


def _wrong_key(server, dep, monkeypatch):
    p = server.port
    return [
        _request(p, "POST", "/reload?accessKey=wrong"),
        _request(p, "POST", "/stop?accessKey=wrong"),
        _request(p, "POST", "/reload", headers={"Authorization": "Bearer wrong"}),
        _query(p, "u1"),  # queries are not key-gated
    ]


SCENARIOS = {
    # name: (app options, the function sending its requests, expected codes)
    "bad_requests": ({}, _bad_requests, [400, 400, 400, 404, 405, 504, 504, 200, 200]),
    "queue_bound": ({"max_queue": 1}, _queue_bound, [503, 200, 200]),
    "inflight_cap": ({"max_inflight": 1}, _inflight_cap, [503, 200, 200]),
    "wrong_key": ({"access_key": "k1"}, _wrong_key, [401, 401, 401, 200]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_status_codes_and_headers_match_jax(trained, monkeypatch, scenario):
    options, drive, codes = SCENARIOS[scenario]
    shapes = {}
    servers = []
    try:
        servers = _servers(trained, **options)
        for name, server, dep in servers:
            shapes[name] = [_shape(r) for r in drive(server, dep, monkeypatch)]
    finally:
        for _, server, _ in servers:
            server.shutdown()
    assert shapes["port"] == shapes["jax"]
    assert [s for s, _ in shapes["port"]] == codes
    for status, headers in shapes["port"]:
        assert ("Retry-After" in headers) == (status == 503)
        assert headers.get("Retry-After", "1") == "1"


def test_pipelined_device_waves_release_their_generation(trained):
    """Two bursts of WAVE queries through a micro-batcher of WAVE-query
    waves: each wave is dispatched on the worker and fenced on the
    finalizer (the plain version on CPU tensors), answers equal the solo
    answers, no slot stays held, and once the engine swaps, nothing of the
    batcher holds the old generation's factors."""
    first = trained["instance"]
    dep = pt_server.deploy_engine(
        "recommendation", storage=trained["port_storage"],
        engine_instance_id=first.id, device="cpu",
    )
    app = _port_app(dep, max_batch=WAVE, max_queue=0, pipeline_depth=2)
    batcher = app.microbatcher
    old = weakref.ref(dep.models[0].user_factors)
    users = [f"u{i % N_USERS}" for i in range(2 * WAVE)]
    metas = [{} for _ in users]

    async def burst():
        # hold the batcher's condition while the burst enqueues, so the
        # worker's first wave is a full one
        with batcher._cond:
            futs = [asyncio.ensure_future(
                        batcher.submit(pt_server.QueuedQuery({"user": u, "num": 4}), m))
                    for u, m in zip(users, metas)]
            await asyncio.sleep(0)
            assert len(batcher._pending) == len(futs)
        return await asyncio.gather(*futs)

    try:
        results = asyncio.run(asyncio.wait_for(burst(), timeout=60))
        assert {(r[0], r[2]) for r in results} == {("ok", first.id)}
        assert sorted({m["wave_seq"] for m in metas}) == [1, 2]
        assert all(m["pipelined"] and m["wave_size"] == WAVE for m in metas)
        for u, (_, body, _) in zip(users, results):
            _, solo = dep.predict(pt_rec.Query(user=u, num=5))
            _hold_to([(x["item"], x["score"]) for x in body["itemScores"]],
                     _pairs(solo), u)
        assert dep.inflight_snapshot() == {} and not batcher.busy
        dep.verify_and_swap(first)  # a new binding of the same instance
        gc.collect()
        assert old() is None, "the old generation's factors are still held"
    finally:
        batcher.close()


def _no_host_replica(dep, monkeypatch):
    """Record (and refuse) every read of the deploy's host replica."""
    reads = []

    def host_factors():
        reads.append(1)
        raise AssertionError("a device wave read the host replica")

    monkeypatch.setattr(dep.models[0], "host_factors", host_factors)
    return reads


def _device_fault(where, monkeypatch):
    """The device top-k failing on every call, at its dispatch or at its
    fence, as it does under a sticky CUDA error."""

    def fail(*args, **kw):
        raise RuntimeError(f"device fault at the {where}")

    if where == "dispatch":
        monkeypatch.setattr(pt_rec, "fused_topk_batch", fail)
    else:
        monkeypatch.setattr(pt_rec.ALSAlgorithm, "_unpack", staticmethod(fail))


@pytest.mark.parametrize("where", ["dispatch", "fence"])
def test_failing_device_wave_answers_500_never_the_host(trained, monkeypatch, where):
    """A device wave whose top-k fails at its dispatch or its fence bisects
    on the device down to single queries (its halves are below the device
    floor, where a host wave would take the host replica), each an error;
    the host replica is never read.  Then, with the device floor lowered
    to 1 so that a single HTTP query is a device wave, the query answers
    500."""
    dep = pt_server.deploy_engine(
        "recommendation", storage=trained["port_storage"],
        engine_instance_id=trained["instance"].id, device="cpu",
    )
    reads = _no_host_replica(dep, monkeypatch)
    _device_fault(where, monkeypatch)
    server = pt_aio.AsyncAppServer(
        _port_app(dep, max_batch=WAVE, max_queue=0), "127.0.0.1", 0
    ).start_background()
    try:
        batcher = server.app.microbatcher

        async def burst():
            with batcher._cond:  # one wave of WAVE queries
                futs = [asyncio.ensure_future(batcher.submit(
                    pt_server.QueuedQuery({"user": f"u{i % N_USERS}", "num": 4})))
                    for i in range(WAVE)]
                await asyncio.sleep(0)
            return await asyncio.gather(*futs)

        results = asyncio.run(asyncio.wait_for(burst(), timeout=60))
        monkeypatch.setattr(pt_rec.ALSAlgorithm, "DEVICE_BATCH_MIN", 1)
        status, headers, body = _query(server.port, "u1")
    finally:
        server.shutdown()
    assert {r[0] for r in results} == {"err"}
    assert all(f"device fault at the {where}" in str(r[1]) for r in results)
    assert status == 500, body
    assert f"device fault at the {where}" in body["message"]
    assert headers["X-Pio-Engine-Instance"] == trained["instance"].id
    assert reads == [] and dep.inflight_snapshot() == {}


def test_solo_retry_of_a_device_wave_stays_on_the_device(trained, monkeypatch):
    """A device wave whose fence raises DeadlineExceeded goes to the
    batcher's solo-retry pass; each retried query, a wave of one, is
    dispatched on the device (``force``), not computed on the host
    replica, and answers as its solo answer."""
    from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded

    users = [f"u{i % N_USERS}" for i in range(WAVE)]
    solo = {u: _pairs(trained["port"].predict(pt_rec.Query(user=u, num=5))[1])
            for u in set(users)}
    dep = pt_server.deploy_engine(
        "recommendation", storage=trained["port_storage"],
        engine_instance_id=trained["instance"].id, device="cpu",
    )
    reads = _no_host_replica(dep, monkeypatch)
    real = dep.dispatch_batch_bound
    calls = []

    def first_fence_runs_out(binding, queries, force=False):
        calls.append((len(queries), force))
        fin = real(binding, queries, force=force)
        if len(calls) > 1:
            return fin

        def fence():
            fin()
            raise DeadlineExceeded("the wave's budget ran out at the fence")

        return fence

    monkeypatch.setattr(dep, "dispatch_batch_bound", first_fence_runs_out)
    app = _port_app(dep, max_batch=WAVE, max_queue=0, pipeline_depth=2)
    batcher = app.microbatcher
    metas = [{} for _ in users]

    async def burst():
        with batcher._cond:
            futs = [asyncio.ensure_future(batcher.submit(
                pt_server.QueuedQuery({"user": u, "num": 4}), m))
                for u, m in zip(users, metas)]
            await asyncio.sleep(0)
        return await asyncio.gather(*futs)

    try:
        results = asyncio.run(asyncio.wait_for(burst(), timeout=60))
    finally:
        batcher.close()
    assert calls == [(WAVE, False)] + [(1, True)] * WAVE
    assert all(m["solo_retry"] and m["wave_size"] == 1 for m in metas)
    for u, (status, body, _) in zip(users, results):
        assert status == "ok"
        _hold_to([(x["item"], x["score"]) for x in body["itemScores"]], solo[u], u)
    assert reads == [] and dep.inflight_snapshot() == {}


def test_reload_swaps_generations_as_jax(trained, monkeypatch):
    """409 while no COMPLETED instance exists (the old generation keeps
    serving), then 200 to a second instance, after which both packages
    answer from its factors and name it in ``X-Pio-Engine-Instance``."""
    first = trained["instance"]
    jax_st, port_st = trained["jax_storage"], trained["port_storage"]
    servers = []
    try:
        servers = _servers(trained, access_key="k1")
        jax_st.engine_instances().update(dataclasses.replace(first, status="INIT"))
        refused = [
            _request(s.port, "POST", "/reload?accessKey=k1") for _, s, _ in servers
        ]
        jax_st.engine_instances().update(first)
        for status, _, body in refused:
            assert status == 409 and "refused" in body["message"]
            assert body["engineInstanceId"] == first.id
        for _, s, _ in servers:
            assert _query(s.port, "u3")[1]["X-Pio-Engine-Instance"] == first.id
        # a second generation: the same vocabularies, doubled user factors
        (blob,) = jax_load_models(jax_st.models(), first.id)
        blob = dict(blob, user_factors=blob["user_factors"] * 2)
        second = dataclasses.replace(
            first, id="second-generation",
            start_time=first.start_time + timedelta(seconds=1),
        )
        jax_st.engine_instances().insert(second)
        jax_save_models(jax_st.models(), second.id, [blob])
        before = {u: _query(servers[1][1].port, u)[2] for u in ("u1", "u7")}
        swapped = [
            _request(s.port, "POST", "/reload?accessKey=k1") for _, s, _ in servers
        ]
        assert [(c, b["engineInstanceId"]) for c, _, b in swapped] == [
            (200, second.id)
        ] * 2
        fresh = pt_server.deploy_engine(
            "recommendation", storage=port_st, engine_instance_id=second.id,
            device="cpu",
        )
        for name, s, dep in servers:
            assert dep.instance.id == second.id
            assert dep.inflight_snapshot() == {}
            status, _, body = _request(s.port, "GET", "/status.json")
            assert status == 200, name
            assert {k: body[k] for k in ("status", "engineInstanceId",
                                         "inflightGenerations", "batcherBusy")} == {
                "status": "alive", "engineInstanceId": second.id,
                "inflightGenerations": {}, "batcherBusy": False,
            }, name
            assert body["request_count"] >= 1
            for u in ("u1", "u7"):
                status, headers, body = _query(s.port, u)
                assert status == 200
                assert headers["X-Pio-Engine-Instance"] == second.id
                _, want = fresh.predict(pt_rec.Query(user=u, num=4))
                want = jax_server._render_prediction(want)
                assert body == want, (name, u)
                assert body != before[u]
    finally:
        for _, server, dep in servers:
            server.shutdown()
            dep.verify_and_swap(first)  # the module's other tests' model


def test_cli_deploy_passes_the_front_end_flags(monkeypatch, capsys):
    from predictionio_tpu_torch.tools import cli

    seen = {}

    class Bound:
        """The deploy verb's server: started in the background, joined,
        shut down."""

        port = 0

        def start_background(self):
            return self

        def join(self):
            pass

        def shutdown(self):
            pass

    def create(engine, **kw):
        seen.update(kw, engine=engine)
        return Bound()

    monkeypatch.setattr(pt_server, "create_prediction_server", create)
    monkeypatch.setattr(cli, "get_storage", lambda: None)
    argv = ["deploy", "--engine", "recommendation", "--port", "0", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert (seen["max_queue"], seen["max_inflight"], seen["default_deadline_s"]) == (
        None, None, None
    )
    assert cli.main(argv + ["--max-queue", "7", "--max-inflight", "3",
                            "--deadline-s", "0.25"]) == 0
    assert (seen["max_queue"], seen["max_inflight"], seen["default_deadline_s"]) == (
        7, 3, 0.25
    )
    assert seen["device"] == "cpu" and seen["engine"] == "recommendation"
    assert "Engine deployed" in capsys.readouterr().out
