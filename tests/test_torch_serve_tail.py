"""The serve tail of the port's deploy against the JAX package's, on the CPU.

- TLS on both front ends (``AppServer``, ``AsyncAppServer``) from explicit
  PEM paths or ``PIO_SSL_CERTFILE`` / ``PIO_SSL_KEYFILE`` (the event server
  too), and ``/queries.json`` over TLS answering the bytes plain HTTP
  answers.
- ``deploy --feedback``: each answer written back as a ``predict`` event of
  entity type ``pio_pr`` whose properties equal the JAX package's for the
  same queries (only the random 64-hex-digit entity id differs).  A
  feedback write that raises fails no query, solo or in a micro-batched
  wave; an invalid feedback key refuses the build, as in JAX.
- Output plugins on both paths: the answer, the feedback event and the
  decision record all hold what the plugin returned; ``/plugins.json``
  answers the JAX package's body and 401 without the deploy's key.

Answers are compared exactly (both packages answer a wave of one from the
host replica's numpy product and top-k).
"""

from __future__ import annotations

import asyncio
import json
import logging
import ssl
import subprocess
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import predictionio_tpu.models  # noqa: F401  (the JAX package's factories)
from predictionio_tpu.data.storage.base import EventFilter as JaxEventFilter
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.server import plugins as jax_plugins
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.server.httpd import AppServer as JaxAppServer
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.storage.base import EventFilter
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.sqlite_backend import SQLiteLEvents
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import plugins as pt_plugins
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.server.aio import AsyncAppServer
from predictionio_tpu_torch.server.event_server import create_event_server
from predictionio_tpu_torch.server.httpd import AppServer, HTTPApp, Response

torch.set_num_threads(2)

TIMEOUT = 10
USERS = [f"u{u}" for u in range(0, 30, 3)]


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    """A self-signed certificate and its key, made with ``openssl``."""
    tmp = tmp_path_factory.mktemp("tls")
    cert, key = tmp / "cert.pem", tmp / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
         "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=localhost"],
        check=True, capture_output=True, timeout=60,
    )
    return str(cert), str(key)


def _client_ctx() -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _call(url: str, body: dict | None = None, key: str | None = None,
          tls: bool = False) -> tuple[int, dict, bytes]:
    """(status, headers, body bytes) of a GET, or a POST of ``body``."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Authorization": f"Bearer {key}"} if key else {})
    try:
        with urllib.request.urlopen(
            req, timeout=TIMEOUT, context=_client_ctx() if tls else None
        ) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# -- TLS -------------------------------------------------------------------------


@pytest.mark.parametrize("front_end", [AppServer, AsyncAppServer])
def test_https_serving(cert, front_end):
    """Each front end with a self-signed certificate answers over TLS (the
    JAX package's ``TestSSL``), and refuses plain HTTP."""
    app = HTTPApp("ssltest")

    @app.route("GET", "/")
    def index(req):
        return Response(200, {"secure": True})

    server = front_end(
        app, host="127.0.0.1", port=0, ssl_certfile=cert[0], ssl_keyfile=cert[1]
    ).start_background()
    try:
        status, _, body = _call(f"https://127.0.0.1:{server.port}/", tls=True)
        assert status == 200 and json.loads(body)["secure"] is True
        with pytest.raises(Exception):
            _call(f"http://127.0.0.1:{server.port}/")
    finally:
        server.shutdown()


def test_the_event_server_takes_tls_from_the_environment(cert, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_SSL_CERTFILE", cert[0])
    monkeypatch.setenv("PIO_SSL_KEYFILE", cert[1])
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path)}))
    server = create_event_server(
        host="127.0.0.1", port=0, storage=storage).start_background()
    try:
        status, _, body = _call(f"https://127.0.0.1:{server.port}/", tls=True)
        assert (status, json.loads(body)) == (200, {"status": "alive"})
    finally:
        server.shutdown()
        storage.close()


# -- a trained home both packages serve ------------------------------------------


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """The quickstart app (the JAX package's ``app_new`` and
    ``import_events``) and a model the port trained on it on the CPU."""
    tmp = tmp_path_factory.mktemp("quickstart")
    rng = np.random.default_rng(3)
    with open(tmp / "events.jsonl", "w") as f:
        for _ in range(400):
            u, i = rng.integers(30), rng.integers(20)
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(rng.integers(1, 6))}}) + "\n")
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(tmp)}))
    try:
        d = jax_cmd.app_new(jax_storage, "quickstart")
        jax_cmd.import_events(jax_storage, "quickstart", tmp / "events.jsonl")
        other = jax_cmd.app_new(jax_storage, "other")
    finally:
        jax_storage.close()
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp)}))
    try:
        engine = resolve_engine_factory("recommendation")()
        params = engine.params_from_json({
            "datasource": {"params": {"appName": "quickstart"}},
            "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3}}],
        })
        instance = run_train(engine, params, ctx=EngineContext(storage=storage, device="cpu"),
                             storage=storage, engine_factory="recommendation")
    finally:
        storage.close()
    return tmp, instance.id, (d.app.id, d.keys[0].key), (other.app.id, other.keys[0].key)


@pytest.fixture()
def storage(home):
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home[0])}))
    yield storage
    storage.close()


def _serve(storage, kind="aio", **kw):
    return pt_server.create_prediction_server(
        "recommendation", host="127.0.0.1", port=0, storage=storage,
        server_kind=kind, device="cpu", **kw).start_background()


@pytest.mark.parametrize("kind", ["aio", "threaded"])
def test_queries_over_tls_answer_as_plain_http(cert, storage, kind, monkeypatch):
    plain = _serve(storage, kind)
    try:
        want = [_call(f"http://127.0.0.1:{plain.port}/queries.json",
                      {"user": u, "num": 3})[2] for u in USERS]
    finally:
        plain.shutdown()
    monkeypatch.setenv("PIO_SSL_CERTFILE", cert[0])
    monkeypatch.setenv("PIO_SSL_KEYFILE", cert[1])
    server = _serve(storage, kind)
    try:
        got = [_call(f"https://127.0.0.1:{server.port}/queries.json",
                     {"user": u, "num": 3}, tls=True) for u in USERS]
    finally:
        server.shutdown()
    assert [g[0] for g in got] == [200] * len(USERS)
    assert [g[2] for g in got] == want


# -- feedback ---------------------------------------------------------------------


def _predict_events(storage, app_id: int) -> list:
    return list(storage.l_events().find(
        app_id, None, EventFilter(event_names=("predict",))))


def test_feedback_loop_writes_the_jax_packages_events(home, storage):
    """The JAX package's ``test_feedback_loop``, on both packages' deploys
    of one model: one ``predict`` event per query, equal apart from the
    random entity id."""
    tmp, instance_id, (app_id, key), _ = home
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(tmp)}))
    jserver = jax_server.create_prediction_server(
        "recommendation", host="127.0.0.1", port=0, storage=jax_storage,
        feedback=jax_server.FeedbackConfig(enabled=True, access_key=key),
    ).start_background()
    try:
        jax_bodies = [_call(f"http://127.0.0.1:{jserver.port}/queries.json",
                            {"user": u, "num": 2})[2] for u in USERS]
        jax_events = list(jax_storage.l_events().find(
            app_id, None, JaxEventFilter(event_names=("predict",))))
    finally:
        jserver.shutdown()
        jax_storage.close()
    server = _serve(storage, feedback=pt_server.FeedbackConfig(enabled=True, access_key=key))
    try:
        bodies = [_call(f"http://127.0.0.1:{server.port}/queries.json",
                        {"user": u, "num": 2})[2] for u in USERS]
    finally:
        server.shutdown()
    seen = {e.event_id for e in jax_events}
    events = [e for e in _predict_events(storage, app_id) if e.event_id not in seen]
    assert bodies == jax_bodies
    assert len(events) == len(jax_events) == len(USERS)

    def key_of(e):
        assert len(e.entity_id) == 64 and int(e.entity_id, 16) >= 0
        return (e.event, e.entity_type, e.target_entity_type, e.target_entity_id,
                json.dumps(e.properties.fields, sort_keys=True))

    assert sorted(map(key_of, events)) == sorted(map(key_of, jax_events))
    assert {e.properties.get("engineInstanceId") for e in events} == {instance_id}
    assert events[0].properties.get("prediction")["itemScores"]
    # each event holds its query and the answer that query got
    for e in events:
        q = e.properties.get("query")
        assert json.loads(bodies[USERS.index(q["user"])]) == e.properties.get("prediction")


def test_an_invalid_feedback_key_refuses_the_build(storage):
    deployed = pt_server.deploy_engine("recommendation", storage=storage, device="cpu")
    with pytest.raises(RuntimeError, match="feedback access key is invalid"):
        pt_server.create_prediction_server_app(
            deployed, feedback=pt_server.FeedbackConfig(enabled=True, access_key="nope"))
    with pytest.raises(RuntimeError, match="requires an app_id or access_key"):
        pt_server.create_prediction_server_app(
            deployed, feedback=pt_server.FeedbackConfig(enabled=True))


def _queued(app, payloads: list) -> list:
    """``payloads`` queued on the app's micro-batcher at once: one wave."""
    batcher = app.microbatcher

    async def burst():
        with batcher._cond:
            futs = [asyncio.ensure_future(batcher.submit(pt_server.QueuedQuery(p), {}))
                    for p in payloads]
            await asyncio.sleep(0)
        return await asyncio.gather(*futs)

    return asyncio.run(burst())


def _boom(self, *a, **kw):
    raise OSError("event store down")


def test_a_failed_feedback_write_fails_no_query(home, storage, monkeypatch, caplog):
    _, _, _, (app_id, key) = home
    feedback = pt_server.FeedbackConfig(enabled=True, access_key=key)
    monkeypatch.setattr(SQLiteLEvents, "insert", _boom)
    caplog.set_level(logging.ERROR, "predictionio_tpu_torch.serving")
    # solo, on the threaded server
    server = _serve(storage, "threaded", feedback=feedback)
    try:
        got = [_call(f"http://127.0.0.1:{server.port}/queries.json",
                     {"user": u, "num": 2}) for u in USERS[:3]]
    finally:
        server.shutdown()
    assert [g[0] for g in got] == [200] * 3
    # a micro-batched wave
    deployed = pt_server.deploy_engine("recommendation", storage=storage, device="cpu")
    app = pt_server.create_prediction_server_app(
        deployed, feedback=feedback, use_microbatch=True, max_batch=64,
        registry=MetricsRegistry())
    try:
        wave = _queued(app, [{"user": u, "num": 2} for u in USERS])
    finally:
        app.microbatcher.close()
    assert [w[0] for w in wave] == ["ok"] * len(USERS)
    assert all(w[1]["itemScores"] for w in wave)
    failed = [r for r in caplog.records if "feedback event failed" in r.getMessage()]
    assert len(failed) == 3 + len(USERS)
    monkeypatch.undo()
    assert _predict_events(storage, app_id) == []


# -- output plugins ------------------------------------------------------------------


def _mark_plugin(base, blocker_type):
    """An output blocker keeping the first item and marking the answer."""

    class MarkPlugin(base):
        plugin_name = "mark"
        plugin_type = blocker_type

        def process(self, engine_instance_id, query, prediction):
            return {"itemScores": prediction["itemScores"][:1], "marked": True,
                    "user": query["user"]}

        def handle_rest(self, path, query):
            return {"path": path, "query": query}

    return MarkPlugin()


def _port_plugins():
    ctx = pt_plugins.PluginContext()
    ctx.register(_mark_plugin(pt_plugins.EngineServerPlugin, pt_plugins.OUTPUT_BLOCKER))
    return ctx


@pytest.mark.parametrize("kind", ["aio", "threaded"])
def test_the_output_plugin_changes_what_is_answered_and_recorded(home, storage, kind):
    _, _, _, (app_id, key) = home
    server = _serve(storage, kind, plugins=_port_plugins(),
                    feedback=pt_server.FeedbackConfig(enabled=True, access_key=key))
    try:
        got = [_call(f"http://127.0.0.1:{server.port}/queries.json",
                     {"user": u, "num": 3}) for u in USERS]
        records = [server.app.provenance.get(h["X-Pio-Request-Id"]) for _, h, _ in got]
    finally:
        server.shutdown()
    bodies = [json.loads(b) for _, _, b in got]
    assert all(b["marked"] and len(b["itemScores"]) == 1 for b in bodies)
    assert [b["user"] for b in bodies] == USERS
    # the decision record keeps the plugin's answer, not the engine's
    assert [r["items"] for r in records] == [
        [{"item": b["itemScores"][0]["item"], "score": b["itemScores"][0]["score"]}]
        for b in bodies]
    # and so does the feedback event
    events = _predict_events(storage, app_id)
    by_user = {e.properties.get("query")["user"]: e.properties.get("prediction")
               for e in events}
    assert [by_user[u] for u in USERS] == bodies
    storage.l_events().remove(app_id)
    storage.l_events().init(app_id)


def test_the_output_plugin_runs_on_a_queued_wave(storage):
    deployed = pt_server.deploy_engine("recommendation", storage=storage, device="cpu")
    app = pt_server.create_prediction_server_app(
        deployed, plugins=_port_plugins(), use_microbatch=True, max_batch=64,
        registry=MetricsRegistry())
    try:
        wave = _queued(app, [{"user": u, "num": 3} for u in USERS])
    finally:
        app.microbatcher.close()
    assert [w[1]["user"] for w in wave] == USERS
    assert all(w[1]["marked"] and len(w[1]["itemScores"]) == 1 for w in wave)


def test_plugins_routes_answer_as_jax(home, storage):
    tmp, _, _, _ = home
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(tmp)}))
    jctx = jax_plugins.PluginContext()
    jctx.register(_mark_plugin(jax_plugins.EngineServerPlugin, jax_plugins.OUTPUT_BLOCKER))
    jax_app = jax_server.create_prediction_server_app(
        jax_server.deploy_engine("recommendation", storage=jax_storage),
        access_key="S", plugins=jctx)
    servers = {
        "jax": JaxAppServer(jax_app, "127.0.0.1", 0).start_background(),
        "port": _serve(storage, access_key="S", plugins=_port_plugins()),
    }
    got = {}
    try:
        for name, server in servers.items():
            base = f"http://127.0.0.1:{server.port}"
            got[name] = [
                _call(base + "/plugins.json")[::2],
                _call(base + "/plugins.json", key="S")[::2],
                _call(base + "/plugins/outputblocker/mark/x/y?a=1", key="S")[::2],
                _call(base + "/plugins/outputblocker/none", key="S")[0],
                _call(base + "/plugins/outputblocker/mark")[0],
            ]
    finally:
        for server in servers.values():
            server.shutdown()
        jax_storage.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 401
    assert json.loads(got["port"][1][1]) == {
        "plugins": {"outputblocker": {"mark": {"class": "_mark_plugin.<locals>.MarkPlugin"}}}}
    assert json.loads(got["port"][2][1]) == {"path": "/x/y", "query": {"a": "1"}}
