"""The port's event server against the JAX package's, on the CPU.

Every case of ``tests/test_event_server.py``, the ingest-gate case of
``tests/test_data_plane.py`` (``TestBackpressure``) and the input-blocker
case of ``tests/test_aux.py`` (``TestPlugins``), plus the routes and
filters those leave out, is sent as the same requests to both packages'
``create_event_server_app``, each over a storage of its own set up the
same way (an app, a key for all events, a key for ``rate`` only, a
channel).  Status codes, ``Retry-After`` and bodies must be equal, with
event ids mapped in the order they appear and ``creationTime`` (a wall
clock) left out; afterwards both stores must hold equal events.  The
port's threaded server then takes 4 clients x 2,000 events over real HTTP
on port 0, each event stored exactly once.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
from datetime import datetime
from urllib.parse import urlencode

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.server import event_server as jax_es
from predictionio_tpu.server import httpd as jax_httpd
from predictionio_tpu.server import plugins as jax_plugins
from predictionio_tpu_torch.data.storage import base as pt_base
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import event_server as pt_es
from predictionio_tpu_torch.server import httpd as pt_httpd
from predictionio_tpu_torch.server import plugins as pt_plugins

torch.set_num_threads(2)

TIMEOUT = 10

EVENT = {
    "event": "rate",
    "entityType": "user",
    "entityId": "u1",
    "targetEntityType": "item",
    "targetEntityId": "i1",
    "properties": {"rating": 4.0},
    "eventTime": "2026-01-01T00:00:00.000Z",
}

MAILCHIMP_SUBSCRIBE = {
    "type": "subscribe",
    "fired_at": "2026-03-26 21:35:57",
    "data[id]": "8a25ff1d98",
    "data[list_id]": "a6b5da1054",
    "data[email]": "api@example.com",
    "data[email_type]": "html",
    "data[merges][EMAIL]": "api@example.com",
    "data[merges][FNAME]": "Mail",
    "data[ip_opt]": "10.20.10.30",
    "data[ip_signup]": "10.20.10.30",
}

SEGMENT_TRACK = {
    "version": "2",
    "type": "track",
    "userId": "user42",
    "event": "Signed Up",
    "properties": {"plan": "Pro"},
    "timestamp": "2026-01-05T10:00:00.000Z",
}

#: a fixed event time for events that would otherwise take the wall clock
T = "2026-02-01T00:00:00.000Z"

BASIC = {"Authorization": "Basic " + base64.b64encode(b"SECRET:").decode()}


class Pkg:
    """One package's side of a parity case: its modules, a storage set up
    as the JAX package's ``served`` fixture does, and its app."""

    def __init__(self, name: str, home, **app_kw):
        self.name = name
        jax = name == "jax"
        self.base = jax_base if jax else pt_base
        self.es = jax_es if jax else pt_es
        self.httpd = jax_httpd if jax else pt_httpd
        self.plugins = jax_plugins if jax else pt_plugins
        self.registry = JaxRegistry() if jax else MetricsRegistry()
        cfg = (JaxStorageConfig if jax else StorageConfig).from_env(
            {"PIO_HOME": str(home / name)}
        )
        self.storage = (JaxStorageRuntime if jax else StorageRuntime)(cfg)
        b = self.base
        self.app_id = self.storage.apps().insert(b.App(id=0, name="testapp", description=""))
        keys = self.storage.access_keys()
        keys.insert(b.AccessKey(key="SECRET", appid=self.app_id, events=()))
        keys.insert(b.AccessKey(key="LIMITED", appid=self.app_id, events=("rate",)))
        self.channel_id = self.storage.channels().insert(
            b.Channel(id=0, name="ch1", appid=self.app_id)
        )
        self.storage.l_events().init(self.app_id)
        self.app_kw = app_kw
        self._app = None

    @property
    def app(self):
        if self._app is None:
            self._app = self.es.create_event_server_app(
                self.storage, registry=self.registry, **self.app_kw
            )
        return self._app

    def send(self, method, path, query=None, body=None, headers=None):
        """(status, Retry-After, body) of one request through the app."""
        raw = b""
        if body is not None:
            raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        resp = self.app.handle(self.httpd.Request(
            method=method, path=path, query=dict(query or {}),
            headers=dict(headers or {}), body=raw,
        ))
        return resp.status, resp.headers.get("Retry-After"), json.loads(resp.encoded()[0])

    def stored(self) -> list[dict]:
        """Every event of the app's default namespace and its channel."""
        out = []
        for ch in (None, self.channel_id):
            out += [dict(e.to_api_dict(), namespace=ch)
                    for e in self.storage.l_events().find(self.app_id, ch)]
        return out

    def ingested(self) -> dict:
        fam = self.registry.get("pio_events_ingested_total")
        if fam is None:
            return {}
        return {k[0]: c.value for k, c in fam._children.items()}

    def close(self):
        self.storage.close()


class IdMap:
    """Event ids of one package to positional tokens, in order of first
    appearance, so two packages' random ids compare."""

    def __init__(self):
        self.ids: dict[str, str] = {}

    def __call__(self, obj):
        if isinstance(obj, (list, tuple)):
            return [self(x) for x in obj]
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if k == "creationTime":
                    continue
                if k == "eventId" and isinstance(v, str):
                    v = self.ids.setdefault(v, f"id{len(self.ids)}")
                elif k in ("startTime", "endTime") and isinstance(v, str):
                    # the hourly window's wall clock: on the hour, not compared
                    t = datetime.fromisoformat(v)
                    assert (t.minute, t.second, t.microsecond) == (0, 0, 0), v
                    v = "hour"
                out[k] = self(v)
            return out
        return obj


def _pair(tmp_path, **app_kw):
    return Pkg("jax", tmp_path, **app_kw), Pkg("port", tmp_path, **app_kw)


def _run(pkg: Pkg, scenario) -> list:
    answers = []

    def send(*args, **kw):
        answers.append(pkg.send(*args, **kw))
        return answers[-1]

    scenario(send)
    return answers


# -- the scenarios: each one case of the JAX package's tests, or a route or
# filter they leave out --------------------------------------------------------

Q = {"accessKey": "SECRET"}


def missing_key(send):
    send("POST", "/events.json", body=EVENT)


def invalid_key(send):
    send("POST", "/events.json", {"accessKey": "nope"}, EVENT)


def basic_auth_header(send):
    send("POST", "/events.json", body=EVENT, headers=BASIC)
    send("POST", "/events.json", body=EVENT, headers={"Authorization": "Basic !!"})
    send("POST", "/events.json", body=EVENT, headers={"Authorization": "Bearer SECRET"})


def invalid_channel(send):
    send("POST", "/events.json", {"accessKey": "SECRET", "channel": "nope"}, EVENT)


def restricted_events(send):
    bad = {k: v for k, v in EVENT.items() if not k.startswith("target")}
    send("POST", "/events.json", {"accessKey": "LIMITED"}, dict(bad, event="buy"))
    send("POST", "/events.json", {"accessKey": "LIMITED"}, EVENT)
    send("POST", "/batch/events.json", {"accessKey": "LIMITED"},
         [EVENT, dict(bad, event="buy")])


def roundtrip(send):
    _, _, body = send("POST", "/events.json", Q, EVENT)
    eid = body["eventId"]
    send("GET", f"/events/{eid}.json", Q)
    send("DELETE", f"/events/{eid}.json", Q)
    send("GET", f"/events/{eid}.json", Q)
    send("DELETE", f"/events/{eid}.json", Q)


def channel_isolation(send):
    send("POST", "/events.json", {"accessKey": "SECRET", "channel": "ch1"}, EVENT)
    send("GET", "/events.json", Q)
    send("GET", "/events.json", {"accessKey": "SECRET", "channel": "ch1"})


def malformed_event(send):
    send("POST", "/events.json", Q, {"event": "", "entityType": "user", "entityId": "u1"})
    send("POST", "/events.json", Q, b"{not json")
    send("POST", "/events.json", Q, [EVENT])
    send("POST", "/events.json", Q, dict(EVENT, eventTime="yesterday"))


def query_filters(send):
    for i in range(5):
        e = dict(EVENT, entityId=f"u{i}", eventTime=f"2026-01-0{i + 1}T00:00:00.000Z")
        send("POST", "/events.json", Q, e)
    send("GET", "/events.json", dict(Q, entityId="u2", entityType="user"))
    send("GET", "/events.json", dict(Q, startTime="2026-01-03T00:00:00.000Z", limit="10"))
    send("GET", "/events.json", dict(Q, reversed="true"))


def every_filter(send):
    """The filters and limits the JAX package's tests leave out."""
    for i in range(25):
        e = dict(EVENT, entityId=f"u{i % 3}", targetEntityId=f"i{i % 4}",
                 event="rate" if i % 2 else "view",
                 eventTime=f"2026-02-{i + 1:02d}T12:00:00+02:00")
        send("POST", "/events.json", Q, e)
    send("POST", "/events.json", Q, {"event": "$set", "entityType": "user",
                                     "entityId": "u0", "properties": {"a": 1},
                                     "eventTime": "2026-02-10T00:00:00Z"})
    send("GET", "/events.json", Q)  # the default limit of 20
    send("GET", "/events.json", dict(Q, limit="-1"))
    send("GET", "/events.json", dict(Q, untilTime="2026-02-05T10:00:00.000Z"))
    send("GET", "/events.json", dict(Q, event="view", limit="100"))
    send("GET", "/events.json", dict(Q, targetEntityType="item", targetEntityId="i2"))
    send("GET", "/events.json", dict(Q, entityType="user", entityId="u1",
                                     reversed="true", limit="4"))
    send("GET", "/events.json", dict(Q, entityType="user", entityId="u0",
                                     event="$set"))
    send("GET", "/events.json", dict(Q, limit="many"))
    send("GET", "/events.json", dict(Q, startTime="not a time"))
    send("GET", "/events.json", dict(Q, entityType="item"))


def batch_mixed(send):
    send("POST", "/batch/events.json", Q,
         [EVENT, {"event": "", "entityType": "user", "entityId": "x"},
          dict(EVENT, entityId="u9"), "not an event"])


def batch_cap(send):
    send("POST", "/batch/events.json", Q, [EVENT] * 51)
    send("POST", "/batch/events.json", Q, [dict(EVENT, entityId=f"u{i}") for i in range(50)])
    send("POST", "/batch/events.json", Q, EVENT)
    send("POST", "/batch/events.json", Q, b"[")


def stats_counts(send):
    send("POST", "/events.json", Q, EVENT)
    send("POST", "/events.json", Q, EVENT)
    send("GET", "/stats.json", Q)


def stats_mixed_target_types(send):
    send("POST", "/events.json", Q, EVENT)
    send("POST", "/events.json", Q, {"event": "$set", "entityType": "user",
                                     "entityId": "u1", "properties": {"a": 1},
                                     "eventTime": T})
    send("POST", "/batch/events.json", Q, [EVENT, dict(EVENT, event="buy")])
    send("GET", "/stats.json", Q)


def segmentio_track(send):
    send("POST", "/webhooks/segmentio.json", Q, SEGMENT_TRACK)
    send("GET", "/events.json", Q)


def segmentio_unknown_type(send):
    send("POST", "/webhooks/segmentio.json", Q,
         {"version": "2", "type": "frobnicate", "userId": "u"})
    send("POST", "/webhooks/segmentio.json", Q, [SEGMENT_TRACK])
    send("POST", "/webhooks/segmentio.json", Q, b"{")


def unsupported_connector(send):
    send("POST", "/webhooks/nope.json", Q, {"a": 1})
    send("POST", "/webhooks/nope.form", Q, b"a=1")
    send("GET", "/webhooks/nope.json", Q)
    send("GET", "/webhooks/nope.form", Q)
    send("GET", "/webhooks/segmentio.json", Q)
    send("GET", "/webhooks/mailchimp.form", Q)
    send("GET", "/webhooks/mailchimp.form")


def mailchimp_subscribe_form(send):
    send("POST", "/webhooks/mailchimp.form", Q, urlencode(MAILCHIMP_SUBSCRIBE).encode())
    send("GET", "/events.json", Q)


def mailchimp_bad_fired_at(send):
    form = {"type": "subscribe", "fired_at": "2026-03-26T21:35:57",
            "data[id]": "x", "data[list_id]": "y"}
    send("POST", "/webhooks/mailchimp.form", Q, urlencode(form).encode())
    send("POST", "/webhooks/mailchimp.form", Q, b"\xff\xfe")


def liveness_and_methods(send):
    send("GET", "/")
    send("PUT", "/events.json", Q, EVENT)
    send("GET", "/nowhere.json", Q)


def stats_off(send):
    send("GET", "/stats.json", Q)


SCENARIOS = [
    missing_key, invalid_key, basic_auth_header, invalid_channel,
    restricted_events, roundtrip, channel_isolation, malformed_event,
    query_filters, every_filter, batch_mixed, batch_cap, stats_counts,
    stats_mixed_target_types, segmentio_track, segmentio_unknown_type,
    unsupported_connector, mailchimp_subscribe_form, mailchimp_bad_fired_at,
    liveness_and_methods,
]


def _hold_equal(jax_pkg: Pkg, port_pkg: Pkg, scenario):
    want = IdMap()(_run(jax_pkg, scenario))
    got = IdMap()(_run(port_pkg, scenario))
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, (scenario.__name__, n)
    # the same events in both stores, ids mapped in store order
    assert IdMap()(port_pkg.stored()) == IdMap()(jax_pkg.stored())
    assert port_pkg.ingested() == jax_pkg.ingested()


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_routes_answer_as_jax(tmp_path, scenario):
    jax_pkg, port_pkg = _pair(tmp_path, stats=True)
    try:
        _hold_equal(jax_pkg, port_pkg, scenario)
    finally:
        jax_pkg.close()
        port_pkg.close()


def test_stats_need_the_flag(tmp_path):
    jax_pkg, port_pkg = _pair(tmp_path)
    try:
        _hold_equal(jax_pkg, port_pkg, stats_off)
        assert port_pkg.send("GET", "/stats.json", Q)[0] == 404
    finally:
        jax_pkg.close()
        port_pkg.close()


# -- plugins (test_event_server.py TestPluginRoutes, test_aux.py TestPlugins) --


def _plugin_ctx(pkg: Pkg):
    p = pkg.plugins

    class Sniffy(p.EventServerPlugin):
        plugin_name = "sniffy"
        plugin_type = p.INPUT_SNIFFER

        def __init__(self):
            self.seen = []

        def process(self, app_id, channel_id, event):
            self.seen.append((app_id, channel_id, event.event, event.entity_id))

        def handle_rest(self, path, query):
            return {"echo": path, "q": query.get("x")}

    class RejectBuys(p.EventServerPlugin):
        plugin_name = "rejectbuys"
        plugin_type = p.INPUT_BLOCKER

        def process(self, app_id, channel_id, event):
            if event.event == "buy":
                raise ValueError("buys are blocked")

    ctx = p.PluginContext()
    ctx.register(Sniffy())
    ctx.register(RejectBuys())
    return ctx


def _user_event(name, user):
    return {"event": name, "entityType": "user", "entityId": user, "eventTime": T}


def plugin_routes(send):
    send("GET", "/plugins.json")
    send("GET", "/plugins.json", Q)
    send("GET", "/plugins/inputsniffer/sniffy/hello", dict(Q, x="1"))
    send("GET", "/plugins/inputsniffer/sniffy", Q)
    send("GET", "/plugins/inputsniffer/nope/x", Q)
    send("POST", "/events.json", Q, _user_event("view", "u1"))
    send("POST", "/events.json", Q, _user_event("buy", "u1"))
    send("POST", "/batch/events.json", {"accessKey": "SECRET", "channel": "ch1"},
         [_user_event("buy", "u2"), _user_event("view", "u2")])
    send("POST", "/webhooks/segmentio.json", Q, SEGMENT_TRACK)


def test_plugins_answer_as_jax(tmp_path):
    jax_pkg, port_pkg = _pair(tmp_path)
    try:
        for pkg in (jax_pkg, port_pkg):
            pkg.app_kw["plugins"] = _plugin_ctx(pkg)
        _hold_equal(jax_pkg, port_pkg, plugin_routes)
        seen = []
        for pkg in (jax_pkg, port_pkg):
            ctx = pkg.app_kw["plugins"]
            ctx.drain_pending()
            (sniffy,) = [x for x in ctx._plugins if x.plugin_name == "sniffy"]
            seen.append(sniffy.seen)
        assert seen[1] == seen[0] and len(seen[0]) == 3
    finally:
        jax_pkg.close()
        port_pkg.close()


def test_plugins_from_env(tmp_path, monkeypatch):
    """``PIO_PLUGINS`` import paths resolve to the same plugins; a bad entry
    is skipped in both packages."""
    monkeypatch.setenv(
        "PIO_PLUGINS",
        "tests.test_torch_event_server:env_sniffer, no.such.module:Nope",
    )
    jax_ctx = jax_plugins.PluginContext.from_env()
    port_ctx = pt_plugins.PluginContext.from_env()
    assert port_ctx.descriptions() == jax_ctx.descriptions() == {
        "inputsniffer": {"env-sniffer": {"class": "EnvSniffer"}}
    }


class EnvSniffer:
    plugin_name = "env-sniffer"

    def __init__(self):
        self.plugin_type = "inputsniffer"

    def process(self, app_id, channel_id, event):
        pass


def env_sniffer():
    """A plugin factory, as ``PIO_PLUGINS`` may name one."""
    return EnvSniffer()


def _output_steps(p) -> list:
    """The output half of a ``PluginContext`` (test_aux.py TestPlugins):
    blockers transform a prediction in order, a blocker's error reaches
    the caller, sniffers see the blocked prediction and their errors are
    swallowed."""

    class Tag(p.EngineServerPlugin):
        plugin_name = "tag"
        plugin_type = p.OUTPUT_BLOCKER

        def process(self, engine_instance_id, query, prediction):
            if query.get("veto"):
                raise ValueError("vetoed")
            return {**prediction, "tags": prediction.get("tags", []) + [engine_instance_id]}

    class Watch(p.EngineServerPlugin):
        plugin_name = "watch"

        def __init__(self):
            self.seen = []

        def process(self, engine_instance_id, query, prediction):
            self.seen.append((engine_instance_id, query, prediction))

    class Boom(p.EngineServerPlugin):
        plugin_name = "boom"

        def process(self, *a):
            raise RuntimeError("boom")

    ctx, watch = p.PluginContext(), Watch()
    for plugin in (Tag(), Boom(), watch, Tag()):
        ctx.register(plugin)
    steps = [ctx.process_output("inst1", {"q": 1}, {"itemScores": []}),
             ctx.process_output("inst2", {"q": 2}, {"ok": 1})]
    with pytest.raises(ValueError, match="vetoed"):
        ctx.process_output("inst3", {"veto": True}, {"ok": 1})
    ctx.drain_pending()
    return steps + [watch.seen, ctx.descriptions()]


def test_output_plugins_as_jax():
    got, want = _output_steps(pt_plugins), _output_steps(jax_plugins)
    assert got == want
    assert got[0] == {"itemScores": [], "tags": ["inst1", "inst1"]}
    assert len(got[2]) == 2


# -- the ingest gate (test_data_plane.py TestBackpressure) ----------------------


def _slow_store(pkg: Pkg, gate: threading.Event) -> threading.Semaphore:
    """Hold every write until ``gate`` opens; the returned semaphore is
    released once per write that entered the store."""
    levents = pkg.storage.l_events()
    real = levents.insert
    entered = threading.Semaphore(0)

    def slow_insert(event, app_id, channel_id=None):
        entered.release()
        assert gate.wait(timeout=TIMEOUT), "the gate never opened"
        return real(event, app_id, channel_id)

    levents.insert = slow_insert
    return entered


@pytest.mark.parametrize("route", ["/events.json", "/batch/events.json",
                                   "/webhooks/segmentio.json"])
def test_saturated_ingest_sheds_503_as_jax(tmp_path, route):
    """Two writes held inside a slow store, then four more: each package
    admits two (201, or 200 for a batch) and sheds four with 503 and
    ``Retry-After: 1``; reads are never gated; the shed count is
    ``pio_shed_total{reason="eventstore"}``."""
    body = {
        "/events.json": {"event": "view", "entityType": "user", "entityId": "u1"},
        "/batch/events.json": [{"event": "view", "entityType": "user", "entityId": "u1"}],
        "/webhooks/segmentio.json": SEGMENT_TRACK,
    }[route]
    outcomes = {}
    for pkg in _pair(tmp_path, max_write_inflight=2):
        gate = threading.Event()
        entered = _slow_store(pkg, gate)
        pkg.app  # built before the threads race to build it
        results: list = []
        lock = threading.Lock()

        def post():
            r = pkg.send("POST", route, Q, body)
            with lock:
                results.append(r[:2])

        held = [threading.Thread(target=post, daemon=True) for _ in range(2)]
        for th in held:
            th.start()
        for _ in held:  # both writes inside the store, both slots taken
            assert entered.acquire(timeout=TIMEOUT)
        rest = [threading.Thread(target=post, daemon=True) for _ in range(4)]
        for th in rest:
            th.start()
        for th in rest:
            th.join(timeout=TIMEOUT)
        shed_first = sorted(results)
        assert pkg.send("GET", "/events.json", Q)[0] == 404  # reads pass
        gate.set()
        for th in held:
            th.join(timeout=TIMEOUT)
        assert not any(th.is_alive() for th in held + rest)
        shed = pkg.registry.get("pio_shed_total")
        outcomes[pkg.name] = (shed_first, sorted(results),
                              shed.labels("eventstore").value)
        pkg.close()
    ok = 200 if route.startswith("/batch") else 201
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == [(503, "1")] * 4
    assert outcomes["port"][1] == [(ok, None)] * 2 + [(503, "1")] * 4
    assert outcomes["port"][2] == 4


class _DownStore:
    """An event store whose every write and read raises, as a store that
    lost its connection does."""

    def __init__(self, exc):
        self.exc = exc

    def __getattr__(self, name):
        def fail(*args, **kw):
            raise self.exc

        return fail


@pytest.mark.parametrize("exc", [ConnectionError("refused"), TimeoutError("slow")],
                         ids=["connection", "timeout"])
def test_store_unavailable_answers_503_as_jax(tmp_path, exc):
    jax_pkg, port_pkg = _pair(tmp_path)
    try:
        for pkg in (jax_pkg, port_pkg):
            pkg.storage.l_events = lambda exc=exc: _DownStore(exc)

        def writes(send):
            send("POST", "/events.json", Q, EVENT)
            send("POST", "/batch/events.json", Q, [EVENT, EVENT])
            send("POST", "/webhooks/segmentio.json", Q, SEGMENT_TRACK)

        want, got = _run(jax_pkg, writes), _run(port_pkg, writes)
        assert got == want
        assert got[0][:2] == (503, "1")
    finally:
        jax_pkg.close()
        port_pkg.close()


# -- real HTTP ------------------------------------------------------------------


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_servers_bind_and_serve_as_jax(tmp_path):
    """test_event_server.py's socket-level case, on both packages' threaded
    servers bound to port 0: liveness, POST, GET by id, DELETE (the verb
    the port's handler gained), Basic auth."""
    answers = {}
    for pkg in _pair(tmp_path):
        server = pkg.es.create_event_server(host="127.0.0.1", port=0,
                                            storage=pkg.storage)
        server.start_background()
        try:
            ids = IdMap()
            got = [_http(server.port, "GET", "/")]
            got.append(_http(server.port, "POST", "/events.json?accessKey=SECRET",
                             json.dumps(EVENT), {"Content-Type": "application/json"}))
            eid = got[-1][1]["eventId"]
            got.append(_http(server.port, "GET", f"/events/{eid}.json", headers=BASIC))
            got.append(_http(server.port, "DELETE", f"/events/{eid}.json?accessKey=SECRET"))
            got.append(_http(server.port, "GET", f"/events/{eid}.json?accessKey=SECRET"))
            answers[pkg.name] = ids(got)
        finally:
            server.shutdown()
            pkg.close()
    assert answers["port"] == answers["jax"]
    assert [s for s, _ in answers["port"]] == [200, 201, 200, 200, 404]


def test_shutdown_is_safe_twice_and_before_serving(tmp_path):
    pkg = Pkg("port", tmp_path)
    try:
        idle = pt_es.create_event_server(host="127.0.0.1", port=0, storage=pkg.storage)
        idle.shutdown()
        idle.shutdown()
        server = pt_es.create_event_server(host="127.0.0.1", port=0, storage=pkg.storage)
        server.start_background()
        assert _http(server.port, "GET", "/")[0] == 200
        server.shutdown()
        server.shutdown()
        assert not server._thread.is_alive()
    finally:
        pkg.close()


CLIENTS, PER_CLIENT = 4, 2_000


def test_concurrent_batches_store_every_event_once(tmp_path):
    """4 clients x 2,000 events in batches of 50 over real HTTP, while a
    reader on a connection of its own (as a ``pio train`` in another
    process has) scans the same file: every item answers 201, every event
    is stored exactly once, each scan sees distinct events in a growing
    count (a batch's items commit one by one, as in the JAX package), and
    ``/stats.json`` counts them all."""
    pkg = Pkg("port", tmp_path)
    server = pt_es.create_event_server(host="127.0.0.1", port=0, storage=pkg.storage,
                                       stats=True)
    server.start_background()
    reader_storage = StorageRuntime(StorageConfig.from_env(
        {"PIO_HOME": str(tmp_path / "port")}))
    scans: list = []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set():
                frame = reader_storage.p_events().find(pkg.app_id)
                scans.append((len(frame), len(set(frame.event_id))))
        except Exception as e:  # reported below
            scans.append(repr(e))

    scan_thread = threading.Thread(target=reader, daemon=True)
    rng = np.random.default_rng(7)
    errors: list = []
    statuses: list = []
    lock = threading.Lock()

    def client(c):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
            for lo in range(0, PER_CLIENT, 50):
                batch = [
                    {"event": "rate", "entityType": "user", "entityId": f"c{c}-{n}",
                     "targetEntityType": "item", "targetEntityId": f"i{rng_items[c][n]}",
                     "properties": {"rating": int(rng_items[c][n] % 5 + 1)},
                     "eventTime": "2026-04-01T00:00:00.000Z"}
                    for n in range(lo, lo + 50)
                ]
                conn.request("POST", "/batch/events.json?accessKey=SECRET",
                             body=json.dumps(batch))
                resp = conn.getresponse()
                items = json.loads(resp.read())
                with lock:
                    statuses.append(resp.status)
                    statuses.extend(x["status"] for x in items)
            conn.close()
        except Exception as e:  # reported below
            with lock:
                errors.append(repr(e))

    rng_items = rng.integers(0, 100, (CLIENTS, PER_CLIENT))
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(CLIENTS)]
    try:
        scan_thread.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        done.set()
        scan_thread.join(timeout=TIMEOUT)
        assert not any(th.is_alive() for th in threads + [scan_thread])
        assert errors == []
        assert all(isinstance(x, tuple) for x in scans), scans[-1]
        counts = [n for n, _ in scans]
        assert counts == sorted(counts) and all(n == u for n, u in scans)
        assert len(scans) > 1 and counts[-1] <= CLIENTS * PER_CLIENT
        n_batches = CLIENTS * PER_CLIENT // 50
        assert statuses.count(200) == n_batches
        assert statuses.count(201) == CLIENTS * PER_CLIENT
        stored = list(pkg.storage.l_events().find(pkg.app_id))
        assert len(stored) == CLIENTS * PER_CLIENT
        assert len({e.event_id for e in stored}) == CLIENTS * PER_CLIENT
        assert sorted(e.entity_id for e in stored) == sorted(
            f"c{c}-{n}" for c in range(CLIENTS) for n in range(PER_CLIENT))
        status, stats = _http(server.port, "GET", "/stats.json?accessKey=SECRET")
        assert status == 200
        assert stats["currentHour"]["statusCode"] == [
            {"status": 201, "count": CLIENTS * PER_CLIENT}]
    finally:
        done.set()
        server.shutdown()
        reader_storage.close()
        pkg.close()


# -- the store's row CRUD behind the routes ---------------------------------------


def _filters(base):
    t = lambda d: datetime.fromisoformat(f"2026-02-{d:02d}T00:00:00+00:00")  # noqa: E731
    F = base.EventFilter
    return [
        F(), F(start_time=t(5)), F(until_time=t(9)), F(start_time=t(3), until_time=t(4)),
        F(entity_type="user"), F(entity_type="item"), F(entity_id="u1"),
        F(event_names=("view",)), F(event_names=("rate", "$set")),
        F(target_entity_type="item"), F(target_entity_type=""),
        F(target_entity_id="i2"), F(target_entity_id=""),
        F(entity_type="user", entity_id="u2", event_names=("rate",), target_entity_id="i0"),
    ]


def _store_events(pkg: Pkg) -> list:
    """Every filter's events from the store (in its order) and through
    ``EventFilter.matches`` over the whole store (in store order)."""
    le = pkg.storage.l_events()
    everything = list(le.find(pkg.app_id))
    out = []
    for f in _filters(pkg.base):
        found = [e.event_id for e in le.find(pkg.app_id, None, f)]
        matched = [e.event_id for e in everything if f.matches(e)]
        assert sorted(found) == sorted(matched), f
        out.append([{"eventId": x} for x in found])
    return out


def test_filters_match_as_the_store_and_jax(tmp_path):
    """``EventFilter.matches`` selects what ``find`` returns, in both
    packages, and the two packages' stores return the same events."""
    def fill(send):
        every_filter(send)
        send("POST", "/events.json", Q, {"event": "$set", "entityType": "item",
                                         "entityId": "i9", "eventTime": T})

    jax_pkg, port_pkg = _pair(tmp_path)
    try:
        ids = [IdMap() for _ in range(2)]
        want = ids[0](_run(jax_pkg, fill))
        got = ids[1](_run(port_pkg, fill))
        assert got == want
        assert ids[1](_store_events(port_pkg)) == ids[0](_store_events(jax_pkg))
    finally:
        jax_pkg.close()
        port_pkg.close()


def test_row_and_frame_crud_as_jax(tmp_path):
    """``LEvents.insert`` (an event carrying an id replaces its row),
    ``get``, ``delete``, ``remove``; ``PEvents.write`` of a frame into
    another namespace and ``PEvents.delete`` of ids: the same store in
    both packages after each step."""
    from predictionio_tpu.data.event import Event as JaxEvent
    from predictionio_tpu_torch.data.event import Event

    states = {}
    for pkg in _pair(tmp_path):
        ev = JaxEvent if pkg.name == "jax" else Event
        le, pe = pkg.storage.l_events(), pkg.storage.p_events()
        steps = []
        t0 = datetime.fromisoformat("2026-05-01T00:00:00+00:00")
        ids = [le.insert(ev.from_api_dict(dict(EVENT, entityId=f"u{n}",
                                                eventTime=f"2026-05-0{n + 1}T00:00:00Z")),
                         pkg.app_id) for n in range(4)]
        steps.append(pkg.stored())
        replaced = ev.from_api_dict(dict(EVENT, entityId="u9", eventId=ids[1],
                                         eventTime="2026-05-09T00:00:00Z"))
        assert le.insert(replaced, pkg.app_id) == ids[1]
        steps.append(pkg.stored())
        steps.append(le.get(ids[1], pkg.app_id).to_api_dict())
        steps.append((le.get("nope", pkg.app_id), le.delete(ids[0], pkg.app_id),
                      le.delete(ids[0], pkg.app_id)))
        frame = pe.find(pkg.app_id)
        pe.write(frame, pkg.app_id, pkg.channel_id)
        steps.append(pkg.stored())
        pe.delete([ids[2], "nope"], pkg.app_id, pkg.channel_id)
        steps.append(pkg.stored())
        assert le.remove(pkg.app_id, pkg.channel_id)
        steps.append(pkg.stored())
        le.close()
        steps.append(len(list(le.find(pkg.app_id, None, pkg.base.EventFilter(
            start_time=t0)))))
        states[pkg.name] = IdMap()(steps)
        pkg.close()
    assert states["port"] == states["jax"]
    assert states["port"][-1] == 3
