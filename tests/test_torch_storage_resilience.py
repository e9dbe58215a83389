"""The port's circuit breaker, retry policy and storage-client resilience
against the JAX package's, on the CPU.

Every breaker and retry case of ``tests/test_resilience.py`` runs on both
packages on the same frozen clock and seeded RNG, and their observations
must be equal; every ``TestRemoteClientResilience`` case runs the port's
``RemoteClient`` against the port's daemon under the port's fault
injector; ``TestEventServerShedsWhenStoreDown`` sends the same requests to
both packages' event servers over a dead storage daemon, whose answers
(503 + ``Retry-After``, per-item 503 in a batch) must be equal.  Then the
front ends: ``CircuitOpen`` answers 503 + ``Retry-After`` on the threaded
and the asyncio server, ``/slo.json`` carries the breakers, and a deploy's
``/readyz`` turns not ready on an open storage breaker.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import time

import pytest
import torch

from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.obs.quality import QualityMonitor as JaxQualityMonitor
from predictionio_tpu.resilience import breaker as jax_breaker
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu.resilience import retry as jax_retry
from predictionio_tpu.server import event_server as jax_es
from predictionio_tpu.server import httpd as jax_httpd
from predictionio_tpu_torch.data.storage import base as pt_base
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.remote_backend import (
    RemoteClient,
    RemoteStorageError,
    StorageUnavailable,
)
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.quality import QualityMonitor
from predictionio_tpu_torch.resilience import breaker as pt_breaker
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.resilience import retry as pt_retry
from predictionio_tpu_torch.resilience.deadline import (
    DeadlineExceeded,
    deadline_scope,
)
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import event_server as pt_es
from predictionio_tpu_torch.server import httpd as pt_httpd
from predictionio_tpu_torch.server.storage_server import StorageServer

torch.set_num_threads(2)

TIMEOUT = 10
#: a loopback port nothing listens on (connect refused at once)
_DEAD_URL = "http://127.0.0.1:2"

PACKAGES = {
    "jax": (jax_breaker, JaxRegistry),
    "port": (pt_breaker, MetricsRegistry),
}


@pytest.fixture(autouse=True)
def _isolate_process_globals():
    """Breakers are process-global (endpoint-keyed) and fault plans are
    process-wide in both packages: neither leaks across tests."""
    for mod in (jax_breaker, pt_breaker):
        mod.reset_breakers()
    for mod in (jax_faults, faults):
        mod.clear()
    yield
    for mod in (jax_breaker, pt_breaker):
        mod.reset_breakers()
    for mod in (jax_faults, faults):
        mod.clear()


@pytest.fixture()
def clock(monkeypatch):
    """One frozen clock for both packages' breakers."""
    state = {"t": 1000.0}
    for mod in (jax_breaker, pt_breaker):
        monkeypatch.setattr(mod, "_now", lambda: state["t"])
    return state


def _both(scenario, clock):
    """Run ``scenario(breaker_module, registry_class)`` on each package from
    the same clock reading; return {package: observations}."""
    out = {}
    for name, (mod, reg) in PACKAGES.items():
        clock["t"] = 1000.0
        out[name] = scenario(mod, reg)
    return out


# ---------------------------------------------------------------------------
# the circuit breaker (tests/test_resilience.py::TestCircuitBreaker)


def _lifecycle(mod, reg_cls):
    obs = []
    reg = reg_cls()
    br = mod.CircuitBreaker(
        "ep", failure_threshold=3, reset_timeout_s=5.0, registry=reg
    )
    gauge = reg.get("pio_breaker_state").labels("ep")
    obs.append((br.state, gauge.value))
    br.record_failure()
    br.record_failure()
    obs.append(br.state)
    br.record_failure()
    obs.append((br.state, gauge.value, br.allow(), br.retry_after_s()))
    try:
        br.guard("op")
        obs.append("admitted")
    except mod.CircuitOpen as e:
        obs.append(("rejected", e.retry_after_s))
    return obs, br, gauge


def test_breaker_full_lifecycle(clock):
    got = {}
    for name, (mod, reg_cls) in PACKAGES.items():
        clock["t"] = 1000.0
        obs, br, gauge = _lifecycle(mod, reg_cls)
        clock["t"] += 5.0
        obs.append(br.state)
        obs.append((br.allow(), gauge.value))
        obs.append(br.allow())
        br.record_success()
        obs.append((br.state, gauge.value, br.snapshot()))
        got[name] = obs
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port[0] == ("closed", 0) and port[1] == "closed"
    assert port[2] == ("open", 2, False, 5.0)
    assert port[3] == ("rejected", 5.0)
    assert port[4] == "half_open" and port[5] == (True, 1) and port[6] is False
    assert port[7][:2] == ("closed", 0)


def test_breaker_half_open_failure_reopens(clock):
    def scenario(mod, reg_cls):
        br = mod.CircuitBreaker(
            "ep2", failure_threshold=1, reset_timeout_s=5.0, registry=reg_cls()
        )
        br.record_failure()
        obs = [br.state]
        clock["t"] += 5.0
        obs.append(br.allow())
        br.record_failure()
        obs += [br.state, br.allow(), br.snapshot()["opened_total"]]
        return obs

    got = _both(scenario, clock)
    assert got["port"] == got["jax"] == ["open", True, "open", False, 2]


def test_breaker_abandoned_trial_releases_its_slot(clock):
    def scenario(mod, reg_cls):
        br = mod.CircuitBreaker(
            "ep-rel", failure_threshold=1, reset_timeout_s=5.0,
            registry=reg_cls(),
        )
        br.record_failure()
        clock["t"] += 5.0
        obs = [br.allow()]
        br.release_trial()
        obs.append(br.allow())
        br.record_success()
        obs.append(br.state)
        return obs

    got = _both(scenario, clock)
    assert got["port"] == got["jax"] == [True, True, "closed"]


def test_breaker_success_resets_failure_streak(clock):
    def scenario(mod, reg_cls):
        br = mod.CircuitBreaker("ep3", failure_threshold=2, registry=reg_cls())
        br.record_failure()
        br.record_success()
        br.record_failure()
        return [br.state, br.snapshot()]

    got = _both(scenario, clock)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "closed"


def test_breaker_registry_shares_by_name(clock):
    def scenario(mod, reg_cls):
        a = mod.get_breaker("storage:h:1", failure_threshold=1)
        b = mod.get_breaker("storage:h:1", failure_threshold=9)
        obs = [a is b, a.failure_threshold]
        a.record_failure()
        obs.append(mod.breaker_states())
        mod.reset_breakers()
        obs.append(mod.breaker_states())
        return obs

    got = _both(scenario, clock)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == [True, 1]
    assert got["port"][2]["storage:h:1"]["state"] == "open"
    assert got["port"][3] == {}


def test_breaker_reset_force_closes(clock):
    def scenario(mod, reg_cls):
        br = mod.CircuitBreaker("ep4", failure_threshold=1, registry=reg_cls())
        br.record_failure()
        obs = [br.state]
        br.reset()
        obs += [br.state, br.allow(), br.retry_after_s()]
        return obs

    got = _both(scenario, clock)
    assert got["port"] == got["jax"] == ["open", "closed", True, 0.0]


# ---------------------------------------------------------------------------
# the retry policy and budget (tests/test_resilience.py::TestRetry)


def test_retry_backoff_is_bounded_jittered_and_equal_across_packages():
    seqs = {}
    for name, mod in (("jax", jax_retry), ("port", pt_retry)):
        policy = mod.RetryPolicy(
            max_attempts=5, base_backoff_s=0.05, max_backoff_s=1.0
        )
        rng = random.Random(7)
        prev, seq = 0.0, []
        for _ in range(20):
            prev = policy.backoff_s(prev, rng)
            assert 0.05 <= prev <= 1.0
            seq.append(prev)
        seqs[name] = seq
    assert seqs["port"] == seqs["jax"]  # the same draws, bit for bit
    assert len(set(round(s, 6) for s in seqs["port"])) > 5


@pytest.mark.parametrize("mod", [jax_retry, pt_retry], ids=["jax", "port"])
def test_retry_invalid_policy(mod):
    with pytest.raises(ValueError):
        mod.RetryPolicy(max_attempts=0)
    assert mod.NO_RETRY.max_attempts == 1


def test_retry_budget_caps_retry_volume():
    got = {}
    for name, mod in (("jax", jax_retry), ("port", pt_retry)):
        budget = mod.RetryBudget(cap=2.0, deposit_per_call=0.5)
        obs = [budget.try_spend(), budget.try_spend(), budget.try_spend()]
        for _ in range(2):
            budget.record_call()
        obs += [budget.try_spend(), budget.try_spend(), budget.tokens]
        got[name] = obs
    assert got["port"] == got["jax"] == [True, True, False, True, False, 0.0]


# ---------------------------------------------------------------------------
# RemoteClient transport resilience against the port's daemon
# (tests/test_resilience.py::TestRemoteClientResilience)


@pytest.fixture()
def daemon(tmp_path):
    s = StorageServer(tmp_path / "root", host="127.0.0.1", port=0)
    s.start_background()
    yield s
    s.shutdown()


def _client(url, **kw):
    kw.setdefault("timeout", 2.0)
    return RemoteClient(url, **kw)


class TestRemoteClientResilience:
    def test_send_phase_fault_is_retried(self, daemon):
        inj = faults.install(
            [{"seam": "remote.send", "kind": "connection_reset", "count": 1}]
        )
        c = _client(f"http://127.0.0.1:{daemon.port}")
        assert c.json("GET", "/v1/ping")["status"] == "alive"
        assert inj.snapshot()[0]["fired"] == 1
        assert c.breaker.state == "closed"

    def test_response_phase_fault_retries_only_idempotent(self, daemon):
        c = _client(f"http://127.0.0.1:{daemon.port}")
        faults.install(
            [{"seam": "remote.response", "kind": "connection_reset", "count": 1}]
        )
        assert c.json("GET", "/v1/ping")["status"] == "alive"
        faults.install(
            [{"seam": "remote.response", "kind": "connection_reset", "count": 1}]
        )
        with pytest.raises(RemoteStorageError, match="after send"):
            c.request("POST", "/v1/apps", body=b"{}", idempotent=False)

    def test_retry_policy_bounds_attempts(self):
        c = _client(
            _DEAD_URL,
            retry=pt_retry.RetryPolicy(max_attempts=3, base_backoff_s=0.001),
            breaker=None,
        )
        inj = faults.install(
            [{"seam": "remote.send", "kind": "connection_reset"}]
        )
        with pytest.raises(StorageUnavailable, match="unreachable"):
            c.request("GET", "/v1/ping")
        assert inj.snapshot()[0]["seen"] == 3  # exactly max_attempts

    def test_breaker_opens_and_rejects_in_microseconds(self):
        c = _client(
            _DEAD_URL,
            retry=pt_retry.RetryPolicy(max_attempts=1),
            breaker_threshold=2,
            breaker_reset_s=60.0,
        )
        for _ in range(2):
            with pytest.raises(StorageUnavailable):
                c.request("GET", "/v1/ping")
        assert c.breaker.state == "open"
        t0 = time.perf_counter()
        with pytest.raises(StorageUnavailable) as ei:
            c.request("GET", "/v1/ping")
        assert time.perf_counter() - t0 < 0.05  # no connect attempt at all
        assert ei.value.retry_after_s > 0
        assert pt_breaker.breaker_states()["storage:127.0.0.1:2"]["state"] == "open"

    def test_breaker_half_open_recovers_against_live_daemon(
        self, daemon, monkeypatch
    ):
        c = _client(f"http://127.0.0.1:{daemon.port}", breaker_threshold=1)
        c.breaker.record_failure()
        assert c.breaker.state == "open"
        real_now = pt_breaker._now
        monkeypatch.setattr(pt_breaker, "_now", lambda: real_now() + 3600.0)
        assert c.breaker.state == "half_open"
        assert c.json("GET", "/v1/ping")["status"] == "alive"  # the trial
        assert c.breaker.state == "closed"

    def test_deadline_mid_trial_does_not_wedge_breaker(self, daemon, monkeypatch):
        c = _client(f"http://127.0.0.1:{daemon.port}", breaker_threshold=1)
        c.breaker.record_failure()
        real_now = pt_breaker._now
        monkeypatch.setattr(pt_breaker, "_now", lambda: real_now() + 3600.0)
        assert c.breaker.state == "half_open"
        faults.install(
            [
                {"seam": "remote.send", "kind": "latency", "latency_s": 0.05,
                 "count": 1},
                {"seam": "remote.send", "kind": "timeout", "count": 1},
            ]
        )
        with deadline_scope(budget_s=0.02):
            with pytest.raises(DeadlineExceeded):
                c.request("GET", "/v1/ping")
        assert c.json("GET", "/v1/ping")["status"] == "alive"
        assert c.breaker.state == "closed"

    def test_deadline_preempts_call(self, daemon):
        c = _client(f"http://127.0.0.1:{daemon.port}")
        with deadline_scope(budget_s=-0.01):
            with pytest.raises(DeadlineExceeded):
                c.request("GET", "/v1/ping")
        with deadline_scope(budget_s=5.0):
            assert c.json("GET", "/v1/ping")["status"] == "alive"

    def test_deadline_capped_timeout_beats_hung_daemon(self):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)  # connects land in the backlog; nothing answers
        try:
            c = _client(
                f"http://127.0.0.1:{srv.getsockname()[1]}", timeout=30.0
            )
            t0 = time.perf_counter()
            with deadline_scope(budget_s=0.2):
                with pytest.raises(DeadlineExceeded):
                    c.request("GET", "/v1/ping")
            assert time.perf_counter() - t0 < 2.0
        finally:
            srv.close()


# ---------------------------------------------------------------------------
# the event server over a dead daemon
# (tests/test_resilience.py::TestEventServerShedsWhenStoreDown)


def _dead_env(home) -> dict:
    """Metadata in local sqlite (auth works), EVENTDATA behind a dead
    storage daemon (inserts fail) with a hair-trigger breaker."""
    return {
        "PIO_HOME": str(home),
        "PIO_STORAGE_SOURCES_DEADR_TYPE": "remote",
        "PIO_STORAGE_SOURCES_DEADR_URL": _DEAD_URL,
        "PIO_STORAGE_SOURCES_DEADR_TIMEOUT": "0.3",
        "PIO_STORAGE_SOURCES_DEADR_RETRIES": "1",
        "PIO_STORAGE_SOURCES_DEADR_BREAKER_THRESHOLD": "1",
        "PIO_STORAGE_SOURCES_DEADR_BREAKER_RESET_S": "30",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DEADR",
    }


class TestEventServerShedsWhenStoreDown:
    @pytest.fixture()
    def apps(self, tmp_path):
        """Both packages' event servers over a dead daemon, one app and
        key each (straight through the metadata DAOs: app_new would also
        init the dead event store)."""
        out = {}
        rts = []
        for name, cfg, rt_cls, base, es, reg, qm in (
            ("jax", JaxStorageConfig, JaxStorageRuntime, jax_base, jax_es,
             JaxRegistry, JaxQualityMonitor),
            ("port", StorageConfig, StorageRuntime, pt_base, pt_es,
             MetricsRegistry, QualityMonitor),
        ):
            rt = rt_cls(cfg.from_env(_dead_env(tmp_path / name)))
            rts.append(rt)
            app_id = rt.apps().insert(base.App(id=0, name="shed", description=None))
            rt.access_keys().insert(base.AccessKey(key="k-shed", appid=app_id, events=()))
            r = reg()
            out[name] = es.create_event_server_app(
                rt, registry=r, quality=qm(registry=r)
            )
        yield out
        for rt in rts:
            rt.close()

    @staticmethod
    def _post(app, request_cls, path, body):
        return app.handle(
            request_cls("POST", path, {"accessKey": "k-shed"}, {}, body)
        )

    def test_post_event_503_with_retry_after(self, apps):
        body = json.dumps(
            {"event": "rate", "entityType": "user", "entityId": "u1"}
        ).encode()
        got = {}
        for name, req_cls in (("jax", jax_httpd.Request), ("port", pt_httpd.Request)):
            r = self._post(apps[name], req_cls, "/events.json", body)
            t0 = time.perf_counter()
            r2 = self._post(apps[name], req_cls, "/events.json", body)
            elapsed = time.perf_counter() - t0
            assert r.status == 503, r.body
            assert "Retry-After" in r.headers
            assert "unavailable" in r.body["message"]
            # the breaker is open: the next ingest sheds in ~0 ms with
            # the breaker's reset hint riding the Retry-After header
            assert elapsed < 0.05
            got[name] = (r.status, r2.status, int(r2.headers["Retry-After"]) >= 1)
        assert got["port"] == got["jax"] == (503, 503, True)

    def test_batch_marks_items_503_not_500(self, apps):
        body = json.dumps(
            [
                {"event": "rate", "entityType": "user", "entityId": "u1"},
                {"entityType": "user"},  # invalid: still a per-item 400
            ]
        ).encode()
        got = {}
        for name, req_cls in (("jax", jax_httpd.Request), ("port", pt_httpd.Request)):
            r = self._post(apps[name], req_cls, "/batch/events.json", body)
            got[name] = (r.status, [item["status"] for item in r.body])
        assert got["port"] == got["jax"] == (200, [503, 400])


# ---------------------------------------------------------------------------
# the front ends


def _breaker_app(registry):
    app = pt_httpd.HTTPApp("breaker-test")

    @app.route("GET", r"/boom")
    def boom(req):
        br = pt_breaker.CircuitBreaker(
            "ep-http", failure_threshold=1, reset_timeout_s=7.0,
            registry=registry,
        )
        br.record_failure()
        br.guard("boom")
        return pt_httpd.json_response(200, {})

    return app


@pytest.mark.parametrize("front", ["threaded", "aio"])
def test_circuit_open_answers_503_with_retry_after(front):
    app = _breaker_app(MetricsRegistry())
    server = (
        pt_httpd.AppServer(app, "127.0.0.1", 0)
        if front == "threaded"
        else pt_aio.AsyncAppServer(app, "127.0.0.1", 0)
    ).start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
        conn.request("GET", "/boom")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
    assert resp.status == 503
    assert int(resp.getheader("Retry-After")) == 7
    assert "circuit" in body["message"]


def test_handle_maps_circuit_open_like_the_jax_package():
    """``HTTPApp.handle`` (the path tests and the event server's unit calls
    take) answers the same status and Retry-After in both packages."""
    got = {}
    for name, httpd, reg, brk in (
        ("jax", jax_httpd, JaxRegistry, jax_breaker),
        ("port", pt_httpd, MetricsRegistry, pt_breaker),
    ):
        app = httpd.HTTPApp("breaker-test")

        @app.route("GET", r"/boom")
        def boom(req, brk=brk, reg=reg, httpd=httpd):
            raise brk.CircuitOpen("down", retry_after_s=2.5)

        r = app.handle(httpd.Request("GET", "/boom", {}, {}, b""))
        got[name] = (r.status, r.headers.get("Retry-After"), r.body["message"])
    assert got["port"] == got["jax"] == (503, "3", "down")
