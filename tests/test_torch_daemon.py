"""The port's process management, admin API and dashboard against the JAX
package's (the cases of its ``tests/test_cli.py`` daemon, admin and
dashboard classes and ``tests/test_resilience.py``'s stop escalation):

- ``daemon``, ``start-all``, ``stop-all``, ``stop`` and ``undeploy
  --pidfile`` on the port's CLI, each daemon the port's own CLI
  (``-m predictionio_tpu_torch.tools.cli``); the pidfiles are the JAX
  package's, so the JAX ``pio stop`` stops a port daemon and the port's
  ``stop`` a JAX-style one;
- ``stop_pidfile``'s SIGTERM, its SIGKILL escalation and a dead pid;
- the admin API's JSON on one shared storage, request for request with the
  JAX package's admin API;
- the dashboard's pages against the JAX package's over one shared
  storage: the index section by section (the device panel and the
  profiler's device column are the stated exemption, and the SLO's
  ``uptime_s`` the clock's), the evaluation detail page, its
  ``evaluator_results.json``, 404s, the key gate and the trace waterfall
  of one fragment file;
- the admin API, the dashboard (with its fleet and tenants panels) and a
  router never initialize CUDA.

``PIO_HOME`` is under ``tmp_path``; servers bind port 0 (``start-all``
takes free ports); every client call has a timeout.
"""

from __future__ import annotations

import json
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import pytest
import torch

from predictionio_tpu.data.storage.base import EvaluationInstance as JaxEvaluationInstance
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.server import admin as jax_admin
from predictionio_tpu.server import dashboard as jax_dashboard
from predictionio_tpu.server.httpd import Request as JaxRequest
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import daemon as jax_daemon
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.server import admin as pt_admin
from predictionio_tpu_torch.server import dashboard as pt_dashboard
from predictionio_tpu_torch.server.httpd import AppServer, Request
from predictionio_tpu_torch.tools import daemon
from predictionio_tpu_torch.tools.cli import build_parser
from predictionio_tpu_torch.tools.cli import main as cli_main

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 30


def _free_ports(n: int) -> list[int]:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _wait_http(port, path="/", timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=2) as r:
                return r.status
        except Exception:
            time.sleep(0.2)
    raise TimeoutError(f"port {port} never served {path}")


def _cmdline(pid: int) -> str:
    """The process's command line once it has one: /proc's is empty while a
    just-spawned child is still inside execve (a few ms, longer on a loaded
    host)."""
    deadline = time.monotonic() + 10
    while True:
        raw = Path(f"/proc/{pid}/cmdline").read_bytes()
        if raw or time.monotonic() > deadline:
            return raw.replace(b"\0", b" ").decode()
        time.sleep(0.01)


@pytest.fixture()
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path))
    monkeypatch.setenv("PIO_ALERTS", "0")
    monkeypatch.chdir(REPO)  # the daemons run `python -m` from the checkout
    yield tmp_path
    for pf in (tmp_path / "pids").glob("*.pid"):
        daemon.stop_pidfile(pf, timeout=2.0)


# ---------------------------------------------------------------------------
# the daemon verbs
# ---------------------------------------------------------------------------


class TestDaemonVerbs:
    def test_start_all_stop_all(self, home, capsys):
        ev, ad, db = _free_ports(3)
        assert cli_main(["start-all", "--ip", "127.0.0.1", "--event-port", str(ev),
                         "--admin-port", str(ad), "--dashboard-port", str(db)]) == 0
        try:
            pid_dir = home / "pids"
            assert {p.name for p in pid_dir.glob("*.pid")} == {
                "eventserver.pid", "adminserver.pid", "dashboard.pid"}
            for pf in pid_dir.glob("*.pid"):
                cmd = _cmdline(daemon.read_pidfile(pf))
                assert f"-m predictionio_tpu_torch.tools.cli {pf.stem}" in cmd
            assert _wait_http(ev) == 200
            assert _wait_http(ad) == 200
            assert _wait_http(db) == 200
            with urllib.request.urlopen(f"http://127.0.0.1:{ad}/", timeout=TIMEOUT) as r:
                assert json.loads(r.read()) == {"status": "alive"}
            assert cli_main(["start-all", "--event-port", str(ev)]) == 1
        finally:
            assert cli_main(["stop-all"]) == 0
        out = capsys.readouterr().out
        assert "eventserver: stopped (SIGTERM)" in out
        assert list((home / "pids").glob("*.pid")) == []
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{ev}/", timeout=2)
        assert cli_main(["stop-all"]) == 0
        assert "Nothing to stop." in capsys.readouterr().out

    def test_start_all_boots_local_storage_daemon(self, home, monkeypatch):
        ev, ad, db, sp = _free_ports(4)
        monkeypatch.setenv("PIO_STORAGE_SOURCES_R_TYPE", "remote")
        monkeypatch.setenv("PIO_STORAGE_SOURCES_R_URL", f"http://127.0.0.1:{sp}")
        monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "R")
        assert cli_main(["start-all", "--ip", "127.0.0.1", "--event-port", str(ev),
                         "--admin-port", str(ad), "--dashboard-port", str(db)]) == 0
        try:
            pids = {p.stem for p in (home / "pids").glob("*.pid")}
            assert pids == {"storageserver", "eventserver", "adminserver", "dashboard"}
            with urllib.request.urlopen(f"http://127.0.0.1:{sp}/v1/ping",
                                        timeout=TIMEOUT) as r:
                assert json.loads(r.read())["service"] == "storage"
            assert _wait_http(ev) == 200
        finally:
            assert cli_main(["stop-all"]) == 0
        assert list((home / "pids").glob("*.pid")) == []

    def test_daemon_one_off_and_the_jax_stop_stops_it(self, home, capsys):
        (port,) = _free_ports(1)
        pidfile = home / "pids" / "oneoff.pid"
        assert cli_main(["daemon", str(pidfile), "--", "eventserver", "--ip",
                         "127.0.0.1", "--port", str(port)]) == 0
        assert f"pidfile {pidfile}" in capsys.readouterr().out
        assert _wait_http(port) == 200
        pid = daemon.read_pidfile(pidfile)
        assert daemon.pid_alive(pid) and jax_daemon.pid_alive(pid)
        assert "-m predictionio_tpu_torch.tools.cli eventserver" in _cmdline(pid)
        # the JAX package's `pio stop` reads the port's pidfile
        assert jax_cli.main(["stop", "oneoff"]) == 0
        assert "oneoff: stopped (SIGTERM)" in capsys.readouterr().out
        assert not pidfile.exists() and not daemon.pid_alive(pid)
        assert cli_main(["daemon", str(pidfile)]) == 1

    def test_port_stop_reads_a_jax_pidfile(self, home, capsys):
        proc, pidfile = _spawn_sleeper(home, ignore_term=False)
        jax_daemon_pidfile = home / "pids" / "jaxd.pid"
        jax_daemon_pidfile.parent.mkdir(parents=True, exist_ok=True)
        pidfile.rename(jax_daemon_pidfile)
        try:
            assert cli_main(["stop", "jaxd", "--timeout", "5"]) == 0
            assert "jaxd: stopped (SIGTERM)" in capsys.readouterr().out
        finally:
            proc.wait(timeout=10)

    def test_pio_stop_reports_signal(self, home, capsys):
        assert cli_main(["stop", "nosuchdaemon"]) == 1
        pids = home / "pids"
        pids.mkdir(parents=True, exist_ok=True)
        (pids / "ghost.pid").write_text("999999999")
        assert cli_main(["stop", "ghost"]) == 0
        assert "was not running" in capsys.readouterr().out

    def test_pio_stop_never_unlinks_stray_files(self, tmp_path, monkeypatch, capsys):
        monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
        monkeypatch.chdir(tmp_path)
        stray = tmp_path / "eventserver"
        stray.write_text("precious user data")
        assert cli_main(["stop", "eventserver"]) == 1
        assert stray.read_text() == "precious user data"
        (tmp_path / "dashboard").mkdir()
        assert cli_main(["stop", "dashboard"]) == 1
        capsys.readouterr()

    def test_undeploy_falls_back_to_the_pidfile(self, home, capsys):
        (port, dead_port) = _free_ports(2)
        pidfile = home / "pids" / "es.pid"
        assert cli_main(["daemon", str(pidfile), "eventserver", "--ip", "127.0.0.1",
                         "--port", str(port)]) == 0
        assert _wait_http(port) == 200
        pid = daemon.read_pidfile(pidfile)
        # /stop on a port nothing serves fails: the pidfile stops it
        assert cli_main(["undeploy", "--port", str(dead_port),
                         "--pidfile", str(pidfile)]) == 0
        out = capsys.readouterr().out
        assert "es: stopped (SIGTERM)" in out
        assert not pidfile.exists() and not daemon.pid_alive(pid)
        assert cli_main(["undeploy", "--port", str(dead_port),
                         "--pidfile", str(pidfile)]) == 0
        assert "es: was not running" in capsys.readouterr().out
        assert cli_main(["undeploy", "--port", str(dead_port)]) == 1

    def test_spawn_refuses_a_live_pidfile(self, home):
        proc, pidfile = _spawn_sleeper(home, ignore_term=False)
        try:
            with pytest.raises(RuntimeError, match="already points"):
                daemon.spawn_daemon(["version"], pidfile)
        finally:
            daemon.stop_pidfile(pidfile, timeout=5.0)
            proc.wait(timeout=10)

    def test_pio_home_and_dirs(self, home):
        assert daemon.pio_home() == jax_daemon.pio_home() == home
        assert daemon._pid_dir() == home / "pids" and daemon._log_dir().is_dir()
        assert daemon.STACK == jax_daemon.STACK


@pytest.mark.parametrize("verb,argv,fn", [
    ("stop", ["stop", "eventserver", "--timeout", "3"], "do_stop"),
    ("stop-all", ["stop-all"], "do_stop_all"),
    ("start-all", ["start-all", "--dashboard-port", "9"], "do_start_all"),
    ("daemon", ["daemon", "x.pid", "eventserver"], "do_daemon"),
    ("adminserver", ["adminserver", "--access-key", "k"], "do_adminserver"),
    ("dashboard", ["dashboard", "--port", "1"], "do_dashboard"),
    ("undeploy", ["undeploy", "--pidfile", "/tmp/x.pid"], "do_undeploy"),
    ("fleet", ["fleet", "deploy", "--engine", "x", "--device", "cpu"], "do_fleet"),
])
def test_verbs_registered_as_the_jax_cli_registers_them(verb, argv, fn):
    port = vars(build_parser().parse_args(argv))
    ref = vars(jax_cli.build_parser().parse_args(argv[:-2] if verb == "fleet" else argv))
    assert port.pop("fn").__name__ == ref.pop("fn").__name__ == fn
    port.pop("device", None)
    if verb == "fleet":
        assert port.pop("engine") == "x"
        ref.pop("engine")
    assert port == ref


def test_fleet_deploy_defaults_to_the_card():
    assert build_parser().parse_args(["fleet", "deploy"]).device == "cuda"


# ---------------------------------------------------------------------------
# SIGTERM -> SIGKILL escalation
# ---------------------------------------------------------------------------


def _spawn_sleeper(tmp_path, ignore_term: bool):
    ready = tmp_path / f"ready-{time.monotonic_ns()}"
    code = (
        "import signal, sys, time\n"
        + ("signal.signal(signal.SIGTERM, signal.SIG_IGN)\n" if ignore_term else "")
        + "open(sys.argv[2], 'w').write('up')\n"
        + "time.sleep(60)\n"
    )
    # argv names predictionio_tpu so pid_alive's /proc check owns it
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "predictionio_tpu_torch-stoptest", str(ready)])
    deadline = time.monotonic() + 10
    while not ready.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert ready.exists(), "child never came up"
    pidfile = tmp_path / "victim.pid"
    pidfile.write_text(str(proc.pid))
    return proc, pidfile


@pytest.mark.parametrize("stopper", ["port", "jax"])
class TestStopEscalation:
    def _stop(self, stopper):
        return daemon.stop_pidfile if stopper == "port" else jax_daemon.stop_pidfile

    def test_sigterm_wins_for_cooperative_daemon(self, tmp_path, stopper):
        proc, pidfile = _spawn_sleeper(tmp_path, ignore_term=False)
        try:
            assert self._stop(stopper)(pidfile, timeout=5.0) == "TERM"
            assert not pidfile.exists()
        finally:
            proc.wait(timeout=5)

    def test_sigkill_escalation_for_wedged_daemon(self, tmp_path, stopper):
        proc, pidfile = _spawn_sleeper(tmp_path, ignore_term=True)
        try:
            assert self._stop(stopper)(pidfile, timeout=0.3) == "KILL"
            assert not pidfile.exists()
        finally:
            proc.wait(timeout=5)
        assert proc.returncode == -9

    def test_nothing_running_reports_none(self, tmp_path, stopper):
        pidfile = tmp_path / "ghost.pid"
        pidfile.write_text("999999999")
        assert self._stop(stopper)(pidfile) is None
        assert not pidfile.exists()


def test_pid_alive_equals_jax(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        assert "time.sleep(30)" in _cmdline(proc.pid)  # past its execve
        for pid in (None, 999999999, proc.pid):
            assert daemon.pid_alive(pid) == jax_daemon.pid_alive(pid)
        assert not daemon.pid_alive(proc.pid)  # alive, but not one of ours
    finally:
        proc.kill()
        proc.wait(timeout=10)
    bad = tmp_path / "bad.pid"
    bad.write_text("not a pid")
    assert daemon.read_pidfile(bad) is None is jax_daemon.read_pidfile(bad)
    assert daemon.read_pidfile(tmp_path / "missing.pid") is None


# ---------------------------------------------------------------------------
# admin API
# ---------------------------------------------------------------------------


@pytest.fixture()
def shared(tmp_path):
    """Both packages' storage runtimes over one sqlite home."""
    env = {"PIO_HOME": str(tmp_path / "shared")}
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    pt_storage = StorageRuntime(StorageConfig.from_env(env))
    yield pt_storage, jax_storage
    pt_storage.close()
    jax_storage.close()


def _call(app, req_cls, method, path, body=None, query=None):
    resp = app.handle(req_cls(method, path, query or {}, {},
                              json.dumps(body).encode() if body is not None else b""))
    raw, ctype = resp.encoded()
    return resp.status, json.loads(raw) if "json" in ctype else raw.decode()


ADMIN_SCRIPT = [
    ("GET", "/", None),
    ("GET", "/cmd/app", None),
    ("POST", "/cmd/app", {"name": "{p}app", "accessKey": "{p}KEY", "description": "d"}),
    ("POST", "/cmd/app", {"name": "{p}app"}),
    ("POST", "/cmd/app", {"nope": 1}),
    ("POST", "/cmd/app", "not json"),
    ("GET", "/cmd/app/{p}app", None),
    ("GET", "/cmd/app/none", None),
    ("DELETE", "/cmd/app/{p}app/data", None),
    ("DELETE", "/cmd/app/none/data", None),
    ("DELETE", "/cmd/app/{p}app", None),
    ("GET", "/cmd/app/{p}app", None),
    ("DELETE", "/cmd/app/{p}app", None),
]


def _fill(obj, prefix):
    if isinstance(obj, str):
        return obj.replace("{p}", prefix)
    if isinstance(obj, dict):
        return {k: _fill(v, prefix) for k, v in obj.items()}
    return obj


def _unprefix(obj, prefix):
    return json.loads(json.dumps(obj).replace(prefix, "{p}"))


def test_admin_routes_equal_jax_on_one_storage(shared):
    """The same request script against both admin APIs over one storage
    (each names its own app): equal statuses and JSON bodies; and each
    API lists and shows the app the other created."""
    pt_storage, jax_storage = shared
    port = pt_admin.create_admin_app(pt_storage)
    ref = jax_admin.create_admin_app(jax_storage)
    for method, path, body in ADMIN_SCRIPT:
        if method == "GET" and path == "/cmd/app":
            continue  # compared below, once both apps exist
        got = _call(port, Request, method, _fill(path, "zq"), _fill(body, "zq"))
        want = _call(ref, JaxRequest, method, _fill(path, "xj"), _fill(body, "xj"))
        assert got[0] == want[0], (method, path)
        got_b, want_b = _unprefix(got[1], "zq"), _unprefix(want[1], "xj")
        if isinstance(got_b, dict) and "id" in got_b:
            got_b.pop("id"), want_b.pop("id")  # one id sequence, two apps
        assert got_b == want_b, (method, path)
    assert _call(port, Request, "POST", "/cmd/app", {"name": "shared1",
                                                     "accessKey": "K1"})[0] == 201
    assert _call(ref, JaxRequest, "POST", "/cmd/app", {"name": "shared2",
                                                       "accessKey": "K2"})[0] == 201
    assert _call(port, Request, "GET", "/cmd/app") == _call(ref, JaxRequest, "GET", "/cmd/app")
    for name in ("shared1", "shared2"):
        assert _call(port, Request, "GET", f"/cmd/app/{name}") == _call(
            ref, JaxRequest, "GET", f"/cmd/app/{name}")


def test_admin_key_auth(shared):
    pt_storage, _ = shared
    app = pt_admin.create_admin_app(pt_storage, access_key="adminsecret")
    assert app.handle(Request("GET", "/", {}, {})).status == 401
    assert app.handle(Request("GET", "/", {"accessKey": "wrong"}, {})).status == 401
    assert app.handle(Request("GET", "/", {"accessKey": "adminsecret"}, {})).status == 200
    assert app.handle(Request("GET", "/healthz", {}, {})).status == 200
    assert app.handle(Request("GET", "/readyz", {"accessKey": "adminsecret"}, {})).status == 200


def test_admin_server_over_http(shared):
    pt_storage, _ = shared
    server = pt_admin.create_admin_server("127.0.0.1", 0, storage=pt_storage).start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/cmd/app",
            data=json.dumps({"name": "viahttp"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 201 and json.loads(r.read())["name"] == "viahttp"
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------


def _insert_evaluation(jax_storage, iid="eval1"):
    now = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
    jax_storage.evaluation_instances().insert(JaxEvaluationInstance(
        id=iid, status="EVALCOMPLETED", start_time=now, end_time=now,
        evaluation_class="my.Eval", evaluator_results="best: 0.5",
        evaluator_results_html="<table><tr><td>0.5</td></tr></table>",
        evaluator_results_json='{"best": 0.5}'))


#: index sections that read the device: the port's CUDA accounting
EXEMPT_SECTIONS = ("<h2>Device efficiency</h2>", "<h2>Profiling</h2>")


def _sections(page: str) -> list[str]:
    page = re.sub(r"<td>uptime_s</td><td>[0-9.e-]+</td>", "<td>uptime_s</td>", page)
    return re.split(r"(?=<h2>)", page)


def _fresh_registries(monkeypatch) -> None:
    """Both dashboards read their package's process-wide ``REGISTRY``
    (the Capacity and Model-quality panels) and process-default quality
    monitor (the Model-quality panel's prediction log and drift).  Other
    test files that ran earlier in this worker left samples and logged
    predictions in one package's and not the other's, so each dashboard
    module gets a registry of its own and each package a fresh default
    monitor."""
    from predictionio_tpu.obs import quality as jax_quality
    from predictionio_tpu.obs.metrics import MetricsRegistry as JaxMetricsRegistry
    from predictionio_tpu_torch.obs import quality as pt_quality
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry

    monkeypatch.setattr(pt_dashboard, "REGISTRY", MetricsRegistry())
    monkeypatch.setattr(jax_dashboard, "REGISTRY", JaxMetricsRegistry())
    monkeypatch.setattr(pt_quality, "_default_monitor", None)
    monkeypatch.setattr(jax_quality, "_default_monitor", None)


def test_dashboard_pages_equal_jax_on_one_storage(shared, monkeypatch):
    pt_storage, jax_storage = shared
    _insert_evaluation(jax_storage)
    monkeypatch.delenv("PIO_FLEET_URL", raising=False)
    monkeypatch.delenv("PIO_SERVING_URL", raising=False)
    _fresh_registries(monkeypatch)
    port = pt_dashboard.create_dashboard_app(pt_storage)
    ref = jax_dashboard.create_dashboard_app(jax_storage)

    def both(path, query=None):
        got = port.handle(Request("GET", path, query or {}, {}))
        want = ref.handle(JaxRequest("GET", path, query or {}, {}))
        assert got.status == want.status, path
        return got, want

    got, want = both("/")
    assert got.status == 200 and "eval1" in got.body and "my.Eval" in got.body
    pt_sections, jax_sections = _sections(got.body), _sections(want.body)
    assert [s[:30] for s in pt_sections] == [s[:30] for s in jax_sections]
    compared = 0
    for a, b in zip(pt_sections, jax_sections):
        if a.startswith(EXEMPT_SECTIONS):
            continue
        # the process-wide registries and trace rings hold whatever this
        # test process recorded in each package: those panels' frames
        if a.startswith(("<h2>Metrics</h2>", "<h2>Recent traces</h2>")):
            a, b = a.split("</tr>")[0], b.split("</tr>")[0]
        assert a == b
        compared += 1
    assert compared == len(pt_sections) - len(EXEMPT_SECTIONS)
    for path in ("/engine_instances/eval1",
                 "/engine_instances/eval1/evaluator_results.json",
                 "/engine_instances/nope", "/engine_instances/nope/evaluator_results.json",
                 "/trace/no-such-trace"):
        got, want = both(path)
        assert got.encoded() == want.encoded(), path
    assert json.loads(both("/engine_instances/eval1/evaluator_results.json")[0]
                      .encoded()[0])["best"] == 0.5
    assert "0.5" in both("/engine_instances/eval1")[0].body


def test_dashboard_pages_equal_jax_after_a_port_only_sample(shared, monkeypatch):
    """A port-only wave's samples in the port's real registry
    (``pio_microbatch_batch_size`` and the ``pio_microbatch_device_seconds``
    a wave records beside it), as an earlier test file leaves them, would
    give the port's Capacity panel a device ceiling the JAX one lacks; the
    parity test above runs on fresh registries, so it still passes."""
    from predictionio_tpu_torch.obs.metrics import REGISTRY, SIZE_BUCKETS

    REGISTRY.histogram(
        "pio_microbatch_batch_size", "Queries coalesced per dispatch wave",
        buckets=SIZE_BUCKETS,
    ).observe(32)
    REGISTRY.histogram(
        "pio_microbatch_device_seconds",
        "Per-wave batch_fn (device dispatch) duration",
    ).observe(0.004)
    test_dashboard_pages_equal_jax_on_one_storage(shared, monkeypatch)


def test_dashboard_key_auth_and_gated_links(shared):
    pt_storage, _ = shared
    app = pt_dashboard.create_dashboard_app(pt_storage, access_key="dashkey")
    assert app.handle(Request("GET", "/", {}, {})).status == 401
    page = app.handle(Request("GET", "/", {"accessKey": "dashkey"}, {}))
    assert page.status == 200
    assert "/debug/stacks.json?accessKey=dashkey" in page.body
    assert app.handle(Request("GET", "/healthz", {}, {})).status == 200


def test_dashboard_waterfall_equals_jax(tmp_path):
    """One assembled trace (a bundle-style fragment file) renders to the
    same waterfall HTML and the same Perfetto JSON in both packages."""
    from predictionio_tpu.obs import timeline as jax_timeline
    from predictionio_tpu_torch.obs import timeline as pt_timeline

    frags = [
        {"trace_id": "t1", "span_id": "a", "parent_id": None, "name": "http.router",
         "process": "router@h:1", "start_s": 100.0, "duration_s": 0.01},
        {"trace_id": "t1", "span_id": "b", "parent_id": "a", "name": "fleet.forward",
         "process": "router@h:1", "start_s": 100.001, "duration_s": 0.008,
         "tags": {"replica": "h:2"}},
        {"trace_id": "t1", "span_id": "c", "parent_id": "b",
         "name": "http.predictionserver", "process": "deploy@h:2",
         "start_s": 100.002, "duration_s": 0.005, "error": "boom"},
        {"trace_id": "t1", "span_id": "d", "parent_id": "zz", "name": "orphan",
         "process": "deploy@h:2", "start_s": 100.003, "duration_s": 0.001},
    ]
    path = tmp_path / "frags.json"
    path.write_text(json.dumps({"spans": frags}))
    pt_tl = pt_timeline.collect_trace("t1", files=[str(path)])
    jax_tl = jax_timeline.collect_trace("t1", files=[str(path)])
    for key in (None, "k&y"):
        assert pt_dashboard._waterfall_html(pt_tl, access_key=key) == (
            jax_dashboard._waterfall_html(jax_tl, access_key=key))
    assert json.dumps(pt_tl.to_chrome_trace()) == json.dumps(jax_tl.to_chrome_trace())
    assert "fleet.forward" in pt_dashboard._waterfall_html(pt_tl)


def test_dashboard_helpers_equal_jax():
    for values in ([], [1.0], [3.0, 1.0, 2.0, 2.0], [0.0] * 5, list(range(20))):
        assert pt_dashboard._sparkline(values) == jax_dashboard._sparkline(values)
    for v in (None, 3, 2.5, "x"):
        assert pt_dashboard._esc_num(v) == jax_dashboard._esc_num(v)
    for key in (None, "k"):
        assert pt_dashboard._fleet_html("http://127.0.0.1:1", key) == (
            jax_dashboard._fleet_html("http://127.0.0.1:1", key))
        assert pt_dashboard._tenants_html("http://127.0.0.1:1", key) == (
            jax_dashboard._tenants_html("http://127.0.0.1:1", key))


def test_admin_dashboard_and_router_never_initialize_cuda(shared, monkeypatch):
    """The admin API, the dashboard (with a fleet panel over a router and
    a tenants panel) and the router answer every page without asking
    torch for the card: a CUDA context costs each process device memory."""
    from predictionio_tpu_torch.fleet.membership import FleetState
    from predictionio_tpu_torch.fleet.router import create_router_app
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry

    def refuse(*_a, **_k):
        raise AssertionError("CUDA initialized")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.cuda, "init", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    pt_storage, jax_storage = shared
    _insert_evaluation(jax_storage)
    fleet = FleetState(["http://127.0.0.1:1"], registry=MetricsRegistry())
    router = AppServer(create_router_app(fleet, registry=MetricsRegistry()),
                       "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{router.port}"
    try:
        for path in ("/fleet.json", "/capacity.json", "/metrics", "/alerts.json",
                     "/costs.json", "/readyz", "/efficiency.json", "/metrics.json"):
            try:
                urllib.request.urlopen(base + path, timeout=TIMEOUT).read()
            except urllib.error.HTTPError as e:
                assert e.code == 503 and path == "/readyz", path
        dash = pt_dashboard.create_dashboard_app(
            pt_storage, fleet_url=base, serving_url="http://127.0.0.1:1")
        page = dash.handle(Request("GET", "/", {}, {}))
        assert page.status == 200
        assert "<h2>Fleet</h2><p>1 replicas" in page.body
        assert "<h2>Tenants</h2><p>replica at" in page.body
        for path in ("/efficiency.json", "/metrics", "/readyz", "/engine_instances/eval1"):
            assert dash.handle(Request("GET", path, {}, {})).status == 200, path
        admin = pt_admin.create_admin_app(pt_storage)
        for path in ("/", "/cmd/app", "/metrics", "/readyz"):
            assert admin.handle(Request("GET", path, {}, {})).status == 200, path
    finally:
        router.shutdown()
