"""The port's watch-loop verbs (``costs``, ``alerts``, ``top``,
``capacity``, ``explain``, ``profile``) held to the JAX package's, on the
CPU.

- For the same document each verb prints what the JAX package's prints:
  the same ledger served by both packages' servers gives the same ``costs
  --url`` text; the same evaluator state the same ``alerts --url`` text;
  the same ``/capacity.json``, ``/costs.json`` + ``/alerts.json`` +
  ``/metrics.json`` and explain report the same ``capacity``, ``top`` and
  ``explain`` renders.
- ``explain`` joins a live answer's provenance with its flight entry and
  logs, and renders a recorded record offline; a missing record exits 1.
- ``profile``: the server's capture (202, then its status), ``--stacks``
  and ``--speedscope`` through the continuous sampler, the host stack
  capture when the profiler answers 501, the local sampler without
  ``--url``, and a dead server exiting 1.

Every server binds port 0 and is shut down in ``finally``.
"""

from __future__ import annotations

import contextlib
import io
import json
import types

import pytest
import torch

from predictionio_tpu.obs import alerts as j_alerts
from predictionio_tpu.obs import capacity as j_capacity
from predictionio_tpu.obs import costs as j_costs
from predictionio_tpu.obs import http as j_http
from predictionio_tpu.obs import metrics as j_metrics
from predictionio_tpu.server import httpd as j_httpd
from predictionio_tpu.tools import cli as j_cli
from predictionio_tpu_torch.obs import alerts as p_alerts
from predictionio_tpu_torch.obs import capacity as p_capacity
from predictionio_tpu_torch.obs import costs as p_costs
from predictionio_tpu_torch.obs import http as p_http
from predictionio_tpu_torch.obs import metrics as p_metrics
from predictionio_tpu_torch.obs import profiler as p_profiler
from predictionio_tpu_torch.server import httpd as p_httpd
from predictionio_tpu_torch.tools import cli as p_cli

torch.set_num_threads(2)

KEY = "verb-key"

PKGS = {
    "jax": types.SimpleNamespace(alerts=j_alerts, capacity=j_capacity,
                                 costs=j_costs, http=j_http, metrics=j_metrics,
                                 httpd=j_httpd, cli=j_cli),
    "port": types.SimpleNamespace(alerts=p_alerts, capacity=p_capacity,
                                  costs=p_costs, http=p_http, metrics=p_metrics,
                                  httpd=p_httpd, cli=p_cli),
}


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _run_cli(pkg, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pkg.cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def _served(pkg, **routes):
    reg = routes.pop("registry", None) or pkg.metrics.MetricsRegistry()
    app = pkg.httpd.HTTPApp("verbs")
    pkg.http.add_observability_routes(app, reg, access_key=KEY, **routes)
    server = pkg.httpd.AppServer(app, "127.0.0.1", 0).start_background()
    try:
        yield f"http://127.0.0.1:{server.port}", app
    finally:
        server.shutdown()


def _filled_ledger(pkg):
    clock = Clock()
    led = pkg.costs.CostLedger(window_s=60.0, registry=pkg.metrics.MetricsRegistry(),
                               budgets={"one": 0.5}, default_budget=None,
                               clock=clock)
    for i in range(5):
        led.bill_meta("one", "/queries.json", "default", {
            "wave_size": 4, "device_s": 0.004 * (i + 1), "wave_flops": 1e6,
            "wave_bytes": 2e5, "wave_storage_bytes": 1536.0,
            "queue_wait_s": 0.002})
        led.bill_meta("two", "/queries.json", "canary", {
            "wave_size": 1, "device_s": 0.0005, "queue_wait_s": 0.0})
        clock.t += 20.0
    led.note_shed("two", "/queries.json")
    return led


def _filled_alerts(pkg):
    reg = pkg.metrics.MetricsRegistry()
    ev = pkg.alerts.AlertEvaluator(registry=reg, clock=Clock(), rules=[
        pkg.alerts.AlertRule("g", "metric:pio_g", 1.0, severity="critical"),
        pkg.alerts.AlertRule("h", "metric:pio_g", 3.0, for_s=30.0)])
    reg.gauge("pio_g").set(5.0)
    ev.tick()
    return reg, ev


@pytest.mark.parametrize("window", [None, 1])
def test_costs_url_prints_what_the_jax_package_prints(window):
    outs = {}
    for name, pkg in PKGS.items():
        with _served(pkg, costs=_filled_ledger(pkg)) as (url, _):
            argv = ["costs", "--url", url, "--access-key", KEY]
            if window is not None:
                argv += ["--window", str(window)]
            outs[name] = _run_cli(pkg, argv)
            rc, body, _ = _run_cli(pkg, argv + ["--json"])
            assert rc == 0 and json.loads(body)["schema"] == 1
    assert outs["port"] == outs["jax"]
    rc, text, _ = outs["port"]
    assert rc == 0 and "one" in text and "budgets (device-s/min): one=0.5" in text


def test_alerts_url_prints_what_the_jax_package_prints():
    outs = {}
    for name, pkg in PKGS.items():
        reg, ev = _filled_alerts(pkg)
        with _served(pkg, registry=reg, alerts=ev) as (url, _):
            outs[name] = _run_cli(pkg, ["alerts", "--url", url, "--access-key", KEY])
            watch = _run_cli(pkg, ["alerts", "--url", url, "--access-key", KEY,
                                   "--watch", "0.01", "--watch-count", "2"])
            assert watch[0] == 0 and watch[1].count("--- pio alerts @") == 2
    assert outs["port"] == outs["jax"]
    rc, text, _ = outs["port"]
    assert rc == 1 and "1 firing, 1 pending" in text


def test_renders_of_the_same_documents_match():
    led = _filled_ledger(PKGS["port"])
    _, ev = _filled_alerts(PKGS["port"])
    reg = p_metrics.MetricsRegistry()
    lat = reg.histogram("pio_request_latency_seconds", labelnames=("route", "status"))
    for v in (0.001, 0.002, 0.05):
        lat.labels("/queries.json", "200").observe(v)
    docs = json.loads(json.dumps((led.snapshot(), ev.snapshot(), reg.render_json())))
    assert p_cli._render_top(*docs) == j_cli._render_top(*docs)
    assert "requests: 3 total" in p_cli._render_top(*docs)
    cap = json.loads(json.dumps(p_capacity.capacity_snapshot(None, reg)))
    assert p_capacity.render_capacity_text(cap) == j_capacity.render_capacity_text(cap)
    fleet = dict(cap, fleet={"replicas": 2, "routable": 2, "active": 1,
                             "per_replica": {"r1": cap, "r2": None}})
    assert p_capacity.render_capacity_text(fleet) == j_capacity.render_capacity_text(fleet)
    report = {
        "record": {"request_id": "rid1", "server": "predictionserver",
                   "path": "/queries.json", "status": 200, "duration_s": 0.0123,
                   "capture": "cheap", "instance_id": "i1", "variant": "default",
                   "role": "live", "generation": {"checksum": "abc", "status": "live"},
                   "engine_path": "als.device_topk", "cache": {"hits": 1, "misses": 0,
                                                               "generation": "i1"},
                   "wave": {"id": "w-1", "size": 4, "seq": 1},
                   "filters": {"blacklist": 2}, "degraded": ["live_reads"],
                   "items": [{"item": f"i{k}", "score": 1.0 / (k + 1)}
                             for k in range(12)]},
        "flight": [{"route": "/queries.json", "duration_s": 0.02,
                    "stages": {"parse": 0.001, "serialize": 0.002}}],
        "logs": [{"level": "INFO", "message": "microbatch wave dispatched"}],
        "trace": {"span_count": 3},
    }
    assert p_cli._render_explain(report) == j_cli._render_explain(report)


def test_capacity_and_top_read_a_live_server():
    led = _filled_ledger(PKGS["port"])
    reg, ev = _filled_alerts(PKGS["port"])
    with _served(PKGS["port"], registry=reg, alerts=ev, costs=led) as (url, _):
        rc, out, _ = _run_cli(PKGS["port"], ["capacity", "--url", url,
                                             "--access-key", KEY])
        assert rc == 0 and "max sustainable" in out
        rc, out, _ = _run_cli(PKGS["port"], ["capacity", "--url", url,
                                             "--access-key", KEY, "--json"])
        assert rc == 0 and "headroom_frac" in json.loads(out)
        rc, out, _ = _run_cli(PKGS["port"], ["top", "--url", url,
                                             "--access-key", KEY, "--once"])
        assert rc == 0 and "alerts: 1 firing, 1 pending" in out and "one" in out
        rc, out, _ = _run_cli(PKGS["port"], ["top", "--url", url, "--access-key",
                                             KEY, "--json", "--once"])
        assert set(json.loads(out)) == {"costs", "alerts"}
    rc, _, err = _run_cli(PKGS["port"], ["top", "--url", "http://127.0.0.1:2", "--once"])
    assert rc == 1 and "scrape failed" in err


# ---------------------------------------------------------------------------
# explain


def test_explain_joins_a_live_answer_and_renders_a_record(tmp_path):
    from predictionio_tpu_torch.obs.provenance import ProvenanceStore

    store = ProvenanceStore()
    record = {"request_id": "rid-x", "server": "predictionserver",
              "path": "/queries.json", "status": 200, "duration_s": 0.004,
              "capture": "cheap", "instance_id": "inst", "variant": "default",
              "items": [{"item": "i1", "score": 0.5}]}
    store.record(dict(record))
    with _served(PKGS["port"], provenance=store) as (url, _):
        rc, out, _ = _run_cli(PKGS["port"], ["explain", "rid-x", "--url", url,
                                             "--access-key", KEY, "--json"])
        assert rc == 0
        report = json.loads(out)
        assert report["record"]["request_id"] == "rid-x"
        assert "flight" in report and "logs" in report
        rc, _, err = _run_cli(PKGS["port"], ["explain", "nope", "--url", url,
                                             "--access-key", KEY])
        assert rc == 1 and "fetch failed" in err
    path = tmp_path / "rec.json"
    path.write_text(json.dumps({"record": record}))
    outs = {name: _run_cli(p, ["explain", "rid-x", "--record", str(path)])
            for name, p in PKGS.items()}
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0 and "i1  score=0.5" in outs["port"][1]


# ---------------------------------------------------------------------------
# profile


def test_profile_capture_stacks_and_speedscope(tmp_path):
    with _served(PKGS["port"]) as (url, _):
        rc, out, err = _run_cli(PKGS["port"], [
            "profile", "--url", url, "--access-key", KEY, "--seconds", "0.2"])
        assert rc == 0, err
        assert "torch profiler capturing 0.2s (cpu)" in out
        status = json.loads(out[out.index("{"):])
        assert status["running"] is False and status["last"]["error"] is None
        assert status["last"]["trace"].endswith("trace.json")
        rc, out, _ = _run_cli(PKGS["port"], [
            "profile", "--url", url, "--access-key", KEY, "--seconds", "0.1",
            "--stacks"])
        assert rc == 0 and '"samples"' in out
        target = tmp_path / "prof.speedscope.json"
        rc, out, _ = _run_cli(PKGS["port"], [
            "profile", "--url", url, "--access-key", KEY, "--seconds", "0.1",
            "--speedscope", str(target)])
        assert rc == 0 and "speedscope" in json.loads(target.read_text())["$schema"]
    from predictionio_tpu_torch.obs.sampling import SAMPLER

    SAMPLER.stop()


def test_profile_falls_back_to_host_stacks_on_501(monkeypatch):
    def refuse(*a, **kw):
        raise p_profiler.ProfilerUnsupported("CUPTI refused the card")

    monkeypatch.setattr(p_profiler.PROFILER, "start", refuse)
    with _served(PKGS["port"]) as (url, _):
        rc, out, err = _run_cli(PKGS["port"], [
            "profile", "--url", url, "--access-key", KEY, "--seconds", "0.1"])
    from predictionio_tpu_torch.obs.sampling import SAMPLER

    SAMPLER.stop()
    assert rc == 0 and "capturing host stacks instead" in err
    assert '"samples"' in out


def test_profile_locally_and_against_a_dead_server():
    rc, out, _ = _run_cli(PKGS["port"], ["profile", "--seconds", "0.1"])
    assert rc == 0 and '"samples"' in out
    rc, _, err = _run_cli(PKGS["port"], ["profile", "--url", "http://127.0.0.1:2",
                                         "--seconds", "0.1"])
    assert rc == 1 and "profile failed" in err
    rc, _, err = _run_cli(PKGS["port"], ["profile", "--seconds", "0"])
    assert rc == 2
