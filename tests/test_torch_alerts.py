"""The port's watch loop (``obs/alerts.py``, ``obs/incident.py``) held to
the JAX package's, on the CPU.

Every behaviour case of the JAX package's ``tests/test_alerts.py`` that
does not need the fleet runs on both packages (``pkg`` is ``jax`` or
``port``): rule semantics under an injected clock, the rule pack and the
env, the sinks, the stable soak, the incident recorder (contents,
retention, rate limit, crash safety, the burst sampler), the
fault-to-firing end to end, the HTTP and CLI ``--url`` surfaces, and the
evaluator's thread hygiene.  Then the cross-package checks, exact:

- one scripted signal sequence under one frozen clock gives the same
  transition list and the same ``/alerts.json`` alert rows in both;
- a bundle written by either package loads, lists and renders the same
  text in the other, and the JAX fixture bundle renders identically
  through both CLIs' ``incident show`` and ``export --perfetto``.

Every server binds port 0 and every client call has a timeout of 10 s.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from predictionio_tpu.obs import alerts as j_alerts
from predictionio_tpu.obs import disttrace as j_disttrace
from predictionio_tpu.obs import http as j_http
from predictionio_tpu.obs import incident as j_incident
from predictionio_tpu.obs import metrics as j_metrics
from predictionio_tpu.obs import sampling as j_sampling
from predictionio_tpu.obs import timeline as j_timeline
from predictionio_tpu.resilience import breaker as j_breaker
from predictionio_tpu.resilience import faults as j_faults
from predictionio_tpu.server import httpd as j_httpd
from predictionio_tpu.tools import cli as j_cli
from predictionio_tpu_torch.obs import alerts as p_alerts
from predictionio_tpu_torch.obs import disttrace as p_disttrace
from predictionio_tpu_torch.obs import http as p_http
from predictionio_tpu_torch.obs import incident as p_incident
from predictionio_tpu_torch.obs import metrics as p_metrics
from predictionio_tpu_torch.obs import sampling as p_sampling
from predictionio_tpu_torch.obs import timeline as p_timeline
from predictionio_tpu_torch.resilience import breaker as p_breaker
from predictionio_tpu_torch.resilience import faults as p_faults
from predictionio_tpu_torch.server import httpd as p_httpd
from predictionio_tpu_torch.tools import cli as p_cli

torch.set_num_threads(2)

TIMEOUT = 10
FIXTURE = Path(__file__).parent / "fixtures" / "incidents" / (
    "inc-fixture01-breaker-open-001.json"
)

PKGS = {
    "jax": types.SimpleNamespace(
        alerts=j_alerts, incident=j_incident, disttrace=j_disttrace,
        metrics=j_metrics, breaker=j_breaker, faults=j_faults,
        timeline=j_timeline, http=j_http, httpd=j_httpd, cli=j_cli,
        sampling=j_sampling,
    ),
    "port": types.SimpleNamespace(
        alerts=p_alerts, incident=p_incident, disttrace=p_disttrace,
        metrics=p_metrics, breaker=p_breaker, faults=p_faults,
        timeline=p_timeline, http=p_http, httpd=p_httpd, cli=p_cli,
        sampling=p_sampling,
    ),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _isolate_breakers():
    for p in PKGS.values():
        p.breaker.reset_breakers()
    yield
    for p in PKGS.values():
        p.breaker.reset_breakers()


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_eval(pkg, rules, reg=None, clock=None, **kwargs):
    return pkg.alerts.AlertEvaluator(
        registry=reg or pkg.metrics.MetricsRegistry(),
        rules=rules,
        clock=clock or Clock(),
        **kwargs,
    )


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace")


def _run_cli(pkg, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pkg.cli.main(argv)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# rule semantics, on both packages


def test_threshold_directions_and_clear_band(pkg):
    Rule = pkg.alerts.AlertRule
    above = Rule("a", "metric:m", 1.0)
    below = Rule("b", "metric:m", 1.0, direction="below")
    assert above.breached(1.5) and not above.breached(1.0)
    assert below.breached(0.5) and not below.breached(1.0)
    r = Rule("a", "metric:m", 1.0, clear_band=0.25)
    assert not r.cleared(0.9) and r.cleared(0.75)


@pytest.mark.parametrize("bad", [
    {"direction": "sideways"}, {"severity": "meh"}, {"for_s": -1},
])
def test_invalid_rules_raise(pkg, bad):
    with pytest.raises(ValueError):
        pkg.alerts.AlertRule("a", "metric:m", 1.0, **bad)


def test_gauge_rule_fires_immediately_with_zero_for_s(pkg):
    reg = pkg.metrics.MetricsRegistry()
    ev = make_eval(pkg, [pkg.alerts.AlertRule("g", "metric:pio_g", 1.0)], reg)
    g = reg.gauge("pio_g")
    g.set(0.5)
    assert ev.tick()["firing"] == 0
    g.set(2.0)
    assert ev.tick()["firing"] == 1
    snap = ev.snapshot()
    assert snap["firing"] == 1 and snap["alerts"][0]["rule"] == "g"


def test_for_s_holds_pending_until_duration(pkg):
    reg = pkg.metrics.MetricsRegistry()
    clock = Clock()
    Rule = pkg.alerts.AlertRule
    ev = make_eval(pkg, [Rule("g", "metric:pio_g", 1.0, for_s=10.0)], reg, clock)
    g = reg.gauge("pio_g")
    g.set(5.0)
    assert ev.tick()["pending"] == 1
    clock.advance(5.0)
    assert ev.tick()["pending"] == 1
    clock.advance(5.0)
    assert ev.tick()["firing"] == 1
    ev2 = make_eval(pkg, [Rule("g2", "metric:pio_g2", 1.0, for_s=10.0)], reg, clock)
    g2 = reg.gauge("pio_g2")
    g2.set(5.0)
    assert ev2.tick()["pending"] == 1
    g2.set(0.0)
    clock.advance(20.0)
    counts = ev2.tick()
    assert counts["pending"] == 0 and counts["firing"] == 0
    assert all(e["event"] != "firing" for e in ev2.recent_events())


def test_hysteresis_prevents_flapping(pkg):
    reg = pkg.metrics.MetricsRegistry()
    ev = make_eval(pkg, [pkg.alerts.AlertRule(
        "g", "metric:pio_g", 1.0, clear_band=0.5)], reg)
    g = reg.gauge("pio_g")
    g.set(1.5)
    assert ev.tick()["firing"] == 1
    g.set(0.9)
    assert ev.tick()["firing"] == 1
    g.set(0.4)
    assert ev.tick()["firing"] == 0
    assert ev.recent_events()[0]["event"] == "resolved"


def test_per_series_instances_and_label_filter(pkg):
    Rule = pkg.alerts.AlertRule
    reg = pkg.metrics.MetricsRegistry()
    ev = make_eval(pkg, [Rule("d", "metric:pio_d", 1.5)], reg)
    fam = reg.gauge("pio_d", labelnames=("distribution",))
    fam.labels("f0").set(2.0)
    fam.labels("f1").set(0.0)
    assert ev.tick()["firing"] == 1
    assert {a["key"] for a in ev.firing()} == {"distribution=f0"}
    fam.labels("f1").set(2.0)
    assert ev.tick()["firing"] == 2
    reg2 = pkg.metrics.MetricsRegistry()
    ev2 = make_eval(pkg, [Rule("d", "metric:pio_d", 1.5,
                               labels={"distribution": "f1"})], reg2)
    fam2 = reg2.gauge("pio_d", labelnames=("distribution",))
    fam2.labels("f0").set(9.0)
    fam2.labels("f1").set(0.0)
    assert ev2.tick()["firing"] == 0
    fam2.labels("f1").set(9.0)
    assert ev2.tick()["firing"] == 1


def test_rate_selectors(pkg):
    Rule = pkg.alerts.AlertRule
    reg = pkg.metrics.MetricsRegistry()
    clock = Clock()
    ev = make_eval(pkg, [Rule("c", "metric:pio_c", 1.0, rate=True)], reg, clock)
    c = reg.counter("pio_c")
    c.inc(100)
    assert ev.tick()["firing"] == 0
    clock.advance(10.0)
    c.inc(100)
    assert ev.tick()["firing"] == 1
    clock.advance(10.0)
    assert ev.tick()["firing"] == 0
    # two rate rules on one family keep separate deltas
    reg2 = pkg.metrics.MetricsRegistry()
    ev2 = make_eval(pkg, [Rule("fast", "metric:pio_c", 5.0, rate=True),
                          Rule("slow", "metric:pio_c", 1.0, rate=True)], reg2, clock)
    c2 = reg2.counter("pio_c")
    c2.inc(10)
    ev2.tick()
    clock.advance(10.0)
    c2.inc(30)
    ev2.tick()
    assert {a["rule"] for a in ev2.firing()} == {"slow"}


def test_breaker_selector_keys_by_endpoint_and_resolves_on_vanish(pkg):
    reg = pkg.metrics.MetricsRegistry()
    ev = make_eval(pkg, [pkg.alerts.AlertRule("b", "breaker.state", 1.5)], reg)
    pkg.breaker.get_breaker("dep:ok", failure_threshold=3, reset_timeout_s=999)
    bad = pkg.breaker.get_breaker("dep:bad", failure_threshold=1, reset_timeout_s=999)
    bad.record_failure()
    assert ev.tick()["firing"] == 1
    assert ev.firing()[0]["key"] == "dep:bad"
    pkg.breaker.reset_breakers()
    assert ev.tick()["firing"] == 0
    assert ev.recent_events()[0]["event"] == "resolved"


def test_slo_selector_and_transient_failure_freezes(pkg):
    reg = pkg.metrics.MetricsRegistry()
    snaps = {"body": {"error_burn_rate": 5.0, "latency_burn_rate": 0.1}}

    def snapshot():
        if snaps["body"] is None:
            raise RuntimeError("transient scrape failure")
        return snaps["body"]

    app = types.SimpleNamespace(slo=types.SimpleNamespace(snapshot=snapshot))
    ev = make_eval(pkg, [pkg.alerts.AlertRule("s", "slo.max_burn_rate", 1.0),
                         pkg.alerts.AlertRule("g", "metric:pio_g", 1.0)],
                   reg, app=app)
    reg.gauge("pio_g").set(5.0)
    assert ev.tick()["firing"] == 2
    snaps["body"] = None
    assert ev.tick()["firing"] == 2  # frozen, the metric rule still ran
    assert all(e["event"] != "resolved" for e in ev.recent_events())
    snaps["body"] = {"error_burn_rate": 5.0, "latency_burn_rate": 0.0}
    assert ev.tick()["firing"] == 2
    by_to = {lv: c.value for lv, c in reg.get(
        "pio_alerts_transitions_total").series()}
    assert by_to[("s", "firing")] == 1.0


def test_transitions_counter_firing_gauge_and_pruning(pkg):
    Rule = pkg.alerts.AlertRule
    reg = pkg.metrics.MetricsRegistry()
    clock = Clock()
    ev = make_eval(pkg, [Rule("g", "metric:pio_g", 1.0),
                         Rule("b", "breaker.state", 1.5),
                         Rule("c", "metric:pio_c", 1e9, rate=True)], reg, clock)
    g = reg.gauge("pio_g")
    g.set(2.0)
    pkg.breaker.get_breaker("dep:gone", failure_threshold=9, reset_timeout_s=1.0)
    c = reg.counter("pio_c")
    c.inc()
    ev.tick()
    g.set(0.0)
    clock.advance(5.0)
    c.inc()
    ev.tick()
    by_to = {lv[1]: child.value for lv, child in
             reg.get("pio_alerts_transitions_total").series() if lv[0] == "g"}
    assert by_to["firing"] == 1.0 and by_to["ok"] == 1.0
    assert reg.get("pio_alerts_firing").labels("g").value == 0.0
    assert ("b", "dep:gone") in ev._instances and len(ev._prev_counts) == 1
    pkg.breaker.reset_breakers()
    clock.advance(5.0)
    c.inc()
    ev.tick()
    assert ("b", "dep:gone") not in ev._instances and len(ev._prev_counts) == 1


def test_rule_pack_env_and_sinks(pkg, tmp_path):
    names = {r.name for r in pkg.alerts.default_rule_pack()}
    assert {"slo_burn", "breaker_open", "model_drift", "recompile_storm",
            "low_headroom", "factor_cache_collapse", "queue_shed",
            "cost_skew", "cost_burn", "freshness_lag"} <= names
    inline = json.dumps([{"name": "custom", "selector": "metric:pio_x",
                          "threshold": 3}])
    assert [r.name for r in pkg.alerts.rules_from_env(
        {"PIO_ALERT_RULES": inline})] == ["custom"]
    p = tmp_path / "rules.json"
    p.write_text(inline)
    assert pkg.alerts.rules_from_env({"PIO_ALERT_RULES": f"@{p}"})[0].threshold == 3
    with pytest.raises(ValueError):
        pkg.alerts.rules_from_env({"PIO_ALERT_RULES": '{"not": "a list"}'})
    env = {"PIO_ALERT_RULES": json.dumps([
        {"name": "slo_burn", "selector": "slo.max_burn_rate", "threshold": 9.0,
         "severity": "critical"},
        {"name": "extra", "selector": "metric:pio_x", "threshold": 1}])}
    by_name = {r.name: r for r in pkg.alerts.resolve_rules(env)}
    assert by_name["slo_burn"].threshold == 9.0 and "extra" in by_name
    only = pkg.alerts.resolve_rules({**env, "PIO_ALERT_DEFAULT_PACK": "0"})
    assert {r.name for r in only} == {"slo_burn", "extra"}
    # the file sink and a synthetic event
    reg = pkg.metrics.MetricsRegistry()
    sink = pkg.alerts.FileSink(str(tmp_path / "alerts.jsonl"))
    ev = make_eval(pkg, [pkg.alerts.AlertRule("g", "metric:pio_g", 1.0)], reg,
                   sinks=[sink])
    reg.gauge("pio_g").set(2.0)
    ev.tick()
    ev.note_event("autoscaler_scale_up", "grew the fleet", key="r1", size=2)
    lines = [json.loads(ln) for ln in
             (tmp_path / "alerts.jsonl").read_text().splitlines()]
    assert [e["event"] for e in lines] == ["firing", "resolved"]
    assert lines[1]["synthetic"] is True
    text = pkg.alerts.render_alerts_text(ev.snapshot())
    assert "1 firing" in text and "FIRING" in text


def test_stable_soak_zero_false_transitions(pkg):
    """120 simulated 5 s ticks over a healthy, busy registry: the full
    default pack makes no transition, and a tick stays cheap."""
    reg = pkg.metrics.MetricsRegistry()
    clock = Clock()
    app = types.SimpleNamespace(slo=types.SimpleNamespace(snapshot=lambda: {
        "error_burn_rate": 0.2, "latency_burn_rate": 0.3, "window_s": 600.0,
        "uptime_s": 600.0, "requests": 1000, "status": "ok"}))
    ev = make_eval(pkg, pkg.alerts.default_rule_pack(), reg, clock, app=app)
    shed = reg.counter("pio_shed_total", labelnames=("reason",))
    hit_rate = reg.gauge("pio_factor_cache_hit_rate")
    drift = reg.gauge("pio_drift_state", labelnames=("distribution",))
    storms = reg.counter("pio_recompile_storm_total", labelnames=("fn",))
    pkg.breaker.get_breaker("dep:healthy", failure_threshold=3, reset_timeout_s=1.0)
    storms.labels("f")
    t0 = time.perf_counter()
    for i in range(120):
        hit_rate.set(0.85 + 0.1 * (i % 2))
        drift.labels("f0").set(1 if i % 7 == 0 else 0)
        if i % 10 == 0:
            shed.labels("inflight").inc()
        clock.advance(5.0)
        counts = ev.tick()
        assert counts["firing"] == 0 and counts["pending"] == 0, (i, ev.active())
    assert (time.perf_counter() - t0) / 120 < 0.005
    fam = reg.get("pio_alerts_transitions_total")
    assert fam is None or all(c.value == 0 for _, c in fam.series())
    assert ev.snapshot()["ticks"] == 120


# ---------------------------------------------------------------------------
# the incident recorder, on both packages


def _recorder(pkg, tmp_path, **kwargs):
    reg = kwargs.pop("reg", None) or pkg.metrics.MetricsRegistry()
    store = pkg.disttrace.FragmentStore()
    rec = pkg.incident.IncidentRecorder(
        str(tmp_path / "incidents"), registry=reg, fragments=store,
        min_interval_s=kwargs.pop("min_interval_s", 0.0),
        stack_burst_s=kwargs.pop("stack_burst_s", 0.05), **kwargs,
    )
    return rec, reg, store


def test_bundle_contents_and_replayability(pkg, tmp_path):
    rec, reg, store = _recorder(pkg, tmp_path)
    reg.counter("pio_x").inc(3)
    reg.history.sample(reg)
    pkg.disttrace.record_fragment("http.predictionserver", 1000.0, 0.1,
                                  trace_id="t1", store=store)
    pkg.disttrace.record_fragment("serve.microbatch", 1000.01, 0.08,
                                  trace_id="t1", store=store)
    path = rec.record({"rule": "breaker_open", "key": "dep:x",
                       "severity": "critical", "value": 2.0, "event": "firing"})
    bundle = pkg.incident.load_bundle(path)
    assert bundle["format"] == "pio-incident-bundle/1"
    assert bundle["rule"] == "breaker_open" and len(bundle["spans"]) == 2
    assert bundle["exemplar_trace_id"] == "t1"
    assert bundle["metrics"]["pio_x"]["series"][0]["value"] == 3.0
    assert bundle["history"]["series"]["pio_x"][0]["values"] == [3.0]
    assert "capacity" in bundle and "stacks" in bundle
    assert "slo" in bundle["missing"]
    tl = pkg.timeline.assemble(pkg.timeline.load_fragment_file(path), "t1")
    assert tl.span_count == 2
    assert pkg.incident.bundle_timeline(bundle).span_count == 2
    text = pkg.incident.render_incident_text(bundle)
    assert "breaker_open" in text and "http.predictionserver" in text


def test_rate_limit_and_retention(pkg, tmp_path):
    clock = Clock()
    rec, reg, _ = _recorder(pkg, tmp_path, min_interval_s=60.0, clock=clock)
    ev = {"rule": "r1", "severity": "warning"}
    assert rec.record(ev) is not None
    assert rec.record(ev) is None
    assert rec.record({"rule": "r2"}) is not None
    clock.advance(61.0)
    assert rec.record(ev) is not None
    assert reg.get("pio_incidents_suppressed_total").labels("r1").value == 1.0
    rec2, _, _ = _recorder(pkg, tmp_path / "count", max_count=10)
    base = time.time()
    for i in range(6):
        p = rec2.record({"rule": f"r{i}"})
        os.utime(p, (base + i, base + i))
    rec2.max_count = 3
    assert rec2.prune() == 3
    assert {r["rule"] for r in rec2.list()} == {"r3", "r4", "r5"}
    rec3, _, _ = _recorder(pkg, tmp_path / "age", max_age_s=100.0)
    p1 = rec3.record({"rule": "old"})
    old = time.time() - 500
    os.utime(p1, (old, old))
    rec3.record({"rule": "new"})
    assert {r["rule"] for r in rec3.list()} == {"new"}
    snap = rec3.snapshot()
    assert snap["count"] == 1 and snap["incidents"][0]["rule"] == "new"


def test_crash_safe_write_and_prefix_lookup(pkg, tmp_path):
    rec, _, _ = _recorder(pkg, tmp_path)
    p = rec.record({"rule": "breaker_open"})

    class HostileStr:
        def __str__(self):
            raise RuntimeError("boom")

    assert rec.record({"rule": "bad", "key": HostileStr()}) is None
    names = os.listdir(rec.directory)
    assert all(".tmp" not in n for n in names)
    assert len([n for n in names if n.endswith(".json")]) == 1
    bid = pkg.incident.load_bundle(p)["id"]
    assert pkg.incident.find_bundle(rec.directory, bid) == p
    assert pkg.incident.find_bundle(rec.directory, bid[:20]) == p
    assert pkg.incident.find_bundle(rec.directory, "inc-nope") is None


def test_recording_leaves_no_continuous_sampler_running(pkg, tmp_path):
    assert not pkg.sampling.SAMPLER.running
    rec, _, _ = _recorder(pkg, tmp_path)
    path = rec.record({"rule": "r1"})
    assert not pkg.sampling.SAMPLER.running
    assert not any(t.name == "pio-stack-sampler" for t in threading.enumerate())
    bundle = pkg.incident.load_bundle(path)
    assert bundle["stacks"]["source"].startswith("burst:")


def test_evaluator_firing_triggers_recorder(pkg, tmp_path):
    rec, reg, _ = _recorder(pkg, tmp_path)
    ev = make_eval(pkg, [pkg.alerts.AlertRule("g", "metric:pio_g", 1.0)], reg,
                   incidents=rec)
    reg.gauge("pio_g").set(5.0)
    ev.tick()
    rows = rec.list()
    assert len(rows) == 1 and rows[0]["rule"] == "g"
    assert reg.get("pio_incidents_recorded_total").labels("g").value == 1.0


def test_breaker_fault_fires_bundles_and_resolves(pkg, tmp_path):
    """A frozen-clock evaluator over the breaker registry while a fault
    plan kills a breaker-guarded dependency: ``breaker_open`` fires within
    one tick, the firing writes a complete bundle whose waterfall replays
    offline, and the same rule resolves once the breaker closes."""
    rec, reg, store = _recorder(pkg, tmp_path)
    clock = Clock()
    pkg.disttrace.record_fragment("client.request", 2000.0, 0.25,
                                  trace_id="deg1", store=store)
    pkg.disttrace.record_fragment("storage.remote", 2000.01, 0.2, trace_id="deg1",
                                  error="ConnectionResetError: injected",
                                  store=store)
    rules = [r for r in pkg.alerts.default_rule_pack() if r.name == "breaker_open"]
    ev = make_eval(pkg, rules, reg, clock, incidents=rec)
    br = pkg.breaker.get_breaker("storage:fault", failure_threshold=2,
                                 reset_timeout_s=60.0)
    pkg.faults.install([{"seam": "test.dep", "kind": "connection_reset",
                         "count": 2}])
    try:
        counts = ev.tick()
        assert counts["firing"] == 0 and counts["pending"] == 0
        for _ in range(2):
            try:
                pkg.faults.ACTIVE.check("test.dep")
            except ConnectionResetError:
                br.record_failure()
        assert br.state == "open"
        clock.advance(5.0)
        assert ev.tick()["firing"] == 1
        assert ev.firing()[0]["key"] == "storage:fault"
        bundle = pkg.incident.load_bundle(rec.list()[0]["path"])
        assert bundle["breakers"]["storage:fault"]["state"] == "open"
        text = pkg.incident.bundle_timeline(bundle, trace_id="deg1").render_text()
        assert "storage.remote" in text and "injected" in text
        br.reset()
        clock.advance(5.0)
        assert ev.tick()["firing"] == 0
        assert ev.recent_events()[0]["event"] == "resolved"
        assert ev.recent_events()[0]["rule"] == "breaker_open"
    finally:
        pkg.faults.clear()


def test_cli_show_and_trace_replay_the_bundle(pkg, tmp_path):
    rec, _, store = _recorder(pkg, tmp_path)
    pkg.disttrace.record_fragment("http.pred", 3000.0, 0.1, trace_id="tcli",
                                  store=store)
    path = rec.record({"rule": "slo_burn", "severity": "critical"})
    bid = pkg.incident.load_bundle(path)["id"]
    rc, out = _run_cli(pkg, ["incident", "show", bid, "--dir", rec.directory])
    assert rc == 0 and "slo_burn" in out and "http.pred" in out
    rc, out = _run_cli(pkg, ["trace", "tcli", "--file", path, "--json"])
    assert rc == 0 and json.loads(out)["span_count"] == 1


# ---------------------------------------------------------------------------
# the HTTP surfaces and the CLI's --url paths, on both packages


def test_routes_and_cli_url_round_trip(pkg, tmp_path):
    rec, reg, store = _recorder(pkg, tmp_path)
    pkg.disttrace.record_fragment("http.x", 1000.0, 0.1, trace_id="th1",
                                  store=store)
    ev = pkg.alerts.AlertEvaluator(
        registry=reg,
        rules=[pkg.alerts.AlertRule("g", "metric:pio_g", 1.0, severity="critical")],
        incidents=rec,
    )
    app = pkg.httpd.HTTPApp("t")
    pkg.http.add_observability_routes(app, reg, alerts=ev, incidents=rec)
    reg.gauge("pio_g").set(5.0)
    ev.tick()
    server = pkg.httpd.AppServer(app, "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        status, body = _get(base + "/alerts.json")
        assert status == 200 and json.loads(body)["firing"] == 1
        listing = json.loads(_get(base + "/incidents.json")[1])
        assert listing["count"] == 1
        bid = listing["incidents"][0]["id"]
        status, body = _get(base + f"/incidents/{bid}.json")
        assert status == 200 and json.loads(body)["rule"] == "g"
        assert _get(base + "/incidents/inc-nope.json")[0] == 404
        rc, out = _run_cli(pkg, ["alerts", "--url", base])
        assert rc == 1 and "FIRING" in out and "1 firing" in out
        rc, out = _run_cli(pkg, ["incident", "list", "--url", base])
        assert rc == 0 and bid in out
        rc, out = _run_cli(pkg, ["incident", "show", bid, "--url", base])
        assert rc == 0 and "rule:      g" in out
    finally:
        server.shutdown()


def test_app_construction_spawns_no_evaluator_thread(tmp_path, monkeypatch):
    """The port's deploy builds its evaluator without a thread; the server
    starts it when it starts serving and stops it at shutdown."""
    from predictionio_tpu_torch.core.base import EngineContext, FirstServing
    from predictionio_tpu_torch.server.prediction_server import (
        DeployedEngine,
        create_prediction_server_app,
    )

    monkeypatch.setenv("PIO_INCIDENT_DIR", str(tmp_path / "inc"))

    class Algo:
        def predict(self, model, query):
            return {"ok": 1}

    def make_app():
        deployed = DeployedEngine.__new__(DeployedEngine)
        deployed._lock = threading.RLock()
        deployed.instance = types.SimpleNamespace(
            id="t", engine_variant="default", engine_factory="f", engine_id="f")
        deployed.storage = None
        deployed.ctx = EngineContext(device="cpu")
        deployed.generation_store = None
        deployed.algorithms = [Algo()]
        deployed.models = [object()]
        deployed.serving = FirstServing()
        return create_prediction_server_app(
            deployed, registry=p_metrics.MetricsRegistry())

    def evaluator_threads():
        return [t for t in threading.enumerate()
                if t.name == "pio-alert-evaluator"]

    before = len(evaluator_threads())
    apps = [make_app() for _ in range(3)]
    assert len(evaluator_threads()) == before
    assert all(a.alerts is not None and a.alerts_autostart for a in apps)
    assert all(a.incidents.directory == str(tmp_path / "inc") for a in apps)
    server = p_httpd.AppServer(apps[0], "127.0.0.1", 0).start_background()
    try:
        assert len(evaluator_threads()) == before + 1
    finally:
        server.shutdown()
    assert len(evaluator_threads()) == before


# ---------------------------------------------------------------------------
# cross-package: the same transitions, bundles both ways


def _scripted_transitions(pkg):
    """One signal script under one frozen clock: a gauge that fires and
    clears through its band, a for_s rule, a rate rule, and a breaker that
    opens then vanishes.  Returns the transition events (wall time
    dropped) and the alert rows after the busiest tick."""
    Rule = pkg.alerts.AlertRule
    reg = pkg.metrics.MetricsRegistry()
    clock = Clock()
    ev = make_eval(pkg, [
        Rule("g", "metric:pio_g", 1.0, clear_band=0.5, severity="critical"),
        Rule("p", "metric:pio_g", 3.0, for_s=10.0),
        Rule("c", "metric:pio_c", 1.0, rate=True),
        Rule("b", "breaker.state", 1.5),
    ], reg, clock)
    g = reg.gauge("pio_g")
    c = reg.counter("pio_c")
    rows = None
    for step, (gv, cinc, open_breaker) in enumerate([
        (0.5, 0, False), (4.0, 5, False), (4.0, 50, True), (0.9, 50, True),
        (4.0, 0, False), (0.2, 0, False), (0.2, 0, False),
    ]):
        g.set(gv)
        c.inc(cinc)
        if open_breaker:
            pkg.breaker.get_breaker("dep:x", failure_threshold=1,
                                    reset_timeout_s=999).record_failure()
        else:
            pkg.breaker.reset_breakers()
        clock.advance(5.0)
        ev.tick()
        if step == 2:
            rows = [{k: v for k, v in a.items() if k != "fired_at"}
                    for a in ev.active()]
    events = [{k: v for k, v in e.items() if k not in ("at", "description")}
              for e in reversed(ev.recent_events(limit=1000))]
    return events, rows


def test_same_clock_and_signals_give_the_same_transitions():
    got = {name: _scripted_transitions(p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    events = got["port"][0]
    assert [e["event"] for e in events].count("firing") >= 3
    assert {e["rule"] for e in events} == {"g", "p", "c", "b"}


def test_rule_packs_match_field_for_field():
    def pack(p):
        return [{k: v for k, v in r.to_dict().items() if k != "description"}
                for r in p.alerts.default_rule_pack()]

    assert pack(PKGS["port"]) == pack(PKGS["jax"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_bundle_reads_both_ways(writer, tmp_path):
    w = PKGS[writer]
    rec, reg, store = _recorder(w, tmp_path)
    reg.counter("pio_x").inc(2)
    w.disttrace.record_fragment("http.predictionserver", 1000.0, 0.1,
                                trace_id="tb", store=store)
    w.disttrace.record_fragment("storage.remote", 1000.02, 0.05, trace_id="tb",
                                error="ConnectionResetError: down", store=store)
    path = rec.record({"rule": "breaker_open", "key": "remote:x",
                       "severity": "critical", "value": 2.0, "event": "firing",
                       "description": "a circuit breaker is OPEN"})
    texts, listings = {}, {}
    for name, p in PKGS.items():
        bundle = p.incident.load_bundle(path)
        texts[name] = p.incident.render_incident_text(bundle)
        listings[name] = p.incident.list_incidents(rec.directory)
        tl = p.incident.bundle_timeline(bundle)
        assert tl is not None and tl.span_count == 2
    assert texts["port"] == texts["jax"]
    assert listings["port"] == listings["jax"]
    assert "storage.remote" in texts["port"]


def test_the_jax_fixture_bundle_renders_identically_through_both_clis(tmp_path):
    fdir = tmp_path / "inc"
    fdir.mkdir()
    shutil.copy(FIXTURE, fdir / FIXTURE.name)
    outs = {}
    for name, p in PKGS.items():
        show = _run_cli(p, ["incident", "show", "inc-fixture01", "--dir", str(fdir)])
        listing = _run_cli(p, ["incident", "list", "--dir", str(fdir)])
        perfetto = _run_cli(p, ["incident", "export", "inc-fixture01",
                                "--dir", str(fdir), "--perfetto", "-"])
        outs[name] = (show, listing, perfetto)
    assert outs["port"] == outs["jax"]
    (rc, text), _, (prc, body) = outs["port"]
    assert rc == 0 and "breaker" in text
    assert prc == 0 and json.loads(body)["traceEvents"]


@pytest.mark.parametrize("severity,rc", [("critical", 1), ("warning", 0)])
def test_status_url_folds_the_alerts(pkg, severity, rc, tmp_path):
    """``status --url`` of a ready server: a firing critical alert alone
    turns the exit code to 1 (a warning is printed, exit 0), in both
    packages."""
    reg = pkg.metrics.MetricsRegistry()
    ev = pkg.alerts.AlertEvaluator(
        registry=reg, rules=[pkg.alerts.AlertRule(
            "g", "metric:pio_g", 1.0, severity=severity)])
    app = pkg.httpd.HTTPApp("t")
    pkg.http.add_observability_routes(app, reg, alerts=ev)
    reg.gauge("pio_g").set(5.0)
    ev.tick()
    server = pkg.httpd.AppServer(app, "127.0.0.1", 0).start_background()
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            got, out = _run_cli(pkg, ["status", "--url",
                                      f"http://127.0.0.1:{server.port}"])
    finally:
        server.shutdown()
    assert got == rc
    assert json.loads(out)["alerts"] == {"firing": 1, "pending": 0}
    assert "WARNING: alert g firing" in err.getvalue()


# ---------------------------------------------------------------------------
# the metrics sniffer plugin on the plugin seams


@pytest.mark.parametrize("kind", ["input", "output"])
def test_metrics_sniffer_plugin_counts_the_same_in_both(kind, monkeypatch):
    from predictionio_tpu.obs import plugin as j_plugin
    from predictionio_tpu.server import plugins as j_plugins
    from predictionio_tpu_torch.obs import plugin as p_plugin
    from predictionio_tpu_torch.server import plugins as p_plugins

    got = {}
    for name, plugin_mod, plugins_mod, metrics in (
        ("jax", j_plugin, j_plugins, j_metrics),
        ("port", p_plugin, p_plugins, p_metrics),
    ):
        reg = metrics.MetricsRegistry()
        sniffer = plugin_mod.MetricsSnifferPlugin(kind=kind, registry=reg)
        ctx = plugins_mod.PluginContext()
        ctx.register(sniffer)
        for i in range(130):
            if kind == "input":
                ctx.process_input(1, None, types.SimpleNamespace(event=f"e{i % 3}"))
            else:
                assert ctx.process_output(f"inst{i % 2}", {"q": i}, {"p": i}) == {"p": i}
        ctx.drain_pending()
        rest = sniffer.handle_rest("/", {})
        monkeypatch.setenv("PIO_PLUGINS", f"{plugin_mod.__name__}:{kind}_sniffer")
        from_env = plugins_mod.PluginContext.from_env().descriptions()
        got[name] = (sniffer.plugin_type, sniffer.plugin_name, rest, from_env)
    assert got["port"] == got["jax"]
    counts = got["port"][2]["counts"]
    assert sum(counts.values()) == 130
    with pytest.raises(ValueError):
        p_plugin.MetricsSnifferPlugin(kind="sideways")
