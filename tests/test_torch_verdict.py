"""The port's verdict engine against the JAX package's.

``predictionio_tpu_torch.obs.verdict`` judges a scripted day from the same
evidence as ``predictionio_tpu.obs.verdict``: for every evidence pack of
the JAX ``TestVerdict`` (missing, duplicate, spurious and stale bundles,
duplicate and missing outcomes, a write shed inside and outside a stall
window, a stale generation after the flip, an unknown instance, missing
or out-of-tolerance autoscaler evidence, p99 from the outcome log and
from bucket deltas) and for the ``tenant_isolation`` rows of the JAX
tenancy tests, ``evaluate_day`` gives a JSON-equal dict in both packages
and ``render_verdict`` the same text.  The falsification of the mini day
runs here at verdict level: with no bundle on disk the only failing clause
is ``fault_reconciliation``, missing one ``breaker_open``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from predictionio_tpu.obs import verdict as jax_verdict
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu_torch.obs import verdict as pt_verdict
from predictionio_tpu_torch.obs.metrics import MetricsRegistry

REPO = Path(__file__).resolve().parent.parent


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the JAX tests' all-green evidence pack and bundle writer
_JAX_REPLAY_TESTS = _load(REPO / "tests" / "test_replay.py", "_jax_replay_tests_v")
_evidence = _JAX_REPLAY_TESTS._evidence
_write_bundle = _JAX_REPLAY_TESTS._write_bundle
MINI_DAY = _load(REPO / "tests" / "test_production_day.py",
                 "_jax_day_tests_v").MINI_DAY

KILL = [{"kind": "kill_replica", "at_s": 1.0, "rule": "breaker_open"}]


def _same(ev) -> dict:
    """Both engines on one evidence pack: JSON-equal dicts, equal text."""
    got = pt_verdict.evaluate_day(json.loads(json.dumps(ev)))
    want = jax_verdict.evaluate_day(json.loads(json.dumps(ev)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert pt_verdict.render_verdict(got) == jax_verdict.render_verdict(want)
    return got


def _clause(v, name):
    return next(c for c in v["clauses"] if c["clause"] == name)


def _histogram_snapshots(registry_cls):
    reg = registry_cls()
    h = reg.histogram("pio_router_forward_seconds", "t", labelnames=("replica",))
    for _ in range(50):
        h.labels("r1").observe(0.002)
    snap0 = reg.render_json()
    for _ in range(50):
        h.labels("r1").observe(0.002)
    for _ in range(3):
        h.labels("r2").observe(0.9)
    c = reg.counter("pio_shed_total", "t", labelnames=("reason",))
    c.labels("eventstore").inc(7)
    f = reg.counter("pio_router_forwards_total", "t", labelnames=("replica",))
    f.labels("r1").inc(100)
    r = reg.counter("pio_router_retry_elsewhere_total", "t", labelnames=("reason",))
    r.labels("transport_error").inc(4)
    return [snap0, reg.render_json()]


def _case(name, tmp_path):
    """The evidence pack of one JAX ``TestVerdict`` case (bundles written
    into ``tmp_path`` as that case writes them)."""
    if name == "all_green":
        return _evidence(tmp_path)
    if name == "missing_bundle":
        return _evidence(tmp_path, injected=KILL)
    if name == "exact_reconciliation":
        _write_bundle(tmp_path, "breaker_open")
        return _evidence(tmp_path, injected=KILL)
    if name == "duplicate_bundle":
        _write_bundle(tmp_path, "breaker_open", name="b1")
        _write_bundle(tmp_path, "breaker_open", name="b2")
        return _evidence(tmp_path, injected=KILL)
    if name == "spurious_bundle":
        _write_bundle(tmp_path, "slo_burn")
        return _evidence(tmp_path)
    if name == "stale_bundle":
        _write_bundle(tmp_path, "breaker_open", now=50.0)
        return _evidence(tmp_path, incidents_after=60.0)
    if name == "duplicate_request_id":
        ev = _evidence(tmp_path)
        ev["outcomes"].append(dict(ev["outcomes"][0]))
        return ev
    if name == "missing_outcome":
        ev = _evidence(tmp_path)
        ev["outcomes"].pop()
        return ev
    if name in ("write_shed_in_stall", "write_shed_outside_stall"):
        shed = {"id": "r-p0-w", "phase": "p0", "phase_index": 0, "kind": "write",
                "start_s": 0.5, "latency_ms": 1.0, "status": 503, "replica": None,
                "instance": None, "variant": None, "error": None}
        windows = [[0.0, 1.0]] if name == "write_shed_in_stall" else []
        ev = _evidence(tmp_path, stall_windows=windows)
        ev["outcomes"].append(shed)
        ev["phases"][0]["scheduled"] = 11
        return ev
    if name == "stale_generation_after_flip":
        ev = _evidence(tmp_path)
        ev["instances"] = {"known": ["inst-old", "inst-new"], "new": "inst-new",
                           "flip_completed_s": 0.45}
        return ev
    if name == "unknown_instance":
        ev = _evidence(tmp_path)
        ev["outcomes"][3]["instance"] = "who-dis"
        return ev
    if name == "autoscaler_evidence_missing":
        return _evidence(tmp_path, autoscaler={"desired": None, "actual": 2,
                                               "tolerance": 1})
    if name == "autoscaler_out_of_tolerance":
        return _evidence(tmp_path, autoscaler={"desired": 1, "actual": 3,
                                               "tolerance": 1})
    if name == "autoscaler_within_tolerance":
        return _evidence(tmp_path, autoscaler={"desired": 1, "actual": 3,
                                               "tolerance": 2})
    if name == "p99_from_outcome_log":
        ev = _evidence(tmp_path)
        ev["phases"][0]["p99_ms"] = 1.0
        return ev
    if name == "p99_from_bucket_deltas":
        ev = _evidence(tmp_path, snapshots=_histogram_snapshots(JaxRegistry),
                       costs=[0.0, 0.25])
        ev["phases"][0]["p99_ms"] = 50.0
        return ev
    if name == "variantless_answer":
        ev = _evidence(tmp_path)
        ev["outcomes"][2]["variant"] = None
        return ev
    if name == "unanswered_and_failed_read":
        ev = _evidence(tmp_path)
        ev["outcomes"][1]["status"] = None
        ev["outcomes"][1]["error"] = "ConnectionRefusedError: refused"
        ev["outcomes"][4]["status"] = 503
        return ev
    raise KeyError(name)


CASES = [
    "all_green", "missing_bundle", "exact_reconciliation", "duplicate_bundle",
    "spurious_bundle", "stale_bundle", "duplicate_request_id", "missing_outcome",
    "write_shed_in_stall", "write_shed_outside_stall", "stale_generation_after_flip",
    "unknown_instance", "autoscaler_evidence_missing", "autoscaler_out_of_tolerance",
    "autoscaler_within_tolerance", "p99_from_outcome_log", "p99_from_bucket_deltas",
    "variantless_answer", "unanswered_and_failed_read",
]

#: (passed overall, the failing clauses) per case, as the JAX tests pin them
EXPECTED_FAILS = {
    "all_green": [],
    "missing_bundle": ["fault_reconciliation"],
    "exact_reconciliation": [],
    "duplicate_bundle": ["fault_reconciliation"],
    "spurious_bundle": ["fault_reconciliation"],
    "stale_bundle": [],
    "duplicate_request_id": ["exactly_once"],
    "missing_outcome": ["exactly_once"],
    "write_shed_in_stall": [],
    "write_shed_outside_stall": ["exactly_once"],
    "stale_generation_after_flip": ["flip_coherence"],
    "unknown_instance": ["flip_coherence"],
    "autoscaler_evidence_missing": ["autoscaler_converged"],
    "autoscaler_out_of_tolerance": ["autoscaler_converged"],
    "autoscaler_within_tolerance": [],
    "p99_from_outcome_log": ["phase_p99_bounded"],
    "p99_from_bucket_deltas": ["phase_p99_bounded"],
    "variantless_answer": ["flip_coherence"],
    "unanswered_and_failed_read": ["exactly_once"],
}


@pytest.mark.parametrize("name", CASES)
def test_verdict_equals_jax(name, tmp_path):
    v = _same(_case(name, tmp_path))
    failed = [c["clause"] for c in v["clauses"] if not c["passed"]]
    assert failed == EXPECTED_FAILS[name]
    assert v["pass"] is (not failed)


def test_case_evidence_as_the_jax_tests_pin_it(tmp_path):
    """The details the JAX ``TestVerdict`` asserts, on the port's dicts."""
    for sub in "abcdefghijklm":
        (tmp_path / sub).mkdir()
    c = _clause(_same(_case("missing_bundle", tmp_path / "a")), "fault_reconciliation")
    assert c["evidence"]["missing"] == {"breaker_open": 1}
    c = _clause(_same(_case("exact_reconciliation", tmp_path / "b")),
                "fault_reconciliation")
    assert c["evidence"]["bundles"]["breaker_open"][0].endswith(".json")
    c = _clause(_same(_case("duplicate_bundle", tmp_path / "c")), "fault_reconciliation")
    assert "breaker_open" in c["evidence"]["duplicate"]
    c = _clause(_same(_case("spurious_bundle", tmp_path / "d")), "fault_reconciliation")
    assert "slo_burn" in c["evidence"]["spurious"]
    c = _clause(_same(_case("duplicate_request_id", tmp_path / "e")), "exactly_once")
    assert "r-p0-0" in c["evidence"]["duplicate_ids"]
    c = _clause(_same(_case("missing_outcome", tmp_path / "f")), "exactly_once")
    assert c["evidence"]["missing_outcomes"] == 1
    c = _clause(_same(_case("write_shed_outside_stall", tmp_path / "g")), "exactly_once")
    assert "r-p0-w" in c["evidence"]["write_failures"]
    c = _clause(_same(_case("stale_generation_after_flip", tmp_path / "h")),
                "flip_coherence")
    assert c["evidence"]["exemplar_stale_after_flip"]
    c = _clause(_same(_case("unknown_instance", tmp_path / "i")), "flip_coherence")
    assert "r-p0-3" in c["evidence"]["exemplar_incoherent"]
    c = _clause(_same(_case("autoscaler_evidence_missing", tmp_path / "j")),
                "autoscaler_converged")
    assert "missing" in c["detail"]
    c = _clause(_same(_case("p99_from_outcome_log", tmp_path / "k")), "phase_p99_bounded")
    assert c["evidence"]["violations"][0]["source"].startswith("outcome log")
    v = _same(_case("p99_from_bucket_deltas", tmp_path / "l"))
    viol = _clause(v, "phase_p99_bounded")["evidence"]["violations"][0]
    assert viol["source"].startswith("metric:pio_router_forward_seconds")
    assert viol["p99_ms"] > 100.0
    row = v["phases"][0]
    assert row["telemetry_requests"] == 53 and row["shed"] == 7.0
    assert row["retry_elsewhere_rate"] == 0.04 and row["device_s"] == 0.25
    text = pt_verdict.render_verdict(_same(_case("missing_bundle", tmp_path / "m")))
    assert "VERDICT: FAIL" in text and "[FAIL] fault_reconciliation" in text
    assert "breaker_open" in text and "p99ms" in text


def test_port_snapshots_cut_the_same_quantiles(tmp_path):
    """The port's own registry snapshots (the router's registry in a port
    day) give the verdict the JAX registry's snapshots give."""
    pt = _evidence(tmp_path, snapshots=_histogram_snapshots(MetricsRegistry),
                   costs=[0.0, 0.25])
    jx = _evidence(tmp_path, snapshots=_histogram_snapshots(JaxRegistry),
                   costs=[0.0, 0.25])
    for ev in (pt, jx):
        ev["phases"][0]["p99_ms"] = 50.0
    assert pt["snapshots"] == jx["snapshots"]
    got = pt_verdict.evaluate_day(pt)
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jax_verdict.evaluate_day(jx), sort_keys=True)
    assert pt_verdict.LATENCY_FAMILY == jax_verdict.LATENCY_FAMILY


def _row(app, **kw):
    row = {"app": app, "quota_shed": 0, "leaked": 0, "availability": 1.0,
           "p99_ms": 5.0, "p99_bound_ms": None}
    row.update(kw)
    return row


@pytest.mark.parametrize("rows,flooded,floor,passed", [
    ([_row("alpha"), _row("beta", quota_shed=40)], ["beta"], 0.99, True),
    ([_row("alpha", leaked=1), _row("beta", quota_shed=40)], ["beta"], 0.99, False),
    ([_row("alpha"), _row("beta")], ["beta"], 0.99, False),
    ([_row("alpha", availability=0.5), _row("beta", quota_shed=40)], ["beta"], 0.99,
     False),
    ([_row("alpha", availability=0.95), _row("beta", quota_shed=4)], ["beta"], 0.9,
     True),
    ([_row("alpha", p99_ms=120.0, p99_bound_ms=50.0), _row("beta", quota_shed=40)],
     ["beta"], 0.99, False),
    ([_row("alpha", availability=None), _row("beta", quota_shed=1)], ["beta"], 0.99,
     False),
], ids=["contained", "leak", "quota_never_engaged", "starved", "lower_floor",
        "neighbor_p99", "no_availability"])
def test_tenant_isolation_equals_jax(rows, flooded, floor, passed):
    v = _same({"phases": [], "outcomes": [],
               "tenants": {"rows": rows, "flooded": flooded,
                           "availability_floor": floor}})
    assert _clause(v, "tenant_isolation")["passed"] is passed


def test_single_tenant_days_have_no_tenant_clause():
    v = _same({"phases": [], "outcomes": []})
    assert all(c["clause"] != "tenant_isolation" for c in v["clauses"])


def test_no_bundles_fails_reconciliation_only(tmp_path):
    """The falsification of the mini day at verdict level (its end-to-end
    ``--no-incidents`` run is ``slow``): every request answered through
    the SIGKILL and the flip, but no bundle on disk.  The verdict fails on
    ``fault_reconciliation`` alone, naming one missing ``breaker_open``."""
    outcomes, phases = [], []
    for i, p in enumerate(MINI_DAY["phases"]):
        n = int(round(p["qps"] * p["duration_s"]))
        phases.append({"name": p["name"], "index": i, "start_s": 6.0 * i,
                       "duration_s": p["duration_s"], "qps": p["qps"],
                       "read_frac": p["read_frac"], "p99_ms": p["p99_ms"],
                       "scheduled": n})
        outcomes += [{"id": f"day7-p{i}-{j}", "phase": p["name"], "phase_index": i,
                      "kind": "read", "start_s": 6.0 * i + j / p["qps"],
                      "latency_ms": 3.0, "status": 200, "replica": "r",
                      "instance": "old" if i < 2 else "new", "variant": "default",
                      "error": None} for j in range(n)]
    ev = {"scenario": "mini-day", "seed": 7, "phases": phases, "outcomes": outcomes,
          "injected": [{"kind": "kill_replica", "at_s": 9.0, "rule": "breaker_open"}],
          "incident_dir": str(tmp_path / "never-written"), "incidents_after": 0.0,
          "autoscaler": {"desired": 1, "actual": 1, "tolerance": 2},
          "instances": {"known": ["old", "new"], "new": "new",
                        "flip_completed_s": 18.0}}
    v = _same(ev)
    assert v["pass"] is False
    assert [c["clause"] for c in v["clauses"] if not c["passed"]] == [
        "fault_reconciliation"]
    recon = _clause(v, "fault_reconciliation")
    assert recon["evidence"]["missing"] == {"breaker_open": 1}
    assert v["requests"] == {"scheduled": 336, "answered": 336}
    text = pt_verdict.render_verdict(v)
    assert "VERDICT: FAIL" in text and "breaker_open" in text
