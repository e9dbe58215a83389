"""The port's traffic generator and scenario format against the JAX package's.

``predictionio_tpu_torch.replay.workload`` and ``.scenario`` hold the same
contract as ``predictionio_tpu.replay``:

- **schedules**: the same scenario and seed give byte-identical schedules
  in both packages (``schedule_digest`` over ``PCG64([seed, phase])``),
  for the JAX tests' ``MINI_DAY`` and ``FULL_DAY`` and for
  ``chip_smoke.py``'s ``ml20m-full-day`` at seeds 0 and 7; ``zipf_entities``
  gives equal arrays (over 5,000,000 entities, with an offset); every case
  of the JAX ``TestSchedules`` is run on both packages;
- **scenarios**: every malformed document raises ``ScenarioError`` with
  the same field and message in both; ``pio day`` on a malformed scenario
  exits 2 with the JAX CLI's stderr;
- **loops**: ``measure_closed_loop`` and ``run_load_rounds`` measure a
  small port server alike; ``OpenLoopRunner`` of either package gives one
  outcome per scheduled id with the same statuses and captured
  ``X-Pio-*`` headers, reads to the query URL and writes to the event URL;
  the ``-m`` entry point prints one JSON line per round.

Every server binds port 0 and is shut down in ``finally``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.replay import scenario as jax_scenario
from predictionio_tpu.replay import workload as jax_workload
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.replay import scenario as pt_scenario
from predictionio_tpu_torch.replay import workload as pt_workload
from predictionio_tpu_torch.server.httpd import AppServer, HTTPApp, Response
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the JAX package's day scenarios (its tests' own dicts) and chip_smoke's
#: ML-20M-wide full day
_JAX_DAY_TESTS = _load(REPO / "tests" / "test_production_day.py", "_jax_day_tests")
_JAX_REPLAY_TESTS = _load(REPO / "tests" / "test_replay.py", "_jax_replay_tests")
_CHIP_SMOKE = _load(REPO / "chip_smoke.py", "_chip_smoke_for_tests")
MINI_DAY = _JAX_DAY_TESTS.MINI_DAY
FULL_DAY = _JAX_DAY_TESTS.FULL_DAY
ML20M_FULL_DAY = _CHIP_SMOKE.ML20M_FULL_DAY
MINI = _JAX_REPLAY_TESTS.MINI


# -- schedules ------------------------------------------------------------------


@pytest.mark.parametrize("doc", [MINI_DAY, FULL_DAY, ML20M_FULL_DAY, MINI],
                         ids=["mini-day", "full-day", "ml20m-full-day", "mini"])
@pytest.mark.parametrize("seed", [0, 7])
def test_schedule_digest_equals_jax(doc, seed):
    pt = pt_scenario.Scenario.from_dict(doc).build_schedules(seed)
    jx = jax_scenario.Scenario.from_dict(doc).build_schedules(seed)
    assert pt_workload.schedule_digest(pt) == jax_workload.schedule_digest(jx)
    for a, b in zip(pt, jx):
        assert a.name == b.name and a.index == b.index and len(a) == len(b)
        assert a.at.tobytes() == b.at.tobytes()
        assert np.array_equal(a.is_read, b.is_read)
        assert np.array_equal(a.entity, b.entity)
        assert [a.request_id(i, "day7") for i in range(len(a))] == [
            b.request_id(i, "day7") for i in range(len(b))]


def test_ml20m_full_day_is_the_full_day_widened():
    """``ml20m-full-day`` is the JAX ``FULL_DAY`` with only the population
    widened to ML-20M (the shift's offset half of it, as 6 is of 12)."""
    assert ML20M_FULL_DAY["num_entities"] == 138_493
    assert ML20M_FULL_DAY["num_items"] == 26_744
    widened = json.loads(json.dumps(FULL_DAY))
    widened.update(name="ml20m-full-day", num_entities=138_493, num_items=26_744)
    widened["phases"][2]["entity_offset"] = 69_246
    assert ML20M_FULL_DAY == widened
    schedules = pt_scenario.Scenario.from_dict(ML20M_FULL_DAY).build_schedules(7)
    assert [len(s) for s in schedules] == [48, 640, 80]


def test_schedule_same_seed_byte_identical():
    s = pt_scenario.Scenario.from_dict(MINI)
    d1 = pt_workload.schedule_digest(s.build_schedules(42))
    assert d1 == pt_workload.schedule_digest(s.build_schedules(42))
    assert d1 == jax_workload.schedule_digest(
        jax_scenario.Scenario.from_dict(MINI).build_schedules(42))


def test_schedule_different_seed_differs():
    s = pt_scenario.Scenario.from_dict(MINI)
    assert pt_workload.schedule_digest(s.build_schedules(1)) != pt_workload.schedule_digest(
        s.build_schedules(2))


def test_schedule_phase_rng_isolated():
    edited = dict(MINI, phases=[MINI["phases"][0], dict(MINI["phases"][1], qps=40)])
    a = pt_scenario.Scenario.from_dict(MINI).build_schedules(7)[0]
    b = pt_scenario.Scenario.from_dict(edited).build_schedules(7)[0]
    j = jax_scenario.Scenario.from_dict(edited).build_schedules(7)[0]
    assert np.array_equal(a.at, b.at) and np.array_equal(a.entity, b.entity)
    assert np.array_equal(b.at, j.at) and np.array_equal(b.entity, j.entity)


def test_schedule_shape():
    s = pt_scenario.Scenario.from_dict(MINI).build_schedules(0)
    j = jax_scenario.Scenario.from_dict(MINI).build_schedules(0)
    assert len(s[0]) == len(j[0]) == 20 and len(s[1]) == len(j[1]) == 60
    assert np.all(np.diff(s[1].at) >= 0)
    assert s[1].at[0] >= s[1].start_s
    assert s[1].at[-1] < s[1].start_s + s[1].duration_s
    ids = {p.request_id(i, "r") for p in s for i in range(len(p))}
    assert ids == {p.request_id(i, "r") for p in j for i in range(len(p))}
    assert len(ids) == 80


@pytest.mark.parametrize("n,population,exponent,offset,seed", [
    (20_000, 5_000_000, 1.1, 0, 0),
    (500, 1000, 1.1, 700, 3),
    (1_000, 138_493, 1.1, 69_246, 7),
    (300, 12, 1.0, 6, 1),
    (10, 1, 1.1, 4, 2),
])
def test_zipf_entities_equal_jax(n, population, exponent, offset, seed):
    got = pt_workload.zipf_entities(np.random.Generator(np.random.PCG64(seed)), n,
                                    population, exponent, offset)
    want = jax_workload.zipf_entities(np.random.Generator(np.random.PCG64(seed)), n,
                                      population, exponent, offset)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_zipf_skew_over_millions():
    e = pt_workload.zipf_entities(np.random.Generator(np.random.PCG64(0)), 20000,
                                  5_000_000, exponent=1.1)
    assert e.min() >= 0 and e.max() < 5_000_000
    counts = np.bincount(e[e < 10])
    assert counts[0] > counts[-1] * 2


def test_zipf_offset_rotates_head():
    e = pt_workload.zipf_entities(np.random.Generator(np.random.PCG64(3)), 500, 1000,
                                  offset=700)
    vals, counts = np.unique(e, return_counts=True)
    assert vals[np.argmax(counts)] == 700


# -- scenarios ------------------------------------------------------------------

MALFORMED = {
    "negative_qps": dict(MINI, phases=[{"name": "a", "duration_s": 1, "qps": -5}]),
    "unknown_action": dict(MINI, actions=[{"at_s": 0, "kind": "meteor_strike"}]),
    "overlapping_phases": dict(MINI, phases=[
        {"name": "a", "duration_s": 5, "qps": 1},
        {"name": "b", "duration_s": 5, "qps": 1, "start_s": 2.0}]),
    "empty_phases": {"name": "t", "phases": []},
    "read_frac_out_of_range": dict(
        MINI, phases=[{"name": "a", "duration_s": 1, "qps": 1, "read_frac": 1.5}]),
    "action_beyond_day_end": dict(MINI, actions=[{"at_s": 99.0, "kind": "kill_replica"}]),
    "not_an_object": [1, 2],
    "phase_not_an_object": dict(MINI, phases=[3]),
    "missing_duration": dict(MINI, phases=[{"name": "a", "qps": 1}]),
    "zero_duration": dict(MINI, phases=[{"name": "a", "duration_s": 0, "qps": 1}]),
    "boolean_qps": dict(MINI, phases=[{"name": "a", "duration_s": 1, "qps": True}]),
    "string_qps": dict(MINI, phases=[{"name": "a", "duration_s": 1, "qps": "9"}]),
    "action_not_an_object": dict(MINI, actions=["kill"]),
    "action_missing_at": dict(MINI, actions=[{"kind": "kill_replica"}]),
    "slo_not_an_object": dict(MINI, slo=[1]),
    "tenants_not_an_array": dict(MINI, tenants={"a": 1}),
    "tenant_without_name": dict(MINI, tenants=[{"quota_rps": 1}]),
    "duplicate_tenant": dict(MINI, tenants=[{"name": "a"}, {"name": "a"}]),
    "zero_quota": dict(MINI, tenants=[{"name": "a", "quota_rps": 0}]),
    "zero_weight": dict(MINI, tenants=[{"name": "a", "weight": 0}]),
    "flood_of_unknown_tenant": dict(
        MINI, tenants=[{"name": "a"}],
        actions=[{"at_s": 1.0, "kind": "quota_flood", "tenant": "b"}]),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_scenario_error_equals_jax(case):
    doc = MALFORMED[case]
    with pytest.raises(pt_scenario.ScenarioError) as got:
        pt_scenario.Scenario.from_dict(doc)
    with pytest.raises(jax_scenario.ScenarioError) as want:
        jax_scenario.Scenario.from_dict(doc)
    assert got.value.field == want.value.field
    assert str(got.value) == str(want.value)


def test_named_fields():
    """The fields the JAX ``TestScenarioValidation`` pins, on the port."""
    fields = {}
    for case in ("negative_qps", "unknown_action", "overlapping_phases", "empty_phases",
                 "read_frac_out_of_range", "action_beyond_day_end"):
        with pytest.raises(pt_scenario.ScenarioError) as ei:
            pt_scenario.Scenario.from_dict(MALFORMED[case])
        fields[case] = ei.value.field
    assert fields == {
        "negative_qps": "phases[0].qps",
        "unknown_action": "actions[0].kind",
        "overlapping_phases": "phases[1].start_s",
        "empty_phases": "phases",
        "read_frac_out_of_range": "phases[0].read_frac",
        "action_beyond_day_end": "actions[0].at_s",
    }


def test_load_arg_inline_file_and_round_trip(tmp_path):
    s = pt_scenario.Scenario.load_arg(json.dumps(MINI))
    assert s.name == "t" and s.total_duration_s == 5.0
    p = tmp_path / "sc.json"
    p.write_text(json.dumps(FULL_DAY))
    got = pt_scenario.Scenario.load_arg(f"@{p}")
    assert got.to_dict() == jax_scenario.Scenario.load_arg(f"@{p}").to_dict()
    assert pt_scenario.Scenario.from_dict(got.to_dict()).to_dict() == got.to_dict()
    assert [a.expected_rule for a in got.actions] == [
        "breaker_open", "ingest_shed", None]
    assert pt_scenario.ACTION_KINDS == jax_scenario.ACTION_KINDS
    assert pt_scenario.ACTION_EXPECTED_RULE == jax_scenario.ACTION_EXPECTED_RULE


@pytest.mark.parametrize("arg", [
    "{nope",
    json.dumps(dict(MINI, phases=[{"name": "a", "duration_s": 1, "qps": -1}])),
    json.dumps(dict(MINI, actions=[{"at_s": 0, "kind": "volcano"}])),
    "@MISSING",
], ids=["bad_json", "negative_qps", "unknown_action", "missing_file"])
def test_day_cli_malformed_exits_2_with_the_jax_stderr(arg, tmp_path, capsys):
    """Both CLIs in this process: exit 2 and the same stderr, before any
    topology (or device) is touched."""
    arg = arg.replace("MISSING", str(tmp_path / "absent.json"))
    code = pt_cli.main(["day", "--scenario", arg])
    got = capsys.readouterr().err
    jax_code = jax_cli.main(["day", "--scenario", arg])
    want = capsys.readouterr().err
    assert code == jax_code == 2
    assert got == want and "malformed scenario" in got


# -- the shared loops -------------------------------------------------------------


@pytest.fixture()
def tiny_server():
    """A minimal /queries.json and /events.json server with the serving
    headers the outcome log captures."""
    app = HTTPApp("replaytest")
    hits, writes = [], []

    @app.route("POST", "/queries\\.json")
    def q(req):
        hits.append(req.json())
        return Response(200, {"itemScores": []}, headers={
            "X-Pio-Engine-Instance": "inst-1",
            "X-Pio-Variant": "champion",
            "X-Pio-Replica": "127.0.0.1:0",
        })

    @app.route("POST", "/events\\.json")
    def ev(req):
        writes.append((req.query.get("accessKey"), req.json()))
        return Response(201, {"eventId": "e"})

    server = AppServer(app, "127.0.0.1", 0).start_background()
    try:
        yield server, hits, writes
    finally:
        server.shutdown()


def test_closed_loop_matches_async_client(tiny_server):
    server = tiny_server[0]
    seq = pt_workload.measure_closed_loop("127.0.0.1", server.port, 60, 5)
    assert len(seq) == 60 and seq == sorted(seq)
    rounds = pt_workload.run_load_rounds(server.port, 4, 15, 5, 2)
    assert len(rounds) == 2
    for r in rounds:
        assert set(r) == {"p50_ms", "p99_ms"}
    seq_p50 = seq[len(seq) // 2]
    conc_p50 = min(r["p50_ms"] for r in rounds)
    assert seq_p50 < 100 and conc_p50 < 250
    assert conc_p50 / seq_p50 < 50
    # the JAX package's loops against the same server: the same shapes
    jax_seq = jax_workload.measure_closed_loop("127.0.0.1", server.port, 60, 5)
    assert len(jax_seq) == 60 and jax_seq == sorted(jax_seq)
    assert [set(r) for r in jax_workload.run_load_rounds(server.port, 4, 15, 5, 1)] == [
        {"p50_ms", "p99_ms"}]


def _run(module, url, event_url, key, sched, **kw):
    runner = module.OpenLoopRunner(url, event_url, key, run="t", **kw)
    try:
        return runner.run_phase(sched, time.monotonic())
    finally:
        runner.close()


KEPT = ("id", "phase", "phase_index", "kind", "status", "replica", "instance",
        "variant", "error")


def test_open_loop_runner_outcomes_equal_jax(tiny_server):
    server, hits, _ = tiny_server
    url = f"http://127.0.0.1:{server.port}"
    kw = dict(name="p0", index=0, start_s=0.0, duration_s=0.5, qps=40,
              read_frac=1.0, num_entities=10, seed=3)
    got = _run(pt_workload, url, None, None, pt_workload.build_phase_schedule(**kw),
               max_inflight=8)
    port_hits = list(hits)
    hits.clear()
    want = _run(jax_workload, url, None, None, jax_workload.build_phase_schedule(**kw),
                max_inflight=8)
    assert len(got) == len(want) == 20
    assert len({o["id"] for o in got}) == 20
    assert sorted(tuple(o[k] for k in KEPT) for o in got) == sorted(
        tuple(o[k] for k in KEPT) for o in want)
    assert all(o["status"] == 200 and o["instance"] == "inst-1"
               and o["variant"] == "champion" and o["replica"] == "127.0.0.1:0"
               for o in got)
    assert set(got[0]) == set(want[0])
    key = lambda h: json.dumps(h, sort_keys=True)  # noqa: E731
    assert sorted(map(key, port_hits)) == sorted(map(key, hits))
    assert all(h["user"].startswith("u") and h["num"] == 4 for h in port_hits)


def test_writes_route_to_event_url(tiny_server):
    server, hits, writes = tiny_server
    url = f"http://127.0.0.1:{server.port}"
    kw = dict(name="w", index=0, start_s=0.0, duration_s=0.5, qps=40,
              read_frac=0.0, num_entities=6, seed=1)
    got = _run(pt_workload, url, url, "KEY", pt_workload.build_phase_schedule(**kw))
    port_writes = list(writes)
    writes.clear()
    want = _run(jax_workload, url, url, "KEY", jax_workload.build_phase_schedule(**kw))
    assert not hits
    assert all(o["kind"] == "write" and o["status"] == 201 for o in got)
    assert sorted(o["id"] for o in got) == sorted(o["id"] for o in want)
    assert len(port_writes) == 20 and all(k == "KEY" for k, _ in port_writes)
    key = lambda w: json.dumps(w, sort_keys=True)  # noqa: E731
    assert sorted(map(key, port_writes)) == sorted(map(key, writes))
    assert all(w["event"] == "rate" for _, w in port_writes)


def test_module_entry_point_prints_a_line_per_round(tiny_server):
    server = tiny_server[0]
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.replay.workload",
         str(server.port), "2", "5", "5", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert len(lines) == 2 and all(set(x) == {"p50_ms", "p99_ms"} for x in lines)
