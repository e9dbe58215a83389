"""The production day end to end on the port: ``pio day`` over real
``deploy --device cpu`` replica subprocesses.

- The mini day (the JAX tests' ``MINI_DAY``: ramp traffic, a mid-peak
  replica SIGKILL, a canary generation flip) through the port's CLI with
  ``--device cpu --replicas 2 --seed 7``, over a home seeded by the port's
  ``seed_demo_home(device="cpu")``: exit 0, the five clauses passed, 336
  of 336 answered, one ``breaker_open`` bundle on disk, three telemetry
  p99s under their bounds, ``VERDICT: PASS``; its outcome ids are the JAX
  schedule's ids, and its evidence gives the JAX ``evaluate_day`` the same
  verdict.
- The fixture seeder writes the JAX ``seed_demo_home``'s events and
  vocabularies (factors differ by design: a ``torch.Generator`` start).
- The device rule: without ``--device`` on a host without a card, ``pio
  day`` raises ``DeviceUnavailable`` before any replica spawns, and leaves
  no replica process or pidfile.
- ``FULL_DAY`` (storage stall, shift of the hot head) and the
  ``--no-incidents`` falsification run are ``slow``, as in the JAX tests.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from predictionio_tpu.obs import verdict as jax_verdict
from predictionio_tpu.replay import day as jax_day
from predictionio_tpu.replay import scenario as jax_scenario
from predictionio_tpu.replay import workload as jax_workload
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.fleet import autoscaler as pt_autoscaler
from predictionio_tpu_torch.obs import verdict as pt_verdict
from predictionio_tpu_torch.replay import day as pt_day
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "_jax_day_tests_pd", REPO / "tests" / "test_production_day.py")
_JAX_DAY_TESTS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_JAX_DAY_TESTS)
MINI_DAY, FULL_DAY = _JAX_DAY_TESTS.MINI_DAY, _JAX_DAY_TESTS.FULL_DAY
CLAUSES = ("phase_p99_bounded", "exactly_once", "flip_coherence",
           "autoscaler_converged", "fault_reconciliation")


@pytest.fixture(scope="module")
def day_home(tmp_path_factory):
    """One home seeded and trained on the CPU by the port, shared by the
    day runs of this module (they append events and flip clones)."""
    home = tmp_path_factory.mktemp("torch_day_home")
    pt_day.seed_demo_home(home, device="cpu")
    return home


def run_day_cli(home, scenario, tmp_path, *extra, timeout=420):
    scenario_path = tmp_path / "scenario.json"
    scenario_path.write_text(json.dumps(scenario))
    report_path = tmp_path / "report.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PIO_HOME=str(home))
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "day",
         "--scenario", f"@{scenario_path}", "--replicas", "2", "--seed", "7",
         "--report", str(report_path), "--incident-dir", str(tmp_path / "incidents"),
         "--device", "cpu", *extra],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    report = json.loads(report_path.read_text()) if report_path.exists() else None
    return proc, report


def clause(report, name):
    return next(c for c in report["verdict"]["clauses"] if c["clause"] == name)


def _jax_ids(scenario, seed=7) -> list[str]:
    schedules = jax_scenario.Scenario.from_dict(scenario).build_schedules(seed)
    return sorted(s.request_id(i, f"day{seed}") for s in schedules for i in range(len(s)))


def _held_to_jax(report) -> None:
    """The port's evidence judged by both engines: the same verdict, and the
    clause outcomes of the report's own."""
    evidence = report["evidence"]
    got = pt_verdict.evaluate_day(evidence)
    want = jax_verdict.evaluate_day(evidence)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert {c["clause"]: c["passed"] for c in want["clauses"]} == {
        c["clause"]: c["passed"] for c in report["verdict"]["clauses"]}


def test_mini_day_passes_every_clause(day_home, tmp_path):
    proc, report = run_day_cli(day_home, MINI_DAY, tmp_path)
    assert report is not None, proc.stderr[-2000:]
    verdict = report["verdict"]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert verdict["pass"] is True
    assert report["seed"] == 7 and report["replicas"] == 2
    assert report["device"] == "cpu"
    assert {c["clause"]: c["passed"] for c in verdict["clauses"]} == {
        c: True for c in CLAUSES}
    assert verdict["requests"]["scheduled"] == verdict["requests"]["answered"] == 336

    recon = clause(report, "fault_reconciliation")
    bundles = recon["evidence"]["bundles"]
    assert list(bundles) == ["breaker_open"]
    assert len(bundles["breaker_open"]) == 1
    assert os.path.exists(bundles["breaker_open"][0])
    with open(bundles["breaker_open"][0]) as f:
        assert json.load(f)["rule"] == "breaker_open"

    rows = verdict["phases"]
    assert [r["name"] for r in rows] == ["warm", "peak", "cool"]
    assert all(r["telemetry_p99_ms"] is not None for r in rows)
    assert all(r["telemetry_p99_ms"] <= r["p99_bound_ms"] for r in rows)
    assert "VERDICT: PASS" in proc.stdout
    assert "[PASS] fault_reconciliation" in proc.stdout

    # the port's outcomes carry the JAX schedule's ids, one each
    outcomes = report["evidence"]["outcomes"]
    assert sorted(o["id"] for o in outcomes) == _jax_ids(MINI_DAY)
    assert report["schedule_digest"] == jax_workload.schedule_digest(
        jax_scenario.Scenario.from_dict(MINI_DAY).build_schedules(7))
    ready = report["replica_ready_s"]
    assert len(ready) == 2 and all(s > 0 for s in ready.values())
    assert report["evidence"]["injected"][0]["victim"] in ready
    assert [a["kind"] for a in report["actions_run"]] == ["kill_replica", "canary_flip"]
    _held_to_jax(report)


def test_seeder_writes_the_jax_events_and_vocabularies(tmp_path):
    homes = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    pt_iid = pt_day.seed_demo_home(homes["port"], device="cpu")
    jax_iid = jax_day.seed_demo_home(homes["jax"])
    stores = {k: StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(h)}))
              for k, h in homes.items()}
    try:
        def canonical(storage):
            (app,) = storage.apps().get_all()
            rows = sorted(
                json.dumps([e.event, e.entity_type, e.entity_id, e.target_entity_type,
                            e.target_entity_id, e.properties.fields], sort_keys=True)
                for e in storage.l_events().find(app.id))
            return app.name, rows

        port_app, port_rows = canonical(stores["port"])
        jax_app, jax_rows = canonical(stores["jax"])
        assert port_app == jax_app == "fleet"
        assert port_rows == jax_rows and len(port_rows) > 0
        (pt_blob,) = load_models(stores["port"].models(), pt_iid)
        (jax_blob,) = load_models(stores["jax"].models(), jax_iid)
        for key in ("user_vocab", "item_vocab"):
            assert sorted(pt_blob[key]) == sorted(jax_blob[key]), key
        for k in ("port", "jax"):
            (inst,) = stores[k].engine_instances().get_all()
            assert inst.status == "COMPLETED"
            assert inst.engine_factory == "recommendation"
        assert pt_blob["user_factors"].shape == jax_blob["user_factors"].shape
    finally:
        for s in stores.values():
            s.close()


def test_day_without_a_card_raises_before_any_replica_spawns(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "home"))
    spawned = []
    monkeypatch.setattr(pt_autoscaler.LocalProcessSpawner, "spawn",
                        lambda self: spawned.append(self) or "http://127.0.0.1:1")
    argv = ["day", "--scenario", json.dumps(MINI_DAY), "--replicas", "2"]
    assert pt_cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_cli.main(argv)
    assert spawned == []
    pids = tmp_path / "home" / "pids"
    assert not pids.exists() or not list(pids.glob("replica-*.pid"))
    # the fixture seeder asks for the card the same way, and writes nothing
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_day.seed_demo_home(tmp_path / "seeded")
    assert not (tmp_path / "seeded").exists()


def test_malformed_scenario_exits_2_before_the_device(monkeypatch, capsys):
    """A malformed scenario exits 2 on any host: it is read before the
    device is resolved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bad = dict(MINI_DAY, phases=[{"name": "a", "duration_s": 1, "qps": -1}])
    assert pt_cli.main(["day", "--scenario", json.dumps(bad)]) == 2
    assert "phases[0].qps" in capsys.readouterr().err


@pytest.mark.slow
def test_full_day_with_storage_stall(day_home, tmp_path):
    proc, report = run_day_cli(day_home, FULL_DAY, tmp_path, timeout=540)
    assert report is not None, proc.stderr[-2000:]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    verdict = report["verdict"]
    assert verdict["pass"] is True
    recon = clause(report, "fault_reconciliation")
    assert recon["passed"]
    bundles = recon["evidence"]["bundles"]
    assert sorted(bundles) == ["breaker_open", "ingest_shed"]
    assert all(len(v) == 1 for v in bundles.values())
    rows = {r["name"]: r for r in verdict["phases"]}
    assert rows["peak"]["shed"] > 0
    assert clause(report, "exactly_once")["passed"]
    assert verdict["requests"]["scheduled"] == verdict["requests"]["answered"] == 768
    assert sorted(o["id"] for o in report["evidence"]["outcomes"]) == _jax_ids(FULL_DAY)
    _held_to_jax(report)


@pytest.mark.slow
def test_disabled_recorder_fails_naming_missing_evidence(day_home, tmp_path):
    proc, report = run_day_cli(day_home, MINI_DAY, tmp_path, "--no-incidents")
    assert report is not None, proc.stderr[-2000:]
    assert proc.returncode == 1
    verdict = report["verdict"]
    assert verdict["pass"] is False
    recon = clause(report, "fault_reconciliation")
    assert not recon["passed"]
    assert recon["evidence"]["missing"] == {"breaker_open": 1}
    assert [c["clause"] for c in verdict["clauses"] if not c["passed"]] == [
        "fault_reconciliation"]
    assert "VERDICT: FAIL" in proc.stdout and "breaker_open" in proc.stdout
    _held_to_jax(report)
