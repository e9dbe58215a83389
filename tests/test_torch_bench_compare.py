"""``compare_bench`` and ``pio bench --compare`` held to the JAX package's,
on the CPU.

The gate reads two BENCH JSON lines and runs nothing, so every case goes
through both packages on the same inputs and must give the same exit code
and report; both CLIs must print the same report and the same stderr line
and exit the same way (0 within tolerance, 1 on a regression, 2 on a usage
error or a schema refusal).
"""

from __future__ import annotations

import io
import json
import sys

import pytest

from predictionio_tpu.obs import device as jax_device
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.obs import device as pt_device
from predictionio_tpu_torch.tools import cli as pt_cli

V = pt_device.BENCH_SCHEMA_VERSION


def _bench(v=5.0, **kw):
    d = {"schema_version": V, "value": v}
    d.update(kw)
    return d


#: (current, previous, tolerance): the JAX package's own compare-gate cases,
#: every configuration refusal, bools and zero previous values
CASES = {
    "within_tolerance": (_bench(5.2), _bench(5.0), 10.0),
    "regression": (_bench(7.0), _bench(5.0), 10.0),
    "quality_drop": (_bench(5.0, map_at_10=0.02), _bench(5.0, map_at_10=0.03), 10.0),
    "quality_rise": (_bench(5.0, map_at_10=0.04), _bench(5.0, map_at_10=0.03), 10.0),
    "missing_schema_current": ({"value": 5.0}, _bench(5.0), 10.0),
    "missing_schema_previous": (_bench(5.0), {"value": 5.0}, 10.0),
    "old_schema": ({"schema_version": 1, "value": 5.0}, _bench(5.0), 10.0),
    "previous_schema": (_bench(5.0, schema_version=V - 1), _bench(5.0), 10.0),
    "metric_mismatch": (
        _bench(5.0, metric="als_ml20m_train_time"),
        _bench(0.5, metric="als_ml20m_train_time_scale0.1"), 10.0),
    "sharded_devices_mismatch": (
        _bench(5.0, sharded_devices=8), _bench(5.0, sharded_devices=2), 10.0),
    "sharded_devices_one_side": (
        _bench(5.0, sharded_devices=8), _bench(5.0), 10.0),
    "fleet_replicas_mismatch": (
        _bench(5.0, fleet_replicas=2), _bench(5.0, fleet_replicas=8), 10.0),
    "fleet_day_scenario_mismatch": (
        _bench(5.0, fleet_day_scenario="calm"),
        _bench(5.0, fleet_day_scenario="sigkill"), 10.0),
    "events_scale_mismatch": (
        _bench(5.0, events_scale_m=100), _bench(5.0, events_scale_m=20), 10.0),
    "bools_skipped": (
        _bench(5.0, factor_cache_hit_rate=True),
        _bench(5.0, factor_cache_hit_rate=False), 10.0),
    "bool_against_number": (
        _bench(5.0, serving_p50_ms=True), _bench(5.0, serving_p50_ms=2.0), 10.0),
    "zero_previous_skipped": (
        _bench(5.0, events_compaction_backlog=7),
        _bench(5.0, events_compaction_backlog=0), 10.0),
    "non_numeric_skipped": (
        _bench(5.0, serving_p50_ms="n/a"), _bench(5.0, serving_p50_ms=2.0), 10.0),
    "ungated_keys_ignored": (
        _bench(5.0, not_a_gate_metric=99.0), _bench(5.0, not_a_gate_metric=1.0), 10.0),
    "several_metrics": (
        _bench(5.0, serving_p50_ms=3.0, map_at_10=0.5, fleet_router_p99_ms=1.0,
               events_write_mb_s=50.0),
        _bench(5.0, serving_p50_ms=2.0, map_at_10=0.4, fleet_router_p99_ms=1.05,
               events_write_mb_s=100.0), 10.0),
    "tight_tolerance": (_bench(5.2), _bench(5.0), 1.0),
    "zero_tolerance_equal": (_bench(5.0), _bench(5.0), 0.0),
    "negative_previous": (
        _bench(5.0, fleet_day_p99_ms=-1.0), _bench(5.0, fleet_day_p99_ms=-2.0), 10.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_bench_equals_the_jax_gate(case):
    current, previous, tol = CASES[case]
    got = pt_device.compare_bench(current, previous, tolerance_pct=tol)
    want = jax_device.compare_bench(current, previous, tolerance_pct=tol)
    assert got == want


def test_expected_codes():
    """The port's codes on the JAX package's own cases, as its tests state
    them."""
    code = {k: pt_device.compare_bench(*CASES[k])[0] for k in CASES}
    assert code["within_tolerance"] == 0 and code["regression"] == 1
    assert code["quality_drop"] == 1 and code["quality_rise"] == 0
    for k in ("missing_schema_current", "missing_schema_previous", "old_schema",
              "previous_schema", "metric_mismatch", "sharded_devices_mismatch",
              "fleet_replicas_mismatch", "fleet_day_scenario_mismatch",
              "events_scale_mismatch"):
        assert code[k] == 2, k
    report = pt_device.compare_bench(*CASES["regression"])[1]
    assert report["regressions"][0]["change_pct"] == pytest.approx(40.0)
    for k in ("bools_skipped", "zero_previous_skipped", "bool_against_number"):
        assert pt_device.compare_bench(*CASES[k])[1]["checked"] == 1, k


def test_gate_metrics_and_schema_equal_the_jax_package():
    assert pt_device.BENCH_SCHEMA_VERSION == jax_device.BENCH_SCHEMA_VERSION == 9
    assert list(pt_device.BENCH_GATE_METRICS.items()) == list(
        jax_device.BENCH_GATE_METRICS.items())


def _run(cli, argv, capsys, monkeypatch, stdin: str | None = None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    rc = cli.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, [x for x in cap.err.splitlines() if not x.startswith("{")]


def _both(argv, capsys, monkeypatch, stdin=None):
    got = _run(pt_cli, argv, capsys, monkeypatch, stdin)
    want = _run(jax_cli, argv, capsys, monkeypatch, stdin)
    assert got == want
    return got


def _write(path, *lines):
    path.write_text("".join(
        (x if isinstance(x, str) else json.dumps(x)) + "\n" for x in lines))
    return str(path)


@pytest.mark.parametrize("case,code", [
    ("within_tolerance", 0), ("regression", 1), ("quality_rise", 0),
    ("old_schema", 2), ("metric_mismatch", 2), ("several_metrics", 1),
])
def test_cli_files_equal_the_jax_cli(tmp_path, capsys, monkeypatch, case, code):
    current, previous, _ = CASES[case]
    prev = _write(tmp_path / "prev.json", previous)
    cur = _write(tmp_path / "cur.json", current)
    rc, out, err = _both(["bench", "--compare", prev, cur], capsys, monkeypatch)
    assert rc == code
    assert json.loads(out)["schema_version"] == V
    assert len(err) == 1, err


def test_cli_stdin_equals_the_jax_cli(tmp_path, capsys, monkeypatch):
    prev = _write(tmp_path / "prev.json", _bench(5.0))
    rc, out, _ = _both(["bench", "--compare", prev], capsys, monkeypatch,
                       stdin=json.dumps(_bench(7.0)))
    assert rc == 1 and json.loads(out)["regressions"][0]["metric"] == "value"


def test_cli_last_json_line_wins(tmp_path, capsys, monkeypatch):
    prev = _write(tmp_path / "prev.json", "bench: warming up", _bench(5.0))
    cur = _write(tmp_path / "cur.json", _bench(9.0), "not json {",
                 "[1, 2]", _bench(5.1), "done")
    rc, out, err = _both(["bench", "--compare", prev, cur], capsys, monkeypatch)
    assert rc == 0, (out, err)
    assert "bench within tolerance" in err[0]


def test_cli_tolerance_flag(tmp_path, capsys, monkeypatch):
    prev = _write(tmp_path / "prev.json", _bench(5.0))
    cur = _write(tmp_path / "cur.json", _bench(6.0))
    argv = ["bench", "--compare", prev, cur]
    assert _both(argv, capsys, monkeypatch)[0] == 1
    rc, _, err = _both(argv + ["--tolerance", "25"], capsys, monkeypatch)
    assert rc == 0 and "1 metrics checked" in err[0]


@pytest.mark.parametrize("what", ["missing_previous", "missing_current",
                                  "no_json", "empty_stdin"])
def test_cli_usage_errors_exit_two(tmp_path, capsys, monkeypatch, what):
    prev = _write(tmp_path / "prev.json", _bench(5.0))
    stdin = None
    if what == "missing_previous":
        argv = ["bench", "--compare", str(tmp_path / "absent.json")]
    elif what == "missing_current":
        argv = ["bench", "--compare", prev, str(tmp_path / "absent.json")]
    elif what == "no_json":
        argv = ["bench", "--compare", prev, _write(tmp_path / "c.json", "no json")]
    else:
        argv, stdin = ["bench", "--compare", prev], ""
    rc, out, err = _both(argv, capsys, monkeypatch, stdin)
    assert rc == 2 and out == "" and err[0].startswith("usage error:"), err


def test_bench_needs_compare_and_takes_no_device(capsys):
    for argv in (["bench"], ["bench", "--compare", "p.json", "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            pt_cli.main(argv)
        assert e.value.code == 2
