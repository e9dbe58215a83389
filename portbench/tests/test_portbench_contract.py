"""The benchmark's files against its contract: every cell, configuration,
traffic mix and metric found by name; names and units in their alphabets;
the frozen counts against hand counts; a new cell from new files alone; no
JAX and no JAX package loaded by a run."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import pytest
from conftest import CHECKOUT, TINY, TINY_NCF

from portbench import harness, work

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.load_cell(CHECKOUT / "BENCHMARK.json", workload)
    drv = harness.driver(cell)
    for fn in ("setup", "window", "check", "controls"):
        assert callable(getattr(drv, fn))
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert "setup_s" in names and len(cell.end_to_end) >= 2 and cell.per_layer
    for name in names:
        assert callable(harness.load_module(
            harness.ROOT / "metrics" / f"{name}.py").read)


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_name_unit_and_cells(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    else:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_names_units_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (CHECKOUT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (harness.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    names = [m["name"] for m in ALL_METRICS]
    assert len(names) == len(set(names))


def test_least_work_matches_hand_counts():
    # a wave of 2 users over 3 items, table 8 (d 4), one layer 8 -> 2, k 1:
    # per pair 4 (gmf) + 2*8*2 + 2*2 (layer) + 2*(4+2) + 1 (output) + 1
    pair = 4 + 32 + 4 + 12 + 1 + 1
    assert work.ncf_pair_flops(8, [(8, 2)], True) == pair
    wave = work.ncf_wave_least_work(2, 3, 8, [(8, 2)], 1, True)
    assert wave["flops"] == 2 * 3 * pair
    weights = 1 + (8 * 2 + 2) + (4 + 2)
    assert wave["bytes"] == 4 * (2 * 8 + 3 * 8 + weights + 3 + 2 * 2 * 1)
    assert work.ncf_train_step_flops(5, 4, 8, [(8, 2)], True) == 3 * 25 * pair
    # ALS at rank 2 over 7 ratings, 3 segments against 4 opposite rows
    als = work.als_accum_least_work(7, 2, 3, 4)
    assert als["flops"] == 7 * (3 * 4 + 2 * 2 + 1)
    assert als["bytes"] == 4 * (3 * 7 + 4 * 2 + 3 * (4 + 2 + 1))
    assert work.als_iteration_flops(7, 2, 3, 4) == 2 * 7 * 17 + 7 * 8 / 3
    assert work.least_seconds({"bytes": 3.35e12, "flops": 0.0},
                              "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)
    assert work.least_seconds({"bytes": 1, "flops": 1}, "cpu") is None


def test_new_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries run without an edit to any file there."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg = json.loads((harness.ROOT / "configs" / "ncf-dle-ml20m.json").read_text())
    cfg.update(TINY, **TINY_NCF, name="ncf-tiny")
    (root / "portbench" / "configs" / "ncf-tiny.json").write_text(json.dumps(cfg))
    (root / "portbench" / "traffic" / "few_users.json").write_text(json.dumps({
        "driver": "ncf_batch", "queries_per_file": 40, "num": 5,
        "sampled_per_file": 3}))
    (root / "portbench" / "metrics" / "waves_per_s.py").write_text(
        "def read(run):\n    return run.stats['waves'] / run.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "ncf-tiny", "source": "https://example.org",
                             "file": "portbench/configs/ncf-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ncf-tiny.few", "config": "ncf-tiny",
                               "traffic": "few_users", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "batch_queries_per_s":
            m["workloads"].append("ncf-tiny.few")
    bench["per_layer"].append({"name": "waves_per_s", "unit": "1/s",
                               "better": "higher", "source": "program_span",
                               "layer": "test", "moves": "batch_queries_per_s",
                               "workloads": ["ncf-tiny.few"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(root / "BENCHMARK.json", "ncf-tiny.few",
                             root / "portbench")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "batch_queries_per_s"]
    out = harness.run_cell(cell, 3, 0.2, True, "cpu", time.perf_counter(),
                           root / "portbench")
    assert out["correct"] and out["metrics"]["waves_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_run_loads_no_jax_and_reference_no_program():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from conftest import tiny_cell, run_tiny\n"
        "from portbench import harness\n"
        "for w in ('als-ml20m.train', 'ncf-dle-ml20m.train', 'ncf-dle-ml20m.batch'):\n"
        "    assert run_tiny(tiny_cell(w))['correct'], w\n"
        "print(harness.forbidden_modules())\n"
    ) % str(CHECKOUT / "portbench" / "tests")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    ref = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); "
         "import portbench.reference.als, portbench.reference.ncf; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'predictionio_tpu', 'predictionio_tpu_torch', 'jax'}))"],
        cwd=CHECKOUT, text=True, capture_output=True, timeout=120)
    assert ref.returncode == 0 and ref.stdout.strip() == "[]", ref.stderr


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("predictionio_tpu_torch_like", sys)
    try:
        assert "predictionio_tpu_torch_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["predictionio_tpu_torch_like"]
