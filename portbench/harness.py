"""The benchmark's harness, driven by data.

``BENCHMARK.json`` (at the root of the checkout) lists the cells.  A cell
names a configuration, whose file ``BENCHMARK.json`` gives, and a traffic
mix, found as ``traffic/<traffic>.json`` here.  The traffic file names its
driver, ``drivers/<driver>.py``, which takes its model family's plain
reference from ``reference/``.  Every metric is a reader of its own,
``metrics/<metric name>.py``, whose ``read(run)`` returns a number or None
(nothing to read: the metric is left out of the line).  A later cell,
configuration, traffic mix or metric is new files and new entries; no file
here changes.

A driver module has these functions:

- ``setup(cell, seed, device) -> state``: inputs and weights from the seed,
  the program's set-up, the warm-up of every shape the window uses;
- ``window(state, seconds, traced) -> dict``: the measured window, ended on a
  device synchronize, returning ``window_s``, ``attempted``, ``failed`` and
  the counts its metrics read;
- ``check(state) -> list[dict]``: after the window, the program's state
  freed, the comparison with the plain reference: ``{"name", "value",
  "limit"}`` each, a run correct where every value is at most its limit;
- ``controls(state) -> dict``: the readings the limits are set from, the
  program's beside its control's and planted faults' (``controls.py``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: top-level module names that may not be loaded when the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")


def cache_env(root: Path = ROOT) -> dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel
    cache, so that only a cell's first run in a checkout builds."""
    cache = root / ".cache"
    return {
        "PIO_KERNEL_BUILD_DIR": str(cache / "kernels"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_module(path: Path) -> ModuleType:
    """A module from a file, whatever characters its name holds."""
    name = "portbench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench_path: Path, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, with its configuration,
    traffic mix and the metrics it reports."""
    bench = json.loads(Path(bench_path).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def driver(cell: Cell, root: Path = ROOT) -> ModuleType:
    return load_module(root / "drivers" / f"{cell.traffic['driver']}.py")


@dataclass
class Run:
    """What a metric's reader sees."""

    cell: Cell
    device_name: str
    setup_s: float
    window_s: float
    stats: dict
    trace: object = None  # trace.TraceSummary of a traced run


def read_metrics(run: Run, metrics: list, root: Path = ROOT) -> dict:
    out = {}
    for m in metrics:
        value = load_module(root / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: list[dict]) -> bool:
    return bool(checks) and all(
        isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks
    )


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, root: Path = ROOT) -> dict:
    """One run: set-up, the window (traced or not), the memory peak, the
    check against the reference, the metrics.  Returns the result line's
    object with the checks under ``checks``, last."""
    import torch

    from portbench import trace as tracing

    on_card = torch.device(device).type == "cuda"
    drv = driver(cell, root)
    state = drv.setup(cell, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    summary = None
    if trace:
        with tracing.profiled(on_card) as prof:
            stats = drv.window(state, seconds, True)
        summary = tracing.summarize(prof, stats["window_s"])
    else:
        stats = drv.window(state, seconds, False)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    checks = drv.check(state)
    del state
    run = Run(cell, name, setup_s, stats["window_s"], stats, summary)
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end,
                           root)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell.chips if on_card else 1, "memory_peak_bytes": peak}
    out = {"correct": judge(checks), "attempted": int(stats["attempted"]),
           "failed": int(stats["failed"]), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = {
        c["name"]: {"value": c["value"] if math.isfinite(c["value"]) else None,
                    "limit": c["limit"]}
        for c in checks
    }
    return out


def main(argv=None) -> int:
    import argparse

    started = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(cache_env())
    cell = load_cell(CHECKOUT / "BENCHMARK.json", args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   started)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad[:20])}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
