"""Readings that the limits of ``correct`` are set from, for one cell at its
own size: per seed, the program's numbers (the timed call at the timed
sizes, as set-up and the check drive it), the control's (the reference in
the nearest precision below the configuration's, or the program's own
lower-precision path) and planted faults', all against the float64
reference.  The benchmark's runs never run this.

    python3 portbench/controls.py --workload <name> --seeds 1,2,3 [--out file]

prints one JSON line per seed (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def readings(cell, seed: int, device) -> dict:
    drv = harness.driver(cell)
    t0 = time.perf_counter()
    state = drv.setup(cell, seed, device)
    out = drv.controls(state)
    return {"workload": cell.name, "seed": seed, "readings": out,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env())
    cell = harness.load_cell(harness.CHECKOUT / "BENCHMARK.json", args.workload)

    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, "cuda"))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
