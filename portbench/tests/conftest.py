"""Shared helpers of the benchmark's own tests: tiny cells on the CPU.

Run from the root of the checkout:

    python -m pytest portbench/tests -q          # the CPU tests
    python -m pytest portbench/tests -q -m cuda  # on a machine with a card
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench import harness  # noqa: E402

#: the shapes of a tiny cell: every width the configuration gives but the
#: data's scale and the tower's widths, cut so a CPU run takes seconds
TINY = {"users": 300, "items": 160, "ratings": 12000}
TINY_NCF = {"embed_dim": 8, "mlp_layers": [16, 8, 4], "batch_size": 1024}

#: (workload, configuration file, traffic) of every cell the harness has
#: files for, the ALS cell included
CELLS = {
    "als-ml20m.train": ("als-ml20m", "als_retrain"),
    "ncf-dle-ml20m.train": ("ncf-dle-ml20m", "ncf_epochs"),
    "ncf-dle-ml20m.batch": ("ncf-dle-ml20m", "batchpredict_users"),
}


def tiny_cell(workload: str, widths: bool = False, scale: int = 1,
              **traffic) -> harness.Cell:
    """The cell ``workload`` at a tiny size (``scale`` times it), its limits
    as the configuration states them; ``widths`` keeps the tower's."""
    import json

    config, traffic_name = CELLS[workload]
    cfg = json.loads((harness.ROOT / "configs" / f"{config}.json").read_text())
    cfg.update({k: v * scale for k, v in TINY.items()})
    if "embed_dim" in cfg:
        cfg.update(TINY_NCF if not widths else
                   {"batch_size": TINY_NCF["batch_size"] * scale})
    tr = json.loads((harness.ROOT / "traffic" / f"{traffic_name}.json").read_text())
    if "queries_per_file" in tr:
        tr.update(queries_per_file=64, sampled_per_file=4)
    tr.update(traffic)
    return harness.Cell(workload, 1, cfg, tr, [], [])


def run_tiny(cell: harness.Cell, seed: int = 5, seconds: float = 0.3,
             trace: bool = False) -> dict:
    return harness.run_cell(copy.deepcopy(cell), seed, seconds, trace, "cpu",
                            time.perf_counter())


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
