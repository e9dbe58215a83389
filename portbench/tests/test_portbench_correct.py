"""What decides ``correct``: the program against the plain reference at tiny
sizes on the CPU, each fault a cell can have planted under the timed path
(a run must then come out not correct), and the controls, which must fail
the limits the configurations state."""

from __future__ import annotations

import pytest
import torch
from conftest import run_tiny, tiny_cell

from portbench import harness


@pytest.mark.parametrize("workload", ["als-ml20m.train", "ncf-dle-ml20m.train",
                                      "ncf-dle-ml20m.batch"])
@pytest.mark.parametrize("trace", [False, True])
def test_port_matches_reference(workload, trace):
    out = run_tiny(tiny_cell(workload), trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for c in out["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"]


# -- faults planted under the timed path --------------------------------------


def _als_with(monkeypatch, change):
    from predictionio_tpu_torch.ops import als

    real = als.train_als

    def train_als(user, item, rating, n_users, n_items, params, device):
        return change(real, user, item, rating, n_users, n_items, params, device)

    monkeypatch.setattr(als, "train_als", train_als)


def als_unchanged(monkeypatch):
    """Every step returns its state unchanged: the start comes back."""
    from dataclasses import replace

    _als_with(monkeypatch, lambda real, *a: real(
        *a[:5], replace(a[5], num_iterations=0), a[6]))


def als_half_batch(monkeypatch):
    """Every other rating left out."""
    _als_with(monkeypatch, lambda real, u, i, r, *a: real(
        u[::2], i[::2], r[::2], *a))


def als_answer_altered(monkeypatch):
    """One user's factors altered where they are produced."""
    def change(real, *a):
        out = real(*a)
        out.user_factors[3] += 0.5
        return out

    _als_with(monkeypatch, change)


def ncf_unchanged(monkeypatch):
    """Each step leaves the parameters as they were."""
    from predictionio_tpu_torch.ops import ncf

    real = ncf.train_step

    def train_step(params, *a, **k):
        before = [x.detach().clone() for x in ncf.tree_leaves(params)]
        loss = real(params, *a, **k)
        with torch.no_grad():
            for x, b in zip(ncf.tree_leaves(params), before):
                x.copy_(b)
        return loss

    monkeypatch.setattr(ncf, "train_step", train_step)


def ncf_half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from predictionio_tpu_torch.ops import ncf

    real = ncf.bpr_loss

    def bpr_loss(params, user, pos, neg, valid, count=None):
        half = valid * (torch.arange(len(valid)) % 2 == 0)
        return real(params, user, pos, neg, half, count)

    monkeypatch.setitem(ncf._SAMPLED_LOSSES, "bpr", bpr_loss)


def batch_answer_altered(monkeypatch):
    """Each wave's first answer swapped for a later one where it is made."""
    from predictionio_tpu_torch.models.ncf import engine

    real = engine.score_topk_batch

    def score_topk_batch(*a, **k):
        packed = real(*a, **k)
        packed[:, :, [0, -1]] = packed[:, :, [-1, 0]]
        return packed

    monkeypatch.setattr(engine, "score_topk_batch", score_topk_batch)


@pytest.mark.parametrize("workload,fault", [
    ("als-ml20m.train", als_unchanged),
    ("als-ml20m.train", als_half_batch),
    ("als-ml20m.train", als_answer_altered),
    ("ncf-dle-ml20m.train", ncf_unchanged),
    ("ncf-dle-ml20m.train", ncf_half_batch),
    ("ncf-dle-ml20m.batch", batch_answer_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_comes_out_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_cell(workload))
    assert not out["correct"], out["checks"]


# -- controls ------------------------------------------------------------------


def _control_fails(cell: harness.Cell, device) -> dict:
    drv = harness.driver(cell)
    readings = drv.controls(drv.setup(cell, 9, device))
    limits = cell.config["limits"][cell.traffic["driver"]]
    ok = lambda r: all(r[n] <= limits[n] for n in limits)  # noqa: E731
    assert ok(readings["program"]), readings["program"]
    for name, r in readings.items():
        if name.startswith(("control", "fault")) and not name.endswith("_leaves"):
            assert not ok(r), (name, r)
    return readings


def test_als_control_fails_on_cpu():
    """The program's own bf16 accumulation runs on the CPU too."""
    _control_fails(tiny_cell("als-ml20m.train"), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["als-ml20m.train", "ncf-dle-ml20m.train",
                                      "ncf-dle-ml20m.batch"])
def test_control_fails_on_card(card, workload):
    """TF32 exists only on the card: there every control fails a limit, at
    the configuration's own widths over a small data set."""
    _control_fails(tiny_cell(workload, widths=True, scale=20), card)
