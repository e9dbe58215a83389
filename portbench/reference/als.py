"""Plain ALS-WR for explicit ratings, the reference the ALS cells are held
to.  Plain PyTorch; imports nothing of the program.

Apache PredictionIO's recommendation template trains MLlib's ALS with
explicit feedback: each half-step solves, for every entity, ``(V_u^T V_u +
lambda * n_u * I) x = V_u^T r_u`` over the ratings of that entity (ALS-WR,
lambda scaled by the entity's rating count, at least 1), users first.  The
start is MLlib's non-negative draw, ``|N(0, 1)| / sqrt(rank)`` from a CPU
``torch.Generator`` seeded with the template's ``seed``, users then items.

The sums are formed in sorted order, a block of ratings at a time, by a
running sum that is differenced at each entity's last rating: no atomics,
so the reference repeats bit for bit.
"""

from __future__ import annotations

import math

import torch

#: ratings summed at once (bounds the [rows, k*k + k + 1] block)
BLOCK = 1 << 20


def init_factors(n_users: int, n_items: int, rank: int, seed: int):
    """The template's start: ``(U0, V0)`` float32 on the CPU."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    scale = math.sqrt(rank)
    U = torch.randn((n_users, rank), generator=g).abs() / scale
    V = torch.randn((n_items, rank), generator=g).abs() / scale
    return U, V


class Direction:
    """One side's ratings sorted by that side's entity."""

    def __init__(self, seg: torch.Tensor, oth: torch.Tensor,
                 rating: torch.Tensor, n_seg: int):
        order = torch.argsort(seg.to(torch.int64), stable=True)
        self.seg = seg.to(torch.int64)[order]
        self.oth = oth.to(torch.int64)[order]
        self.rating = rating[order]
        self.n_seg = n_seg


def half_step(d: Direction, other: torch.Tensor, reg: float) -> torch.Tensor:
    """The factors of ``d``'s entities from the opposite ``other`` factors,
    in ``other``'s dtype."""
    k = other.shape[1]
    dt, dev = other.dtype, other.device
    stats = torch.zeros((d.n_seg, k * k + k + 1), dtype=dt, device=dev)
    for lo in range(0, len(d.seg), BLOCK):
        seg = d.seg[lo:lo + BLOCK]
        v = other[d.oth[lo:lo + BLOCK]]
        r = d.rating[lo:lo + BLOCK].to(dt)
        # column-major, so that each running sum is along the inner dim
        cols = torch.cat(
            [(v.T[:, None, :] * v.T[None, :, :]).reshape(k * k, -1),
             v.T * r[None, :], torch.ones_like(r)[None, :]], dim=0)
        run = cols.cumsum(1)
        ids, counts = torch.unique_consecutive(seg, return_counts=True)
        ends = counts.cumsum(0) - 1
        sums = run[:, ends]
        sums[:, 1:] -= run[:, ends[:-1]]
        stats.index_add_(0, ids, sums.T)
    A = stats[:, :k * k].reshape(-1, k, k)
    b = stats[:, k * k:k * k + k]
    n = stats[:, -1]
    eye = torch.eye(k, dtype=dt, device=dev)
    lhs = A + (reg * torch.clamp(n, min=1.0))[:, None, None] * eye
    L = torch.linalg.cholesky(lhs)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def train(user: torch.Tensor, item: torch.Tensor, rating: torch.Tensor,
          n_users: int, n_items: int, rank: int, iterations: int, reg: float,
          seed: int, dtype=torch.float64):
    """``(U, V)`` after ``iterations`` ALS iterations, on ``user``'s device,
    in ``dtype``."""
    dev = user.device
    by_user = Direction(user, item, rating, n_users)
    by_item = Direction(item, user, rating, n_items)
    U, V = (x.to(dev, dt) for x, dt in
            zip(init_factors(n_users, n_items, rank, seed), (dtype, dtype)))
    for _ in range(iterations):
        U = half_step(by_user, V, reg)
        V = half_step(by_item, U, reg)
    return U, V
