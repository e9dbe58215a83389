"""Seeded MovieLens-shaped ratings, drawn on the device.

A frozen copy of ``chip_smoke.py`` ``movielens_like``, rewritten to draw
with a ``torch.Generator`` on the device in a few large calls: Zipf item
popularity ``(i + 10)^-0.8``, lognormal user activity, a planted rank-8
taste plus noise, half stars in [0.5, 5].  The same seed on the same kind
of device gives the same arrays.

The ratings themselves are drawn from the configuration's ``data_seed``,
so every run works on the same set of sizes; the run's seed relabels the
users and the items and shuffles the order of the ratings.  A seed thus
changes every input the program sees and none of the sizes.
"""

from __future__ import annotations

import math

import torch

#: rows drawn per slice: bounds the [rows, 8] taste gathers
_STEP = 1 << 22


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def movielens_like(nnz: int, n_users: int, n_items: int, seed: int,
                   device, data_seed: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(user int32 [nnz], item int32 [nnz], rating float32 [nnz])`` on
    ``device``: the ratings of ``data_seed``, relabelled and shuffled by
    ``seed``."""
    g = generator(data_seed, device)
    f64 = torch.float64
    item_cdf = torch.cumsum(
        (torch.arange(n_items, device=device, dtype=f64) + 10.0) ** -0.8, 0)
    user_cdf = torch.cumsum(
        torch.randn(n_users, generator=g, device=device, dtype=f64).exp(), 0)
    item_cdf /= item_cdf[-1].clone()
    user_cdf /= user_cdf[-1].clone()
    uf = torch.randn((n_users, 8), generator=g, device=device)
    vf = torch.randn((n_items, 8), generator=g, device=device)
    u = torch.empty(nnz, dtype=torch.int32, device=device)
    i = torch.empty(nnz, dtype=torch.int32, device=device)
    r = torch.empty(nnz, dtype=torch.float32, device=device)
    for lo in range(0, nnz, _STEP):
        n = min(_STEP, nnz - lo)
        uu = torch.searchsorted(
            user_cdf, torch.rand(n, generator=g, device=device, dtype=f64)
        ).clamp_(max=n_users - 1)
        ii = torch.searchsorted(
            item_cdf, torch.rand(n, generator=g, device=device, dtype=f64)
        ).clamp_(max=n_items - 1)
        raw = 3.5 + 0.9 * (uf[uu] * vf[ii]).sum(1) / math.sqrt(8.0)
        raw += 0.4 * torch.randn(n, generator=g, device=device)
        u[lo:lo + n] = uu
        i[lo:lo + n] = ii
        r[lo:lo + n] = torch.clamp(torch.round(raw * 2.0) / 2.0, 0.5, 5.0)
    g = generator(seed + 2, device)  # apart from the weights' and draws'
    users = torch.randperm(n_users, generator=g, device=device).to(torch.int32)
    items = torch.randperm(n_items, generator=g, device=device).to(torch.int32)
    order = torch.randperm(nnz, generator=g, device=device)
    return users[u[order].long()], items[i[order].long()], r[order]
