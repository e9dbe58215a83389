"""The port's similarity scoring (predictionio_tpu_torch.ops.similarity)
against the JAX package's, on the CPU.

The JAX package computes ``cosine_topk`` and ``dot_topk`` outside Pallas (a
``jnp`` matmul, then ``lax.top_k``); the port with ``torch.matmul`` and a
stable descending sort.  The contract is the tie rule: (value descending,
id ascending) over the masked row, excluded items at ``-inf``, so a ``k``
past the candidates left returns the excluded ids last in ascending order.

- Exact inputs (small integers; every cosine operand a power-of-two norm,
  so each score is exactly rounded in both packages) with planted ties:
  ids and scores equal bit for bit.
- Random-normal inputs: scores within rtol 1e-5 (the two packages' CPU
  matmuls may sum in another order), ids equal apart from near ties,
  judged on the (k+1)th score; excluded tails equal exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import similarity as jax_sim
from predictionio_tpu_torch.ops import similarity as pt_sim

torch.set_num_threads(2)

RTOL = 1e-5
N_ITEMS = 97


def _pow2_rows(rng, n: int, r: int) -> np.ndarray:
    """Integer rows whose norms are powers of two: m entries of +-1 with m
    in {1, 4, 16} (as far as the rank allows), or one entry of +-2."""
    out = np.zeros((n, r), np.float32)
    for row in out:
        choices = [m for m in (1, 4, 16) if m <= r] + [0]
        m = rng.choice(choices)
        if m == 0:
            row[rng.integers(r)] = rng.choice([-2.0, 2.0])
        else:
            cols = rng.choice(r, m, replace=False)
            row[cols] = rng.choice([-1.0, 1.0], m)
    return out


def _inputs(kind: str, rank: int, n_query: int, mask: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "exact":
        items = _pow2_rows(rng, N_ITEMS, rank)
        queries = _pow2_rows(rng, n_query, rank)
        # planted ties: duplicated rows score alike in every query
        for a, b in ((3, 40), (3, 41), (10, 96), (55, 56)):
            items[b] = items[a]
    else:
        items = rng.standard_normal((N_ITEMS, rank)).astype(np.float32)
        queries = rng.standard_normal((n_query, rank)).astype(np.float32)
    if mask == "none":
        exclude = np.zeros(N_ITEMS, bool)
    elif mask == "all":
        exclude = np.ones(N_ITEMS, bool)
    elif mask == "most":  # fewer candidates than k
        exclude = np.ones(N_ITEMS, bool)
        exclude[rng.choice(N_ITEMS, 5, replace=False)] = False
    else:
        exclude = rng.random(N_ITEMS) < 0.3
    return queries, items, exclude


def _jax(fn, q, items, exclude, k):
    s, i = fn(q, items, exclude, k)
    return np.asarray(s), np.asarray(i)


def _port(fn, q, items, exclude, k):
    s, i = fn(torch.from_numpy(q), torch.from_numpy(items),
              torch.from_numpy(exclude), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int64
    return s.numpy(), i.numpy()


def _call(which: str, mod, q, items, exclude, k):
    run = _jax if mod is jax_sim else _port
    if which == "cosine":
        return run(mod.cosine_topk, q, items, exclude, k)
    return run(mod.dot_topk, q[0], items, exclude, k)


def _hold(got, want, want_next, what):
    """Scores within RTOL; ids equal, except a finite position whose score
    is within RTOL of its neighbour's (the (k+1)th included)."""
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6, err_msg=what)
    nb = np.r_[ws, want_next]
    for j in np.flatnonzero(gi != wi):
        assert np.isfinite(ws[j]), (what, j)  # the -inf tail is exact
        gap = min(abs(nb[j] - nb[x]) for x in (j - 1, j + 1) if 0 <= x < len(nb))
        assert gap <= RTOL * abs(ws[j]) + 1e-6, (what, j)


RANKS = (1, 10, 17)
MASKS = ("none", "random", "all", "most")
CASES = [
    (which, rank, n_query, mask)
    for which in ("cosine", "dot")
    for rank in RANKS
    for n_query in ((1, 3, 5) if which == "cosine" else (1,))
    for mask in MASKS
]


def _id(c):
    return f"{c[0]}-r{c[1]}-q{c[2]}-{c[3]}"


@pytest.mark.parametrize("which,rank,n_query,mask", CASES, ids=[_id(c) for c in CASES])
def test_exact_inputs_with_ties_are_equal_bit_for_bit(which, rank, n_query, mask):
    q, items, exclude = _inputs("exact", rank, n_query, mask, seed=rank * 10 + n_query)
    for k in (1, 10, N_ITEMS):
        gs, gi = _call(which, pt_sim, q, items, exclude, k)
        ws, wi = _call(which, jax_sim, q, items, exclude, k)
        np.testing.assert_array_equal(gi, wi, err_msg=f"k={k}")
        np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
        # the tie rule itself: value desc, id asc
        for a in range(len(gi) - 1):
            assert gs[a] > gs[a + 1] or (gs[a] == gs[a + 1] and gi[a] < gi[a + 1])


@pytest.mark.parametrize("which,rank,n_query,mask", CASES, ids=[_id(c) for c in CASES])
def test_random_inputs_match_within_rtol(which, rank, n_query, mask):
    q, items, exclude = _inputs("normal", rank, n_query, mask, seed=7 + rank + n_query)
    for k in (1, 10, 40):
        got = _call(which, pt_sim, q, items, exclude, k)
        want = _call(which, jax_sim, q, items, exclude, k + 1)
        _hold(got, (want[0][:k], want[1][:k]), want[0][k], f"{which} k={k}")


@pytest.mark.parametrize("which", ["cosine", "dot"])
def test_k_past_the_candidates_returns_the_excluded_tail_in_id_order(which):
    q, items, exclude = _inputs("normal", 10, 2, "most", seed=3)
    gs, gi = _call(which, pt_sim, q, items, exclude, N_ITEMS)
    ws, wi = _call(which, jax_sim, q, items, exclude, N_ITEMS)
    n_cand = int((~exclude).sum())
    assert np.isfinite(gs[:n_cand]).all() and np.isneginf(gs[n_cand:]).all()
    np.testing.assert_array_equal(gi[n_cand:], np.flatnonzero(exclude))
    np.testing.assert_array_equal(gi[n_cand:], wi[n_cand:])
    np.testing.assert_array_equal(np.sort(gi[:n_cand]), np.flatnonzero(~exclude))


def test_zero_vectors_score_zero_as_in_jax():
    # a zero query or item row: the norm clamps at 1e-9, the score is 0
    q = np.zeros((2, 4), np.float32)
    q[1, 0] = 1.0
    items = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    items[5] = 0.0
    exclude = np.zeros(8, bool)
    gs, gi = _call("cosine", pt_sim, q, items, exclude, 8)
    ws, wi = _call("cosine", jax_sim, q, items, exclude, 8)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(gi, wi)
