"""The numbers that decide ``correct``, computed from the program's outputs
and the plain reference's.  Each is a gap that is 0 for exact agreement."""

from __future__ import annotations

import math

import torch


def norm_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between two norms: ``| |prog| - |ref| |`` over
    the larger of the reference leaf's norm and the median leaf's, for the
    leaves in ``keep`` (default: all).  ``prog`` and ``ref`` map leaf names
    to norms."""
    names = [n for n in ref if keep is None or n in keep]
    med = sorted(ref[n] for n in names)[len(names) // 2]
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
               for n in names)


def leaf_norms(leaves: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(x.double())) for n, x in
            leaves.items()}


def factor_gaps(prog: tuple, ref: tuple) -> dict:
    """``factor_gap``: the Frobenius norm of the difference of both factor
    tables over that of the reference's; ``row_gap``: the worst row's
    distance over the larger of its reference norm and the median row's."""
    diff2 = total2 = 0.0
    row = 0.0
    for p, r in zip(prog, ref):
        p, r = p.double(), r.double()
        d = torch.linalg.vector_norm(p - r, dim=1)
        n = torch.linalg.vector_norm(r, dim=1)
        diff2 += float((d * d).sum())
        total2 += float((n * n).sum())
        row = max(row, float((d / torch.clamp(n, min=float(n.median()))).max()))
    return {"factor_gap": math.sqrt(diff2 / total2), "row_gap": row}


def topk_gaps(users, items, scores, ref_scores: torch.Tensor) -> dict:
    """For answers of ``k`` items each (``items``, ``scores`` ``[n, k]``,
    the rows of ``users``) against the reference's scores of every item
    ``[n, n_items]``: ``rank_gap``, the widest gap by which an answer's
    j-th item lies below the reference's j-th best score; ``score_gap``,
    the widest distance between an answered score and the reference's
    score of that item.  Both over the spread (standard deviation) of that
    user's reference scores.  A row with a repeated item reads infinite."""
    ref = ref_scores.double()
    k = items.shape[1]
    best = torch.sort(ref, dim=1, descending=True).values[:, :k]
    got = torch.gather(ref, 1, items)
    scale = ref.std(dim=1)[:, None]
    rank = ((best - got) / scale).max()
    score = ((scores.double() - got).abs() / scale).max()
    repeats = any(len(set(row.tolist())) < k for row in items.cpu())
    inf = float("inf")
    return {"rank_gap": inf if repeats else float(rank),
            "score_gap": inf if repeats else float(score)}
