"""Dense similarity scoring for item-to-item and known-user serving.

The port of the JAX package's ``ops/similarity.py``, which computes both
functions outside Pallas (a ``jnp`` matmul, then ``lax.top_k``): here a
``torch.matmul`` on the device of the factors, then a stable descending
sort.  The tie rule is the contract: (value descending, id ascending) over
the masked row, with excluded items at ``-inf`` (so a ``k`` past the
candidates left returns the excluded ids last, in ascending order, as
``lax.top_k`` does; callers drop non-finite scores).  ``torch.topk``
promises no order among equal values, so it is not used.
"""

from __future__ import annotations

import torch


def _masked_topk(scores: torch.Tensor, exclude_mask: torch.Tensor, k: int):
    scores = scores.masked_fill(exclude_mask, float("-inf"))
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def cosine_topk(
    query_features: torch.Tensor,  # [q, rank] feature vectors of query items
    item_factors: torch.Tensor,  # [n_items, rank]
    exclude_mask: torch.Tensor,  # [n_items] bool, True = filtered out
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of cosine similarities of each item to all query vectors, top-k:
    (scores [k] float32, item ids [k] int64) on the factors' device.

    Mirrors the reference scoring exactly: per query vector cosine, summed
    over query vectors; excluded items rank at ``-inf`` (callers drop
    non-positive scores)."""
    qn = query_features / torch.clamp(
        torch.linalg.vector_norm(query_features, dim=1, keepdim=True), min=1e-9
    )
    item_norm = torch.clamp(torch.linalg.vector_norm(item_factors, dim=1), min=1e-9)
    # [n_items, q] cosine matrix via one matmul, summed over query vectors
    scores = (item_factors @ qn.T).sum(dim=1) / item_norm
    return _masked_topk(scores, exclude_mask, k)


def dot_topk(
    user_vec: torch.Tensor,  # [rank]
    item_factors: torch.Tensor,  # [n_items, rank]
    exclude_mask: torch.Tensor,  # [n_items] bool
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dot-product scoring with masked top-k (the known-user serving path)."""
    return _masked_topk(item_factors @ user_vec, exclude_mask, k)
