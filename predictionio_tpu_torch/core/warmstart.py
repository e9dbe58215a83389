"""Warm-start helpers: seeding a retrain from the previous generation.

The JAX package's ``core/warmstart.py``.  ``run_train(warm_start_from=...)``
puts the previous generation's persisted per-algorithm models on
``ctx.warm_start``; algorithms that understand their own persisted shape
pick it up here:

- :func:`find_warm_start`: each algorithm scans the per-algorithm list for
  a dict carrying its keys;
- :func:`align_warm_factors`: the old -> new vocab row mapping; entities the
  previous generation never saw get a scale-matched random init.

Anything unusable returns None and the train starts cold: a warm start is
an optimization, never a correctness dependency.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap


def find_warm_start(
    ctx: Any, required: tuple[str, ...]
) -> dict[str, Any] | None:
    """First previous-generation persisted model on ``ctx.warm_start``
    carrying every key in ``required``, else None."""
    prev_models = getattr(ctx, "warm_start", None)
    if not prev_models:
        return None
    for m in prev_models:
        if isinstance(m, dict) and all(k in m for k in required):
            return m
    return None


def align_warm_factors(
    prev: np.ndarray, prev_vocab: BiMap, new_vocab: BiMap, rng
) -> np.ndarray:
    """Previous factor rows in the NEW vocab's order; entities the
    previous generation never saw get the MLlib-style nonnegative random
    init so their scale matches the trained rows."""
    rank = prev.shape[1]
    out = (
        np.abs(rng.standard_normal((len(new_vocab), rank))) / np.sqrt(rank)
    ).astype(np.float32)
    old_idx = prev_vocab.to_index_array(new_vocab.keys_array(), missing=-1)
    found = old_idx >= 0
    out[found] = prev[old_idx[found]].astype(np.float32)
    return out
