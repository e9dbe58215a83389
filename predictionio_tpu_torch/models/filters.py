"""Vectorized serving-time candidate filtering shared by the rec templates.

The port of the JAX package's ``models/filters.py``: the isCandidateItem
checks of the similarproduct/ecommerce references (ALSAlgorithm.scala
isCandidateItem, ECommAlgorithm.isCandidateItem) as one numpy mask build,
and category membership via a per-model category->bool-array index built
once and cached (predict runs per query — no per-item Python loops in the
hot path).

The masks are the JAX package's, bit for bit.  Where it marks
whiteList/blackList members with ``np.isin`` over the vocabulary's key
array, the port looks each listed id up in the vocabulary: ``np.isin`` of
an id list (an object array) compares in Python per item and list entry,
about 0.5 s a query at 26,744 items with ~220 listed ids (the seen items
of an ecommerce user), where the lookups take microseconds.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from predictionio_tpu_torch.data.bimap import BiMap


class CategoryIndex:
    """category name -> boolean membership array over item indices."""

    def __init__(self, item_vocab: BiMap, items_categories: Mapping[str, Iterable[str]]):
        n = len(item_vocab)
        self._by_cat: dict[str, np.ndarray] = {}
        for item_id, cats in items_categories.items():
            idx = item_vocab.get(item_id)
            if idx is None:
                continue
            for c in cats:
                arr = self._by_cat.get(c)
                if arr is None:
                    arr = self._by_cat[c] = np.zeros(n, bool)
                arr[idx] = True
        self._n = n

    def any_of(self, categories: Iterable[str]) -> np.ndarray:
        """Items belonging to at least one of the categories."""
        mask = np.zeros(self._n, bool)
        for c in categories:
            arr = self._by_cat.get(c)
            if arr is not None:
                mask |= arr
        return mask


def _vocab_rows(item_vocab: BiMap, ids: Iterable[str]) -> list[int]:
    """Vocabulary rows of the listed ids (ids outside it are skipped)."""
    get = item_vocab.get
    return [i for x in ids if (i := get(x)) is not None]


def exclude_mask(
    item_vocab: BiMap,
    category_index: CategoryIndex | None = None,
    query_idx: Iterable[int] = (),
    white_list: Iterable[str] | None = None,
    black_list: Iterable[str] = (),
    categories: Iterable[str] | None = None,
    category_black_list: Iterable[str] | None = None,
) -> np.ndarray:
    """True = item filtered out of the candidate set."""
    n = len(item_vocab)
    exclude = np.zeros(n, bool)
    qi = list(query_idx)
    if qi:
        exclude[qi] = True
    if white_list is not None:
        keep = np.zeros(n, bool)
        keep[_vocab_rows(item_vocab, white_list)] = True
        exclude |= ~keep
    bl = _vocab_rows(item_vocab, black_list)
    if bl:
        exclude[bl] = True
    if category_index is not None:
        if categories:
            exclude |= ~category_index.any_of(categories)
        if category_black_list:
            exclude |= category_index.any_of(category_black_list)
    return exclude
