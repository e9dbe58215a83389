"""BiMap: bidirectional value <-> index mapping — the id-vocab primitive.

The reference's BiMap (data/.../storage/BiMap.scala:28,105) maps arbitrary
string entity ids to dense integer indices so models can use array layouts;
``BiMap.stringInt`` builds the vocab from an RDD.  Here the vocab is a numpy
string array plus a hash dict, built from any iterable or numpy array;
``to_index_array`` vectorizes the forward lookup for columnar event batches.
``to_state``/``from_state`` keep the numpy string array layout of the JAX
package's BiMap, so persisted vocabularies load in either package.
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, Iterator, Mapping, Sequence, TypeVar

import numpy as np

K = TypeVar("K", bound=Hashable)


class BiMap(Generic[K]):
    """Immutable bidirectional mapping between keys and dense int64 indices."""

    __slots__ = ("_forward", "_inverse_keys")

    def __init__(self, forward: Mapping[K, int]):
        n = len(forward)
        inv: list = [None] * n
        for k, i in forward.items():
            if not 0 <= i < n:
                raise ValueError(f"BiMap indices must be dense 0..{n - 1}; got {i}")
            if inv[i] is not None:
                raise ValueError(f"BiMap index {i} is not unique")
            inv[i] = k
        self._forward: dict[K, int] = dict(forward)
        self._inverse_keys: list[K] = inv

    # -- construction --------------------------------------------------------
    @classmethod
    def from_keys(cls, keys: Iterable[K]) -> "BiMap[K]":
        """Build a vocab from keys in first-seen order (deduplicating)."""
        forward: dict[K, int] = {}
        for k in keys:
            if k not in forward:
                forward[k] = len(forward)
        return cls.__new__(cls)._init_unchecked(forward)

    @classmethod
    def string_int(cls, keys: Iterable[str]) -> "BiMap[str]":
        """Name kept for parity with the reference's BiMap.stringInt."""
        return cls.from_keys(keys)  # type: ignore[return-value]

    def _init_unchecked(self, forward: dict[K, int]) -> "BiMap[K]":
        self._forward = forward
        self._inverse_keys = list(forward)
        return self

    # -- lookups -------------------------------------------------------------
    def __getitem__(self, key: K) -> int:
        return self._forward[key]

    def get(self, key: K, default: int | None = None) -> int | None:
        return self._forward.get(key, default)

    def inverse(self, index: int) -> K:
        return self._inverse_keys[index]

    def __contains__(self, key: object) -> bool:
        return key in self._forward

    def __len__(self) -> int:
        return len(self._forward)

    def __iter__(self) -> Iterator[K]:
        return iter(self._forward)

    def items(self):
        return self._forward.items()

    # -- vectorized ----------------------------------------------------------
    def to_index_array(
        self, keys: Sequence[K] | np.ndarray, missing: int = -1
    ) -> np.ndarray:
        """Vectorized forward lookup; unknown keys map to ``missing``."""
        get = self._forward.get
        return np.fromiter(
            (get(k, missing) for k in keys), dtype=np.int64, count=len(keys)
        )

    def keys_array(self) -> np.ndarray:
        """The inverse table as a numpy array indexed by position."""
        return np.asarray(self._inverse_keys)

    # -- persistence ---------------------------------------------------------
    def to_state(self) -> np.ndarray:
        return self.keys_array()

    @classmethod
    def from_state(cls, keys: np.ndarray) -> "BiMap":
        return cls.from_keys(k.item() if hasattr(k, "item") else k for k in keys)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._forward == other._forward

    def __repr__(self) -> str:
        return f"BiMap(n={len(self)})"
