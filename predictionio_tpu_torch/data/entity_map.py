"""EntityMap: BiMap + typed per-entity payload (data/storage/EntityMap.scala:99),
the JAX package's ``data/entity_map.py`` over the port's ``data/bimap.py``.

Wraps the id<->index vocabulary with the entities' aggregated property
payloads, so templates can look up both the dense index (for device arrays)
and the business object by either key.
"""

from __future__ import annotations

from typing import Generic, Iterator, Mapping, TypeVar

from predictionio_tpu_torch.data.bimap import BiMap

T = TypeVar("T")


class EntityMap(Generic[T]):
    def __init__(self, entities: Mapping[str, T]):
        self._vocab = BiMap.from_keys(sorted(entities))
        self._payloads = dict(entities)

    @property
    def vocab(self) -> BiMap:
        return self._vocab

    def index_of(self, entity_id: str) -> int | None:
        return self._vocab.get(entity_id)

    def entity_id_of(self, index: int) -> str:
        return self._vocab.inverse(index)

    def __getitem__(self, entity_id: str) -> T:
        return self._payloads[entity_id]

    def get(self, entity_id: str, default: T | None = None) -> T | None:
        return self._payloads.get(entity_id, default)

    def by_index(self, index: int) -> T:
        return self._payloads[self._vocab.inverse(index)]

    def __len__(self) -> int:
        return len(self._payloads)

    def __contains__(self, entity_id: object) -> bool:
        return entity_id in self._payloads

    def __iter__(self) -> Iterator[str]:
        return iter(self._vocab)

    def items(self):
        return self._payloads.items()
