"""Fold $set/$unset/$delete event streams into per-entity PropertyMaps.

The port of the JAX package's ``data/aggregator.py``.  Mirrors the
semantics of LEventAggregator (data/.../storage/LEventAggregator.scala:32):
events are ordered by event time; ``$set`` merges properties (later wins),
``$unset`` removes the named keys, ``$delete`` drops the entity entirely (it may
be re-created by a later ``$set``); other event names do not affect properties.
An entity whose final state is deleted does not appear in the result.

The reference has both a local (iterator) and a Spark (RDD aggregateByKey)
flavor; here one pure function serves both the LEventStore path and the
columnar PEventStore path (which groups on the host before folding).
"""

from __future__ import annotations

from datetime import datetime
from typing import Iterable

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event

#: The event names that drive property aggregation.
AGGREGATOR_EVENT_NAMES = ("$set", "$unset", "$delete")


class _Acc:
    __slots__ = ("fields", "alive", "first", "last")

    def __init__(self):
        self.fields: dict | None = None  # None = no live property state
        self.alive = False
        self.first: datetime | None = None
        self.last: datetime | None = None

    def fold(self, e: Event) -> None:
        if e.event == "$set":
            if self.fields is None:
                self.fields = dict(e.properties.fields)
            else:
                self.fields.update(e.properties.fields)
        elif e.event == "$unset":
            if self.fields is not None:
                for k in e.properties.keyset():
                    self.fields.pop(k, None)
        elif e.event == "$delete":
            self.fields = None
            self.first = None
            self.last = None
            return
        else:
            return
        if self.first is None:
            self.first = e.event_time
        self.last = e.event_time

    def result(self) -> PropertyMap | None:
        if self.fields is None or self.first is None or self.last is None:
            return None
        return PropertyMap(self.fields, self.first, self.last)


def aggregate_properties_single(events: Iterable[Event]) -> PropertyMap | None:
    """Aggregate one entity's event stream; None if never set or deleted."""
    acc = _Acc()
    for e in sorted(events, key=lambda e: e.event_time):
        acc.fold(e)
    return acc.result()


def aggregate_properties(events: Iterable[Event]) -> dict[str, PropertyMap]:
    """Aggregate a mixed stream grouped by entityId -> PropertyMap."""
    by_entity: dict[str, list[Event]] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: dict[str, PropertyMap] = {}
    for entity_id, evs in by_entity.items():
        pm = aggregate_properties_single(evs)
        if pm is not None:
            out[entity_id] = pm
    return out
