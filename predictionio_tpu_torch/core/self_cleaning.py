"""Self-cleaning data source: TTL window + $set compaction + dedup.

Parity with core/SelfCleaningDataSource.scala:42-324: an ``EventWindow``
declares a duration (events older than it are dropped, except ``$set``
property events when compaction will fold them), ``compress_properties``
collapses each entity's ``$set`` chain into a single event carrying the
folded property map, ``remove_duplicates`` keeps the earliest of
identical events, and ``clean_persisted_events`` writes the cleaned stream
back to the store (delete stale rows, insert compacted ones).  The port of
the JAX package's ``core/self_cleaning.py`` over the port's
``data/aggregator.py`` and event stores.

Use as a mixin/wrapper around any DataSource, same as the reference trait::

    class CleaningRatingsDataSource(SelfCleaningDataSource, RatingsDataSource):
        @property
        def event_window(self):
            return EventWindow(duration_seconds=30 * 24 * 3600)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Iterable

from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.store import resolve_app


@dataclass(frozen=True)
class EventWindow:
    """Cleanup policy (the reference EventWindow: duration, removeDuplicates,
    compressProperties)."""

    duration_seconds: float | None = None
    remove_duplicates: bool = False
    compress_properties: bool = False


def is_set_event(e: Event) -> bool:
    return e.event == "$set"


def _dedup_key(e: Event):
    # DataMap is hashable (canonical JSON); raw .fields tuples would crash
    # on list/dict-valued properties
    return (
        e.event,
        e.entity_type,
        e.entity_id,
        e.target_entity_type,
        e.target_entity_id,
        e.properties,
        e.tags,
        e.pr_id,
    )


class SelfCleaningDataSource:
    """Mixin offering cleaned event reads and persisted cleanup."""

    #: override (or set as attribute) — the app whose events are cleaned
    app_name: str = "default"

    @property
    def event_window(self) -> EventWindow | None:
        return None

    # -- pure transforms -----------------------------------------------------
    def cleaned_events(self, events: Iterable[Event]) -> list[Event]:
        """TTL filter + optional compaction + optional dedup (cleanEvents)."""
        events = list(events)
        ew = self.event_window
        if ew is None:
            return events
        if ew.duration_seconds is not None:
            cutoff = datetime.now(tz=timezone.utc) - timedelta(
                seconds=ew.duration_seconds
            )
            events = [
                e for e in events if e.event_time > cutoff or is_set_event(e)
            ]
        if ew.compress_properties:
            events = self._compress(events)
        if ew.remove_duplicates:
            events = self._dedup(events)
        return events

    def _compress(self, events: list[Event]) -> list[Event]:
        """Fold each entity's $set chain into one event (compressPProperties)."""
        set_events = [e for e in events if is_set_event(e)]
        other = [e for e in events if not is_set_event(e)]
        by_entity: dict[tuple[str, str], list[Event]] = {}
        for e in set_events:
            by_entity.setdefault((e.entity_type, e.entity_id), []).append(e)
        compressed = []
        for (etype, eid), chain in by_entity.items():
            chain.sort(key=lambda e: e.event_time)
            folded = aggregate_properties(chain)
            props = folded.get(eid)
            compressed.append(
                dataclasses.replace(
                    chain[-1],
                    properties=props if props is not None else chain[-1].properties,
                    event_id=chain[-1].event_id,
                )
            )
        return compressed + other

    def _dedup(self, events: list[Event]) -> list[Event]:
        """Keep the first occurrence of identical events (removeDuplicates)."""
        seen: set = set()
        out = []
        for e in sorted(events, key=lambda e: e.event_time):
            k = _dedup_key(e)
            if k in seen:
                continue
            seen.add(k)
            out.append(e)
        return out

    # -- persisted cleanup ---------------------------------------------------
    def clean_persisted_events(self, ctx: EngineContext) -> int:
        """Apply the window to the stored stream: delete events that cleaning
        dropped, rewrite compacted $set rows (cleanPersistedPEvents).

        Returns the number of removed events.
        """
        ew = self.event_window
        if ew is None:
            return 0
        storage = ctx.storage_runtime
        app_id, channel_id = resolve_app(self.app_name, None, storage)
        levents = storage.l_events()
        original = list(levents.find(app_id, channel_id))
        by_id = {e.event_id: e for e in original if e.event_id}
        cleaned = self.cleaned_events(original)
        cleaned_ids = {e.event_id for e in cleaned if e.event_id}
        removed = 0
        for e in original:
            if e.event_id and e.event_id not in cleaned_ids:
                levents.delete(e.event_id, app_id, channel_id)
                removed += 1
        # rewrite events cleaning changed (compacted rows keep their id —
        # insert is an id-keyed upsert per the LEvents contract) and insert
        # genuinely new ones
        to_write = [
            e
            for e in cleaned
            if e.event_id not in by_id or by_id[e.event_id] != e
        ]
        if to_write:
            levents.insert_batch(to_write, app_id, channel_id)
        return removed
