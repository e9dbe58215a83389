"""Event-server bookkeeping counters (data/api/Stats.scala:47-112); the
port's copy of the JAX package's ``server/stats.py``.

Counts per-app (entityType, targetEntityType, event) triples and HTTP status
codes, with an hourly cutoff: ``update`` rolls the current window when the
hour changes, keeping the previous hour's frozen snapshot queryable — the
StatsActor's HourlyStats behavior (StatsActor.scala:76)."""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any


def _now() -> datetime:
    return datetime.now(tz=timezone.utc)


def _hour_floor(t: datetime) -> datetime:
    return t.replace(minute=0, second=0, microsecond=0)


@dataclass
class StatsWindow:
    start_time: datetime
    end_time: datetime | None = None
    # (appId, entityType, targetEntityType|None, event) -> count
    ete_count: Counter = field(default_factory=Counter)
    # (appId, status) -> count
    status_count: Counter = field(default_factory=Counter)

    def snapshot(self, app_id: int) -> dict[str, Any]:
        return {
            "startTime": self.start_time.isoformat(),
            "endTime": self.end_time.isoformat() if self.end_time else None,
            "basic": [
                {
                    "entityType": et,
                    "targetEntityType": tet,
                    "event": ev,
                    "count": c,
                }
                for (aid, et, tet, ev), c in sorted(
                    self.ete_count.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2] or "", kv[0][3])
                )
                if aid == app_id
            ],
            "statusCode": [
                {"status": status, "count": c}
                for (aid, status), c in sorted(self.status_count.items())
                if aid == app_id
            ],
        }


class HourlyStats:
    """Thread-safe current + previous hourly windows."""

    def __init__(self):
        self._lock = threading.Lock()
        now = _now()
        self.current = StatsWindow(start_time=_hour_floor(now))
        self.previous: StatsWindow | None = None

    def update(
        self,
        app_id: int,
        status: int,
        entity_type: str,
        target_entity_type: str | None,
        event_name: str,
    ) -> None:
        with self._lock:
            now = _now()
            hour = _hour_floor(now)
            if hour > self.current.start_time:
                # the frozen window covers exactly its own hour, not the
                # whole idle gap
                self.current.end_time = self.current.start_time + timedelta(
                    hours=1
                )
                # only an ADJACENT window is "the previous hour"; after a
                # multi-hour idle gap the prior hour had no traffic, so a
                # stale window must not be served as previousHour
                self.previous = (
                    self.current
                    if hour - self.current.start_time == timedelta(hours=1)
                    else None
                )
                self.current = StatsWindow(start_time=hour)
            self.current.ete_count[
                (app_id, entity_type, target_entity_type, event_name)
            ] += 1
            self.current.status_count[(app_id, status)] += 1

    def get(self, app_id: int) -> dict[str, Any]:
        with self._lock:
            out = {"currentHour": self.current.snapshot(app_id)}
            if self.previous is not None:
                out["previousHour"] = self.previous.snapshot(app_id)
            return out
