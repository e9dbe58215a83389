"""DataMap: the JSON property bag attached to events, and event times.

The part of the JAX package's ``data/datamap.py`` that :class:`Event`
needs: an immutable mapping of property name -> JSON value, and the API's
ISO-8601 time parsing and formatting.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from typing import Any, Mapping


class DataMapError(Exception):
    """Raised on a value that cannot be read as an event time."""


def parse_event_time(value: Any) -> datetime:
    """Parse an ISO-8601 timestamp (or epoch millis) into an aware UTC datetime."""
    if isinstance(value, datetime):
        return value if value.tzinfo else value.replace(tzinfo=timezone.utc)
    if isinstance(value, (int, float)):
        return datetime.fromtimestamp(value / 1000.0, tz=timezone.utc)
    if isinstance(value, str):
        s = value.strip()
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        dt = datetime.fromisoformat(s)
        return dt if dt.tzinfo else dt.replace(tzinfo=timezone.utc)
    raise DataMapError(f"cannot parse event time from {value!r}")


def format_event_time(dt: datetime) -> str:
    """Format an aware datetime as ISO-8601 with millisecond precision (API format)."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    dt = dt.astimezone(timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


class DataMap:
    """Immutable property bag; keys are property names, values JSON values."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    @property
    def fields(self) -> dict[str, Any]:
        return dict(self._fields)

    def keyset(self) -> set[str]:
        return set(self._fields)

    def is_empty(self) -> bool:
        return not self._fields

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DataMap) and self._fields == other._fields

    def __hash__(self) -> int:
        return hash(self.to_json())

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"
