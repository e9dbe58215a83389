"""DataMap / PropertyMap: typed JSON property bags attached to events and
entities.

The port of the JAX package's ``data/datamap.py``, the contract of the
reference's DataMap (data/.../storage/DataMap.scala:45) and PropertyMap
(data/.../storage/PropertyMap.scala:33): an immutable mapping of property
name -> JSON value, with typed accessors, merge (``++``) and key-removal
(``--``) operators, and a dataclass extractor.  PropertyMap additionally
carries first/last updated times, produced by the $set/$unset/$delete
aggregation (see predictionio_tpu_torch.data.aggregator).
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime, timezone
from typing import Any, Iterable, Iterator, Mapping, Type, TypeVar

T = TypeVar("T")

# JSON value types a DataMap field may hold.
JSONValue = None | bool | int | float | str | list | dict


class DataMapError(Exception):
    """Raised on missing required fields or extraction failures."""


def _coerce(value: Any, typ: Any, name: str) -> Any:
    """Coerce a JSON value to the requested Python type, erroring on mismatch."""
    if typ in (None, Any):
        return value
    origin = getattr(typ, "__origin__", None)
    if origin is list:
        (elem,) = typ.__args__
        if not isinstance(value, list):
            raise DataMapError(f"field {name!r}: expected list, got {type(value).__name__}")
        return [_coerce(v, elem, name) for v in value]
    if origin is dict:
        _, elem = typ.__args__
        if not isinstance(value, dict):
            raise DataMapError(f"field {name!r}: expected dict, got {type(value).__name__}")
        return {k: _coerce(v, elem, name) for k, v in value.items()}
    if typ is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise DataMapError(f"field {name!r}: expected float, got {value!r}")
        return float(value)
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise DataMapError(f"field {name!r}: expected int, got {value!r}")
        return value
    if typ is bool:
        if not isinstance(value, bool):
            raise DataMapError(f"field {name!r}: expected bool, got {value!r}")
        return value
    if typ is str:
        if not isinstance(value, str):
            raise DataMapError(f"field {name!r}: expected str, got {value!r}")
        return value
    if typ is datetime:
        return parse_event_time(value)
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return _extract_dataclass(value, typ)
    return value


def _extract_dataclass(fields: Mapping[str, Any], cls: Type[T]) -> T:
    kwargs = {}
    for f in dataclasses.fields(cls):  # type: ignore[arg-type]
        if f.name in fields:
            kwargs[f.name] = _coerce(fields[f.name], f.type if not isinstance(f.type, str) else None, f.name)
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
            raise DataMapError(f"field {f.name!r} is required by {cls.__name__}")
    return cls(**kwargs)  # type: ignore[return-value]


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
    """Immutable property bag; keys are property names, values JSON values.

    Deliberately NOT a ``collections.abc.Mapping``: ``get`` here is the typed
    mandatory accessor (raising on absence, reference DataMap.get), which
    would violate the Mapping.get contract.  Use ``get_opt``/``get_or_else``
    for optional access and ``.fields`` for a plain dict.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields or {})

    def __getitem__(self, name: str) -> Any:
        return self._fields[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, name: object) -> bool:
        return name in self._fields

    # -- accessors -----------------------------------------------------------
    @property
    def fields(self) -> dict[str, Any]:
        return dict(self._fields)

    def keyset(self) -> set[str]:
        return set(self._fields)

    def is_empty(self) -> bool:
        return not self._fields

    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def get(self, name: str, typ: Type[T] = object) -> T:  # type: ignore[assignment]
        """Mandatory typed accessor; raises if missing or null."""
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapError(f"The required field {name} cannot be null.")
        return _coerce(value, typ, name)

    def get_opt(self, name: str, typ: Type[T] = object) -> T | None:  # type: ignore[assignment]
        value = self._fields.get(name)
        if value is None:
            return None
        return _coerce(value, typ, name)

    def get_or_else(self, name: str, default: T, typ: Type[T] = object) -> T:  # type: ignore[assignment]
        value = self.get_opt(name, typ)
        return default if value is None else value

    def extract(self, cls: Type[T]) -> T:
        """Extract the whole map into a dataclass instance (JsonExtractor role)."""
        return _extract_dataclass(self._fields, cls)

    # -- operators -----------------------------------------------------------
    def __add__(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """Merge; right side wins on key conflict (reference ``++``)."""
        merged = dict(self._fields)
        merged.update(other.fields if isinstance(other, DataMap) else other)
        return type(self)._with_fields(self, merged)

    def __sub__(self, keys: Iterable[str]) -> "DataMap":
        """Remove keys (reference ``--``)."""
        drop = set(keys)
        return type(self)._with_fields(
            self, {k: v for k, v in self._fields.items() if k not in drop}
        )

    def _with_fields(self, fields: dict[str, Any]) -> "DataMap":
        return DataMap(fields)

    # -- serialization -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True, default=_json_default)

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        return cls(json.loads(s))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DataMap) and self._fields == other._fields

    def __hash__(self) -> int:
        return hash(self.to_json())

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


def _json_default(o: Any) -> Any:
    if isinstance(o, datetime):
        return format_event_time(o)
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class PropertyMap(DataMap):
    """DataMap plus the first/last update times of the aggregated entity.

    Produced by folding $set/$unset/$delete event streams
    (reference: data/.../storage/PropertyMap.scala:33).
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: datetime,
        last_updated: datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def _with_fields(self, fields: dict[str, Any]) -> "PropertyMap":
        return PropertyMap(fields, self.first_updated, self.last_updated)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, PropertyMap)
            and self._fields == other._fields
            and self.first_updated == other.first_updated
            and self.last_updated == other.last_updated
        )

    def __hash__(self) -> int:
        return hash((self.to_json(), self.first_updated, self.last_updated))

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first={self.first_updated}, "
            f"last={self.last_updated})"
        )
