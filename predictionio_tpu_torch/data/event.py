"""The Event record and its validation rules.

The JAX package's ``data/event.py``: the reference's event model
(data/.../storage/Event.scala:42) and the validation semantics of
EventValidation (Event.scala:68): reserved ``$`` and ``pio_`` prefixes, the
special ``$set``/``$unset``/``$delete`` events, paired target-entity fields,
and property-name restrictions.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Any, Mapping, Sequence

from predictionio_tpu_torch.data.datamap import (
    DataMap,
    format_event_time,
    parse_event_time,
)

#: Event names reserved by the framework for entity property mutation.
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})

#: Entity types with a reserved prefix that are nevertheless allowed.
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})

#: Reserved property names that are allowed (currently none).
BUILTIN_PROPERTIES: frozenset[str] = frozenset()


class EventValidationError(ValueError):
    """An event violates the data-model invariants."""


def _now() -> datetime:
    return datetime.now(tz=timezone.utc)


def is_reserved_prefix(name: str) -> bool:
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


@dataclass(frozen=True)
class Event:
    """A single immutable event in the event store."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: datetime = field(default_factory=_now)
    tags: tuple[str, ...] = ()
    pr_id: str | None = None
    event_id: str | None = None
    creation_time: datetime = field(default_factory=_now)

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        for attr in ("event_time", "creation_time"):
            t = getattr(self, attr)
            if t.tzinfo is None:
                object.__setattr__(self, attr, t.replace(tzinfo=timezone.utc))

    def with_id(self, event_id: str | None = None) -> "Event":
        return replace(self, event_id=event_id or uuid.uuid4().hex)

    def to_api_dict(self) -> dict[str, Any]:
        """Serialize in the REST API format (EventJson4sSupport's apiSerializer)."""
        d: dict[str, Any] = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.fields,
            "eventTime": format_event_time(self.event_time),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        d["creationTime"] = format_event_time(self.creation_time)
        return d

    @classmethod
    def from_api_dict(cls, d: Mapping[str, Any]) -> "Event":
        """Parse the REST API JSON format, raising EventValidationError on junk."""
        try:
            event = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from None
        for name in ("event", "entityType", "entityId"):
            if not isinstance(d[name], str):
                raise EventValidationError(f"field {name} must be a string")
        props = d.get("properties") or {}
        if not isinstance(props, Mapping):
            raise EventValidationError("properties must be a JSON object")
        tags = d.get("tags") or []
        if not isinstance(tags, Sequence) or isinstance(tags, str):
            raise EventValidationError("tags must be a list of strings")
        try:
            event_time = (
                parse_event_time(d["eventTime"]) if "eventTime" in d else _now()
            )
            creation_time = (
                parse_event_time(d["creationTime"]) if "creationTime" in d else _now()
            )
        except Exception as e:
            raise EventValidationError(f"bad timestamp: {e}") from None
        ev = cls(
            event=event,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(props),
            event_time=event_time,
            tags=tuple(tags),
            pr_id=d.get("prId"),
            event_id=d.get("eventId"),
            creation_time=creation_time,
        )
        validate_event(ev)
        return ev


def validate_event(e: Event) -> None:
    """Enforce the event invariants (reference EventValidation.validate).

    Raises EventValidationError when:
      - event / entityType / entityId is empty
      - targetEntityType/Id is an empty string or specified without the other
      - a ``$unset`` event has empty properties
      - the event name has a reserved prefix but is not a special event
      - a special event carries a target entity
      - entityType / targetEntityType has a reserved prefix and is not built-in
      - any property name has a reserved prefix and is not built-in
    """

    def check(ok: bool, msg: str) -> None:
        if not ok:
            raise EventValidationError(msg)

    check(bool(e.event), "event must not be empty.")
    check(bool(e.entity_type), "entityType must not be empty string.")
    check(bool(e.entity_id), "entityId must not be empty string.")
    check(e.target_entity_type != "", "targetEntityType must not be empty string")
    check(e.target_entity_id != "", "targetEntityId must not be empty string.")
    check(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    check(
        not (e.event == "$unset" and e.properties.is_empty()),
        "properties cannot be empty for $unset event",
    )
    check(
        not is_reserved_prefix(e.event) or is_special_event(e.event),
        f"{e.event} is not a supported reserved event name.",
    )
    check(
        not is_special_event(e.event)
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    check(
        not is_reserved_prefix(e.entity_type) or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    check(
        e.target_entity_type is None
        or not is_reserved_prefix(e.target_entity_type)
        or e.target_entity_type in BUILTIN_ENTITY_TYPES,
        f"The targetEntityType {e.target_entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    for k in e.properties.keyset():
        check(
            not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )
