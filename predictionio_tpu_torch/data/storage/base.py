"""Storage contracts of the train and deploy paths.

- Metadata: the app, access-key and channel records with their DAOs, and
  the engine-instance record (the deploy handle).
- Events: :class:`EventFilter`, the row DAO :class:`LEvents` (``init``,
  ``remove``, ``close``, ``insert``, ``insert_batch``, ``get``,
  ``delete``, ``find``, and the serving path's ``find_by_entity`` and
  ``aggregate_properties``) and the columnar bulk DAO :class:`PEvents`,
  whose ``find`` returns an :class:`EventFrame`, the subset of the JAX
  package's frame that the templates read, whose ``write``/``delete``
  take frames and id lists, and whose ``aggregate_properties`` folds
  ``$set``/``$unset``/``$delete``.
- Models: the blob store with its multipart (manifest + named parts)
  layout, the JAX package's byte for byte (``<id>:manifest`` framed by the
  sorted part-name list, ``<id>:part:<name>`` per part), so either package
  reads a checkpoint the other wrote.
"""

from __future__ import annotations

import abc
import json
from dataclasses import dataclass, field, fields, replace
from datetime import datetime, timezone
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import Event


@dataclass(frozen=True)
class App:
    id: int
    name: str
    description: str | None = None


@dataclass(frozen=True)
class AccessKey:
    key: str
    appid: int
    events: tuple[str, ...] = ()  # empty = all events allowed


@dataclass(frozen=True)
class Channel:
    id: int
    name: str
    appid: int

    def __post_init__(self):
        if not channel_name_is_valid(self.name):
            raise ValueError(
                f"invalid channel name {self.name!r}: must be 1-16 chars of "
                "[a-zA-Z0-9-]"
            )


def channel_name_is_valid(name: str) -> bool:
    """Channel naming rule from the reference (Channels.scala: 1-16 word chars/hyphen)."""
    if not 1 <= len(name) <= 16:
        return False
    return all(c.isalnum() or c == "-" for c in name)


@dataclass(frozen=True)
class EngineInstance:
    """Record of one training run — the deploy handle.

    Mirrors EngineInstances.scala:46: every parameter that produced the model
    is frozen into this row as JSON.
    """

    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: datetime
    end_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, Any] = field(default_factory=dict)
    datasource_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"

    def completed(self) -> "EngineInstance":
        return replace(
            self, status="COMPLETED", end_time=datetime.now(tz=timezone.utc)
        )


@dataclass(frozen=True)
class EvaluationInstance:
    """Record of one evaluation run (EvaluationInstances.scala:42)."""

    id: str
    status: str  # INIT | EVALUATING | EVALCOMPLETED | FAILED
    start_time: datetime
    end_time: datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""  # one-liner
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> int | None: ...

    @abc.abstractmethod
    def get(self, app_id: int) -> App | None: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> App | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> str | None: ...

    @abc.abstractmethod
    def get(self, key: str) -> AccessKey | None: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> list[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> int | None: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Channel | None: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None: ...

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EvaluationInstance | None: ...

    @abc.abstractmethod
    def get_all(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class Models(abc.ABC):
    """Model blob store keyed by engine-instance id (Models.scala:33).

    Besides the single-blob contract, every backend supports the multipart
    checkpoint layout: each part is an ordinary keyed blob
    (``<id>:part:<name>``) and the manifest is written last as the commit
    point.
    """

    @abc.abstractmethod
    def insert(self, instance_id: str, blob: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> bytes | None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...

    # -- multipart (sharded checkpoints) -------------------------------------
    def insert_parts(
        self, instance_id: str, manifest: bytes, parts: Mapping[str, bytes]
    ) -> None:
        # re-saving an id: drop the old manifest FIRST so readers see
        # "absent" rather than the old part list paired with new bytes,
        # then remove the old parts so fewer new parts leak no orphans
        old = self.get(f"{instance_id}:manifest")
        if old is not None:
            self.delete(f"{instance_id}:manifest")
            for name in _manifest_part_names(old):
                self.delete(f"{instance_id}:part:{name}")
        for name, blob in parts.items():
            self.insert(f"{instance_id}:part:{name}", blob)
        # manifest last: readers treat its presence as "all parts written"
        self.insert(f"{instance_id}:manifest", _manifest_blob(manifest, parts))

    def get_manifest(self, instance_id: str) -> bytes | None:
        raw = self.get(f"{instance_id}:manifest")
        return None if raw is None else _manifest_payload(raw)

    def get_part(self, instance_id: str, name: str) -> bytes | None:
        return self.get(f"{instance_id}:part:{name}")


def _manifest_blob(manifest: bytes, parts: Mapping[str, bytes]) -> bytes:
    """Frame the part-name list in front of the manifest payload so a
    cleanup can enumerate parts without deserializing models."""
    names = ",".join(sorted(parts)).encode()
    return len(names).to_bytes(4, "big") + names + manifest


def _manifest_payload(raw: bytes) -> bytes:
    n = int.from_bytes(raw[:4], "big")
    return raw[4 + n:]


def _manifest_part_names(raw: bytes) -> list[str]:
    n = int.from_bytes(raw[:4], "big")
    names = raw[4 : 4 + n].decode()
    return names.split(",") if names else []


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EventFilter:
    """The find() filter shared by both DAO shapes (LEvents.futureFind,
    LEvents.scala:188): time window [start_time, until_time), entity,
    event-name list, target entity, limit (None = all), reversed order."""

    start_time: datetime | None = None
    until_time: datetime | None = None
    entity_type: str | None = None
    entity_id: str | None = None
    event_names: tuple[str, ...] | None = None
    target_entity_type: str | None = None  # "" matches None-valued target
    target_entity_id: str | None = None
    limit: int | None = None
    reversed: bool = False

    def matches(self, e: Event) -> bool:
        """The filter applied to one event in memory (limit and order
        aside)."""
        if self.start_time is not None and e.event_time < self.start_time:
            return False
        if self.until_time is not None and e.event_time >= self.until_time:
            return False
        if self.entity_type is not None and e.entity_type != self.entity_type:
            return False
        if self.entity_id is not None and e.entity_id != self.entity_id:
            return False
        if self.event_names is not None and e.event not in self.event_names:
            return False
        if self.target_entity_type is not None:
            if e.target_entity_type != (self.target_entity_type or None):
                return False
        if self.target_entity_id is not None:
            if e.target_entity_id != (self.target_entity_id or None):
                return False
        return True


_AGGREGATOR_EVENTS = ("$set", "$unset", "$delete")


def _required_only(
    result: dict[str, PropertyMap], required: Sequence[str] | None
) -> dict[str, PropertyMap]:
    if not required:
        return result
    req = set(required)
    return {k: v for k, v in result.items() if req.issubset(v.keyset())}


class LEvents(abc.ABC):
    """Row-at-a-time event CRUD and queries per (app_id, channel_id)
    namespace (LEvents.scala:90-280): the event server's single-event
    routes, the import and train paths, and the per-entity reads of
    serving-time business rules."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        """Create the namespace (table) of an app/channel."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        """Drop all events of an app/channel."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        """Insert one event, returning its id; an event carrying an existing
        ``event_id`` replaces that row."""

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """Insert events, returning their ids, as :meth:`insert` does."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None: ...

    @abc.abstractmethod
    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> Iterator[Event]: ...

    def find_by_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Per-entity history, the serving-path access pattern (business
        rules): ``find`` with an entity-pinned filter."""
        return self.find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=tuple(event_names) if event_names else None,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=reversed,
            ),
        )

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """Fold $set/$unset/$delete into per-entity property maps
        (LEvents.futureAggregateProperties, LEvents.scala:215); entities
        lacking any ``required`` key are left out."""
        if not entity_type:
            raise ValueError("aggregate_properties requires a non-empty entity_type")
        events = self.find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                event_names=_AGGREGATOR_EVENTS,
            ),
        )
        return _required_only(aggregate_properties(events), required)


def _coerce_numeric(v) -> float | None:
    """The ``float(props[name])`` coercion of the row-wise engine loops:
    ints/floats pass, bools become 0/1, numeric strings parse; everything
    else is not a number (None)."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def _row_value(p, name: str) -> float | None:
    """One row's coerced property (None = absent or malformed); ``p`` is a
    dict or a lazy row, its JSON text ("" = no properties)."""
    if isinstance(p, str):
        if not p:
            return None
        try:
            p = json.loads(p)
        except json.JSONDecodeError:
            return None  # junk row -> no properties
    return _coerce_numeric(p.get(name) if isinstance(p, dict) else None)


@dataclass
class EventFrame:
    """A columnar batch of events (the reference's ``RDD[Event]``,
    PEvents.scala:80): numpy columns, strings as object arrays, times as
    int64 epoch millis.  ``properties`` holds dicts or lazy rows (the
    serialized JSON document, "" = empty) that bulk scans leave undecoded;
    :meth:`property_column` reads one numeric property out of them."""

    event: np.ndarray  # object[str]
    entity_type: np.ndarray  # object[str]
    entity_id: np.ndarray  # object[str]
    target_entity_type: np.ndarray  # object[str|None]
    target_entity_id: np.ndarray  # object[str|None]
    event_time_ms: np.ndarray  # int64
    properties: np.ndarray  # object[dict | str]
    event_id: np.ndarray | None = None  # object[str|None]
    tags: np.ndarray | None = None  # object[tuple[str,...]]
    pr_id: np.ndarray | None = None  # object[str|None]
    creation_time_ms: np.ndarray | None = None  # int64

    def __len__(self) -> int:
        return len(self.event)

    def take(self, sel) -> "EventFrame":
        """Row subset by boolean mask or index array (all columns)."""
        return EventFrame(
            **{
                f.name: (v[sel] if v is not None else None)
                for f in fields(self)
                for v in [getattr(self, f.name)]
            }
        )

    def property_column(
        self, name: str, default: float = np.nan, dtype=np.float32
    ) -> np.ndarray:
        """One numeric property as a float column, with the JAX package's
        coercion (numeric JSON strings and bools count; absent, junk and
        non-numeric values give ``default``).  Each distinct lazy document
        is parsed once: a rating column holds a handful of them."""
        out = np.full(len(self), default, dtype=dtype)
        parsed: dict[str, float | None] = {}
        for i, p in enumerate(self.properties):
            if isinstance(p, str):
                if p in parsed:
                    v = parsed[p]
                else:
                    v = parsed[p] = _row_value(p, name)
            else:
                v = _row_value(p, name)
            if v is not None:
                out[i] = v
        return out

    def to_events(self) -> list[Event]:
        """The rows as :class:`Event` objects, lazy JSON rows decoded."""
        out = []
        for i in range(len(self)):
            kwargs = {}
            if self.event_id is not None:
                kwargs["event_id"] = self.event_id[i]
            if self.tags is not None and self.tags[i]:
                kwargs["tags"] = tuple(self.tags[i])
            if self.pr_id is not None:
                kwargs["pr_id"] = self.pr_id[i]
            if self.creation_time_ms is not None:
                kwargs["creation_time"] = datetime.fromtimestamp(
                    self.creation_time_ms[i] / 1000.0, tz=timezone.utc
                )
            props = self.properties[i]
            if isinstance(props, str):  # lazy raw-JSON row
                props = json.loads(props) if props else {}
            out.append(
                Event(
                    event=self.event[i],
                    entity_type=self.entity_type[i],
                    entity_id=self.entity_id[i],
                    target_entity_type=self.target_entity_type[i],
                    target_entity_id=self.target_entity_id[i],
                    properties=DataMap(props or {}),
                    event_time=datetime.fromtimestamp(
                        self.event_time_ms[i] / 1000.0, tz=timezone.utc
                    ),
                    **kwargs,
                )
            )
        return out


class PEvents(abc.ABC):
    """Bulk columnar event access (PEvents.scala:38)."""

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> EventFrame: ...

    @abc.abstractmethod
    def write(
        self, frame: EventFrame, app_id: int, channel_id: int | None = None
    ) -> None: ...

    @abc.abstractmethod
    def delete(
        self, event_ids: Sequence[str], app_id: int, channel_id: int | None = None
    ) -> None: ...

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: int | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        """:meth:`LEvents.aggregate_properties` over one bulk scan."""
        if not entity_type:
            raise ValueError("aggregate_properties requires a non-empty entity_type")
        frame = self.find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                event_names=_AGGREGATOR_EVENTS,
            ),
        )
        return _required_only(aggregate_properties(frame.to_events()), required)
