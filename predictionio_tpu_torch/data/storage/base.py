"""Storage contracts of the train and deploy paths.

- Metadata: the app, access-key and channel records with their DAOs, and
  the engine-instance record (the deploy handle).
- Events: :class:`EventFilter`, the row DAO :class:`LEvents` (``init``,
  ``remove``, ``close``, ``insert``, ``insert_batch``, ``get``,
  ``delete``, ``find``, and the serving path's ``find_by_entity`` and
  ``aggregate_properties``) and the columnar bulk DAO :class:`PEvents`,
  whose ``find`` returns an :class:`EventFrame` (the JAX package's frame
  and ``concat_frames``), whose ``write``/``delete``
  take frames and id lists, and whose ``aggregate_properties`` folds
  ``$set``/``$unset``/``$delete``.
- Models: the blob store with its multipart (manifest + named parts)
  layout, the JAX package's byte for byte (``<id>:manifest`` framed by the
  sorted part-name list, ``<id>:part:<name>`` per part), so either package
  reads a checkpoint the other wrote.
"""

from __future__ import annotations

import abc
import hashlib
import json
from dataclasses import dataclass, field, fields, replace
from datetime import datetime, timezone
from typing import Any, Iterable, Iterator, Mapping, Sequence

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
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]: ...

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

    def delete_parts(self, instance_id: str) -> bool:
        raw = self.get(f"{instance_id}:manifest")
        if raw is None:
            return False
        for name in _manifest_part_names(raw):
            self.delete(f"{instance_id}:part:{name}")
        return self.delete(f"{instance_id}:manifest")

    def delete_models(self, instance_id: str) -> bool:
        """Remove a checkpoint in either layout (sharded parts and/or the
        single blob): the deletion entry point for cleanup paths."""
        had_parts = self.delete_parts(instance_id)
        had_blob = self.delete(instance_id)
        return had_parts or had_blob


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

    @classmethod
    def from_events(cls, events: Iterable[Event]) -> "EventFrame":
        evs = list(events)
        n = len(evs)

        def col(f, dtype=object):
            a = np.empty(n, dtype=dtype)
            for i, e in enumerate(evs):
                a[i] = f(e)
            return a

        return cls(
            event=col(lambda e: e.event),
            entity_type=col(lambda e: e.entity_type),
            entity_id=col(lambda e: e.entity_id),
            target_entity_type=col(lambda e: e.target_entity_type),
            target_entity_id=col(lambda e: e.target_entity_id),
            event_time_ms=np.fromiter(
                (_to_ms(e.event_time) for e in evs), dtype=np.int64, count=n
            ),
            properties=col(lambda e: e.properties.fields),
            event_id=col(lambda e: e.event_id),
            tags=col(lambda e: e.tags),
            pr_id=col(lambda e: e.pr_id),
            creation_time_ms=np.fromiter(
                (_to_ms(e.creation_time) for e in evs), dtype=np.int64, count=n
            ),
        )

    def select(self, mask: np.ndarray) -> "EventFrame":
        """Rows where ``mask`` holds (the JAX package's name for
        :meth:`take` with a boolean mask)."""
        return self.take(mask)

    def where_event(self, *names: str) -> "EventFrame":
        return self.select(np.isin(self.event, list(names)))

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


def entity_shard(entity_type: str, entity_id: str, n_shards: int) -> int:
    """The HBEventsUtil.scala:83 row-key hash, reduced to a shard index:
    the md5 of ``f"{entity_type}-{entity_id}"``, its first four bytes
    big-endian, modulo ``n_shards``.  The JAX package's function bit for
    bit: the canary split (``lifecycle.canary``) keys on it, so a user
    lands on the same side of a split in either package."""
    digest = hashlib.md5(f"{entity_type}-{entity_id}".encode()).digest()
    return int.from_bytes(digest[:4], "big") % n_shards


def run_concurrent(executor, thunks: Sequence) -> list:
    """Run thunks on the executor and join them all, then surface the
    first error: the fan-out idiom of the parquet backend's per-shard
    segment writes and the remote fleet's per-daemon calls (joining
    everything first keeps a partial failure from orphaning in-flight
    writes)."""
    if len(thunks) == 1:
        return [thunks[0]()]
    futs = [executor.submit(t) for t in thunks]
    out, errs = [], []
    for f in futs:
        try:
            out.append(f.result())
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
    if errs:
        raise errs[0]
    return out


def obj_ptrs(col: np.ndarray) -> np.ndarray | None:
    """int64 view of an object array's PyObject pointers (read-only; the
    caller keeps ``col`` alive while using the view), or None for any
    other array.

    Pointer equality implies value equality, so a pointer-level
    factorization is a conservative dictionary encode: bulk columns are
    built as ``vocabulary[codes]`` (one Python object per unique value,
    broadcast), and 8-byte pointers sort far faster than the strings or
    dicts they point to.  Distinct but equal objects merely split a
    dictionary entry."""
    if col.dtype != object or col.itemsize != 8 or len(col) == 0:
        return None
    import ctypes

    buf = (ctypes.c_char * (len(col) * col.itemsize)).from_address(
        col.ctypes.data
    )
    return np.frombuffer(buf, dtype=np.int64)


#: pointer factorization: the leading rows whose distinct pointers are
#: looked up first (a column of a few objects never pays a full sort)
_PTR_SAMPLE = 65536
#: ... when they are at most this many
_PTR_FEW = 4096


def _ptr_codes(
    col: np.ndarray, max_card_frac: float, sample_only: bool = False
) -> tuple[np.ndarray, np.ndarray] | None:
    """(codes, first row of each code) by pointer identity, or None.  The
    pointers of a leading sample are sorted first; when every row's
    pointer is among them, a binary search codes the column (a few
    objects: no sort of the whole column), and a sample of nearly distinct
    pointers ends the pass; ``sample_only`` gives None rather than sort the
    whole column."""
    ptrs = obj_ptrs(col)
    if ptrs is None:
        return None
    n = len(ptrs)
    limit = max(int(n * max_card_frac), 64)
    uniq_ptrs, first = np.unique(ptrs[:_PTR_SAMPLE], return_index=True)
    if len(uniq_ptrs) > limit or (
        n > _PTR_SAMPLE and len(uniq_ptrs) * 10 > _PTR_SAMPLE * 9
    ):
        return None
    if len(uniq_ptrs) <= _PTR_FEW:
        codes = np.searchsorted(uniq_ptrs, ptrs)
        codes[codes == len(uniq_ptrs)] = 0
        covered = bool((uniq_ptrs[codes] == ptrs).all())
    else:
        covered = False
    if not covered:  # pointers past the sample, or too many to search
        if sample_only:
            return None
        uniq_ptrs, first, codes = np.unique(
            ptrs, return_index=True, return_inverse=True
        )
        if len(uniq_ptrs) > limit:
            return None
    return codes.reshape(-1).astype(np.int64, copy=False), first


def ptr_factorize(
    col: np.ndarray, max_card_frac: float = 0.25, sample_only: bool = False
) -> tuple[np.ndarray, np.ndarray] | None:
    """(codes int64, unique objects) by pointer identity, or None when the
    column is mostly distinct at the pointer level (more than
    ``max_card_frac`` of its rows, and more than 64), or with
    ``sample_only`` when its leading rows do not hold every object.  The
    JAX package's contract with numpy alone: uniques come in pointer
    order, not first occurrence, which no caller reads."""
    col = np.ascontiguousarray(col)
    f = _ptr_codes(col, max_card_frac, sample_only)
    if f is None:
        return None
    codes, first = f
    return codes, col[first]


def value_factorize(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes int64, unique values) by value equality, uniques in first
    occurrence order (``pandas.factorize``'s order; None is a value here):
    the pointer pass when it collapses the column, its uniques then merged
    by value, else one dict pass over the rows."""
    col = np.ascontiguousarray(col)
    seen: dict = {}
    f = _ptr_codes(col, 0.25)
    if f is None:
        codes = np.fromiter(
            (seen.setdefault(v, len(seen)) for v in col), np.int64, len(col)
        )
        values = np.empty(len(seen), object)
        values[:] = list(seen)
        return codes, values
    codes, first = f
    remap = np.fromiter(
        (seen.setdefault(v, len(seen)) for v in col[first]),
        np.int64,
        len(first),
    )
    # a merged value's first row is the least first row of its pointers
    first_row = np.full(len(seen), len(col), np.int64)
    np.minimum.at(first_row, remap, first)
    order = np.argsort(first_row, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    values = np.empty(len(seen), object)
    values[:] = list(seen)
    return rank[remap][codes], values[order]


def frame_shard_of(
    entity_type_col: np.ndarray | None,
    entity_id_col: np.ndarray | None,
    n_shards: int,
    factorized: tuple[tuple, tuple] | None = None,
) -> np.ndarray:
    """Vectorized :func:`entity_shard` over frame columns: the md5 of each
    unique (type, id) pair once (entities are ~100x fewer than events),
    broadcast through the pair codes.  The JAX package's function with
    numpy in place of pandas: the shard of every row is the same.

    ``factorized`` lets a caller that already factorized the two columns
    skip that pass: ``((tcode, utypes), (icode, uids))``."""
    if factorized is not None:
        (tcode, utypes), (icode, uids) = factorized
    else:
        tcode, utypes = value_factorize(entity_type_col)
        icode, uids = value_factorize(entity_id_col)
    nid = max(len(uids), 1)
    upairs, inv = np.unique(
        np.asarray(tcode, np.int64) * nid + np.asarray(icode, np.int64),
        return_inverse=True,
    )
    shard_of_uniq = np.fromiter(
        (
            entity_shard(utypes[c // nid], uids[c % nid], n_shards)
            for c in upairs.tolist()
        ),
        np.int64,
        len(upairs),
    )
    return shard_of_uniq[inv.reshape(-1)]


def _to_ms(dt: datetime) -> int:
    return int(dt.timestamp() * 1000)


def concat_frames(frames: Sequence[EventFrame]) -> EventFrame:
    """Row-wise concatenation of EventFrames (all columns).  An optional
    column is kept only when every input carries it: mixing frames from
    different backends would otherwise fabricate ids or tags for some
    rows."""
    frames = [f for f in frames if len(f)]
    if not frames:
        return EventFrame.from_events([])
    if len(frames) == 1:
        return frames[0]
    cols = {}
    for fld in fields(EventFrame):
        vals = [getattr(f, fld.name) for f in frames]
        cols[fld.name] = (
            np.concatenate(vals) if all(v is not None for v in vals) else None
        )
    return EventFrame(**cols)


class PEvents(abc.ABC):
    """Bulk columnar event access (PEvents.scala:38)."""

    def n_shards(self, app_id: int, channel_id: int | None = None) -> int:
        """Entity-hash scan-shard count of this app's layout (1 =
        unsharded): part of the contract so shard-addressed consumers (the
        storage daemon's ``/shards`` route) never reach into a backend's
        internals for it."""
        return 1

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
