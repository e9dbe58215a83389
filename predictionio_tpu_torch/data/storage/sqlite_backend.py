"""SQLite events, metadata and model blobs: the subset of the JAX package's
sqlite backend that the train, eval and deploy paths use.

Same tables, same columns, same encodings (one event table per app and
channel, ``pio_event_<appId>[_<channelId>]``; times in epoch milliseconds;
properties, env and mesh config as JSON), so either package reads the
events, apps, instances and models the other wrote to a
``$PIO_HOME/pio.sqlite``.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFilter,
    EventFrame,
)

_EVENT_COLS = (
    "id, event, entityType, entityId, targetEntityType, targetEntityId, "
    "properties, eventTime, tags, prId, creationTime"
)


def _ms(dt: datetime) -> int:
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)  # naive timestamps are UTC everywhere
    return int(dt.timestamp() * 1000)


def _from_ms(ms: int) -> datetime:
    return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)


class SQLiteClient:
    """One connection + lock shared by all DAOs of a storage source."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self.conn = sqlite3.connect(self.path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute("PRAGMA synchronous=NORMAL")
        self.lock = threading.RLock()

    def execute(self, sql: str, params: Sequence = ()) -> sqlite3.Cursor:
        with self.lock:
            cur = self.conn.execute(sql, params)
            self.conn.commit()
            return cur

    def executemany(self, sql: str, rows: Sequence[Sequence]) -> None:
        with self.lock:
            self.conn.executemany(sql, rows)
            self.conn.commit()

    def query(self, sql: str, params: Sequence = ()) -> list[tuple]:
        with self.lock:
            return self.conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self.lock:
            self.conn.close()


#: the metadata and model tables, with the JAX package's DDL byte for byte
#: (its ``SQLiteMetadata``), so ``sqlite_master`` reads the same whichever
#: package made the database
_METADATA_DDL = (
    """CREATE TABLE IF NOT EXISTS pio_apps (
               id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL,
               description TEXT)""",
    """CREATE TABLE IF NOT EXISTS pio_access_keys (
               accesskey TEXT PRIMARY KEY, appid INTEGER NOT NULL, events TEXT)""",
    """CREATE TABLE IF NOT EXISTS pio_channels (
               id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL,
               appid INTEGER NOT NULL)""",
    """CREATE TABLE IF NOT EXISTS pio_engine_instances (
               id TEXT PRIMARY KEY, status TEXT, startTime INTEGER,
               endTime INTEGER, engineId TEXT, engineVersion TEXT,
               engineVariant TEXT, engineFactory TEXT, batch TEXT,
               env TEXT, meshConf TEXT, dataSourceParams TEXT,
               preparatorParams TEXT, algorithmsParams TEXT, servingParams TEXT)""",
    """CREATE TABLE IF NOT EXISTS pio_evaluation_instances (
               id TEXT PRIMARY KEY, status TEXT, startTime INTEGER,
               endTime INTEGER, evaluationClass TEXT,
               engineParamsGeneratorClass TEXT, batch TEXT, env TEXT,
               evaluatorResults TEXT, evaluatorResultsHTML TEXT,
               evaluatorResultsJSON TEXT)""",
    """CREATE TABLE IF NOT EXISTS pio_models (
               id TEXT PRIMARY KEY, models BLOB NOT NULL)""",
)


def create_tables(client: SQLiteClient) -> None:
    """Create the metadata and model tables (:data:`_METADATA_DDL`)."""
    for ddl in _METADATA_DDL:
        client.execute(ddl)


class SQLiteMetadata:
    """Creates the metadata tables once per client (the JAX package's
    class of that name)."""

    def __init__(self, client: SQLiteClient):
        self.client = client
        create_tables(client)


def _ei_to_row(i: EngineInstance) -> tuple:
    return (
        i.id,
        i.status,
        _ms(i.start_time),
        _ms(i.end_time),
        i.engine_id,
        i.engine_version,
        i.engine_variant,
        i.engine_factory,
        i.batch,
        json.dumps(i.env),
        json.dumps(i.mesh_conf),
        i.datasource_params,
        i.preparator_params,
        i.algorithms_params,
        i.serving_params,
    )


def _ei_from_row(r: tuple) -> EngineInstance:
    return EngineInstance(
        id=r[0],
        status=r[1],
        start_time=_from_ms(r[2]),
        end_time=_from_ms(r[3]),
        engine_id=r[4],
        engine_version=r[5],
        engine_variant=r[6],
        engine_factory=r[7],
        batch=r[8] or "",
        env=json.loads(r[9]) if r[9] else {},
        mesh_conf=json.loads(r[10]) if r[10] else {},
        datasource_params=r[11] or "{}",
        preparator_params=r[12] or "{}",
        algorithms_params=r[13] or "[]",
        serving_params=r[14] or "{}",
    )


class SQLiteEngineInstances(base.EngineInstances):
    _COLS = (
        "id, status, startTime, endTime, engineId, engineVersion, engineVariant, "
        "engineFactory, batch, env, meshConf, dataSourceParams, preparatorParams, "
        "algorithmsParams, servingParams"
    )

    def __init__(self, client: SQLiteClient):
        self.client = client

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        if i.id != iid:
            i = dataclasses.replace(i, id=iid)
        self.client.execute(
            f"INSERT OR REPLACE INTO pio_engine_instances ({self._COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            _ei_to_row(i),
        )
        return iid

    def get(self, instance_id: str) -> EngineInstance | None:
        rows = self.client.query(
            f"SELECT {self._COLS} FROM pio_engine_instances WHERE id = ?",
            (instance_id,),
        )
        return _ei_from_row(rows[0]) if rows else None

    def get_all(self) -> list[EngineInstance]:
        return [
            _ei_from_row(r)
            for r in self.client.query(
                f"SELECT {self._COLS} FROM pio_engine_instances "
                "ORDER BY startTime DESC"
            )
        ]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        rows = self.client.query(
            f"SELECT {self._COLS} FROM pio_engine_instances "
            "WHERE status = 'COMPLETED' AND engineId = ? AND "
            "engineVersion = ? AND engineVariant = ? ORDER BY startTime DESC "
            "LIMIT 1",
            (engine_id, engine_version, engine_variant),
        )
        return _ei_from_row(rows[0]) if rows else None

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return [
            _ei_from_row(r)
            for r in self.client.query(
                f"SELECT {self._COLS} FROM pio_engine_instances "
                "WHERE status = 'COMPLETED' AND engineId = ? AND "
                "engineVersion = ? AND engineVariant = ? ORDER BY startTime DESC",
                (engine_id, engine_version, engine_variant),
            )
        ]

    def update(self, i: EngineInstance) -> bool:
        self.insert(i)
        return True

    def delete(self, instance_id: str) -> bool:
        cur = self.client.execute(
            "DELETE FROM pio_engine_instances WHERE id = ?", (instance_id,)
        )
        return cur.rowcount > 0


class SQLiteEvaluationInstances(base.EvaluationInstances):
    _COLS = (
        "id, status, startTime, endTime, evaluationClass, "
        "engineParamsGeneratorClass, batch, env, evaluatorResults, "
        "evaluatorResultsHTML, evaluatorResultsJSON"
    )

    def __init__(self, client: SQLiteClient):
        self.client = client

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        self.client.execute(
            f"INSERT OR REPLACE INTO pio_evaluation_instances ({self._COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (
                iid,
                i.status,
                _ms(i.start_time),
                _ms(i.end_time),
                i.evaluation_class,
                i.engine_params_generator_class,
                i.batch,
                json.dumps(i.env),
                i.evaluator_results,
                i.evaluator_results_html,
                i.evaluator_results_json,
            ),
        )
        return iid

    @staticmethod
    def _row(r: tuple) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0],
            status=r[1],
            start_time=_from_ms(r[2]),
            end_time=_from_ms(r[3]),
            evaluation_class=r[4] or "",
            engine_params_generator_class=r[5] or "",
            batch=r[6] or "",
            env=json.loads(r[7]) if r[7] else {},
            evaluator_results=r[8] or "",
            evaluator_results_html=r[9] or "",
            evaluator_results_json=r[10] or "",
        )

    def get(self, instance_id: str) -> EvaluationInstance | None:
        rows = self.client.query(
            f"SELECT {self._COLS} FROM pio_evaluation_instances WHERE id = ?",
            (instance_id,),
        )
        return self._row(rows[0]) if rows else None

    def get_all(self) -> list[EvaluationInstance]:
        return [
            self._row(r)
            for r in self.client.query(
                f"SELECT {self._COLS} FROM pio_evaluation_instances "
                "ORDER BY startTime DESC"
            )
        ]

    def get_completed(self) -> list[EvaluationInstance]:
        return [
            self._row(r)
            for r in self.client.query(
                f"SELECT {self._COLS} FROM pio_evaluation_instances "
                "WHERE status = 'EVALCOMPLETED' ORDER BY startTime DESC"
            )
        ]

    def update(self, i: EvaluationInstance) -> bool:
        self.insert(i)
        return True

    def delete(self, instance_id: str) -> bool:
        cur = self.client.execute(
            "DELETE FROM pio_evaluation_instances WHERE id = ?", (instance_id,)
        )
        return cur.rowcount > 0


class SQLiteModels(base.Models):
    def __init__(self, client: SQLiteClient):
        self.client = client

    def insert(self, instance_id: str, blob: bytes) -> None:
        self.client.execute(
            "INSERT OR REPLACE INTO pio_models (id, models) VALUES (?, ?)",
            (instance_id, blob),
        )

    def get(self, instance_id: str) -> bytes | None:
        rows = self.client.query(
            "SELECT models FROM pio_models WHERE id = ?", (instance_id,)
        )
        return bytes(rows[0][0]) if rows else None

    def delete(self, instance_id: str) -> bool:
        cur = self.client.execute(
            "DELETE FROM pio_models WHERE id = ?", (instance_id,)
        )
        return cur.rowcount > 0


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


def event_table_name(app_id: int, channel_id: int | None) -> str:
    suffix = f"_{channel_id}" if channel_id is not None else ""
    return f"pio_event_{app_id}{suffix}"


class SQLiteLEvents(base.LEvents):
    def __init__(self, client: SQLiteClient):
        self.client = client
        self._known_tables: set[str] = set()

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        table = event_table_name(app_id, channel_id)
        self.client.execute(
            f"""CREATE TABLE IF NOT EXISTS {table} (
                id TEXT PRIMARY KEY,
                event TEXT NOT NULL,
                entityType TEXT NOT NULL,
                entityId TEXT NOT NULL,
                targetEntityType TEXT,
                targetEntityId TEXT,
                properties TEXT,
                eventTime INTEGER NOT NULL,
                tags TEXT,
                prId TEXT,
                creationTime INTEGER NOT NULL)"""
        )
        self.client.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{table}_time ON {table}(eventTime)"
        )
        self.client.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{table}_entity "
            f"ON {table}(entityType, entityId, eventTime)"
        )
        self._known_tables.add(table)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        table = event_table_name(app_id, channel_id)
        self.client.execute(f"DROP TABLE IF EXISTS {table}")
        self._known_tables.discard(table)
        return True

    def close(self) -> None:
        pass  # the client belongs to the storage runtime

    def _ensure(self, app_id: int, channel_id: int | None) -> str:
        table = event_table_name(app_id, channel_id)
        if table not in self._known_tables:
            self.init(app_id, channel_id)
        return table

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        table = self._ensure(app_id, channel_id)
        eid = event.event_id or uuid.uuid4().hex
        self.client.execute(
            f"INSERT OR REPLACE INTO {table} ({_EVENT_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            self._to_row(event, eid),
        )
        return eid

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        table = self._ensure(app_id, channel_id)
        ids = [e.event_id or uuid.uuid4().hex for e in events]
        self.client.executemany(
            f"INSERT OR REPLACE INTO {table} ({_EVENT_COLS}) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            [self._to_row(e, i) for e, i in zip(events, ids)],
        )
        return ids

    @staticmethod
    def _to_row(e: Event, eid: str) -> tuple:
        return (
            eid,
            e.event,
            e.entity_type,
            e.entity_id,
            e.target_entity_type,
            e.target_entity_id,
            json.dumps(e.properties.fields) if not e.properties.is_empty() else None,
            _ms(e.event_time),
            ",".join(e.tags) if e.tags else None,
            e.pr_id,
            _ms(e.creation_time),
        )

    @staticmethod
    def _from_row(row: tuple) -> Event:
        (eid, name, etype, eid2, ttype, tid, props, etime, tags, prid, ctime) = row
        return Event(
            event=name,
            entity_type=etype,
            entity_id=eid2,
            target_entity_type=ttype,
            target_entity_id=tid,
            properties=DataMap(json.loads(props)) if props else DataMap(),
            event_time=_from_ms(etime),
            tags=tuple(tags.split(",")) if tags else (),
            pr_id=prid,
            event_id=eid,
            creation_time=_from_ms(ctime),
        )

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        table = self._ensure(app_id, channel_id)
        rows = self.client.query(
            f"SELECT {_EVENT_COLS} FROM {table} WHERE id = ?", (event_id,)
        )
        return self._from_row(rows[0]) if rows else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        table = self._ensure(app_id, channel_id)
        cur = self.client.execute(f"DELETE FROM {table} WHERE id = ?", (event_id,))
        return cur.rowcount > 0

    @staticmethod
    def _where(f: EventFilter) -> tuple[str, list]:
        clauses, params = [], []
        if f.start_time is not None:
            clauses.append("eventTime >= ?")
            params.append(_ms(f.start_time))
        if f.until_time is not None:
            clauses.append("eventTime < ?")
            params.append(_ms(f.until_time))
        if f.entity_type is not None:
            clauses.append("entityType = ?")
            params.append(f.entity_type)
        if f.entity_id is not None:
            clauses.append("entityId = ?")
            params.append(f.entity_id)
        if f.event_names is not None:
            marks = ",".join("?" * len(f.event_names))
            clauses.append(f"event IN ({marks})")
            params.extend(f.event_names)
        if f.target_entity_type is not None:
            if f.target_entity_type == "":
                clauses.append("targetEntityType IS NULL")
            else:
                clauses.append("targetEntityType = ?")
                params.append(f.target_entity_type)
        if f.target_entity_id is not None:
            if f.target_entity_id == "":
                clauses.append("targetEntityId IS NULL")
            else:
                clauses.append("targetEntityId = ?")
                params.append(f.target_entity_id)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        return where, params

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> Iterator[Event]:
        table = self._ensure(app_id, channel_id)
        f = filter or EventFilter()
        where, params = self._where(f)
        order = "DESC" if f.reversed else "ASC"
        sql = f"SELECT {_EVENT_COLS} FROM {table}{where} ORDER BY eventTime {order}"
        if f.limit is not None and f.limit >= 0:
            sql += f" LIMIT {int(f.limit)}"
        for row in self.client.query(sql, params):
            yield self._from_row(row)


class SQLitePEvents(base.PEvents):
    """Columnar bulk scan over the same tables as SQLiteLEvents."""

    def __init__(self, client: SQLiteClient, levents: SQLiteLEvents):
        self.client = client
        self.levents = levents

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> EventFrame:
        table = self.levents._ensure(app_id, channel_id)
        f = filter or EventFilter()
        where, params = SQLiteLEvents._where(f)
        order = "DESC" if f.reversed else "ASC"
        sql = (
            f"SELECT event, entityType, entityId, targetEntityType, "
            f"targetEntityId, properties, eventTime, id, tags, prId, "
            f"creationTime FROM {table}{where} ORDER BY eventTime {order}"
        )
        if f.limit is not None and f.limit >= 0:
            sql += f" LIMIT {int(f.limit)}"
        return self._rows_to_frame(self.client.query(sql, params))

    @staticmethod
    def _rows_to_frame(rows) -> EventFrame:
        n = len(rows)
        event = np.empty(n, dtype=object)
        etype = np.empty(n, dtype=object)
        eid = np.empty(n, dtype=object)
        ttype = np.empty(n, dtype=object)
        tid = np.empty(n, dtype=object)
        props = np.empty(n, dtype=object)
        times = np.empty(n, dtype=np.int64)
        ids = np.empty(n, dtype=object)
        tags = np.empty(n, dtype=object)
        prids = np.empty(n, dtype=object)
        ctimes = np.empty(n, dtype=np.int64)
        for i, r in enumerate(rows):
            event[i], etype[i], eid[i], ttype[i], tid[i] = r[0], r[1], r[2], r[3], r[4]
            # the raw JSON stays a lazy row: bulk scans skip per-row
            # json.loads until something needs the dict
            props[i] = r[5] or ""
            times[i] = r[6]
            ids[i] = r[7]
            tags[i] = tuple(r[8].split(",")) if r[8] else ()
            prids[i] = r[9]
            ctimes[i] = r[10]
        return EventFrame(
            event=event,
            entity_type=etype,
            entity_id=eid,
            target_entity_type=ttype,
            target_entity_id=tid,
            event_time_ms=times,
            properties=props,
            event_id=ids,
            tags=tags,
            pr_id=prids,
            creation_time_ms=ctimes,
        )

    def write(
        self, frame: EventFrame, app_id: int, channel_id: int | None = None
    ) -> None:
        self.levents.insert_batch(frame.to_events(), app_id, channel_id)

    def delete(
        self, event_ids: Sequence[str], app_id: int, channel_id: int | None = None
    ) -> None:
        table = self.levents._ensure(app_id, channel_id)
        self.client.executemany(
            f"DELETE FROM {table} WHERE id = ?", [(i,) for i in event_ids]
        )

    # -- entity-hash scan sharding ------------------------------------------
    #: default logical shard count for multi-process scans
    N_SCAN_SHARDS = 8

    def n_shards(self, app_id: int, channel_id: int | None = None) -> int:
        return self.N_SCAN_SHARDS

    def _shard_expr(self, n_shards: int) -> str | None:
        """SQL expression computing the entity-hash shard of a row, or None
        when the dialect can't (scan once + split on the host instead).
        Embedded sqlite has no md5(), and its rows are local anyway."""
        return None

    def iter_shards(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
        shards: Sequence[int] | None = None,
        n_shards: int | None = None,
    ):
        """Yield (shard, EventFrame) by the same md5 entity-hash shard
        function as the parquet layout (HBEventsUtil.scala:83's row-key
        prefix role), so multi-process training splits any event store
        identically: process p consumes ``shards=range(p, n, P)``.

        A dialect that hashes in SQL (Postgres, :meth:`_shard_expr`)
        filters rows on the server, so each process transfers only its own
        shards; sqlite scans once and splits on the host."""
        n = n_shards or self.N_SCAN_SHARDS
        want = list(range(n)) if shards is None else list(shards)
        expr = self._shard_expr(n)
        f = filter or EventFilter()
        # a LIMIT is global across the scan (find() semantics), which a
        # per-shard WHERE cannot express: split on the host so every
        # backend returns the same rows for the same filter
        if expr is None or f.limit is not None:
            frame = self.find(app_id, channel_id, filter)
            shard_of = base.frame_shard_of(
                frame.entity_type, frame.entity_id, n
            )
            for k in want:
                yield k, frame.take(shard_of == k)
            return
        table = self.levents._ensure(app_id, channel_id)
        where, params = SQLiteLEvents._where(f)
        order = "DESC" if f.reversed else "ASC"
        for k in want:
            shard_where = (
                f"{where} AND {expr} = {int(k)}"
                if where
                else f" WHERE {expr} = {int(k)}"
            )
            sql = (
                f"SELECT event, entityType, entityId, targetEntityType, "
                f"targetEntityId, properties, eventTime, id, tags, prId, "
                f"creationTime FROM {table}{shard_where} "
                f"ORDER BY eventTime {order}"
            )
            yield k, self._rows_to_frame(self.client.query(sql, params))


# ---------------------------------------------------------------------------
# App, access-key and channel metadata
# ---------------------------------------------------------------------------


class SQLiteApps(base.Apps):
    def __init__(self, client: SQLiteClient):
        self.client = client

    def insert(self, app: App) -> int | None:
        try:
            cur = self.client.execute(
                "INSERT INTO pio_apps (name, description) VALUES (?, ?)",
                (app.name, app.description),
            )
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id: int) -> App | None:
        rows = self.client.query(
            "SELECT id, name, description FROM pio_apps WHERE id = ?", (app_id,)
        )
        return App(*rows[0]) if rows else None

    def get_by_name(self, name: str) -> App | None:
        rows = self.client.query(
            "SELECT id, name, description FROM pio_apps WHERE name = ?", (name,)
        )
        return App(*rows[0]) if rows else None

    def get_all(self) -> list[App]:
        return [
            App(*r)
            for r in self.client.query(
                "SELECT id, name, description FROM pio_apps ORDER BY id"
            )
        ]

    def update(self, app: App) -> bool:
        cur = self.client.execute(
            "UPDATE pio_apps SET name = ?, description = ? WHERE id = ?",
            (app.name, app.description, app.id),
        )
        return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        cur = self.client.execute("DELETE FROM pio_apps WHERE id = ?", (app_id,))
        return cur.rowcount > 0


class SQLiteAccessKeys(base.AccessKeys):
    def __init__(self, client: SQLiteClient):
        self.client = client

    def insert(self, k: AccessKey) -> str | None:
        key = k.key or uuid.uuid4().hex + uuid.uuid4().hex[:16]
        try:
            self.client.execute(
                "INSERT INTO pio_access_keys (accesskey, appid, events) "
                "VALUES (?, ?, ?)",
                (key, k.appid, ",".join(k.events)),
            )
            return key
        except sqlite3.IntegrityError:
            return None

    @staticmethod
    def _row(r: tuple) -> AccessKey:
        return AccessKey(
            key=r[0], appid=r[1], events=tuple(r[2].split(",")) if r[2] else ()
        )

    def get(self, key: str) -> AccessKey | None:
        rows = self.client.query(
            "SELECT accesskey, appid, events FROM pio_access_keys "
            "WHERE accesskey = ?",
            (key,),
        )
        return self._row(rows[0]) if rows else None

    def get_by_appid(self, appid: int) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self.client.query(
                "SELECT accesskey, appid, events FROM pio_access_keys "
                "WHERE appid = ?",
                (appid,),
            )
        ]

    def get_all(self) -> list[AccessKey]:
        return [
            self._row(r)
            for r in self.client.query(
                "SELECT accesskey, appid, events FROM pio_access_keys"
            )
        ]

    def update(self, k: AccessKey) -> bool:
        cur = self.client.execute(
            "UPDATE pio_access_keys SET appid = ?, events = ? WHERE accesskey = ?",
            (k.appid, ",".join(k.events), k.key),
        )
        return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        cur = self.client.execute(
            "DELETE FROM pio_access_keys WHERE accesskey = ?", (key,)
        )
        return cur.rowcount > 0


class SQLiteChannels(base.Channels):
    def __init__(self, client: SQLiteClient):
        self.client = client

    def insert(self, channel: Channel) -> int | None:
        cur = self.client.execute(
            "INSERT INTO pio_channels (name, appid) VALUES (?, ?)",
            (channel.name, channel.appid),
        )
        return cur.lastrowid

    def get(self, channel_id: int) -> Channel | None:
        rows = self.client.query(
            "SELECT id, name, appid FROM pio_channels WHERE id = ?", (channel_id,)
        )
        return Channel(*rows[0]) if rows else None

    def get_by_appid(self, appid: int) -> list[Channel]:
        return [
            Channel(*r)
            for r in self.client.query(
                "SELECT id, name, appid FROM pio_channels WHERE appid = ?", (appid,)
            )
        ]

    def delete(self, channel_id: int) -> bool:
        cur = self.client.execute(
            "DELETE FROM pio_channels WHERE id = ?", (channel_id,)
        )
        return cur.rowcount > 0
