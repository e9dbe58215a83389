"""SQLite metadata + model blobs — the subset of the JAX package's sqlite
backend that deploy needs.

Same tables, same columns, same encodings (times in epoch milliseconds, env
and mesh config as JSON), so the port reads a ``$PIO_HOME/pio.sqlite`` that
the JAX ``pio train`` wrote, and the JAX package reads the port's rows.
"""

from __future__ import annotations

import dataclasses
import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from pathlib import Path
from typing import Sequence

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import EngineInstance


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

    def query(self, sql: str, params: Sequence = ()) -> list[tuple]:
        with self.lock:
            return self.conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self.lock:
            self.conn.close()


def create_tables(client: SQLiteClient) -> None:
    """The two tables deploy reads, with the JAX package's exact DDL."""
    client.execute(
        """CREATE TABLE IF NOT EXISTS pio_engine_instances (
           id TEXT PRIMARY KEY, status TEXT, startTime INTEGER,
           endTime INTEGER, engineId TEXT, engineVersion TEXT,
           engineVariant TEXT, engineFactory TEXT, batch TEXT,
           env TEXT, meshConf TEXT, dataSourceParams TEXT,
           preparatorParams TEXT, algorithmsParams TEXT, servingParams TEXT)"""
    )
    client.execute(
        """CREATE TABLE IF NOT EXISTS pio_models (
           id TEXT PRIMARY KEY, models BLOB NOT NULL)"""
    )


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
