"""The port's Postgres backend (``data/storage/postgres_backend.py``, the
libpq ctypes driver ``pq_driver.py``) and the sqlite ``_shard_expr`` hook
held to the JAX package's, on the CPU, with no server.

- The SQL corpus: every statement the port's sqlite DAOs emit during a
  full workout (metadata, events, instances, models) translates to
  well-formed PostgreSQL, and to exactly the string the JAX package's
  ``_translate`` makes of it; so does the JAX DAOs' own corpus.
- The cursor shim, the explicit upsert conflict targets, the ``%s`` ->
  ``$N`` rewrite, ``_encode_param`` and ``_decode_value`` over numpy-seeded
  values: identical in both packages.
- A refused connect raises the driver's ``PQError`` in both, and the
  server-side shard expression is the same string.
- ``iter_shards``: sqlite (no ``_shard_expr``) splits on the host by
  ``entity_shard``; a dialect that hashes in SQL (here sqlite with the
  hash registered as a function) filters per shard on the server and
  yields the same rows.
"""

from __future__ import annotations

import hashlib
import re
from datetime import datetime, timezone

import numpy as np
import pytest

from predictionio_tpu.data.storage import postgres_backend as j_pg
from predictionio_tpu.data.storage import pq_driver as j_pq
from predictionio_tpu.data.storage import sqlite_backend as j_sb
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as p_base
from predictionio_tpu_torch.data.storage import postgres_backend as p_pg
from predictionio_tpu_torch.data.storage import pq_driver as p_pq
from predictionio_tpu_torch.data.storage import sqlite_backend as p_sb
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EventFilter,
)
from predictionio_tpu_torch.data.storage.config import (
    StorageConfig,
    StorageRuntime,
)


def t(i):
    return datetime(2026, 1, 1, 0, 0, i, tzinfo=timezone.utc)


def mk(event, eid, i, target=None, props=None):
    return Event(
        event=event, entity_type="user", entity_id=eid,
        target_entity_type="item" if target else None, target_entity_id=target,
        properties=DataMap(props or {}), event_time=t(i),
    )


def _capture(module, monkeypatch) -> list[str]:
    captured: list[str] = []
    client = module.SQLiteClient
    orig_exec, orig_many, orig_query = client.execute, client.executemany, client.query
    monkeypatch.setattr(client, "execute", lambda self, sql, params=(): (
        captured.append(sql), orig_exec(self, sql, params))[1])
    monkeypatch.setattr(client, "executemany", lambda self, sql, rows: (
        captured.append(sql), orig_many(self, sql, rows))[1])
    monkeypatch.setattr(client, "query", lambda self, sql, params=(): (
        captured.append(sql), orig_query(self, sql, params))[1])
    return captured


@pytest.fixture()
def port_corpus(tmp_path, monkeypatch):
    """Every SQL string the port's sqlite DAOs emit in a full workout."""
    captured = _capture(p_sb, monkeypatch)
    rt = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "h")}))
    app_id = rt.apps().insert(App(id=0, name="dialect"))
    rt.apps().get(app_id)
    rt.apps().get_by_name("dialect")
    rt.apps().get_all()
    rt.access_keys().insert(AccessKey(key="k1", appid=app_id, events=()))
    rt.access_keys().get("k1")
    rt.access_keys().get_by_appid(app_id)
    ch = rt.channels().insert(Channel(id=0, name="ch", appid=app_id))
    rt.channels().get_by_appid(app_id)
    le = rt.l_events()
    le.init(app_id)
    eid = le.insert(mk("rate", "u1", 1, target="i1", props={"rating": 4.0}), app_id)
    le.insert_batch([mk("view", "u2", 2), mk("buy", "u3", 3)], app_id)
    le.get(eid, app_id)
    list(le.find(app_id, filter=EventFilter(
        event_names=("rate",), entity_type="user", entity_id="u1",
        start_time=t(0), until_time=t(9))))
    list(le.find(app_id, filter=EventFilter(target_entity_type="", limit=2,
                                            reversed=True)))
    le.delete(eid, app_id)
    pe = rt.p_events()
    pe.find(app_id)
    list(pe.iter_shards(app_id, n_shards=4))
    inst = EngineInstance(id="inst1", status="INIT", start_time=t(0),
                          end_time=t(1), engine_id="e", engine_version="1",
                          engine_variant="default", engine_factory="f")
    rt.engine_instances().insert(inst)
    rt.engine_instances().update(inst.completed())
    rt.engine_instances().get("inst1")
    rt.engine_instances().get_latest_completed("e", "1", "default")
    rt.models().insert("inst1", b"blob")
    rt.models().get("inst1")
    rt.models().delete("inst1")
    le.remove(app_id)
    rt.channels().delete(ch)
    rt.apps().delete(app_id)
    rt.close()
    return sorted(set(captured))


def _well_formed(out: str) -> None:
    up = out.upper()
    assert "?" not in out, f"untranslated placeholder: {out}"
    for bad in ("INSERT OR REPLACE", "INSERT OR IGNORE", "AUTOINCREMENT"):
        assert bad not in up, out
    assert not re.search(r"\bBLOB\b", up), out
    if "ON CONFLICT" in up:
        assert re.search(r"ON CONFLICT \([\w]+\) DO (UPDATE SET|NOTHING)", out), out
    if re.match(r"\s*INSERT INTO pio_(apps|channels)\b", out, re.I):
        assert out.rstrip().endswith("RETURNING id"), out


def test_the_port_corpus_translates_as_the_jax_package_does(port_corpus):
    assert len(port_corpus) > 25, "workout captured too few statements"
    for sql in port_corpus:
        out = p_pg._translate(sql)
        _well_formed(out)
        assert out == j_pg._translate(sql), sql


def test_the_jax_corpus_translates_the_same_in_the_port(tmp_path, monkeypatch):
    from predictionio_tpu.data.storage.base import App as JaxApp
    from predictionio_tpu.data.storage.config import StorageConfig as JaxConfig
    from predictionio_tpu.data.storage.config import reset_storage as jax_reset

    captured = _capture(j_sb, monkeypatch)
    rt = jax_reset(JaxConfig.from_env({"PIO_HOME": str(tmp_path / "jh")}))
    app_id = rt.apps().insert(JaxApp(id=0, name="dialect"))
    rt.l_events().init(app_id)
    rt.p_events().find(app_id)
    rt.models().insert("x", b"blob")
    rt.apps().delete(app_id)
    rt.close()
    assert len(set(captured)) > 10
    for sql in sorted(set(captured)):
        assert p_pg._translate(sql) == j_pg._translate(sql), sql


def test_cursor_shim_and_conflict_targets():
    class FakePG:
        description = [("id",)]
        rowcount = 1

        def fetchone(self):
            return (42,)

    class FakeNoRows:
        description = None
        rowcount = 0

    for pg in (p_pg, j_pg):
        assert pg._Cursor(FakePG()).lastrowid == 42
        assert pg._Cursor(FakeNoRows()).lastrowid is None
        assert pg._conflict_target("pio_models") == "id"
        assert pg._conflict_target("pio_event_3_7") == "id"
        with pytest.raises(ValueError, match="conflict target"):
            pg._conflict_target("pio_new_table")
    out = p_pg._translate("INSERT OR REPLACE INTO pio_models (id, models) VALUES (?, ?)")
    assert "ON CONFLICT (id) DO UPDATE SET models = EXCLUDED.models" in out


@pytest.mark.parametrize("sql", [
    "INSERT INTO t (a, b) VALUES (%s, %s)",
    "SELECT '%s' || a FROM t WHERE b = %s",
    "SELECT 1",
    "UPDATE t SET a = %s, b = 'it''s %s' WHERE c = %s",
])
def test_placeholders_to_dollar(sql):
    assert p_pq.placeholders_to_dollar(sql) == j_pq.placeholders_to_dollar(sql)
    assert p_pq.placeholders_to_dollar(
        "INSERT INTO t (a, b) VALUES (%s, %s)") == "INSERT INTO t (a, b) VALUES ($1, $2)"


def _seeded_params(seed: int) -> list:
    rng = np.random.default_rng(seed)
    vals: list = [None, True, False]
    vals += [int(v) for v in rng.integers(-2**62, 2**62, size=8)]
    vals += [float(v) for v in rng.standard_normal(8) * 10.0 ** rng.integers(-5, 6, 8)]
    vals += [bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8))
             for n in rng.integers(0, 40, size=6)]
    vals += ["".join(chr(int(c)) for c in rng.integers(32, 0x24F, size=int(n)))
             for n in rng.integers(0, 20, size=6)]
    vals += [bytearray(b"\x00\xff"), memoryview(b"ab")]
    return vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_param_encoding_is_the_jax_packages(seed):
    for v in _seeded_params(seed):
        assert p_pq._encode_param(v) == j_pq._encode_param(v), repr(v)
    assert p_pq._encode_param(None) == (None, 0)
    assert p_pq._encode_param(True) == (b"t", 0)
    assert p_pq._encode_param(b"\x00\xff") == (b"\x00\xff", 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_value_decoding_is_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    cases = [(b"t", 16), (b"f", 16), (b"hello", 25), (b"\\x00ff", 17),
             (b"raw", 17)]
    cases += [(str(int(v)).encode(), oid) for v, oid in zip(
        rng.integers(-2**62, 2**62, size=8), [20, 21, 23, 26] * 2)]
    cases += [(repr(float(v)).encode(), oid) for v, oid in zip(
        rng.standard_normal(6), [700, 701, 1700] * 2)]
    cases += [(b"\\x" + bytes(rng.integers(0, 256, 12, dtype=np.uint8)).hex().encode(), 17)]
    cases += [("é✓ x".encode(), 1043)]
    for raw, oid in cases:
        assert p_pq._decode_value(raw, oid) == j_pq._decode_value(raw, oid), (raw, oid)
    assert p_pq._decode_value(b"\\x00ff", 17) == b"\x00\xff"
    assert p_pq._decode_value(b"2.5", 701) == 2.5


def test_connect_refused_raises_cleanly():
    if not p_pq.available():
        pytest.skip("libpq not present on this host")
    url = "postgresql://nobody@127.0.0.1:1/nosuchdb?connect_timeout=2"
    for pq in (p_pq, j_pq):
        with pytest.raises(pq.PQError, match="connection failed"):
            pq.connect(url)


def test_the_server_side_shard_expression_is_the_jax_packages():
    for n in (1, 4, 8, 16):
        assert p_pg.PGPEvents._shard_expr(None, n) == j_pg.PGPEvents._shard_expr(None, n)
    assert "MOD(" in p_pg.PGPEvents._shard_expr(None, 8) and "%" not in \
        p_pg.PGPEvents._shard_expr(None, 8)
    assert p_sb.SQLitePEvents._shard_expr(None, 8) is None
    assert issubclass(p_pg.PGPEvents, p_sb.SQLitePEvents)


def _store_with_events(tmp_path, n_users=40):
    rt = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "s")}))
    app_id = rt.apps().insert(App(id=0, name="shards"))
    rng = np.random.default_rng(7)
    events = [mk("rate", f"u{int(u)}", int(i % 50), target=f"i{int(v)}",
                 props={"rating": float(r)})
              for i, (u, v, r) in enumerate(zip(
                  rng.integers(0, n_users, 300), rng.integers(0, 30, 300),
                  rng.integers(1, 6, 300)))]
    rt.l_events().insert_batch(events, app_id)
    return rt, app_id


def test_sqlite_iter_shards_splits_on_the_host_by_entity_shard(tmp_path):
    rt, app_id = _store_with_events(tmp_path)
    pe = rt.p_events()
    seen = 0
    for k, frame in pe.iter_shards(app_id, n_shards=4):
        for etype, eid in zip(frame.entity_type, frame.entity_id):
            assert p_base.entity_shard(etype, eid, 4) == k
        seen += len(frame.event)
    assert seen == 300
    rt.close()


class _HashingPEvents(p_sb.SQLitePEvents):
    """A dialect that hashes in SQL: sqlite with the md5 shard registered
    as a function, so the per-shard WHERE path runs without a server."""

    def _shard_expr(self, n_shards: int) -> str:
        return f"pio_shard(entityType, entityId, {int(n_shards)})"


def test_a_dialect_that_hashes_in_sql_filters_each_shard_on_the_server(tmp_path):
    rt, app_id = _store_with_events(tmp_path)
    host = rt.p_events()
    client = host.client
    client.conn.create_function(
        "pio_shard", 3,
        lambda t_, i_, n: int.from_bytes(
            hashlib.md5(f"{t_}-{i_}".encode()).digest()[:4], "big") % n)
    server = _HashingPEvents(client, host.levents)
    queries: list[str] = []
    orig = client.query
    client.query = lambda sql, params=(): (queries.append(sql), orig(sql, params))[1]
    try:
        for filt in (None, EventFilter(event_names=("rate",))):
            a = {k: sorted(zip(f.entity_id, f.target_entity_id, f.event_id))
                 for k, f in host.iter_shards(app_id, filter=filt, n_shards=4)}
            b = {k: sorted(zip(f.entity_id, f.target_entity_id, f.event_id))
                 for k, f in server.iter_shards(app_id, filter=filt, n_shards=4)}
            assert a == b and sum(len(v) for v in b.values()) == 300
        assert any("pio_shard(" in q for q in queries)
        # a LIMIT is global: the host split, never a per-shard WHERE
        queries.clear()
        got = dict(server.iter_shards(app_id, filter=EventFilter(limit=5),
                                      n_shards=4))
        assert sum(len(f.event) for f in got.values()) == 5
        assert not any("pio_shard(" in q for q in queries)
    finally:
        client.query = orig
        rt.close()


def test_a_postgres_source_builds_the_postgres_daos(tmp_path, monkeypatch):
    """``TYPE=postgres`` builds its client through ``make_client`` (the
    sqlite DDL translated) and gives the bulk reads the server-side
    shard; a stand-in client records what would go to the server."""
    sent: list[str] = []

    class FakeClient:
        lock = None

        def execute(self, sql, params=()):
            sent.append(p_pg._translate(sql))

            class Cur:
                lastrowid, rowcount = 1, 0
            return Cur()

        def executemany(self, sql, rows):
            sent.append(p_pg._translate(sql))

        def query(self, sql, params=()):
            sent.append(p_pg._translate(sql))
            return []

        def close(self):
            pass

    def fake_make_client(url):
        assert url == "postgresql://pio@db/pio"
        client = FakeClient()
        p_sb.create_tables(client)
        return client

    monkeypatch.setattr(p_pg, "make_client", fake_make_client)
    rt = StorageRuntime(StorageConfig.from_env({
        "PIO_HOME": str(tmp_path),
        "PIO_STORAGE_SOURCES_PG_TYPE": "postgres",
        "PIO_STORAGE_SOURCES_PG_URL": "postgresql://pio@db/pio",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PG",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PG",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "PG",
    }))
    assert isinstance(rt.p_events(), p_pg.PGPEvents)
    list(rt.p_events().iter_shards(3, n_shards=4))
    assert any("BIGSERIAL PRIMARY KEY" in s for s in sent)
    assert any("MOD(('x' || substr(md5(entityType || '-' || entityId)" in s
               for s in sent)
    rt.close()


def test_sqlite_metadata_ddl_equals_the_jax_package(tmp_path):
    """``SQLiteMetadata`` on a fresh database leaves the same
    ``sqlite_master`` SQL as the JAX package's class of that name."""
    got = {}
    for name, mod in (("jax", j_sb), ("port", p_sb)):
        client = mod.SQLiteClient(str(tmp_path / f"{name}.sqlite"))
        meta = mod.SQLiteMetadata(client)
        assert meta.client is client
        mod.SQLiteMetadata(client)  # idempotent
        got[name] = client.query(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY name")
        client.close()
    assert got["port"] == got["jax"]
    assert {row[1] for row in got["port"]} >= {
        "pio_apps", "pio_access_keys", "pio_channels", "pio_engine_instances",
        "pio_evaluation_instances", "pio_models"}
