"""The port's parquet event log, compactor and storage fleet against the
JAX package's, on the CPU.

- Every parquet, compaction, pushdown, fan-out and ``eventstore`` CLI case
  of ``tests/test_data_plane.py`` runs on the port: watermarked folds that
  keep content and ids, upserts and tombstones across the watermark, the
  crash window read exactly once, the in-flight barrier, the compactor's
  policy and status, sharded bulk writes, value-factorized None rows,
  filter and column pushdown, entity point reads with row-group skipping,
  time-window segment skipping, superseded rows that never resurrect,
  root ownership, the two-daemon fleet, ``eventstore status|compact``
  local and ``--url``, ``status --url``'s backlog warning, and a storage
  daemon SIGKILLed inside the compaction publish window.
- A root written by either package reads in the other to the same rows,
  ids, tombstones and shard split, and a fold by either package leaves a
  root the other reads the same.
- ``pio app compact`` on both CLIs.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.data import DataMap as JaxDataMap
from predictionio_tpu.data import Event as JaxEvent
from predictionio_tpu.data.storage import parquet_backend as jax_pq
from predictionio_tpu.data.storage.base import EventFrame as JaxEventFrame
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.tools import cli as jax_cli

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import EventFilter, EventFrame
from predictionio_tpu_torch.data.storage.compactor import CompactionPolicy, Compactor
from predictionio_tpu_torch.data.storage.parquet_backend import (
    ParquetClient,
    ParquetLEvents,
    ParquetPEvents,
    _active_segments,
    _list_segments,
)
from predictionio_tpu_torch.data.storage import parquet_backend as pt_pq

torch.set_num_threads(2)


def t(i: int) -> datetime:
    return datetime.fromtimestamp(1_700_000_000 + i * 60, tz=timezone.utc)


def mk(event, entity, i, target=None, props=None, eid=None) -> Event:
    return Event(
        event=event,
        entity_type="user",
        entity_id=str(entity),
        target_entity_type="item" if target else None,
        target_entity_id=str(target) if target else None,
        properties=DataMap(props or {}),
        event_time=t(i),
        event_id=eid,
    )


def bulk_frame(n, n_users=50, n_items=20, t0=0, seed=0) -> EventFrame:
    rng = np.random.default_rng(seed)
    users = np.array([f"u{x}" for x in range(n_users)], object)
    items = np.array([f"i{x}" for x in range(n_items)], object)
    docs = np.array(
        [json.dumps({"rating": float(v) / 2}) for v in range(1, 11)], object
    )
    const = lambda v: _const(n, v)  # noqa: E731
    return EventFrame(
        event=const("rate"),
        entity_type=const("user"),
        entity_id=users[rng.integers(0, n_users, n)],
        target_entity_type=const("item"),
        target_entity_id=items[rng.integers(0, n_items, n)],
        event_time_ms=np.int64(1_700_000_000_000)
        + np.arange(t0, t0 + n, dtype=np.int64) * 1000,
        properties=docs[rng.integers(0, 10, n)],
    )


def _const(n, v):
    a = np.empty(n, object)
    a[:] = v
    return a


def store_at(path, n_shards=4):
    client = ParquetClient(path, n_shards=n_shards)
    return client, ParquetLEvents(client), ParquetPEvents(client)


def total_hot(client, app_id=1) -> int:
    pe = ParquetPEvents(client)
    return pe.status(app_id)["segments_hot"]


def scan_rows(pe, app_id=1):
    out = []
    for _, f in pe.iter_shards(app_id):
        for i in range(len(f)):
            out.append(
                (
                    f.entity_id[i],
                    f.target_entity_id[i],
                    f.event[i],
                    int(f.event_time_ms[i]),
                    f.event_id[i] if f.event_id is not None else None,
                )
            )
    return sorted(out, key=lambda r: (r[0], r[1] or "", r[3], r[4] or ""))


class TestCompaction:
    def test_fold_preserves_content_and_ids(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        for batch in range(5):
            le.insert_batch(
                [mk("view", f"u{j}", batch * 10 + j, target=f"i{j}")
                 for j in range(8)],
                1,
            )
        before = scan_rows(pe)
        assert total_hot(client) > 0
        live = pe.compact(1)
        assert live == 40
        st = pe.status(1)
        assert st["segments_hot"] == 0
        assert st["segments_compacted"] >= 1
        assert scan_rows(pe) == before  # bit-identical incl. event ids

    def test_upsert_and_tombstone_across_watermark(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        eid = le.insert(mk("view", "u1", 1), 1)
        dead = le.insert(mk("view", "u2", 2), 1)
        pe.compact(1)
        # upsert a compacted row from the new write-hot head
        le.insert(mk("buy", "u1", 3, eid=eid), 1)
        assert le.delete(dead, 1)
        got = {e.event_id: e.event for e in le.find(1)}
        assert got == {eid: "buy"}
        # fold again: same answer, tombstones applied durably
        pe.compact(1)
        got = {e.event_id: e.event for e in le.find(1)}
        assert got == {eid: "buy"}
        # every shard folded past the tombstone: the del files are pruned
        assert not (tmp_path / "pq" / "app_1" / "_tombstones").exists()

    def test_crash_window_reads_exactly_once(self, tmp_path):
        """A SIGKILL between the cseg publish and the source unlink leaves
        both the compacted segment AND its folded sources on disk — every
        row must still read exactly once, and the next compaction sweeps
        the superseded files."""
        client, le, pe = store_at(tmp_path / "pq", n_shards=1)
        le.init(1)
        ids = le.insert_batch([mk("view", f"u{j}", j) for j in range(10)], 1)
        shard_dir = tmp_path / "pq" / "app_1" / "shard=0"
        # preserve the pre-compaction hot segments, then "un-delete" them
        saved = {
            p.name: p.read_bytes() for p in shard_dir.glob("seg-*.parquet")
        }
        pe.compact(1)
        for name, blob in saved.items():  # simulate the crash window
            (shard_dir / name).write_bytes(blob)
        csegs, hots = _list_segments(shard_dir)
        assert csegs and hots  # both generations present
        got = sorted(e.event_id for e in le.find(1))
        assert got == sorted(ids)  # exactly once, no duplicates
        pe.compact(1)  # resumes: superseded files swept
        _, hots = _list_segments(shard_dir)
        assert hots == []
        assert sorted(e.event_id for e in le.find(1)) == sorted(ids)

    def test_concurrent_append_stays_above_watermark(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq", n_shards=1)
        le.init(1)
        le.insert_batch([mk("view", f"u{j}", j) for j in range(4)], 1)
        pe.compact(1)
        le.insert(mk("view", "u99", 99), 1)  # post-watermark append
        shard_dir = tmp_path / "pq" / "app_1" / "shard=0"
        cseg, hots, superseded, w = _active_segments(shard_dir)
        assert cseg is not None and len(hots) == 1
        assert hots[0].seq > w and superseded == []
        assert len(list(le.find(1))) == 5

    def test_fold_never_swallows_inflight_write(self, tmp_path):
        """A writer that reserved its seq BEFORE a fold started may
        publish its segment after the new cseg lands; the fold must stop
        at the in-flight barrier so that segment stays above the
        watermark (a watermark at or past it would read the acked rows
        as superseded — silent loss)."""
        client, le, pe = store_at(tmp_path / "pq", n_shards=1)
        le.init(1)
        # writer A reserves a seq, then stalls mid-conversion
        seq_a = client.seq.reserve()
        try:
            # writer B lands a later batch while A is still in flight
            ids_b = le.insert_batch(
                [mk("view", f"u{j}", j) for j in range(5)], 1
            )
            live = pe.compact(1)  # must NOT fold past A's reserved seq
            assert live == 0  # B's segment sits above the barrier: unfolded
            shard_dir = tmp_path / "pq" / "app_1" / "shard=0"
            _, hots = _list_segments(shard_dir)
            assert len(hots) == 1  # B's segment survived the fold
            # A finally publishes with its OLD seq
            from predictionio_tpu_torch.data.storage.parquet_backend import (
                _event_row,
                _write_segment,
            )

            rows = [_event_row(mk("buy", "uA", 99), seq_a, "idA")]
            _write_segment(shard_dir, rows, seq_a)
        finally:
            client.seq.release(seq_a)
        got = sorted(e.event_id for e in le.find(1))
        assert got == sorted(ids_b + ["idA"])  # nothing swallowed
        pe.compact(1)  # barrier lifted: everything folds
        got = sorted(e.event_id for e in le.find(1))
        assert got == sorted(ids_b + ["idA"])

    def test_compactor_tick_policy_and_status(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        comp = Compactor(
            client,
            CompactionPolicy(min_hot_segments=4, backlog_budget_segments=8),
        )
        le.insert_batch([mk("view", f"u{j}", j) for j in range(12)], 1)
        below = comp.tick()
        # one batch adds at most ONE segment per shard: per-shard depth 1
        # is under the threshold no matter how many shards it touched
        assert below["apps_compacted"] == 0
        for batch in range(4):
            le.insert_batch(
                [mk("view", f"u{j}", 100 + batch * 12 + j) for j in range(12)],
                1,
            )
        over = comp.tick()
        assert over["apps_compacted"] == 1
        st = comp.status()
        assert st["backlog_segments"] == 0 and not st["over_budget"]
        assert st["apps"][0]["segments_compacted"] >= 1
        assert len(list(le.find(1))) == 60

    def test_bulk_write_fans_out_and_round_trips(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq", n_shards=4)
        pe.write(bulk_frame(5000), 1)
        st = pe.status(1)
        assert st["n_shards"] == 4
        assert sum(1 for s in st["shards"] if s["bytes"]) == 4
        rows = sum(len(f) for _, f in pe.iter_shards(1))
        assert rows == 5000
        pe.compact(1)
        assert sum(len(f) for _, f in pe.iter_shards(1)) == 5000


class TestColumnEncoding:
    def test_value_factorize_none_rows_round_trip(self, tmp_path):
        """A column of pointer-DISTINCT but value-repetitive strings with
        None rows exercises the value-level factorize fallback, whose -1
        NA sentinel must become a masked dictionary slot (raw -1 codes
        crash DictionaryArray.from_arrays)."""
        n = 9000
        col = np.array(
            [("v" + str(i % 3)) if i % 5 else None for i in range(n)],
            object,
        )
        from predictionio_tpu_torch.data.storage.parquet_backend import (
            _string_array,
        )

        arr = _string_array(col)
        assert arr.to_pylist() == list(col)
        # and end to end through a bulk write
        client, le, pe = store_at(tmp_path / "pq", n_shards=2)
        frame = bulk_frame(n)
        frame.target_entity_id = col
        pe.write(frame, 1)
        got = pe.find(1)
        assert sum(v is None for v in got.target_entity_id) == sum(
            v is None for v in col
        )


class TestPushdown:
    def test_filter_parity_with_matches(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        events = [
            mk(
                "view" if j % 3 else "buy",
                f"u{j % 7}",
                j,
                target=f"i{j % 5}" if j % 2 else None,
            )
            for j in range(60)
        ]
        le.insert_batch(events, 1)
        pe.compact(1)
        le.insert_batch(
            [mk("rate", f"u{j % 7}", 100 + j) for j in range(10)], 1
        )  # mixed compacted + hot
        filters = [
            EventFilter(event_names=("buy",)),
            EventFilter(entity_type="user", entity_id="u3"),
            EventFilter(start_time=t(10), until_time=t(40)),
            EventFilter(target_entity_type="", event_names=("view",)),
            EventFilter(target_entity_id="i2"),
        ]
        everything = list(le.find(1))
        for flt in filters:
            got = sorted(e.event_id for e in le.find(1, filter=flt))
            want = sorted(
                e.event_id for e in everything if flt.matches(e)
            )
            assert got == want, flt

    def test_column_projection(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq")
        pe.write(bulk_frame(500), 1)
        for _, f in pe.iter_shards(1, columns=["entity_id", "properties"]):
            assert f.entity_id is not None and f.properties is not None
            assert f.event is not None  # anchor column always present
            assert f.target_entity_id is None and f.event_id is None
            assert f.event_time_ms is None
        # projection composes with a filter that reads non-projected cols
        rows = sum(
            len(f)
            for _, f in pe.iter_shards(
                1,
                filter=EventFilter(event_names=("rate",)),
                columns=["entity_id"],
            )
        )
        assert rows == 500

    def test_find_by_entity_parity_and_skipping(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        events = [
            mk("view", f"u{j % 9}", j, target=f"i{j % 4}") for j in range(90)
        ]
        le.insert_batch(events, 1)
        pe.compact(1)
        le.insert_batch(
            [mk("buy", f"u{j % 9}", 200 + j) for j in range(9)], 1
        )
        from predictionio_tpu_torch.obs.metrics import REGISTRY

        read0 = REGISTRY.counter(
            "pio_eventstore_bytes_read_total", labelnames=("kind",)
        ).labels("entity").value
        via_point = [
            (e.event_id, e.event)
            for e in le.find_by_entity(1, "user", "u3", reversed=True)
        ]
        via_find = [
            (e.event_id, e.event)
            for e in le.find(
                1,
                filter=EventFilter(
                    entity_type="user", entity_id="u3", reversed=True
                ),
            )
        ]
        assert via_point == via_find and via_point
        assert (
            REGISTRY.counter(
                "pio_eventstore_bytes_read_total", labelnames=("kind",)
            ).labels("entity").value
            > read0
        )
        # limit + time-window shapes
        latest = list(
            le.find_by_entity(1, "user", "u3", limit=2, reversed=True)
        )
        assert len(latest) == 2
        assert latest[0].event_time >= latest[1].event_time

    def test_time_window_segment_skipping(self, tmp_path):
        client, le, pe = store_at(tmp_path / "pq", n_shards=1)
        pe.write(bulk_frame(300, t0=0), 1)
        pe.write(bulk_frame(300, t0=10_000_000, seed=1), 1)
        from predictionio_tpu_torch.obs.metrics import REGISTRY

        skip_c = REGISTRY.counter(
            "pio_eventstore_bytes_skipped_total", labelnames=("kind",)
        ).labels("full")
        before = skip_c.value
        start = datetime.fromtimestamp(
            (1_700_000_000_000 + 10_000_000_000) / 1000, tz=timezone.utc
        )
        got = pe.find(1, filter=EventFilter(start_time=start))
        assert len(got) == 300
        assert skip_c.value > before  # the old segment was never decoded

    def test_time_window_skip_never_resurrects_superseded_rows(
        self, tmp_path
    ):
        """A hot segment OUTSIDE a query's time window may hold the
        NEWEST version of an upserted id — skipping it by footer stats
        must not let the superseded in-window compacted copy escape."""
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        eid = le.insert(mk("view", "u1", 1), 1)
        pe.compact(1)
        le.insert(mk("view", "u1", 10_000_000, eid=eid), 1)  # far future
        got = list(
            le.find(1, filter=EventFilter(until_time=t(2000)))
        )
        assert got == []  # the old version is superseded, not in-window

    def test_entity_range_skip_never_resurrects_superseded_rows(
        self, tmp_path
    ):
        """Same guard for the entity point read: an upsert that MOVED an
        event to an out-of-range entity still claims its id."""
        client, le, pe = store_at(tmp_path / "pq", n_shards=1)
        le.init(1)
        eid = le.insert(mk("view", "aaa", 1), 1)
        pe.compact(1)
        le.insert(mk("view", "zzz", 2, eid=eid), 1)  # same shard (1 shard)
        got = list(le.find_by_entity(1, "user", "aaa"))
        assert got == []  # the 'aaa' version is superseded

    def test_local_compact_refuses_owned_root(self, tmp_path):
        from predictionio_tpu_torch.data.storage.parquet_backend import (
            acquire_root_ownership,
        )

        client, le, pe = store_at(tmp_path / "pq", n_shards=1)
        le.insert_batch([mk("view", "u1", 1)], 1)
        owner = acquire_root_ownership(client.root)
        assert owner is not None
        try:
            # a second process-level claim must fail while the owner lives
            assert acquire_root_ownership(client.root) is None
        finally:
            owner.close()
        again = acquire_root_ownership(client.root)
        assert again is not None
        again.close()

    def test_upsert_semantics_survive_pushdown(self, tmp_path):
        """The superseded version of an upserted row must stay hidden from
        filters even when the predicate could push into the reader."""
        client, le, pe = store_at(tmp_path / "pq")
        le.init(1)
        eid = le.insert(mk("view", "u1", 1), 1)
        pe.compact(1)
        le.insert(mk("buy", "u1", 2, eid=eid), 1)
        assert [
            e.event_id for e in le.find(1, filter=EventFilter(event_names=("view",)))
        ] == []
        assert [
            e.event_id for e in le.find(1, filter=EventFilter(event_names=("buy",)))
        ] == [eid]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestFanout:
    @pytest.fixture
    def daemons(self, tmp_path):
        from predictionio_tpu_torch.server.storage_server import StorageServer

        servers = [
            StorageServer(
                tmp_path / f"root{i}",
                host="127.0.0.1",
                port=0,
                compaction=False,
            ).start_background()
            for i in range(2)
        ]
        yield servers
        for s in servers:
            s.shutdown()

    @pytest.fixture
    def fan(self, daemons):
        from predictionio_tpu_torch.data.storage.config import (
            StorageConfig,
            StorageRuntime,
        )

        urls = ",".join(
            f"http://127.0.0.1:{s.port}" for s in daemons
        )
        rt = StorageRuntime(
            StorageConfig.from_env(
                {
                    "PIO_STORAGE_SOURCES_FLEET_TYPE": "remote",
                    "PIO_STORAGE_SOURCES_FLEET_URL": urls,
                    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "FLEET",
                }
            )
        )
        yield rt
        rt.close()

    def test_fanout_types_selected(self, fan):
        from predictionio_tpu_torch.data.storage.remote_backend import (
            FanoutLEvents,
            FanoutPEvents,
        )

        assert isinstance(fan.l_events(), FanoutLEvents)
        assert isinstance(fan.p_events(), FanoutPEvents)

    def test_bulk_write_partitions_by_entity_hash(self, fan, daemons):
        pe = fan.p_events()
        pe.write(bulk_frame(400), 1)
        whole = pe.find(1)
        assert len(whole) == 400
        # each daemon holds a DISJOINT, non-empty subset
        from predictionio_tpu_torch.data.storage.remote_backend import (
            RemoteClient,
            RemotePEvents,
        )

        counts = []
        for s in daemons:
            sub = RemotePEvents(
                RemoteClient(f"http://127.0.0.1:{s.port}")
            )
            counts.append(len(sub.find(1)))
        assert sum(counts) == 400 and all(c > 0 for c in counts)
        # shard-addressed scans fan in across daemons
        rows = sum(len(f) for _, f in pe.iter_shards(1))
        assert rows == 400
        # per-shard results hash to their shard
        from predictionio_tpu_torch.data.storage.base import entity_shard

        n = pe.n_shards(1)
        for k, f in pe.iter_shards(1, shards=[1, 3]):
            assert k in (1, 3)
            for et, eid in zip(f.entity_type, f.entity_id):
                assert entity_shard(et, eid, n) == k

    def test_row_ops_route_and_round_trip(self, fan):
        le = fan.l_events()
        le.init(1)
        ids = le.insert_batch(
            [mk("view", f"u{j}", j, target=f"i{j}") for j in range(20)], 1
        )
        assert len(set(ids)) == 20
        got = le.get(ids[3], 1)
        assert got is not None and got.entity_id == "u3"
        hist = list(le.find_by_entity(1, "user", "u7"))
        assert [e.event_id for e in hist] == [ids[7]]
        assert le.delete(ids[3], 1)
        assert le.get(ids[3], 1) is None
        remaining = list(le.find(1, filter=EventFilter(limit=100)))
        assert len(remaining) == 19
        # ordered merge across daemons respects limit/reversed
        newest = list(le.find(1, filter=EventFilter(limit=3, reversed=True)))
        times = [e.event_time for e in newest]
        assert times == sorted(times, reverse=True) and len(newest) == 3

    def test_fanout_compact_and_status(self, fan):
        pe = fan.p_events()
        pe.write(bulk_frame(200), 1)
        rows = pe.compact(1)
        assert rows == 200
        st = pe.status(1)
        assert st["daemons"] == 2
        assert st["segments_hot"] == 0 and st["segments_compacted"] > 0


class TestEventstoreCLI:
    def test_status_and_compact_local(self, tmp_path, capsys):
        from predictionio_tpu_torch.data.storage.config import reset_storage, StorageConfig
        from predictionio_tpu_torch.tools.cli import main as cli_main

        env = {
            "PIO_HOME": str(tmp_path),
            "PIO_STORAGE_SOURCES_PQ_TYPE": "parquet",
            "PIO_STORAGE_SOURCES_PQ_PATH": str(tmp_path / "ev"),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PQ",
        }
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            rt = reset_storage(StorageConfig.from_env())
            rt.l_events().insert_batch(
                [mk("view", f"u{j}", j) for j in range(6)], 1
            )
            assert cli_main(["eventstore", "status", "--json"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["backlog_segments"] > 0
            assert cli_main(["eventstore", "compact"]) == 0
            assert "live rows" in capsys.readouterr().out
            assert cli_main(["eventstore", "status", "--json"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["backlog_segments"] == 0
            assert out["apps"][0]["segments_compacted"] >= 1
        finally:
            for k, v in old.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
            reset_storage(StorageConfig.from_env())

    def test_status_url_against_daemon(self, tmp_path, capsys):
        from predictionio_tpu_torch.server.storage_server import StorageServer
        from predictionio_tpu_torch.tools.cli import main as cli_main

        server = StorageServer(
            tmp_path / "root", host="127.0.0.1", port=0, compaction=False
        ).start_background()
        try:
            server.runtime.l_events().insert_batch(
                [mk("view", f"u{j}", j) for j in range(4)], 1
            )
            url = f"http://127.0.0.1:{server.port}"
            assert cli_main(["eventstore", "status", "--url", url, "--json"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["backlog_segments"] > 0
            assert cli_main(["eventstore", "compact", "--url", url]) == 0
            capsys.readouterr()
            assert cli_main(["eventstore", "status", "--url", url, "--json"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out["backlog_segments"] == 0
        finally:
            server.shutdown()

    def test_pio_status_url_warns_on_backlog(self, tmp_path, capsys, monkeypatch):
        from predictionio_tpu_torch.server.storage_server import StorageServer
        from predictionio_tpu_torch.tools.cli import main as cli_main

        monkeypatch.setenv("PIO_COMPACT_BACKLOG_BUDGET", "1")
        server = StorageServer(
            tmp_path / "root", host="127.0.0.1", port=0, compaction=False
        ).start_background()
        try:
            for batch in range(3):
                server.runtime.l_events().insert_batch(
                    [mk("view", f"u{j}", batch * 4 + j) for j in range(4)], 1
                )
            url = f"http://127.0.0.1:{server.port}"
            cli_main(["status", "--url", url])
            err = capsys.readouterr().err
            assert "compaction backlog" in err and "WARNING" in err
        finally:
            server.shutdown()


def _spawn_storage_daemon(root, port, extra_env=None):
    env = dict(os.environ)
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
            "storageserver", "--ip", "127.0.0.1", "--port", str(port),
            "--root", str(root), "--no-compact",
        ],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        env=env,
    )
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return proc
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError("storage daemon died at boot")
            time.sleep(0.1)
    proc.kill()
    raise TimeoutError("storage daemon never bound its port")


class TestChaosCompaction:
    def test_sigkill_mid_compaction_loses_nothing(self, tmp_path):
        """SIGKILL a REAL storage daemon between the compacted-segment
        publish and the source unlink (a latency fault holds it in that
        exact window), under concurrent ingest.  On restart every acked
        event reads exactly once, and the next compaction resumes from
        the watermark, sweeping the superseded files."""
        from predictionio_tpu_torch.data.storage.remote_backend import (
            RemoteClient,
            RemoteLEvents,
            RemotePEvents,
        )

        root = tmp_path / "root"
        port = _free_port()
        # hold the daemon 30s at the publish seam of shard=0 — the crash
        # window where BOTH the cseg and its folded sources exist
        plan = json.dumps(
            [
                {
                    "seam": "compact.publish",
                    "kind": "latency",
                    "latency_s": 30.0,
                    "match": "shard=0",
                }
            ]
        )
        proc = _spawn_storage_daemon(
            root, port, extra_env={"PIO_FAULT_PLAN": plan}
        )
        client = RemoteClient(f"http://127.0.0.1:{port}", breaker=None, timeout=60)
        le = RemoteLEvents(client)
        acked: list[str] = []
        try:
            le.init(1)
            acked += le.insert_batch(
                [mk("view", f"u{j}", j) for j in range(40)], 1
            )
            # trigger compaction over HTTP; it will wedge at the seam
            def compact_call():
                try:
                    client.json(
                        "POST", "/eventstore/compact", idempotent=True
                    )
                except Exception:
                    pass  # the SIGKILL kills this call

            ct = threading.Thread(target=compact_call, daemon=True)
            ct.start()
            # concurrent ingest while the compactor is mid-fold
            deadline = time.monotonic() + 30.0
            j = 100
            while time.monotonic() < deadline:
                try:
                    acked += le.insert_batch(
                        [mk("view", f"u{j}", j)], 1
                    )
                    j += 1
                except Exception:
                    break  # daemon may already be dead
                # once shard=0's cseg exists the daemon is inside the
                # publish window: kill it there
                shard0 = root / "events_parquet" / "app_1" / "shard=0"
                if list(shard0.glob("cseg-*.parquet")) and list(
                    shard0.glob("seg-*.parquet")
                ):
                    break
                time.sleep(0.05)
            shard0 = root / "events_parquet" / "app_1" / "shard=0"
            assert list(shard0.glob("cseg-*.parquet")), (
                "compaction never reached the publish window"
            )
            assert list(shard0.glob("seg-*.parquet")), (
                "sources already swept; the crash window was missed"
            )
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

        # restart WITHOUT the fault plan: every acked event reads exactly
        # once (no loss from the kill, no duplicates from the overlap of
        # cseg + superseded sources)
        proc2 = _spawn_storage_daemon(root, port)
        try:
            client2 = RemoteClient(f"http://127.0.0.1:{port}", breaker=None, timeout=60)
            le2 = RemoteLEvents(client2)
            got = sorted(
                e.event_id
                for e in le2.find(1, filter=EventFilter(limit=-1))
            )
            assert got == sorted(acked)
            # the compactor resumes from the watermark: re-folding sweeps
            # the superseded files and changes nothing
            out = client2.json(
                "POST", "/eventstore/compact", idempotent=True
            )
            assert out["rows"] == len(acked)
            assert not list(shard0.glob("seg-*.parquet"))
            got2 = sorted(
                e.event_id
                for e in le2.find(1, filter=EventFilter(limit=-1))
            )
            assert got2 == sorted(acked)
            st = RemotePEvents(client2).status(1)
            assert st["backlog_segments"] == 0
        finally:
            proc2.kill()
            proc2.wait(timeout=10)


# ---------------------------------------------------------------------------
# parquet roots across the packages


def _jax_mk(event, entity, i, target=None, props=None, eid=None):
    return JaxEvent(
        event=event, entity_type="user", entity_id=str(entity),
        target_entity_type="item" if target else None,
        target_entity_id=str(target) if target else None,
        properties=JaxDataMap(props or {}), event_time=t(i), event_id=eid,
    )


def _write_root(pkg: str, root, fold: bool) -> dict:
    """Row inserts (one upserted), a bulk frame, tombstones, and a fold
    in between when ``fold``, through one package; returns the ids."""
    mod, mk_event, frame_cls = (
        (jax_pq, _jax_mk, JaxEventFrame) if pkg == "jax" else (pt_pq, mk, EventFrame)
    )
    client = mod.ParquetClient(root, n_shards=4)
    le, pe = mod.ParquetLEvents(client), mod.ParquetPEvents(client)
    le.init(1)
    ids = le.insert_batch(
        [mk_event("view" if j % 3 else "buy", f"u{j % 9}", j, target=f"i{j % 5}",
                  props={"n": j}) for j in range(40)],
        1,
    )
    if fold:
        pe.compact(1)
    le.insert(mk_event("rate", "u1", 50, target="i2", props={"rating": 4.0},
                       eid=ids[1]), 1)  # upsert across the watermark
    cols = {k: np.asarray(v) for k, v in bulk_frame(300, seed=5).__dict__.items()
            if v is not None}
    pe.write(frame_cls(**cols), 1)
    le.delete(ids[2], 1)
    pe.delete([ids[3], ids[4]], 1)
    client.close()
    return {"ids": ids}


def _read_root(pkg: str, root) -> dict:
    mod = jax_pq if pkg == "jax" else pt_pq
    client = mod.ParquetClient(root, n_shards=4)
    le, pe = mod.ParquetLEvents(client), mod.ParquetPEvents(client)
    rows = sorted(
        (e.event_id or "", e.event, e.entity_id, e.target_entity_id or "",
         int(e.event_time.timestamp() * 1000), json.dumps(e.properties.fields, sort_keys=True))
        for e in le.find(1)
    )
    shards = {
        k: sorted(zip(f.entity_id.tolist(), f.event_time_ms.tolist()))
        for k, f in pe.iter_shards(1)
    }
    whole = pe.find(1)
    st = pe.status(1)
    out = {
        "rows": rows,
        "n_shards": pe.n_shards(1),
        "shards": shards,
        "frame": sorted(zip(whole.entity_id.tolist(), whole.event_time_ms.tolist(),
                            [p or "" for p in whole.properties.tolist()])),
        "point": sorted((e.event_id or "", int(e.event_time.timestamp() * 1000))
                        for e in le.find_by_entity(1, "user", "u1")),
        "segments": (st["segments_hot"], st["segments_compacted"], st["rows_hint"]),
    }
    client.close()
    return out


@pytest.mark.parametrize("fold", [False, True], ids=["hot", "folded"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parquet_root_reads_the_same_in_both_packages(tmp_path, writer, fold):
    root = tmp_path / "pq"
    ids = _write_root(writer, root, fold)["ids"]
    port = _read_root("port", root)
    jax = _read_root("jax", root)
    assert port == jax
    got_ids = {r[0] for r in port["rows"] if r[0]}
    assert ids[1] in got_ids and not {ids[2], ids[3], ids[4]} & got_ids
    assert len(port["rows"]) == 40 - 3 + 300
    upserted = [r for r in port["rows"] if r[0] == ids[1]]
    assert upserted and upserted[0][1] == "rate"


@pytest.mark.parametrize("folder", ["jax", "port"])
def test_a_fold_by_either_package_reads_the_same(tmp_path, folder):
    """Hot segments and tombstones written by the other package, folded by
    ``folder``: both packages read the folded root as they read it hot."""
    writer = "port" if folder == "jax" else "jax"
    root = tmp_path / "pq"
    _write_root(writer, root, fold=False)
    before = _read_root("jax", root)
    mod = jax_pq if folder == "jax" else pt_pq
    client = mod.ParquetClient(root, n_shards=4)
    assert mod.ParquetPEvents(client).compact(1) == len(before["rows"])
    client.close()
    for reader in ("jax", "port"):
        after = _read_root(reader, root)
        assert after["segments"][:2] == (0, 4)
        for key in ("rows", "shards", "frame", "point", "n_shards"):
            assert after[key] == before[key], (reader, key)
    assert not (root / "app_1" / "_tombstones").exists()


def test_bulk_write_segments_equal_across_packages(tmp_path):
    """One bulk frame written by each package: the same shard split and
    the same columns in each shard's segment (the dictionary encoding
    differs only where the JAX package calls pandas)."""
    frame = bulk_frame(2000, seed=9)
    cols = {k: v for k, v in frame.__dict__.items() if v is not None}
    tables = {}
    for pkg, mod, cls in (("jax", jax_pq, JaxEventFrame), ("port", pt_pq, EventFrame)):
        client = mod.ParquetClient(tmp_path / pkg, n_shards=4)
        mod.ParquetPEvents(client).write(cls(**cols), 1)
        client.close()
        per_shard = {}
        for k in range(4):
            (seg,) = (tmp_path / pkg / "app_1" / f"shard={k}").glob("seg-*.parquet")
            t = jax_pq.pq.read_table(seg).drop(["seq"])
            per_shard[k] = sorted(
                zip(*[t.column(c).cast(jax_pq.pa.string()).to_pylist()
                      if jax_pq.pa.types.is_dictionary(t.column(c).type)
                      else t.column(c).to_pylist() for c in t.column_names])
            )
        tables[pkg] = per_shard
    assert tables["port"] == tables["jax"]
    assert sum(len(v) for v in tables["port"].values()) == 2000


# ---------------------------------------------------------------------------
# pio app compact


def test_app_compact_verb_on_both_clis(tmp_path, capsys):
    got = {}
    for name, reset, config, main in (
        ("jax", jax_reset_storage, JaxStorageConfig, jax_cli.main),
        ("port", None, None, None),
    ):
        from predictionio_tpu_torch.data.storage.config import (
            StorageConfig,
            reset_storage,
        )
        from predictionio_tpu_torch.tools.cli import main as pt_main

        if name == "port":
            reset, config, main = reset_storage, StorageConfig, pt_main
        env = {
            "PIO_HOME": str(tmp_path / name),
            "PIO_STORAGE_SOURCES_PQ_TYPE": "parquet",
            "PIO_STORAGE_SOURCES_PQ_PATH": str(tmp_path / name / "ev"),
            "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / name / "db.sqlite"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PQ",
        }
        storage = reset(config.from_env(env))
        try:
            rows = []
            assert main(["app", "new", "shop"]) == 0
            app_id = storage.apps().get_by_name("shop").id
            capsys.readouterr()
            event_cls = JaxEvent if name == "jax" else Event
            datamap_cls = JaxDataMap if name == "jax" else DataMap
            storage.l_events().insert_batch(
                [event_cls(event="view", entity_type="user", entity_id=f"u{j}",
                           properties=datamap_cls({}), event_time=t(j))
                 for j in range(7)],
                app_id,
            )
            rows.append(main(["app", "compact", "shop"]))
            rows.append(capsys.readouterr().out)
            rows.append(main(["app", "compact", "shop"]))
            rows.append(capsys.readouterr().out)
            got[name] = rows
        finally:
            storage.close()
    assert got["port"] == got["jax"] == [
        0, "Compacted app shop: 7 live events.\n",
        0, "Compacted app shop: 7 live events.\n",
    ]


def test_frame_cols_equal_the_jax_backend():
    assert pt_pq.FRAME_COLS == jax_pq.FRAME_COLS
    # every EventFrame column, and not the storage-internal ``seq``
    assert set(pt_pq.FRAME_COLS) == set(EventFrame.__dataclass_fields__)
