"""The port's remote storage plane against the JAX package's, on the CPU.

- Every case of ``tests/test_remote_storage.py`` (the PIOF1 codec,
  shard-addressed scans, auth, request-id propagation, multipart models,
  slashes in names, the parquet import thread, the CLI verb, the daemon's
  error paths, and the quickstart with every repository behind the
  daemon) runs on the port's client and daemon.
- The codec: a frame encodes to the same bytes in both packages, and each
  decodes the other's bytes to equal columns, over seeded frames with
  None, non-ASCII, lazy and dict documents, tags, and a column past the
  dedup threshold.
- Both pairings: the port's client against the JAX daemon, the JAX client
  against the port's daemon, every repository.
- ``frame_shard_of`` equals the JAX function on 10,000 seeded pairs.
- Train, deploy and query over the daemon: the port's train (on the CPU)
  and the JAX package's, from one seeded ``init_factors``, give factors
  within 2e-3; the deploy's answers are the plain top-k of the stored
  factors, ids exact, the last position read with num+1 scores.
- The daemon's death and revival: a SIGKILLed daemon process turns the
  deploy's ``/readyz`` not ready on ``storage_breakers``, ``/slo.json``
  shows the breaker open, the event server answers 503 + ``Retry-After``,
  device-free answers keep coming from the bound model; restarted on the
  same root, the breaker closes and every acknowledged event reads back.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import resolve_engine_factory as jax_resolve
from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data import DataMap as JaxDataMap
from predictionio_tpu.data import Event as JaxEvent
from predictionio_tpu.data.storage import base as jax_base
from predictionio_tpu.data.storage import frame_codec as jax_codec
from predictionio_tpu.data.storage import remote_backend as jax_remote
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.models import recommendation as jax_recommendation  # noqa: F401
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.server.storage_server import StorageServer as JaxStorageServer
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as pt_base
from predictionio_tpu_torch.data.storage import frame_codec as pt_codec
from predictionio_tpu_torch.data.storage.base import EventFilter, EventFrame
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.frame_codec import decode_frame, encode_frame
from predictionio_tpu_torch.data.storage.remote_backend import (
    RemoteApps,
    RemoteClient,
    RemoteModels,
    RemotePEvents,
    RemoteStorageError,
    StorageUnavailable,
    filter_from_dict,
    filter_to_dict,
)
from predictionio_tpu_torch.models import recommendation  # noqa: F401
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience import breaker as pt_breaker
from predictionio_tpu_torch.server import event_server as pt_es
from predictionio_tpu_torch.server import httpd as pt_httpd
from predictionio_tpu_torch.server.prediction_server import create_prediction_server
from predictionio_tpu_torch.server.storage_server import StorageServer
from predictionio_tpu_torch.tools import commands as cmd

torch.set_num_threads(2)

TIMEOUT = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(i):
    return datetime(2026, 1, 1, 0, 0, i, tzinfo=timezone.utc)


def mk(event, eid, i, target=None, props=None):
    return Event(
        event=event,
        entity_type="user",
        entity_id=eid,
        target_entity_type="item" if target else None,
        target_entity_id=target,
        properties=DataMap(props or {}),
        event_time=t(i),
    )


@pytest.fixture()
def daemon(tmp_path):
    s = StorageServer(tmp_path / "root", host="127.0.0.1", port=0)
    s.start_background()
    yield s
    s.shutdown()


@pytest.fixture()
def client(daemon):
    return RemoteClient(f"http://127.0.0.1:{daemon.port}", timeout=TIMEOUT)


def _remote_env(home, url, **extra) -> dict:
    env = {
        "PIO_HOME": str(home),
        "PIO_STORAGE_SOURCES_R_TYPE": "remote",
        "PIO_STORAGE_SOURCES_R_URL": url,
        "PIO_STORAGE_SOURCES_R_TIMEOUT": str(TIMEOUT),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R",
    }
    env.update({f"PIO_STORAGE_SOURCES_R_{k}": str(v) for k, v in extra.items()})
    return env


@pytest.fixture(autouse=True)
def _isolate_breakers():
    pt_breaker.reset_breakers()
    yield
    pt_breaker.reset_breakers()


# ---------------------------------------------------------------------------
# the wire codec (tests/test_remote_storage.py::TestFrameCodec)


class TestFrameCodec:
    def test_roundtrip_full(self):
        events = [
            mk("rate", "u1", 1, target="i1", props={"rating": 4.5}).with_id(),
            mk("$set", "uñicode", 2, props={"name": "héllo", "n": 3}).with_id(),
            mk("view", "u3", 3).with_id(),
        ]
        frame = EventFrame.from_events(events)
        out = decode_frame(encode_frame(frame))
        assert len(out) == 3
        assert out.event.tolist() == frame.event.tolist()
        assert out.entity_id.tolist() == frame.entity_id.tolist()
        assert out.target_entity_type[2] is None
        assert json.loads(out.properties[0]) == {"rating": 4.5}
        assert out.properties[2] == ""
        np.testing.assert_allclose(out.property_column("rating")[:1], [4.5])
        assert out.to_events()[0].properties.fields == {"rating": 4.5}
        assert out.event_id.tolist() == frame.event_id.tolist()
        np.testing.assert_array_equal(out.event_time_ms, frame.event_time_ms)
        np.testing.assert_array_equal(out.creation_time_ms, frame.creation_time_ms)

    def test_roundtrip_empty_and_missing_cols(self):
        empty = EventFrame.from_events([])
        assert len(decode_frame(encode_frame(empty))) == 0
        n = 2
        frame = EventFrame(
            event=np.array(["a", "b"], object),
            entity_type=np.array(["user"] * n, object),
            entity_id=np.array(["u1", "u2"], object),
            target_entity_type=np.array([None, None], object),
            target_entity_id=np.array([None, None], object),
            event_time_ms=np.array([1, 2], np.int64),
            properties=np.array([{}, {"x": 1}], object),
        )
        out = decode_frame(encode_frame(frame))
        assert out.event_id is None and out.tags is None
        assert json.loads(out.properties[1]) == {"x": 1}

    def test_rejects_junk(self):
        with pytest.raises(ValueError):
            decode_frame(b"not a frame at all")

    def test_filter_codec_roundtrip(self):
        f = EventFilter(
            start_time=t(1),
            until_time=t(9),
            entity_type="user",
            event_names=("rate", "buy"),
            target_entity_type="",
            limit=7,
            reversed=True,
        )
        back = filter_from_dict(filter_to_dict(f))
        assert back == f
        assert filter_to_dict(None) is None
        assert filter_from_dict(None) is None
        jf = jax_base.EventFilter(**dataclasses.asdict(f))
        assert filter_to_dict(f) == jax_remote.filter_to_dict(jf)


def _seeded_frame(n: int, seed: int, distinct_props: bool = False) -> dict:
    """The columns of a seeded frame: repetitive and distinct ids, None
    targets and ids, non-ASCII strings, lazy or dict documents, tags."""
    rng = np.random.default_rng(seed)
    users = np.array([f"u{i}" for i in range(max(n // 20, 1))], object)
    items = np.array([f"ítem{i}" for i in range(50)], object)
    docs = np.array([json.dumps({"rating": v / 2}) for v in range(1, 11)], object)
    tag_vocab = [(), ("a",), ("a", "b")]
    ev = np.empty(n, object)
    ev[:] = "rate"
    tid = items[rng.integers(0, 50, n)]
    tid[::7] = None
    tt = np.empty(n, object)
    tt[:] = None
    tt[np.not_equal(tid, None)] = "item"
    props = (
        np.array([{"r": int(i)} for i in range(n)] + [None], object)[:n]
        if distinct_props
        else docs[rng.integers(0, 10, n)]
    )
    eid = np.array([f"{i:016x}" for i in rng.integers(0, 2**62, n)], object)
    eid[::11] = None
    tags = np.empty(n, object)
    for j, k in enumerate(rng.integers(0, 3, n)):
        tags[j] = tag_vocab[k]
    return dict(
        event=ev,
        entity_type=np.array(["user"] * n, object),
        entity_id=users[rng.integers(0, len(users), n)],
        target_entity_type=tt,
        target_entity_id=tid,
        event_time_ms=np.arange(n, dtype=np.int64) + 1_700_000_000_000,
        properties=props,
        event_id=eid,
        tags=tags,
        pr_id=np.array([None] * n, object),
        creation_time_ms=np.arange(n, dtype=np.int64) + 5,
    )


@pytest.mark.parametrize(
    "n,seed,distinct_props",
    [(0, 0, False), (5, 1, False), (3000, 2, False), (3000, 3, True), (20000, 4, False)],
)
def test_codec_bytes_equal_across_packages(n, seed, distinct_props):
    cols = _seeded_frame(n, seed, distinct_props)
    pt_bytes = pt_codec.encode_frame(EventFrame(**cols))
    jax_bytes = jax_codec.encode_frame(jax_base.EventFrame(**cols))
    assert pt_bytes == jax_bytes
    ours = pt_codec.decode_frame(jax_bytes)
    theirs = jax_codec.decode_frame(pt_bytes)
    for f in dataclasses.fields(EventFrame):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert list(a) == list(b), f.name


# ---------------------------------------------------------------------------
# frame_shard_of


def test_frame_shard_of_equals_the_jax_function_on_10000_pairs():
    rng = np.random.default_rng(10_000)
    types = np.array(["user", "item", "ütype"], object)
    ids = np.array([f"e{i}" for i in range(1500)], object)
    et = types[rng.integers(0, 3, 10_000)]
    ei = ids[rng.integers(0, 1500, 10_000)]
    # half the ids as distinct objects: the value pass, not the pointer pass
    ei = np.array([x if j % 2 else "".join(list(x)) for j, x in enumerate(ei)], object)
    for n in (1, 3, 8, 16, 64):
        got = pt_base.frame_shard_of(et, ei, n)
        want = jax_base.frame_shard_of(et, ei, n)
        np.testing.assert_array_equal(got, want)
        assert got[0] == pt_base.entity_shard(et[0], ei[0], n)


def test_sqlite_iter_shards_splits_as_the_jax_package(tmp_path):
    """One sqlite event table read by both packages: the same shard count
    and, shard for shard, the same rows (the host split of one scan)."""
    from predictionio_tpu.data.storage.sqlite_backend import (
        SQLitePEvents as JaxSQLitePEvents,
    )
    from predictionio_tpu_torch.data.storage.sqlite_backend import SQLitePEvents

    env = {"PIO_HOME": str(tmp_path)}
    mine = StorageRuntime(StorageConfig.from_env(env))
    theirs = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    try:
        mine.l_events().insert_batch(
            [mk("rate", f"u{j % 37}", j % 60, target=f"i{j % 11}") for j in range(400)], 3
        )
        pe, jpe = mine.p_events(), theirs.p_events()
        assert isinstance(pe, SQLitePEvents) and isinstance(jpe, JaxSQLitePEvents)
        assert pe.n_shards(3) == jpe.n_shards(3) == 8
        for flt in (None, EventFilter(event_names=("rate",), limit=150)):
            jflt = None if flt is None else jax_base.EventFilter(**dataclasses.asdict(flt))
            got = {k: sorted(f.event_id.tolist()) for k, f in pe.iter_shards(3, filter=flt)}
            want = {k: sorted(f.event_id.tolist()) for k, f in jpe.iter_shards(3, filter=jflt)}
            assert got == want and sum(map(len, got.values())) == (400 if flt is None else 150)
        got = {k: len(f) for k, f in pe.iter_shards(3, shards=[1, 5], n_shards=16)}
        want = {k: len(f) for k, f in jpe.iter_shards(3, shards=[1, 5], n_shards=16)}
        assert got == want and set(got) == {1, 5}
    finally:
        theirs.close()
        mine.close()


def test_sqlite_daemon_serves_shard_addressed_scans(tmp_path):
    """``storageserver --events sqlite``: /shards names the sqlite store's
    8 scan shards and a shard-restricted /frame holds only its rows."""
    s = StorageServer(tmp_path / "root", host="127.0.0.1", port=0,
                      events="sqlite").start_background()
    try:
        pe = RemotePEvents(RemoteClient(f"http://127.0.0.1:{s.port}", timeout=TIMEOUT))
        pe.write(EventFrame.from_events(
            [mk("view", f"u{j}", j % 60).with_id() for j in range(120)]), 2)
        assert pe.n_shards(2) == 8
        seen = []
        for k, f in pe.iter_shards(2):
            assert all(pt_base.entity_shard(et, e, 8) == k
                       for et, e in zip(f.entity_type, f.entity_id))
            seen += f.entity_id.tolist()
        assert sorted(seen) == sorted(f"u{j}" for j in range(120))
        (k, only), = list(pe.iter_shards(2, shards=[3]))
        assert k == 3 and all(pt_base.entity_shard("user", e, 8) == 3 for e in only.entity_id)
        assert pe.compact(2) is None  # sqlite rewrites in place
        assert pe.status(2) == {"supported": False}
    finally:
        s.shutdown()


# ---------------------------------------------------------------------------
# shard-addressed scans (tests/test_remote_storage.py::TestRemoteScan)


class TestRemoteScan:
    def test_iter_shards_matches_find_and_is_disjoint(self, daemon, client):
        pe = RemotePEvents(client)
        events = [
            mk("rate", f"u{i}", i % 50, target=f"i{i % 7}", props={"rating": 1.0})
            for i in range(200)
        ]
        pe.write(EventFrame.from_events([e.with_id() for e in events]), 1)
        whole = pe.find(1)
        assert len(whole) == 200
        n = pe.n_shards(1)
        assert n > 1
        seen = []
        for k, f in pe.iter_shards(1):
            seen.extend(f.entity_id.tolist())
            for et, eid in zip(f.entity_type, f.entity_id):
                assert pt_base.entity_shard(et, eid, n) == k
        assert sorted(seen) == sorted(whole.entity_id.tolist())

    def test_filtered_shard_scan(self, daemon, client):
        pe = RemotePEvents(client)
        frame = EventFrame.from_events(
            [
                mk("rate", "u1", 1, target="i1", props={"rating": 5.0}).with_id(),
                mk("view", "u1", 2, target="i2").with_id(),
            ]
        )
        pe.write(frame, 1)
        flt = EventFilter(event_names=("rate",))
        assert sum(len(f) for _, f in pe.iter_shards(1, filter=flt)) == 1

    def test_bulk_delete(self, daemon, client):
        pe = RemotePEvents(client)
        frame = EventFrame.from_events(
            [mk("view", "u1", 1).with_id(), mk("view", "u2", 2).with_id()]
        )
        pe.write(frame, 1)
        pe.delete([frame.event_id[0]], 1)
        assert pe.find(1).entity_id.tolist() == ["u2"]

    def test_remote_compact(self, daemon, client):
        pe = RemotePEvents(client)
        frame = EventFrame.from_events(
            [mk("view", f"u{i}", i % 50).with_id() for i in range(10)]
        )
        pe.write(frame, 1)
        pe.delete(list(frame.event_id[:4]), 1)
        assert pe.compact(1) == 6
        assert len(pe.find(1)) == 6


# ---------------------------------------------------------------------------
# auth and operations (tests/test_remote_storage.py::TestAuthAndOps)


class TestAuthAndOps:
    def test_access_key_gates_every_route(self, tmp_path):
        s = StorageServer(
            tmp_path / "root", host="127.0.0.1", port=0, access_key="sekret"
        ).start_background()
        try:
            url = f"http://127.0.0.1:{s.port}"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(url + "/v1/apps", timeout=TIMEOUT)
            assert ei.value.code == 401
            c = RemoteClient(url, auth_key="sekret", timeout=TIMEOUT)
            assert c.json("GET", "/v1/ping")["status"] == "alive"
            assert c.json("GET", "/v1/apps") == []
            bad = RemoteClient(url, auth_key="wrong", timeout=TIMEOUT)
            with pytest.raises(RemoteStorageError):
                bad.json("GET", "/v1/apps")
        finally:
            s.shutdown()

    def test_unreachable_daemon_raises_clean_error(self):
        c = RemoteClient("http://127.0.0.1:9", timeout=0.5)
        with pytest.raises(RemoteStorageError):
            c.json("GET", "/v1/ping")

    def test_request_id_crosses_the_process_boundary(self, daemon, client):
        from predictionio_tpu_torch.obs.logging import (
            reset_request_context,
            set_request_context,
        )

        rid = "corr-e2e-1234"
        tokens = set_request_context(rid)
        try:
            RemoteApps(client).get_all()
        finally:
            reset_request_context(tokens)
        snap = daemon.app.flight.snapshot(request_id=rid)
        assert snap["slowest"], "daemon flight entry missing the client's id"
        entry = snap["slowest"][0]
        assert entry["request_id"] == rid
        assert entry["path"] == "/v1/apps"
        RemoteApps(client).get_all()
        snap = daemon.app.flight.snapshot(request_id=rid)
        assert len(snap["slowest"]) == 1
        unfiltered = daemon.app.flight.snapshot()
        assert len(unfiltered["slowest"]) == 2
        other = [e for e in unfiltered["slowest"] if e["request_id"] != rid]
        assert len(other) == 1 and len(other[0]["request_id"]) == 16

    def test_multipart_model_checkpoint(self, daemon, client):
        m = RemoteModels(client)
        parts = {"leaf0": b"\x00" * 1000, "leaf1": b"\xff" * 10}
        m.insert_parts("inst9", b'{"leaves": 2}', parts)
        assert m.get_manifest("inst9") == b'{"leaves": 2}'
        assert m.get_part("inst9", "leaf0") == parts["leaf0"]
        assert m.get_part("inst9", "leaf1") == parts["leaf1"]
        assert m.delete_models("inst9")
        assert m.get_manifest("inst9") is None

    def test_path_segments_with_slashes(self, daemon, client):
        apps = RemoteApps(client)
        app_id = apps.insert(pt_base.App(id=0, name="team/rec", description=None))
        assert app_id is not None
        got = apps.get_by_name("team/rec")
        assert got is not None and got.id == app_id
        m = RemoteModels(client)
        m.insert("inst/with/slashes", b"blob")
        assert m.get("inst/with/slashes") == b"blob"
        assert m.delete("inst/with/slashes")

    def test_first_parquet_touch_in_worker_thread(self):
        """The arrow-in-a-dying-thread crash recipe, in a subprocess so a
        regression fails the test instead of killing the suite."""
        code = textwrap.dedent(
            """
            import tempfile, threading
            from datetime import datetime, timezone
            from predictionio_tpu_torch.data.datamap import DataMap
            from predictionio_tpu_torch.data.event import Event
            from predictionio_tpu_torch.data.storage.base import EventFrame
            from predictionio_tpu_torch.server.storage_server import runtime_for_root

            frame = EventFrame.from_events([
                Event(event="view", entity_type="user", entity_id=f"u{i}",
                      properties=DataMap({}),
                      event_time=datetime(2026, 1, 1, tzinfo=timezone.utc)
                      ).with_id()
                for i in range(100)
            ])
            for rep in range(6):
                rt = runtime_for_root(tempfile.mkdtemp())
                err = []
                def work():
                    try:
                        rt.p_events().write(frame, 1)
                    except Exception as e:
                        err.append(e)
                th = threading.Thread(target=work)
                th.start(); th.join()
                assert not err, err
                rt.close()
            print("OK")
            """
        )
        out = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=120,
            cwd=REPO,
        )
        assert out.returncode == 0, f"crashed: rc={out.returncode}\n{out.stderr[-2000:]}"
        assert "OK" in out.stdout

    def test_cli_verb_registered(self):
        from predictionio_tpu_torch.tools.cli import build_parser

        args = build_parser().parse_args(
            ["storageserver", "--port", "0", "--root", "/tmp/x"]
        )
        assert args.fn.__name__ == "do_storageserver"


# ---------------------------------------------------------------------------
# the daemon's error paths (tests/test_remote_storage.py::TestDaemonErrorPaths)


class TestDaemonErrorPaths:
    def test_invalid_event_batch_400(self, daemon, client):
        status, raw = client.request(
            "POST", "/v1/apps/1/events",
            body=json.dumps([{"entityType": "user"}]).encode(),
        )
        assert status == 400
        assert b"invalid event" in raw

    def test_malformed_frame_body_500_and_store_intact(self, daemon, client):
        pe = RemotePEvents(client)
        pe.write(EventFrame.from_events([mk("view", "u1", 1).with_id()]), 1)
        status, _ = client.request(
            "POST", "/v1/apps/1/frame",
            body=b"definitely not a PIOF1 frame",
            content_type="application/x-pio-frame",
        )
        assert status == 500
        assert len(pe.find(1)) == 1

    def test_unknown_route_404_wrong_method_405(self, daemon, client):
        status, _ = client.request("GET", "/v1/nope")
        assert status == 404
        status, _ = client.request("DELETE", "/v1/ping")
        assert status == 405

    def test_bad_filter_json_is_500_not_hang(self, daemon, client):
        status, _ = client.request(
            "GET", "/v1/apps/1/events", params={"filter": "{broken"}
        )
        assert status == 500

    def test_get_missing_entities_404(self, daemon, client):
        assert client.json("GET", "/v1/apps/id/999", ok_404=True) is None
        assert client.json("GET", "/v1/engine_instances/nope", ok_404=True) is None
        status, _ = client.request("GET", "/v1/models/ghost")
        assert status == 404


# ---------------------------------------------------------------------------
# both pairings across the packages


def _exercise_all_repositories(rt, base, event_cls, datamap_cls, tag):
    """Metadata, row and bulk events, and models through one runtime;
    returns what it read back, in package-neutral form."""
    app_id = rt.apps().insert(base.App(id=0, name=f"app-{tag}", description="d"))
    rt.access_keys().insert(base.AccessKey(key=f"k-{tag}", appid=app_id, events=("rate",)))
    ch = rt.channels().insert(base.Channel(id=0, name="ch", appid=app_id))
    le, pe = rt.l_events(), rt.p_events()
    le.init(app_id)
    ids = le.insert_batch(
        [
            event_cls(
                event="rate", entity_type="user", entity_id=f"u{j}",
                target_entity_type="item", target_entity_id=f"i{j % 3}",
                properties=datamap_cls({"rating": float(j % 5)}),
                event_time=t(j),
            )
            for j in range(12)
        ],
        app_id,
    )
    frame_cls = type(pe.find(app_id))
    bulk = frame_cls.from_events(
        [
            event_cls(
                event="buy", entity_type="user", entity_id=f"b{j}",
                target_entity_type="item", target_entity_id="i0",
                event_time=t(30 + j),
            ).with_id()
            for j in range(5)
        ]
    )
    pe.write(bulk, app_id)
    le.delete(ids[0], app_id)
    rt.models().insert_parts("inst-x", b"manifest", {"p0": b"\x01\x02", "p1": b""})
    whole = pe.find(app_id)
    shards = sorted(
        (k, sorted(f.entity_id.tolist())) for k, f in pe.iter_shards(app_id)
    )
    return {
        "apps": [(a.name, a.description) for a in rt.apps().get_all()],
        "keys": [(k.key, tuple(k.events)) for k in rt.access_keys().get_all()],
        "channel": ch is not None,
        "rows": sorted(
            zip(whole.event.tolist(), whole.entity_id.tolist(),
                whole.target_entity_id.tolist(), whole.event_time_ms.tolist())
        ),
        "point": le.get(ids[1], app_id).entity_id,
        "entity": [e.entity_id for e in le.find_by_entity(app_id, "user", "u3")],
        "n_shards": pe.n_shards(app_id),
        "shards": shards,
        "manifest": rt.models().get_manifest("inst-x"),
        "parts": (rt.models().get_part("inst-x", "p0"), rt.models().get_part("inst-x", "p1")),
        "compacted": pe.compact(app_id),
    }


@pytest.mark.parametrize("pairing", ["port-client-jax-daemon", "jax-client-port-daemon"])
def test_client_and_daemon_pairings_across_packages(tmp_path, pairing):
    """Each pairing reads back what a same-package pairing reads back."""
    results = {}
    for name, daemon_cls, client_side in (
        ("same", StorageServer, "port"),
        ("cross", JaxStorageServer if pairing.startswith("port") else StorageServer,
         "port" if pairing.startswith("port") else "jax"),
    ):
        d = daemon_cls(tmp_path / name, host="127.0.0.1", port=0).start_background()
        try:
            url = f"http://127.0.0.1:{d.port}"
            env = _remote_env(tmp_path / f"{name}_home", url)
            if client_side == "port":
                rt = StorageRuntime(StorageConfig.from_env(env))
                results[name] = _exercise_all_repositories(rt, pt_base, Event, DataMap, "x")
            else:
                rt = JaxStorageRuntime(JaxStorageConfig.from_env(env))
                results[name] = _exercise_all_repositories(
                    rt, jax_base, JaxEvent, JaxDataMap, "x"
                )
            rt.close()
        finally:
            d.shutdown()
    assert results["cross"] == results["same"]
    assert len(results["same"]["rows"]) == 16  # 12 rows + 5 bulk - 1 deleted
    assert results["same"]["compacted"] == 16


# ---------------------------------------------------------------------------
# the quickstart over the daemon (tests/test_remote_storage.py::TestRemoteQuickstart)

N_USERS, N_ITEMS, N_RATINGS, RANK = 25, 15, 300, 8


def _seeded_train_als(monkeypatch, mod):
    """Wrap the engine module's ``train_als`` to start from factors drawn
    from one seed (both packages' cold draws differ by design)."""
    real = mod.train_als

    def wrapped(u, i, r, num_users, num_items, params, **kw):
        kw.pop("init_factors", None)  # a warm start's: none here
        rng = np.random.default_rng(11)
        init = tuple(
            (np.abs(rng.standard_normal((n, params.rank))) / np.sqrt(params.rank))
            .astype(np.float32)
            for n in (num_users, num_items)
        )
        return real(u, i, r, num_users=num_users, num_items=num_items,
                    params=params, init_factors=init, **kw)

    monkeypatch.setattr(mod, "train_als", wrapped)


def _ratings_file(tmp_path):
    rng = np.random.default_rng(7)
    path = tmp_path / "events.jsonl"
    with open(path, "w") as f:
        for j in range(N_RATINGS):
            u, i = rng.integers(N_USERS), rng.integers(N_ITEMS)
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": float(rng.integers(1, 6))},
                "eventTime": time.strftime(
                    "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(1_700_000_000 + j)
                ),
            }) + "\n")
    return path


ENGINE_JSON = {
    "datasource": {"params": {"appName": "remoteqs"}},
    "algorithms": [
        {"name": "als", "params": {"rank": RANK, "numIterations": 10,
                                   "lambda": 0.01, "seed": 3}}
    ],
}


def _factors_by_key(model) -> tuple[dict, dict]:
    """{entity id: factor row} of a loaded model (a persisted dict of host
    arrays and vocabulary key arrays, or a model object)."""
    if isinstance(model, dict):
        U, V = model["user_factors"], model["item_factors"]
        uk, ik = model["user_vocab"], model["item_vocab"]
    else:
        U, V = model.user_factors, model.item_factors
        uk, ik = model.user_vocab.keys_array(), model.item_vocab.keys_array()
    U, V = np.asarray(U), np.asarray(V)
    return ({str(k): U[i] for i, k in enumerate(uk)},
            {str(k): V[i] for i, k in enumerate(ik)})


class TestRemoteQuickstart:
    def test_train_deploy_query_over_daemon(self, tmp_path, monkeypatch):
        """The whole journey with every repository behind a daemon, on
        each package: app and key (metadata), import (events), train and
        save (models), deploy and query (reads back through the daemon)."""
        _seeded_train_als(monkeypatch, jax_rec)
        _seeded_train_als(monkeypatch, pt_rec)
        events = _ratings_file(tmp_path)
        models = {}
        for name in ("jax", "port"):
            daemon_cls = JaxStorageServer if name == "jax" else StorageServer
            d = daemon_cls(tmp_path / f"{name}_root", host="127.0.0.1", port=0)
            d.start_background()
            try:
                env = _remote_env(tmp_path / f"{name}_home", f"http://127.0.0.1:{d.port}")
                if name == "jax":
                    storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
                    jax_cmd.app_new(storage, "remoteqs")
                    assert jax_cmd.import_events(storage, "remoteqs", events) == N_RATINGS
                    engine = jax_resolve("recommendation")()
                    instance = jax_run_train(
                        engine, engine.params_from_json(ENGINE_JSON),
                        ctx=JaxEngineContext(storage=storage),
                        engine_factory="recommendation", storage=storage,
                    )
                    models[name] = jax_load_models(storage.models(), instance.id)[0]
                else:
                    storage = StorageRuntime(StorageConfig.from_env(env))
                    cmd.app_new(storage, "remoteqs")
                    assert cmd.import_events(storage, "remoteqs", events) == N_RATINGS
                    engine = resolve_engine_factory("recommendation")()
                    instance = run_train(
                        engine, engine.params_from_json(ENGINE_JSON),
                        ctx=EngineContext(storage=storage, device="cpu"),
                        engine_factory="recommendation", storage=storage,
                    )
                    assert instance.status == "COMPLETED"
                    # the blob lives in the daemon's store
                    assert storage.models().get_manifest(instance.id) is not None
                    model = load_models(storage.models(), instance.id)[0]
                    models[name] = model
                    self._serve_and_hold(storage, model)
                storage.close()
            finally:
                d.shutdown()
        pu, pi = _factors_by_key(models["port"])
        ju, ji = _factors_by_key(models["jax"])
        assert pu.keys() == ju.keys() and pi.keys() == ji.keys()
        for got, want in ((pu, ju), (pi, ji)):
            keys = sorted(got)
            np.testing.assert_allclose(
                np.stack([got[k] for k in keys]), np.stack([want[k] for k in keys]),
                atol=2e-3, rtol=0,
            )

    @staticmethod
    def _serve_and_hold(storage, model):
        """Every user's answer from the deploy equals the plain top-k of the
        stored factors: ids exact, scores within float32 rounding, the last
        position checked against the num+1-th score for a near tie."""
        num = 3
        U = np.asarray(model["user_factors"])
        V = np.asarray(model["item_factors"])
        keys = [str(k) for k in model["item_vocab"]]
        item_index = {k: j for j, k in enumerate(keys)}
        server = create_prediction_server(
            "recommendation", host="127.0.0.1", port=0, storage=storage,
            device="cpu",
        ).start_background()
        try:
            for ui, user in enumerate(str(k) for k in model["user_vocab"]):
                conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
                conn.request("POST", "/queries.json",
                             json.dumps({"user": user, "num": num}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                got = json.loads(resp.read())["itemScores"]
                conn.close()
                assert resp.status == 200
                scores = V @ U[ui]
                order = sorted(range(len(scores)), key=lambda j: (-scores[j], j))
                want = [keys[j] for j in order[: num + 1]]
                assert [g["item"] for g in got[: num - 1]] == want[: num - 1]
                assert got[num - 1]["item"] in want[num - 1: num + 1]
                for g in got:
                    j = item_index[g["item"]]
                    assert abs(g["score"] - float(scores[j])) <= 1e-5 * max(1.0, abs(scores[j]))
                if abs(scores[order[num - 1]] - scores[order[num]]) > 1e-5:
                    assert got[num - 1]["item"] == want[num - 1]
        finally:
            server.shutdown()


# ---------------------------------------------------------------------------
# the daemon's death and revival


def _spawn_daemon(root, port: int) -> tuple[subprocess.Popen, int]:
    """``storageserver`` as a process of its own; returns it and the port
    it printed once bound."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
         "storageserver", "--ip", "127.0.0.1", "--port", str(port),
         "--root", str(root), "--no-compact"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO,
    )
    line = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(timeout=60)
    if not line or "Storage daemon on http://" not in line[0]:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
        raise RuntimeError(f"storage daemon did not bind: {line}")
    return proc, int(line[0].split("http://127.0.0.1:")[1].split()[0])


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_daemon_death_and_revival(tmp_path):
    proc, port = _spawn_daemon(tmp_path / "root", 0)
    proc2 = None
    env = _remote_env(
        tmp_path / "home", f"http://127.0.0.1:{port}",
        RETRIES=1, BREAKER_THRESHOLD=1, BREAKER_RESET_S=0.5, TIMEOUT=2,
    )
    storage = StorageRuntime(StorageConfig.from_env(env))
    try:
        desc = cmd.app_new(storage, "life")
        key = desc.keys[0].key
        app_id = desc.app.id
        le = storage.l_events()
        acked = list(le.insert_batch(
            [mk("rate", f"u{j % 6}", j, target=f"i{j % 4}",
                props={"rating": float(1 + j % 5)}) for j in range(60)],
            app_id,
        ))
        engine = resolve_engine_factory("recommendation")()
        instance = run_train(
            engine,
            engine.params_from_json({
                "datasource": {"params": {"appName": "life"}},
                "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3}}],
            }),
            ctx=EngineContext(storage=storage, device="cpu"),
            engine_factory="recommendation", storage=storage,
        )
        server = create_prediction_server(
            "recommendation", host="127.0.0.1", port=0, storage=storage,
            engine_instance_id=instance.id, device="cpu",
        ).start_background()
        es_app = pt_es.create_event_server_app(storage, registry=MetricsRegistry())
        try:
            assert _get(server.port, "/readyz")[0] == 200
            before = _get(server.port, "/queries.json")  # GET: 405, server alive
            assert before[0] in (404, 405)

            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=TIMEOUT)

            # the event server answers 503 + Retry-After, not 500
            body = json.dumps({"event": "rate", "entityType": "user",
                               "entityId": "u1", "targetEntityType": "item",
                               "targetEntityId": "i1",
                               "properties": {"rating": 3.0}}).encode()
            r = es_app.handle(pt_httpd.Request(
                "POST", "/events.json", {"accessKey": key}, {}, body))
            assert r.status == 503 and int(r.headers["Retry-After"]) >= 1
            with pytest.raises(StorageUnavailable):
                le.insert(mk("rate", "u1", 58), app_id)
            # the deploy keeps answering from the bound model
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
            conn.request("POST", "/queries.json", json.dumps({"user": "u1", "num": 2}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200 and len(json.loads(resp.read())["itemScores"]) == 2
            conn.close()
            # /readyz turns not ready on storage_breakers; /slo.json shows it
            status, ready = _get(server.port, "/readyz")
            assert status == 503 and ready["checks"]["storage_breakers"] is False
            slo = _get(server.port, "/slo.json")[1]
            assert slo["breakers"][f"storage:127.0.0.1:{port}"]["state"] == "open"

            proc2, port2 = _spawn_daemon(tmp_path / "root", port)
            assert port2 == port
            # the breaker half-opens after BREAKER_RESET_S; the trial write
            # closes it (bounded wait, no race on a fixed sleep)
            deadline = time.monotonic() + 30
            while True:
                try:
                    acked.append(le.insert(mk("rate", "u2", 59), app_id))
                    break
                except StorageUnavailable:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
            assert storage.breakers()[0].state == "closed"
            r = es_app.handle(pt_httpd.Request(
                "POST", "/events.json", {"accessKey": key}, {}, body))
            assert r.status == 201
            acked.append(r.body["eventId"])
            assert _get(server.port, "/readyz")[0] == 200
            got = sorted(e.event_id for e in le.find(app_id, filter=EventFilter(limit=-1)))
            assert got == sorted(acked)
        finally:
            server.shutdown()
    finally:
        storage.close()
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=TIMEOUT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=TIMEOUT)


@pytest.mark.parametrize("typ", ["postgres", "jdbc"])
def test_postgres_sources_wait_for_their_slice(tmp_path, typ):
    """A postgres source resolves to the postgres backend (its own slice
    has landed): with no server listening, the port's runtime fails the
    connect as the JAX package's does, through the libpq driver."""
    from predictionio_tpu.data.storage import pq_driver as jax_pq
    from predictionio_tpu.data.storage.config import StorageConfig as JaxConfig
    from predictionio_tpu.data.storage.config import StorageRuntime as JaxRuntime
    from predictionio_tpu_torch.data.storage import pq_driver

    if not pq_driver.available():
        pytest.skip("libpq not present on this host")
    env = {
        "PIO_HOME": str(tmp_path),
        "PIO_STORAGE_SOURCES_PG_TYPE": typ,
        "PIO_STORAGE_SOURCES_PG_URL":
            "postgresql://nobody@127.0.0.1:1/pio?connect_timeout=2",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PG",
    }
    errors = []
    for runtime, config, err in ((StorageRuntime, StorageConfig, pq_driver.PQError),
                                 (JaxRuntime, JaxConfig, jax_pq.PQError)):
        rt = runtime(config.from_env(env))
        with pytest.raises(err, match="connection failed") as info:
            rt.apps()
        errors.append(str(info.value).split(":")[0])
        rt.close()
    assert errors[0] == errors[1] == "connection failed"


def test_remote_source_needs_a_url_and_exposes_its_breakers(tmp_path):
    from predictionio_tpu_torch.data.storage.config import StorageError

    rt = StorageRuntime(StorageConfig.from_env({
        "PIO_HOME": str(tmp_path),
        "PIO_STORAGE_SOURCES_R_TYPE": "remote",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
    }))
    with pytest.raises(StorageError, match="PIO_STORAGE_SOURCES_R_URL"):
        rt.l_events()
    assert rt.breakers() == []
    rt.close()
    rt = StorageRuntime(StorageConfig.from_env({
        "PIO_HOME": str(tmp_path),
        "PIO_STORAGE_SOURCES_R_TYPE": "remote",
        "PIO_STORAGE_SOURCES_R_URL": "http://127.0.0.1:2,http://127.0.0.1:3",
        "PIO_STORAGE_SOURCES_R_BREAKER_THRESHOLD": "3",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
    }))
    try:
        from predictionio_tpu_torch.data.storage.remote_backend import FanoutLEvents

        assert isinstance(rt.l_events(), FanoutLEvents)
        names = sorted(b.name for b in rt.breakers())
        assert names == ["storage:127.0.0.1:2", "storage:127.0.0.1:3"]
        assert {b.failure_threshold for b in rt.breakers()} == {3}
    finally:
        rt.close()


@pytest.mark.parametrize("values,null_value,transform", [
    (["a", "b", "a", None, "c", "b"], None, None),
    ([None, None, None], "", None),
    ([], None, None),
    (['{"k": 1}', "{}", '{"k": 1}', None], {}, json.loads),
    (["x"] * 5, None, str.upper),
])
def test_dictionary_to_objects_equals_the_jax_codec(values, null_value, transform):
    import pyarrow as pa

    from predictionio_tpu.data.storage import parquet_backend as jax_pq
    from predictionio_tpu_torch.data.storage import frame_codec as pt_codec
    from predictionio_tpu_torch.data.storage import parquet_backend as pt_pq

    arr = pa.array(values, pa.string()).dictionary_encode()
    got = pt_codec.dictionary_to_objects(arr, null_value, transform)
    want = jax_codec.dictionary_to_objects(arr, null_value, transform)
    assert got.dtype == want.dtype == object
    assert got.tolist() == want.tolist()
    # one definition, importable from both of the port's modules (as the
    # JAX package's parquet backend imports it too)
    assert pt_pq.dictionary_to_objects is pt_codec.dictionary_to_objects
    assert jax_pq.dictionary_to_objects is jax_codec.dictionary_to_objects
