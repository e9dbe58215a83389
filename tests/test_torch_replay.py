"""Decision replay on the port against the JAX package's.

``obs.provenance``'s ``_diff_items`` and ``generation_info`` on the same
inputs; then a JAX-trained model deployed by the port on the CPU: each
answer's record names its generation (checksum, status, engine
coordinates), and ``replay-request`` rebinds those bytes and re-answers
through the host replica.  A solo answer replays ``MATCHED`` (exit 0),
from ``--url`` and from ``--record``, through the port's CLI and the JAX
package's; a stored byte flipped after the record names
``generation.bytes`` (exit 1); a record whose checksum the manifest no
longer names, or whose generation is not in it, is named too; a
perturbed score diverges by default and matches within ``--tolerance``;
a record without a payload is not replayable (exit 2).  A device-wave
answer (the device floor patched down) is replayed with the default
tolerance and with 1e-5: the exact outcome is recorded, the tolerant one
must match.
"""

from __future__ import annotations

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import (
    resolve_engine_factory as jax_resolve_engine_factory,
)
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.data.datamap import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.lifecycle.generations import GenerationStore as JaxGenerationStore
from predictionio_tpu.models.recommendation import engine as jax_rec  # noqa: F401
from predictionio_tpu.obs import provenance as jax_provenance
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.data.storage.config import StorageConfig
from predictionio_tpu_torch.lifecycle.generations import GenerationStore
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs import provenance as pt_provenance
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 20, 30, 300
TIMEOUT = 10


ITEMS = [{"item": f"i{j}", "score": 1.0 - j / 8} for j in range(5)]
DIFFS = [
    (ITEMS, ITEMS, 0.0),
    (ITEMS, ITEMS[:4], 0.0),
    (ITEMS, [ITEMS[1], ITEMS[0]] + ITEMS[2:], 0.0),
    (ITEMS, [dict(ITEMS[0], score=ITEMS[0]["score"] + 1e-9)] + ITEMS[1:], 0.0),
    (ITEMS, [dict(ITEMS[0], score=ITEMS[0]["score"] + 1e-9)] + ITEMS[1:], 1e-6),
    (ITEMS, [dict(ITEMS[0], score=ITEMS[0]["score"] + 1e-3)] + ITEMS[1:], 1e-6),
    ([{"item": "a", "score": float("nan")}], [{"item": "a", "score": float("nan")}], 0.0),
    ([{"item": "a", "score": -0.0}], [{"item": "a", "score": 0.0}], 0.0),
    ([{"item": "a", "score": None}], [{"item": "a", "score": 1.0}], 1e-3),
]


@pytest.mark.parametrize("case", range(len(DIFFS)))
def test_diff_items_equal(case):
    recorded, replayed, tol = DIFFS[case]
    got = pt_provenance._diff_items(recorded, replayed, tol)
    assert repr(got) == repr(jax_provenance._diff_items(recorded, replayed, tol))
    report = pt_provenance._replay_report({"request_id": "r", "instance_id": "i"}, got, None)
    assert report == jax_provenance._replay_report(
        {"request_id": "r", "instance_id": "i"}, got, None)


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_replay") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(path)}))
    app = jax_cmd.app_new(jax_storage, "rp").app
    rng = np.random.default_rng(0)
    for n in range(N_EVENTS):
        jax_storage.l_events().insert(
            JaxEvent(event="rate", entity_type="user", entity_id=f"u{n % N_USERS}",
                     target_entity_type="item", target_entity_id=f"i{n % N_ITEMS}",
                     properties=JaxDataMap({"rating": float(rng.integers(1, 6))})),
            app.id,
        )
    engine = jax_resolve_engine_factory("recommendation")()
    params = engine.params_from_json({
        "datasource": {"name": "ratings", "params": {"appName": "rp"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}],
    })
    instance = run_train(
        engine, params, ctx=JaxEngineContext(storage=jax_storage, mode="train"),
        engine_factory="recommendation", storage=jax_storage)
    yield {"path": path, "A": instance, "jax_storage": jax_storage}
    jax_storage.close()


@pytest.fixture()
def storage(home, monkeypatch, tmp_path):
    """A copy of the trained home for one test (a test may corrupt it),
    as the process storage of both packages' CLIs."""
    import shutil

    from predictionio_tpu_torch.data.storage import config as pt_config

    dst = tmp_path / "pio_home"
    shutil.copytree(home["path"], dst)
    monkeypatch.setenv("PIO_HOME", str(dst))
    jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(dst)}))
    port = pt_config.reset_storage(StorageConfig.from_env({"PIO_HOME": str(dst)}))
    yield port
    port.close()


def test_generation_info_equal(home, storage):
    import os

    port_store = GenerationStore(storage.models())
    port_store.record(home["A"].id, status="live")
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env(
        {"PIO_HOME": os.environ["PIO_HOME"]}))
    jax_store = JaxGenerationStore(jax_storage.models())
    got = pt_provenance.generation_info(port_store, home["A"].id)
    assert got == jax_provenance.generation_info(jax_store, home["A"].id)
    assert got["checksum"] and got["status"] == "live"
    assert got["engine"] == {"id": "default", "version": "default", "variant": "default"}
    assert got["shard_axes"] is None
    assert pt_provenance.generation_info(None, "x") is None
    assert pt_provenance.generation_info(port_store, "missing") is None


def _serve(storage, **kw):
    dep = pt_server.deploy_engine("recommendation", storage=storage, device="cpu")
    app = pt_server.create_prediction_server_app(
        dep, registry=MetricsRegistry(), **kw)
    return dep, app, pt_aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()


def _query(port, user, num=5):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/queries.json", json.dumps({"user": user, "num": num}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        return resp.status, resp.getheader("X-Pio-Request-Id"), body
    finally:
        conn.close()


@pytest.mark.parametrize("microbatch", [False, True])
def test_solo_answer_replays_matched(storage, microbatch, capsys):
    _, app, server = _serve(storage, use_microbatch=microbatch)
    url = f"http://127.0.0.1:{server.port}"
    try:
        status, rid, body = _query(server.port, "u3")
        assert status == 200
        record = app.provenance.get(rid)
        assert record["generation"]["checksum"] and record["items"]
        assert record["items"] == [{"item": x["item"], "score": x["score"]}
                                   for x in body["itemScores"]]
        rc = pt_cli.main(["replay-request", rid, "--url", url, "--device", "cpu"])
        out = capsys.readouterr()
        assert rc == 0, out.err
        assert out.out.startswith(f"replay MATCHED bit-exactly: request {rid}")
        # the JAX package's replay of the port's record on the same store
        assert jax_cli.main(["replay-request", rid, "--url", url]) == 0
        capsys.readouterr()
        assert pt_cli.main(["replay-request", rid, "--url", url, "--json",
                            "--device", "cpu"]) == 0
        report = json.loads(capsys.readouterr().out.split("\nreplay MATCHED")[0])
        assert report["matched"] and report["divergences"] == []
    finally:
        server.shutdown()


def test_replay_from_a_record_file_and_its_divergences(storage, tmp_path, capsys):
    dep, app, server = _serve(storage)
    try:
        rids = [_query(server.port, f"u{i}")[1] for i in range(3)]
        records = [app.provenance.get(r) for r in rids]
    finally:
        server.shutdown()
    path = tmp_path / "records.json"
    path.write_text(json.dumps({"records": records}))

    def run(*argv):
        rc = pt_cli.main(["replay-request", *argv, "--device", "cpu"])
        return rc, capsys.readouterr()

    rc, out = run(rids[1], "--record", str(path))
    assert rc == 0 and rids[1] in out.out
    rc, out = run("nope", "--record", str(path))
    assert rc == 2 and "no record" in out.err
    # a score moved by a hair: diverges by default, matches within 1e-5
    moved = dict(records[0], items=[dict(records[0]["items"][0],
                                         score=records[0]["items"][0]["score"] + 1e-7)]
                 + records[0]["items"][1:])
    single = tmp_path / "moved.json"
    single.write_text(json.dumps({"record": moved}))
    rc, out = run(rids[0], "--record", str(single))
    assert rc == 1 and "items[0].score" in out.err
    rc, out = run(rids[0], "--record", str(single), "--tolerance", "1e-5")
    assert rc == 0
    # the manifest names other bytes now
    other = dict(records[0], generation=dict(records[0]["generation"], checksum="0" * 64))
    single.write_text(json.dumps(other))
    rc, out = run(rids[0], "--record", str(single))
    assert rc == 1 and "generation.checksum" in out.err
    # a generation the manifest never held
    gone = dict(records[0], generation=dict(records[0]["generation"],
                                            engine={"id": "zz", "version": "1",
                                                    "variant": "v"}))
    report = pt_provenance.replay_request(gone, storage=storage, device="cpu")
    assert [d["field"] for d in report["divergences"]] == ["generation"]
    # nothing to re-answer
    for broken in ({"instance_id": records[0]["instance_id"]}, {"payload": {}}):
        single.write_text(json.dumps(broken))
        rc, out = run("x", "--record", str(single))
        assert rc == 2 and "not replayable" in out.err
    rc, out = run("x")
    assert rc == 2 and "--url" in out.err


def test_flipped_byte_names_generation_bytes(storage, capsys):
    from predictionio_tpu_torch.data.storage.base import _manifest_part_names

    _, app, server = _serve(storage)
    url = f"http://127.0.0.1:{server.port}"
    try:
        _, rid, _ = _query(server.port, "u5")
        record = app.provenance.get(rid)
        models = storage.models()
        iid = record["instance_id"]
        raw = models.get(f"{iid}:manifest")
        parts = sorted(_manifest_part_names(raw)) if raw is not None else []
        key = f"{iid}:part:{parts[0]}" if parts else f"{iid}:manifest"
        blob = bytearray(models.get(key))
        blob[len(blob) // 2] ^= 0x01
        models.insert(key, bytes(blob))
        rc = pt_cli.main(["replay-request", rid, "--url", url, "--device", "cpu"])
        err = capsys.readouterr().err
    finally:
        server.shutdown()
    assert rc == 1
    assert "generation.bytes" in err and "DIVERGED" in err


def _one_wave_of(app, n):
    """Hold the deploy's micro-batcher until ``n`` queries are queued, so
    they form ONE wave whatever the threads' timing.  Returns a callable
    that waits for the i-th submit to be queued."""
    batcher = app.microbatcher
    run = batcher._drain

    def gated():
        with batcher._cond:
            batcher._cond.wait_for(
                lambda: len(batcher._pending) >= n or batcher._closed,
                timeout=4 * TIMEOUT)
        run()

    batcher._drain = gated  # the worker thread starts at the first submit

    def queued(i):
        with batcher._cond:
            assert batcher._cond.wait_for(
                lambda: len(batcher._pending) >= i or batcher._wave_seq,
                timeout=TIMEOUT), i
    return queued


#: the pair of this data whose scores tie within 1e-5 at adjacent ranks:
#: item n % 30 is rated by user n % 20, so i1 and i21 are rated by the same
#: users and their factors nearly coincide; which users' answers hold the
#: tie changes from train to train (the fixture's train is not bit for bit
#: the same twice), and the host replica's replay may order the pair the
#: other way than the device wave did
NEAR_TIE = frozenset({"i1", "i21"})


def _near_tie_swap(record: dict, divergences: list) -> bool:
    """True when ``divergences`` are exactly the NEAR_TIE pair swapped at
    adjacent ranks ``k`` and ``k + 1`` of ``record``, their recorded scores
    within 1e-5 of each other (score divergences aside)."""
    items = {d["field"]: (d["recorded"], d["replayed"]) for d in divergences
             if d["field"].endswith(".item")}
    if len(items) != 2:
        return False
    (fa, (ra, pa)), (fb, (rb, pb)) = sorted(
        items.items(), key=lambda kv: int(kv[0].split("[")[1].split("]")[0]))
    k = int(fa.split("[")[1].split("]")[0])
    scores = record["items"]
    return (fb == f"items[{k + 1}].item" and {ra, rb} == NEAR_TIE
            and (ra, rb) == (pb, pa)
            and abs(scores[k]["score"] - scores[k + 1]["score"]) <= 1e-5)


def test_device_wave_answer_replays_within_tolerance(storage, monkeypatch):
    """A micro-batched answer of a device wave (the device floor patched
    down to 1, so the wave takes the device route: the plain fused top-k
    on the CPU) replayed through the host replica.  The 24 queries form
    ONE wave in a fixed order (the batcher is held until all are queued,
    each sent after the one before it is queued), so the wave's size and
    order no longer follow thread timing.  Within 1e-5 every answer
    matches but, in some runs, one: the replay re-answers through the host
    replica, which sums in another order than the wave, and ``i1`` and
    ``i21`` tie within 1e-5 at adjacent ranks of a few users' answers.
    Where that pair is swapped it is the whole divergence (a difference
    the JAX package's replay shares); anything else fails."""
    monkeypatch.setattr(pt_rec.ALSAlgorithm, "DEVICE_BATCH_MIN", 1)
    _, app, server = _serve(storage, use_microbatch=True, max_batch=64)
    try:
        queued = _one_wave_of(app, 24)
        got = [None] * 24
        threads = []
        for i in range(24):
            threads.append(threading.Thread(
                target=lambda i=i: got.__setitem__(
                    i, _query(server.port, f"u{i % N_USERS}")),
                daemon=True))
            threads[-1].start()
            queued(i + 1)
        for t in threads:
            t.join(timeout=4 * TIMEOUT)
        records = [app.provenance.get(rid) for _, rid, _ in got]
        waves = app.microbatcher.wave_histogram()
    finally:
        server.shutdown()
    assert waves == {24: 1}, waves
    assert all(r["engine_path"] == "als.device_topk" for r in records), records[0]
    for rec in records:
        exact = pt_provenance.replay_request(rec, storage=storage, device="cpu")
        loose = pt_provenance.replay_request(rec, storage=storage, device="cpu",
                                             score_tolerance=1e-5)
        swapped = not loose["matched"] and _near_tie_swap(rec, loose["divergences"])
        assert loose["matched"] or swapped, loose["divergences"]
        if swapped:
            assert {d["field"].split("]")[-1] for d in loose["divergences"]} == {".item"}
        fields = {d["field"].split("]")[-1] for d in exact["divergences"]}
        assert fields <= ({".score", ".item"} if swapped else {".score"}), fields


@pytest.mark.parametrize("divergences,swap", [
    ([{"field": "items[1].item", "recorded": "i1", "replayed": "i21"},
      {"field": "items[2].item", "recorded": "i21", "replayed": "i1"}], True),
    ([{"field": "items[2].item", "recorded": "i21", "replayed": "i1"},
      {"field": "items[1].item", "recorded": "i1", "replayed": "i21"}], True),
    ([{"field": "items[1].item", "recorded": "i1", "replayed": "i21"},
      {"field": "items[3].item", "recorded": "i21", "replayed": "i1"}], False),
    ([{"field": "items[1].item", "recorded": "i1", "replayed": "i7"},
      {"field": "items[2].item", "recorded": "i7", "replayed": "i1"}], False),
    ([{"field": "items[1].item", "recorded": "i1", "replayed": "i21"}], False),
    ([{"field": "items[0].item", "recorded": "i1", "replayed": "i21"},
      {"field": "items[1].item", "recorded": "i21", "replayed": "i1"}], False),
])
def test_only_the_pinned_near_tie_counts_as_the_swap(divergences, swap):
    """The swap the device-wave replay may show is that pair at adjacent
    ranks with scores within 1e-5, and nothing else."""
    record = {"items": [{"item": "i3", "score": 0.9}, {"item": "i1", "score": 0.5},
                        {"item": "i21", "score": 0.5 - 4e-6},
                        {"item": "i4", "score": 0.1}]}
    assert _near_tie_swap(record, divergences) is swap


def test_replay_needs_a_card_unless_asked_for_the_cpu(storage, monkeypatch):
    from predictionio_tpu_torch.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        pt_provenance.replay_request({"instance_id": "x", "payload": {}}, storage=storage)
