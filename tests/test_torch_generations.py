"""The port's generation store, fault injector and gated swaps against the
JAX package's, on the CPU.

- ``tests/test_lifecycle.py::TestGenerationStore``'s cases on the port.
- One manifest advanced alternately by the two packages over one store
  equals the manifest either package writes alone, byte for byte (clock
  frozen); both compute the same checksums for the same stored bytes.
- ``resilience/faults.py``: the same plan and seed fire the same faults in
  both packages; a malformed ``PIO_FAULT_PLAN`` raises at import; the
  ``batch_fn`` and ``eventstore.write`` seams.
- The port's counterparts of ``tests/test_lifecycle_chaos.py``'s generation
  cases: whole generations under a hammer of flips, the corrupt-live
  fallback at bind, the gated ``/reload`` (flip, 409 on a corrupt or
  insane candidate, access key), ``pio lifecycle`` from a deploy and from
  the store, and a ``--device cpu`` deploy SIGKILLed mid-swap restarting
  on the committed generation.
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
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage.localfs_models import LocalFSModels as JaxLocalFSModels
from predictionio_tpu.lifecycle import generations as jax_generations
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EngineContext,
    FirstServing,
    IdentityPreparator,
    SanityCheckError,
)
from predictionio_tpu_torch.core.engine import Engine, EngineParams, engine_registry
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.localfs_models import LocalFSModels
from predictionio_tpu_torch.lifecycle import (
    CorruptModelError,
    GenerationStore,
    LifecycleError,
    compute_checksum,
    compute_checksums,
)
from predictionio_tpu_torch.lifecycle import generations as pt_generations
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.server.aio import AsyncAppServer
from predictionio_tpu_torch.server.event_server import create_event_server_app
from predictionio_tpu_torch.server.microbatch import MicroBatcher
from predictionio_tpu_torch.server.prediction_server import (
    create_prediction_server_app,
    deploy_engine,
)
from predictionio_tpu_torch.tools import cli as pt_cli
from predictionio_tpu_torch.tools import commands as pt_cmd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clear_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture()
def models(tmp_path):
    return LocalFSModels(tmp_path / "models")


@pytest.fixture()
def storage(tmp_path):
    rt = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "h")}))
    yield rt
    rt.close()


# ---------------------------------------------------------------------------
# tests/test_lifecycle.py::TestGenerationStore on the port
# ---------------------------------------------------------------------------


def test_record_verify_roundtrip_single_blob(models):
    models.insert("i1", b"model-bytes")
    store = GenerationStore(models, "e")
    gen = store.record("i1", status="live")
    assert gen.checksum == compute_checksum(models, "i1")
    store.verify(gen)
    assert store.live().instance_id == "i1"


def test_verify_refuses_tampered_blob(models):
    models.insert("i1", b"model-bytes")
    store = GenerationStore(models, "e")
    store.record("i1", status="live")
    models.insert("i1", b"model-byteX")
    with pytest.raises(CorruptModelError):
        store.verify("i1")


def test_verify_covers_sharded_parts(models):
    models.insert_parts("i2", b"manifest", {"p0": b"aaa", "p1": b"bbb"})
    store = GenerationStore(models, "e")
    gen = store.record("i2")
    store.verify(gen)
    models.insert("i2:part:p1", b"bbc")
    with pytest.raises(CorruptModelError, match="part:p1"):
        store.verify("i2")
    models.delete("i2:part:p0")
    with pytest.raises(CorruptModelError):
        store.verify("i2")


def test_state_machine_transitions(models):
    store = GenerationStore(models, "e")
    models.insert("g1", b"one")
    models.insert("g2", b"two")
    store.record("g1", status="live")
    store.record("g2", status="staged")
    store.start_canary("g2")
    assert store.canary().instance_id == "g2"
    store.promote("g2")
    assert store.live().instance_id == "g2"
    assert store.get("g1").status == "retired"
    with pytest.raises(LifecycleError):
        store.rollback("g2")


def test_rollback_leaves_live_untouched(models):
    store = GenerationStore(models, "e")
    models.insert("g1", b"one")
    models.insert("g2", b"two")
    store.record("g1", status="live")
    store.record("g2", status="staged")
    store.start_canary("g2")
    store.rollback("g2", note="guardrail breach")
    assert store.live().instance_id == "g1"
    g2 = store.get("g2")
    assert g2.status == "rolled_back" and g2.rolled_back_at is not None
    assert "guardrail" in g2.note
    assert store.rollback_stats()["rolled_back"] == 1


def test_bind_candidates_walk_live_then_retired_newest_first(models):
    store = GenerationStore(models, "e")
    for name in ("g1", "g2", "g3"):
        models.insert(name, name.encode())
        store.record(name, status="live")
    assert [g.instance_id for g in store.bind_candidates()] == ["g3", "g2", "g1"]


def test_manifest_write_is_whole_file_atomic(models):
    store = GenerationStore(models, "e")
    models.insert("g1", b"one")
    store.record("g1", status="live")
    manifest = json.loads(models.get(store.manifest_key).decode())
    assert manifest["generations"][0]["instance_id"] == "g1"
    assert manifest["schema"] == 1
    assert store.manifest_key == "__lifecycle__:e/default/default"


def test_fault_injected_corruption_via_models_read_seam(models):
    models.insert("i1", b"x" * 4096)
    store = GenerationStore(models, "e")
    gen = store.record("i1")
    faults.install([{"seam": "models.read", "kind": "corrupt", "match": "i1"}])
    with pytest.raises(CorruptModelError):
        store.verify(gen)
    faults.clear()
    store.verify(gen)


def test_history_trims_but_keeps_active(models):
    store = GenerationStore(models, "e", max_history=3)
    for i in range(8):
        models.insert(f"g{i}", str(i).encode())
        store.record(f"g{i}", status="live")
    assert len(store.generations()) <= 3
    assert store.live().instance_id == "g7"


# ---------------------------------------------------------------------------
# one manifest, two packages
# ---------------------------------------------------------------------------


def _freeze_clocks(monkeypatch):
    ticks = iter(range(1000, 2000))
    clock = {"t": 0.0}

    def now():
        clock["t"] = float(next(ticks))
        return clock["t"]

    monkeypatch.setattr(pt_generations, "_now", now)
    monkeypatch.setattr(jax_generations, "_now", now)


def _seed_blobs(models_store):
    models_store.insert("g1", b"one" * 100)
    models_store.insert_parts("g2", b"manifest-two", {"leaf00000": b"p" * 300,
                                                      "leaf00001": b"q" * 7})
    # the serving-plan sidecar the JAX package's run_train leaves beside a
    # sharded model: both packages' record() embed it in the manifest
    models_store.insert("g2:shardplan", json.dumps(
        {"axes": {"model": -1}, "specs": {"item_factors": ["model", None]}},
        sort_keys=True).encode())
    models_store.insert("g3", b"three")


def _advance(stores):
    """One rollout, each step taken by ``stores[i % len(stores)]``."""
    steps = [
        lambda s: s.record("g1", status="live", note="first"),
        lambda s: s.record("g2", status="staged"),
        lambda s: s.start_canary("g2"),
        lambda s: s.promote("g2", note="canary"),
        lambda s: s.verify("g2"),
        lambda s: s.record("g3", status="staged"),
        lambda s: s.start_canary("g3"),
        lambda s: s.rollback("g3", note="guardrail"),
        lambda s: s.mark_corrupt("g2", "bit rot"),
        lambda s: s.promote("g1", note="flip back"),
    ]
    for i, step in enumerate(steps):
        step(stores[i % len(stores)])


def test_manifest_advanced_alternately_equals_either_package_alone(
    tmp_path, monkeypatch
):
    out = {}
    for name, make in (
        ("port", lambda m: [GenerationStore(m, "e", "v1", "var")]),
        ("jax", lambda m: [jax_generations.GenerationStore(
            JaxLocalFSModels(m.root), "e", "v1", "var")]),
        ("both", lambda m: [
            GenerationStore(m, "e", "v1", "var"),
            jax_generations.GenerationStore(
                JaxLocalFSModels(m.root), "e", "v1", "var"),
        ]),
    ):
        _freeze_clocks(monkeypatch)
        m = LocalFSModels(tmp_path / name)
        _seed_blobs(m)
        stores = make(m)
        _advance(stores)
        out[name] = m.get(stores[0].manifest_key)
        snap = stores[0].snapshot()
        assert snap["live"] == "g1" and snap["rolled_back"] == 2
    assert out["port"] == out["jax"] == out["both"]
    body = json.loads(out["both"])
    assert [g["status"] for g in body["generations"]] == [
        "live", "rolled_back", "rolled_back"]
    assert body["generations"][1]["part_checksums"] is not None
    assert body["generations"][1]["shard_plan"]["axes"] == {"model": -1}


def test_checksums_of_the_same_bytes_are_equal(tmp_path):
    m = LocalFSModels(tmp_path / "m")
    _seed_blobs(m)
    jm = JaxLocalFSModels(m.root)
    for iid in ("g1", "g2", "g3"):
        assert compute_checksums(m, iid) == jax_generations.compute_checksums(jm, iid)
    with pytest.raises(CorruptModelError):
        compute_checksums(m, "absent")


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

PLAN = [
    {"seam": "remote.send", "kind": "connection_reset", "match": "GET",
     "after": 1, "count": 3},
    {"seam": "remote.send", "kind": "latency", "latency_s": 0.25,
     "probability": 0.5},
    {"seam": "batch_fn", "kind": "error", "probability": 0.3},
    {"seam": "models.read", "kind": "corrupt", "match": "i", "after": 2,
     "count": 4, "probability": 0.7},
    {"seam": "shard.settle", "kind": "latency", "latency_s": 0.1,
     "probability": 0.6},
]


def _fire(mod, seed):
    slept = []
    inj = mod.install(PLAN, seed=seed, sleep=slept.append)
    events = []
    for i in range(60):
        for seam, label in (("remote.send", "GET /v1" if i % 3 else "POST"),
                            ("batch_fn", "wave")):
            try:
                inj.check(seam, label)
                events.append("ok")
            except Exception as e:
                events.append(type(e).__name__)
        events.append(inj.corrupt("models.read", f"i{i}", b"x" * 2050).hex()[:8])
        events.append(inj.latency("shard.settle", "d0"))
    return events, slept, inj.snapshot()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_same_plan_and_seed_fire_the_same_faults(seed):
    got = _fire(faults, seed)
    want = _fire(jax_faults, seed)
    assert got == want
    assert "ConnectionResetError" in got[0] and "FaultInjected" in got[0]


def test_env_plan_loads_and_a_malformed_plan_raises_at_import(tmp_path):
    def run(plan):
        env = {**os.environ, "PIO_FAULT_PLAN": plan, "PIO_FAULT_SEED": "3",
               "PYTHONPATH": str(REPO)}
        return subprocess.run(
            [sys.executable, "-c",
             "from predictionio_tpu_torch.resilience import faults; "
             "print(faults.ACTIVE.snapshot())"],
            capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))

    ok = run(json.dumps([{"seam": "batch_fn", "kind": "error"}]))
    assert ok.returncode == 0 and "'seam': 'batch_fn'" in ok.stdout
    path = tmp_path / "plan.json"
    path.write_text(json.dumps([{"seam": "lifecycle.swap", "kind": "latency"}]))
    assert run("@" + str(path)).returncode == 0
    for bad in ('{"seam": "x"}', "[{\"seam\": \"x\", \"kind\": \"melt\"}]", "[{"):
        out = run(bad)
        assert out.returncode != 0, bad
        assert "Error" in out.stderr


def test_batch_fn_seam_fails_the_wave_and_solo_retries():
    """The first wave (one query) holds the worker while three more queue;
    the plan fails the second call, that wave of three, and each query's
    solo retry answers."""
    import asyncio

    entered, gate = threading.Event(), threading.Event()

    def batch_fn(items):
        if not entered.is_set():
            entered.set()
            gate.wait(10)
        return [x * 2 for x in items]

    faults.install([{"seam": "batch_fn", "kind": "error", "after": 1,
                     "count": 1}])
    batcher = MicroBatcher(batch_fn, max_batch=8, registry=MetricsRegistry())

    async def go():
        first = asyncio.ensure_future(batcher.submit(0))
        await asyncio.get_running_loop().run_in_executor(None, entered.wait, 10)
        rest = [asyncio.ensure_future(batcher.submit(i)) for i in (1, 2, 3)]
        await asyncio.sleep(0.05)
        gate.set()
        return await asyncio.gather(first, *rest)

    try:
        assert asyncio.run(go()) == [0, 2, 4, 6]
    finally:
        batcher.close()
    (rule,) = faults.ACTIVE.snapshot()
    assert rule["fired"] == 1 and rule["seen"] == 5


def test_eventstore_write_seam_answers_503_as_the_jax_package(storage):
    from predictionio_tpu_torch.server.httpd import Request

    d = pt_cmd.app_new(storage, "seam")
    key = d.keys[0].key
    app = create_event_server_app(storage=storage, registry=MetricsRegistry())
    body = json.dumps({"event": "view", "entityType": "user", "entityId": "u1"})
    faults.install([{"seam": "eventstore.write", "kind": "connection_reset",
                     "count": 1}])

    def post(path, payload):
        resp = app.handle(Request(method="POST", path=path,
                                  query={"accessKey": key}, headers={},
                                  body=payload.encode()))
        return resp.status, json.loads(resp.encoded()[0])

    status, _ = post("/events.json", body)
    assert status == 503
    status, got = post("/events.json", body)
    assert status == 201 and got["eventId"]
    faults.install([{"seam": "eventstore.write", "kind": "timeout", "after": 1,
                     "count": 1}])
    status, got = post("/batch/events.json", f"[{body}, {body}, {body}]")
    assert status == 200 and [r["status"] for r in got] == [201, 503, 201]
    assert faults.ACTIVE.snapshot()[0]["seen"] == 3


# ---------------------------------------------------------------------------
# the chaos suite's generation cases, on the port
# ---------------------------------------------------------------------------


class _MarkerTD:
    pass


class MarkerDataSource(DataSource):
    def __init__(self, params=None):
        pass

    def read_training(self, ctx):
        return _MarkerTD()


@dataclass(frozen=True)
class MarkerParams:
    marker: str = "A"


class MarkerAlgo(Algorithm):
    """A model that IS its generation marker: every answer names the
    generation that produced it, so a torn read is directly visible."""

    params_class = MarkerParams

    def __init__(self, params=None):
        self.params = params or MarkerParams()

    def train(self, ctx, pd):
        return {"marker": self.params.marker}

    def predict(self, model, q):
        return {"gen": model["marker"], "user": q.get("user")}


FACTORY = "lifecycle-marker-test"
if FACTORY not in engine_registry:
    engine_registry.register(
        FACTORY,
        lambda: Engine(MarkerDataSource, IdentityPreparator,
                       {"marker": MarkerAlgo}, FirstServing),
    )


def _marker_instances(storage, markers=("A", "B")):
    """One trained instance per marker, the last the latest COMPLETED (the
    store orders by start time, to the millisecond)."""
    engine = engine_registry.get(FACTORY)()
    out = []
    for m in markers:
        time.sleep(0.005)
        out.append(run_train(
            engine,
            EngineParams(algorithms=(("marker", MarkerParams(marker=m)),)),
            ctx=EngineContext(storage=storage, device="cpu"),
            storage=storage, engine_factory=FACTORY,
        ))
    return out


def _post(url, payload, headers=None, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _flip_byte(models_store, instance_id, mask=0xFF):
    key = f"{instance_id}:manifest"
    blob = models_store.get(key)
    models_store.insert(key, blob[:-1] + bytes([blob[-1] ^ mask]))


def test_hammer_observes_only_whole_generations(storage):
    inst_a, inst_b = _marker_instances(storage)
    deployed = deploy_engine(FACTORY, storage=storage,
                             engine_instance_id=inst_a.id, device="cpu")
    marker_of = {inst_a.id: "A", inst_b.id: "B"}
    app = create_prediction_server_app(deployed, use_microbatch=True,
                                       registry=MetricsRegistry())
    server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{server.port}"
    results, stop = [], threading.Event()

    def hammer(worker):
        n = 0
        while not stop.is_set():
            results.append(_post(base + "/queries.json",
                                 {"user": f"w{worker}-u{n % 40}"}))
            n += 1

    try:
        with ThreadPoolExecutor(3) as ex:
            for w in range(3):
                ex.submit(hammer, w)
            # flip A <-> B (12 flips at least) until 150 answers came back
            flips, deadline = 0, time.monotonic() + 60
            while (flips < 12 or len(results) < 150) and time.monotonic() < deadline:
                deployed.verify_and_swap([inst_b, inst_a][flips % 2])
                flips += 1
                time.sleep(0.01)
            if flips % 2:
                deployed.verify_and_swap(inst_a)
            stop.set()
    finally:
        stop.set()
        server.shutdown()
    assert len(results) >= 150 and flips >= 12, (len(results), flips)
    bad = [(code, body, h.get("X-Pio-Engine-Instance"))
           for code, body, h in results
           if code != 200 or body.get("gen") != marker_of.get(
               h.get("X-Pio-Engine-Instance"))]
    assert bad == [], bad[:5]
    store = deployed.generation_store
    assert store.live().instance_id == inst_a.id
    assert store.get(inst_b.id).status == "retired"


def test_startup_refuses_corrupt_live_and_binds_last_good(storage):
    inst_a, inst_b = _marker_instances(storage)
    store = GenerationStore(storage.models(), "default", "default", "default")
    store.record(inst_a.id, status="live")
    store.record(inst_b.id, status="live")
    _flip_byte(storage.models(), inst_b.id)
    counter = REGISTRY.counter("pio_lifecycle_corrupt_blobs_total",
                               "Model blobs refused by checksum verification")
    before = counter.value
    deployed = deploy_engine(FACTORY, storage=storage, device="cpu")
    assert deployed.instance.id == inst_a.id
    assert store.get(inst_b.id).status == "rolled_back"
    assert "corrupt" in store.get(inst_b.id).note
    assert counter.value == before + 1
    assert store.live().instance_id == inst_a.id


def test_a_refused_latest_completed_is_not_recorded_live(storage):
    """Every manifest generation fails its checksum and the latest
    COMPLETED instance is one of them: the deploy refuses rather than
    bless the corruption."""
    _, inst_b = _marker_instances(storage)
    store = GenerationStore(storage.models(), "default", "default", "default")
    store.record(inst_b.id, status="live")
    _flip_byte(storage.models(), inst_b.id)
    with pytest.raises(RuntimeError, match="failed checksum"):
        deploy_engine(FACTORY, storage=storage, device="cpu")
    assert store.get(inst_b.id).status == "rolled_back"


def test_manifest_bind_needs_a_card_unless_asked(storage, monkeypatch):
    (inst_a,) = _marker_instances(storage, ("A",))
    GenerationStore(storage.models()).record(inst_a.id, status="live")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailable):
        deploy_engine(FACTORY, storage=storage)
    assert deploy_engine(FACTORY, storage=storage, device="cpu").instance.id == inst_a.id


def _server(storage, inst_id, access_key=None):
    deployed = deploy_engine(FACTORY, storage=storage, engine_instance_id=inst_id,
                             device="cpu")
    app = create_prediction_server_app(deployed, registry=MetricsRegistry(),
                                       access_key=access_key, use_microbatch=True)
    server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
    return server, deployed, f"http://127.0.0.1:{server.port}"


def test_reload_verifies_then_flips(storage):
    inst_a, inst_b = _marker_instances(storage)
    server, deployed, base = _server(storage, inst_a.id)
    try:
        code, body, _ = _post(base + "/reload", {})
        assert code == 200 and body["engineInstanceId"] == inst_b.id
        store = deployed.generation_store
        assert store.live().instance_id == inst_b.id
        assert store.get(inst_a.id).status == "retired"
        assert store.get(inst_b.id).note == "reload"
    finally:
        server.shutdown()


def test_reload_refuses_corrupt_candidate_with_409(storage):
    inst_a, inst_b = _marker_instances(storage)
    _flip_byte(storage.models(), inst_b.id)
    server, deployed, base = _server(storage, inst_a.id)
    try:
        store = deployed.generation_store
        store.record(inst_b.id, status="staged")
        _flip_byte(storage.models(), inst_b.id, 0x55)
        code, body, _ = _post(base + "/reload", {})
        assert code == 409 and "refused" in body["message"]
        assert "checksum" in body["message"]
        assert body["engineInstanceId"] == inst_a.id
        assert deployed.instance.id == inst_a.id
        assert store.live().instance_id == inst_a.id
        qcode, qbody, qh = _post(base + "/queries.json", {"user": "u1"})
        assert qcode == 200 and qbody["gen"] == "A"
        assert qh["X-Pio-Engine-Instance"] == inst_a.id
    finally:
        server.shutdown()


def test_reload_refuses_failed_sanity_check(storage, monkeypatch):
    inst_a, inst_b = _marker_instances(storage)
    server, deployed, base = _server(storage, inst_a.id)
    try:
        real = deployed.load_binding

        def load_with_bad_sanity(instance):
            binding = real(instance)
            if instance.id == inst_b.id:
                class Bad(dict):
                    def sanity_check(self):
                        raise SanityCheckError("non-finite factors")

                return binding._replace(models=[Bad(m) for m in binding.models])
            return binding

        monkeypatch.setattr(deployed, "load_binding", load_with_bad_sanity)
        code, body, _ = _post(base + "/reload", {})
        assert code == 409 and "non-finite" in body["message"]
        assert deployed.instance.id == inst_a.id
        assert deployed.generation_store.live().instance_id == inst_a.id
    finally:
        server.shutdown()


def test_reload_and_lifecycle_json_require_access_key(storage):
    (inst_a,) = _marker_instances(storage, ("A",))
    server, deployed, base = _server(storage, inst_a.id, access_key="sekret")
    try:
        assert _post(base + "/reload", {})[0] == 401
        assert _get(base + "/lifecycle.json")[0] == 401
        code, body = _get(base + "/lifecycle.json?accessKey=sekret")
        assert code == 200
        assert body["manifest"]["live"] == inst_a.id
        assert body["controller"] == {"enabled": False}
        assert body["canary_in_progress"] is False
        code, body, _ = _post(base + "/reload?accessKey=sekret", {})
        assert code in (200, 409)
    finally:
        server.shutdown()


def test_pio_lifecycle_url_and_local_manifest(storage, monkeypatch, capsys):
    inst_a, inst_b = _marker_instances(storage)
    server, deployed, base = _server(storage, inst_a.id)
    try:
        deployed.verify_and_swap(inst_b)
        assert pt_cli.main(["lifecycle", "--url", base]) == 0
        out = capsys.readouterr().out
        assert f"live generation: {inst_b.id}" in out and "canary: none" in out
        assert f"* {inst_b.id} live" in out and f"  {inst_a.id} retired" in out
        assert pt_cli.main(["lifecycle", "--url", base, "--json"]) == 0
        body = json.loads(capsys.readouterr().out)
        assert body["manifest"]["live"] == inst_b.id
        assert body["engineInstanceId"] == inst_b.id
    finally:
        server.shutdown()
    monkeypatch.setattr(pt_cli, "get_storage", lambda: storage)
    assert pt_cli.main(["lifecycle"]) == 0
    out = capsys.readouterr().out
    assert inst_b.id in out and "live" in out
    assert pt_cli.main(["lifecycle", "--url", base]) == 1
    assert "scrape failed" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# SIGKILL a --device cpu deploy mid-swap
# ---------------------------------------------------------------------------


def _als_params(app="lc", iters=3, rank=4):
    from predictionio_tpu_torch.models.recommendation import engine as rec

    return EngineParams(
        datasource=("ratings", rec.DataSourceParams(app_name=app)),
        preparator=("ratings", None),
        algorithms=(("als", rec.ALSAlgorithmParams(rank=rank, num_iterations=iters)),),
        serving=("first", None),
    )


def _seed_events(storage, app_name="lc", n_users=16, n_items=12, seed=11):
    app_id = storage.apps().insert(App(id=0, name=app_name))
    le = storage.l_events()
    le.init(app_id)
    rng = np.random.default_rng(seed)
    le.insert_batch([
        Event(event="rate", entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"m{i}",
              properties=DataMap({"rating": float(rng.uniform(1, 5))}))
        for u in range(n_users) for i in range(n_items) if rng.random() < 0.75
    ], app_id)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_deploy(home, port, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PIO_FAULT_PLAN"}
    env.update(PIO_HOME=str(home), PYTHONPATH=str(REPO), **(extra_env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "deploy",
         "--engine", "recommendation", "--ip", "127.0.0.1", "--port", str(port),
         "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
        cwd=str(REPO))
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            code, body = _get(f"http://127.0.0.1:{port}/status.json", timeout=2)
            if code == 200:
                return proc, body
        except Exception:
            pass
        if proc.poll() is not None:
            raise RuntimeError("deploy subprocess died at boot")
        time.sleep(0.25)
    proc.kill()
    proc.wait(timeout=10)
    raise TimeoutError("deploy subprocess never became ready")


def test_sigkill_mid_swap_restarts_on_last_good(tmp_path):
    """A /reload stalled at the ``lifecycle.swap`` seam (after
    verification, BEFORE the manifest commit) is SIGKILLed; the restarted
    deploy binds the manifest's committed generation and answers the same
    bits."""
    from predictionio_tpu_torch.core.engine import resolve_engine_factory

    home = tmp_path / "pio_home"
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    _seed_events(storage)
    engine = resolve_engine_factory("recommendation")()
    ctx = EngineContext(storage=storage, device="cpu")
    inst1 = run_train(engine, _als_params(), ctx=ctx, storage=storage,
                      engine_factory="recommendation")
    port = _free_port()
    plan = json.dumps([{"seam": "lifecycle.swap", "kind": "latency",
                        "latency_s": 45, "match": "reload"}])
    proc, status = _spawn_deploy(home, port, {"PIO_FAULT_PLAN": plan})
    base = f"http://127.0.0.1:{port}"
    try:
        assert status["engineInstanceId"] == inst1.id
        code, baseline, _ = _post(base + "/queries.json", {"user": "u1", "num": 5})
        assert code == 200
        inst2 = run_train(engine, _als_params(iters=2), ctx=ctx, storage=storage,
                          engine_factory="recommendation")
        assert inst2.id != inst1.id

        def fire_reload():
            try:
                _post(base + "/reload", {}, timeout=60)
            except Exception:
                pass  # the server dies under the request

        t = threading.Thread(target=fire_reload, daemon=True)
        t.start()
        store = GenerationStore(storage.models(), "default", "default", "default")
        # the reload records the candidate (staged) before it verifies,
        # then stalls at the seam; wait for that, then kill
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and store.get(inst2.id) is None:
            time.sleep(0.1)
        assert store.get(inst2.id).status == "staged"
        time.sleep(1.0)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        t.join(timeout=10)
        assert store.live().instance_id == inst1.id
        proc2, status2 = _spawn_deploy(home, port)
        try:
            assert status2["engineInstanceId"] == inst1.id
            code, after, headers = _post(base + "/queries.json",
                                         {"user": "u1", "num": 5})
            assert code == 200
            assert headers["X-Pio-Engine-Instance"] == inst1.id
            assert after == baseline
        finally:
            proc2.kill()
            proc2.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        storage.close()
