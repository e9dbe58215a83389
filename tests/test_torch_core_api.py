"""The core API the JAX package exports and the port now has, held to the
JAX package on the same inputs, on the CPU.

``AverageServing``, ``SimpleEngine``, ``run_fake`` (the JAX package's
``TestFakeWorkflow``), ``EngineInstances.get_all`` / ``get_completed``,
``Models.delete_parts`` / ``delete_models``, ``EventFrame.from_events`` /
``select`` / ``where_event`` with ``concat_frames``, ``Event.with_id``, and
``deadline.check`` / ``expired``.  Every comparison is exact.
"""

from __future__ import annotations

import dataclasses
import uuid
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.core import base as jax_base
from predictionio_tpu.core import engine as jax_engine
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import base as jax_sbase
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.data.storage.localfs_models import LocalFSModels as JaxLocalFSModels
from predictionio_tpu.resilience import deadline as jax_deadline
from predictionio_tpu_torch.core import base as pt_base
from predictionio_tpu_torch.core.base import Algorithm, DataSource, EngineContext
from predictionio_tpu_torch.core.engine import SimpleEngine
from predictionio_tpu_torch.core.persistence import load_models, save_models
from predictionio_tpu_torch.core.workflow import run_fake, run_train
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base as pt_sbase
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.localfs_models import LocalFSModels
from predictionio_tpu_torch.resilience import deadline as pt_deadline

torch.set_num_threads(2)


@pytest.fixture()
def storage(tmp_path):
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path)}))
    yield storage
    storage.close()


def _cpu(storage) -> EngineContext:
    return EngineContext(storage=storage, mode="eval", device="cpu")


# -- serving and engines ---------------------------------------------------------


@pytest.mark.parametrize("predictions", [
    [1, 2, 3, 4],
    [0.5, 0.25],
    [7],
    [np.float32(1.5), np.float32(2.25), np.float32(-3.0)],
    [np.arange(3.0), np.arange(3.0) * 2],
])
def test_average_serving_matches_jax(predictions):
    got = pt_base.AverageServing().serve(None, predictions)
    want = jax_base.AverageServing().serve(None, predictions)
    np.testing.assert_array_equal(got, want)
    assert type(got) is type(want)


class _Numbers(DataSource):
    def read_training(self, ctx):
        return [1, 2, 3]


class _Sum(Algorithm):
    def train(self, ctx, pd):
        return {"total": sum(pd)}

    def predict(self, model, query):
        return model["total"] + query


def test_simple_engine_trains_and_serves(storage):
    engine = SimpleEngine(_Numbers, _Sum)
    jax_simple = jax_engine.SimpleEngine(object, object)
    for stage in ("preparator_classes", "serving_classes"):
        (name, cls), = getattr(engine, stage).items()
        (jname, jcls), = getattr(jax_simple, stage).items()
        assert (name, cls.__name__) == (jname, jcls.__name__)
    assert set(engine.datasource_classes) == set(engine.algorithm_classes) == {""}
    params = engine.params_from_json({})
    instance = run_train(engine, params, ctx=_cpu(storage), storage=storage)
    assert instance.status == "COMPLETED"
    (stored,) = load_models(storage.models(), instance.id)
    assert stored == {"total": 6}
    _, _, algos, serving = engine.instantiate(params)
    (model,) = engine.prepare_deploy(_cpu(storage), params, [stored])
    assert serving.serve(10, [algos[0].predict(model, 10)]) == 16
    # a serving class of its own replaces FirstServing
    avg = SimpleEngine(_Numbers, _Sum, serving=pt_base.AverageServing)
    _, _, _, serving = avg.instantiate(avg.params_from_json({}))
    assert serving.serve(0, [2, 4]) == 3


class TestFakeWorkflow:
    def test_records_completion(self, storage):
        out = run_fake(lambda ctx: 42, ctx=_cpu(storage), label="MyFake")
        assert out == 42
        (inst,) = storage.evaluation_instances().get_completed()
        assert inst.evaluation_class == "MyFake"
        assert inst.evaluator_results == "MyFake completed"

    def test_records_failure(self, storage):
        with pytest.raises(RuntimeError):
            run_fake(lambda ctx: (_ for _ in ()).throw(RuntimeError("x")),
                     ctx=_cpu(storage))
        rows = storage.evaluation_instances().get_all()
        assert rows and rows[0].status == "FAILED"


def test_run_fake_needs_cuda_unless_given_a_context(storage, monkeypatch):
    from predictionio_tpu_torch.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        run_fake(lambda ctx: 1, storage=storage)


# -- storage -------------------------------------------------------------------------


def _instance(engine_id: str, status: str, minute: int) -> EngineInstance:
    t = datetime(2024, 1, 1, tzinfo=timezone.utc) + timedelta(minutes=minute)
    return EngineInstance(
        id=uuid.uuid4().hex, status=status, start_time=t, end_time=t,
        engine_id=engine_id, engine_version="1", engine_variant="v",
        engine_factory="recommendation")


def test_engine_instances_get_all_and_get_completed(storage, tmp_path):
    rows = [_instance("a", "COMPLETED", 1), _instance("a", "INIT", 2),
            _instance("b", "COMPLETED", 3), _instance("a", "COMPLETED", 4),
            _instance("a", "FAILED", 5)]
    ei = storage.engine_instances()
    for r in rows:
        ei.insert(r)
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(tmp_path)}))
    try:
        jei = jax_storage.engine_instances()
        assert [i.id for i in ei.get_all()] == [i.id for i in jei.get_all()]
        assert [i.id for i in ei.get_all()] == [r.id for r in rows[::-1]]
        for coords in (("a", "1", "v"), ("b", "1", "v"), ("a", "2", "v")):
            got = [i.id for i in ei.get_completed(*coords)]
            assert got == [i.id for i in jei.get_completed(*coords)]
        assert [i.id for i in ei.get_completed("a", "1", "v")] == [rows[3].id, rows[0].id]
        assert ei.get_completed("a", "1", "v")[0] == ei.get_latest_completed("a", "1", "v")
    finally:
        jax_storage.close()


@pytest.mark.parametrize("backend", ["sqlite", "localfs"])
def test_models_delete_parts_and_delete_models(storage, tmp_path, backend):
    store = storage.models() if backend == "sqlite" else LocalFSModels(tmp_path / "m")
    save_models(store, "multi", [{"w": np.arange(3.0)}])
    assert store.get_manifest("multi") is not None
    store.insert("single", b"legacy-blob")
    store.insert_parts("both", b"m", {"a": b"1", "b": b"2"})
    store.insert("both", b"blob")
    assert not store.delete_parts("single")  # no manifest
    assert store.delete_parts("both")
    assert (store.get_part("both", "a"), store.get_manifest("both")) == (None, None)
    assert store.get("both") == b"blob"
    assert store.delete_models("both")
    assert store.delete_models("multi") and store.delete_models("single")
    assert load_models(store, "multi") is None and store.get("single") is None
    assert not store.delete_models("multi")
    if backend == "localfs":
        assert list((tmp_path / "m").glob("pio_model_*")) == []
        # the JAX package finds nothing left either
        assert not JaxLocalFSModels(tmp_path / "m").delete_models("multi")


# -- events ----------------------------------------------------------------------------


def _api_events() -> list[dict]:
    rng = np.random.default_rng(7)
    out = []
    for j in range(30):
        kind = ["rate", "view", "buy", "$set"][j % 4]
        d = {"event": kind, "entityType": "user", "entityId": f"u{rng.integers(5)}",
             "eventTime": f"2024-01-0{1 + j % 9}T00:00:{j:02d}.000Z",
             "properties": {"rating": int(rng.integers(1, 6))} if kind == "rate" else {}}
        if kind != "$set":
            d.update(targetEntityType="item", targetEntityId=f"i{rng.integers(7)}")
        if j % 5 == 0:
            d["tags"] = ["a", "b"]
        if j % 3 == 0:
            d["prId"] = f"pr{j}"
        d["eventId"] = f"e{j}"
        out.append(d)
    return out


def _columns(frame) -> dict:
    out = {}
    for f in dataclasses.fields(frame):
        v = getattr(frame, f.name)
        out[f.name] = None if v is None else [
            x.tolist() if isinstance(x, np.ndarray) else x for x in v.tolist()]
    return out


def test_event_frames_match_jax():
    api = _api_events()
    ev = [Event.from_api_dict(d) for d in api]
    jev = [JaxEvent.from_api_dict(d) for d in api]
    # creation times are the parse time: carry JAX's over
    ev = [dataclasses.replace(e, creation_time=j.creation_time) for e, j in zip(ev, jev)]
    frame = pt_sbase.EventFrame.from_events(ev)
    jframe = jax_sbase.EventFrame.from_events(jev)
    assert _columns(frame) == _columns(jframe)
    assert frame.event_time_ms.dtype == np.int64 and len(frame) == 30
    mask = np.arange(30) % 4 != 1
    assert _columns(frame.select(mask)) == _columns(jframe.select(mask))
    assert _columns(frame.where_event("rate", "buy")) == _columns(
        jframe.where_event("rate", "buy"))
    assert set(frame.where_event("view").event) == {"view"}
    assert len(frame.where_event("nope")) == 0
    # the frame reads back the events it was made from
    assert [e.to_api_dict() for e in frame.to_events()] == [e.to_api_dict() for e in ev]
    # concatenation, and an optional column dropped unless all inputs carry it
    parts = [frame.select(np.arange(30) < 10), frame.select(np.arange(30) >= 10)]
    jparts = [jframe.select(np.arange(30) < 10), jframe.select(np.arange(30) >= 10)]
    assert _columns(pt_sbase.concat_frames(parts)) == _columns(frame)
    assert _columns(pt_sbase.concat_frames(parts)) == _columns(
        jax_sbase.concat_frames(jparts))
    bare = dataclasses.replace(parts[1], tags=None)
    jbare = dataclasses.replace(jparts[1], tags=None)
    got = pt_sbase.concat_frames([parts[0], bare])
    assert got.tags is None and _columns(got) == _columns(
        jax_sbase.concat_frames([jparts[0], jbare]))
    assert len(pt_sbase.concat_frames([])) == 0
    assert pt_sbase.concat_frames([parts[0], frame.select(np.zeros(30, bool))]) is parts[0]


def test_event_with_id():
    d = _api_events()[0]
    del d["eventId"]
    # a creation time of its own: without one each package stamps "now",
    # and the two reads of the clock may fall in different milliseconds
    d["creationTime"] = "2024-02-01T00:00:00.000Z"
    e = Event.from_api_dict(d)
    assert e.event_id is None
    named = e.with_id("ev42")
    assert named.event_id == "ev42" and e.event_id is None
    assert named.to_api_dict() == JaxEvent.from_api_dict(d).with_id("ev42").to_api_dict()
    fresh = e.with_id()
    assert len(fresh.event_id) == 32 and int(fresh.event_id, 16) >= 0
    assert fresh.event_id != e.with_id().event_id


# -- deadlines ---------------------------------------------------------------------------


def test_deadline_check_and_expired(monkeypatch):
    clock = [100.0]
    for mod in (pt_deadline, jax_deadline):
        monkeypatch.setattr(mod, "_now", lambda: clock[0])
    assert not pt_deadline.expired()
    pt_deadline.check()  # no deadline bound: nothing to raise
    tokens = [pt_deadline.set_deadline(0.5), jax_deadline.set_deadline(0.5)]
    try:
        for now in (100.0, 100.4999, 100.5, 101.25):
            clock[0] = now
            assert pt_deadline.expired() == jax_deadline.expired() == (now >= 100.5)
            got = want = None
            try:
                pt_deadline.check("wave")
            except pt_deadline.DeadlineExceeded as e:
                got = str(e)
            try:
                jax_deadline.check("wave")
            except jax_deadline.DeadlineExceeded as e:
                want = str(e)
            assert got == want
            assert (got is not None) == (now >= 100.5)
        assert got == "wave deadline exceeded (750 ms past budget)"
    finally:
        pt_deadline.reset_deadline(tokens[0])
        jax_deadline.reset_deadline(tokens[1])


# -- the single-blob model format --------------------------------------------------


def _models_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _models_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _models_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_serialize_models_reads_the_jax_blob_and_round_trips():
    from predictionio_tpu.core import persistence as jax_persistence
    from predictionio_tpu_torch.core import persistence as pt_persistence

    rng = np.random.default_rng(22)
    models = [
        {"user_factors": rng.standard_normal((7, 4)).astype(np.float32),
         "item_vocab": np.array(["i0", "i1", "i2"]), "rank": 4},
        [np.arange(5, dtype=np.int64), ("a", 1.5)],
        None,
    ]
    jax_blob = jax_persistence.serialize_models(models)
    _models_equal(pt_persistence.deserialize_models(jax_blob), models)
    # the port's own blob: tensors leave as host numpy, the JAX package reads it
    with_tensors = [{**models[0], "user_factors": torch.from_numpy(
        models[0]["user_factors"])}, *models[1:]]
    pt_blob = pt_persistence.serialize_models(with_tensors)
    _models_equal(pt_persistence.deserialize_models(pt_blob), models)
    _models_equal(jax_persistence.deserialize_models(pt_blob), models)


def test_load_models_reads_a_single_blob(storage):
    from predictionio_tpu_torch.core.persistence import serialize_models

    models = [{"w": np.linspace(0, 1, 6, dtype=np.float32)}]
    storage.models().insert("legacy", serialize_models(models))
    _models_equal(load_models(storage.models(), "legacy"), models)
