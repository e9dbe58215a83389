"""The port's training slice (predictionio_tpu_torch) against the JAX package,
on the CPU: the data plane, the warm start, and ``pio app new`` ->
``pio import`` -> ``pio train`` -> deploy end to end.

- Events written through either package's sqlite storage are read by the
  other package's ``RatingsDataSource``: ``read_training`` arrays and
  ``prepare`` vocabularies equal the JAX package's exactly.
- ``EventFrame.property_column`` and ``Event.from_api_dict`` behave as the
  JAX package's on the same inputs, junk included.
- ``_warm_start_init`` equals the JAX package's exactly (numpy RNG, the same
  vocab alignment).
- The CLI trains on the CPU into a COMPLETED instance that deploys, answers
  solo and 512-query waves as the trained factors say, and loads in the JAX
  package; ``run_train`` keeps the INIT -> COMPLETED/FAILED contract.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import EventFrame as JaxEventFrame
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core.base import EngineContext, SanityCheckError
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.persistence import save_models
from predictionio_tpu_torch.core.workflow import WorkflowParams, run_train
from predictionio_tpu_torch.data.event import Event, EventValidationError
from predictionio_tpu_torch.data.storage.base import EventFrame
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.server.prediction_server import deploy_engine
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.tools import commands as pt_cmd

torch.set_num_threads(2)

N_USERS, N_ITEMS = 40, 25


def _events(rng, n=600):
    """Rate events (float, int and numeric-string ratings, some missing),
    buy events (no rating), and events the data source must skip."""
    out = []
    for j in range(n):
        u, i = rng.integers(N_USERS), rng.integers(N_ITEMS)
        e = {
            "entityType": "user",
            "entityId": f"u{u}",
            "targetEntityType": "item",
            "targetEntityId": f"i{i}",
            "eventTime": f"2026-01-01T00:{j // 60:02d}:{j % 60:02d}.000Z",
        }
        x = rng.random()
        if x < 0.15:
            e["event"] = "buy"
        elif x < 0.2:
            e["event"] = "view"
        else:
            e["event"] = "rate"
            if x < 0.25:
                e["properties"] = {"rating": str(float(rng.integers(1, 6)))}
            elif x < 0.28:
                e["properties"] = {"note": "no rating"}
            else:
                e["properties"] = {"rating": int(rng.integers(1, 11)) / 2}
        out.append(e)
    return out


@pytest.fixture()
def homes(tmp_path):
    """Both packages' storage over one PIO_HOME."""
    env = {"PIO_HOME": str(tmp_path / "pio_home")}
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    storage = StorageRuntime(StorageConfig.from_env(env))
    yield jax_storage, storage
    storage.close()
    jax_storage.close()


def _write_events(path, rng, n=600):
    path.write_text("".join(json.dumps(e) + "\n" for e in _events(rng, n)))
    return path


def _read_both(jax_storage, storage, app):
    jds = jax_rec.RatingsDataSource(jax_rec.DataSourceParams(app_name=app))
    pds = pt_rec.RatingsDataSource(pt_rec.DataSourceParams(app_name=app))
    jtd = jds.read_training(JaxEngineContext(storage=jax_storage))
    ptd = pds.read_training(EngineContext(storage=storage, device="cpu"))
    return jtd, ptd


def _assert_same_data(jtd, ptd):
    np.testing.assert_array_equal(ptd.users, jtd.users)
    np.testing.assert_array_equal(ptd.items, jtd.items)
    assert ptd.ratings.dtype == np.float32
    np.testing.assert_array_equal(ptd.ratings, jtd.ratings)
    jpd = jax_rec.RatingsPreparator().prepare(None, jtd)
    ppd = pt_rec.RatingsPreparator().prepare(None, ptd)
    for name in ("user_vocab", "item_vocab"):
        np.testing.assert_array_equal(
            getattr(ppd, name).keys_array(), getattr(jpd, name).keys_array()
        )
    for name in ("user_idx", "item_idx", "ratings"):
        np.testing.assert_array_equal(getattr(ppd, name), getattr(jpd, name))
        assert getattr(ppd, name).dtype == getattr(jpd, name).dtype


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_events_the_other_wrote(homes, tmp_path, writer):
    jax_storage, storage = homes
    path = _write_events(tmp_path / "events.jsonl", np.random.default_rng(1))
    if writer == "jax":
        jax_cmd.app_new(jax_storage, "shop")
        assert jax_cmd.import_events(jax_storage, "shop", path) == 600
    else:
        desc = pt_cmd.app_new(storage, "shop", description="d")
        assert desc.to_json_dict()["accessKeys"][0]["key"]
        assert pt_cmd.import_events(storage, "shop", path) == 600
        # the JAX package sees the port's app and key
        app = jax_storage.apps().get_by_name("shop")
        assert app is not None and jax_storage.access_keys().get_by_appid(app.id)
    jtd, ptd = _read_both(jax_storage, storage, "shop")
    assert 400 < len(ptd.ratings) < 600  # views and unrated rates dropped
    _assert_same_data(jtd, ptd)


def test_channels_and_unknown_apps(homes, tmp_path):
    jax_storage, storage = homes
    jax_cmd.app_new(jax_storage, "shop")
    jax_cmd.channel_new(jax_storage, "shop", "mobile")
    path = _write_events(tmp_path / "m.jsonl", np.random.default_rng(2), 100)
    assert pt_cmd.import_events(storage, "shop", path, channel="mobile") == 100
    pds = pt_rec.RatingsDataSource(
        pt_rec.DataSourceParams(app_name="shop", channel_name="mobile")
    )
    ctx = EngineContext(storage=storage, device="cpu")
    assert len(pds.read_training(ctx).ratings) > 50
    jds = jax_rec.RatingsDataSource(
        jax_rec.DataSourceParams(app_name="shop", channel_name="mobile")
    )
    _assert_same_data(
        jds.read_training(JaxEngineContext(storage=jax_storage)),
        pds.read_training(ctx),
    )
    with pytest.raises(KeyError, match="Invalid app name"):
        pt_rec.RatingsDataSource(
            pt_rec.DataSourceParams(app_name="nope")
        ).read_training(ctx)
    with pytest.raises(pt_cmd.CommandError, match="already exists"):
        pt_cmd.app_new(storage, "shop")
    with pytest.raises(pt_cmd.CommandError, match="does not exist"):
        pt_cmd.import_events(storage, "shop", path, channel="web")


def test_property_column_matches_the_jax_package():
    props = [
        '{"rating": 4}', '{"rating": "4.5"}', '{"rating": true}',
        '{"rating": "x"}', "", "junk{", '{"other": 1}', '{"rating": [1]}',
        {"rating": 2}, {}, {"rating": "3"}, '{"rating": 4}', None,
    ]
    n = len(props)
    cols = dict(
        event=np.array(["rate"] * n, object),
        entity_type=np.array(["user"] * n, object),
        entity_id=np.array([f"u{i}" for i in range(n)], object),
        target_entity_type=np.array(["item"] * n, object),
        target_entity_id=np.array([f"i{i}" for i in range(n)], object),
        event_time_ms=np.arange(n, dtype=np.int64),
        properties=np.array(props, object),
    )
    for default in (np.nan, -1.0):
        want = JaxEventFrame(**cols).property_column("rating", default=default)
        got = EventFrame(**cols).property_column("rating", default=default)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    sub = EventFrame(**cols).take(np.array([1, 3]))
    assert list(sub.entity_id) == ["u1", "u3"] and len(sub) == 2


API_EVENTS = [
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 4}, "eventTime": "2026-01-02T03:04:05.678Z",
     "tags": ["a"], "prId": "p"},
    {"event": "$set", "entityType": "user", "entityId": "u1",
     "properties": {"a": 1}, "eventTime": 1767225600000},
    {"event": "rate", "entityType": "user"},
    {"event": "rate", "entityType": "user", "entityId": ""},
    {"event": "$unset", "entityType": "user", "entityId": "u1"},
    {"event": "$bogus", "entityType": "user", "entityId": "u1"},
    {"event": "$set", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1"},
    {"event": "rate", "entityType": "pio_user", "entityId": "u1"},
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item"},
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "properties": {"pio_x": 1}},
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "eventTime": "yesterday"},
    {"event": "rate", "entityType": "user", "entityId": 5},
    {"event": "rate", "entityType": "user", "entityId": "u1", "tags": "a"},
]


@pytest.mark.parametrize("payload", API_EVENTS, ids=range(len(API_EVENTS)))
def test_event_validation_matches_the_jax_package(payload):
    try:
        want = JaxEvent.from_api_dict(payload).to_api_dict()
    except ValueError as e:
        with pytest.raises(EventValidationError) as got:
            Event.from_api_dict(payload)
        assert str(got.value) == str(e)
        return
    got = Event.from_api_dict(payload).to_api_dict()
    want.pop("creationTime"), got.pop("creationTime")
    assert got == want


def test_warm_start_init_equals_the_jax_package():
    rng = np.random.default_rng(4)
    prev = {
        "user_factors": rng.random((6, 3), np.float32),
        "item_factors": rng.random((5, 3), np.float32),
        "user_vocab": np.array([f"u{i}" for i in range(6)]),
        "item_vocab": np.array([f"i{i}" for i in range(5)]),
    }
    td_users = np.array(["u9", "u1", "u4", "u7", "u0"], object)
    td_items = np.array(["i3", "i8", "i0", "i8", "i2"], object)
    ratings = np.ones(5, np.float32)
    jpd = jax_rec.RatingsPreparator().prepare(
        None, jax_rec.TrainingData(td_users, td_items, ratings)
    )
    ppd = pt_rec.RatingsPreparator().prepare(
        None, pt_rec.TrainingData(td_users, td_items, ratings)
    )
    params = dict(rank=3, seed=17)
    want = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(**params))._warm_start_init(
        JaxEngineContext(warm_start=[{"other": 1}, prev]), jpd
    )
    got = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(**params))._warm_start_init(
        EngineContext(device="cpu", warm_start=[{"other": 1}, prev]), ppd
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][1], prev["user_factors"][1])
    # another rank, or no previous model: a cold start
    algo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4))
    assert algo._warm_start_init(EngineContext(device="cpu", warm_start=[prev]), ppd) is None
    assert algo._warm_start_init(EngineContext(device="cpu"), ppd) is None


ENGINE_JSON = {
    "id": "default",
    "engineFactory": "recommendation",
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [
        {"name": "als", "params": {"rank": 4, "numIterations": 8, "lambda": 0.01}}
    ],
}


@pytest.fixture()
def trained(tmp_path, monkeypatch):
    """``app new`` -> ``import`` -> ``train --device cpu`` through the CLI."""
    storage = StorageRuntime(
        StorageConfig.from_env({"PIO_HOME": str(tmp_path / "pio_home")})
    )
    monkeypatch.setattr(cli, "get_storage", lambda: storage)
    events = _write_events(tmp_path / "events.jsonl", np.random.default_rng(5), 3000)
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ENGINE_JSON))
    assert cli.main(["app", "new", "shop"]) == 0
    assert cli.main(["import", "--app", "shop", "--input", str(events)]) == 0
    assert cli.main(["train", "--engine-json", str(engine_json), "--device", "cpu"]) == 0
    instance = storage.engine_instances().get_latest_completed(
        "default", "default", "default"
    )
    yield storage, instance, engine_json
    storage.close()


def test_cli_train_then_deploy_on_the_cpu(trained, tmp_path):
    storage, instance, _ = trained
    assert instance is not None and instance.status == "COMPLETED"
    assert json.loads(instance.algorithms_params)[0]["als"]["rank"] == 4
    deployed = deploy_engine("recommendation", storage=storage, device="cpu")
    algo, model = deployed.algorithms[0], deployed.models[0]
    assert deployed.instance.id == instance.id
    Uh, Vh = model.host_factors()
    assert np.isfinite(Uh).all() and Uh.shape[1] == 4
    # a solo query: the host answer of the trained factors
    uidx = model.user_vocab.get("u3")
    got = algo.predict(model, pt_rec.Query(user="u3", num=5))
    order = np.argsort(-(Vh @ Uh[uidx]), kind="stable")[:5]
    assert [s.item for s in got.item_scores] == [model.item_vocab.inverse(int(j)) for j in order]
    # a 512-query wave goes through the fused top-k path (its plain version)
    queries = [(i, pt_rec.Query(user=f"u{i % N_USERS}", num=3)) for i in range(512)]
    wave = dict(algo.batch_predict(model, queries))
    assert len(wave) == 512
    for i in (0, 7, 511):
        solo = algo.predict(model, queries[i][1])
        assert [s.item for s in wave[i].item_scores] == [s.item for s in solo.item_scores]
        np.testing.assert_allclose(
            [s.score for s in wave[i].item_scores],
            [s.score for s in solo.item_scores], rtol=1e-5,
        )


def test_the_jax_package_loads_the_port_trained_model(trained):
    storage, instance, _ = trained
    jax_storage = JaxStorageRuntime(
        JaxStorageConfig.from_env({"PIO_HOME": str(storage.config.home)})
    )
    try:
        (blob,) = jax_load_models(jax_storage.models(), instance.id)
        record = jax_storage.engine_instances().get(instance.id)
    finally:
        jax_storage.close()
    assert record.status == "COMPLETED" and record.engine_factory == "recommendation"
    deployed = deploy_engine("recommendation", storage=storage, device="cpu")
    U, V = deployed.models[0].host_factors()
    np.testing.assert_array_equal(blob["user_factors"], U)
    np.testing.assert_array_equal(blob["item_factors"], V)
    assert list(blob["user_vocab"]) == list(deployed.models[0].user_vocab.keys_array())


def test_stop_flags_and_failures(trained, caplog):
    storage, instance, engine_json = trained
    engine = resolve_engine_factory("recommendation")()
    params = engine.params_from_json(ENGINE_JSON)
    ctx = EngineContext(storage=storage, device="cpu")
    before = storage.engine_instances().get_latest_completed("default", "default", "default")
    for flags in ({"stop_after_read": True}, {"stop_after_prepare": True}):
        assert run_train(engine, params, ctx=ctx,
                         workflow_params=WorkflowParams(**flags)) is None
    assert storage.engine_instances().get_latest_completed(
        "default", "default", "default"
    ) == before
    # a stage that raises leaves the row FAILED
    bad = engine.params_from_json({**ENGINE_JSON, "datasource": {"params": {"appName": "nope"}}})
    with pytest.raises(KeyError):
        run_train(engine, bad, ctx=ctx, engine_id="broken")
    rows = storage.engine_instances().client.query(
        "SELECT status FROM pio_engine_instances WHERE engineId = 'broken'"
    )
    assert rows == [("FAILED",)]
    # a warm-started retrain logs the stage breakdown and completes
    with caplog.at_level(logging.INFO, logger="predictionio_tpu_torch.workflow"):
        done = run_train(engine, params, ctx=EngineContext(storage=storage, device="cpu"),
                         warm_start_from=instance.id)
    assert done.status == "COMPLETED"
    (record,) = [r for r in caplog.records if hasattr(r, "stages")]
    assert {"datasource.read", "preparator.prepare", "algorithm.als",
            "persist.save_models", "total"} <= set(record.stages)


def test_train_needs_cuda_unless_cpu(trained, monkeypatch):
    storage, _, engine_json = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train", "--engine-json", str(engine_json)]
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(device_mod.DeviceUnavailable):
        cli.main(argv)
    with pytest.raises(device_mod.DeviceUnavailable):
        als.train_als(np.zeros(3, np.int32), np.zeros(3, np.int32), np.ones(3), 1, 1)


def test_algorithm_train_and_sanity(trained):
    storage, _, _ = trained
    ctx = EngineContext(storage=storage, device="cpu")
    td = pt_rec.RatingsDataSource(pt_rec.DataSourceParams(app_name="shop")).read_training(ctx)
    pd = pt_rec.RatingsPreparator().prepare(ctx, td)
    model = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=3, num_iterations=2)).train(ctx, pd)
    assert model.user_factors.device == ctx.device
    assert model.user_factors.shape == (len(pd.user_vocab), 3)
    model.sanity_check()
    model.user_factors[0, 0] = float("nan")
    with pytest.raises(SanityCheckError):
        model.sanity_check()
    with pytest.raises(SanityCheckError):
        pt_rec.TrainingData(np.array([]), np.array([]), np.array([])).sanity_check()


def test_persisted_blob_layout(tmp_path):
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path)}))
    try:
        model = pt_rec.ALSModel(
            user_factors=torch.ones((3, 2)), item_factors=torch.zeros((4, 2)),
            user_vocab=pt_rec.BiMap.from_keys(["a", "b", "c"]),
            item_vocab=pt_rec.BiMap.from_keys(["w", "x", "y", "z"]),
        )
        blob = pt_rec.ALSAlgorithm().make_persistent_model(None, model)
        save_models(storage.models(), "inst", [blob])
        jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(tmp_path)}))
        (got,) = jax_load_models(jax_storage.models(), "inst")
        jax_storage.close()
    finally:
        storage.close()
    assert isinstance(got["user_factors"], np.ndarray)
    assert got["user_factors"].dtype == np.float32
    assert list(got["item_vocab"]) == ["w", "x", "y", "z"]
