"""The port's serving slice (predictionio_tpu_torch) against the JAX package,
on one model.

A tiny explicit-ALS model is trained by the JAX package (``run_train``, as
in the quickstart) into a temp ``PIO_HOME``.  The port deploys the same
COMPLETED engine instance from the same sqlite file on the CPU and must
answer as the JAX package does: solo queries exactly (both score on the
host numpy replica), waves of ``DEVICE_BATCH_MIN`` queries or more with the
same item ids and scores within 1e-5 (the JAX fused kernel in interpret
mode against the port's plain version), the batch job and the HTTP server
line for line.  Model blobs cross-load in both directions.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.batch_predict import (
    run_batch_predict as jax_run_batch_predict,
)
from predictionio_tpu.core.engine import (
    resolve_engine_factory as jax_resolve_engine_factory,
)
from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.core.persistence import save_models as jax_save_models
from predictionio_tpu.core.workflow import run_train
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.batch_predict import run_batch_predict
from predictionio_tpu_torch.core.persistence import load_models, save_models
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.ops import topk as pt_topk
from predictionio_tpu_torch.server.prediction_server import (
    create_prediction_server,
    deploy_engine,
)

torch.set_num_threads(2)

N_USERS, N_ITEMS, N_EVENTS = 30, 20, 400
WAVE = pt_rec.ALSAlgorithm.DEVICE_BATCH_MIN + 8


def _events(rng):
    events = []
    for _ in range(N_EVENTS):
        u, i = rng.integers(N_USERS), rng.integers(N_ITEMS)
        e = {
            "entityType": "user",
            "entityId": f"u{u}",
            "targetEntityType": "item",
            "targetEntityId": f"i{i}",
        }
        if rng.random() < 0.2:
            e["event"] = "buy"
        else:
            e["event"] = "rate"
            e["properties"] = {"rating": float(rng.integers(1, 6))}
        events.append(e)
    return events


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One JAX-trained model, and both packages' storage over its PIO_HOME."""
    root = tmp_path_factory.mktemp("torch_rec")
    home = root / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    jax_cmd.app_new(jax_storage, "quickstart")
    events_file = root / "events.jsonl"
    events_file.write_text(
        "".join(json.dumps(e) + "\n" for e in _events(np.random.default_rng(3)))
    )
    assert jax_cmd.import_events(jax_storage, "quickstart", events_file) == N_EVENTS
    engine = jax_resolve_engine_factory("recommendation")()
    params = engine.params_from_json(
        {
            "datasource": {"params": {"appName": "quickstart"}},
            "algorithms": [
                {
                    "name": "als",
                    "params": {"rank": 8, "numIterations": 3, "lambda": 0.01, "seed": 3},
                }
            ],
        }
    )
    instance = run_train(
        engine, params, ctx=JaxEngineContext(storage=jax_storage),
        engine_factory="recommendation", storage=jax_storage,
    )
    assert instance is not None and instance.status == "COMPLETED"
    port_storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    yield {
        "root": root,
        "jax_storage": jax_storage,
        "port_storage": port_storage,
        "instance": instance,
        "jax": jax_server.deploy_engine(
            "recommendation", storage=jax_storage, engine_instance_id=instance.id
        ),
        "port": deploy_engine(
            "recommendation", storage=port_storage, device="cpu"
        ),
    }
    port_storage.close()
    jax_storage.close()


def _pairs(result):
    return [(s.item, s.score) for s in result.item_scores]


def _queries(module, n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        module.Query(user=f"u{rng.integers(N_USERS)}", num=int(rng.choice([3, 4, 10])))
        for _ in range(n)
    ]


def test_port_binds_the_latest_completed_instance(trained):
    port = trained["port"]
    assert port.instance.id == trained["instance"].id
    assert port.ctx.device == torch.device("cpu")
    (model,) = port.models
    assert model.user_factors.device.type == "cpu"
    assert model.item_factors.dtype == torch.float32
    assert tuple(model.item_factors.shape) == (N_ITEMS, 8)
    assert port.algorithms[0].params.rank == trained["jax"].algorithms[0].params.rank


@pytest.mark.parametrize("user", [f"u{i}" for i in range(0, N_USERS, 3)] + ["nobody"])
def test_solo_predict_equals_jax_exactly(trained, user):
    jax_d, port_d = trained["jax"], trained["port"]
    want = jax_d.algorithms[0].predict(jax_d.models[0], jax_rec.Query(user=user, num=7))
    got = port_d.algorithms[0].predict(port_d.models[0], pt_rec.Query(user=user, num=7))
    assert _pairs(got) == _pairs(want)
    assert (len(_pairs(got)) == 0) == (user == "nobody")
    _, served = port_d.predict(pt_rec.Query(user=user, num=7))
    assert _pairs(served) == _pairs(want)


def _batch_both(trained, n, seed):
    jax_d, port_d = trained["jax"], trained["port"]
    jq = _queries(jax_rec, n, seed) + [jax_rec.Query(user="nobody", num=4)]
    pq = _queries(pt_rec, n, seed) + [pt_rec.Query(user="nobody", num=4)]
    want = dict(jax_d.algorithms[0].batch_predict(jax_d.models[0], list(enumerate(jq))))
    got = dict(port_d.algorithms[0].batch_predict(port_d.models[0], list(enumerate(pq))))
    assert sorted(got) == sorted(want) == list(range(n + 1))
    return got, want


def test_device_wave_matches_jax(trained):
    got, want = _batch_both(trained, WAVE, seed=1)
    # the wave took the fused top-k (its plain version on CPU tensors)
    shapes = pt_topk.LAST_KERNEL_SHAPES["als.fused_topk"]
    assert shapes["batch"] == WAVE and shapes["route"] == "plain"
    for i in got:
        g, w = _pairs(got[i]), _pairs(want[i])
        assert [x for x, _ in g] == [x for x, _ in w], i
        np.testing.assert_allclose(
            [s for _, s in g], [s for _, s in w], rtol=1e-5, atol=1e-5
        )
    assert _pairs(got[WAVE]) == []


def _exact_persisted(n_users, n_items, rank, seed):
    """A persisted ALS dict whose factors are positive integers over 8:
    every score is exact in fp32, with many exact ties."""
    rng = np.random.default_rng(seed)
    return {
        "user_factors": (rng.integers(1, 9, (n_users, rank)) / 8.0).astype(np.float32),
        "item_factors": (rng.integers(1, 9, (n_items, rank)) / 8.0).astype(np.float32),
        "user_vocab": np.array([f"u{i}" for i in range(n_users)]),
        "item_vocab": np.array([f"i{i}" for i in range(n_items)]),
    }


def test_off_menu_device_wave_matches_jax():
    """A device wave whose num is past the fused menu: the JAX package
    scores the full row on its device (lax.top_k, ties by id ascending),
    and the port's CPU model answers the same, ties included."""
    persisted = _exact_persisted(40, 300, 4, seed=9)
    jax_algo, pt_algo = jax_rec.ALSAlgorithm(), pt_rec.ALSAlgorithm()
    jax_model = jax_algo.load_persistent_model(JaxEngineContext(), persisted)
    pt_model = pt_rec.ALSModel.from_jax_params(persisted, "cpu")
    num = pt_topk.MAX_FUSED_K + 72
    rng = np.random.default_rng(10)
    users = [f"u{rng.integers(40)}" for _ in range(WAVE)]
    want = dict(jax_algo.batch_predict(
        jax_model, list(enumerate(jax_rec.Query(user=u, num=num) for u in users))
    ))
    before = pt_topk.FULL_ROW_FALLBACKS.get("als.batch_topk", 0)
    got = dict(pt_algo.batch_predict(
        pt_model, list(enumerate(pt_rec.Query(user=u, num=num) for u in users))
    ))
    assert pt_topk.FULL_ROW_FALLBACKS["als.batch_topk"] == before + 1
    assert sorted(got) == sorted(want) == list(range(WAVE))
    for i in got:
        assert len(got[i].item_scores) == num
        assert _pairs(got[i]) == _pairs(want[i]), i


def test_off_menu_device_wave_raises_off_the_cpu():
    # the off-menu wave runs on the model's device, CPU or CUDA (the card's
    # answer is held to the CPU's in tests/test_torch_kernels_cuda.py); a
    # model on any other device gets no host-replica answer: it raises
    model = pt_rec.ALSModel.from_jax_params(_exact_persisted(40, 300, 4, 9), "meta")
    algo = pt_rec.ALSAlgorithm()
    queries = [pt_rec.Query(user=f"u{i % 40}", num=200) for i in range(WAVE)]
    before = pt_topk.FULL_ROW_FALLBACKS.get("als.batch_topk", 0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        algo.batch_predict(model, list(enumerate(queries)))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        algo.dispatch_batch(model, list(enumerate(queries)))
    assert pt_topk.FULL_ROW_FALLBACKS.get("als.batch_topk", 0) == before


def test_host_wave_matches_jax_exactly(trained):
    got, want = _batch_both(trained, 40, seed=2)
    for i in got:
        assert _pairs(got[i]) == _pairs(want[i]), i


def test_dispatch_batch_fences_the_same_answers(trained):
    port_d = trained["port"]
    algo, model = port_d.algorithms[0], port_d.models[0]
    assert algo.dispatch_batch(model, list(enumerate(_queries(pt_rec, 10)))) is None
    iq = list(enumerate(_queries(pt_rec, WAVE, seed=4)))
    finalize = algo.dispatch_batch(model, iq)
    assert finalize is not None
    assert sorted(finalize(), key=lambda x: x[0]) == sorted(
        algo.batch_predict(model, iq), key=lambda x: x[0]
    )


def test_predict_batch_equals_jax_exactly(trained):
    jax_d, port_d = trained["jax"], trained["port"]
    got = port_d.predict_batch(_queries(pt_rec, 12, seed=5))
    want = jax_d.predict_batch(_queries(jax_rec, 12, seed=5))
    assert len(got) == len(want) == 12
    for (gq, gp), (wq, wp) in zip(got, want):
        assert (gq.user, gq.num) == (wq.user, wq.num)
        assert _pairs(gp) == _pairs(wp)


def _write_queries(path, n, seed):
    rng = np.random.default_rng(seed)
    users = [f"u{rng.integers(N_USERS)}" for _ in range(n)] + ["nobody"]
    path.write_text(
        "".join(json.dumps({"user": u, "num": 5}) + "\n" for u in users)
    )


@pytest.mark.parametrize("n", [7, WAVE])
def test_run_batch_predict_writes_the_jax_lines(trained, n, tmp_path):
    qfile = tmp_path / "q.jsonl"
    _write_queries(qfile, n, seed=n)
    jout, pout = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert jax_run_batch_predict(
        "recommendation", qfile, jout, storage=trained["jax_storage"]
    ) == n + 1
    assert run_batch_predict(
        "recommendation", qfile, pout, storage=trained["port_storage"], device="cpu"
    ) == n + 1
    jl, pl = jout.read_text().splitlines(), pout.read_text().splitlines()
    if n < pt_rec.ALSAlgorithm.DEVICE_BATCH_MIN:
        assert pl == jl  # both on the host replica: byte for byte
        return
    for a, b in zip(pl, jl):  # device wave: same ids, scores within 1e-5
        a, b = json.loads(a), json.loads(b)
        assert a["query"] == b["query"]
        ga, gb = a["prediction"]["itemScores"], b["prediction"]["itemScores"]
        assert [x["item"] for x in ga] == [x["item"] for x in gb]
        np.testing.assert_allclose(
            [x["score"] for x in ga], [x["score"] for x in gb], rtol=1e-5, atol=1e-5
        )


def _post(base, payload):
    req = urllib.request.Request(
        base + "/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def test_http_queries_answer_as_jax(trained):
    jax_srv = jax_server.create_prediction_server(
        "recommendation", host="127.0.0.1", port=0,
        storage=trained["jax_storage"], server_kind="threaded",
    ).start_background()
    port_srv = create_prediction_server(
        "recommendation", host="127.0.0.1", port=0,
        storage=trained["port_storage"], device="cpu",
    ).start_background()
    try:
        jb = f"http://127.0.0.1:{jax_srv.port}"
        pb = f"http://127.0.0.1:{port_srv.port}"
        page = urllib.request.urlopen(pb + "/", timeout=10).read().decode()
        assert "Engine is deployed" in page
        for payload in ({"user": "u1", "num": 4}, {"user": "u7", "num": 10},
                        {"user": "nobody", "num": 4}):
            assert _post(pb, payload) == _post(jb, payload)
        bad = urllib.request.Request(pb + "/queries.json", data=b"[1, 2]")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=10)
        assert err.value.code == 400
        stop = urllib.request.Request(pb + "/stop", method="POST")
        assert json.loads(urllib.request.urlopen(stop, timeout=10).read()) == {
            "message": "Shutting down."
        }
        port_srv._thread.join(timeout=10)
        assert not port_srv._thread.is_alive()
    finally:
        jax_srv.shutdown()
        port_srv.shutdown()


def _fresh_pair(tmp_path):
    home = tmp_path / "pio_home"
    return (
        StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)})),
        JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(home)})),
    )


def test_port_blob_deploys_in_jax(trained, tmp_path):
    """A model the port persists (``save_models``) deploys in the JAX
    ``deploy_engine`` and answers as the port does."""
    port_d = trained["port"]
    algo, model = port_d.algorithms[0], port_d.models[0]
    persisted = algo.make_persistent_model(port_d.ctx, model)
    # a different model than the trained one: doubled user factors
    persisted["user_factors"] = persisted["user_factors"] * 2
    port_st, jax_st = _fresh_pair(tmp_path)
    instance = dataclasses.replace(
        trained["port_storage"].engine_instances().get(trained["instance"].id),
        id="port-written",
    )
    port_st.engine_instances().insert(instance)
    save_models(port_st.models(), instance.id, [persisted], threshold=64)
    jax_d = jax_server.deploy_engine(
        "recommendation", storage=jax_st, engine_instance_id="port-written"
    )
    mine = deploy_engine("recommendation", storage=port_st, device="cpu")
    assert mine.instance.id == "port-written"
    for user in ("u0", "u5", "u29"):
        want = jax_d.algorithms[0].predict(
            jax_d.models[0], jax_rec.Query(user=user, num=6)
        )
        got = mine.algorithms[0].predict(mine.models[0], pt_rec.Query(user=user, num=6))
        assert _pairs(got) == _pairs(want)
    (blob,) = jax_load_models(jax_st.models(), "port-written")
    np.testing.assert_array_equal(blob["user_factors"], persisted["user_factors"])
    port_st.close()
    jax_st.close()


@pytest.mark.parametrize("threshold", [None, 64])
def test_jax_blob_loads_in_port_byte_for_byte(trained, tmp_path, threshold):
    (persisted,) = jax_load_models(
        trained["jax_storage"].models(), trained["instance"].id
    )
    port_st, jax_st = _fresh_pair(tmp_path)
    jax_save_models(jax_st.models(), "jax-written", [persisted], threshold=threshold)
    (got,) = load_models(port_st.models(), "jax-written")
    assert sorted(got) == sorted(persisted)
    for key, want in persisted.items():
        assert got[key].dtype == want.dtype
        assert got[key].tobytes() == want.tobytes()
    port_st.close()
    jax_st.close()


def test_from_jax_params_round_trip(trained):
    (persisted,) = jax_load_models(
        trained["jax_storage"].models(), trained["instance"].id
    )
    model = pt_rec.ALSModel.from_jax_params(persisted, "cpu")
    assert isinstance(model.user_factors, torch.Tensor)
    np.testing.assert_array_equal(model.user_factors.numpy(), persisted["user_factors"])
    assert len(model.user_vocab) == len(persisted["user_vocab"])
    algo = pt_rec.ALSAlgorithm()
    back = algo.make_persistent_model(EngineContext(device="cpu"), model)
    assert sorted(back) == sorted(persisted)
    for key, want in persisted.items():
        np.testing.assert_array_equal(back[key], want)
        assert back[key].dtype == want.dtype


def test_training_is_the_next_slice():
    # the training slice has landed: train() returns a model on the
    # context's device; factor-sharded serving still waits for its slice
    algo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=3, num_iterations=2))
    ctx = EngineContext(device="cpu")
    td = pt_rec.TrainingData(
        users=np.array(["u0", "u1", "u1"], object),
        items=np.array(["i0", "i0", "i1"], object),
        ratings=np.array([4.0, 3.0, 5.0], np.float32),
    )
    model = algo.train(ctx, pt_rec.RatingsPreparator().prepare(ctx, td))
    assert model.user_factors.shape == (2, 3)
    assert model.item_factors.device == ctx.device
    with pytest.raises(NotImplementedError):
        algo._sharded_topk(None, np.zeros(1, np.int32), 1)
