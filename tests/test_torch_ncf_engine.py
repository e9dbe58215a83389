"""The port's NCF template (predictionio_tpu_torch/models/ncf) against the JAX
package's, on the CPU.

- A model the JAX package trained deploys on the port from the same sqlite
  file: the host replica (solo queries) answers with the JAX host replica's
  ids and scores exactly (both are the same numpy arithmetic); device waves
  (``batch_predict``, ``dispatch_batch``) agree with the host answer and
  with the JAX package's waves within rtol 1e-5, ids exactly, unknown users
  answered empty.
- Blobs cross in both directions, each loaded in a fresh process: the port
  loads a JAX-written blob (its ``NCFParams`` included) with no ``jax``,
  ``optax`` or ``predictionio_tpu`` module loaded; the JAX package deploys
  a port-written blob (``config`` a dict of the same fields) and answers as
  the port does.
- The pre-packed checkpoint migration, the ALS-pretrain train (the tables
  start from the port's implicit ``train_als`` at rank ``embed_dim``), the
  warm start (the same initial tables as the JAX package's), and the deploy
  through the asyncio front end (device waves) and the threaded server
  (host replica).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import resolve_engine_factory as jax_resolve
from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.models.ncf import engine as jax_ncf
from predictionio_tpu.ops import ncf as jax_ops
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu_torch.core.base import EngineContext, SanityCheckError
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.ncf import engine as pt_ncf
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.ops import als as pt_als
from predictionio_tpu_torch.ops import ncf as pt_ops
from predictionio_tpu_torch.server.prediction_server import (
    create_prediction_server,
    deploy_engine,
)
from predictionio_tpu_torch.tools import commands as pt_cmd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 30, 20
RTOL = 1e-5

ALGOS = {
    "mlp": {"embedDim": 8, "mlpLayers": [16, 8], "numEpochs": 6,
            "batchSize": 64, "learningRate": 5e-3},
    "gmf": {"embedDim": 6, "mlpLayers": [], "loss": "full_softmax",
            "numEpochs": 4, "batchSize": 64, "learningRate": 5e-3},
}


def _events(rng, n=400):
    """Rate events with their own eventTime each: two taste clusters."""
    out = []
    for j in range(n):
        u = int(rng.integers(N_USERS))
        lo = 0 if u % 2 == 0 else N_ITEMS // 2
        i = lo + int(rng.integers(N_ITEMS // 2)) if rng.random() < 0.8 \
            else int(rng.integers(N_ITEMS))
        out.append({
            "event": "rate", "entityType": "user", "entityId": f"u{u}",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "properties": {"rating": float(rng.integers(1, 6))},
            "eventTime": f"2026-01-01T{j // 3600:02d}:{j // 60 % 60:02d}:"
                         f"{j % 60:02d}.000Z",
        })
    return out


def _variant(algo: str, app: str = "ncfapp", **over) -> dict:
    return {
        "engineFactory": "ncf",
        "datasource": {"params": {"appName": app}},
        "algorithms": [{"name": "ncf", "params": {**ALGOS[algo], **over}}],
    }


@pytest.fixture()
def homes(tmp_path):
    """Both packages' storage over one PIO_HOME holding the ncfapp events."""
    env = {"PIO_HOME": str(tmp_path / "pio_home")}
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    storage = StorageRuntime(StorageConfig.from_env(env))
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n"
                            for e in _events(np.random.default_rng(0))))
    pt_cmd.app_new(storage, "ncfapp")
    assert pt_cmd.import_events(storage, "ncfapp", path) == 400
    yield {"jax": jax_storage, "port": storage, "home": env["PIO_HOME"]}
    storage.close()
    jax_storage.close()


def _jax_train(jax_storage, algo: str):
    engine = jax_resolve("ncf")()
    params = engine.params_from_json(_variant(algo))
    return jax_run_train(engine, params, ctx=JaxEngineContext(storage=jax_storage),
                         storage=jax_storage, engine_factory="ncf")


def _port_train(storage, algo: str, **kw):
    engine = resolve_engine_factory("ncf")()
    params = engine.params_from_json(_variant(algo, **kw.pop("over", {})))
    return run_train(engine, params, ctx=EngineContext(storage=storage, device="cpu"),
                     storage=storage, engine_factory="ncf", **kw)


def _pairs(result):
    return [(s.item, s.score) for s in result.item_scores]


def _queries(mod, users, nums=(5, 3, 20, 1)):
    return [mod.Query(user=u, num=nums[j % len(nums)]) for j, u in enumerate(users)]


USERS = [f"u{u}" for u in range(N_USERS)] + ["stranger"]


def _hold_wave(got, want, what):
    """A wave's answer against a host answer: scores within rtol, ids
    exactly (no near tie in these models)."""
    assert [i for i, _ in got] == [i for i, _ in want], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL, atol=1e-7, err_msg=str(what))


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_host_replica_and_waves_match_the_jax_package(homes, algo):
    inst = _jax_train(homes["jax"], algo)
    jdep = jax_server.deploy_engine("ncf", storage=homes["jax"])
    pdep = deploy_engine("ncf", storage=homes["port"], device="cpu")
    assert pdep.instance.id == inst.id
    jalgo, jmodel = jdep.algorithms[0], jdep.models[0]
    palgo, pmodel = pdep.algorithms[0], pdep.models[0]
    assert isinstance(pmodel.state.config, pt_ops.NCFParams)
    assert pmodel.state.config == pt_ops.NCFParams(
        **{k: v for k, v in vars(jmodel.state.config).items()})
    jq, pq = _queries(jax_ncf, USERS), _queries(pt_rec, USERS)
    for a, b in zip(jq, pq):
        want = _pairs(jalgo.predict(jmodel, a))
        assert _pairs(palgo.predict(pmodel, b)) == want  # exact
        assert _pairs(palgo.predict(pmodel, b)) == want  # from the factor cache
    # waves: 31 queries and 40 (a full wave of 32 and one of 8)
    for n in (31, 40):
        iq = [(j, pq[j % len(pq)]) for j in range(n)]
        got = dict(palgo.batch_predict(pmodel, iq))
        jwant = dict(jalgo.batch_predict(jmodel, [(j, jq[j % len(jq)])
                                                  for j in range(n)]))
        for j, q in iq:
            if q.user == "stranger":
                assert got[j].item_scores == () and jwant[j].item_scores == ()
                continue
            host = _pairs(palgo.predict(pmodel, q))
            assert len(host) == min(q.num, N_ITEMS)
            _hold_wave(_pairs(got[j]), host, (n, j))
            _hold_wave(_pairs(got[j]), _pairs(jwant[j]), (n, j, "jax"))


def test_dispatch_batch_pads_to_the_menu_and_observes_the_wave(homes):
    _jax_train(homes["jax"], "mlp")
    pdep = deploy_engine("ncf", storage=homes["port"], device="cpu")
    algo, model = pdep.algorithms[0], pdep.models[0]
    iq = list(enumerate(_queries(pt_rec, USERS[:5], nums=(3,))))
    before = device_obs.default_recompiles().snapshot()
    with device_obs.wave_timeline() as tl:
        fin = algo.dispatch_batch(model, iq)
        out = fin()
    assert [i for i, _ in out] == list(range(5))
    assert set(tl.stages) >= {"host_gather", "compute", "d2h"}
    assert tl.fn == "ncf.batch_predict" and tl.flops > 0 and tl.kernel_s > 0
    # launched padded to b=32, k=16 (k never below 16, never past the
    # catalog); the least work counts the wave's 5 rows, not the padding
    shapes = (N_ITEMS,) + tuple(model.state.params["user_emb"].shape)
    sig = (5, 16) + shapes
    cost = device_obs.default_efficiency().cached_cost("ncf.batch_predict", sig)
    mlp = [tuple(x["w"].shape) for x in model.state.params["mlp"]]
    assert cost["flops"] == pt_ops.ncf_wave_least_work(
        5, N_ITEMS, 16, mlp, 16, True)["flops"]
    after = device_obs.default_recompiles().snapshot()
    assert after != before or (32, 16) + shapes in device_obs.default_recompiles(
    )._seen["ncf.batch_predict"]
    many = list(enumerate(_queries(pt_rec, USERS * 2)))
    assert algo.dispatch_batch(model, many) is None  # past MAX_WAVE
    forced = dict(algo.dispatch_batch(model, many, force=True)())
    assert forced.keys() == dict(many).keys()
    assert _pairs(forced[3]) == _pairs(dict(algo.batch_predict(model, many))[3])
    assert pt_ncf._wave_shape([(0, pt_rec.Query("u1", 100))], 26_744) == (32, 128)
    assert pt_ncf._wave_shape([(0, pt_rec.Query("u1", 17))] * 33, 20) == (64, 20)


def test_packed_transfer_refuses_a_catalog_past_2_24():
    class Vocab:
        def __len__(self):
            return 1 << 24

    model = pt_ncf.NCFModel(state=None, user_vocab=None, item_vocab=Vocab())
    with pytest.raises(ValueError, match="2\\^24"):
        pt_ncf._packable_n_items(model)


def _subprocess(code: str, home: str, env_extra=None) -> dict:
    env = {**os.environ, "PIO_HOME": home, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO)}
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


PORT_LOAD = """
import json, sys, torch
torch.set_num_threads(2)
from predictionio_tpu_torch.server.prediction_server import deploy_engine
dep = deploy_engine("ncf", device="cpu")
model = dep.models[0]
answers = {u: [[s.item, s.score] for s in dep.predict(dep.extract_query(
    {"user": u, "num": 4}))[1].item_scores] for u in %r}
print(json.dumps({
    "answers": answers,
    "config": [type(model.state.config).__module__, vars(model.state.config)],
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "predictionio_tpu")),
}))
"""

JAX_LOAD = """
import json
import predictionio_tpu.models
from predictionio_tpu.server.prediction_server import deploy_engine
dep = deploy_engine("ncf")
answers = {u: [[s.item, s.score] for s in dep.predict(dep.extract_query(
    {"user": u, "num": 4}))[1].item_scores] for u in %r}
print(json.dumps({"answers": answers,
                  "config": type(dep.models[0].state.config).__name__}))
"""


def test_jax_blob_loads_in_the_port_without_jax(homes):
    _jax_train(homes["jax"], "mlp")
    out = _subprocess(PORT_LOAD % (USERS,), homes["home"])
    assert out["loaded"] == []
    assert out["config"][0] == "predictionio_tpu_torch.ops.ncf"
    jdep = jax_server.deploy_engine("ncf", storage=homes["jax"])
    cfg = vars(jdep.models[0].state.config)
    assert out["config"][1] == {**cfg, "mlp_layers": list(cfg["mlp_layers"])}
    for u in USERS:
        _, want = jdep.predict(jdep.extract_query({"user": u, "num": 4}))
        assert [tuple(x) for x in out["answers"][u]] == _pairs(want)


def test_port_blob_loads_in_the_jax_package(homes):
    inst = _port_train(homes["port"], "mlp")
    [blob] = jax_load_models(homes["jax"].models(), inst.id)
    assert isinstance(blob["config"], dict)
    assert blob["config"] == {**vars(jax_ops.NCFParams(
        embed_dim=8, mlp_layers=(16, 8), num_epochs=6, batch_size=64,
        learning_rate=5e-3))}
    assert sorted(blob) == ["config", "item_vocab", "n_items", "n_users",
                            "params", "user_vocab"]
    out = _subprocess(JAX_LOAD % (USERS,), homes["home"])
    assert out["config"] == "dict"
    pdep = deploy_engine("ncf", storage=homes["port"], device="cpu")
    for u in USERS:
        _, want = pdep.predict(pdep.extract_query({"user": u, "num": 4}))
        assert [tuple(x) for x in out["answers"][u]] == _pairs(want)


def test_shard_plan_is_the_jax_plan_dict_and_ignored_on_one_device(homes):
    inst = _port_train(homes["port"], "gmf", over={"shardServing": True})
    [blob] = load_models(homes["port"].models(), inst.id)
    from predictionio_tpu.parallel.placement import ShardPlan

    algo = jax_ncf.NCFAlgorithm(jax_ncf.NCFAlgorithmParams(shard_serving=True))
    jstate = jax_ops.NCFState(params=blob["params"], n_users=blob["n_users"],
                              n_items=blob["n_items"], config=None)
    jmodel = jax_ncf.NCFModel(state=jstate,
                              user_vocab=JaxBiMap.from_state(blob["user_vocab"]),
                              item_vocab=JaxBiMap.from_state(blob["item_vocab"]))
    assert blob["shard_plan"] == algo.serving_shard_plan(jmodel).to_dict()
    assert ShardPlan.from_dict(blob["shard_plan"]) is not None
    pdep = deploy_engine("ncf", storage=homes["port"], device="cpu")
    _, res = pdep.predict(pdep.extract_query({"user": "u2", "num": 3}))
    assert len(res.item_scores) == 3


def test_pre_packed_checkpoint_still_deploys():
    """The four-table layout (user_gmf/item_gmf/user_mlp/item_mlp) loads
    into the packed layout and scores as the old formula does, on both
    packages."""
    rng = np.random.default_rng(0)
    d, n_u, n_i = 8, 12, 9
    scale = 1.0 / math.sqrt(d)
    old = {
        "user_gmf": rng.standard_normal((n_u, d)).astype(np.float32) * scale,
        "item_gmf": rng.standard_normal((n_i, d)).astype(np.float32) * scale,
        "user_mlp": rng.standard_normal((n_u, d)).astype(np.float32) * scale,
        "item_mlp": rng.standard_normal((n_i, d)).astype(np.float32) * scale,
        "mlp": [
            {"w": rng.standard_normal((2 * d, 16)).astype(np.float32),
             "b": np.zeros(16, np.float32)},
            {"w": rng.standard_normal((16, 8)).astype(np.float32),
             "b": np.zeros(8, np.float32)},
        ],
        "out_w": rng.standard_normal((d + 8, 1)).astype(np.float32),
        "out_b": np.zeros(1, np.float32),
    }
    users = np.asarray([f"u{u}" for u in range(n_u)])
    items = np.asarray([f"i{i}" for i in range(n_i)])
    data = {"params": old, "n_users": n_u, "n_items": n_i,
            "config": {**vars(pt_ops.NCFParams(embed_dim=d, mlp_layers=(16, 8)))},
            "user_vocab": BiMap.from_keys(users).to_state(),
            "item_vocab": BiMap.from_keys(items).to_state()}
    algo = pt_ncf.NCFAlgorithm()
    model = algo.load_persistent_model(EngineContext(device="cpu"), data)
    model.sanity_check()
    assert model.state.params["user_emb"].shape == (n_u, 2 * d)
    r = algo.predict(model, pt_rec.Query(user="u1", num=3))
    ue = np.concatenate([old["user_gmf"][1], old["user_mlp"][1]])
    scores = []
    for i in range(n_i):
        gmf = ue[:d] * old["item_gmf"][i]
        h = np.concatenate([ue[d:], old["item_mlp"][i]])
        for layer in old["mlp"]:
            h = np.maximum(h @ layer["w"] + layer["b"], 0.0)
        scores.append(float(np.concatenate([gmf, h]) @ old["out_w"][:, 0]
                            + old["out_b"][0]))
    assert r.item_scores[0].item == f"i{max(range(n_i), key=lambda i: scores[i])}"
    jdata = {**data, "config": jax_ops.NCFParams(embed_dim=d, mlp_layers=(16, 8))}
    jalgo = jax_ncf.NCFAlgorithm()
    jmodel = jalgo.load_persistent_model(JaxEngineContext(storage=None), jdata)
    assert _pairs(r) == _pairs(jalgo.predict(jmodel, jax_ncf.Query(user="u1", num=3)))
    wave = dict(algo.batch_predict(model, [(0, pt_rec.Query(user="u1", num=3))]))
    _hold_wave(_pairs(wave[0]), _pairs(r), "migrated wave")
    bad = dict(data, params={**data["params"], "user_gmf": old["user_gmf"] * np.nan})
    with pytest.raises(SanityCheckError, match="not finite"):
        algo.load_persistent_model(EngineContext(device="cpu"), bad).sanity_check()


def test_als_pretrain_starts_from_the_ports_implicit_als(homes, monkeypatch):
    calls = []
    real = pt_als.train_als

    def spy(*args, **kw):
        calls.append(kw["params"])
        out = real(*args, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(pt_als, "train_als", spy)
    over = {"pretrain": "als", "loss": "full_softmax", "weightDecay": 1e-4}
    inst = _port_train(homes["port"], "gmf", over={**over, "numEpochs": 0})
    p, als_state = calls
    assert (p.rank, p.num_iterations, p.reg, p.implicit_prefs, p.alpha) == (
        6, 20, 0.01, True, 2.0)
    [blob] = load_models(homes["port"].models(), inst.id)
    np.testing.assert_array_equal(blob["params"]["user_emb"],
                                  als_state.user_factors.numpy())
    np.testing.assert_array_equal(blob["params"]["item_emb"],
                                  als_state.item_factors.numpy())
    # then a fine-tuning epoch; the model serves
    _port_train(homes["port"], "gmf", over={**over, "numEpochs": 1})
    dep = deploy_engine("ncf", storage=homes["port"], device="cpu")
    _, res = dep.predict(dep.extract_query({"user": "u1", "num": 3}))
    assert len(res.item_scores) == 3
    with pytest.raises(ValueError, match="mlpLayers"):
        pt_ncf.NCFAlgorithmParams(pretrain="als", mlp_layers=(16,))
    with pytest.raises(ValueError, match="unknown pretrain"):
        pt_ncf.NCFAlgorithmParams(pretrain="bogus")


def test_no_positives_fail_the_sanity_check(homes):
    engine = resolve_engine_factory("ncf")()
    params = engine.params_from_json(_variant("gmf", positiveThreshold=9.0))
    with pytest.raises(SanityCheckError, match="no positive"):
        run_train(engine, params, ctx=EngineContext(storage=homes["port"],
                                                    device="cpu"),
                  storage=homes["port"])


def test_warm_start_takes_the_jax_packages_initial_tables(homes):
    first = _port_train(homes["port"], "mlp")
    [prev] = load_models(homes["port"].models(), first.id)
    ctx = EngineContext(storage=homes["port"], device="cpu", warm_start=[prev])
    td = pt_rec.RatingsDataSource(
        pt_rec.DataSourceParams(app_name="ncfapp")).read_training(ctx)
    pd = pt_rec.RatingsPreparator().prepare(ctx, td)
    # the warm-start pure-GMF tables (embed_dim 6 of the packed 8 + 8)
    algo = pt_ncf.NCFAlgorithm(pt_ncf.NCFAlgorithmParams(embed_dim=6, mlp_layers=()))
    got = algo._warm_start_initial(ctx, pd)
    jctx = JaxEngineContext(storage=homes["jax"])
    jctx.warm_start = [prev]
    jalgo = jax_ncf.NCFAlgorithm(jax_ncf.NCFAlgorithmParams(embed_dim=6,
                                                            mlp_layers=()))
    jpd = jax_ncf.PreparedData(
        user_vocab=JaxBiMap.from_keys(td.users), item_vocab=JaxBiMap.from_keys(td.items),
        user_idx=pd.user_idx, item_idx=pd.item_idx, ratings=pd.ratings)
    want = jalgo._warm_start_initial(jctx, jpd)
    for name in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(got["user_emb"], prev["params"]["user_emb"][:, :6])
    # run_train(warm_start_from=...) trains from those tables
    second = _port_train(homes["port"], "gmf", warm_start_from=first.id,
                         over={"numEpochs": 0})
    [blob] = load_models(homes["port"].models(), second.id)
    np.testing.assert_array_equal(blob["params"]["user_emb"], got["user_emb"])
    # an unusable previous model (a wider embedding asked) trains cold
    wide = pt_ncf.NCFAlgorithm(pt_ncf.NCFAlgorithmParams(embed_dim=64))
    assert wide._warm_start_initial(ctx, pd) is None


def _post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_deploy_through_both_front_ends(homes):
    _jax_train(homes["jax"], "mlp")
    jdep = jax_server.deploy_engine("ncf", storage=homes["jax"])
    for kind in ("aio", "threaded"):
        server = create_prediction_server(
            "ncf", host="127.0.0.1", port=0, storage=homes["port"],
            server_kind=kind, device="cpu").start_background()
        try:
            for u in USERS[:8] + ["stranger"]:
                got = [(x["item"], x["score"])
                       for x in _post(server.port, {"user": u, "num": 4})["itemScores"]]
                _, want = jdep.predict(jdep.extract_query({"user": u, "num": 4}))
                if kind == "threaded":  # the host replica: exact
                    assert got == _pairs(want), u
                else:  # a device wave of one
                    _hold_wave(got, _pairs(want), (kind, u))
        finally:
            server.shutdown()
