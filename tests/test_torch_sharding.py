"""Factor-sharded serving of the port against the JAX package's, on the CPU.

The JAX package runs on its 8-virtual-device CPU mesh (``tests/conftest.py``);
the port runs the same inputs, made from a numpy seed, on eight CPU slots
(``[torch.device("cpu")] * 8``):

- ``ShardPlan``: the same ``to_dict`` (ALS and NCF plans, ``ndims``
  included), the same ``rebind`` over a table of (axes, n) cases, the same
  errors; ``make_mesh``'s shapes, slot labels and errors;
- the padding helpers on the edge cases of ``tests/test_sharding.py``;
- ``build_sharded_topk``: n not divisible by 8, k above a shard's rows,
  ties planted at shard boundaries, fused and unfused local steps: ids
  equal, scores within 1e-6;
- the ALS and NCF engines: one JAX blob loaded by both packages onto 8
  slots (and the port's rebound onto 2 and 3) answers the same, ties across
  a boundary included; solo answers unchanged;
- ``settle_shards``, the straggler board, ``/shards.json`` and
  ``/efficiency.json``'s ``shards`` (fresh registries on both sides), the
  ``:shardplan`` sidecar and the generation manifest, the micro-batched
  wave's meta and its ``wave.shard`` fragments, and the straggler
  acceptance (a slowed slot flagged, a balanced mesh quiet).

A sharded wave through kernel 3 on a card is held to its plain version in
``tests/test_torch_kernels_cuda.py`` (marked ``cuda``; no JAX there).
"""

from __future__ import annotations

import asyncio
import contextlib
import http.client
import io
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import (
    resolve_engine_factory as jax_resolve_engine_factory,
)
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.data.datamap import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.models.ncf import engine as jax_ncf
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.obs import device as jax_device
from predictionio_tpu.obs import disttrace as jax_disttrace
from predictionio_tpu.obs import logging as jax_logging
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.ops import ncf as jax_ops_ncf
from predictionio_tpu.parallel import mesh as jax_mesh
from predictionio_tpu.parallel import placement as jax_pl
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.lifecycle.generations import (
    GenerationStore,
    read_shard_plan,
)
from predictionio_tpu_torch.models.ncf import engine as pt_ncf
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.obs import device as pt_device
from predictionio_tpu_torch.obs import disttrace as pt_disttrace
from predictionio_tpu_torch.obs import logging as pt_logging
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.ops import topk as pt_topk
from predictionio_tpu_torch.parallel import mesh as pt_mesh
from predictionio_tpu_torch.parallel import placement as pt_pl
from predictionio_tpu_torch.resilience import faults as pt_faults
from predictionio_tpu_torch.server.httpd import AppServer, HTTPApp
from predictionio_tpu_torch.server.microbatch import MicroBatcher

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8
#: scores of the two packages' sharded top-k (ids are held exactly)
SCORE_TOL = 1e-6
TIMEOUT = 10


def _ctx(slots=CPU8) -> EngineContext:
    return EngineContext(device="cpu", mesh_devices=slots)


def _vocab(prefix: str, n: int) -> np.ndarray:
    return np.array([f"{prefix}{i}" for i in range(n)])


# ---------------------------------------------------------------------------
# ShardPlan and the mesh


REBIND_CASES = [
    ({"model": -1}, 8), ({"model": -1}, 4), ({"model": -1}, 1),
    ({"model": 8}, 4), ({"model": 8}, 8), ({"model": 3}, 8),
    ({"data": 2, "model": 4}, 8), ({"data": 2, "model": 4}, 2),
    ({"data": 2, "model": 4}, 6), ({"data": 2, "model": -1}, 8),
    ({"data": 2, "model": -1}, 5), ({"data": 3, "model": -1}, 0),
]


@pytest.mark.parametrize("axes,n", REBIND_CASES)
def test_rebind_agrees(axes, n):
    specs = {"t": ("model", None)}
    got = pt_pl.ShardPlan(axes=dict(axes), specs=specs).rebind(n)
    want = jax_pl.ShardPlan(axes=dict(axes), specs=specs).rebind(n)
    assert got.to_dict() == want.to_dict()


def test_plan_dicts_are_json_equal():
    als = {"rows": {"user_factors": 21, "item_factors": 37}}
    ncf = {"rows": {"user_emb": 9, "item_emb": 7, "item_bias": 7},
           "ndims": {"item_bias": 1}}
    for names, kw in ((["user_factors", "item_factors"], als),
                      (["user_emb", "item_emb", "item_bias"], ncf)):
        got = pt_pl.ShardPlan.model_parallel(names, **kw).to_dict()
        want = jax_pl.ShardPlan.model_parallel(names, **kw).to_dict()
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        back = pt_pl.ShardPlan.from_dict(json.loads(json.dumps(got)))
        assert back == pt_pl.ShardPlan.model_parallel(names, **kw)
    assert pt_pl.ShardPlan.from_dict(None) is None
    assert pt_pl.ShardPlan.from_dict({}) is None
    assert pt_pl.PLAN_SCHEMA_VERSION == jax_pl.PLAN_SCHEMA_VERSION


def test_plan_errors_match():
    msgs = []
    for pl, mesh in ((pt_pl, pt_mesh.make_mesh(pt_mesh.MeshConfig({"data": -1}), CPU8)),
                     (jax_pl, jax_mesh.make_mesh(jax_mesh.MeshConfig({"data": -1})))):
        row = []
        with pytest.raises(pl.ShardPlanError) as e:
            pl.ShardPlan(axes={"a": -1, "b": -1}).rebind(8)
        row.append(str(e.value))
        plan = pl.ShardPlan(axes={"model": -1}, specs={"t": ("model", None)})
        with pytest.raises(pl.ShardPlanError) as e:
            plan.shard_multiple(mesh, "t")
        row.append(str(e.value))
        row.append(plan.shard_multiple(pl.ShardPlan.model_parallel(["t"]).mesh(
            CPU8 if pl is pt_pl else None), "t"))
        msgs.append(row)
    assert msgs[0] == msgs[1]


MESH_CASES = [
    ({"data": -1}, 8), ({"model": -1}, 4), ({"data": 2, "model": 4}, 8),
    ({"data": 2, "model": -1}, 8), ({"data": 3, "model": -1}, 8),
    ({"a": -1, "b": -1}, 8), ({"data": 16}, 8), ({}, 8),
]


@pytest.mark.parametrize("axes,n", MESH_CASES)
def test_make_mesh_agrees(axes, n):
    out = []
    for mod, devices in ((pt_mesh, [torch.device("cpu")] * n),
                         (jax_mesh, jax.devices()[:n])):
        try:
            mesh = mod.make_mesh(mod.MeshConfig(axes=dict(axes)), devices)
        except ValueError as e:
            out.append(("error", str(e)))
            continue
        labels = [f"{d.type}:{i}" for i, d in enumerate(mesh.devices.flat)] \
            if mod is pt_mesh else [f"{d.platform}:{d.id}" for d in mesh.devices.flat]
        out.append((dict(mesh.shape), mesh.devices.size, labels))
    assert out[0] == out[1]


def test_mesh_slots_and_default_devices(monkeypatch):
    mesh = pt_mesh.make_mesh(pt_mesh.MeshConfig({"model": -1}), CPU8)
    assert mesh.labels == [f"cpu:{i}" for i in range(8)]
    assert mesh.physical_devices == [torch.device("cpu")]
    assert mesh.merge_device == torch.device("cpu")
    grid = pt_mesh.make_mesh(pt_mesh.MeshConfig({"data": 2, "model": 4}), CPU8)
    assert grid.positions("model") == [0, 1, 2, 3] * 2
    assert grid.owners("model") == [0, 1, 2, 3]
    assert grid.owners("data") == [0, 4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pt_mesh.DeviceUnavailable):
        pt_mesh.make_mesh()
    with pytest.raises(pt_mesh.DeviceUnavailable):
        pt_pl.ShardPlan.model_parallel(["t"]).mesh()


# ---------------------------------------------------------------------------
# padding helpers (the edge cases of tests/test_sharding.py)


PAD_CASES = [
    (np.arange(5), 0, 0), (np.arange(5), -4, 0), (np.zeros(0, np.int32), 8, 0),
    (np.arange(5, dtype=np.int32), 4, -1), (np.ones((5, 3), np.float32), 8, 0),
    (np.arange(8, dtype=np.int64), 4, 0), (np.ones((3, 2), np.float32), 1, 0),
]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", range(len(PAD_CASES)))
def test_pad_to_multiple_agrees(case):
    arr, mult, fill = PAD_CASES[case]
    got = _outcome(pt_mesh.pad_to_multiple, arr, mult, fill=fill)
    want = _outcome(jax_mesh.pad_to_multiple, arr, mult, fill=fill)
    assert got[0] == want[0]
    if got[0] == "error":
        assert got[1] == want[1]
    else:
        np.testing.assert_array_equal(got[1][0], want[1][0])
        assert got[1][0].dtype == want[1][0].dtype and got[1][1] == want[1][1]


BALANCE_CASES = [
    ([np.arange(3)], 0), ([], 4), ([np.arange(3), np.arange(4)], 4),
    ([np.zeros(0, np.float32)], 4),
    ([np.arange(5, dtype=np.int64), np.ones(5, np.float32)], 4),
    ([np.arange(8, dtype=np.int32)], 4),
]


@pytest.mark.parametrize("case", range(len(BALANCE_CASES)))
def test_balance_local_chunks_agrees(case):
    arrays, mult = BALANCE_CASES[case]
    got = _outcome(pt_mesh.balance_local_chunks, arrays, mult)
    want = _outcome(jax_mesh.balance_local_chunks, arrays, mult)
    assert got[0] == want[0]
    if got[0] == "error":
        assert got[1] == want[1]
        return
    (g_arrs, g_valid), (w_arrs, w_valid) = got[1], want[1]
    np.testing.assert_array_equal(g_valid, w_valid)
    for g, w in zip(g_arrs, w_arrs, strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# ---------------------------------------------------------------------------
# the factor-sharded top-k kernel against the JAX package's


def _tied_table(n: int) -> np.ndarray:
    """Rows whose first column repeats in pairs straddling every boundary
    of 2-row shards (rows 1 and 2, 3 and 4, ...)."""
    V = np.zeros((n, 2), np.float32)
    V[:, 0] = np.repeat(np.arange(n // 2 + 1)[::-1], 2)[1 : n + 1].astype(np.float32)
    return V


TOPK_CASES = {
    # name: (n_users, n_items, rank, k, fused, queries)
    "n37_k10": (21, 37, 5, 10, False, None),
    "n37_k12_wide": (21, 37, 5, 12, False, None),
    "n37_k10_fused": (21, 37, 5, 10, True, None),
    "n37_k12_fused": (21, 37, 5, 12, True, None),
    "n61_k3": (9, 61, 4, 3, False, None),
    "n61_k5_fused": (9, 61, 4, 5, True, None),
    "ties_k3": (0, 16, 2, 3, False, "ties"),
    "ties_k5_fused": (0, 16, 2, 5, True, "ties"),
    "ties_k16": (0, 16, 2, 16, False, "ties"),
    "ties_odd_k7_fused": (0, 19, 2, 7, True, "ties"),
}


def _topk_inputs(case: str):
    nu, ni, r, k, fused, kind = TOPK_CASES[case]
    rng = np.random.default_rng(len(case) + ni)
    if kind == "ties":
        V = _tied_table(ni)
        Q = np.array([[1.0, 0.0], [2.0, 0.5], [-1.0, 0.0]], np.float32)
    else:
        V = rng.normal(size=(ni, r)).astype(np.float32)
        Q = rng.normal(size=(nu, r)).astype(np.float32)[[0, 3, 7, nu - 1]]
    return Q, V, k, fused


def _jax_sharded(Q, V, k, fused, name):
    from predictionio_tpu.ops.topk import fused_topk_batch

    plan = jax_pl.ShardPlan.model_parallel(["V"], rows={"V": len(V)})
    bound = jax_pl.bind_shards(plan, {"V": V})

    def local(Vl, q, kc, limit):
        packed = fused_topk_batch(q, Vl, kc, limit=limit, name=name + ".f")
        return packed[0], packed[1].astype(jnp.int32)

    fn = jax_pl.build_sharded_topk(
        bound.mesh, bound.plan, lambda Vl, q: q @ Vl.T, ["V"],
        n_items=len(V), k=k, name=name, local_topk_fn=local if fused else None,
    )
    return np.asarray(fn(bound.arrays["V"], jnp.asarray(Q)))


def _port_sharded(Q, V, k, fused, name, slots=CPU8):
    plan = pt_pl.ShardPlan.model_parallel(["V"], rows={"V": len(V)})
    bound = pt_pl.bind_shards(plan, {"V": V}, devices=slots)

    def local(Vl, q, kc, limit):
        packed = pt_topk.fused_topk_batch(q, Vl, kc, limit=limit, name=name + ".f")
        return packed[0], packed[1]

    fn = pt_pl.build_sharded_topk(
        bound.mesh, lambda Vl, q: q @ Vl.T,
        n_items=len(V), k=k, name=name, local_topk_fn=local if fused else None,
    )
    res = fn(bound.arrays["V"], torch.from_numpy(Q).to(bound.mesh.merge_device))
    return res.packed.cpu().numpy(), bound


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_sharded_topk_matches_jax(case):
    Q, V, k, fused = _topk_inputs(case)
    want = _jax_sharded(Q, V, k, fused, f"jax.{case}")
    got, bound = _port_sharded(Q, V, k, fused, f"pt.{case}")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=SCORE_TOL, atol=SCORE_TOL)
    # ... and the unsharded stable top-k of the whole catalog
    full = torch.from_numpy(Q) @ torch.from_numpy(V).T
    _, idx = torch.sort(full + 0.0, dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(got[1].astype(np.int64), idx[:, :k].numpy())
    shapes = pt_pl.LAST_KERNEL_SHAPES[f"pt.{case}"]
    jshapes = jax_pl.LAST_KERNEL_SHAPES[f"jax.{case}"]
    assert shapes == jshapes
    assert shapes["rows_local"] * shapes["n_shards"] == bound.arrays["V"].shape[0]
    assert shapes["fused"] == int(fused)


def test_gather_rows_and_attribution_match_jax():
    rng = np.random.default_rng(1)
    U = rng.normal(size=(21, 5)).astype(np.float32)
    plan_kw = {"rows": {"U": 21}}
    pbound = pt_pl.bind_shards(pt_pl.ShardPlan.model_parallel(["U"], **plan_kw),
                               {"U": U}, devices=CPU8)
    jbound = jax_pl.bind_shards(jax_pl.ShardPlan.model_parallel(["U"], **plan_kw),
                                {"U": U})
    idx = np.array([0, 3, 7, 20, 20, 2], np.int32)
    got = pt_pl.gather_rows(pbound.mesh, pbound.arrays["U"], torch.from_numpy(idx))
    want = jax_pl.gather_rows(jbound.mesh, jbound.arrays["U"], jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pbound.attribution() == jbound.attribution()
    assert pt_mesh.shard_attribution({"U": pbound.arrays["U"], "h": U}) == (
        jax_mesh.shard_attribution({"U": jbound.arrays["U"], "h": U}))
    rep = pt_pl.replicate(pbound.mesh, U)
    assert len({id(t) for t in rep.locals}) == 1  # one copy per device
    assert pt_mesh.shard_attribution(rep) == jax_mesh.shard_attribution(
        jax_pl.replicate(jbound.mesh, U))


# ---------------------------------------------------------------------------
# the engines: one JAX blob, both packages' sharded answers


@pytest.fixture(scope="module")
def als_blob():
    """A JAX-persisted ALS model with a shard plan; item 12 equals item 13
    and item 4 equals item 5 (a tie across each 8-way shard boundary of
    the 5-row shards)."""
    rng = np.random.default_rng(2)
    nu, ni = 50, 37
    U = rng.normal(size=(nu, 4)).astype(np.float32)
    V = rng.normal(size=(ni, 4)).astype(np.float32)
    V[5] = V[4]
    V[13] = V[12]
    algo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4, shard_serving=True))
    model = jax_rec.ALSModel(U, V, JaxBiMap.from_keys(_vocab("u", nu)),
                             JaxBiMap.from_keys(_vocab("i", ni)))
    return algo.make_persistent_model(None, model)


def _answers(results):
    return {i: [(s.item, s.score) for s in r.item_scores] for i, r in results}


def _hold(got, want):
    assert set(got) == set(want)
    for i in want:
        assert [x for x, _ in got[i]] == [x for x, _ in want[i]], i
        np.testing.assert_allclose([s for _, s in got[i]], [s for _, s in want[i]],
                                   rtol=SCORE_TOL, atol=SCORE_TOL)


def test_als_plan_and_blob_match_jax(als_blob):
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4, shard_serving=True))
    loaded = palgo.load_persistent_model(_ctx(), als_blob)
    assert loaded.shards is not None
    assert loaded.shards.mesh.shape == {"model": 8}
    blob = palgo.make_persistent_model(None, loaded)
    assert blob["shard_plan"] == als_blob["shard_plan"]
    np.testing.assert_array_equal(blob["item_factors"], als_blob["item_factors"])
    attr = loaded.shards.attribution()
    jattr = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4)).load_persistent_model(
        None, als_blob).shards.attribution()
    assert attr == jattr
    total = sum(e["bytes"] for e in attr.values())
    assert all(e["bytes"] < total / 4 for e in attr.values())
    # one slot ignores the plan, as JAX does on one device
    solo = palgo.load_persistent_model(_ctx([torch.device("cpu")]), als_blob)
    assert solo.shards is None and solo.user_factors.device.type == "cpu"


@pytest.mark.parametrize("nums", [(5, 5), (10, 3), (37, 20)])
def test_als_sharded_batch_predict_matches_jax(als_blob, nums):
    jalgo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4))
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4))
    jmodel = jalgo.load_persistent_model(None, als_blob)
    pmodel = palgo.load_persistent_model(_ctx(), als_blob)
    queries = [(i, jax_rec.Query(user=f"u{i}", num=nums[i % 2])) for i in range(12)]
    queries.append((99, jax_rec.Query(user="missing", num=5)))
    pq = [(i, pt_rec.Query(user=q.user, num=q.num)) for i, q in queries]
    want = _answers(jalgo.batch_predict(jmodel, queries))
    got = _answers(palgo.batch_predict(pmodel, pq))
    _hold(got, want)
    shapes = pt_pl.LAST_KERNEL_SHAPES["als.sharded_topk"]
    assert shapes["rows_local"] < shapes["n_items"] and shapes["fused"] == 1
    assert shapes == jax_pl.LAST_KERNEL_SHAPES["als.sharded_topk"]
    # the tie across the 4|5 and 12|13 boundaries: the lower id first
    for items in ([x for x, _ in v] for v in got.values()):
        for lo, hi in (("i4", "i5"), ("i12", "i13")):
            if lo in items and hi in items:
                assert items.index(lo) + 1 == items.index(hi)


@pytest.mark.parametrize("n_slots", [2, 3])
def test_als_rebound_onto_fewer_slots_serves_identically(als_blob, n_slots):
    jalgo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4))
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4))
    jmodel = jalgo.load_persistent_model(None, als_blob)
    pmodel = palgo.load_persistent_model(_ctx([torch.device("cpu")] * n_slots), als_blob)
    assert pmodel.shards.mesh.shape == {"model": n_slots}
    rebound = palgo.load_persistent_model(_ctx(), als_blob)
    plan = pt_pl.ShardPlan.from_dict(als_blob["shard_plan"])
    rebound.shards = pt_pl.bind_shards(
        plan, {"user_factors": als_blob["user_factors"],
               "item_factors": als_blob["item_factors"]},
        devices=[torch.device("cpu")] * n_slots)
    queries = [(i, jax_rec.Query(user=f"u{i + 3}", num=7)) for i in range(5)]
    pq = [(i, pt_rec.Query(user=q.user, num=q.num)) for i, q in queries]
    want = _answers(jalgo.batch_predict(jmodel, queries))
    for model in (pmodel, rebound):
        _hold(_answers(palgo.batch_predict(model, pq)), want)
    assert pt_pl.LAST_KERNEL_SHAPES["als.sharded_topk"]["n_shards"] == n_slots


def test_als_solo_path_unchanged_and_dispatch_declines(als_blob):
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4))
    jalgo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4))
    sharded = palgo.load_persistent_model(_ctx(), als_blob)
    jmodel = jalgo.load_persistent_model(None, als_blob)
    for user in ("u0", "u7", "missing"):
        a = palgo.predict(sharded, pt_rec.Query(user=user, num=4))
        b = jalgo.predict(jmodel, jax_rec.Query(user=user, num=4))
        assert [(s.item, s.score) for s in a.item_scores] == [
            (s.item, s.score) for s in b.item_scores]
    iq = [(i, pt_rec.Query(user=f"u{i % 50}", num=5)) for i in range(600)]
    assert palgo.dispatch_batch(sharded, iq) is None
    assert palgo.dispatch_batch(sharded, iq, force=True) is None


@pytest.fixture(scope="module", params=["mlp", "gmf"])
def ncf_blob(request):
    """A JAX-persisted NCF model with a shard plan: parameters drawn by
    the JAX package's ``init_ncf`` and a seeded item bias."""
    layers = (16, 8) if request.param == "mlp" else ()
    nu, ni = 40, 30
    p = jax_ops_ncf.NCFParams(embed_dim=8, mlp_layers=layers)
    net = jax.tree_util.tree_map(
        np.asarray, jax_ops_ncf.init_ncf(jax.random.PRNGKey(3), nu, ni, p))
    net["item_bias"] = np.random.default_rng(3).normal(
        scale=0.1, size=ni).astype(np.float32)
    algo = jax_ncf.NCFAlgorithm(jax_ncf.NCFAlgorithmParams(
        embed_dim=8, mlp_layers=layers, shard_serving=True))
    model = jax_ncf.NCFModel(
        state=jax_ops_ncf.NCFState(params=net, n_users=nu, n_items=ni, config=p),
        user_vocab=JaxBiMap.from_keys(_vocab("u", nu)),
        item_vocab=JaxBiMap.from_keys(_vocab("i", ni)))
    blob = algo.make_persistent_model(None, model)
    return algo, blob, layers


def test_ncf_sharded_wave_matches_jax(ncf_blob):
    jalgo, blob, layers = ncf_blob
    palgo = pt_ncf.NCFAlgorithm(pt_ncf.NCFAlgorithmParams(
        embed_dim=8, mlp_layers=layers, shard_serving=True))
    jmodel = jalgo.load_persistent_model(None, blob)
    pmodel = palgo.load_persistent_model(_ctx(), blob)
    assert jmodel.shards is not None and pmodel.shards is not None
    assert palgo.make_persistent_model(None, pmodel)["shard_plan"] == blob["shard_plan"]
    queries = [(i, jax_rec.Query(user=f"u{i}", num=6)) for i in range(40)]
    queries.append((77, jax_rec.Query(user="missing", num=6)))
    pq = [(i, pt_rec.Query(user=q.user, num=q.num)) for i, q in queries]
    want = _answers(jalgo.batch_predict(jmodel, queries))
    got = _answers(palgo.batch_predict(pmodel, pq))
    assert set(got) == set(want)
    for i in want:
        assert [x for x, _ in got[i]] == [x for x, _ in want[i]], i
        np.testing.assert_allclose([s for _, s in got[i]], [s for _, s in want[i]],
                                   rtol=1e-5, atol=1e-6)
    shapes = pt_pl.LAST_KERNEL_SHAPES["ncf.sharded_topk"]
    assert shapes == jax_pl.LAST_KERNEL_SHAPES["ncf.sharded_topk"]
    assert shapes["n_shards"] == 8 and shapes["rows_local"] < shapes["n_items"]
    # solo answers stay on the host replica; dispatch declines sharded waves
    for user in ("u0", "u7", "missing"):
        a = palgo.predict(pmodel, pt_rec.Query(user=user, num=4))
        b = jalgo.predict(jmodel, jax_rec.Query(user=user, num=4))
        assert [s.item for s in a.item_scores] == [s.item for s in b.item_scores]
    assert palgo.dispatch_batch(pmodel, pq[:8]) is None
    # one slot serves unsharded
    assert palgo.load_persistent_model(
        _ctx([torch.device("cpu")]), blob).shards is None


# ---------------------------------------------------------------------------
# the settle clock, the straggler board and the bodies


def test_settle_shards_per_slot_fault_seam_and_host():
    plan = pt_pl.ShardPlan(axes={"model": -1}, specs={"t": ("model", None)})
    mesh = plan.mesh(CPU8)
    arr, _ = pt_pl.shard_put(mesh, plan, "t", np.arange(64.0).reshape(16, 4))
    t0 = time.perf_counter()
    settles = pt_pl.settle_shards(arr, t0)
    assert list(settles) == [f"cpu:{i}" for i in range(8)]
    assert all(s >= 0 for s in settles.values())
    assert pt_pl.settle_shards(np.zeros(4), t0) == {}
    assert pt_pl.settle_shards(torch.zeros(4), t0) == {}
    one = pt_pl.shard_put(plan.mesh([torch.device("cpu")]), plan, "t", np.ones((4, 2)))[0]
    assert pt_pl.settle_shards(one, t0) == {}
    pt_faults.install([{"seam": "shard.settle", "kind": "latency",
                        "latency_s": 0.25, "match": "cpu:3"}])
    try:
        deferred = pt_pl.settle_shards(arr, time.perf_counter())
    finally:
        pt_faults.clear()
    assert deferred["cpu:3"] >= 0.25
    assert all(v < 0.25 for k, v in deferred.items() if k != "cpu:3")
    # a wave's own result: one entry per slot, each its own work's seconds
    Q, V, k, _ = _topk_inputs("n37_k10")
    plan = pt_pl.ShardPlan.model_parallel(["V"], rows={"V": len(V)})
    bound = pt_pl.bind_shards(plan, {"V": V}, devices=CPU8)
    fn = pt_pl.build_sharded_topk(bound.mesh, lambda v, q: q @ v.T,
                                  n_items=len(V), k=k)
    t0 = time.perf_counter()
    res = fn(bound.arrays["V"], torch.from_numpy(Q))
    wave = pt_pl.settle_shards(res, t0)
    elapsed = time.perf_counter() - t0
    assert len(wave) == 8
    # the slots ran synchronously: every one reads as settled at the
    # clock's first poll, after all of them
    assert len(set(wave.values())) == 1
    assert 0 < wave["cpu:0"] <= elapsed


def _straggler_waves():
    rng = np.random.default_rng(5)
    waves = []
    for w in range(9):
        secs = {f"cpu:{i}": float(rng.uniform(0.01, 0.012)) for i in range(8)}
        if 2 <= w <= 5:
            secs["cpu:6"] = 0.05
        if w == 7:
            secs["cpu:1"] = 0.04
        waves.append(secs)
    waves.append({"cpu:0": 0.1})
    waves.append({"cpu:0": 0.0, "cpu:1": 0.0})
    return waves


def test_straggler_board_matches_jax():
    out = []
    for mod, reg in ((pt_device, MetricsRegistry()), (jax_device, JaxRegistry())):
        board = mod.StragglerBoard(registry=reg, skew_threshold=0.5, patience=3)
        skews = [board.record_wave("fn", secs, {k: 100.0 + i for i, k in enumerate(secs)})
                 for secs in _straggler_waves()]
        fam = reg.get("pio_shard_straggler_total")
        counts = {labels: child.value for labels, child in fam.series()}
        out.append((skews, board.snapshot(), counts,
                    reg.get("pio_shard_bytes_imbalance_frac").labels("fn").value))
        board.clear()
        assert board.snapshot()["functions"] == {}
    assert out[0] == out[1]
    assert out[0][2] == {("fn", "cpu:6"): 1.0}


def test_board_env_knobs_match_jax(monkeypatch):
    for value in ("0.25", "x"):
        monkeypatch.setenv("PIO_SHARD_SKEW_THRESHOLD", value)
        monkeypatch.setenv("PIO_SHARD_SKEW_PATIENCE", "0" if value == "x" else "5")
        got = pt_device.StragglerBoard(registry=MetricsRegistry())
        want = jax_device.StragglerBoard(registry=JaxRegistry())
        assert (got.skew_threshold, got.patience) == (want.skew_threshold, want.patience)


def _recorded_bodies(pkg_mesh, pkg_pl, pkg_device, reg, arrays_of):
    board = pkg_device.StragglerBoard(registry=reg)
    arrays = arrays_of()
    for w in range(4):
        secs = {f"cpu:{i}": 0.001 * (i + 1) + 0.0001 * w for i in range(8)}
        pkg_mesh.meter_shards("als.sharded_topk", arrays, seconds=secs, registry=reg)
        board.record_wave("als.sharded_topk", secs)
    pkg_mesh.meter_shards("als.serving_factors", arrays, registry=reg)
    pkg_mesh.meter_shards("train", arrays, seconds=0.5, registry=reg)
    return (pkg_device.shards_snapshot(reg, board),
            pkg_device.shard_snapshot(reg))


def test_shards_bodies_match_jax_on_fresh_registries():
    rng = np.random.default_rng(4)
    U = rng.normal(size=(21, 4)).astype(np.float32)
    V = rng.normal(size=(37, 4)).astype(np.float32)
    rows = {"rows": {"U": 21, "V": 37}}
    got = _recorded_bodies(
        pt_mesh, pt_pl, pt_device, MetricsRegistry(),
        lambda: pt_pl.bind_shards(pt_pl.ShardPlan.model_parallel(["U", "V"], **rows),
                                  {"U": U, "V": V}, devices=CPU8).arrays)
    want = _recorded_bodies(
        jax_mesh, jax_pl, jax_device, JaxRegistry(),
        lambda: jax_pl.bind_shards(jax_pl.ShardPlan.model_parallel(["U", "V"], **rows),
                                   {"U": U, "V": V}).arrays)
    assert got == want
    assert got[0]["shards"]["devices"] == [f"cpu:{i}" for i in range(8)]
    # /efficiency.json's shards key is the same snapshot of the process
    # registry
    assert pt_device.device_snapshot()["shards"] == pt_device.shard_snapshot(REGISTRY)


# ---------------------------------------------------------------------------
# :shardplan and the generation manifest


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    home = tmp_path_factory.mktemp("torch_sharding") / "pio_home"
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    app = jax_cmd.app_new(jax_storage, "shardapp").app
    rng = np.random.default_rng(6)
    jax_storage.l_events().insert_batch([
        JaxEvent(event="rate", entity_type="user", entity_id=f"u{rng.integers(0, 30)}",
                 target_entity_type="item", target_entity_id=f"i{rng.integers(0, 21)}",
                 properties=JaxDataMap({"rating": float(rng.integers(1, 6))}))
        for _ in range(300)
    ], app.id)
    port_storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    yield {"jax": jax_storage, "port": port_storage}
    port_storage.close()
    jax_storage.close()


ENGINE_JSON = {
    "datasource": {"name": "ratings", "params": {"appName": "shardapp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 2, "shardServing": True}}],
}


@pytest.fixture(scope="module")
def trained(homes):
    """The JAX and the port's instances trained with ``shardServing`` in
    the one home."""
    jengine = jax_resolve_engine_factory("recommendation")()
    jinst = jax_run_train(
        jengine, jengine.params_from_json(ENGINE_JSON),
        ctx=JaxEngineContext(storage=homes["jax"], mode="train"),
        engine_factory="recommendation", storage=homes["jax"])
    pengine = resolve_engine_factory("recommendation")()
    pinst = run_train(
        pengine, pengine.params_from_json(ENGINE_JSON),
        ctx=EngineContext(storage=homes["port"], device="cpu"),
        engine_factory="recommendation", storage=homes["port"])
    return jinst, pinst


def test_run_train_records_the_jax_shardplan_bytes(homes, trained):
    jinst, pinst = trained
    models = homes["port"].models()
    jbytes = models.get(f"{jinst.id}:shardplan")
    pbytes = models.get(f"{pinst.id}:shardplan")
    assert jbytes is not None and pbytes == jbytes
    plan = read_shard_plan(models, pinst.id)
    assert plan["axes"] == {"model": -1}
    gen = GenerationStore(models).record(pinst.id, status="staged")
    assert gen.shard_plan == plan
    assert pinst.mesh_conf == jinst.mesh_conf == {"axes": {"data": -1}}
    # the port's train records the same mesh_conf the JAX row holds
    rows = {i.id: i.mesh_conf for i in homes["port"].engine_instances().get_all()}
    assert rows[pinst.id] == rows[jinst.id]
    # a deploy onto 8 slots binds the recorded plan; the CPU default, one
    from predictionio_tpu_torch.server.prediction_server import deploy_engine

    sharded = deploy_engine("recommendation", storage=homes["port"],
                            engine_instance_id=pinst.id, device="cpu",
                            mesh_devices=CPU8)
    assert sharded.live_binding().models[0].shards.mesh.shape == {"model": 8}
    plain = deploy_engine("recommendation", storage=homes["port"],
                          engine_instance_id=pinst.id, device="cpu")
    assert plain.live_binding().models[0].shards is None


def test_status_url_reports_the_sharded_deploy_as_jax_does(homes, trained):
    """``status --url`` of a micro-batched deploy serving the recorded plan
    on 8 slots (the JAX package's on its 8 virtual devices), after one
    query each (a sharded wave of one): the
    same report keys, the same ``lifecycle`` (``shard_plan_axes`` among
    them), ``mesh_devices`` and per-slot bytes of the sharded top-k."""
    from predictionio_tpu.server import aio as jax_aio
    from predictionio_tpu.server import prediction_server as jax_server
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.server import aio as pt_aio
    from predictionio_tpu_torch.server import prediction_server as pt_server
    from predictionio_tpu_torch.tools import cli as pt_cli

    jinst, pinst = trained
    apps = {
        "jax": (jax_cli, jax_aio, jax_server.create_prediction_server_app(
            jax_server.deploy_engine("recommendation", storage=homes["jax"],
                                     engine_instance_id=jinst.id),
            use_microbatch=True, enable_alerts=False)),
        "port": (pt_cli, pt_aio, pt_server.create_prediction_server_app(
            pt_server.deploy_engine("recommendation", storage=homes["port"],
                                    engine_instance_id=pinst.id, device="cpu",
                                    mesh_devices=CPU8),
            use_microbatch=True, enable_alerts=False)),
    }
    reports = {}
    for name, (cli, aio, app) in apps.items():
        server = aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
            conn.request("POST", "/queries.json", body=json.dumps({"user": "u3", "num": 4}))
            assert conn.getresponse().status == 200
            conn.close()
            out = io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(["status", "--url", f"http://127.0.0.1:{server.port}",
                               "--no-quality"])
        finally:
            app.microbatcher.close()
            server.shutdown()
        reports[name] = (rc, json.loads(out.getvalue()))
    (jrc, jrep), (prc, prep) = reports["jax"], reports["port"]
    assert prc == jrc
    assert sorted(prep) == sorted(jrep)
    assert prep["lifecycle"] == jrep["lifecycle"]
    assert prep["lifecycle"]["shard_plan_axes"] == {"model": -1}
    assert sorted(prep["efficiency"]) == sorted(jrep["efficiency"])
    slots = [f"cpu:{i}" for i in range(8)]
    assert sorted(prep["efficiency"]["mesh_devices"]) == slots
    assert sorted(jrep["efficiency"]["mesh_devices"]) == slots

    def slot_bytes(rep):
        return {d: e["bytes"]
                for d, e in rep["efficiency"]["shards"]["als.sharded_topk"].items()}

    assert sorted(slot_bytes(prep)) == slots
    assert slot_bytes(prep) == slot_bytes(jrep)


# ---------------------------------------------------------------------------
# the micro-batched wave and its fragments


def test_wave_meta_carries_shards_and_fragments(als_blob):
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4))
    model = palgo.load_persistent_model(_ctx(), als_blob)
    jalgo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=4))
    jmodel = jalgo.load_persistent_model(None, als_blob)

    def batch_fn(items):
        by_idx = dict(palgo.batch_predict(model, list(enumerate(items))))
        return [by_idx[i] for i in range(len(items))]

    metas = [dict() for _ in range(16)]

    async def run():
        b = MicroBatcher(batch_fn, max_batch=16, registry=MetricsRegistry())
        try:
            return await asyncio.gather(*(
                b.submit(pt_rec.Query(user=f"u{i}", num=5), metas[i])
                for i in range(16)))
        finally:
            b.close()

    results = asyncio.run(run())
    # each answer is the JAX package's sharded answer to that user
    want = _answers(jalgo.batch_predict(
        jmodel, [(i, jax_rec.Query(user=f"u{i}", num=5)) for i in range(16)]))
    _hold(_answers(enumerate(results)), want)
    meta = next(m for m in metas if m.get("wave_shards"))
    assert len(meta["wave_shards"]) == 8
    assert all("bytes" in e for e in meta["wave_shards"].values())
    assert sorted(meta["wave_shard_seconds"]) == [f"cpu:{i}" for i in range(8)]
    assert meta["wave_fn"] == "als.sharded_topk"
    # one wave.shard fragment per slot, in both packages, from one meta
    wave = {
        "wave_t0": 5000.0, "wave_seq": 3, "wave_size": 16, "wave_device": "cpu:0",
        "device_breakdown": {"host_gather": 0.001, "h2d": 0.0002,
                             "compute": 0.003, "d2h": 0.0004, "other": 0.0},
        "wave_shard_seconds": {f"cpu:{i}": 0.001 * (i + 1) for i in range(8)},
    }
    outs = []
    for dt, lg in ((jax_disttrace, jax_logging), (pt_disttrace, pt_logging)):
        store = dt.FragmentStore()
        tokens = lg.set_request_context("r", "tr")
        try:
            dt.note_wave_events(wave, parent=SimpleNamespace(span_id="P"), store=store)
        finally:
            lg.reset_request_context(tokens)
        frags = sorted(
            ({k: v for k, v in f.items() if k not in ("span_id", "process")}
             for f in store.fragments("tr")),
            key=lambda f: (f["name"], f.get("track") or ""))
        outs.append(frags)
    assert outs[0] == outs[1]
    shards = [f for f in outs[1] if f["name"] == "wave.shard"]
    assert [f["track"] for f in shards] == [f"device:cpu:{i}" for i in range(8)]
    assert all(f["start_ts"] == 5000.0012 for f in shards)


# ---------------------------------------------------------------------------
# acceptance: a slowed slot trips the skew gauge and names the straggler on
# /shards.json; a balanced mesh stays quiet


@pytest.fixture()
def als_sharded(als_blob):
    pt_device.STRAGGLERS.clear()
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=4))
    yield palgo, palgo.load_persistent_model(_ctx(), als_blob)
    pt_device.STRAGGLERS.clear()
    pt_faults.clear()


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_slowed_slot_trips_skew_and_shards_json(als_sharded):
    algo, model = als_sharded
    straggler = "cpu:3"
    pt_faults.install([{"seam": "shard.settle", "kind": "latency",
                        "latency_s": 0.5, "match": straggler}])
    fam = REGISTRY.get("pio_shard_straggler_total")
    before = fam.labels("als.sharded_topk", straggler).value
    for wave in range(4):  # past the default patience of 3
        algo.batch_predict(
            model, [(i, pt_rec.Query(user=f"u{i + wave}", num=5)) for i in range(6)])
    skew = REGISTRY.get("pio_shard_skew_frac")
    assert skew.labels("als.sharded_topk").value > 0.5
    board = pt_device.STRAGGLERS.snapshot()["functions"]["als.sharded_topk"]
    assert board["straggler"] == straggler
    assert fam.labels("als.sharded_topk", straggler).value == before + 1
    server = AppServer(add_observability_routes(HTTPApp("shardstest")),
                       "127.0.0.1", 0).start_background()
    try:
        status, body = _get(server.port, "/shards.json")
    finally:
        server.shutdown()
    assert status == 200
    fn = body["stragglers"]["functions"]["als.sharded_topk"]
    assert fn["straggler"] == straggler and fn["last_max_device"] == straggler
    assert fn["devices"][straggler]["slowest"] >= 3
    assert len(body["shards"]["functions"]["als.sharded_topk"]) == 8


def test_balanced_mesh_stays_quiet(als_sharded):
    algo, model = als_sharded
    for wave in range(3):
        algo.batch_predict(
            model, [(i, pt_rec.Query(user=f"u{i}", num=5)) for i in range(4)])
    board = pt_device.STRAGGLERS.snapshot()["functions"].get("als.sharded_topk")
    assert board is None or board["straggler"] is None
