"""The port's ALS training over a mesh against the JAX package, on the CPU.

``train_als(mesh=)`` on eight CPU slots (``[torch.device("cpu")] * 8``)
against the JAX ``train_als(mesh=)`` on its eight virtual CPU devices
(``tests/conftest.py``), both from one ``init_factors`` drawn with numpy
(jax PRNG bits cannot be drawn in torch), on ``tests/test_als_ops.py``'s
fixture and at its tolerance (factors within 2e-3):

- explicit and implicit over ``{"data": 8}`` and ``{"data": 4, "model":
  2}``, a warm start, unpadded shapes, the chunked rung against the fused
  one (1e-5), the mesh train against the one-slot train (2e-3) and against
  itself (bit for bit);
- ``pio_shard_bytes{fn="als.factors"}``: 8 equal shares (JAX
  ``tests/test_sharding.py:246``);
- the ``PIO_TRAIN_STEP_TIMELINE`` fragments: names, tracks and tags equal
  to the JAX package's, none without the opt-in;
- ``make_hybrid_mesh`` collapsing in one process, its errors the JAX
  package's; ``global_data_array`` slot for slot the JAX global array's
  shards, ``global_replicated_array``; the backend rule;
  ``EngineContext.mesh``;
- ``pio train`` of an engine.json carrying ``"mesh"`` through both CLIs
  into one home: both instances record that mesh in ``mesh_conf``;
- the recommendation, similarproduct and ecommerce engines trained on an
  8-slot context against the JAX engines on 8 virtual devices (2e-3).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel import mesh as jax_mesh
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

torch.set_num_threads(2)

ATOL = 2e-3
CPU8 = [torch.device("cpu")] * 8
EXPLICIT = dict(rank=5, num_iterations=15, reg=0.01, scale_reg_with_count=False)
IMPLICIT = dict(rank=5, num_iterations=5, reg=0.01, implicit_prefs=True,
                alpha=40.0, scale_reg_with_count=False)
AXES = {"data8": {"data": 8}, "data4-model2": {"data": 4, "model": 2}}


@pytest.fixture(scope="module")
def ratings():
    """``tests/test_als_ops.py``'s fixture: 200 x 100, 5,000 exact-rank-5
    ratings."""
    rng = np.random.default_rng(0)
    nu, ni, k = 200, 100, 5
    U = np.abs(rng.normal(size=(nu, k)))
    V = np.abs(rng.normal(size=(ni, k)))
    n = 5000
    ui = rng.integers(0, nu, n).astype(np.int32)
    ii = rng.integers(0, ni, n).astype(np.int32)
    r = (U[ui] * V[ii]).sum(1).astype(np.float32)
    return nu, ni, ui, ii, r


def seeded_init(nu: int, ni: int, rank: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return tuple(
        (np.abs(rng.standard_normal((n, rank))) / np.sqrt(rank)).astype(np.float32)
        for n in (nu, ni)
    )


def port_mesh(axes: dict):
    return make_mesh(MeshConfig(dict(axes)), devices=CPU8)


def both(ratings, kw: dict, axes: dict, init=None):
    """(port mesh train, JAX mesh train) from one start."""
    nu, ni, ui, ii, r = ratings
    init = init or seeded_init(nu, ni, kw["rank"])
    got = als.train_als(ui, ii, r, nu, ni, als.ALSParams(**kw),
                        mesh=port_mesh(axes), init_factors=init)
    want = jax_als.train_als(
        ui, ii, r, nu, ni, jax_als.ALSParams(chunk_size=1024, **kw),
        mesh=jax_mesh.make_mesh(jax_mesh.MeshConfig(dict(axes))),
        init_factors=init,
    )
    return got, want


def assert_factors_close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.user_factors.numpy(),
                               np.asarray(want.user_factors), atol=atol)
    np.testing.assert_allclose(got.item_factors.numpy(),
                               np.asarray(want.item_factors), atol=atol)


@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("kind", ["explicit", "implicit"])
def test_mesh_train_matches_the_jax_mesh_train(ratings, kind, axes):
    kw = EXPLICIT if kind == "explicit" else IMPLICIT
    got, want = both(ratings, kw, AXES[axes])
    assert_factors_close(got, want)
    info = als.LAST_PLAN_INFO
    assert info["data_slots"] == AXES[axes]["data"]
    assert info["mesh"] == AXES[axes]
    assert info["collective_backend"] == "in-process"
    assert info["mode"] == "fused"


def test_warm_start_on_a_mesh(ratings):
    """A warm start from a short train's factors, on both meshes alike."""
    nu, ni, ui, ii, r = ratings
    short = als.train_als(ui, ii, r, nu, ni,
                          als.ALSParams(**{**EXPLICIT, "num_iterations": 3}),
                          device="cpu", init_factors=seeded_init(nu, ni, 5))
    init = (short.user_factors.numpy(), short.item_factors.numpy())
    got, want = both(ratings, {**EXPLICIT, "num_iterations": 5}, {"data": 8},
                     init=init)
    assert_factors_close(got, want)
    cold, _ = both(ratings, {**EXPLICIT, "num_iterations": 5}, {"data": 8})
    assert not torch.allclose(got.user_factors, cold.user_factors, atol=ATOL)


def test_mesh_train_equals_the_one_slot_train_and_repeats(ratings):
    nu, ni, ui, ii, r = ratings
    p = als.ALSParams(**EXPLICIT)
    init = seeded_init(nu, ni, 5)
    one = als.train_als(ui, ii, r, nu, ni, p, device="cpu", init_factors=init)
    a = als.train_als(ui, ii, r, nu, ni, p, mesh=port_mesh({"data": 8}),
                      init_factors=init)
    b = als.train_als(ui, ii, r, nu, ni, p, mesh=port_mesh({"data": 8}),
                      init_factors=init)
    assert_factors_close(a, one)
    assert torch.equal(a.user_factors, b.user_factors)
    assert torch.equal(a.item_factors, b.item_factors)
    # a mesh of one slot takes the single-device path unchanged
    single = als.train_als(ui, ii, r, nu, ni, p, device="cpu", init_factors=init,
                           mesh=make_mesh(MeshConfig(), devices=["cpu"]))
    assert torch.equal(single.user_factors, one.user_factors)


@pytest.mark.parametrize("nu,ni", [(37, 11), (129, 300)])
def test_factor_shapes_unpadded(nu, ni):
    rng = np.random.default_rng(nu)
    ui = rng.integers(0, nu, 900).astype(np.int32)
    ii = rng.integers(0, ni, 900).astype(np.int32)
    r = rng.uniform(1, 5, 900).astype(np.float32)
    p = als.ALSParams(rank=3, num_iterations=2)
    st = als.train_als(ui, ii, r, nu, ni, p, mesh=port_mesh({"data": 8}))
    assert tuple(st.user_factors.shape) == (nu, 3)
    assert tuple(st.item_factors.shape) == (ni, 3)
    want = jax_als.train_als(ui, ii, r, nu, ni,
                             jax_als.ALSParams(rank=3, num_iterations=2,
                                               chunk_size=256),
                             mesh=jax_mesh.default_mesh())
    assert np.asarray(want.user_factors).shape == tuple(st.user_factors.shape)


def test_chunked_rung_over_the_mesh_equals_the_fused_one(ratings):
    nu, ni, ui, ii, r = ratings
    p = als.ALSParams(**EXPLICIT)
    init = seeded_init(nu, ni, 5)
    fused = als.train_als(ui, ii, r, nu, ni, p, mesh=port_mesh({"data": 8}),
                          init_factors=init)
    chunked = als.train_als(ui, ii, r, nu, ni,
                            dataclasses.replace(p, pallas_mode="chunked"),
                            mesh=port_mesh({"data": 8}), init_factors=init)
    assert als.LAST_PLAN_INFO["mode"] == "chunked"
    assert als.LAST_PLAN_INFO["chunks_user"] == 8
    np.testing.assert_allclose(chunked.user_factors.numpy(),
                               fused.user_factors.numpy(), atol=1e-5)
    np.testing.assert_allclose(chunked.item_factors.numpy(),
                               fused.item_factors.numpy(), atol=1e-5)


def test_factor_state_is_metered_in_eight_equal_shares():
    from predictionio_tpu_torch.obs.device import default_efficiency
    from predictionio_tpu_torch.obs.metrics import REGISTRY

    rng = np.random.default_rng(0)
    ui = rng.integers(0, 64, 2000).astype(np.int32)
    ii = rng.integers(0, 48, 2000).astype(np.int32)
    r = rng.uniform(1, 5, 2000).astype(np.float32)
    als.train_als(ui, ii, r, 64, 48, als.ALSParams(rank=4, num_iterations=2),
                  mesh=port_mesh({"data": 8}))
    fam = REGISTRY.get("pio_shard_bytes")
    per_slot = {labels[1]: child.value for labels, child in fam.series()
                if labels[0] == "als.factors"}
    assert sorted(per_slot) == [f"cpu:{i}" for i in range(8)]
    assert len(set(per_slot.values())) == 1
    # 128 padded rows a table over 8 slots, rank 4, float32
    assert per_slot["cpu:0"] == 2 * (128 // 8) * 4 * 4
    assert "als.train_step" in default_efficiency().snapshot()["functions"]


def _fragments(store, trace):
    return sorted(
        ((f["name"], f["track"], f["tags"]) for f in store.fragments(trace)
         if f["name"].startswith("als.train_step")),
        key=lambda x: x[2]["iteration"],
    )


@pytest.mark.parametrize("opt_in", [True, False], ids=["opt-in", "no-opt-in"])
def test_step_fragments_equal_the_jax_package(monkeypatch, opt_in):
    from predictionio_tpu.obs import disttrace as jax_dt
    from predictionio_tpu.obs import logging as jax_log
    from predictionio_tpu_torch.obs import disttrace as pt_dt
    from predictionio_tpu_torch.obs import logging as pt_log

    if opt_in:
        monkeypatch.setenv("PIO_TRAIN_STEP_TIMELINE", "1")
    else:
        monkeypatch.delenv("PIO_TRAIN_STEP_TIMELINE", raising=False)
    rng = np.random.default_rng(3)
    ui = rng.integers(0, 20, 300).astype(np.int32)
    ii = rng.integers(0, 15, 300).astype(np.int32)
    r = rng.uniform(1, 5, 300).astype(np.float32)
    got = {}
    for name, log, dt, train in (
        ("port", pt_log, pt_dt,
         lambda: als.train_als(ui, ii, r, 20, 15,
                               als.ALSParams(rank=3, num_iterations=4),
                               mesh=port_mesh({"data": 8}))),
        ("jax", jax_log, jax_dt,
         lambda: jax_als.train_als(ui, ii, r, 20, 15,
                                   jax_als.ALSParams(rank=3, num_iterations=4,
                                                     chunk_size=256),
                                   mesh=jax_mesh.default_mesh())),
    ):
        dt.FRAGMENTS.clear()
        tokens = log.set_request_context("rid-mesh", "trace-mesh")
        try:
            train()
        finally:
            log.reset_request_context(tokens)
        got[name] = _fragments(dt.FRAGMENTS, "trace-mesh")
    assert got["port"] == got["jax"]
    if opt_in:
        assert [f[0] for f in got["port"]] == [f"als.train_step[{i}]" for i in range(4)]
        assert {f[1] for f in got["port"]} == {"train:8dev"}
        assert got["port"][0][2] == {"iteration": 0, "devices": 8}
    else:
        assert got["port"] == []


def test_hybrid_mesh_collapses_in_one_process_with_the_jax_errors():
    from predictionio_tpu_torch.parallel.mesh import make_hybrid_mesh

    m = make_hybrid_mesh({"data": 4, "model": 2}, {"data": 1, "model": 1},
                         devices=CPU8)
    jm = jax_mesh.make_hybrid_mesh({"data": 4, "model": 2}, {"data": 1, "model": 1})
    assert m.shape == dict(jm.shape) == {"data": 4, "model": 2}
    assert m.labels == [f"cpu:{i}" for i in range(8)]
    default = make_hybrid_mesh(devices=CPU8)
    assert default.shape == dict(jax_mesh.make_hybrid_mesh().shape)
    for ici, dcn in (({"data": 8}, {"model": 1}),
                     ({"data": 4, "model": 2}, {"model": 1, "data": 1})):
        with pytest.raises(ValueError) as want:
            jax_mesh.make_hybrid_mesh(ici, dcn)
        with pytest.raises(ValueError) as got:
            make_hybrid_mesh(ici, dcn, devices=CPU8)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_hybrid_mesh({"data": 16, "model": 1}, {"data": 1, "model": 1})
    with pytest.raises(ValueError) as got:
        make_hybrid_mesh({"data": 16, "model": 1}, {"data": 1, "model": 1},
                         devices=CPU8)
    assert str(got.value) == str(want.value)


def test_engine_context_mesh_is_built_once_from_its_config():
    from predictionio_tpu_torch.core.base import EngineContext

    ctx = EngineContext(device="cpu", mesh_config=MeshConfig({"data": 4, "model": 2}),
                        mesh_devices=CPU8)
    assert ctx.mesh is ctx.mesh
    assert ctx.mesh.shape == {"data": 4, "model": 2}
    assert ctx.mesh.devices.size == 8
    one = EngineContext(device="cpu")
    assert one.mesh.devices.size == 1 and one.mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="needs 2 devices"):
        EngineContext(device="cpu", mesh_config=MeshConfig({"data": 2})).mesh


# -- the engines ------------------------------------------------------------


def test_train_records_the_variants_mesh_in_both_clis(tmp_path, capsys):
    """``pio train`` of an engine.json carrying ``"mesh"``: the JAX CLI
    records it as the instance's ``mesh_conf``, and so must the port's."""
    from predictionio_tpu.data.storage.config import StorageConfig as JaxConfig
    from predictionio_tpu.data.storage.config import reset_storage as jax_reset
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        reset_storage,
    )
    from predictionio_tpu_torch.tools import cli as pt_cli

    rng = np.random.default_rng(9)
    with open(tmp_path / "events.jsonl", "w") as f:
        for _ in range(300):
            f.write(json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": f"u{rng.integers(20)}", "targetEntityType": "item",
                "targetEntityId": f"i{rng.integers(12)}",
                "properties": {"rating": int(rng.integers(1, 6))},
            }) + "\n")
    mesh = {"axes": {"data": 1, "model": 1}}
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "meshy", "engineFactory": "recommendation", "mesh": mesh,
        "datasource": {"params": {"appName": "shop"}},
        "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 2}}],
    }))
    env = {"PIO_HOME": str(tmp_path / "home")}
    jax_storage = jax_reset(JaxConfig.from_env(env))
    try:
        assert jax_cli.main(["app", "new", "shop"]) == 0
        assert jax_cli.main(["import", "--app", "shop", "--input",
                             str(tmp_path / "events.jsonl")]) == 0
        assert jax_cli.main(["train", "--engine-json",
                             str(tmp_path / "engine.json")]) == 0
    finally:
        jax_storage.close()
    storage = reset_storage(StorageConfig.from_env(env))
    try:
        capsys.readouterr()
        assert pt_cli.main(["train", "--engine-json", str(tmp_path / "engine.json"),
                            "--device", "cpu"]) == 0
        port_id = capsys.readouterr().out.split("Engine instance: ")[1].split()[0]
        instances = [x for x in storage.engine_instances().get_all()
                     if x.engine_id == "meshy"]
    finally:
        storage.close()
    assert len(instances) == 2 and port_id in {x.id for x in instances}
    assert all(x.status == "COMPLETED" for x in instances)
    assert [x.mesh_conf for x in instances] == [mesh, mesh]


def _set(etype, eid, props=None):
    from predictionio_tpu.data.datamap import DataMap
    from predictionio_tpu.data.event import Event

    return Event(event="$set", entity_type=etype, entity_id=eid,
                 properties=DataMap(props or {}))


def _act(event, user, item, props=None):
    from predictionio_tpu.data.datamap import DataMap
    from predictionio_tpu.data.event import Event

    return Event(event=event, entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 properties=DataMap(props or {}))


def _events(factory: str) -> list:
    rng = np.random.default_rng(4)
    if factory == "recommendation":
        return [_act("rate", f"u{u}", f"i{i}", {"rating": float(rng.integers(1, 6))})
                for u in range(24) for i in rng.choice(16, 6, replace=False)]
    ev = [_set("user", f"u{u}") for u in range(16)]
    ev += [_set("item", f"i{i}", {"categories": ["a" if i < 6 else "b"]})
           for i in range(12)]
    for u in range(16):
        base = 0 if u < 8 else 6
        ev += [_act("view", f"u{u}", f"i{base + i}") for i in rng.choice(6, 4, replace=False)]
    ev += [_act("buy", f"u{u}", "i0") for u in range(6)]
    return ev


ENGINES = {
    "recommendation": ("als", {"rank": 4, "numIterations": 6}, "user_factors"),
    "similarproduct": ("als", {"rank": 4, "numIterations": 6}, "item_factors"),
    "ecommerce": ("ecomm", {"appName": "shop", "rank": 4, "numIterations": 6},
                  "user_factors"),
}


def _seeded(monkeypatch, mod):
    real = mod.train_als

    def wrapped(u, i, r, num_users, num_items, params, **kw):
        kw.pop("init_factors", None)
        return real(u, i, r, num_users=num_users, num_items=num_items,
                    params=params, init_factors=seeded_init(num_users, num_items,
                                                            params.rank, 11),
                    **kw)

    monkeypatch.setattr(mod, "train_als", wrapped)


@pytest.mark.parametrize("factory", sorted(ENGINES))
def test_engines_train_on_eight_slots_as_the_jax_engines_on_eight_devices(
        tmp_path, monkeypatch, factory):
    import importlib

    from predictionio_tpu.core.base import EngineContext as JaxContext
    from predictionio_tpu.data.storage.config import StorageConfig as JaxConfig
    from predictionio_tpu.data.storage.config import reset_storage as jax_reset
    from predictionio_tpu.tools import commands as jax_cmd
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )

    jmod = importlib.import_module(f"predictionio_tpu.models.{factory}.engine")
    pmod = importlib.import_module(f"predictionio_tpu_torch.models.{factory}.engine")
    _seeded(monkeypatch, jmod)
    _seeded(monkeypatch, pmod)
    env = {"PIO_HOME": str(tmp_path / "home")}
    jax_storage = jax_reset(JaxConfig.from_env(env))
    storage = StorageRuntime(StorageConfig.from_env(env))
    try:
        app_id = jax_cmd.app_new(jax_storage, "shop").app.id
        jax_storage.l_events().insert_batch(_events(factory), app_id)
        algo, algo_params, table = ENGINES[factory]
        variant = {"datasource": {"params": {"appName": "shop"}},
                   "algorithms": [{"name": algo, "params": algo_params}]}
        jeng = getattr(jmod, f"{factory}_engine")()
        jctx = JaxContext(storage=jax_storage)
        assert jctx.mesh.devices.size == 8
        want = jeng.train(jctx, jeng.params_from_json(variant))[0]
        peng = getattr(pmod, f"{factory}_engine")()
        ctx = EngineContext(storage=storage, device="cpu", mesh_devices=CPU8)
        assert ctx.mesh.shape == {"data": 8}
        got = peng.train(ctx, peng.params_from_json(variant))[0]
        assert als.LAST_PLAN_INFO["data_slots"] == 8
    finally:
        storage.close()
        jax_storage.close()
    for name in ("user_factors", "item_factors"):
        if not hasattr(want, name):
            continue
        np.testing.assert_allclose(torch.as_tensor(getattr(got, name)).numpy(),
                                   np.asarray(getattr(want, name)), atol=ATOL,
                                   err_msg=name)
    assert getattr(got, table) is not None


def test_backend_rule():
    from predictionio_tpu_torch.parallel.mesh import choose_backend

    card = lambda uuid: {"type": "cuda", "uuid": uuid}  # noqa: E731
    assert choose_backend([card("a"), card("b")]) == "nccl"
    # two ranks on one card: NCCL refuses that, so gloo
    assert choose_backend([card("a"), card("a")]) == "gloo"
    assert choose_backend([{"type": "cpu", "uuid": ""}] * 2) == "gloo"
    assert choose_backend([card("a"), {"type": "cpu", "uuid": ""}]) == "gloo"


@pytest.mark.parametrize("axes", sorted(AXES))
def test_global_arrays_in_one_process_equal_the_jax_shards(axes):
    """``global_data_array`` gives each slot the rows the JAX package's
    global array gives the same device; ``global_replicated_array`` the
    whole value everywhere."""
    from predictionio_tpu_torch.parallel.mesh import (
        global_data_array,
        global_replicated_array,
    )

    local = np.arange(64, dtype=np.int32) * 3
    mesh = port_mesh(AXES[axes])
    jm = jax_mesh.make_mesh(jax_mesh.MeshConfig(dict(AXES[axes])))
    got = global_data_array(mesh, local)
    want = jax_mesh.global_data_array(jm, local)
    assert got.shape == tuple(want.shape) == (64,)
    shards = {f"{s.device.platform}:{s.device.id}": np.asarray(s.data)
              for s in want.addressable_shards}
    for label, part in got.slot_shards():
        np.testing.assert_array_equal(part.numpy(), shards[label])
    value = np.ones((3, 2), np.float32)
    rep = global_replicated_array(mesh, value)
    assert len(rep.slot_shards()) == 8 and rep.axis is None
    assert all(np.array_equal(t.numpy(), value) for _, t in rep.slot_shards())
