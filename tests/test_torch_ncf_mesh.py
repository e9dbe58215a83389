"""The port's NCF training over a mesh against the JAX package, on the CPU.

``train_ncf(mesh=)`` and its epoch (``ops.ncf.MeshNCF``) on CPU slots
(``[torch.device("cpu")] * n``) against the JAX package's GSPMD epoch on
its virtual CPU devices (``tests/conftest.py``), on vocabularies of 40 x 30
and 41 x 31 (padded to 42 x 32 by a ``model`` axis of 2) with
``embed_dim`` 8:

- three epochs on ``{data: 2, model: 2}`` from one JAX-drawn tree at the
  padded shape (carried by ``params_from_jax``), fed the JAX epoch's own
  permutation and negatives: every leaf within atol 1e-5 (``out_b`` under
  the sampled softmax within 2 x steps x lr, as ``tests/test_torch_ncf.py``
  holds it: its exact gradient is 0, and Adam scales the rounding);
- the mesh epoch against the one-slot epoch from one tree and one seed,
  the same draws (``{data: 2, model: 2}`` and ``{data: 4}``), within 1e-5,
  every copy of a leaf and of its Adam moments equal bit for bit;
  ``train_ncf(mesh=)`` against ``train_ncf(device="cpu")`` where no
  padding changes the init; a one-slot mesh takes the one-device path;
- the placement (JAX ``tests/test_sharding.py:275``): on ``{data: 2,
  model: 4}`` each slot holds a quarter of the tables and twice that of
  their Adam moments, the MLP whole, slot for slot the JAX package's bytes;
- learning (JAX ``tests/test_ncf.py:125`` and ``:536``) on the port's own
  draws: the loss falls, the scores are finite, the clusters are learnt;
- the ``ncf`` engine with an engine.json ``"mesh"`` of ``{data: 2, model:
  2}``: ``mesh_conf`` as the JAX CLI records it, the mesh passed to the ALS
  pretrain, the persisted leaf shapes the JAX package's (which loads the
  blob), and no answer naming a padded item.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from predictionio_tpu.ops import ncf as jncf
from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu_torch.ops import ncf as pncf
from predictionio_tpu_torch.parallel.mesh import (
    MeshConfig,
    make_mesh,
    shard_attribution,
)

torch.set_num_threads(2)

ATOL = 1e-5
CPU = torch.device("cpu")
HEADS = {"mlp_bias": ((16, 8), True), "mlp_nobias": ((16, 8), False),
         "gmf_bias": ((), True)}


def port_mesh(axes: dict):
    return make_mesh(MeshConfig(dict(axes)), devices=[CPU] * int(np.prod(list(axes.values()))))


def padded(n: int, m: int) -> int:
    return -(-n // m) * m


def carried(mlp, bias, n_users, n_items, seed=0):
    """One JAX-drawn tree at the given (padded) shape, with a random item
    bias and ``out_b``: (numpy tree, port tree on the CPU)."""
    p = jncf.NCFParams(embed_dim=8, mlp_layers=mlp, item_bias=bias)
    tree = jax.tree.map(np.asarray, jncf.init_ncf(jax.random.PRNGKey(seed),
                                                  n_users, n_items, p))
    rng = np.random.default_rng(seed)
    if bias:
        tree["item_bias"] = rng.standard_normal(n_items).astype(np.float32)
    tree["out_b"] = rng.standard_normal(1).astype(np.float32)
    return tree, pncf.params_from_jax(tree, "cpu")


def close_tree(got: dict, want: dict, loss: str, steps: int, lr: float):
    """Every leaf within ATOL; ``out_b`` under the sampled softmax within
    2 x steps x lr (see the module docstring)."""
    got = jax.tree.map(np.asarray, got)
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for name in got:
        tol = 2 * steps * lr if loss == "softmax" and name == "out_b" else ATOL
        for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def assert_copies_equal(st: pncf.MeshNCF):
    """Every slot at one model position holds the same bits, in its leaves
    and in its Adam state."""
    by_m: dict = {}
    for slot in st.mesh.local_slots:
        by_m.setdefault(st.layout.m_of[slot], []).append(slot)
    for slots in by_m.values():
        first = st.trees[slots[0]]
        for other in slots[1:]:
            for a, b in zip(pncf.tree_leaves(first), pncf.tree_leaves(st.trees[other])):
                assert torch.equal(a, b)
                sa = st.optimizers[slots[0]].state[a]
                sb = st.optimizers[other].state[b]
                for key in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(sa[key], sb[key])
    # the replicated leaves are equal across model positions too
    slots = st.mesh.local_slots
    for j, name in enumerate(st.names):
        if name not in pncf.TABLES:
            leaves = [pncf.tree_leaves(st.trees[s])[j] for s in slots]
            assert all(torch.equal(leaves[0], x) for x in leaves[1:]), name


def cluster_interactions(rng, n_users=40, n_items=30, per_user=6):
    """Two taste clusters (``tests/test_ncf.py``'s data): even users like
    the low half of the catalog, odd users the high half."""
    users, items = [], []
    for u in range(n_users):
        lo, hi = (0, n_items // 2) if u % 2 == 0 else (n_items // 2, n_items)
        for i in rng.choice(np.arange(lo, hi), per_user, replace=False):
            users.append(u)
            items.append(int(i))
    return np.array(users), np.array(items)


# -- epochs on the JAX package's draws ---------------------------------------

JAX_CASES = {
    # id: (loss, head, negatives, weight decay, vocabulary)
    "bpr": ("bpr", "mlp_bias", 1, 0.0, (41, 31)),
    "bpr_unpadded": ("bpr", "mlp_bias", 1, 0.0, (40, 30)),
    "softmax": ("softmax", "mlp_nobias", 3, 0.0, (41, 31)),
    "full_softmax": ("full_softmax", "gmf_bias", 1, 0.0, (41, 31)),
    "wals": ("wals", "gmf_bias", 1, 0.0, (41, 31)),
    "full_softmax_adamw": ("full_softmax", "gmf_bias", 1, 0.01, (40, 30)),
    "bpr_adamw": ("bpr", "mlp_bias", 1, 0.01, (41, 31)),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_mesh_epochs_on_jax_draws_match_the_jax_mesh_epochs(case):
    """Three epochs of four steps (a padded last step) on ``{data: 2,
    model: 2}``: the JAX package's epoch with its tables and Adam state
    placed by ``param_shardings`` and the stream sharded over ``data``,
    and the port's mesh epoch fed the same permutation and negatives."""
    loss, head, k, wd, (n_users, n_items) = JAX_CASES[case]
    mlp, bias = HEADS[head]
    axes = {"data": 2, "model": 2}
    nu_pad, ni_pad = padded(n_users, 2), padded(n_items, 2)
    rng = np.random.default_rng(4)
    n_pos, bs, n_steps = 58, 16, 4
    users = rng.integers(0, n_users, n_pos).astype(np.int32)
    items = rng.integers(0, n_items, n_pos).astype(np.int32)
    p = pncf.NCFParams(embed_dim=8, mlp_layers=mlp, item_bias=bias, loss=loss,
                       batch_size=bs, learning_rate=1e-2, weight_decay=wd,
                       negatives_per_positive=k, neg_power=0.75)
    tree, port_tree = carried(mlp, bias, nu_pad, ni_pad)
    # the JAX package's mesh epoch, as its train_ncf places and runs it
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dict(axes)))
    jp = jax.device_put(jax.tree.map(jnp.asarray, tree),
                        jncf.param_shardings(mesh, tree))
    opt, epoch = jncf._get_epoch_fn(n_steps, bs, n_items, p.learning_rate, mesh,
                                    loss=loss, k_neg=k, weight_decay=wd,
                                    alpha=p.alpha)
    state = opt.init(jp)
    stream = pncf.stage_stream(users, items, p, CPU, multiple=2)
    assert (stream.n_steps, stream.batch) == (n_steps, bs)
    data = NamedSharding(mesh, PartitionSpec("data"))
    arrays = [jax.device_put(np.asarray(x.numpy(), np.int32 if x.dtype == torch.int64
                                        else np.float32), data)
              for x in (stream.u, stream.i, stream.valid, stream.w)]
    cdf = pncf.negative_sampling_cdf(items, n_items, p.neg_power)
    st = pncf.MeshNCF(port_mesh(axes), port_tree, p)
    key = jax.random.PRNGKey(p.seed)
    for _ in range(3):
        key, ek = jax.random.split(key)
        kperm, kneg = jax.random.split(ek)
        perm = np.asarray(jax.random.permutation(kperm, n_steps * bs))
        step_keys = jax.random.split(kneg, n_steps)

        def negatives(s, step_keys=step_keys):
            draw = jax.random.uniform(step_keys[s], (bs, k))
            neg = jnp.minimum(jnp.searchsorted(jnp.asarray(cdf), draw), n_items - 1)
            return torch.from_numpy(np.asarray(neg).astype(np.int64))

        jp, state, want_loss = epoch(jp, state, *arrays, jnp.asarray(cdf), ek)
        got_loss = st.train_epoch(stream, n_items,
                                  perm=torch.from_numpy(perm.astype(np.int64)),
                                  negatives=negatives)
        np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)
    assert not jp["user_emb"].sharding.is_fully_replicated
    got = pncf.host_params(st.gathered())
    assert got["user_emb"].shape[0] == nu_pad and got["item_emb"].shape[0] == ni_pad
    close_tree(got, jp, loss, 3 * n_steps, p.learning_rate)
    assert_copies_equal(st)


# -- the mesh against one slot -----------------------------------------------

ONE_SLOT_CASES = {
    "bpr": ("bpr", "mlp_bias", 1, 0.0),
    "softmax": ("softmax", "mlp_nobias", 3, 0.0),
    "full_softmax": ("full_softmax", "gmf_bias", 1, 0.01),
    "wals": ("wals", "gmf_bias", 1, 0.0),
}
MESHES = {"data2-model2": {"data": 2, "model": 2}, "data4": {"data": 4}}


@pytest.mark.parametrize("axes", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(ONE_SLOT_CASES))
def test_mesh_epochs_match_the_one_slot_epochs(case, axes):
    """The 41 x 31 vocabulary, padded for the model axis (the one-slot
    epoch trains the same padded tree): three epochs, one seed, the same
    permutation and negatives from one generator each."""
    loss, head, k, wd = ONE_SLOT_CASES[case]
    mlp, bias = HEADS[head]
    axes = MESHES[axes]
    m = axes.get("model", 1)
    n_users, n_items = 41, 31
    rng = np.random.default_rng(7)
    users = rng.integers(0, n_users, 150)
    items = rng.integers(0, n_items, 150)
    p = pncf.NCFParams(embed_dim=8, mlp_layers=mlp, item_bias=bias, loss=loss,
                       batch_size=32, learning_rate=1e-2, weight_decay=wd,
                       negatives_per_positive=k)
    _, tree = carried(mlp, bias, padded(n_users, m), padded(n_items, m), seed=1)
    one = pncf.tree_map(lambda x: x.clone().requires_grad_(True), tree)
    opt = pncf.make_optimizer(one, p)
    st = pncf.MeshNCF(port_mesh(axes), tree, p)
    stream = pncf.stage_stream(users, items, p, CPU, multiple=axes["data"])
    cdf = torch.from_numpy(pncf.negative_sampling_cdf(items, n_items, p.neg_power))
    g_one, g_mesh = (torch.Generator().manual_seed(p.seed) for _ in range(2))
    steps = 0
    for _ in range(3):
        want = pncf.train_epoch(one, opt, stream, p, n_items, g_one, cdf)
        got = st.train_epoch(stream, n_items, g_mesh, cdf)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        steps += stream.n_steps
    close_tree(pncf.host_params(st.gathered()), pncf.host_params(one), loss,
               steps, p.learning_rate)
    assert_copies_equal(st)


@pytest.mark.parametrize("loss", ["bpr", "wals"])
def test_train_ncf_on_a_mesh_matches_train_ncf_on_one_device(loss):
    """Where the model axis pads nothing (40 x 30 over 2), the mesh init is
    the one-device init, so the two ``train_ncf`` calls agree end to end;
    a mesh of one slot takes the one-device path bit for bit."""
    rng = np.random.default_rng(0)
    users, items = cluster_interactions(rng)
    p = pncf.NCFParams(embed_dim=8, mlp_layers=() if loss == "wals" else (16, 8),
                       loss=loss, num_epochs=4, batch_size=64, learning_rate=5e-3)
    one = pncf.train_ncf(users, items, 40, 30, p, device="cpu")
    got = pncf.train_ncf(users, items, 40, 30, p,
                         mesh=port_mesh({"data": 2, "model": 2}))
    close_tree(pncf.host_params(got.params), pncf.host_params(one.params), loss,
               4 * 4, p.learning_rate)
    np.testing.assert_allclose(got.epoch_losses, one.epoch_losses, rtol=1e-5)
    info = pncf.LAST_MESH_INFO
    assert info["mesh"] == {"data": 2, "model": 2} and info["padded"] == [40, 30]
    assert info["collective_backend"] == "in-process" and info["batch"] == 64
    single = pncf.train_ncf(users, items, 40, 30, p, device="cpu",
                            mesh=make_mesh(MeshConfig(), devices=["cpu"]))
    for a, b in zip(pncf.tree_leaves(single.params), pncf.tree_leaves(one.params)):
        assert torch.equal(a, b)


def test_train_ncf_pads_the_tables_and_rounds_the_batch():
    """41 x 31 over ``{data: 4, model: 2}`` on 8 slots: tables of 42 x 32,
    the init drawn at that shape and overlaid with shorter given tables
    (their leading rows), a batch of 30 rounded to 32."""
    rng = np.random.default_rng(1)
    users = rng.integers(0, 41, 90)
    items = rng.integers(0, 31, 90)
    given = {"user_emb": rng.standard_normal((41, 8)).astype(np.float32),
             "item_emb": rng.standard_normal((31, 8)).astype(np.float32)}
    p = pncf.NCFParams(embed_dim=8, mlp_layers=(), loss="full_softmax",
                       batch_size=30, num_epochs=0)
    st = pncf.train_ncf(users, items, 41, 31, p, initial_params=given,
                        mesh=port_mesh({"data": 4, "model": 2}))
    np.testing.assert_array_equal(st.params["user_emb"][:41].numpy(), given["user_emb"])
    np.testing.assert_array_equal(st.params["item_emb"][:31].numpy(), given["item_emb"])
    fresh = pncf.init_ncf(torch.Generator().manual_seed(p.seed), 42, 32, p)
    assert torch.equal(st.params["user_emb"][41:], fresh["user_emb"][41:])
    assert st.params["item_bias"].shape == (32,)
    assert pncf.LAST_MESH_INFO["batch"] == 32
    assert (st.n_users, st.n_items) == (41, 31)
    with pytest.raises(ValueError, match="neither 'data' nor 'model'"):
        pncf.train_ncf(users, items, 41, 31, p, mesh=port_mesh({"x": 2}))
    with pytest.raises(ValueError, match="does not divide"):
        pncf.param_shardings(port_mesh({"model": 2}),
                             {"user_emb": np.zeros((41, 8)), "mlp": []})


# -- placement ---------------------------------------------------------------


def test_tables_and_adam_moments_split_over_the_model_axis():
    """JAX ``tests/test_sharding.py:275``: on ``{data: 2, model: 4}`` each
    slot holds a quarter of the tables and 2 x a quarter of their Adam
    moments (never a replica), the MLP whole: the JAX package's bytes,
    slot for slot."""
    import optax

    from predictionio_tpu.parallel.mesh import shard_attribution as jax_attribution

    axes = {"data": 2, "model": 4}
    p = pncf.NCFParams(embed_dim=8, mlp_layers=(16, 8))
    tree, port_tree = carried((16, 8), True, 64, 32)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dict(axes)))
    net = jax.device_put(jax.tree.map(jnp.asarray, tree),
                         jncf.param_shardings(mesh, tree))
    opt_state = optax.adam(1e-3).init(net)
    table_shapes = (net["user_emb"].shape, net["item_emb"].shape)
    jax_moments = [leaf for leaf in jax.tree_util.tree_leaves(opt_state)
                   if getattr(leaf, "shape", None) in table_shapes]

    st = pncf.MeshNCF(port_mesh(axes), port_tree, p)
    placement = pncf.param_shardings(st.mesh, port_tree)
    assert placement["user_emb"] == pncf.Placement(4, 16)
    assert placement["item_emb"] == pncf.Placement(4, 8)
    assert all(x.blocks == 1 for x in pncf.tree_leaves(
        {k: v for k, v in placement.items() if k not in pncf.TABLES}))
    rng = np.random.default_rng(2)
    users, items = rng.integers(0, 64, 16), rng.integers(0, 32, 16)
    stream = pncf.stage_stream(users, items, p, CPU, multiple=2)
    cdf = torch.from_numpy(pncf.negative_sampling_cdf(items, 32, 0.0))
    st.train_epoch(stream, 32, torch.Generator().manual_seed(0), cdf)
    params, moments = st.placed()

    table_bytes = sum(tree[k].nbytes for k in pncf.TABLES)
    tables = shard_attribution({k: params[k] for k in pncf.TABLES})
    assert len(tables) == 8
    for e in tables.values():
        assert e["bytes"] == table_bytes / 4
    assert len(moments) == 4  # exp_avg + exp_avg_sq for each table
    oattr = shard_attribution(moments)
    assert len(oattr) == 8
    for e in oattr.values():
        assert e["bytes"] == 2 * table_bytes / 4
    mlp_bytes = sum(x.nbytes for x in jax.tree.leaves(tree["mlp"]))
    for e in shard_attribution(params["mlp"]).values():
        assert e["bytes"] == mlp_bytes
    # slot for slot the JAX package's bytes
    assert {k: v["bytes"] for k, v in tables.items()} == {
        k: v["bytes"] for k, v in jax_attribution(
            {"user_emb": net["user_emb"], "item_emb": net["item_emb"]}).items()}
    assert {k: v["bytes"] for k, v in oattr.items()} == {
        k: v["bytes"] for k, v in jax_attribution(jax_moments).items()}


# -- learning ----------------------------------------------------------------

LEARN_CASES = {
    # loss: (mlp_layers, epochs)
    "bpr": ((16, 8), 150),
    "full_softmax": ((), 120),
    "wals": ((), 120),
}


@pytest.mark.parametrize("loss", sorted(LEARN_CASES))
def test_mesh_train_learns_the_clusters(loss):
    """JAX ``tests/test_ncf.py:125`` (bpr on the MLP head) and ``:536``
    (the whole-catalog losses, sharded) on ``{data: 2, model: 2}``: the
    loss falls, the scores are finite, user 0 (even cluster) ranks the low
    items above the high ones and user 1 the other way round."""
    mlp, epochs = LEARN_CASES[loss]
    rng = np.random.default_rng(0)
    users, items = cluster_interactions(rng)
    st = pncf.train_ncf(
        users, items, 40, 30,
        pncf.NCFParams(embed_dim=8, mlp_layers=mlp, num_epochs=epochs,
                       batch_size=256, learning_rate=5e-3, loss=loss),
        mesh=port_mesh({"data": 2, "model": 2}))
    assert st.epoch_losses[-1] < st.epoch_losses[0]
    for user, (good, bad) in ((0, (slice(0, 15), slice(15, 30))),
                              (1, (slice(15, 30), slice(0, 15)))):
        scores = pncf.score_all_items(st.params, user).numpy()
        assert np.isfinite(scores).all()
        assert scores[good].mean() > scores[bad].mean()
    shards = pncf.LAST_MESH_INFO["shards"]
    assert len(shards["params"]) == 4 and len(shards["table_moments"]) == 4


# -- the engine --------------------------------------------------------------

MESH = {"axes": {"data": 2, "model": 2}}


def _ncf_events(rng, n_users=41, n_items=31, n=900):
    out = []
    for j in range(n):
        u = int(rng.integers(n_users))
        lo = 0 if u % 2 == 0 else n_items // 2
        i = lo + int(rng.integers(n_items // 2)) if rng.random() < 0.8 \
            else int(rng.integers(n_items))
        out.append({
            "event": "rate", "entityType": "user", "entityId": f"u{u}",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "properties": {"rating": float(rng.integers(3, 6))},
            "eventTime": f"2026-01-01T{j // 3600:02d}:{j // 60 % 60:02d}:"
                         f"{j % 60:02d}.000Z",
        })
    return out


def test_ncf_engine_trains_over_the_mesh_in_both_packages(tmp_path, monkeypatch):
    """``pio train`` of the ``ncf`` template (the ALS-pretrain recipe) with
    an engine.json mesh of ``{data: 2, model: 2}``: through the JAX CLI on
    its virtual devices, and through the port's ``run_train`` on 4 CPU
    slots with the ``mesh_conf`` the port's CLI builds from that
    engine.json (the port's CLI has one slot on the CPU, and a 4-slot
    mesh does not fit it).  Both record the same ``mesh_conf``; the port
    passes the mesh to its ALS pretrain; the persisted leaf shapes are the
    JAX package's; the JAX package deploys the port's blob; no answer of
    either deploy names a padded item."""
    from predictionio_tpu.core.persistence import load_models as jax_load_models
    from predictionio_tpu.data.storage.config import StorageConfig as JaxConfig
    from predictionio_tpu.data.storage.config import reset_storage as jax_reset
    from predictionio_tpu.server import prediction_server as jax_server
    from predictionio_tpu.tools import cli as jax_cli
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        reset_storage,
    )
    from predictionio_tpu_torch.ops import als as pt_als
    from predictionio_tpu_torch.server.prediction_server import deploy_engine

    with open(tmp_path / "events.jsonl", "w") as f:
        for e in _ncf_events(np.random.default_rng(3)):
            f.write(json.dumps(e) + "\n")
    variant = {
        "id": "ncfmesh", "engineFactory": "ncf", "mesh": MESH,
        "datasource": {"params": {"appName": "shop"}},
        "algorithms": [{"name": "ncf", "params": {
            "embedDim": 8, "mlpLayers": [], "pretrain": "als",
            "loss": "full_softmax", "numEpochs": 3, "batchSize": 64,
            "learningRate": 5e-3}}],
    }
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    env = {"PIO_HOME": str(tmp_path / "home")}
    jax_storage = jax_reset(JaxConfig.from_env(env))
    try:
        assert jax_cli.main(["app", "new", "shop"]) == 0
        assert jax_cli.main(["import", "--app", "shop", "--input",
                             str(tmp_path / "events.jsonl")]) == 0
        assert jax_cli.main(["train", "--engine-json",
                             str(tmp_path / "engine.json")]) == 0
        [jax_inst] = [x for x in jax_storage.engine_instances().get_all()
                      if x.engine_id == "ncfmesh"]
        [jax_blob] = jax_load_models(jax_storage.models(), jax_inst.id)
    finally:
        jax_storage.close()

    meshes = []
    real = pt_als.train_als

    def spy(*args, **kw):
        meshes.append(kw.get("mesh"))
        return real(*args, **kw)

    monkeypatch.setattr(pt_als, "train_als", spy)
    storage = reset_storage(StorageConfig.from_env(env))
    try:
        engine = resolve_engine_factory("ncf")()
        ctx = EngineContext(storage=storage, device="cpu",
                            mesh_config=MeshConfig.from_dict(variant["mesh"]),
                            mesh_devices=[CPU] * 4)
        inst = run_train(engine, engine.params_from_json(variant), ctx=ctx,
                         engine_id="ncfmesh", engine_factory="ncf",
                         storage=storage)
        [blob] = load_models(storage.models(), inst.id)
        assert [m.shape for m in meshes] == [{"data": 2, "model": 2}]
        assert storage.engine_instances().get(inst.id).mesh_conf == MESH
        assert jax_inst.mesh_conf == MESH
        shapes = {k: np.shape(v) for k, v in blob["params"].items() if k != "mlp"}
        assert shapes == {k: np.shape(v) for k, v in jax_blob["params"].items()
                          if k != "mlp"}
        n_users, n_items = len(blob["user_vocab"]), len(blob["item_vocab"])
        assert (n_users, n_items) == (41, 31)
        assert shapes["user_emb"] == (42, 8) and shapes["item_emb"] == (32, 8)
        dep = deploy_engine("ncf", storage=storage, engine_instance_id=inst.id,
                            device="cpu")
        algo = dep.algorithms[0]
        # the padded item row would win every answer if it were reachable
        blob["params"]["item_bias"][n_items:] = 1e6
        items = {f"i{j}" for j in range(n_items)}
        users = ["u0", "u1", "u7", "u40"]
        for model in (dep.models[0], algo.load_persistent_model(ctx, blob)):
            for u in users:
                _, res = dep.predict(dep.extract_query({"user": u, "num": 100})) \
                    if model is dep.models[0] else (None, algo.predict(
                        model, dep.extract_query({"user": u, "num": 100})))
                assert {s.item for s in res.item_scores} == items
            wave = algo.batch_predict(
                model, [(j, dep.extract_query({"user": u, "num": 100}))
                        for j, u in enumerate(users)])
            for _, res in wave:
                assert {s.item for s in res.item_scores} == items
    finally:
        storage.close()
    jax_storage = jax_reset(JaxConfig.from_env(env))
    try:
        jdep = jax_server.deploy_engine("ncf", storage=jax_storage,
                                        engine_instance_id=inst.id)
        _, res = jdep.predict(jdep.extract_query({"user": "u1", "num": 100}))
        assert {s.item for s in res.item_scores} == items
    finally:
        jax_storage.close()

