"""The port's multi-process data plane: two OS processes, one mesh, gloo.

The counterparts of ``tests/test_distributed.py``'s two-process ALS tests
(``:164`` parquet, ``:309`` sqlite, ``:473`` the storage daemon): each
worker joins the group through ``parallel.mesh.initialize_distributed``
under the env contract (``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES``,
``PIO_PROCESS_ID``), with two CPU slots of its own (the JAX workers' two
virtual devices), reads a disjoint half of the event shards, pads its rows
with ``balance_local_chunks``, places them with ``global_data_array`` and
joins one ``train_als_global`` over the global ``{"data": 4}`` mesh.  Rank
0's factors are held to the port's single-process train and to the JAX
package's (from the port's seeded start: jax PRNG bits cannot be drawn in
torch) under each JAX test's tolerance and its top-3 check; both ranks'
factors are equal.  Also: ``train_als(mesh=)`` with identical full inputs
on both ranks, and ``balance_local_chunks`` where one rank read no rows.

The workers import no JAX.  gloo on the loopback needs nothing this host
lacks, so a worker that fails or times out fails the test.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 60, 40
CHUNK = 1 << 10
PARAMS = dict(rank=4, num_iterations=5, reg=0.1, seed=3, chunk_size=CHUNK)
WORKER_TIMEOUT_S = 120


def make_ratings():
    """``tests/test_distributed.py``'s ratings: one per (user, item)."""
    rng = np.random.default_rng(11)
    u = rng.integers(0, N_USERS, 4000).astype(np.int64)
    i = rng.integers(0, N_ITEMS, 4000).astype(np.int64)
    r = np.clip(
        3.0 + 0.5 * ((u % 5) - 2) + 0.4 * ((i % 7) - 3)
        + rng.normal(0, 0.3, len(u)),
        0.5, 5.0,
    ).astype(np.float32)
    _, keep = np.unique(u * N_ITEMS + i, return_index=True)
    return u[keep], i[keep], r[keep]


def rate_events(u, i, r):
    from predictionio_tpu_torch.data.event import Event

    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    return [
        Event(
            event="rate", entity_type="user", entity_id=f"u{uu}",
            target_entity_type="item", target_entity_id=f"i{ii}",
            properties={"rating": float(rr)}, event_time=t0,
        )
        for uu, ii, rr in zip(u, i, r)
    ]


_WORKER = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)

from predictionio_tpu_torch.ops import als_accum
from predictionio_tpu_torch.parallel.mesh import (
    balance_local_chunks, collective_backend, default_mesh,
    global_data_array, initialize_distributed, local_devices, process_count,
)

initialize_distributed(device="cpu", local_devices=["cpu", "cpu"])
assert process_count() == 2, process_count()

from predictionio_tpu_torch.ops.als import ALSParams, train_als, train_als_global

source, where, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
rank = int(os.environ["PIO_PROCESS_ID"])
n_users, n_items, chunk = %d, %d, %d
params = ALSParams(%s)


def read(pe, shards):
    us, is_, rs = [], [], []
    for _, frame in pe.iter_shards(1, shards=shards):
        sel = frame.where_event("rate")
        us.append(np.array([int(s[1:]) for s in sel.entity_id], np.int32))
        is_.append(np.array([int(s[1:]) for s in sel.target_entity_id], np.int32))
        rs.append(np.asarray(sel.property_column("rating", default=0.0), np.float32))
    return np.concatenate(us), np.concatenate(is_), np.concatenate(rs)


if source == "parquet":
    from predictionio_tpu_torch.data.storage.parquet_backend import (
        ParquetClient, ParquetPEvents)
    pe = ParquetPEvents(ParquetClient(where, n_shards=8))
    u, i, r = read(pe, [k for k in range(8) if k %% 2 == rank])
elif source == "sqlite":
    from predictionio_tpu_torch.data.storage.sqlite_backend import (
        SQLiteClient, SQLiteLEvents, SQLitePEvents)
    client = SQLiteClient(where)
    pe = SQLitePEvents(client, SQLiteLEvents(client))
    u, i, r = read(pe, [k for k in range(8) if k %% 2 == rank])
elif source == "remote":
    from predictionio_tpu_torch.data.storage.remote_backend import (
        RemoteClient, RemotePEvents)
    pe = RemotePEvents(RemoteClient(where))
    n = pe.n_shards(1)
    u, i, r = read(pe, [k for k in range(n) if k %% 2 == rank])
else:  # "npz": rank 0 all rows, rank 1 none ("skewed"), or both all
    data = np.load(where)
    u, i, r = data["u"], data["i"], data["r"]
    if source == "skewed" and rank == 1:
        u, i, r = u[:0], i[:0], r[:0]
print(f"rank {rank}: {len(u)} rows", file=sys.stderr)

mesh = default_mesh()
out = {"n_local": len(u)}
if source in ("full", "auto_split", "mixed_mode", "oom"):
    import dataclasses
    from predictionio_tpu_torch.ops import als

    # every attempt of the mode ladder, by its mode
    attempts = []
    train_mode = als._train_mesh_mode

    def counted(*args, **kwargs):
        attempts.append(args[5])
        return train_mode(*args, **kwargs)

    als._train_mesh_mode = counted
    if source == "auto_split" and rank == 1:
        # as a card with less free memory than rank 0's would choose
        als._auto_mode = lambda p, rows: "chunked"
    if source == "mixed_mode":
        params = dataclasses.replace(params, pallas_mode=("fused", "chunked")[rank])
    if source == "oom" and rank == 1:
        def out_of_memory(*args, **kwargs):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

        als._stage = out_of_memory
    try:
        state = train_als(u, i, r, n_users, n_items, params, mesh=mesh)
        U, V = state.user_factors.numpy(), state.item_factors.numpy()
    except Exception as e:
        out.update(error_type=type(e).__name__, error=str(e))
        U = V = np.zeros(0)
    out.update(attempts=np.array(attempts, dtype=str),
               mode=np.array(als.LAST_PLAN_INFO.get("mode", "")))
else:
    (u, i, r), valid = balance_local_chunks([u, i, r], chunk * len(local_devices()))
    out.update(padded=len(u), valid=float(valid.sum()))
    gu, gi, gr, gv = (global_data_array(mesh, a) for a in (u, i, r, valid))
    state = train_als_global(gu, gi, gr, gv, n_users, n_items, mesh, params=params)
    U, V = state.user_factors, state.item_factors
np.savez(
    out_path + f".{rank}.npz", U=U, V=V,
    mesh=np.array(str(mesh.shape)), labels=np.array(mesh.labels),
    local_slots=np.array(mesh.local_slots),
    backend=np.array(collective_backend()),
    launches=als_accum.KERNEL_LAUNCHES["als_fused_accum"], **out,
)
print("done", rank, file=sys.stderr)
""" % (N_USERS, N_ITEMS, CHUNK, ", ".join(f"{k}={v}" for k, v in PARAMS.items()))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_workers(source: str, where, out: Path) -> list[dict]:
    """Two workers under the env contract; each rank's saved arrays.  A
    worker that fails or does not finish within WORKER_TIMEOUT_S fails the
    test."""
    port = free_port()
    procs = []
    for rank in (0, 1):
        env = dict(
            os.environ,
            PYTHONPATH=str(REPO),
            PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            PIO_NUM_PROCESSES="2",
            PIO_PROCESS_ID=str(rank),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, source, str(where), str(out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    try:
        results = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a {source} worker did not finish in {WORKER_TIMEOUT_S} s")
    for rank, (p, (_, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"{source} worker {rank} failed:\n{err[-3000:]}"
    return [dict(np.load(f"{out}.{rank}.npz")) for rank in (0, 1)]


def references(u, i, r):
    """The port's single-process train and the JAX package's, both from
    the port's seeded start."""
    p = als.ALSParams(**PARAMS)
    mine = als.train_als(u.astype(np.int32), i.astype(np.int32), r,
                         N_USERS, N_ITEMS, p, device="cpu")
    U0, V0 = als._init_factors(p, 128, 128, N_USERS, N_ITEMS, "cpu")
    jax = jax_als.train_als(
        u.astype(np.int32), i.astype(np.int32), r, N_USERS, N_ITEMS,
        params=jax_als.ALSParams(**PARAMS),
        init_factors=(U0[:N_USERS].numpy(), V0[:N_ITEMS].numpy()),
    )
    return {
        "port": mine.user_factors.numpy() @ mine.item_factors.numpy().T,
        "jax": np.asarray(jax.user_factors) @ np.asarray(jax.item_factors).T,
    }


def hold(ranks: list[dict], u, i, r, rtol: float, atol: float, top3: bool):
    np.testing.assert_array_equal(ranks[0]["U"], ranks[1]["U"])
    np.testing.assert_array_equal(ranks[0]["V"], ranks[1]["V"])
    assert ranks[0]["U"].shape == (N_USERS, PARAMS["rank"])
    assert ranks[0]["V"].shape == (N_ITEMS, PARAMS["rank"])
    got = ranks[0]["U"] @ ranks[0]["V"].T
    for name, want in references(u, i, r).items():
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
        if top3:
            agree = (np.argsort(-want, axis=1)[:, :3]
                     == np.argsort(-got, axis=1)[:, :3]).all(axis=1).mean()
            assert agree > 0.9, (name, agree)
    for rank, out in enumerate(ranks):
        assert str(out["mesh"]) == "{'data': 4}"
        assert list(out["labels"]) == ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
        assert list(out["local_slots"]) == [2 * rank, 2 * rank + 1]
        assert str(out["backend"]) == "gloo"
        assert int(out["launches"]) == 0  # CPU tensors launch no kernel


def test_two_process_parquet_train_matches_single_process(tmp_path):
    from predictionio_tpu_torch.data.storage.parquet_backend import (
        ParquetClient,
        ParquetLEvents,
    )

    u, i, r = make_ratings()
    le = ParquetLEvents(ParquetClient(tmp_path / "events", n_shards=8))
    le.init(1)
    le.insert_batch(rate_events(u, i, r), 1)
    ranks = run_two_workers("parquet", tmp_path / "events", tmp_path / "f")
    assert ranks[0]["n_local"] + ranks[1]["n_local"] == len(u)
    assert ranks[0]["padded"] == ranks[1]["padded"]
    hold(ranks, u, i, r, rtol=5e-2, atol=5e-3, top3=True)


def test_two_process_sql_store_train_parity(tmp_path):
    from predictionio_tpu_torch.data.storage.sqlite_backend import (
        SQLiteClient,
        SQLiteLEvents,
    )

    u, i, r = make_ratings()
    client = SQLiteClient(tmp_path / "events.sqlite")
    le = SQLiteLEvents(client)
    le.init(1)
    le.insert_batch(rate_events(u, i, r), 1)
    client.close()
    ranks = run_two_workers("sqlite", tmp_path / "events.sqlite", tmp_path / "f")
    assert ranks[0]["n_local"] + ranks[1]["n_local"] == len(u)
    hold(ranks, u, i, r, rtol=5e-2, atol=5e-3, top3=False)


def test_two_process_remote_daemon_train_parity(tmp_path):
    from predictionio_tpu_torch.data.storage.remote_backend import (
        RemoteClient,
        RemoteLEvents,
    )
    from predictionio_tpu_torch.server.storage_server import StorageServer

    daemon = StorageServer(
        tmp_path / "daemon_root", host="127.0.0.1", port=0
    ).start_background()
    try:
        url = f"http://127.0.0.1:{daemon.port}"
        u, i, r = make_ratings()
        le = RemoteLEvents(RemoteClient(url))
        le.init(1)
        le.insert_batch(rate_events(u, i, r), 1)
        ranks = run_two_workers("remote", url, tmp_path / "f")
    finally:
        daemon.shutdown()
    assert ranks[0]["n_local"] + ranks[1]["n_local"] == len(u)
    hold(ranks, u, i, r, rtol=0.05, atol=0.05, top3=False)


def test_two_process_train_als_mesh_with_identical_inputs(tmp_path):
    """``train_als(mesh=)`` across ranks: both pass the full stream, each
    stages only its own slots' rows."""
    u, i, r = make_ratings()
    np.savez(tmp_path / "ratings.npz", u=u.astype(np.int32),
             i=i.astype(np.int32), r=r)
    ranks = run_two_workers("full", tmp_path / "ratings.npz", tmp_path / "f")
    hold(ranks, u, i, r, rtol=5e-2, atol=5e-3, top3=True)


def test_balance_local_chunks_with_a_rank_that_read_nothing(tmp_path):
    """The remainder-on-last-host case: rank 1 read no rows, pads to rank
    0's chunk-aligned length with valid=0 throughout, and the joined train
    still equals the single-process one."""
    u, i, r = make_ratings()
    np.savez(tmp_path / "ratings.npz", u=u.astype(np.int32),
             i=i.astype(np.int32), r=r)
    ranks = run_two_workers("skewed", tmp_path / "ratings.npz", tmp_path / "f")
    target = -(-len(u) // (2 * CHUNK)) * 2 * CHUNK
    assert [int(x["padded"]) for x in ranks] == [target, target]
    assert [float(x["valid"]) for x in ranks] == [len(u), 0.0]
    hold(ranks, u, i, r, rtol=5e-2, atol=5e-3, top3=True)


def test_two_process_train_agrees_on_one_mode(tmp_path):
    """Under ``pallas_mode="auto"`` rank 1 would take the chunked rung (as
    on a card with less free memory) and rank 0 the fused one: both train
    chunked, one attempt each, and agree."""
    u, i, r = make_ratings()
    np.savez(tmp_path / "ratings.npz", u=u.astype(np.int32),
             i=i.astype(np.int32), r=r)
    ranks = run_two_workers("auto_split", tmp_path / "ratings.npz", tmp_path / "f")
    assert [str(x["mode"]) for x in ranks] == ["chunked", "chunked"]
    assert [list(x["attempts"]) for x in ranks] == [["chunked"], ["chunked"]]
    hold(ranks, u, i, r, rtol=5e-2, atol=5e-3, top3=True)


def test_two_process_train_refuses_different_modes_on_every_rank(tmp_path):
    """Rank 0 forces the fused rung and rank 1 the chunked one: both raise
    the same ``ValueError`` before either trains."""
    u, i, r = make_ratings()
    np.savez(tmp_path / "ratings.npz", u=u.astype(np.int32),
             i=i.astype(np.int32), r=r)
    ranks = run_two_workers("mixed_mode", tmp_path / "ratings.npz", tmp_path / "f")
    for x in ranks:
        assert str(x["error_type"]) == "ValueError", x
        assert "pallas_mode ['fused', 'chunked']" in str(x["error"]), x
        assert list(x["attempts"]) == []
    assert str(ranks[0]["error"]) == str(ranks[1]["error"])


def test_two_process_train_stops_every_rank_when_one_runs_out_of_memory(tmp_path):
    """Rank 1 runs out of device memory while it stages: it raises its
    own error, rank 0 raises naming it, and neither retries on the
    chunked rung alone (one fused attempt each)."""
    u, i, r = make_ratings()
    np.savez(tmp_path / "ratings.npz", u=u.astype(np.int32),
             i=i.astype(np.int32), r=r)
    ranks = run_two_workers("oom", tmp_path / "ratings.npz", tmp_path / "f")
    assert str(ranks[1]["error_type"]) == "OutOfMemoryError", ranks[1]
    assert str(ranks[0]["error_type"]) == "RuntimeError", ranks[0]
    assert "rank(s) [1]" in str(ranks[0]["error"]), ranks[0]
    assert [list(x["attempts"]) for x in ranks] == [["fused"], ["fused"]]


# -- NCF over a mesh across two processes ------------------------------------

#: the JAX two-process NCF tests' trains (tests/test_distributed.py:411 and
#: :576), both on {data: 2, model: 2}: one data position and both model
#: blocks a rank
NCF_PARAMS = {
    "bpr": dict(embed_dim=8, mlp_layers=(16, 8), num_epochs=150,
                batch_size=64, learning_rate=5e-3),
    "wals": dict(embed_dim=8, mlp_layers=(), loss="wals", num_epochs=120,
                 batch_size=64, learning_rate=5e-3),
}

_NCF_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)

from predictionio_tpu_torch.parallel.mesh import (
    COLLECTIVE_STATS, MeshConfig, collective_backend, initialize_distributed,
    make_mesh, process_count,
)

initialize_distributed(device="cpu", local_devices=["cpu", "cpu"])
assert process_count() == 2, process_count()

from predictionio_tpu_torch.ops import ncf

data_path, kwargs, fail, out_path = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3], sys.argv[4]
rank = int(os.environ["PIO_PROCESS_ID"])
data = np.load(data_path)
kwargs["mlp_layers"] = tuple(kwargs["mlp_layers"])
mesh = make_mesh(MeshConfig({"data": 2, "model": 2}))
out = {}
if fail == "fail" and rank == 1:
    # rank 1's part of the third step raises
    real = ncf.MeshNCF._position
    calls = []

    def failing(self, *args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected failure")
        return real(self, *args, **kw)

    ncf.MeshNCF._position = failing
leaves = []
try:
    state = ncf.train_ncf(data["u"], data["i"], 40, 30, ncf.NCFParams(**kwargs),
                          mesh=mesh)
    leaves = ncf.tree_leaves(ncf.host_params(state.params))
    out.update(losses=np.array(state.epoch_losses),
               positions=np.array(ncf.LAST_MESH_INFO["local_positions"]),
               info_backend=np.array(ncf.LAST_MESH_INFO["collective_backend"]),
               all_reduce_calls=COLLECTIVE_STATS["all_reduce"]["calls"],
               all_reduce_bytes=COLLECTIVE_STATS["all_reduce"]["bytes"])
except Exception as e:
    out.update(error_type=type(e).__name__, error=str(e))
np.savez(out_path + f".{rank}.npz", labels=np.array(mesh.labels),
         local_slots=np.array(mesh.local_slots),
         backend=np.array(collective_backend()),
         **{f"leaf{j}": x for j, x in enumerate(leaves)}, **out)
print("done", rank, file=sys.stderr)
"""


def run_two_ncf_workers(tmp_path: Path, loss: str,
                        fail: bool = False) -> tuple[list[dict], dict]:
    """Both ranks of ``_NCF_WORKER`` on the cluster data (identical full
    arrays on each rank, the JAX package's contract)."""
    import json

    rng = np.random.default_rng(11)
    users, items = [], []
    for u in range(40):
        lo, hi = (0, 15) if u % 2 == 0 else (15, 30)
        for i in rng.choice(np.arange(lo, hi), 6, replace=False):
            users.append(u)
            items.append(int(i))
    np.savez(tmp_path / "pos.npz", u=np.array(users), i=np.array(items))
    kwargs = dict(NCF_PARAMS[loss], mlp_layers=list(NCF_PARAMS[loss]["mlp_layers"]))
    port = free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _NCF_WORKER, str(tmp_path / "pos.npz"),
             json.dumps(kwargs), "fail" if fail else "ok", str(tmp_path / "ncf")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    try:
        results = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"an ncf worker did not finish in {WORKER_TIMEOUT_S} s")
    for rank, (p, (_, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"ncf worker {rank} failed:\n{err[-3000:]}"
    data = np.load(tmp_path / "pos.npz")
    return [dict(np.load(f"{tmp_path / 'ncf'}.{rank}.npz")) for rank in (0, 1)], data


@pytest.mark.parametrize("loss", sorted(NCF_PARAMS))
def test_two_process_ncf_train_matches_the_one_process_mesh_train(tmp_path, loss):
    """JAX ``tests/test_distributed.py:411`` (bpr on the MLP head) and
    ``:576`` (wals) on ``{data: 2, model: 2}`` across two processes: rank
    0's gathered tree within 1e-5 of the one-process mesh train on 4 CPU
    slots, both ranks' trees equal bit for bit, one ``all_reduce`` a step,
    and the clusters learnt."""
    from predictionio_tpu_torch.ops import ncf
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    ranks, data = run_two_ncf_workers(tmp_path, loss)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = ncf.train_ncf(data["u"], data["i"], 40, 30,
                             ncf.NCFParams(**NCF_PARAMS[loss]),
                             mesh=make_mesh(MeshConfig({"data": 2, "model": 2}),
                                            devices=["cpu"] * 4))
    finally:
        torch.set_num_threads(threads)
    want_leaves = ncf.tree_leaves(ncf.host_params(want.params))
    got_leaves = [ranks[0][f"leaf{j}"] for j in range(len(want_leaves))]
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    for j in range(len(want_leaves)):
        np.testing.assert_array_equal(ranks[0][f"leaf{j}"], ranks[1][f"leaf{j}"])
    np.testing.assert_allclose(ranks[0]["losses"], want.epoch_losses, rtol=1e-5)
    steps = NCF_PARAMS[loss]["num_epochs"] * 4  # 240 positives, batches of 64
    for rank, out in enumerate(ranks):
        assert list(out["labels"]) == ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
        assert list(out["local_slots"]) == [2 * rank, 2 * rank + 1]
        assert str(out["backend"]) == "gloo" and str(out["info_backend"]) == "gloo"
        assert list(out["positions"]) == [rank]
        assert int(out["all_reduce_calls"]) == steps
    # tables padded to nothing here (40 x 30 over 2): one flat buffer a
    # step of the loss, every table block and every other leaf
    n_values = 1 + sum(x.size for x in want_leaves)
    assert float(ranks[0]["all_reduce_bytes"]) == 4.0 * n_values * steps
    tree = ncf.params_from_jax(want.params, "cpu")
    for user, good, bad in ((0, slice(0, 15), slice(15, 30)),
                            (1, slice(15, 30), slice(0, 15))):
        scores = ncf.score_all_items(tree, user).numpy()
        assert np.isfinite(scores).all()
        assert scores[good].mean() > scores[bad].mean()


def test_two_process_ncf_train_stops_every_rank_when_one_fails(tmp_path):
    """Rank 1's part of the third step raises: it raises its own error,
    and rank 0 raises naming it, instead of waiting in the step's
    all-reduce."""
    ranks, _ = run_two_ncf_workers(tmp_path, "bpr", fail=True)
    assert str(ranks[1]["error"]) == "injected failure", ranks[1]
    assert str(ranks[0]["error_type"]) == "RuntimeError", ranks[0]
    assert "train_ncf: rank(s) [1]" in str(ranks[0]["error"]), ranks[0]
