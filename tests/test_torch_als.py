"""The port's ALS (predictionio_tpu_torch.ops.als and .als_accum) against the
JAX package, on the CPU.

- Plans: ``build_plan``/``chunk_plan`` are the contract of the stream
  layout, so they must equal the JAX package's array for array.
- Accumulators: the port's plain versions (what a CPU tensor runs) against
  the JAX package's Pallas kernels in interpret mode, at the tolerances of
  ``tests/test_als_pallas.py``: fused at rtol 1e-4 / atol 2e-3
  ("highest") and rtol 2e-4 / atol 2e-3 ("hilo"), chunked at 1e-4.
- Train: ``train_als(device="cpu")`` against the JAX ``train_als`` from the
  same ``init_factors`` (jax PRNG bits cannot be reproduced in torch) on
  ``tests/test_als_ops.py``'s fixture, ranks 5 and 17 (both of the JAX
  solver's branches), explicit and implicit, factors to atol 2e-3.
- The solve, the mode ladder, and the CPU-only dispatch of the wrappers.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import als_pallas as jax_ap
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.ops import _kernels
from predictionio_tpu_torch.ops import als, als_accum

torch.set_num_threads(2)


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


def _rmse(U, V, ui, ii, r) -> float:
    pred = (np.asarray(U)[ui] * np.asarray(V)[ii]).sum(1)
    return float(np.sqrt(((pred - r) ** 2).mean()))


# -- plans ------------------------------------------------------------------


def _skewed(rng):
    seg = rng.integers(0, 600, 9000)
    seg[:3500] = 7  # one segment over more than 3 tiles
    return seg, 640


def _empty_blocks(rng):
    # blocks 1 and 3 hold nothing: each becomes one all-padding tile
    seg = np.concatenate([rng.integers(0, 128, 2000), rng.integers(256, 384, 500)])
    return rng.permutation(seg), 512


@pytest.mark.parametrize("stream", [_skewed, _empty_blocks])
@pytest.mark.parametrize("tiles_per_chunk", [1, 2, 1024])
def test_plans_equal_the_jax_package(stream, tiles_per_chunk):
    seg, n_seg_pad = stream(np.random.default_rng(3))
    got = als_accum.build_plan(seg.astype(np.int64), n_seg_pad)
    want = jax_ap.build_plan(seg.astype(np.int64), n_seg_pad)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
    got_c = als_accum.chunk_plan(got, tiles_per_chunk)
    want_c = jax_ap.chunk_plan(want, tiles_per_chunk)
    for f in dataclasses.fields(want_c):
        np.testing.assert_array_equal(
            getattr(got_c, f.name), getattr(want_c, f.name)
        )
    assert als_accum.row_width(10) == jax_ap.row_width(10) == 128
    assert als_accum.row_width(17) == jax_ap.row_width(17) == 384
    assert als_accum.row_width(32) == jax_ap.row_width(32) == 1152


def test_out_of_range_segment_rejected():
    with pytest.raises(ValueError, match="segment ids"):
        als_accum.build_plan(np.array([0, 5, 384]), 384)
    with pytest.raises(ValueError, match="segment ids"):
        als_accum.build_plan(np.array([-1, 5]), 384)


# -- accumulators -----------------------------------------------------------


def _stream(n, n_seg, n_oth, k, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_seg - 6, n)
    oth = rng.integers(0, n_oth, n).astype(np.int32)
    rat = rng.uniform(-2, 2, n).astype(np.float32)
    factors = rng.standard_normal((n_oth, k)).astype(np.float32)
    return seg, oth, rat, factors


def _padded(plan, oth, rat, rows):
    oth_p, rat_p = oth[plan.dest_perm].copy(), rat[plan.dest_perm].copy()
    val_p = np.ones(rows, np.float32)
    oth_p[plan.pad_mask] = 0
    rat_p[plan.pad_mask] = 0
    val_p[plan.pad_mask] = 0
    return oth_p, rat_p, val_p


FUSED = [
    (k, implicit, precision, tol)
    for k in (6, 17)
    for implicit in (False, True)
    for precision, tol in (("highest", (1e-4, 2e-3)), ("hilo", (2e-4, 2e-3)))
]


@pytest.mark.parametrize(
    "k,implicit,precision,tol", FUSED,
    ids=[f"r{k}-{'imp' if i else 'exp'}-{p}" for k, i, p, _ in FUSED],
)
def test_fused_plain_matches_jax_interpret(k, implicit, precision, tol):
    n_seg = 256
    seg, oth, rat, factors = _stream(3000, n_seg, 64, k, seed=5 + k)
    plan = jax_ap.build_plan(seg.astype(np.int64), n_seg)
    nt = plan.n_tiles
    oth_p, rat_p, val_p = _padded(plan, oth, rat, plan.padded_len)
    want = jax_ap.segment_stats_fused(
        (jnp.asarray(plan.block_map), jnp.asarray(plan.first),
         jnp.asarray(plan.seg3)),
        jnp.asarray(oth_p.reshape(nt, jax_ap.T)),
        jax_ap.make_wrv(
            jnp.asarray(rat_p.reshape(nt, jax_ap.T)),
            jnp.asarray(val_p.reshape(nt, jax_ap.T)), implicit, 1.5,
        ),
        jnp.asarray(factors), nt, plan.n_blocks, precision=precision,
        interpret=True,
    )
    wrv = als_accum.make_wrv(
        torch.from_numpy(rat_p.reshape(nt, als_accum.T)),
        torch.from_numpy(val_p.reshape(nt, als_accum.T)), implicit, 1.5,
    )
    got = als_accum.segment_stats_fused(
        (torch.from_numpy(plan.block_map), torch.from_numpy(plan.seg3)),
        torch.from_numpy(oth_p.reshape(nt, als_accum.T)), wrv,
        torch.from_numpy(factors), plan.n_blocks, precision=precision,
    )
    assert got.shape == (n_seg, als_accum.row_width(k))
    rtol, atol = tol
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    # the count column is exact and the columns past it are zero
    np.testing.assert_array_equal(
        got[:, k * k + k].numpy(), np.bincount(seg, minlength=n_seg)
    )
    assert not got[:, k * k + k + 1:].any()


def test_make_wrv_equals_the_jax_package():
    rng = np.random.default_rng(2)
    rat = rng.uniform(-2, 2, (3, als_accum.T)).astype(np.float32)
    val = (rng.random((3, als_accum.T)) < 0.9).astype(np.float32)
    for implicit in (False, True):
        want = np.asarray(jax_ap.make_wrv(jnp.asarray(rat), jnp.asarray(val), implicit, 40.0))
        got = als_accum.make_wrv(
            torch.from_numpy(rat), torch.from_numpy(val), implicit, 40.0
        ).numpy()
        np.testing.assert_array_equal(got, want)


CHUNKED = [
    (k, implicit, precision)
    for k in (6, 17)  # widths 128 and 384 (three 128-column slabs)
    for implicit in (False, True)
    for precision in ("highest", "bf16")
]


@pytest.mark.parametrize(
    "k,implicit,precision", CHUNKED,
    ids=[f"r{k}-{'imp' if i else 'exp'}-{p}" for k, i, p in CHUNKED],
)
def test_chunked_plain_matches_jax_interpret(k, implicit, precision):
    n_seg = 256
    seg, oth, rat, factors = _stream(3000, n_seg, 64, k, seed=2)
    plan = jax_ap.chunk_plan(
        jax_ap.build_plan(seg.astype(np.int64), n_seg), tiles_per_chunk=2
    )
    rows = plan.n_chunks * plan.tiles_per_chunk * jax_ap.T
    oth_p, rat_p, val_p = _padded(plan, oth, rat, rows)
    shape2 = (plan.n_chunks, plan.tiles_per_chunk * jax_ap.T)
    want = jax_ap.segment_stats_pallas(
        (jnp.asarray(plan.block_map), jnp.asarray(plan.first),
         jnp.asarray(plan.seg3), jnp.asarray(plan.visited)),
        jnp.asarray(oth_p.reshape(shape2)), jnp.asarray(rat_p.reshape(shape2)),
        jnp.asarray(val_p.reshape(shape2)), jnp.asarray(factors), implicit,
        1.5, plan.tiles_per_chunk, plan.n_blocks, precision=precision,
        interpret=True,
    )
    # blocks cross chunk boundaries: the running output carries them
    assert plan.n_chunks > 1 and plan.first[:, 0].all()
    got = als_accum.segment_stats_chunked(
        (torch.from_numpy(plan.block_map), torch.from_numpy(plan.seg3)),
        torch.from_numpy(oth_p.reshape(shape2)),
        torch.from_numpy(rat_p.reshape(shape2)),
        torch.from_numpy(val_p.reshape(shape2)), torch.from_numpy(factors),
        implicit, 1.5, plan.n_blocks, precision=precision,
    )
    assert got.shape == (n_seg, als_accum.row_width(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # the count column is exact and the columns past it are zero
    np.testing.assert_array_equal(
        got[:, k * k + k].numpy(), np.bincount(seg, minlength=n_seg)
    )
    assert not got[:, k * k + k + 1:].any()


def test_bf16_rounds_each_row_value():
    seg = np.array([0, 0, 1])
    plan = als_accum.build_plan(seg, 128)
    rows = torch.zeros((als_accum.T, 128))
    rows[:3, 0] = torch.tensor([1.0 + 2.0**-10, 1.0, 3.0])  # 1 + 2^-10 rounds to 1
    args = (torch.from_numpy(plan.block_map), torch.from_numpy(plan.seg3))
    out = torch.zeros((128, 128))
    als_accum.segment_accum(out, *args, rows, precision="bf16")
    assert out[0, 0] == 2.0 and out[1, 0] == 3.0
    als_accum.segment_accum(out, *args, rows, precision="hilo")
    assert out[0, 0] == 4.0 + 2.0**-10  # and it adds into the running output


def test_cpu_tensors_never_load_a_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for CPU tensors")

    monkeypatch.setattr(_kernels, "load", refuse)
    before = dict(als_accum.KERNEL_LAUNCHES)
    seg, oth, rat, factors = _stream(500, 128, 20, 3, seed=9)
    plan = als_accum.build_plan(seg.astype(np.int64), 128)
    oth_p, rat_p, val_p = _padded(plan, oth, rat, plan.padded_len)
    args = (torch.from_numpy(plan.block_map), torch.from_numpy(plan.seg3))
    wrv = als_accum.make_wrv(
        torch.from_numpy(rat_p).reshape(-1, als_accum.T),
        torch.from_numpy(val_p).reshape(-1, als_accum.T), False, 1.0,
    )
    als_accum.segment_stats_fused(
        args, torch.from_numpy(oth_p).reshape(-1, als_accum.T), wrv,
        torch.from_numpy(factors), plan.n_blocks,
    )
    assert als_accum.KERNEL_LAUNCHES == before
    assert set(before) == {"als_fused_accum", "als_segment_accum"}
    assert {"als_fused_accum", "als_segment_accum"} <= set(_kernels.KERNELS)


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        als_accum.segment_accum(
            torch.zeros((128, 128)), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 8, 128), dtype=torch.int32),
            torch.zeros((als_accum.T, 128)), precision="fp8",
        )


def test_least_work_at_the_ml20m_shape():
    # ML-20M users, rank 10: 20,576,256 stream rows, 20,000,263 of them
    # ratings, 138,496 padded users, 26,752 padded items
    rows, valid = 20_576_256, 20_000_263
    work = als_accum.als_accum_least_work(rows, 10, 138_496, 26_752, valid)
    # padding rows cost only their segment id
    assert work["bytes"] == 4.0 * (
        rows + valid * 4 + rows // 1024 + 26_752 * 10 + 138_496 * 128
    )
    assert 0.4e9 < work["bytes"] < 0.5e9
    assert work["flops"] == valid * (3 * 100 + 21)
    assert als_accum.als_accum_least_work(rows, 10, 138_496, 26_752)[
        "bytes"] > work["bytes"]
    # one 1,024-tile chunk: 54 user blocks touched, 33,119 padding rows
    chunk = als_accum.segment_accum_least_work(
        1 << 20, 128, 54 * 128, (1 << 20) - 33_119
    )
    assert chunk["bytes"] == 4.0 * (
        (1 << 20) + 1024 + ((1 << 20) - 33_119) * 128 + 2 * 54 * 128 * 128
    )
    assert 0.5e9 < chunk["bytes"] < 0.55e9
    assert chunk["flops"] == ((1 << 20) - 33_119) * 128
    # rank 32: the first chunk of 113 tiles at width 1,152, here with no
    # padding rows and 7 blocks touched: about as many bytes as at width
    # 128, so about the same bound
    rows = als_accum.chunk_tiles(1152) * 1024
    assert rows == 115_712
    wide = als_accum.segment_accum_least_work(rows, 1152, 7 * 128)
    assert wide["bytes"] == 4.0 * (rows + 113 + rows * 1152 + 2 * 7 * 128 * 1152)
    assert 0.5e9 < wide["bytes"] < 0.55e9
    assert wide["flops"] == rows * 1152


def test_chunk_tiles_bound_the_built_rows():
    assert als_accum.chunk_tiles(128) == 1024  # the JAX package's default
    assert als_accum.chunk_tiles(384) == 341
    assert als_accum.chunk_tiles(1152) == 113
    for width in (128, 384, 1152):
        tiles = als_accum.chunk_tiles(width)
        assert tiles * als_accum.T * width * 4 <= als_accum.CHUNK_ROW_BYTES
        assert (tiles + 1) * als_accum.T * width * 4 > als_accum.CHUNK_ROW_BYTES


def test_flat_rows_built_in_place_equal_the_concatenation():
    rng = np.random.default_rng(4)
    n, k, width = 300, 6, 128
    v = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    w, rhs, val = (
        torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        for _ in range(3)
    )
    want = torch.cat([
        (v[:, :, None] * v[:, None, :]).reshape(n, k * k) * w[:, None],
        v * rhs[:, None], val[:, None], torch.zeros((n, width - k * k - k - 1)),
    ], dim=1)
    got = als_accum._flat_rows(v, w, rhs, val, width)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    reused = torch.full((n, width), 7.0)
    assert als_accum._flat_rows(v, w, rhs, val, width, out=reused) is reused
    assert torch.equal(reused, want)


def test_only_the_fused_streams_go_to_the_device():
    # the chunked rung's streams stay in host memory: the accumulator
    # uploads one chunk at a time ("meta" stands in for a card here)
    seg, oth, rat, _ = _stream(3000, 256, 64, 4, seed=6)
    fused = als._stage(seg, oth, rat, 256, "fused", torch.device("meta"))
    chunked = als._stage(seg, oth, rat, 256, "chunked", torch.device("meta"),
                         tiles_per_chunk=2)
    for key in ("oth", "rat", "val"):
        assert fused[key].device.type == "meta"
        assert chunked[key].device.type == "cpu"
    assert all(t.device.type == "meta" for t in fused["plan_args"])
    assert all(t.device.type == "cpu" for t in chunked["plan_args"])
    plan = chunked["plan"]
    assert plan.tiles_per_chunk == 2
    assert chunked["oth"].shape == (plan.n_chunks, 2 * als_accum.T)
    np.testing.assert_array_equal(
        chunked["val"].numpy().reshape(-1), (plan.seg3 >= 0).reshape(-1)
    )


# -- solve, train -----------------------------------------------------------


@pytest.mark.parametrize("with_gram", [False, True])
@pytest.mark.parametrize("k", [4, 20])
def test_solve_factors_matches_numpy(with_gram, k):
    rng = np.random.default_rng(k)
    n = 40
    M = rng.standard_normal((n, k, k)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1)
    b = rng.standard_normal((n, k)).astype(np.float32)
    counts = rng.integers(0, 9, n).astype(np.float32)
    G = rng.standard_normal((k, k)).astype(np.float32)
    gram = G @ G.T if with_gram else None
    got = als._solve_factors(
        torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(counts),
        0.1, True, None if gram is None else torch.from_numpy(gram),
    ).numpy()
    lhs = A + (0.1 * np.maximum(counts, 1.0))[:, None, None] * np.eye(k)
    if gram is not None:
        lhs = lhs + gram
    want = np.linalg.solve(lhs, b[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


TRAIN = [(rank, implicit) for rank in (5, 17) for implicit in (False, True)]


@pytest.mark.parametrize(
    "rank,implicit", TRAIN,
    ids=[f"r{r}-{'imp' if i else 'exp'}" for r, i in TRAIN],
)
def test_train_matches_the_jax_package(ratings, rank, implicit):
    nu, ni, ui, ii, r = ratings
    kw = dict(rank=rank, num_iterations=15, implicit_prefs=implicit, alpha=40.0)
    rng = np.random.default_rng(rank)
    init = (
        (np.abs(rng.standard_normal((nu, rank))) / np.sqrt(rank)).astype(np.float32),
        (np.abs(rng.standard_normal((ni, rank))) / np.sqrt(rank)).astype(np.float32),
    )
    want = jax_als.train_als(
        ui, ii, r, nu, ni, jax_als.ALSParams(chunk_size=1024, **kw),
        init_factors=init,
    )
    got = als.train_als(
        ui, ii, r, nu, ni, als.ALSParams(**kw), device="cpu", init_factors=init
    )
    assert got.user_factors.shape == (nu, rank)
    assert got.item_factors.shape == (ni, rank)
    np.testing.assert_allclose(
        got.user_factors.numpy(), np.asarray(want.user_factors), atol=2e-3
    )
    np.testing.assert_allclose(
        got.item_factors.numpy(), np.asarray(want.item_factors), atol=2e-3
    )


def test_fits_low_rank_data_and_modes_agree(ratings):
    # the RMSE bound of tests/test_als_ops.py:38
    nu, ni, ui, ii, r = ratings
    p = als.ALSParams(rank=5, num_iterations=15, scale_reg_with_count=False)
    fused = als.train_als(ui, ii, r, nu, ni, p, device="cpu")
    assert _rmse(fused.user_factors, fused.item_factors, ui, ii, r) < 0.05 * r.mean()
    assert als.LAST_PLAN_INFO["mode"] == "fused"  # auto on the CPU
    chunked = als.train_als(
        ui, ii, r, nu, ni, dataclasses.replace(p, pallas_mode="chunked"),
        device="cpu",
    )
    assert als.LAST_PLAN_INFO["mode"] == "chunked"
    np.testing.assert_allclose(
        chunked.user_factors.numpy(), fused.user_factors.numpy(), atol=1e-5
    )
    again = als.train_als(ui, ii, r, nu, ni, p, device="cpu")
    assert torch.equal(again.user_factors, fused.user_factors)


def test_stage_cache_reuses_the_staged_streams(ratings):
    nu, ni, ui, ii, r = ratings
    p = als.ALSParams(rank=3, num_iterations=1)
    als.train_als(ui, ii, r, nu, ni, p, device="cpu")
    staged = next(iter(als._STAGE_CACHE.values()))
    als.train_als(ui, ii, r, nu, ni, dataclasses.replace(p, reg=0.5), device="cpu")
    assert next(iter(als._STAGE_CACHE.values())) is staged
    als.train_als(ui[:-1], ii[:-1], r[:-1], nu, ni, p, device="cpu")
    assert len(als._STAGE_CACHE) == 1
    assert next(iter(als._STAGE_CACHE.values())) is not staged


def test_init_factors_are_seeded_and_padded():
    p = als.ALSParams(rank=4, seed=11)
    U, V = als._init_factors(p, 256, 128, 200, 100, "cpu")
    U2, _ = als._init_factors(p, 256, 128, 200, 100, "cpu")
    assert torch.equal(U, U2) and (U[:200] >= 0).all()
    assert not U[200:].any() and not V[100:].any()


def test_train_input_checks(ratings, monkeypatch):
    nu, ni, ui, ii, r = ratings
    with pytest.raises(ValueError, match="item ids"):
        als.train_als(ui, ii, r, nu, ni - 1, device="cpu")
    with pytest.raises(ValueError, match="init_factors"):
        als.train_als(ui, ii, r, nu, ni, als.ALSParams(rank=3), device="cpu",
                      init_factors=(np.zeros((nu, 4)), np.zeros((ni, 4))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailable):
        als.train_als(ui, ii, r, nu, ni)


class TestModeLadder:
    """Device-memory exhaustion degrades fused -> chunked; nothing else is
    caught."""

    def _run(self, monkeypatch, errors, mode="fused"):
        attempts = []

        def fake_mode(user_idx, item_idx, rating, nu, ni, p, device, m,
                      init_factors=None):
            attempts.append(m)
            if len(attempts) <= len(errors):
                raise errors[len(attempts) - 1]
            return "sentinel-state"

        monkeypatch.setattr(als, "_train_mode", fake_mode)
        out = als._train(
            np.zeros(4, np.int64), np.zeros(4, np.int64),
            np.ones(4, np.float32), 4, 4,
            als.ALSParams(rank=4, pallas_mode=mode), torch.device("cpu"),
        )
        return out, attempts

    def test_falls_back_on_oom(self, monkeypatch):
        with pytest.warns(RuntimeWarning, match="retrying as chunked"):
            out, attempts = self._run(
                monkeypatch, [torch.cuda.OutOfMemoryError("CUDA out of memory")]
            )
        assert out == "sentinel-state" and attempts == ["fused", "chunked"]

    def test_reraises_other_errors(self, monkeypatch):
        with pytest.raises(RuntimeError, match="genuine bug"):
            self._run(monkeypatch, [RuntimeError("genuine bug: out of memory")])

    def test_last_rung_reraises(self, monkeypatch):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            self._run(
                monkeypatch, [torch.cuda.OutOfMemoryError("oom")], mode="chunked"
            )

    def test_is_oom_error(self):
        assert als._is_oom_error(torch.cuda.OutOfMemoryError("x"))
        assert not als._is_oom_error(RuntimeError("CUDA out of memory"))
