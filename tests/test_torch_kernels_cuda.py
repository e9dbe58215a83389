"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports nothing of JAX, so it runs on
a GPU host that has none:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

On exact-arithmetic inputs (integers in [-8, 8] over 8, half-star ratings)
every score and every accumulated sum is exact in fp32 whatever the
summation order, so each kernel must be bitwise equal to its plain version,
ties and the ``limit`` mask included.  On random-normal inputs the fused
top-k agrees within rtol=1e-5 (cuBLAS sums in another order), and ids
wherever no near-tie makes the order ambiguous; the ALS accumulators agree
within 1e-4 of each entry's sum of absolute terms (the plain version adds
with atomics, in another order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import als, als_accum, topk

torch.set_num_threads(2)

CASES = {
    # name: (kind, B, N, r, k, duplicate rows (a, c), limit)
    "exact_small": ("exact", 20, 700, 6, 10, (), None),
    "exact_boundary_ties": (
        "exact", 300, 3000, 8, 32, ((0, 1024), (5, 1025), (10, 2999)), None,
    ),
    "exact_k128_r32": ("exact", 17, 900, 32, 128, (), None),
    "exact_k_not_pow2": ("exact", 9, 600, 5, 100, (), None),
    "all_equal": ("equal", 10, 2500, 4, 16, (), None),
    "all_equal_k128": ("equal", 3, 700, 4, 128, (), None),
    "limit_tail": ("exact", 12, 2048, 6, 20, (), 1500),
    "limit_below_k": ("exact", 5, 300, 6, 40, (), 17),
    "limit_zero": ("exact", 5, 300, 6, 40, (), 0),
    "k_equals_n": ("exact", 3, 45, 3, 45, (), None),
    "rank_one": ("exact", 9, 500, 1, 64, (), None),
    "normal_ml20m_wave": ("normal", 512, 26_744, 10, 10, (), None),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(kind, b, n, r, dups, seed):
    rng = np.random.default_rng(seed)
    if kind == "exact":
        q = rng.integers(-8, 9, (b, r)) / 8.0
        t = rng.integers(-8, 9, (n, r)) / 8.0
    elif kind == "normal":
        q = rng.standard_normal((b, r))
        t = rng.standard_normal((n, r))
    else:
        q, t = np.ones((b, r)), np.zeros((n, r))
    t = t.astype(np.float32)
    for a, c in dups:
        t[c] = t[a]
    return q.astype(np.float32), t


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_topk_kernel_matches_plain(cuda, case):
    kind, b, n, r, k, dups, limit = CASES[case]
    q, t = _inputs(kind, b, n, r, dups, seed=b + n + k)
    qd, td = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    got = topk.fused_topk_batch(qd, td, k, limit=limit)
    torch.cuda.synchronize()
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 1
    assert topk.LAST_KERNEL_SHAPES["fused_topk"]["route"] == "cuda"
    # one column more than k: the neighbour of the last position
    wider = topk.fused_topk_plain(qd, td, min(k + 1, n), n if limit is None else limit)
    got, wider = got.cpu().numpy(), wider.cpu().numpy()
    want = wider[:, :, :k]
    if kind == "normal":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        # ids may differ only where the plain scores nearly tie
        v = wider[0]
        tie = np.abs(np.diff(v, axis=1)) <= 1e-5 * np.abs(v[:, 1:])
        near = np.zeros(v.shape, bool)
        near[:, 1:] |= tie
        near[:, :-1] |= tie
        assert ((got[1] == want[1]) | near[:, :k]).all()
    else:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))


@pytest.mark.cuda
def test_off_menu_device_wave_raises_on_the_card(cuda):
    # num past the fused menu on a CUDA model: no host-replica answer and
    # no plain version on the card; it raises until a full-row kernel exists
    from predictionio_tpu_torch.models.recommendation import engine as rec

    rng = np.random.default_rng(5)
    model = rec.ALSModel.from_jax_params(
        {
            "user_factors": rng.standard_normal((40, 4)).astype(np.float32),
            "item_factors": rng.standard_normal((300, 4)).astype(np.float32),
            "user_vocab": np.array([f"u{i}" for i in range(40)]),
            "item_vocab": np.array([f"i{i}" for i in range(300)]),
        },
        cuda,
    )
    algo = rec.ALSAlgorithm()
    queries = list(
        enumerate(rec.Query(user=f"u{i % 40}", num=200) for i in range(520))
    )
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    with pytest.raises(topk.FusedTopKUnsupported, match="not ported"):
        algo.batch_predict(model, queries)
    with pytest.raises(topk.FusedTopKUnsupported, match="not ported"):
        algo.dispatch_batch(model, queries)
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before
    # on the menu, the same wave launches the kernel
    on_menu = [(i, rec.Query(user=q.user, num=10)) for i, q in queries]
    assert len(algo.batch_predict(model, on_menu)) == 520
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 1


@pytest.mark.cuda
def test_fused_topk_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.ones((4, 3), device=cuda)
    t = torch.ones((50, 3), device=cuda)
    geo = topk.kernel_geometry(4, 50, 3, topk._sm_count(q.device))
    with pytest.raises(TypeError):
        topk.fused_topk_cuda(q.double(), t.double(), 5, 50, geo)
    with pytest.raises(ValueError):
        topk.fused_topk_cuda(q, t.T.contiguous().T, 5, 50, geo)
    with pytest.raises(topk.FusedTopKUnsupported):
        topk.fused_topk_cuda(q, t, topk.MAX_FUSED_K + 1, 50, geo)


# -- the ALS segment accumulators (csrc/als_accum.cu) -----------------------


def _als_stream(kind, n, n_seg_pad, n_oth, k, seed, hot=0):
    """A COO stream for one direction: segments in [0, n_seg_pad - 128)
    (the last block stays empty: an all-padding tile), ``hot`` rows on one
    segment (a run across several tiles), factors and ratings either exact
    (multiples of 1/8, half stars) or random normal."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n_seg_pad - als_accum.S, n)
    seg[:hot] = 3
    oth = rng.integers(0, n_oth, n).astype(np.int32)
    if kind == "exact":
        factors = rng.integers(-8, 9, (n_oth, k)) / 8.0
        rating = rng.integers(1, 11, n) / 2.0
    else:
        factors = rng.standard_normal((n_oth, k))
        rating = rng.standard_normal(n)
    return seg, oth, rating.astype(np.float32), factors.astype(np.float32)


def _staged(seg, oth, rating, n_seg_pad, dev, mode="fused", tiles_per_chunk=1024):
    """The stream staged as ``train_als`` stages it (``ops.als._stage``)."""
    st = als._stage(seg, oth, rating, n_seg_pad, mode, dev, tiles_per_chunk)
    return st["plan"], st["plan_args"], st["oth"], st["rat"], st["val"]


def _hold(got, want, scale, exact, what):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if exact:
        bad = np.argwhere(got.view(np.uint32) != want.view(np.uint32))
        assert not len(bad), f"{what}: not bitwise equal at {bad[:3].tolist()}"
    else:
        err = np.abs(got - want)
        tol = 1e-4 * scale.cpu().numpy() + 1e-6
        assert (err <= tol).all(), f"{what}: max err {err.max()}"


ALS_CASES = [
    (kind, rank, implicit, precision)
    for kind in ("exact", "normal")
    for rank in (6, 10, 17, 32)
    for implicit in (False, True)
    for precision in ("highest", "bf16")
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,rank,implicit,precision", ALS_CASES,
    ids=["-".join(map(str, c)) for c in ALS_CASES],
)
def test_als_fused_accum_matches_plain(cuda, kind, rank, implicit, precision):
    n_seg_pad, n_oth = 512, 300
    seg, oth, rating, factors = _als_stream(
        kind, 9000, n_seg_pad, n_oth, rank, seed=rank, hot=3500
    )
    plan, args, oth_d, rat_d, val_d = _staged(seg, oth, rating, n_seg_pad, cuda)
    f = torch.from_numpy(factors).to(cuda)

    def run(fn, fac, rat):
        wrv = als_accum.make_wrv(rat, val_d, implicit, 1.5)
        return fn(args, oth_d, wrv, fac, plan.n_blocks, precision)

    before = als_accum.KERNEL_LAUNCHES["als_fused_accum"]
    got = run(als_accum.segment_stats_fused, f, rat_d)
    again = run(als_accum.segment_stats_fused, f, rat_d)
    torch.cuda.synchronize()
    assert als_accum.KERNEL_LAUNCHES["als_fused_accum"] == before + 2
    want = run(als_accum.segment_stats_fused_plain, f, rat_d)
    scale = run(als_accum.segment_stats_fused_plain, f.abs(), rat_d.abs())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _hold(got, want, scale, kind == "exact", f"fused {kind} r{rank}")
    # the hot segment spans more than 3 tiles; the last block is empty
    assert (plan.block_map == plan.n_blocks - 1).sum() == 1
    assert not got[-als_accum.S:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["exact", "normal"])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_als_segment_accum_across_chunks(cuda, kind, precision):
    n_seg_pad, n_oth, rank = 512, 200, 10
    seg, oth, rating, factors = _als_stream(
        kind, 9000, n_seg_pad, n_oth, rank, seed=7, hot=3500
    )
    plan, args, oth_d, rat_d, val_d = _staged(
        seg, oth, rating, n_seg_pad, cuda, "chunked", tiles_per_chunk=2
    )
    assert plan.n_chunks > 3
    assert rat_d.is_pinned()  # the chunked streams stay in host memory
    f = torch.from_numpy(factors).to(cuda)
    before = als_accum.KERNEL_LAUNCHES["als_segment_accum"]
    got = als_accum.segment_stats_chunked(
        args, oth_d, rat_d, val_d, f, True, 1.5, plan.n_blocks, precision
    )
    again = als_accum.segment_stats_chunked(
        args, oth_d, rat_d, val_d, f, True, 1.5, plan.n_blocks, precision
    )
    torch.cuda.synchronize()
    assert als_accum.KERNEL_LAUNCHES["als_segment_accum"] == before + 2 * plan.n_chunks
    want = als_accum.segment_stats_chunked_plain(
        args, oth_d, rat_d, val_d, f, True, 1.5, plan.n_blocks, precision
    )
    scale = als_accum.segment_stats_chunked_plain(
        args, oth_d, rat_d.abs(), val_d, f.abs(), True, 1.5, plan.n_blocks,
        precision,
    )
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _hold(got, want, scale, kind == "exact", f"chunked {kind}")


@pytest.mark.cuda
def test_als_train_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(0)
    nu, ni, k, n = 700, 300, 10, 20_000
    U = np.abs(rng.normal(size=(nu, k)))
    V = np.abs(rng.normal(size=(ni, k)))
    ui = rng.integers(0, nu, n).astype(np.int32)
    ii = rng.integers(0, ni, n).astype(np.int32)
    r = (U[ui] * V[ii]).sum(1).astype(np.float32)
    init = (
        (np.abs(rng.standard_normal((nu, k))) / np.sqrt(k)).astype(np.float32),
        (np.abs(rng.standard_normal((ni, k))) / np.sqrt(k)).astype(np.float32),
    )
    p = als.ALSParams(rank=k, num_iterations=5)
    for mode in ("fused", "chunked"):
        pm = dataclasses.replace(p, pallas_mode=mode)
        before = dict(als_accum.KERNEL_LAUNCHES)
        gpu = als.train_als(ui, ii, r, nu, ni, pm, device=cuda, init_factors=init)
        cpu = als.train_als(ui, ii, r, nu, ni, pm, device="cpu", init_factors=init)
        name = "als_fused_accum" if mode == "fused" else "als_segment_accum"
        assert als_accum.KERNEL_LAUNCHES[name] > before[name]
        for a, b in ((gpu.user_factors, cpu.user_factors),
                     (gpu.item_factors, cpu.item_factors)):
            assert a.device.type == "cuda"
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=2e-3)


@pytest.mark.cuda
def test_als_kernels_refuse_what_they_do_not_take(cuda):
    seg, oth, rating, factors = _als_stream("exact", 500, 256, 50, 4, seed=1)
    plan, args, oth_d, rat_d, val_d = _staged(seg, oth, rating, 256, cuda)
    wrv = als_accum.make_wrv(rat_d, val_d, False, 1.0)
    f = torch.from_numpy(factors).to(cuda)
    with pytest.raises(TypeError):
        als_accum.fused_accum_cuda(args, oth_d.long(), wrv, f, plan.n_blocks, "hilo")
    with pytest.raises(ValueError):
        als_accum.fused_accum_cuda(args, oth_d, wrv.cpu(), f, plan.n_blocks, "hilo")
    with pytest.raises(ValueError):
        als_accum.fused_accum_cuda(
            args, oth_d, wrv, torch.ones((50, 33), device=cuda), plan.n_blocks,
            "hilo",
        )
    with pytest.raises(ValueError):
        als_accum.fused_accum_cuda(args, oth_d, wrv, f, plan.n_blocks, "fp8")
    out = torch.zeros((256, 128), device=cuda)
    with pytest.raises(ValueError):
        als_accum.segment_accum_cuda(
            out, args[0], args[1], torch.zeros((5, 128), device=cuda)
        )
