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
import time

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
    # scores rise along the table: every row beats the running threshold,
    # so every queue fills and overflows into a merge, tile after tile
    "rising_k128": ("rising", 70, 5000, 8, 128, (), None),
    "rising_k1": ("rising", 70, 5000, 8, 1, (), None),
    "rising_k128_limit": ("rising", 33, 5000, 4, 128, (), 4000),
    # neither k nor r a multiple of 32 or of 4; a rank past 32
    "exact_k100_r33": ("exact", 40, 3000, 33, 100, (), None),
    "exact_k128_r64": ("exact", 64, 4000, 64, 128, ((0, 3999),), None),
    # a rank staged in three 64-column chunks, the last 2 wide
    "exact_k64_r130": ("exact", 40, 2000, 130, 64, ((5, 1999),), None),
}

NEW_CASES = ["rising_k128", "rising_k1", "rising_k128_limit", "exact_k100_r33",
             "exact_k128_r64", "exact_k64_r130"]

QUERY_BLOCKS = [8, 32]


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
    elif kind == "rising":
        # score of row j = q[:, 0] * j: exact, rising with j for every query
        q = np.zeros((b, r))
        q[:, 0] = rng.integers(1, 9, b) / 8.0
        t = np.zeros((n, r))
        t[:, 0] = np.arange(n)
    else:
        q, t = np.ones((b, r)), np.zeros((n, r))
    t = t.astype(np.float32)
    for a, c in dups:
        t[c] = t[a]
    return q.astype(np.float32), t


def _hold_to_plain(got, qd, td, kind, k, limit):
    """The kernel's packed output against the plain version's on the same
    card inputs: bitwise on exact inputs, within rtol 1e-5 on normal ones."""
    n = td.shape[0]
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
    _hold_to_plain(got, qd, td, kind, k, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("qpc", QUERY_BLOCKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_topk_both_query_blocks_match_plain(cuda, case, qpc):
    # the wrapper picks the query block by wave size; each instantiation
    # must answer every case
    kind, b, n, r, k, dups, limit = CASES[case]
    q, t = _inputs(kind, b, n, r, dups, seed=b + n + k)
    qd, td = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    geo = topk.cuda_geometry(b, n, r, k, cuda, qpc=qpc)
    got = topk.fused_topk_cuda(qd, td, k, n if limit is None else limit, geo)
    _hold_to_plain(got, qd, td, kind, k, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("qpc", QUERY_BLOCKS)
@pytest.mark.parametrize("k", [1, 64])
def test_fused_topk_many_due_queues_repeat_the_same_bits(cuda, k, qpc):
    # rising scores at B=32: every query's queue is due after every tile,
    # so all four warps merge at once, tile after tile; the merge step must
    # deal each due queue out once (every warp reads the counts before any
    # merge resets one), launch after launch
    b, n = 32, 6000
    q, t = _inputs("rising", b, n, 8, (), seed=k)
    qd, td = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    geo = topk.cuda_geometry(b, n, 8, k, cuda, qpc=qpc)
    for splits in (1, geo["n_splits"]):
        tiles = -(-geo["n_tiles"] // splits)
        one = dict(geo, n_splits=-(-geo["n_tiles"] // tiles),
                   rows_per_split=tiles * topk.TILE_ROWS_CUDA)
        first = topk.fused_topk_cuda(qd, td, k, n, one)
        _hold_to_plain(first, qd, td, "rising", k, None)
        for _ in range(60):
            again = topk.fused_topk_cuda(qd, td, k, n, one)
            assert torch.equal(first.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k,splits", [(4, 32), (4, 33), (64, 2), (64, 3), (1, 70)])
def test_fused_topk_pass_two_sort_and_merges_agree(cuda, k, splits):
    # pass 2 sorts all slab lists at once where n_splits * k <= 128 (k=4
    # over 32 slabs, k=64 over 2) and merges them list by list past it;
    # both must give the plain version's bits, ties across slabs included
    b, n = 40, splits * 64
    q, t = _inputs("exact", b, n, 6, ((0, n - 1), (1, n // 2), (2, 65)), seed=k + splits)
    qd, td = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    for qpc in QUERY_BLOCKS:
        geo = topk.cuda_geometry(b, n, 6, k, cuda, qpc=qpc)
        one = dict(geo, n_splits=splits, rows_per_split=topk.TILE_ROWS_CUDA)
        _hold_to_plain(topk.fused_topk_cuda(qd, td, k, n, one), qd, td, "exact", k, None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", NEW_CASES)
def test_fused_topk_kernel_repeats_the_same_bits(cuda, case):
    # survivors reach a queue in whatever order the shared-memory atomics
    # give; the k-best is a total order, so a repeat gives the same bits
    kind, b, n, r, k, dups, limit = CASES[case]
    q, t = _inputs(kind, b, n, r, dups, seed=b + n + k)
    qd, td = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    first = topk.fused_topk_batch(qd, td, k, limit=limit)
    for _ in range(3):
        again = topk.fused_topk_batch(qd, td, k, limit=limit)
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    # one slab (pass 1 writes the output) and many slabs (pass 2 merges)
    # give the same bits too
    lim = n if limit is None else limit
    for qpc, splits in ((8, 1), (32, 1), (8, "all"), (32, "all")):
        geo = topk.cuda_geometry(b, n, r, k, cuda, qpc=qpc)
        splits = geo["n_tiles"] if splits == "all" else splits
        tiles = -(-geo["n_tiles"] // splits)
        one = dict(geo, n_splits=-(-geo["n_tiles"] // tiles),
                   rows_per_split=tiles * topk.TILE_ROWS_CUDA)
        got = topk.fused_topk_cuda(qd, td, k, lim, one)
        assert torch.equal(first.view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
def test_off_menu_device_wave_answers_on_the_card(cuda, monkeypatch):
    # num past the fused menu on a CUDA model: answered on the card (full
    # score row, stable sort), equal to the CPU model's answer (the plain
    # version) on exact inputs, counted as a full-row dispatch; no host
    # replica, no kernel launch
    from predictionio_tpu_torch.models.recommendation import engine as rec

    rng = np.random.default_rng(5)
    persisted = {
        "user_factors": (rng.integers(1, 9, (40, 4)) / 8.0).astype(np.float32),
        "item_factors": (rng.integers(1, 9, (300, 4)) / 8.0).astype(np.float32),
        "user_vocab": np.array([f"u{i}" for i in range(40)]),
        "item_vocab": np.array([f"i{i}" for i in range(300)]),
    }
    model = rec.ALSModel.from_jax_params(persisted, cuda)
    cpu_model = rec.ALSModel.from_jax_params(persisted, "cpu")
    algo = rec.ALSAlgorithm()
    queries = list(
        enumerate(rec.Query(user=f"u{i % 40}", num=200) for i in range(520))
    )
    want = dict(algo.batch_predict(cpu_model, queries))

    def no_host_replica():
        raise AssertionError("an off-menu device wave read the host replica")

    def no_plain_version(*args):
        raise AssertionError("an off-menu device wave called the plain version")

    monkeypatch.setattr(model, "host_factors", no_host_replica)
    monkeypatch.setattr(topk, "fused_topk_plain", no_plain_version)
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    counted = topk.FULL_ROW_FALLBACKS.get("als.batch_topk", 0)
    got = dict(algo.batch_predict(model, queries))
    finalize = algo.dispatch_batch(model, queries)
    assert finalize is not None
    dispatched = dict(finalize())
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before
    assert topk.FULL_ROW_FALLBACKS["als.batch_topk"] == counted + 2
    for i in range(520):
        pairs = [(s.item, s.score) for s in want[i].item_scores]
        assert len(pairs) == 200
        assert [(s.item, s.score) for s in got[i].item_scores] == pairs, i
        assert [(s.item, s.score) for s in dispatched[i].item_scores] == pairs, i
    # on the menu, the same wave launches the kernel
    on_menu = [(i, rec.Query(user=q.user, num=10)) for i, q in queries]
    assert len(algo.batch_predict(model, on_menu)) == 520
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", [(700, 26_744, 200), (37, 3000, 129)])
def test_full_row_topk_on_the_card_equals_the_cpu(cuda, b, n, k, monkeypatch):
    # the off-menu route on the card (its own body: it never calls the
    # plain version there) against the plain version on the CPU.  Exact
    # inputs, whole and in slices of 64 queries: bitwise, ties included.
    # Random-normal inputs: within 1e-5 (TF32's 10-bit products would miss
    # by ~1e-3), ids wherever no near tie makes the order ambiguous.
    qe, te = _inputs("exact", b, n, 8, ((0, n - 1), (3, n // 2)), seed=b + k)
    qn, tn = _inputs("normal", b, n, 8, (), seed=b + k + 1)
    want_e, want_n = (
        topk.fused_topk_plain(torch.from_numpy(x), torch.from_numpy(y), k + 1, n)
        for x, y in ((qe, te), (qn, tn))
    )
    monkeypatch.setattr(topk, "fused_topk_plain", None)
    qd, td = torch.from_numpy(qe).to(cuda), torch.from_numpy(te).to(cuda)
    for x in (topk.full_row_sliced(qd, td, k, 64),
              topk.full_row_topk(qd, td, k, where="test.card")):
        x = x.cpu()
        assert torch.equal(x[1], want_e[1, :, :k])
        assert torch.equal(x[0].view(torch.int32), want_e[0, :, :k].view(torch.int32))
    qd, td = torch.from_numpy(qn).to(cuda), torch.from_numpy(tn).to(cuda)
    got = topk.full_row_topk(qd, td, k, where="test.card").cpu().numpy()
    wider = want_n.numpy()
    np.testing.assert_allclose(got[0], wider[0, :, :k], rtol=1e-5, atol=1e-6)
    v = wider[0]
    tie = np.abs(np.diff(v, axis=1)) <= 1e-5 * np.abs(v[:, 1:])
    near = np.zeros(v.shape, bool)
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    assert ((got[1] == wider[1, :, :k]) | near[:, :k]).all()


@pytest.mark.cuda
def test_fused_topk_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.ones((4, 3), device=cuda)
    t = torch.ones((50, 3), device=cuda)
    geo = topk.cuda_geometry(4, 50, 3, 5, cuda)
    with pytest.raises(TypeError):
        topk.fused_topk_cuda(q.double(), t.double(), 5, 50, geo)
    with pytest.raises(ValueError):
        topk.fused_topk_cuda(q, t.T.contiguous().T, 5, 50, geo)
    with pytest.raises(topk.FusedTopKUnsupported):
        topk.fused_topk_cuda(q, t, topk.MAX_FUSED_K + 1, 50, geo)
    # the library refuses a query block it is not built for, and a slab
    # that is not whole tiles
    for bad in (dict(geo, queries_per_cta=16), dict(geo, rows_per_split=100)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            topk.fused_topk_cuda(q, t, 5, 50, bad)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "r,k,qpc,smem",
    # counted by hand from csrc/fused_topk.cu's layout (the count in
    # tests/test_torch_topk.py::_smem_by_hand)
    [(10, 10, 32, 47_616), (10, 10, 8, 19_584), (32, 128, 32, 93_184),
     (32, 128, 8, 40_192), (33, 100, 32, 86_016), (130, 64, 8, 55_552),
     (1, 1, 8, 14_656), (996, 128, 32, 232_448), (997, 128, 32, 233_472)],
)
def test_fused_topk_smem_counted_by_the_library(cuda, r, k, qpc, smem):
    assert topk.kernel_smem_bytes(r, k, qpc) == smem
    assert topk.kernel_smem_bytes(r, k, 16) == -1
    assert topk.kernel_smem_bytes(r, topk.MAX_FUSED_K + 1, qpc) == -1
    card = topk.card_limits(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert card.sm_count == props.multi_processor_count
    # an H100 lets one CTA opt into 227 KB of the SM's 228 KB; 1 KB each
    # is the system's
    if "H100" in props.name:
        assert (card.smem_per_cta, card.smem_per_sm, card.smem_reserved) == (
            232_448, 233_472, 1024
        )


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
    # 8: the pio eval sweep's smaller rank
    for rank in (6, 8, 10, 17, 32)
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


SMALL_RANK_CASES = [
    (kind, rank, precision)
    for kind in ("exact", "normal")
    for rank in (1, 2, 11)
    for precision in ("highest", "bf16")
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,rank,precision", SMALL_RANK_CASES,
    ids=["-".join(map(str, c)) for c in SMALL_RANK_CASES],
)
def test_als_fused_accum_at_block_edges(cuda, kind, rank, precision):
    # ranks where the Gram of u = [v, 1] ends just inside or just past a
    # 4-wide block (k + 1 = 2, 3, 12): the count's block, the rhs column
    # and the masked lanes; many row groups, a hot segment over 4 tiles
    n_seg_pad, n_oth = 640, 250
    seg, oth, rating, factors = _als_stream(
        kind, 12_000, n_seg_pad, n_oth, rank, seed=100 + rank, hot=4000
    )
    plan, args, oth_d, rat_d, val_d = _staged(seg, oth, rating, n_seg_pad, cuda)
    f = torch.from_numpy(factors).to(cuda)
    for implicit in (False, True):
        def run(fn, fac, rat):
            wrv = als_accum.make_wrv(rat, val_d, implicit, 1.5)
            return fn(args, oth_d, wrv, fac, plan.n_blocks, precision)

        got = run(als_accum.segment_stats_fused, f, rat_d)
        again = run(als_accum.segment_stats_fused, f, rat_d)
        torch.cuda.synchronize()
        want = run(als_accum.segment_stats_fused_plain, f, rat_d)
        scale = run(als_accum.segment_stats_fused_plain, f.abs(), rat_d.abs())
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        _hold(got, want, scale, kind == "exact", f"fused {kind} r{rank}")
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


def _boundary_stream(kind, k, seed):
    """A stream whose runs end everywhere kernel 2 can cut a tile (its
    groups of 4 and 8 rows): block 0 holds segment 3 over 3,500 rows (more
    than 3 tiles, two of them one run from first row to last); blocks 1-9 each open with one run of
    1 + 115 (b - 1) rows followed by 127 one-row segments, so between them
    a run boundary falls at every row of a tile, each group boundary and its
    neighbours included; block 10 is empty (an all-padding tile); block 11
    is random."""
    rng = np.random.default_rng(seed)
    seg = [np.full(3500, 3), rng.integers(0, 128, 300)]
    for b in range(1, 10):
        seg += [np.full(1 + 115 * (b - 1), 128 * b), 128 * b + np.arange(1, 128)]
    seg.append(rng.integers(11 * 128, 12 * 128, 600))
    seg = rng.permutation(np.concatenate(seg))
    n, n_oth = len(seg), 300
    oth = rng.integers(0, n_oth, n).astype(np.int32)
    if kind == "exact":
        factors = rng.integers(-8, 9, (n_oth, k)) / 8.0
        rating = rng.integers(1, 11, n) / 2.0
    else:
        factors = rng.standard_normal((n_oth, k))
        rating = rng.standard_normal(n)
    return seg, oth, rating.astype(np.float32), factors.astype(np.float32), 12 * 128


WIDTH_CASES = [
    (kind, rank, precision)
    for kind in ("exact", "normal")
    for rank in (1, 10, 11, 17, 32)  # widths 128, 128, 256, 384, 1,152
    for precision in ("highest", "bf16")
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,rank,precision", WIDTH_CASES,
    ids=["-".join(map(str, c)) for c in WIDTH_CASES],
)
def test_als_segment_accum_at_every_width(cuda, kind, rank, precision):
    # kernel 2 against its plain version chunk by chunk (3-tile chunks, so
    # blocks cross chunks), on runs that end at every row of a tile; then a
    # chunk of filler tiles only, which must leave the output as it was
    seg, oth, rating, factors, n_seg_pad = _boundary_stream(kind, rank, seed=rank)
    plan, args, oth_d, rat_d, val_d = _staged(
        seg, oth, rating, n_seg_pad, cuda, "chunked", tiles_per_chunk=3
    )
    assert plan.n_chunks > 3 and plan.tiles_per_chunk == 3
    f = torch.from_numpy(factors).to(cuda)

    def chunked(fn, fac, rat):
        return fn(args, oth_d, rat, val_d, fac, True, 1.5, plan.n_blocks, precision)

    before = als_accum.KERNEL_LAUNCHES["als_segment_accum"]
    got = chunked(als_accum.segment_stats_chunked, f, rat_d)
    again = chunked(als_accum.segment_stats_chunked, f, rat_d)
    torch.cuda.synchronize()
    assert als_accum.KERNEL_LAUNCHES["als_segment_accum"] == before + 2 * plan.n_chunks
    assert got.shape == (n_seg_pad, als_accum.row_width(rank))
    want = chunked(als_accum.segment_stats_chunked_plain, f, rat_d)
    scale = chunked(als_accum.segment_stats_chunked_plain, f.abs(), rat_d.abs())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _hold(got, want, scale, kind == "exact", f"chunked {kind} r{rank}")
    assert not got[10 * als_accum.S:11 * als_accum.S].any()  # the empty block

    width = als_accum.row_width(rank)
    filler = (torch.zeros(3, dtype=torch.int32, device=cuda),
              torch.full((3, 8, 128), -1, dtype=torch.int32, device=cuda))
    rows = torch.randn((3 * als_accum.T, width), device=cuda)
    out = got.clone()
    als_accum.segment_accum_cuda(out, *filler, rows, precision)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), got.view(torch.int32))


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


def _card_deploy(cuda, tmp_path, rng, n_users, n_items, rank):
    """A seeded ALS model persisted as a COMPLETED instance and deployed on
    the card: (U, V, storage, deployed)."""
    from datetime import datetime, timezone

    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.server import prediction_server as ps

    U = rng.standard_normal((n_users, rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    storage = StorageRuntime(
        StorageConfig.from_env({"PIO_HOME": str(tmp_path / "pio_home")})
    )
    params = EngineParams(algorithms=(("als", rec.ALSAlgorithmParams(rank=rank)),))
    now = datetime.now(tz=timezone.utc)
    storage.engine_instances().insert(
        EngineInstance(
            id="card", status="COMPLETED", start_time=now, end_time=now,
            engine_id="default", engine_version="default",
            engine_variant="default", engine_factory="recommendation",
            **params.to_json_fields(),
        )
    )
    save_models(storage.models(), "card", [{
        "user_factors": U, "item_factors": V,
        "user_vocab": np.array([f"u{i}" for i in range(n_users)]),
        "item_vocab": np.array([f"i{i}" for i in range(n_items)]),
    }])
    deployed = ps.deploy_engine("recommendation", storage=storage, device=cuda)
    return U, V, storage, deployed


def _burst(batcher, payloads, metas):
    """Every payload queued at once (the batcher's condition held while the
    burst enqueues), then the answers in order."""
    import asyncio

    from predictionio_tpu_torch.server.prediction_server import QueuedQuery

    async def burst():
        with batcher._cond:
            futs = [asyncio.ensure_future(batcher.submit(QueuedQuery(p), m))
                    for p, m in zip(payloads, metas)]
            await asyncio.sleep(0)
        return await asyncio.gather(*futs)

    return asyncio.run(asyncio.wait_for(burst(), timeout=120))


@pytest.mark.cuda
def test_pipelined_batcher_device_waves_on_the_card(cuda, tmp_path):
    # 1,024 queries queued at once through the deploy's micro-batcher of
    # 512-query waves: two device waves, each one fused top-k launch,
    # dispatched on the worker and fenced on the finalizer; the answers
    # held to the host replica (scores within 1e-5, ids outside near ties)
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import prediction_server as ps

    rng = np.random.default_rng(11)
    n_users, num = 700, 10
    U, V, storage, deployed = _card_deploy(cuda, tmp_path, rng, n_users, 3000, 8)
    app = ps.create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=512, pipeline_depth=2,
        max_queue=0, registry=MetricsRegistry(),
    )
    batcher = app.microbatcher
    users = rng.integers(0, n_users, 1024)
    metas = [{} for _ in users]
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    try:
        results = _burst(
            batcher, [{"user": f"u{u}", "num": num} for u in users], metas
        )
    finally:
        batcher.close()
        storage.close()
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 2
    assert sorted({m["wave_seq"] for m in metas}) == [1, 2]
    assert all(m["pipelined"] and m["wave_size"] == 512 for m in metas)
    assert deployed.inflight_snapshot() == {}
    # one more than num: the neighbour of the last position
    want_s, want_i = topk.host_topk_batch(U[users] @ V.T, num + 1)
    for row, (status, body, iid) in enumerate(results):
        assert (status, iid) == ("ok", "card")
        got_i = [int(x["item"][1:]) for x in body["itemScores"]]
        got_s = np.asarray([x["score"] for x in body["itemScores"]])
        w = want_s[row]
        np.testing.assert_allclose(got_s, w[:num], rtol=1e-5, atol=1e-6)
        for j in np.flatnonzero(np.asarray(got_i) != want_i[row, :num]):
            gap = min(abs(w[j] - w[x]) for x in (j - 1, j + 1) if 0 <= x <= num)
            assert gap <= 1e-5 * abs(w[j]) + 1e-6, (row, j)


@pytest.mark.cuda
def test_pipelined_wave_kernel_time_is_the_cards_own(cuda, tmp_path):
    # four 512-query device waves through the deploy's pipelined batcher:
    # each wave's CUDA-event time (the kernel's, from the events its
    # launcher records) is at or above the
    # kernel's least-work bound at the card's peak row, its five-way host
    # split sums to its device_s, the pipeline still overlaps (a wave
    # enqueued behind another), and the roofline share read from those
    # times stays in (0, 1.05]
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import prediction_server as ps
    from predictionio_tpu_torch.server.microbatch import PendingWave

    rng = np.random.default_rng(13)
    n_users, n_items, rank, num = 3000, 20_000, 10, 10
    _, _, storage, deployed = _card_deploy(cuda, tmp_path, rng, n_users, n_items, rank)
    app = ps.create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=512, pipeline_depth=2,
        max_queue=0, registry=MetricsRegistry(),
    )
    batcher = app.microbatcher
    dispatch = batcher.batch_fn

    def paused_fence(items):
        # each fence starts after a pause, so the worker's next waves are
        # enqueued behind an unfenced one: the overlap is certain, not a
        # race between the two host threads
        out = dispatch(items)
        if not isinstance(out, PendingWave):
            return out
        fence = out.finalize

        def finalize():
            time.sleep(0.05)
            return fence()

        return PendingWave(finalize)

    batcher.batch_fn = paused_fence
    users = rng.integers(0, n_users, 2048)
    metas = [{} for _ in users]
    try:
        results = _burst(
            batcher, [{"user": f"u{u}", "num": num} for u in users], metas
        )
    finally:
        app.microbatcher.close()
        storage.close()
    assert {r[0] for r in results} == {"ok"}
    waves = {m["wave_seq"]: m for m in metas}
    assert len(waves) == 4
    peaks = device_obs.device_peaks()
    work = topk.fused_topk_least_work(512, rank, n_items, num)
    bound_s = max(work["bytes"] / (peaks.hbm_gbps * 1e9),
                  work["flops"] / (peaks.tflops * 1e12))
    for m in waves.values():
        assert m["wave_fn"] == "als.fused_topk" and m["wave_device"] == "cuda:0"
        assert m["wave_kernel_s"] >= bound_s, (m["wave_kernel_s"], bound_s)
        split = m["device_breakdown"]
        assert abs(sum(split.values()) - m["device_s"]) <= 0.01 * m["device_s"]
        assert m["wave_transfers"] == {"h2d": 512 * 8, "d2h": 2 * 512 * num * 4}
    assert any(m["pipelined"] and m["inflight_depth"] == 2 for m in waves.values())
    util = device_obs.default_efficiency().snapshot()["functions"]["als.fused_topk"]
    assert 0 < util["utilization_hbm"] <= 1.05
    assert 0 < util["utilization_mxu"] <= 1.05


@pytest.mark.cuda
def test_launcher_timing_events_leave_out_host_gaps(cuda):
    # the timing pair the launcher records brackets its passes alone: a
    # host pause before the launch shows in a pair recorded from Python
    # around it, and not in the launcher's
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((512, 10)).astype(np.float32)).cuda()
    t = torch.from_numpy(rng.standard_normal((20_000, 10)).astype(np.float32)).cuda()
    geo = topk.cuda_geometry(512, 20_000, 10, 10, q.device)
    topk.fused_topk_cuda(q, t, 10, 20_000, geo)  # built and warm
    torch.cuda.synchronize()
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    inner = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    outer[0].record()
    time.sleep(0.05)
    got = topk.fused_topk_cuda(q, t, 10, 20_000, geo, timing=inner)
    outer[1].record()
    torch.cuda.synchronize()
    kernel_ms = inner[0].elapsed_time(inner[1])
    span_ms = outer[0].elapsed_time(outer[1])
    assert 0 < kernel_ms < 10, kernel_ms
    assert span_ms >= 45 and span_ms - kernel_ms >= 40, (span_ms, kernel_ms)
    _hold_to_plain(got, q, t, "normal", 10, None)


@pytest.mark.cuda
def test_failing_device_wave_answers_500_on_the_card(cuda, tmp_path, monkeypatch):
    # the fused top-k raising on every call, as under a sticky CUDA error:
    # a 512-query device wave bisects on the card down to single queries,
    # each an error, and a single HTTP query (the device floor lowered to
    # 1) answers 500; neither the host replica nor the plain version is
    # ever read
    import http.client
    import json

    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import prediction_server as ps
    from predictionio_tpu_torch.server.aio import AsyncAppServer

    rng = np.random.default_rng(12)
    _, _, storage, deployed = _card_deploy(cuda, tmp_path, rng, 600, 3000, 8)
    reads, calls = [], []

    def no_host_replica():
        reads.append(1)
        raise AssertionError("a device wave read the host replica")

    def sticky(q, t, k, **kw):
        assert q.device.type == "cuda" and t.device.type == "cuda"
        calls.append(q.shape[0])
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(deployed.models[0], "host_factors", no_host_replica)
    monkeypatch.setattr(topk, "fused_topk_plain", None)
    monkeypatch.setattr(rec, "fused_topk_batch", sticky)
    app = ps.create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=512, max_queue=0,
        registry=MetricsRegistry(),
    )
    server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
    try:
        results = _burst(
            app.microbatcher,
            [{"user": f"u{u}", "num": 10} for u in rng.integers(0, 600, 512)],
            [None] * 512,
        )
        n_burst = len(calls)
        monkeypatch.setattr(rec.ALSAlgorithm, "DEVICE_BATCH_MIN", 1)
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        conn.request("POST", "/queries.json", json.dumps({"user": "u1", "num": 10}))
        resp = conn.getresponse()
        status, body = resp.status, json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        storage.close()
    assert {r[0] for r in results} == {"err"}
    assert all("illegal memory access" in str(r[1]) for r in results)
    # the wave's dispatch, then its bisection on the card: 1,023 dispatches
    # down to its 512 single queries; then the HTTP query and its retry
    assert n_burst == 1 + 1023 and calls[:2] == [512, 512]
    assert calls[:n_burst].count(1) == 512 and calls[n_burst:] == [1, 1]
    assert status == 500 and "illegal memory access" in body["message"]
    assert reads == [] and deployed.inflight_snapshot() == {}


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
    nt = args[0].shape[0]
    rows = torch.zeros((nt * als_accum.T, 128), device=cuda)
    # a width that is not whole 128-column slabs
    with pytest.raises(ValueError, match="shapes"):
        als_accum.segment_accum_cuda(
            torch.zeros((256, 100), device=cuda), args[0], args[1],
            torch.zeros((nt * als_accum.T, 100), device=cuda),
        )
    # rows that are not contiguous, and rows off 16-byte alignment
    with pytest.raises(ValueError, match="contiguous"):
        als_accum.segment_accum_cuda(
            out, args[0], args[1],
            torch.zeros((nt * als_accum.T, 256), device=cuda)[:, ::2],
        )
    with pytest.raises(ValueError, match="aligned"):
        als_accum.segment_accum_cuda(
            out, args[0], args[1],
            torch.zeros(nt * als_accum.T * 128 + 1, device=cuda)[1:].view(-1, 128),
        )
    # an output off 16-byte alignment (the kernel adds into it 16 bytes at
    # a time)
    with pytest.raises(ValueError, match="aligned"):
        als_accum.segment_accum_cuda(
            torch.zeros(256 * 128 + 1, device=cuda)[1:].view(256, 128),
            args[0], args[1], rows,
        )
    # an output on another device than the rows
    with pytest.raises(ValueError, match="cpu"):
        als_accum.segment_accum_cuda(out.cpu(), args[0], args[1], rows)
    # every refusal came before a launch; the same call on good inputs runs
    before = als_accum.KERNEL_LAUNCHES["als_segment_accum"]
    als_accum.segment_accum_cuda(out, args[0], args[1], rows)
    assert als_accum.KERNEL_LAUNCHES["als_segment_accum"] == before + 1


# -- kernel 1 at rank 32 on an implicit stream, and NCF on the card ---------


@pytest.mark.cuda
def test_als_fused_accum_rank32_implicit_train_matches_the_cpu(cuda):
    """Kernel 1 at rank 32 on an implicit stream shaped like NCF's ALS
    pretrain (all ones, Zipf items, a heavy user spanning many tiles): each
    half-step held to the plain version, then 5 iterations on the card
    within 2e-3 of the same train on the CPU."""
    rng = np.random.default_rng(32)
    nu, ni, n = 2000, 900, 120_000
    item_cdf = np.cumsum((np.arange(ni) + 10.0) ** -0.8)
    ii = np.minimum(np.searchsorted(item_cdf / item_cdf[-1], rng.random(n)),
                    ni - 1).astype(np.int32)
    ui = rng.integers(0, nu, n).astype(np.int32)
    ui[:9000] = 7
    ones = np.ones(n, np.float32)
    p = als.ALSParams(rank=32, num_iterations=5, reg=0.01, implicit_prefs=True,
                      alpha=2.0, pallas_mode="fused")
    nu_pad = (nu + 127) // 128 * 128
    plan, args, oth_d, rat_d, val_d = _staged(ui, ii, ones, nu_pad, cuda)
    f = torch.from_numpy(rng.standard_normal((ni, 32)).astype(np.float32)).to(cuda)
    wrv = als_accum.make_wrv(rat_d, val_d, True, 2.0)
    before = als_accum.KERNEL_LAUNCHES["als_fused_accum"]
    got = als_accum.segment_stats_fused(args, oth_d, wrv, f, plan.n_blocks, "hilo")
    assert als_accum.KERNEL_LAUNCHES["als_fused_accum"] == before + 1
    want = als_accum.segment_stats_fused_plain(args, oth_d, wrv, f, plan.n_blocks, "hilo")
    scale = als_accum.segment_stats_fused_plain(
        args, oth_d, wrv.abs(), f.abs(), plan.n_blocks, "hilo")
    _hold(got, want, scale, False, "fused implicit r32")
    gpu = als.train_als(ui, ii, ones, nu, ni, p, device=cuda)
    cpu = als.train_als(ui, ii, ones, nu, ni, p, device="cpu")
    for a, b in ((gpu.user_factors, cpu.user_factors),
                 (gpu.item_factors, cpu.item_factors)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("loss,mlp", [("bpr", (64, 32, 16)), ("full_softmax", ())])
def test_ncf_step_on_the_card_matches_the_cpu(cuda, loss, mlp):
    """One NCF step (forward, loss, autograd, Adam/AdamW) on the card from
    the CPU's parameters, batch and negatives: the loss within 1e-5, each
    gradient entry within 1e-4 of its leaf's largest (1,024 float32 terms
    summed in another order, which cancel in a bias under ReLU masks), and
    the parameters
    equal to the CPU's optimizer replayed from the card's gradient within
    1e-6 * (1 + |p|) (replayed: below Adam's eps the step is lr * g / eps,
    1e5 times the gradient's rounding)."""
    from predictionio_tpu_torch.ops import ncf

    p = ncf.NCFParams(embed_dim=32, mlp_layers=mlp, loss=loss,
                      weight_decay=1e-4 if loss == "full_softmax" else 0.0)
    rng = np.random.default_rng(1)
    nu, ni, b = 3000, 1500, 1024
    base = ncf.init_ncf(torch.Generator().manual_seed(0), nu, ni, p)
    u = torch.from_numpy(rng.integers(0, nu, b))
    pos = torch.from_numpy(rng.integers(0, ni, b))
    neg = torch.from_numpy(rng.integers(0, ni, (b, 1)))
    valid, w = torch.ones(b), torch.zeros(b)

    def fresh(dev):
        params = ncf.tree_map(lambda x: x.clone().to(dev).requires_grad_(True), base)
        return params, ncf.make_optimizer(params, p)

    out = {}
    for dev in ("cpu", cuda):
        params, opt = fresh(dev)
        loss_v = ncf.train_step(params, opt, u.to(dev), pos.to(dev), neg.to(dev),
                                valid.to(dev), w.to(dev), p, ni)
        out[str(dev)] = (float(loss_v), ncf.host_params(params),
                         ncf.tree_map(lambda x: x.grad.cpu().numpy(), params))
    (l_cpu, _, g_cpu), (l_gpu, p_gpu, g_gpu) = out["cpu"], out[str(cuda)]
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    replay, opt = fresh("cpu")
    for leaf, g in zip(ncf.tree_leaves(replay), ncf.tree_leaves(g_gpu)):
        leaf.grad = torch.from_numpy(g)
    opt.step()
    replay = ncf.host_params(replay)
    for gc, gg, pr, pg in zip(*(ncf.tree_leaves(t) for t in (g_cpu, g_gpu, replay, p_gpu))):
        assert np.abs(gg - gc).max() <= 1e-4 * (np.abs(gc).max() or 1.0)
        assert (np.abs(pg - pr) <= 1e-6 * (1.0 + np.abs(pr))).all()


@pytest.mark.cuda
def test_ncf_device_wave_on_the_card_matches_the_host_replica(cuda):
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.ncf import engine as ncf_engine
    from predictionio_tpu_torch.models.recommendation.engine import Query
    from predictionio_tpu_torch.ops import ncf

    p = ncf.NCFParams(embed_dim=32)
    nu, ni = 500, 3000
    params = ncf.init_ncf(torch.Generator().manual_seed(2), nu, ni, p)
    params["item_bias"] = torch.randn(ni, generator=torch.Generator().manual_seed(3))
    blob = {"params": ncf.host_params(params), "n_users": nu, "n_items": ni,
            "config": dataclasses.asdict(p),
            "user_vocab": BiMap.from_keys(np.array([f"u{i}" for i in range(nu)])).to_state(),
            "item_vocab": BiMap.from_keys(np.array([f"i{i}" for i in range(ni)])).to_state()}
    algo = ncf_engine.NCFAlgorithm()
    model = algo.load_persistent_model(EngineContext(device=cuda), blob)
    queries = [(j, Query(user=f"u{j * 7 % nu}", num=10)) for j in range(32)]
    got = dict(algo.dispatch_batch(model, queries)())
    for j, q in queries:
        host = algo.predict(model, q)
        np.testing.assert_allclose([s.score for s in got[j].item_scores],
                                   [s.score for s in host.item_scores], rtol=1e-5)
        hs = [s.score for s in host.item_scores]
        for a, b, s in zip(got[j].item_scores, host.item_scores, hs):
            assert a.item == b.item or min(abs(s - x) for x in hs if x != s) <= 1e-5 * abs(s)


#: two NCF waves and one NCF step on the card under a torch.profiler capture
#: of host and card, in a process of its own (a capture in the pytest
#: process would be one more before the profiler tests that count on
#: theirs): prints the ranges seen, the device operations named as a span,
#: and the capture's totals
_SPAN_CAPTURE_SCRIPT = r'''
import dataclasses, json
import numpy as np, torch
from torch.autograd import DeviceType
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.ncf import engine as ncf_engine
from predictionio_tpu_torch.models.recommendation.engine import Query
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.ops import ncf

cuda = torch.device("cuda")
p = ncf.NCFParams(embed_dim=32, batch_size=1024)
nu, ni, b = 500, 3000, 1024
params = ncf.init_ncf(torch.Generator().manual_seed(2), nu, ni, p)
blob = {"params": ncf.host_params(params), "n_users": nu, "n_items": ni,
        "config": dataclasses.asdict(p),
        "user_vocab": BiMap.from_keys(np.array([f"u{i}" for i in range(nu)])).to_state(),
        "item_vocab": BiMap.from_keys(np.array([f"i{i}" for i in range(ni)])).to_state()}
algo = ncf_engine.NCFAlgorithm()
model = algo.load_persistent_model(EngineContext(device=cuda), blob)
queries = [(j, Query(user=f"u{j}", num=10)) for j in range(2 * algo.MAX_WAVE)]
algo.batch_predict(model, queries)  # warm
train = ncf.tree_map(lambda x: x.clone().to(cuda).requires_grad_(True), params)
opt = ncf.make_optimizer(train, p)
rng = np.random.default_rng(3)
u, pos = (torch.from_numpy(rng.integers(0, n, b)).to(cuda) for n in (nu, ni))
neg = torch.from_numpy(rng.integers(0, ni, (b, 4))).to(cuda)
valid, w = torch.ones(b, device=cuda), torch.zeros(b, device=cuda)
tracing.clear_capture_totals()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    answered = len(algo.batch_predict(model, queries))
    ncf.train_step(train, opt, u, pos, neg, valid, w, p, ni)
    torch.cuda.synchronize()
host, device = set(), set()
for e in prof.profiler.kineto_results.events():
    (device if e.device_type() == DeviceType.CUDA else host).add(e.name())
print(json.dumps({"answered": answered, "host": sorted(host),
                  "device": sorted(device), "totals": tracing.capture_totals()}))
'''


@pytest.mark.cuda
def test_a_capture_on_the_card_names_the_wave_and_times_the_step(cuda):
    """Two NCF waves on the card mark every wave stage (``launch`` and
    ``h2d`` only a card wave has) as host ranges and totals; one NCF
    step's three phases read device time from their CUDA events; no span
    shows on the device timeline (where a ``record_function`` user
    annotation would add its kernels' time again)."""
    import json
    import os
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", _SPAN_CAPTURE_SCRIPT],
        capture_output=True, text=True, timeout=600, env=dict(os.environ),
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["answered"] == 64
    stages = ("h2d", "launch", "compute", "d2h", "render", "host_gather")
    phases = ("ncf.step.forward", "ncf.step.backward", "ncf.step.optimizer")
    wanted = {f"wave.{s}" for s in stages} | {"wave.observe"} | set(phases)
    assert wanted <= set(got["host"]), wanted - set(got["host"])
    assert not wanted & set(got["device"]), wanted & set(got["device"])
    totals = got["totals"]
    for s in stages:
        assert totals[f"wave.{s}"]["count"] == 2, (s, totals)
    assert totals["wave.observe"]["count"] == 4
    for ph in phases:
        assert totals[ph]["count"] == 1 and totals[ph]["device_s"] > 0, totals


def _covtype_like(n, f=54, c=7, seed=0):
    """Binary features whose per-class probabilities plant the classes."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    p = np.clip(rng.uniform(0.05, 0.4, f) * np.exp(
        0.3 * rng.standard_normal((c, f))), 0.01, 0.9)
    return (rng.random((n, f)) < p[y]).astype(np.float32), y, c


@pytest.mark.cuda
def test_classifiers_train_the_same_bits_twice_on_the_card(cuda):
    """Two trains of the same data on the card give the same bits (no
    float atomics in the statistics or the gradient), and agree with the
    CPU: NB exactly before the log (integer sums below 2^24), logreg
    within 1e-4 of each tensor's largest value."""
    from predictionio_tpu_torch.ops import classifiers as cls

    x, y, c = _covtype_like(60_000)
    xd = torch.from_numpy(x).to(cuda)
    runs = [
        cls.train_naive_bayes(xd, y, c) + cls.train_logistic_regression(
            xd, y, c, learning_rate=0.1, num_iterations=50)
        for _ in range(2)
    ]
    for a, b in zip(*runs):
        assert a.device.type == "cuda" and torch.equal(a, b)
    host = cls.train_naive_bayes(
        x, y, c, device="cpu"
    ) + cls.train_logistic_regression(
        x, y, c, learning_rate=0.1, num_iterations=50, device="cpu")
    pi, theta, w, b = (t.cpu() for t in runs[0])
    assert (pi - host[0]).abs().max() <= 1e-5
    assert (theta - host[1]).abs().max() <= 1e-5
    assert (w - host[2]).abs().max() <= 1e-4 * host[2].abs().max()
    assert (b - host[3]).abs().max() <= 1e-4 * host[3].abs().max()


@pytest.mark.cuda
def test_logreg_on_poisson_counts_holds_to_the_cpu_on_the_card(cuda):
    """Unscaled counts (Poisson of per-class rates 0.5-3): 200 steps at lr
    0.1 on the card end within 1e-4 of the CPU's weights, each tensor
    against its largest value."""
    from predictionio_tpu_torch.ops import classifiers as cls

    rng = np.random.default_rng(1)
    n, f, c = 60_000, 54, 7
    y = rng.integers(0, c, n).astype(np.int32)
    x = rng.poisson(rng.uniform(0.5, 3.0, (c, f))[y]).astype(np.float32)
    args = dict(learning_rate=0.1, num_iterations=200)
    w, b = (t.cpu() for t in cls.train_logistic_regression(
        torch.from_numpy(x).to(cuda), y, c, device=cuda, **args))
    w_c, b_c = cls.train_logistic_regression(x, y, c, device="cpu", **args)
    assert (w - w_c).abs().max() <= 1e-4 * w_c.abs().max()
    assert (b - b_c).abs().max() <= 1e-4 * b_c.abs().max()


@pytest.mark.cuda
def test_markov_chain_predicts_the_same_bits_on_the_card(cuda):
    from predictionio_tpu_torch.e2 import MarkovChain

    rng = np.random.default_rng(1)
    n = 2000
    rows, cols = rng.integers(0, n, 40_000), rng.integers(0, n, 40_000)
    counts = rng.integers(1, 9, 40_000).astype(np.float64)
    dev = MarkovChain.train(rows, cols, counts, n_states=n, top_n=8, device=cuda)
    host = MarkovChain.train(rows, cols, counts, n_states=n, top_n=8, device="cpu")
    cur = rng.random(n).tolist()
    a, b = dev.predict(cur), dev.predict(cur)
    assert a == b
    np.testing.assert_allclose(a, host.predict(cur), rtol=1e-5, atol=1e-7)


def _hold_wave(results, users, U, V, num):
    """Each ("ok", body, iid) answer held to the host answer of its user:
    scores within 1e-5, ids equal outside a near tie with a neighbour."""
    want_s, want_i = topk.host_topk_batch(U[users] @ V.T, num + 1)
    for row, body in enumerate(results):
        got_i = [int(x["item"][1:]) for x in body["itemScores"]]
        got_s = np.asarray([x["score"] for x in body["itemScores"]])
        w = want_s[row]
        np.testing.assert_allclose(got_s, w[:num], rtol=1e-5, atol=1e-6)
        for j in np.flatnonzero(np.asarray(got_i) != want_i[row, :num]):
            gap = min(abs(w[j] - w[x]) for x in (j - 1, j + 1) if 0 <= x <= num)
            assert gap <= 1e-5 * abs(w[j]) + 1e-6, (row, j)


@pytest.mark.cuda
def test_tls_queries_to_a_card_deploy(cuda, tmp_path):
    # the aio front end with a self-signed certificate over a deploy on the
    # card: every HTTPS answer 200 and held to the host answer
    import json
    import ssl
    import subprocess
    import urllib.request

    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import prediction_server as ps
    from predictionio_tpu_torch.server.aio import AsyncAppServer

    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
         "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=localhost"],
        check=True, capture_output=True, timeout=60)
    rng = np.random.default_rng(12)
    U, V, storage, deployed = _card_deploy(cuda, tmp_path, rng, 500, 3000, 8)
    app = ps.create_prediction_server_app(
        deployed, use_microbatch=True, registry=MetricsRegistry())
    server = AsyncAppServer(app, "127.0.0.1", 0, ssl_certfile=str(cert),
                            ssl_keyfile=str(key)).start_background()
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    users = rng.integers(0, 500, 24)
    try:
        bodies = []
        for u in users:
            req = urllib.request.Request(
                f"https://127.0.0.1:{server.port}/queries.json",
                data=json.dumps({"user": f"u{u}", "num": 10}).encode())
            with urllib.request.urlopen(req, timeout=30, context=ctx) as r:
                assert r.status == 200 and r.headers["X-Pio-Engine-Instance"] == "card"
                bodies.append(json.loads(r.read()))
    finally:
        server.shutdown()
        storage.close()
    _hold_wave(bodies, users, U, V, 10)


@pytest.mark.cuda
def test_feedback_wave_through_the_fused_topk(cuda, tmp_path):
    # 512 queries queued at once with feedback and an output plugin on: one
    # fused top-k launch, every answer held and marked, and one predict
    # event per query holding that marked answer
    from predictionio_tpu_torch.data.storage.base import EventFilter
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import plugins
    from predictionio_tpu_torch.server import prediction_server as ps
    from predictionio_tpu_torch.tools.commands import app_new

    class Mark(plugins.EngineServerPlugin):
        plugin_name = "mark"
        plugin_type = plugins.OUTPUT_BLOCKER

        def process(self, engine_instance_id, query, prediction):
            return {**prediction, "user": query["user"]}

    rng = np.random.default_rng(13)
    U, V, storage, deployed = _card_deploy(cuda, tmp_path, rng, 700, 3000, 8)
    d = app_new(storage, "fb")
    ctx = plugins.PluginContext()
    ctx.register(Mark())
    app = ps.create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=512, plugins=ctx,
        feedback=ps.FeedbackConfig(enabled=True, access_key=d.keys[0].key),
        registry=MetricsRegistry())
    users = rng.integers(0, 700, 512)
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    try:
        results = _burst(app.microbatcher,
                         [{"user": f"u{u}", "num": 10} for u in users],
                         [{} for _ in users])
        events = list(storage.l_events().find(
            d.app.id, None, EventFilter(event_names=("predict",))))
    finally:
        app.microbatcher.close()
        storage.close()
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 1
    assert [(s, iid) for s, _, iid in results] == [("ok", "card")] * 512
    bodies = [b for _, b, _ in results]
    assert [b["user"] for b in bodies] == [f"u{u}" for u in users]
    _hold_wave(bodies, users, U, V, 10)
    assert len(events) == 512
    by_user = {}
    for e in events:
        by_user.setdefault(e.properties.get("query")["user"], []).append(
            e.properties.get("prediction"))
    for b in bodies:
        assert b in by_user[b["user"]]


@pytest.mark.cuda
def test_partitioned_wave_holds_both_partitions_to_plain(cuda, tmp_path):
    # a canary staged at 0.5 beside the live generation: 1,100 queries
    # queued at once, their users chosen by the split so that each side
    # holds 550 (past the device floor of 512), form one wave of two
    # partitions, each one fused top-k launch against its own generation;
    # every answer held to fused_topk_plain on the card with its side's
    # factors
    from datetime import datetime, timezone

    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.lifecycle.canary import in_canary_fraction
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import prediction_server as ps

    rng = np.random.default_rng(14)
    n_users, n_items, rank, num, side = 4000, 3000, 8, 10, 550
    U, V, storage, deployed = _card_deploy(cuda, tmp_path, rng, n_users, n_items, rank)
    U2 = rng.standard_normal((n_users, rank)).astype(np.float32)
    V2 = rng.standard_normal((n_items, rank)).astype(np.float32)
    live = storage.engine_instances().get("card")
    now = datetime.now(tz=timezone.utc)
    canary = dataclasses.replace(live, id="card-canary", start_time=now, end_time=now)
    storage.engine_instances().insert(canary)
    save_models(storage.models(), canary.id, [{
        "user_factors": U2, "item_factors": V2,
        "user_vocab": np.array([f"u{i}" for i in range(n_users)]),
        "item_vocab": np.array([f"i{i}" for i in range(n_items)]),
    }])
    deployed.stage_canary(canary, 0.5)
    on_canary = np.array([in_canary_fraction(f"u{u}", 0.5) for u in range(n_users)])
    users = np.concatenate([rng.choice(np.flatnonzero(~on_canary), side),
                            rng.choice(np.flatnonzero(on_canary), side)])
    rng.shuffle(users)
    app = ps.create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=2048, max_queue=0,
        registry=MetricsRegistry())
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    try:
        results = _burst(app.microbatcher,
                         [{"user": f"u{u}", "num": num} for u in users],
                         [{} for _ in users])
    finally:
        app.microbatcher.close()
        storage.close()
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 2
    assert [s for s, _, _ in results] == ["ok"] * len(users)
    for want_canary, (Uf, Vf, iid) in ((False, (U, V, "card")),
                                        (True, (U2, V2, "card-canary"))):
        rows = [j for j, u in enumerate(users) if on_canary[u] == want_canary]
        assert len(rows) == side
        assert {results[j][2] for j in rows} == {iid}
        qd = torch.as_tensor(Uf[users[rows]], device=cuda)
        td = torch.as_tensor(Vf, device=cuda)
        wider = topk.fused_topk_plain(qd, td, num + 1, n_items).cpu().numpy()
        for row, j in enumerate(rows):
            got = results[j][1]["itemScores"]
            got_i = [int(x["item"][1:]) for x in got]
            got_s = np.asarray([x["score"] for x in got])
            w, wi = wider[0][row], wider[1][row].astype(np.int64)
            np.testing.assert_allclose(got_s, w[:num], rtol=1e-5, atol=1e-6)
            for c in np.flatnonzero(np.asarray(got_i) != wi[:num]):
                gap = min(abs(w[c] - w[x]) for x in (c - 1, c + 1) if 0 <= x <= num)
                assert gap <= 1e-5 * abs(w[c]) + 1e-6, (j, c)


@pytest.mark.cuda
def test_train_and_wave_over_the_storage_daemon_on_the_card(cuda, tmp_path):
    # every repository on a storage daemon (parquet events): ratings written
    # as bulk frames, the recommendation train on the card (2 fused launches
    # an iteration) held to the same train on the CPU from one seeded start
    # within 2e-3, then the deploy bound through the daemon answering a
    # queued wave of 600 known users with one fused top-k launch, held to
    # the host answer of the stored factors
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage.base import EventFrame
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import prediction_server as ps
    from predictionio_tpu_torch.server.storage_server import StorageServer
    from predictionio_tpu_torch.tools import commands

    n_users, n_items, n, rank, iters = 900, 700, 60_000, 8, 6
    rng = np.random.default_rng(15)
    u = rng.integers(0, n_users, n)
    i = rng.integers(0, n_items, n)
    u[:n_users] = np.arange(n_users)  # every user rated at least once
    r = rng.integers(1, 11, n) / 2.0
    daemon = StorageServer(tmp_path / "root", host="127.0.0.1", port=0,
                           compaction=False).start_background()
    storage = StorageRuntime(StorageConfig.from_env({
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_SOURCES_R_TYPE": "remote",
        "PIO_STORAGE_SOURCES_R_URL": f"http://127.0.0.1:{daemon.port}",
        "PIO_STORAGE_SOURCES_R_TIMEOUT": "60",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R",
    }))
    real_train = rec.train_als
    start = np.random.default_rng(16)
    init = [(np.abs(start.standard_normal((k, rank))) / np.sqrt(rank)).astype(np.float32)
            for k in (n_users, n_items)]
    vocab = {}

    def seeded(uu, ii, rr, num_users, num_items, params, **kw):
        # each entity starts from its own row of the seeded tables
        kw.pop("init_factors", None)
        pd = vocab["pd"]
        ku = [int(x[1:]) for x in pd.user_vocab.keys_array()]
        ki = [int(x[1:]) for x in pd.item_vocab.keys_array()]
        return real_train(uu, ii, rr, num_users=num_users, num_items=num_items,
                          params=params, init_factors=(init[0][ku], init[1][ki]), **kw)

    real_prepare = rec.RatingsPreparator.prepare

    def prepare(self, ctx, td):
        vocab["pd"] = real_prepare(self, ctx, td)
        return vocab["pd"]

    rec.train_als, rec.RatingsPreparator.prepare = seeded, prepare
    try:
        app = commands.app_new(storage, "cardstore").app
        users = np.array([f"u{k}" for k in range(n_users)], object)
        items = np.array([f"i{k}" for k in range(n_items)], object)
        docs = np.array(['{"rating": %s}' % (k / 2) for k in range(11)], object)
        const = np.array(["rate", "user", "item"], object)
        storage.p_events().write(EventFrame(
            event=const[np.zeros(n, np.int64)], entity_type=const[np.ones(n, np.int64)],
            entity_id=users[u], target_entity_type=const[np.full(n, 2)],
            target_entity_id=items[i],
            event_time_ms=1_700_000_000_000 + np.arange(n, dtype=np.int64),
            properties=docs[np.rint(r * 2).astype(np.int64)]), app.id)
        engine = resolve_engine_factory("recommendation")()
        params = engine.params_from_json({
            "datasource": {"params": {"appName": "cardstore"}},
            "algorithms": [{"name": "als", "params": {"rank": rank,
                                                      "numIterations": iters}}]})
        blobs = {}
        for dev in ("cuda", "cpu"):
            before = als_accum.KERNEL_LAUNCHES["als_fused_accum"]
            inst = run_train(engine, params, ctx=EngineContext(storage=storage, device=dev),
                             engine_factory="recommendation", storage=storage)
            launched = als_accum.KERNEL_LAUNCHES["als_fused_accum"] - before
            assert launched == (2 * iters if dev == "cuda" else 0)
            (blobs[dev],) = load_models(storage.models(), inst.id)
        for key in ("user_factors", "item_factors"):
            np.testing.assert_allclose(blobs["cuda"][key], blobs["cpu"][key],
                                       atol=2e-3, rtol=0)
        deployed = ps.deploy_engine("recommendation", storage=storage,
                                    engine_instance_id=inst.id, device=cuda)
        ps_app = ps.create_prediction_server_app(
            deployed, use_microbatch=True, max_batch=1024, registry=MetricsRegistry())
        rows = rng.choice(n_users, 600, replace=False)
        names = [str(x) for x in blobs["cpu"]["user_vocab"]]
        before = topk.KERNEL_LAUNCHES["fused_topk"]
        try:
            results = _burst(ps_app.microbatcher,
                             [{"user": names[x], "num": 10} for x in rows],
                             [{} for _ in rows])
        finally:
            ps_app.microbatcher.close()
        assert topk.KERNEL_LAUNCHES["fused_topk"] == before + 1
        assert [s for s, _, _ in results] == ["ok"] * len(rows)
        ivocab = [int(str(x)[1:]) for x in blobs["cpu"]["item_vocab"]]
        V = np.zeros((n_items, rank), np.float32)
        V[ivocab] = blobs["cpu"]["item_factors"]  # rows by item number
        _hold_wave([b for _, b, _ in results], rows, blobs["cpu"]["user_factors"], V, 10)
    finally:
        rec.train_als, rec.RatingsPreparator.prepare = real_train, real_prepare
        storage.close()
        daemon.shutdown()


@pytest.mark.cuda
def test_billed_http_waves_conserve_device_seconds_on_the_card(cuda, tmp_path):
    # 2,048 HTTP queries for two tenants queued behind a held wave: device
    # waves of 512 or more known users, each partition one fused top-k
    # launch; every answer billed to its tenant, and the ledger's device
    # seconds equal to the batcher's pio_microbatch_device_seconds within
    # 1e-6 of it (the waves' meta device_s, split over their members)
    import asyncio
    import http.client
    import json
    import threading

    from predictionio_tpu_torch.obs.costs import CostLedger
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server import aio
    from predictionio_tpu_torch.server import prediction_server as ps
    from predictionio_tpu_torch.tenancy import Tenant, TenantRegistry

    rng = np.random.default_rng(15)
    n_users = 3000
    _, _, storage, deployed = _card_deploy(cuda, tmp_path, rng, n_users, 3000, 8)
    reg = MetricsRegistry()
    ledger = CostLedger(registry=reg)
    tenants = TenantRegistry(registry=reg)
    tenants.admit(Tenant("one", deployed, cost_name="one", hbm_bytes=0))
    tenants.admit(Tenant("two", deployed, cost_name="two", hbm_bytes=0))
    app = ps.create_multi_tenant_server_app(
        tenants, use_microbatch=True, max_batch=2048, max_queue=0,
        registry=reg, costs=ledger, enable_alerts=False)
    server = aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    batcher = app.microbatcher
    real, gate, held = batcher.batch_fn, threading.Event(), threading.Event()

    def gated(items):
        if not held.is_set():
            held.set()
            gate.wait(60)
        return real(items)

    def post(tenant, user):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        try:
            conn.request("POST", "/queries.json",
                         json.dumps({"user": f"u{user}", "num": 10}),
                         {"Content-Type": "application/json", "X-Pio-App": tenant})
            return conn.getresponse().status
        finally:
            conn.close()

    async def aio_post(tenant, user):
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        body = json.dumps({"user": f"u{user}", "num": 10}).encode()
        writer.write((f"POST /queries.json HTTP/1.1\r\nHost: x\r\nX-Pio-App: "
                      f"{tenant}\r\nContent-Length: {len(body)}\r\nConnection: "
                      "close\r\n\r\n").encode() + body)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout=120)
        writer.close()
        return int(raw.split(b" ", 2)[1])

    async def burst():
        tasks = [asyncio.ensure_future(aio_post(("one", "two")[i % 2], int(u)))
                 for i, u in enumerate(rng.integers(0, n_users, 2048))]
        for _ in range(1200):
            if len(batcher._pending) >= 2048:
                break
            await asyncio.sleep(0.05)
        gate.set()
        return await asyncio.gather(*tasks)

    batcher.batch_fn = gated
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    try:
        hold = threading.Thread(target=post, args=("one", 1))
        hold.start()
        assert held.wait(30)
        codes = asyncio.run(burst())
        hold.join(60)
    finally:
        gate.set()
        batcher.batch_fn = real
        server.shutdown()
        storage.close()
    assert codes == [200] * 2048
    assert topk.KERNEL_LAUNCHES["fused_topk"] - before == 2
    totals = {}
    for row in ledger.snapshot()["totals"]:
        agg = totals.setdefault(row["app"], [0.0, 0.0])
        agg[0] += row["requests"]
        agg[1] += row["device_s"]
    assert totals["one"][0] == 1025 and totals["two"][0] == 1024
    fam = reg.get("pio_microbatch_device_seconds")
    device_s = sum(child.sum for _, child in fam.series())
    billed = sum(v[1] for v in totals.values())
    assert abs(billed - device_s) <= 1e-6 * device_s, (billed, device_s)


_FIRST_CAPTURE_SCRIPT = r'''
import json, sys, threading, time, urllib.request
from datetime import datetime, timezone
import numpy as np
import torch
from predictionio_tpu_torch.core.engine import EngineParams
from predictionio_tpu_torch.core.persistence import save_models
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as rec
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.server import prediction_server as ps
from predictionio_tpu_torch.server.aio import AsyncAppServer

home, key = sys.argv[1], "k"
rng = np.random.default_rng(16)
U = rng.standard_normal((2000, 8)).astype(np.float32)
V = rng.standard_normal((3000, 8)).astype(np.float32)
storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": home}))
params = EngineParams(algorithms=(("als", rec.ALSAlgorithmParams(rank=8)),))
now = datetime.now(tz=timezone.utc)
storage.engine_instances().insert(EngineInstance(
    id="card", status="COMPLETED", start_time=now, end_time=now,
    engine_id="default", engine_version="default", engine_variant="default",
    engine_factory="recommendation", **params.to_json_fields()))
save_models(storage.models(), "card", [{
    "user_factors": U, "item_factors": V,
    "user_vocab": np.array([f"u{i}" for i in range(2000)]),
    "item_vocab": np.array([f"i{i}" for i in range(3000)])}])
deployed = ps.deploy_engine("recommendation", storage=storage, device="cuda")
app = ps.create_prediction_server_app(
    deployed, use_microbatch=True, max_batch=1024, max_queue=0,
    registry=MetricsRegistry(), access_key=key)
server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
base = f"http://127.0.0.1:{server.port}"
auth = {"Authorization": f"Bearer {key}"}
import asyncio
async def burst():
    with app.microbatcher._cond:
        futs = [asyncio.ensure_future(app.microbatcher.submit(
            ps.QueuedQuery({"user": f"u{u}", "num": 10}), {})) for u in range(600)]
        await asyncio.sleep(0)
    return await asyncio.gather(*futs)
# a first wave builds the kernel (nvcc), outside the capture's window
assert {r[0] for r in asyncio.run(burst())} == {"ok"}
req = urllib.request.Request(base + "/debug/profile?seconds=2", method="POST",
                             headers=auth)
assert urllib.request.urlopen(req, timeout=60).status == 202
assert {r[0] for r in asyncio.run(burst())} == {"ok"}
deadline = time.monotonic() + 120
while True:
    st = json.loads(urllib.request.urlopen(urllib.request.Request(
        base + "/debug/profile", headers=auth), timeout=60).read())
    if not st["running"] or time.monotonic() > deadline:
        break
    time.sleep(0.2)
server.shutdown()
storage.close()
print(json.dumps(st["last"]))
'''


@pytest.mark.cuda
def test_a_deploys_first_capture_traces_the_card(cuda, tmp_path):
    # a fresh deploy process whose first torch.profiler capture is the
    # /debug/profile one, run on the controller's thread: the capture holds
    # the device wave's fused top-k
    import json
    import subprocess
    import sys

    import os

    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_CAPTURE_SCRIPT, str(tmp_path / "home")],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PIO_ALERTS="0", PIO_HOME=str(tmp_path / "home")),
        cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["error"] is None, last
    assert any("fused_topk" in op["name"] for op in last["device_ops"]), last


def _device_lead_us(trace_path) -> float:
    """How far ahead of the host's stamp of a launch its device work is
    stamped in a chrome trace (the largest over correlated pairs, in us;
    negative when every device op starts after its launch)."""
    import json

    events = json.loads(open(trace_path).read()).get("traceEvents", [])
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    leads = [launches[e["args"]["correlation"]] - e["ts"] for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and e.get("args", {}).get("correlation") in launches]
    return max(leads) if leads else float("nan")


@pytest.mark.cuda
def test_a_launch_made_as_the_capture_answers_is_captured(cuda, tmp_path):
    # kernel 3 launched the moment ProfilerController.start returns (the
    # 202 of /debug/profile): every capture holds it.  Kineto drops a
    # device record stamped before its window opens, and the card's clock,
    # mapped onto the host's, jitters by up to about 5 ms: answering at
    # once, late in this file's run, lost the launch in 2-4 captures of 100
    # (the controller now answers after obs.profiler.DEVICE_CLOCK_GUARD_S).
    # Each capture also reports how far ahead of the host's stamp of its
    # launch the device work was stamped
    from predictionio_tpu_torch.obs.profiler import ProfilerController

    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((512, 10), dtype=np.float32)).to(cuda)
    t = torch.from_numpy(rng.standard_normal((26_744, 10), dtype=np.float32)).to(cuda)
    topk.fused_topk_batch(q, t, 10)  # built and loaded outside every window
    torch.cuda.synchronize()
    ctl = ProfilerController()
    captures = []
    for n in range(100):
        ctl.start(0.1, out_dir=str(tmp_path / f"c{n}"), cuda=True)
        topk.fused_topk_batch(q, t, 10)
        torch.cuda.synchronize()
        deadline = time.monotonic() + 60
        while ctl.status()["running"]:
            assert time.monotonic() < deadline, "the capture never finished"
            time.sleep(0.05)
        last = ctl.status()["last"]
        captures.append({
            "error": last["error"],
            "fused_topk": [o["name"] for o in last.get("device_ops", ())
                           if "fused_topk" in o["name"]],
            "device_lead_us": (_device_lead_us(last["trace"])
                               if last.get("trace") else None)})
    print([c["device_lead_us"] for c in captures])
    missed = [n for n, c in enumerate(captures) if c["error"] or not c["fused_topk"]]
    assert not missed, (missed, captures)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [3, 4])
def test_sharded_kernel3_wave_matches_plain(cuda, n_slots):
    """A factor-sharded top-k over ``n_slots`` slots on one card: kernel 3
    once per slot, each on its slot's stream, merged to the plain version's
    answer bit for bit (exact inputs; a tie planted across the boundary of
    the first two slots)."""
    from predictionio_tpu_torch.parallel import placement

    rng = np.random.default_rng(n_slots)
    q = (rng.integers(-8, 9, (64, 6)) / 8).astype(np.float32)
    t = (rng.integers(-8, 9, (2003, 6)) / 8).astype(np.float32)
    rows = -(-len(t) // n_slots)
    t[rows] = t[rows - 1]
    plan = placement.ShardPlan.model_parallel(["t"], rows={"t": len(t)})
    bound = placement.bind_shards(plan, {"t": t}, devices=[cuda] * n_slots)

    def local(tl, qq, kc, limit):
        packed = topk.fused_topk_batch(qq, tl, kc, limit=limit, name="cuda.shard")
        return packed[0], packed[1]

    fn = placement.build_sharded_topk(
        bound.mesh, None, n_items=len(t), k=16, name="cuda.sharded",
        local_topk_fn=local)
    before = topk.KERNEL_LAUNCHES["fused_topk"]
    res = fn(bound.arrays["t"], torch.from_numpy(q).to(cuda))
    settle = placement.settle_shards(res, time.perf_counter())
    got = res.packed.cpu().numpy()
    assert topk.KERNEL_LAUNCHES["fused_topk"] == before + n_slots
    assert topk.LAST_KERNEL_SHAPES["cuda.shard"]["route"] == "cuda"
    assert sorted(settle) == [f"cuda:{i}" for i in range(n_slots)]
    want = topk.fused_topk_plain(torch.from_numpy(q), torch.from_numpy(t), 16, len(t))
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_mesh_train_on_four_slots_of_the_card(cuda, mode):
    """``train_als(mesh=)`` over 4 data slots of one card: kernel 1 (kernel
    2 on the chunked rung) once per slot per half-step, each on its slot's
    stream; the factors within 2e-3 of the one-slot train from the same
    start; bit for bit on repeat; each slot's kernel-1 stats within 1e-4 of
    the plain version's absolute sums."""
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rng = np.random.default_rng(1)
    nu, ni, k, n, iters, slots = 700, 300, 10, 20_000, 5, 4
    U = np.abs(rng.normal(size=(nu, k)))
    V = np.abs(rng.normal(size=(ni, k)))
    ui = rng.integers(0, nu, n).astype(np.int32)
    ii = rng.integers(0, ni, n).astype(np.int32)
    r = (U[ui] * V[ii]).sum(1).astype(np.float32)
    init = tuple((np.abs(rng.standard_normal((m, k))) / np.sqrt(k)).astype(np.float32)
                 for m in (nu, ni))
    p = als.ALSParams(rank=k, num_iterations=iters, pallas_mode=mode)
    mesh = make_mesh(MeshConfig({"data": slots}), devices=[cuda] * slots)
    one = als.train_als(ui, ii, r, nu, ni, p, device=cuda, init_factors=init)
    name = "als_fused_accum" if mode == "fused" else "als_segment_accum"
    before = dict(als_accum.KERNEL_LAUNCHES)
    got = als.train_als(ui, ii, r, nu, ni, p, mesh=mesh, init_factors=init)
    torch.cuda.synchronize()
    launched = als_accum.KERNEL_LAUNCHES[name] - before[name]
    if mode == "fused":
        assert launched == 2 * slots * iters
    else:
        info = als.LAST_PLAN_INFO
        assert launched == iters * (info["chunks_user"] + info["chunks_item"])
    again = als.train_als(ui, ii, r, nu, ni, p, mesh=mesh, init_factors=init)
    for a, b, c in ((got.user_factors, one.user_factors, again.user_factors),
                    (got.item_factors, one.item_factors, again.item_factors)):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=2e-3)
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    if mode != "fused":
        return
    staged = next(iter(als._STAGE_CACHE.values()))
    Vp = torch.zeros((384, k), device=cuda)
    Vp[:ni] = got.item_factors
    for pos in sorted(staged):
        su = staged[pos][0]
        args = (su["plan_args"], su["oth"], su["wrv"], Vp, su["plan"].n_blocks)
        kernel = als_accum.segment_stats_fused(*args)
        plain = als_accum.segment_stats_fused_plain(*args)
        scale = als_accum.segment_stats_fused_plain(
            su["plan_args"], su["oth"], su["wrv"].abs(), Vp.abs(), su["plan"].n_blocks)
        _hold(kernel, plain, scale, False, f"slot {pos}'s stats")


@pytest.mark.cuda
@pytest.mark.parametrize("loss,mlp", [("bpr", (64, 32, 16)), ("full_softmax", ())])
def test_ncf_mesh_epoch_on_card_slots_matches_the_one_slot_train(cuda, loss, mlp):
    """``MeshNCF`` on ``{data: 2, model: 2}`` slots of one card against the
    one-slot card train from one tree (1,001 x 501, padded to 1,002 x 502)
    and one seed, the same draws.  The first step: the loss within 1e-5,
    the applied gradient within 1e-4 of each leaf's largest entry, the
    parameters within 1e-6 (1 + |p|) of the one-slot Adam replayed from
    that gradient.  After two epochs: the same bits on repeat, every copy
    of a leaf and of its Adam moments equal bit for bit, and the mesh no
    further from the one-slot
    train than twice what that train moves when its start moves by one
    ulp (Adam turns the rounding of near-zero gradients into steps of up
    to the learning rate, so trains that sum in another order part; on
    the CPU, where they do not, ``tests/test_torch_ncf_mesh.py`` holds
    them within 1e-5)."""
    from predictionio_tpu_torch.ops import ncf
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rng = np.random.default_rng(3)
    n_users, n_items, n = 1001, 501, 20_000
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    p = ncf.NCFParams(embed_dim=32, mlp_layers=mlp, loss=loss, batch_size=2048,
                      learning_rate=1e-3)
    tree = ncf.init_ncf(torch.Generator().manual_seed(5), 1002, 502, p)
    tree = ncf.tree_map(lambda x: x.to(cuda), tree)
    mesh = make_mesh(MeshConfig({"data": 2, "model": 2}), devices=[cuda] * 4)
    stream = ncf.stage_stream(users, items, p, cuda, multiple=2)
    cdf = torch.from_numpy(ncf.negative_sampling_cdf(items, n_items, 0.0)).to(cuda)

    def one_slot(start):
        leaves = ncf.tree_map(lambda x: x.clone().requires_grad_(True), start)
        return leaves, ncf.make_optimizer(leaves, p)

    # the first step
    b = stream.batch
    batch = (stream.u[:b], stream.i[:b],
             torch.from_numpy(rng.integers(0, n_items, (b, 1))).to(cuda),
             stream.valid[:b], stream.w[:b])
    one, opt = one_slot(tree)
    want_loss = float(ncf.train_step(one, opt, *batch, p, n_items))
    st = ncf.MeshNCF(mesh, tree, p)
    got_loss = float(st.step(*batch, n_items))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    g_mesh = st.gathered(grads=True)
    replay, ropt = one_slot(tree)
    for leaf, g in zip(ncf.tree_leaves(replay), ncf.tree_leaves(g_mesh)):
        leaf.grad = g.clone()
    ropt.step()
    for go, gm, pr, pm in zip(*(ncf.tree_leaves(t) for t in (
            ncf.tree_map(lambda x: x.grad, one), g_mesh, replay, st.gathered()))):
        assert float((gm - go).abs().max()) <= 1e-4 * (float(go.abs().max()) or 1.0)
        assert bool(((pm - pr.detach()).abs() <= 1e-6 * (1 + pr.detach().abs())).all())

    # two epochs
    def epochs(train_epoch):
        g = torch.Generator(device=cuda).manual_seed(p.seed)
        for _ in range(2):
            train_epoch(g)

    one, opt = one_slot(tree)
    epochs(lambda g: ncf.train_epoch(one, opt, stream, p, n_items, g, cdf))
    nudged, nopt = one_slot(ncf.tree_map(
        lambda x: torch.nextafter(x, torch.full_like(x, float("inf"))), tree))
    epochs(lambda g: ncf.train_epoch(nudged, nopt, stream, p, n_items, g, cdf))
    st = ncf.MeshNCF(mesh, tree, p)
    epochs(lambda g: st.train_epoch(stream, n_items, g, cdf))
    again = ncf.MeshNCF(mesh, tree, p)
    epochs(lambda g: again.train_epoch(stream, n_items, g, cdf))
    for x, y in zip(ncf.tree_leaves(st.gathered()), ncf.tree_leaves(again.gathered())):
        assert torch.equal(x, y)  # a mesh train repeats bit for bit

    def gap(a, b):
        return max(float((x.detach() - y.detach()).abs().max())
                   for x, y in zip(ncf.tree_leaves(a), ncf.tree_leaves(b)))

    got = st.gathered()
    assert [x.shape for x in ncf.tree_leaves(got)] == [
        x.shape for x in ncf.tree_leaves(one)]
    assert gap(got, one) <= max(2 * gap(nudged, one), 1e-6), (gap(got, one),
                                                              gap(nudged, one))
    slots = st.mesh.local_slots
    for a in slots:
        for b in slots:
            if st.layout.m_of[a] != st.layout.m_of[b]:
                continue
            for x, y in zip(ncf.tree_leaves(st.trees[a]), ncf.tree_leaves(st.trees[b])):
                assert torch.equal(x, y)
                for key in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(st.optimizers[a].state[x][key],
                                       st.optimizers[b].state[y][key])


@pytest.mark.cuda
def test_ncf_mesh_pretrain_runs_kernel_1_once_per_data_slot(cuda):
    """The NCF pretrain (implicit ALS at rank 32) over ``{data: 2, model:
    2}`` slots of one card: kernel 1 once per data slot per half-step, the
    factors within 2e-3 of the one-slot train, and each data slot's stats
    within 1e-4 of the plain version's absolute sums."""
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    rng = np.random.default_rng(4)
    nu, ni, n, iters = 900, 400, 30_000, 2
    ui = rng.integers(0, nu, n).astype(np.int32)
    ii = rng.integers(0, ni, n).astype(np.int32)
    r = np.ones(n, np.float32)
    p = als.ALSParams(rank=32, num_iterations=iters, reg=0.01, implicit_prefs=True,
                      alpha=2.0, pallas_mode="fused")
    mesh = make_mesh(MeshConfig({"data": 2, "model": 2}), devices=[cuda] * 4)
    one = als.train_als(ui, ii, r, nu, ni, p, device=cuda)
    before = als_accum.KERNEL_LAUNCHES["als_fused_accum"]
    got = als.train_als(ui, ii, r, nu, ni, p, mesh=mesh)
    torch.cuda.synchronize()
    assert als_accum.KERNEL_LAUNCHES["als_fused_accum"] - before == 2 * 2 * iters
    for a, b in ((got.user_factors, one.user_factors),
                 (got.item_factors, one.item_factors)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=2e-3)
    staged = next(iter(als._STAGE_CACHE.values()))
    assert sorted(staged) == [0, 1]
    Vp = torch.zeros((512, 32), device=cuda)
    Vp[:ni] = got.item_factors
    for pos in sorted(staged):
        su = staged[pos][0]
        args = (su["plan_args"], su["oth"], su["wrv"], Vp, su["plan"].n_blocks)
        kernel = als_accum.segment_stats_fused(*args)
        plain = als_accum.segment_stats_fused_plain(*args)
        scale = als_accum.segment_stats_fused_plain(
            su["plan_args"], su["oth"], su["wrv"].abs(), Vp.abs(), su["plan"].n_blocks)
        _hold(kernel, plain, scale, False, f"data slot {pos}'s stats")


class _MemoryS3:
    """An in-memory boto3-shaped S3 client (put/get/delete_object)."""

    class exceptions:
        class NoSuchKey(Exception):
            pass

    def __init__(self):
        self.objects: dict[str, bytes] = {}

    def put_object(self, Bucket, Key, Body):
        self.objects[f"{Bucket}/{Key}"] = bytes(Body)

    def get_object(self, Bucket, Key, Range=None):
        k = f"{Bucket}/{Key}"
        if k not in self.objects:
            raise self.exceptions.NoSuchKey(k)
        body = self.objects[k]
        if Range:
            a, b = Range.removeprefix("bytes=").split("-")
            body = body[int(a):int(b) + 1]
        return {"Body": body}

    def delete_object(self, Bucket, Key):
        self.objects.pop(f"{Bucket}/{Key}", None)


@pytest.mark.cuda
def test_s3_loaded_model_wave_equals_the_sqlite_loaded_one(cuda, tmp_path, monkeypatch):
    """A seeded model at the ML-20M shape saved through ``S3Models``
    (``TYPE=s3``) and through sqlite under one instance: the kernel-3 wave
    of 4,096 known users from the S3 deploy equals the sqlite deploy's bit
    for bit, with one launch."""
    from datetime import datetime, timezone

    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage import s3_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.server.prediction_server import deploy_engine

    client = _MemoryS3()
    monkeypatch.setattr(s3_models, "_make_boto3_client", lambda r, e: client)
    env = {
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
    }
    sql = StorageRuntime(StorageConfig.from_env(env))
    s3 = StorageRuntime(StorageConfig.from_env({
        **env, "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3",
        "PIO_STORAGE_SOURCES_S3_TYPE": "s3", "PIO_STORAGE_SOURCES_S3_BUCKET": "m",
    }))
    rng = np.random.default_rng(20)
    nu, ni, rank = 138_493, 26_744, 10
    blob = {
        "user_factors": (np.abs(rng.standard_normal((nu, rank))) / np.sqrt(rank)).astype(np.float32),
        "item_factors": (np.abs(rng.standard_normal((ni, rank))) / np.sqrt(rank)).astype(np.float32),
        "user_vocab": np.array([f"u{i}" for i in range(nu)]),
        "item_vocab": np.array([f"i{i}" for i in range(ni)]),
    }
    params = EngineParams(
        datasource=("", rec.DataSourceParams(app_name="ml20m")),
        algorithms=(("als", rec.ALSAlgorithmParams(rank=rank)),), serving=("", None),
    )
    now = datetime.now(tz=timezone.utc)
    inst = EngineInstance(
        id="s3inst", status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="recommendation", **params.to_json_fields(),
    )
    try:
        sql.engine_instances().insert(inst)
        save_models(s3.models(), inst.id, [blob])
        save_models(sql.models(), inst.id, [blob])
        assert any(":part:" in k for k in client.objects)
        queries = [(j, rec.Query(user=f"u{u}", num=10))
                   for j, u in enumerate(rng.integers(0, nu, 4096))]
        answers = []
        for rt in (s3, sql):
            d = deploy_engine("recommendation", storage=rt, engine_instance_id=inst.id)
            before = topk.KERNEL_LAUNCHES["fused_topk"]
            answers.append(d.algorithms[0].batch_predict(d.models[0], queries))
            torch.cuda.synchronize()
            assert topk.KERNEL_LAUNCHES["fused_topk"] - before == 1
        for (_, a), (_, b) in zip(*answers):
            assert [(x.item, x.score) for x in a.item_scores] == [
                (x.item, x.score) for x in b.item_scores]
    finally:
        s3.close()
        sql.close()


@pytest.mark.cuda
def test_two_threads_first_loads_build_each_source_once(cuda, tmp_path, monkeypatch):
    """Four threads' first ``load()`` of kernel 1 and kernel 3 (two each)
    into an empty build directory: one ``nvcc`` per source, and the two
    compilers run side by side (neither thread waits on the other's
    build)."""
    import subprocess
    import threading

    from predictionio_tpu_torch.ops import _kernels

    monkeypatch.setenv("PIO_KERNEL_BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_kernels, "_loaded", {})
    monkeypatch.setattr(_kernels, "_building", {})
    spans, real_popen = [], subprocess.Popen

    class TimedPopen(real_popen):
        def communicate(self, *a, **k):
            out = super().communicate(*a, **k)
            spans.append((self.t0, time.perf_counter(), self.args[-1]))
            return out

        def __init__(self, *a, **k):
            self.t0 = time.perf_counter()
            super().__init__(*a, **k)

    monkeypatch.setattr(_kernels.subprocess, "Popen", TimedPopen)
    got, errors = {}, []

    def load(name, slot):
        try:
            got[slot] = _kernels.load(name)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(name, f"{name}-{j}"))
               for j in range(2) for name in ("als_fused_accum", "fused_topk")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert errors == []
    assert sorted(s[2].rsplit("/", 1)[1] for s in spans) == [
        "als_accum.cu", "fused_topk.cu"]
    assert got["fused_topk-0"] is got["fused_topk-1"]
    assert got["als_fused_accum-0"] is got["als_fused_accum-1"]
    (a0, a1, _), (b0, b1, _) = spans
    assert max(a0, b0) < min(a1, b1), "the two nvcc processes did not overlap"
    assert list((tmp_path / "kernels").glob("*.tmp")) == []
