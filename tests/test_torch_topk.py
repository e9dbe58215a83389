"""The port's top-k (predictionio_tpu_torch.ops.topk) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX
``fused_topk_batch`` (its Pallas kernel in interpret mode on the CPU) and
through the port's, which on CPU tensors runs its plain PyTorch version.
Ids must be exactly equal; values agree within rtol=1e-6, atol=1e-6,
because torch's and XLA's CPU sgemm may differ in the last ulp.  On
exact-arithmetic inputs (integers over 8) every score is exact in fp32, so
values must be bitwise equal too.  The host replicas are numpy in both
packages and must agree exactly, ties included.

The CUDA kernel itself cannot run here: ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py`` hold it against its plain version on a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu_torch.ops import _kernels
from predictionio_tpu_torch.ops import topk as pt_topk

torch.set_num_threads(2)

RTOL = ATOL = 1e-6

#: an H100's SMs and shared memory (per CTA after opting in, per SM, and
#: reserved per CTA), as ``pio_device_smem`` reads them from the runtime
H100 = pt_topk.CardLimits(132, 232_448, 233_472, 1024)


def _smem_by_hand(r: int, k: int, qpc: int) -> int:
    """A pass-1 CTA's shared memory, counted by hand from the layout in
    csrc/fused_topk.cu: the query block (the rank padded to a multiple of
    4, then to an odd number of 4-float words) and two 64-row tiles of at
    most one 64-column chunk; k-best and a 128-slot queue per query (value
    and id); a 128-slot merge scratch per warp (4 warps); 4 words per
    query.  ``test_torch_kernels_cuda.py`` holds the library to it."""
    rp = -(-r // 4) * 4

    def odd(x):
        return x if (x // 4) % 2 == 1 else x + 4

    rsq, rst = odd(rp), odd(min(rp, 64))
    return 4 * (qpc * rsq + 2 * 64 * rst + 2 * qpc * k + 2 * qpc * 128
                + 2 * 4 * 128 + 4 * qpc)


def _inputs(kind: str, b: int, n: int, r: int, seed: int, tie_rows=()):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        q = rng.standard_normal((b, r))
        t = rng.standard_normal((n, r))
    elif kind == "exact":
        q = rng.integers(-8, 9, (b, r)) / 8.0
        t = rng.integers(-8, 9, (n, r)) / 8.0
    else:  # all-equal scores
        q = np.ones((b, r))
        t = np.zeros((n, r))
    q, t = q.astype(np.float32), t.astype(np.float32)
    for a, c in tie_rows:
        t[c] = t[a]  # exact score ties between rows a and c
    return q, t


def _both(q, t, k, limit=None):
    want = np.asarray(jax_topk.fused_topk_batch(q, t, k, limit=limit))
    got = pt_topk.fused_topk_batch(
        torch.from_numpy(q), torch.from_numpy(t), k, limit=limit
    ).numpy()
    return got, want


T = pt_topk.TILE_ROWS  # the JAX kernel's tile: ties straddle its boundary

PARITY_CASES = {
    # name: (kind, B, N, r, k, tie_rows, limit)
    "small": ("normal", 8, 500, 10, 16, (), None),
    "multi_tile_boundary_ties": (
        "normal", 4, 3000, 8, 32, ((0, T), (5, T + 1), (10, 2999)), None,
    ),
    "exact_boundary_ties": (
        "exact", 6, 3000, 8, 32, ((0, T), (5, T + 1), (10, 2999)), None,
    ),
    "all_equal_scores": ("equal", 2, 2500, 4, 16, (), None),
    "batch_beyond_block": ("normal", 300, 2048, 6, 64, (), None),
    "limit_masks_tail": ("normal", 4, 2048, 6, 20, (), 1500),
    "limit_below_k": ("exact", 3, 1100, 5, 40, (), 17),
    "k_equals_n": ("exact", 3, 45, 3, 45, (), None),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_fused_topk_matches_jax(case):
    kind, b, n, r, k, ties, limit = PARITY_CASES[case]
    q, t = _inputs(kind, b, n, r, seed=b * 31 + n + k, tie_rows=ties)
    got, want = _both(q, t, k, limit)
    assert got.shape == want.shape == (2, b, k)
    np.testing.assert_array_equal(got[1], want[1])  # ids, exactly
    if kind == "normal":
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got[0], want[0])


def test_limit_matches_jax_on_truncated_table():
    q, t = _inputs("normal", 4, 2048, 6, seed=7)
    got, _ = _both(q, t, 20, limit=1500)
    trunc = pt_topk.fused_topk_batch(
        torch.from_numpy(q), torch.from_numpy(t[:1500]), 20
    ).numpy()
    np.testing.assert_array_equal(got, trunc)


def test_no_full_row_proof_hook():
    # the plain CPU version scores the whole row and says so; the CUDA
    # kernel's widest score slab is one shared-memory tile, not the catalog
    q, t = _inputs("equal", 8, 5000, 4, seed=0)
    pt_topk.fused_topk_batch(
        torch.from_numpy(q), torch.from_numpy(t), 10, name="proof.check"
    )
    shapes = pt_topk.LAST_KERNEL_SHAPES["proof.check"]
    assert shapes["route"] == "plain"
    assert shapes["rows_tile"] == shapes["n_rows"] == 5000
    geo = pt_topk.kernel_geometry(8, 5000, 8, _smem_by_hand(4, 10, 8), H100)
    assert geo["tile_rows"] < 5000
    assert geo["n_tiles"] == -(-5000 // geo["tile_rows"])


def test_off_menu_raises_and_fallback_counts():
    for mod in (jax_topk, pt_topk):
        assert mod.MAX_FUSED_K == 128 and mod.RETIRED_ID == float(1 << 25)
        assert not mod.fused_supported(8, mod.MAX_FUSED_K + 1, 4096)
        assert mod.fused_supported(8, mod.MAX_FUSED_K, 4096)
    with pytest.raises(pt_topk.FusedTopKUnsupported):
        pt_topk.fused_topk_batch(
            torch.ones((2, 4)), torch.ones((4096, 4)), pt_topk.MAX_FUSED_K + 1
        )
    with pytest.raises(pt_topk.FusedTopKUnsupported):
        pt_topk.fused_topk_batch(torch.ones((2, 4)), torch.ones((10, 4)), 11)
    before = pt_topk.FULL_ROW_FALLBACKS.get("test.fallback", 0)
    pt_topk.note_full_row_fallback(8, 200, 4096, "test.fallback")
    pt_topk.note_full_row_fallback(8, 200, 4096, "test.fallback")
    assert pt_topk.FULL_ROW_FALLBACKS["test.fallback"] == before + 2


def test_full_row_topk_matches_lax_top_k():
    # off the fused menu the JAX package scores the whole row and takes
    # lax.top_k (ties by id ascending); the port's CPU path must agree
    import jax

    rng = np.random.default_rng(11)
    # positive integers over 8: exact scores, many ties, no signed zeros
    q = (rng.integers(1, 9, (6, 4)) / 8.0).astype(np.float32)
    t = (rng.integers(1, 9, (300, 4)) / 8.0).astype(np.float32)
    t[299], t[150] = t[0], t[3]
    k = pt_topk.MAX_FUSED_K + 72
    want_v, want_i = jax.lax.top_k(q @ t.T, k)
    before = pt_topk.FULL_ROW_FALLBACKS.get("test.full_row", 0)
    got = pt_topk.full_row_topk(
        torch.from_numpy(q), torch.from_numpy(t), k, where="test.full_row"
    ).numpy()
    assert got.shape == (2, 6, k)
    np.testing.assert_array_equal(got[1], np.asarray(want_i))
    np.testing.assert_array_equal(got[0], np.asarray(want_v))
    assert pt_topk.FULL_ROW_FALLBACKS["test.full_row"] == before + 1


def test_full_row_topk_raises_off_the_cpu():
    # off the CPU and off CUDA there is no route: it raises ValueError (not
    # a silent answer) and is not counted; a CUDA tensor takes the sliced
    # route, whose answer equals the whole row's (run here on the CPU)
    q = torch.ones((4, 3), device="meta")
    t = torch.ones((300, 3), device="meta")
    before = pt_topk.FULL_ROW_FALLBACKS.get("test.off_cpu", 0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pt_topk.full_row_topk(q, t, 200, where="test.off_cpu")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pt_topk.full_row_topk(torch.ones((4, 3)), t, 200, where="test.off_cpu")
    assert pt_topk.FULL_ROW_FALLBACKS.get("test.off_cpu", 0) == before
    qe, te = _inputs("exact", 9, 300, 4, seed=3, tie_rows=((0, 299), (7, 150)))
    qe, te = torch.from_numpy(qe), torch.from_numpy(te)
    got = pt_topk.full_row_sliced(qe, te, 200, rows_per_slice=4)
    want = pt_topk.full_row_topk(qe, te, 200, where="test.off_cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows_per_slice", [1, 3, 8, 64])
def test_full_row_sliced_equals_the_whole_row(rows_per_slice):
    # the card's off-menu route scores a slice of queries at a time; each
    # slice must give the whole row's answer, bit for bit, ties included
    q, t = _inputs("exact", 8, 500, 5, seed=rows_per_slice, tie_rows=((1, 499),))
    q, t = torch.from_numpy(q), torch.from_numpy(t)
    k = pt_topk.MAX_FUSED_K + 40
    got = pt_topk.full_row_sliced(q, t, k, rows_per_slice)
    want = pt_topk.fused_topk_plain(q, t, k, 500)
    assert got.shape == (2, 8, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_full_row_slices_bound_the_memory():
    # 56 bytes per score: at the ML-20M shape 1 GiB holds 716 queries
    per = pt_topk._FULL_ROW_BYTES_PER_SCORE
    assert per == 56
    assert pt_topk.full_row_slices(4096, 26_744) == (1 << 30) // (56 * 26_744) == 716
    assert pt_topk.full_row_slices(10, 26_744) == 10
    assert pt_topk.full_row_slices(4096, 1 << 26) == 1  # never fewer than one
    assert pt_topk.full_row_slices(100, 1 << 20) == (1 << 30) // (56 << 20) == 18


@pytest.mark.parametrize(
    "b,n,r,k,rows_per_slice",
    [(6, 500, 10, 129, 6), (40, 2000, 10, 200, 7), (17, 3000, 32, 300, 1),
     (9, 129, 3, 129, 4)],
)
def test_full_row_route_matches_the_jax_xla_route(b, n, r, k, rows_per_slice):
    # the off-menu route's counterpart in the JAX package is
    # _device_score_topk (a jitted matmul and lax.top_k); random-normal
    # inputs, sliced or whole: ids equal, values within the sgemm's ulps
    from predictionio_tpu.models.recommendation.engine import _device_score_topk

    rng = np.random.default_rng(b * n + k)
    U = rng.standard_normal((b + 5, r)).astype(np.float32)
    V = rng.standard_normal((n, r)).astype(np.float32)
    uidx = rng.permutation(b + 5)[:b]
    want_v, want_i = (np.asarray(x) for x in _device_score_topk(U, V, uidx, k))
    q, t = torch.from_numpy(U[uidx]), torch.from_numpy(V)
    for got in (
        pt_topk.full_row_topk(q, t, k, where="test.xla_route").numpy(),
        pt_topk.full_row_sliced(q, t, k, rows_per_slice).numpy(),
    ):
        assert got.shape == (2, b, k)
        np.testing.assert_array_equal(got[1], want_i)
        np.testing.assert_allclose(got[0], want_v, rtol=RTOL, atol=ATOL)


def test_build_dir_checkout_env_and_user_cache(monkeypatch, tmp_path):
    monkeypatch.delenv("PIO_KERNEL_BUILD_DIR", raising=False)
    # from a checkout: its git-ignored build/kernels/
    assert _kernels.build_dir() == _kernels._CHECKOUT / "build" / "kernels"
    # an installed package (no project file beside it): a per-user cache
    monkeypatch.setattr(_kernels, "_CHECKOUT", tmp_path / "site-packages")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _kernels.build_dir() == (
        tmp_path / "cache" / "predictionio_tpu_torch" / "kernels"
    )
    assert _kernels.library_path("fused_topk").parent == _kernels.build_dir()
    # an explicit directory wins
    monkeypatch.setenv("PIO_KERNEL_BUILD_DIR", str(tmp_path / "mine"))
    assert _kernels.build_dir() == tmp_path / "mine"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_topk_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    # few distinct values: many ties, whose order is part of the contract
    scores = rng.integers(0, 5, (7, 60)).astype(np.float32)
    for k in (1, 5, 60, 80):
        for a, b in zip(
            pt_topk.host_topk(scores[0], k), jax_topk.host_topk(scores[0], k)
        ):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(
            pt_topk.host_topk_batch(scores, k),
            jax_topk.host_topk_batch(scores, k),
        ):
            np.testing.assert_array_equal(a, b)


def test_roofline_matches_jax():
    for shape in ((32, 16, 30_000, 16), (4096, 10, 26_744, 10), (1, 3, 7, 2)):
        assert pt_topk.fused_topk_roofline(*shape) == jax_topk.fused_topk_roofline(
            *shape
        )
    least = pt_topk.fused_topk_least_work(4096, 10, 26_744, 10)
    assert least["flops"] == 2.0 * 4096 * 26_744 * 10
    assert least["bytes"] == 4.0 * (4096 * 10 + 26_744 * 10 + 2 * 4096 * 10)


@pytest.mark.parametrize(
    "b,n,r", [(512, 26_744, 10), (4096, 26_744, 10), (4096, 26_744, 32),
              (300, 3000, 8), (1, 1, 1), (7, 100_000, 300)],
)
def test_kernel_geometry_covers_the_table(b, n, r):
    qpc = pt_topk.query_block(b, pt_topk.MAX_FUSED_K)
    smem = _smem_by_hand(r, pt_topk.MAX_FUSED_K, qpc)
    geo = pt_topk.kernel_geometry(b, n, qpc, smem, H100)
    assert geo["tile_rows"] == pt_topk.TILE_ROWS_CUDA == 64
    # shared memory of one pass-1 CTA fits the 227 KB a launch may opt into
    assert geo["smem_bytes"] == smem <= 227 * 1024
    assert 1 <= geo["ctas_per_sm"] <= pt_topk.CTAS_PER_SM
    # the slabs cover every row, and none is empty
    assert geo["rows_per_split"] % geo["tile_rows"] == 0
    assert (geo["n_splits"] - 1) * geo["rows_per_split"] < n
    assert geo["n_splits"] * geo["rows_per_split"] >= n
    assert geo["n_qblocks"] == -(-b // qpc)
    assert geo["queries_per_cta"] == qpc


def test_kernel_geometry_rejects_rank_past_shared_memory():
    # a CTA past the card's 227 KB, and the library's -1 for an input the
    # kernel refuses
    for smem in (H100.smem_per_cta + 1, _smem_by_hand(2000, 128, 32), -1):
        with pytest.raises(pt_topk.FusedTopKUnsupported):
            pt_topk.kernel_geometry(8, 1000, 32, smem, H100)


@pytest.mark.parametrize(
    "b,k,qpc",
    [(1, 10, 8), (300, 10, 8), (512, 10, 8), (1024, 10, 8), (1025, 10, 32),
     (4096, 10, 32), (100_000, 10, 32), (4096, 64, 32), (4096, 65, 8),
     (4096, 128, 8), (1024, 128, 8)],
)
def test_query_block_by_wave_size(b, k, qpc):
    # up to SMALL_WAVE queries, or past WIDE_K entries per query, a CTA
    # takes 8 queries; else 32
    assert (pt_topk.SMALL_WAVE, pt_topk.WIDE_K) == (1024, 64)
    assert pt_topk.query_block(b, k) == qpc
    assert qpc in pt_topk.QUERY_BLOCKS == (8, 32)


@pytest.mark.parametrize(
    "r,k,smem,per_sm",
    [
        # 4 * (32 rsq + 2 * 64 rst + 64k + 8192 + 1024 + 128): rp = r rounded
        # up to 4, rsq = rp padded to an odd number of 4-float words, rst
        # the same for a tile chunk (at most 64 columns: 68 past rank 64)
        (10, 10, 4 * (32 * 12 + 128 * 12 + 640 + 9344), 4),
        (32, 128, 4 * (32 * 36 + 128 * 36 + 8192 + 9344), 2),
        (33, 100, 4 * (32 * 36 + 128 * 36 + 6400 + 9344), 2),
        (64, 128, 4 * (32 * 68 + 128 * 68 + 8192 + 9344), 2),
        (1, 1, 4 * (32 * 4 + 128 * 4 + 64 + 9344), 4),
        (300, 128, 4 * (32 * 300 + 128 * 68 + 8192 + 9344), 1),
    ],
)
def test_kernel_geometry_by_hand(r, k, smem, per_sm):
    assert _smem_by_hand(r, k, 32) == smem
    geo = pt_topk.kernel_geometry(4096, 26_744, 32, smem, H100)
    assert geo["smem_bytes"] == smem
    assert geo["ctas_per_sm"] == per_sm == min(4, 233_472 // (smem + 1024))
    # 128 blocks of 32 queries; as many slabs as fill the SMs' CTA slots
    assert geo["n_qblocks"] == 128
    assert geo["n_tiles"] == -(-26_744 // 64) == 418
    assert geo["n_splits"] == per_sm * 132 // 128
    # a 512-query wave: 64 blocks of 8 queries (a smaller CTA: 4 fit per
    # SM), more slabs, each of whole tiles
    smem8 = _smem_by_hand(r, k, 8)
    assert smem8 < smem
    small = pt_topk.kernel_geometry(512, 26_744, 8, smem8, H100)
    per_sm8 = min(4, 233_472 // (smem8 + 1024))
    assert small["n_qblocks"] == 64 and small["ctas_per_sm"] == per_sm8
    assert small["n_splits"] * small["rows_per_split"] >= 26_744
    assert small["n_splits"] == -(-418 // -(-418 // (per_sm8 * 132 // 64)))


def test_kernel_geometry_refuses_past_227_kb():
    # past rank 64 the tiles are staged in 64-column chunks, so only the
    # query block grows with the rank: 4 * (32 rsq + 8704 + 64k + 9344)
    # bytes; at k=128 the widest rank that fits is 996 (rsq 996: exactly
    # 232,448 bytes); 997 pads to 1000, rsq 1004 (233,472 bytes)
    assert _smem_by_hand(996, 128, 32) == 232_448 == H100.smem_per_cta
    assert _smem_by_hand(997, 128, 32) == 233_472
    geo = pt_topk.kernel_geometry(8, 1000, 32, _smem_by_hand(996, 128, 32), H100)
    assert geo["ctas_per_sm"] == 1
    with pytest.raises(pt_topk.FusedTopKUnsupported, match="233472"):
        pt_topk.kernel_geometry(8, 1000, 32, _smem_by_hand(997, 128, 32), H100)
    # a smaller k, or a block of 8 queries, leaves room for a wider rank
    assert pt_topk.kernel_geometry(8, 1000, 32, _smem_by_hand(997, 10, 32), H100)
    assert pt_topk.kernel_geometry(8, 1000, 8, _smem_by_hand(2000, 128, 8), H100)
    # every rank the earlier kernel took (its 48 KB tile fit up to rank 307)
    for rank in range(1, 308):
        for qpc in pt_topk.QUERY_BLOCKS:
            pt_topk.kernel_geometry(8, 1000, qpc, _smem_by_hand(rank, 128, qpc), H100)


def test_constants_match_the_cuda_source():
    src = (_kernels.CSRC / "fused_topk.cu").read_text()
    assert f"kRetiredId = 1 << 25;" in src
    assert f"kTileRows = {pt_topk.TILE_ROWS_CUDA};" in src
    assert f"kMaxK = {pt_topk.MAX_FUSED_K};" in src
    for entry in ("pio_fused_topk(", "pio_fused_topk_smem(", "pio_device_smem("):
        assert f"extern \"C\" int {entry}" in src
    name, entry, argtypes = _kernels.KERNELS["fused_topk"]
    assert (name, entry) == ("fused_topk.cu", "pio_fused_topk")
    # ... stream, then the two timing events the launcher records
    assert len(argtypes) == 16
    assert "void* stream,\n                              void* started, void* ended)" in src
    assert _kernels.KERNELS["fused_topk_smem"][:2] == ("fused_topk.cu", "pio_fused_topk_smem")
    assert _kernels.KERNELS["device_smem"][:2] == ("fused_topk.cu", "pio_device_smem")


def test_cuda_wrapper_refuses_cpu_tensors():
    # no quiet fallback: the kernel's wrapper computes nothing on the CPU
    q, t = torch.ones((4, 3)), torch.ones((50, 3))
    geo = pt_topk.kernel_geometry(4, 50, 8, _smem_by_hand(3, 5, 8), H100)
    with pytest.raises(ValueError, match="cpu"):
        pt_topk.fused_topk_cuda(q, t, 5, 50, geo)
