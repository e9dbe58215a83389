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
    geo = pt_topk.kernel_geometry(8, 5000, 4, sm_count=132)
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
    # a tensor off the CPU gets no plain-version answer: there is no
    # full-row kernel yet, so it raises (and is not counted)
    q = torch.ones((4, 3), device="meta")
    t = torch.ones((300, 3), device="meta")
    before = pt_topk.FULL_ROW_FALLBACKS.get("test.off_cpu", 0)
    with pytest.raises(pt_topk.FusedTopKUnsupported, match="not ported"):
        pt_topk.full_row_topk(q, t, 200, where="test.off_cpu")
    assert pt_topk.FULL_ROW_FALLBACKS.get("test.off_cpu", 0) == before


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
    geo = pt_topk.kernel_geometry(b, n, r, sm_count=132)
    assert geo["tile_rows"] % 32 == 0 and 32 <= geo["tile_rows"] <= 256
    # shared memory of one pass-1 CTA fits the 48 KB a launch may use
    smem = 4 * (pt_topk.QUERIES_PER_CTA * r + geo["tile_rows"] * (r | 1))
    assert smem <= 48 * 1024
    # the slabs cover every row, and none is empty
    assert geo["rows_per_split"] % geo["tile_rows"] == 0
    assert (geo["n_splits"] - 1) * geo["rows_per_split"] < n
    assert geo["n_splits"] * geo["rows_per_split"] >= n
    assert geo["n_qblocks"] == -(-b // pt_topk.QUERIES_PER_CTA)


def test_kernel_geometry_rejects_rank_past_shared_memory():
    with pytest.raises(pt_topk.FusedTopKUnsupported):
        pt_topk.kernel_geometry(8, 1000, 2000, sm_count=132)


def test_constants_match_the_cuda_source():
    src = (_kernels.CSRC / "fused_topk.cu").read_text()
    assert f"kRetiredId = 1 << 25;" in src
    assert f"kQueriesPerCta = {pt_topk.QUERIES_PER_CTA};" in src
    assert "extern \"C\" int pio_fused_topk(" in src
    name, entry, argtypes = _kernels.KERNELS["fused_topk"]
    assert (name, entry) == ("fused_topk.cu", "pio_fused_topk")
    assert len(argtypes) == 14


def test_cuda_wrapper_refuses_cpu_tensors():
    # no quiet fallback: the kernel's wrapper computes nothing on the CPU
    q, t = torch.ones((4, 3)), torch.ones((50, 3))
    geo = pt_topk.kernel_geometry(4, 50, 3, sm_count=1)
    with pytest.raises(ValueError, match="cpu"):
        pt_topk.fused_topk_cuda(q, t, 5, 50, geo)
