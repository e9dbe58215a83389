"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). This file imports nothing of JAX, so it runs on
a GPU host that has none:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

On exact-arithmetic inputs (integers in [-8, 8] over 8) every score is exact
in fp32 whatever the summation order, so the kernel must be bitwise equal
to the plain version, ties and the ``limit`` mask included.  On
random-normal inputs values agree within rtol=1e-5 (cuBLAS sums in another
order), and ids wherever no near-tie makes the order ambiguous.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import topk

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
