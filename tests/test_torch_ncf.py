"""The port's NCF ops (predictionio_tpu_torch/ops/ncf.py) against the JAX
package's ``ops/ncf.py``, on the CPU.

Both packages start from one parameter tree: the JAX package's
``init_ncf`` draws it, ``params_from_jax`` carries it across as numpy.
Forward and scores agree within rtol 1e-5; every loss and its gradient
within rtol 1e-5 (atol 1e-6 for gradient entries near zero); one Adam and
one AdamW step, and a short epoch fed the JAX package's own permutation and
negatives (drawn with ``jax.random`` from the key ``make_epoch_fn``
splits), leave parameters within atol 1e-5.  Cold trains draw from a
``torch.Generator``, not JAX's PRNG, so the learning checks of
``tests/test_ncf.py`` are held statistically: each taste cluster ranks its
own items above the other's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.ops import ncf as jncf
from predictionio_tpu_torch.ops import ncf as pncf

torch.set_num_threads(2)

RTOL = 1e-5
ATOL_GRAD = 1e-6
ATOL_STEP = 1e-5

HEADS = {
    # name: (mlp_layers, item_bias)
    "mlp_bias": ((16, 8), True),
    "mlp_nobias": ((16, 8), False),
    "gmf_bias": ((), True),
    "gmf_nobias": ((), False),
}


def _carried(mlp, bias, n_users=11, n_items=13, d=6, seed=0):
    """One JAX-drawn tree (random item bias, so the bias term is not 0)
    in both packages: (jax tree of jnp arrays, port tree on the CPU)."""
    p = jncf.NCFParams(embed_dim=d, mlp_layers=mlp, item_bias=bias)
    tree = jax.tree.map(np.asarray, jncf.init_ncf(jax.random.PRNGKey(seed),
                                                  n_users, n_items, p))
    rng = np.random.default_rng(seed)
    if bias:
        tree["item_bias"] = rng.standard_normal(n_items).astype(np.float32)
    tree["out_b"] = rng.standard_normal(1).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), pncf.params_from_jax(tree, "cpu")


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_tree(port_tree, jax_tree, atol, loss="", steps=1, lr=0.0):
    """Every leaf within ``atol``.  Under the sampled softmax, ``out_b``
    shifts every logit alike, so its exact gradient is 0 and what each
    package computes for it is rounding noise, which Adam scales to up to
    ``lr`` a step: that leaf is held within ``steps * lr`` instead."""
    got = pncf.host_params(port_tree)
    want = jax.tree.map(np.asarray, jax_tree)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for name in got:
        tol = atol
        if loss == "softmax" and name == "out_b":
            tol = 2 * steps * lr
        for g, w in zip(jax.tree.leaves(got[name]), jax.tree.leaves(want[name])):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def _cluster_interactions(rng, n_users=40, n_items=30, per_user=6):
    """Two taste clusters: even users like low items, odd users high items
    (``tests/test_ncf.py``'s data)."""
    users, items = [], []
    for u in range(n_users):
        lo, hi = (0, n_items // 2) if u % 2 == 0 else (n_items // 2, n_items)
        for i in rng.choice(np.arange(lo, hi), per_user, replace=False):
            users.append(u)
            items.append(int(i))
    return np.array(users), np.array(items)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_forward_and_scores_match_jax(head):
    jp, tp = _carried(*HEADS[head])
    rng = np.random.default_rng(1)
    u = rng.integers(0, 11, 17).astype(np.int32)
    i = rng.integers(0, 13, 17).astype(np.int32)
    _close(pncf.ncf_forward(tp, torch.from_numpy(u).long(),
                            torch.from_numpy(i).long()),
           jncf.ncf_forward(jp, jnp.asarray(u), jnp.asarray(i)))
    for user in (0, 5, 10):
        _close(pncf.score_all_items(tp, user), jncf.score_all_items(jp, user))
    rows = [3, 0, 7, 7]
    head_t = {k: v for k, v in tp.items() if k in ("mlp", "out_w", "out_b")}
    head_j = {k: v for k, v in jp.items() if k in ("mlp", "out_w", "out_b")}
    bias_t, bias_j = tp.get("item_bias"), jp.get("item_bias")
    got = pncf.score_users_vs_items(head_t, tp["user_emb"][rows],
                                    tp["item_emb"][2:9],
                                    None if bias_t is None else bias_t[2:9])
    want = jncf.score_users_vs_items(head_j, jp["user_emb"][jnp.asarray(rows)],
                                     jp["item_emb"][2:9],
                                     None if bias_j is None else bias_j[2:9])
    assert got.shape == (4, 7)
    _close(got, want)
    # the block computation equals the whole-catalog row
    _close(pncf.score_users_vs_items(head_t, tp["user_emb"][[5]], tp["item_emb"],
                                     bias_t)[0],
           pncf.score_all_items(tp, 5))


def _batch(n_items, k, seed=2, b=9):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 11, b).astype(np.int32)
    pos = rng.integers(0, n_items, b).astype(np.int32)
    neg = rng.integers(0, n_items, (b, k)).astype(np.int32)
    valid = np.ones(b, np.float32)
    valid[-2:] = 0.0  # padding rows take no part
    w = (1.0 / rng.integers(1, 4, b)).astype(np.float32)
    return u, pos, neg, valid, w


def _loss_fns(loss, n_items):
    """(jax loss of (params, batch), port loss of (params, batch))."""
    if loss in ("bpr", "softmax"):
        jf = {"bpr": jncf.bpr_loss, "softmax": jncf.sampled_softmax_loss}[loss]
        pf = {"bpr": pncf.bpr_loss, "softmax": pncf.sampled_softmax_loss}[loss]
        return (lambda p, b: jf(p, b[0], b[1], b[2], b[3]),
                lambda p, b: pf(p, b[0], b[1], b[2], b[3]))
    if loss == "full_softmax":
        return (lambda p, b: jncf.full_softmax_loss(p, b[0], b[1], b[3], n_items),
                lambda p, b: pncf.full_softmax_loss(p, b[0], b[1], b[3], n_items))
    return (lambda p, b: jncf.wals_loss(p, b[0], b[1], b[3], b[4], 2.0, n_items),
            lambda p, b: pncf.wals_loss(p, b[0], b[1], b[3], b[4], 2.0, n_items))


LOSS_CASES = [
    ("bpr", "mlp_bias", 1), ("bpr", "gmf_nobias", 3),
    ("softmax", "mlp_nobias", 4), ("softmax", "gmf_bias", 2),
    ("full_softmax", "gmf_bias", 1), ("full_softmax", "gmf_nobias", 1),
    ("wals", "gmf_bias", 1), ("wals", "gmf_nobias", 1),
]


def _both_batches(k, n_items=13):
    raw = _batch(n_items, k)
    jb = tuple(jnp.asarray(x) for x in raw)
    tb = tuple(torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)
               for x in raw)
    return jb, tb


@pytest.mark.parametrize("loss,head,k", LOSS_CASES,
                         ids=[f"{a}-{b}-k{c}" for a, b, c in LOSS_CASES])
def test_loss_and_gradient_match_jax(loss, head, k):
    jp, tp = _carried(*HEADS[head])
    # the whole-catalog losses mask rows past n_items: give them 2 padding rows
    n_items = 11 if loss in ("full_softmax", "wals") else 13
    jb, tb = _both_batches(k, n_items)
    jf, pf = _loss_fns(loss, n_items)
    want, jgrad = jax.value_and_grad(jf)(jp, jb)
    for leaf in pncf.tree_leaves(tp):
        leaf.requires_grad_(True)
    got = pf(tp, tb)
    got.backward()
    _close(got.detach(), want)
    tgrad = pncf.tree_map(
        lambda x: x.grad.numpy() if x.grad is not None else np.zeros(x.shape),
        tp,
    )
    for g, w in zip(jax.tree.leaves(tgrad), jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL_GRAD)
    if loss in ("full_softmax", "wals"):
        # table rows past the catalog get no gradient
        assert not tgrad["item_emb"][n_items:].any()


def test_whole_catalog_losses_need_the_gmf_head():
    _, tp = _carried((16,), True)
    z = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="mlp_layers"):
        pncf.full_softmax_loss(tp, z, z, torch.ones(2))
    with pytest.raises(ValueError, match="mlp_layers"):
        pncf.wals_loss(tp, z, z, torch.ones(2), torch.ones(2), 2.0, 13)


def _jax_step(jp, optimizer, loss, batch, n_items):
    jf, _ = _loss_fns(loss, n_items)
    value, grads = jax.value_and_grad(jf)(jp, batch)
    updates, _ = optimizer.update(grads, optimizer.init(jp), jp)
    return optax.apply_updates(jp, updates), value


STEP_CASES = [("bpr", "mlp_bias", 0.0), ("softmax", "mlp_bias", 0.01),
              ("full_softmax", "gmf_bias", 0.0), ("wals", "gmf_bias", 0.05)]


@pytest.mark.parametrize("loss,head,wd", STEP_CASES,
                         ids=[f"{a}-wd{c}" for a, _, c in STEP_CASES])
def test_one_adam_or_adamw_step_matches_optax(loss, head, wd):
    mlp, bias = HEADS[head]
    k = 3 if loss == "softmax" else 1
    jp, tp = _carried(mlp, bias)
    jb, tb = _both_batches(k)
    p = pncf.NCFParams(embed_dim=6, mlp_layers=mlp, item_bias=bias, loss=loss,
                       learning_rate=5e-3, weight_decay=wd,
                       negatives_per_positive=k)
    opt = (optax.adamw(p.learning_rate, weight_decay=wd) if wd > 0
           else optax.adam(p.learning_rate))
    want, want_loss = _jax_step(jp, opt, loss, jb, 13)
    for leaf in pncf.tree_leaves(tp):
        leaf.requires_grad_(True)
    optimizer = pncf.make_optimizer(tp, p)
    assert isinstance(optimizer, torch.optim.AdamW if wd > 0 else torch.optim.Adam)
    got_loss = pncf.train_step(tp, optimizer, tb[0], tb[1], tb[2], tb[3], tb[4],
                               p, 13)
    _close(got_loss, want_loss)
    _close_tree(tp, want, ATOL_STEP, loss, 1, p.learning_rate)


EPOCH_CASES = [("bpr", "mlp_bias", 1, 0.0), ("softmax", "mlp_nobias", 3, 0.0),
               ("full_softmax", "gmf_bias", 1, 0.01), ("wals", "gmf_bias", 1, 0.01)]


@pytest.mark.parametrize("loss,head,k,wd", EPOCH_CASES,
                         ids=[c[0] for c in EPOCH_CASES])
def test_short_epoch_on_jax_draws_matches_jax(loss, head, k, wd):
    """Three epochs of four steps (a padded last step), the permutation and
    negatives drawn by jax.random from the key the JAX epoch splits."""
    mlp, bias = HEADS[head]
    rng = np.random.default_rng(4)
    n_users, n_items, n_pos, bs = 11, 13, 58, 16
    users = rng.integers(0, n_users, n_pos).astype(np.int32)
    items = rng.integers(0, n_items, n_pos).astype(np.int32)
    p = pncf.NCFParams(embed_dim=6, mlp_layers=mlp, item_bias=bias, loss=loss,
                       batch_size=bs, learning_rate=1e-2, weight_decay=wd,
                       negatives_per_positive=k, neg_power=0.75)
    jp, tp = _carried(mlp, bias)
    # the JAX package's epoch, as train_ncf runs it
    n_steps = 4
    opt, epoch = jncf._get_epoch_fn(n_steps, bs, n_items, p.learning_rate, None,
                                    loss=loss, k_neg=k, weight_decay=wd,
                                    alpha=p.alpha)
    stream = pncf.stage_stream(users, items, p, torch.device("cpu"))
    assert (stream.n_steps, stream.batch) == (n_steps, bs)
    cdf = pncf.negative_sampling_cdf(items, n_items, p.neg_power)
    np.testing.assert_array_equal(
        cdf, jncf.negative_sampling_cdf(items, n_items, p.neg_power))
    arrays = [jnp.asarray(x.numpy().astype(np.int32 if x.dtype == torch.int64
                                            else np.float32))
              for x in (stream.u, stream.i, stream.valid, stream.w)]
    for leaf in pncf.tree_leaves(tp):
        leaf.requires_grad_(True)
    optimizer = pncf.make_optimizer(tp, p)
    state = opt.init(jp)
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
        got_loss = pncf.train_epoch(tp, optimizer, stream, p, n_items,
                                    perm=torch.from_numpy(perm.astype(np.int64)),
                                    negatives=negatives)
        _close(got_loss.detach(), want_loss, rtol=1e-4)
    _close_tree(tp, jp, ATOL_STEP, loss, 3 * n_steps, p.learning_rate)


@pytest.mark.parametrize("neg_power", [0.0, 0.75, 1.0])
def test_negative_sampling_cdf_matches_jax(neg_power):
    rng = np.random.default_rng(5)
    items = rng.integers(0, 40, 300)
    items = items[items != 7]  # a zero-count item is never drawn
    got = pncf.negative_sampling_cdf(items, 50, neg_power)
    np.testing.assert_array_equal(
        got, jncf.negative_sampling_cdf(items, 50, neg_power))
    g = torch.Generator().manual_seed(9)
    negs = pncf.sample_negatives(torch.from_numpy(got), 400, 3, 50, g).numpy()
    assert negs.min() >= 0 and negs.max() <= 49
    if neg_power > 0:
        assert 7 not in negs and not np.isin(negs, np.arange(40, 50)).any()
    # no draws -> uniform over an empty catalog makes it all-ones weights
    np.testing.assert_array_equal(
        pncf.negative_sampling_cdf(np.array([], np.int64), 4, neg_power),
        jncf.negative_sampling_cdf(np.array([], np.int64), 4, neg_power))


def test_negatives_clamp_at_the_cdf_end():
    """A float32 CDF whose last entry falls below 1.0: a draw above it
    searches past the table and is clamped to the last item, as the JAX
    step clamps it."""
    cdf = torch.tensor([0.25, 0.5, 0.75, 0.999], dtype=torch.float32)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    got = pncf.sample_negatives(cdf, 4000, 2, 4, g1).numpy()
    draws = torch.rand((4000, 2), generator=g2).numpy()
    want = np.minimum(np.asarray(jnp.searchsorted(jnp.asarray(cdf.numpy()),
                                                  jnp.asarray(draws))), 3)
    np.testing.assert_array_equal(got, want)
    assert (draws > 0.999).any() and got.max() == 3


def test_initial_params_overlay_and_errors():
    rng = np.random.default_rng(6)
    users = rng.integers(0, 10, 50)
    items = rng.integers(0, 8, 50)
    p = pncf.NCFParams(embed_dim=4, mlp_layers=(), num_epochs=0)
    full_u = rng.standard_normal((10, 4)).astype(np.float32)
    short_i = rng.standard_normal((5, 4)).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    st = pncf.train_ncf(users, items, 10, 8, p, device="cpu",
                        initial_params={"user_emb": full_u, "item_emb": short_i,
                                        "item_bias": torch.from_numpy(bias)})
    fresh = pncf.train_ncf(users, items, 10, 8, p, device="cpu")
    np.testing.assert_array_equal(st.params["user_emb"].numpy(), full_u)
    np.testing.assert_array_equal(st.params["item_emb"][:5].numpy(), short_i)
    np.testing.assert_array_equal(st.params["item_emb"][5:].numpy(),
                                  fresh.params["item_emb"][5:].numpy())
    np.testing.assert_array_equal(st.params["item_bias"][:3].numpy(), bias)
    assert not st.params["item_bias"][3:].any() and st.epoch_losses == []
    for bad, match in (({"nope": full_u}, "not in the model"),
                       ({"user_emb": np.zeros((10, 3), np.float32)},
                        "does not fit")):
        with pytest.raises(ValueError, match=match):
            pncf.train_ncf(users, items, 10, 8, p, device="cpu",
                           initial_params=bad)
        with pytest.raises(ValueError, match=match):
            jncf.train_ncf(users, items, 10, 8,
                           jncf.NCFParams(embed_dim=4, mlp_layers=(), num_epochs=0),
                           initial_params=bad)


def test_init_draws_the_jax_layout_and_is_seeded():
    for mlp in ((16, 8), ()):
        p = pncf.NCFParams(embed_dim=6, mlp_layers=mlp)
        got = pncf.init_ncf(torch.Generator().manual_seed(0), 11, 13, p)
        want = jncf.init_ncf(jax.random.PRNGKey(0), 11, 13,
                             jncf.NCFParams(embed_dim=6, mlp_layers=mlp))
        assert (jax.tree.structure(pncf.host_params(got))
                == jax.tree.structure(jax.tree.map(np.asarray, want)))
        for g, w in zip(jax.tree.leaves(pncf.host_params(got)),
                        jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == np.float32
        again = pncf.init_ncf(torch.Generator().manual_seed(0), 11, 13, p)
        assert torch.equal(got["user_emb"], again["user_emb"])
    with pytest.raises(ValueError, match="unknown loss"):
        pncf.NCFParams(loss="hinge")


def _learned_clusters(state) -> bool:
    s0 = pncf.score_all_items(state.params, 0).numpy()
    s1 = pncf.score_all_items(state.params, 1).numpy()
    return s0[:15].mean() > s0[15:].mean() and s1[15:].mean() > s1[:15].mean()


LEARN_CASES = {
    "bpr": dict(mlp_layers=(16, 8), num_epochs=150),
    "softmax_k4": dict(mlp_layers=(16, 8), num_epochs=150, loss="softmax",
                       negatives_per_positive=4),
    "bpr_k4": dict(mlp_layers=(16, 8), num_epochs=100, negatives_per_positive=4),
    "full_softmax": dict(mlp_layers=(), num_epochs=150, loss="full_softmax"),
    "wals": dict(mlp_layers=(), num_epochs=150, loss="wals", alpha=2.0),
}


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_training_learns_clusters(case):
    """``tests/test_ncf.py``'s learning checks, on the port's draws: both
    clusters rank their own items first, and the loss falls."""
    users, items = _cluster_interactions(np.random.default_rng(0))
    st = pncf.train_ncf(
        users, items, 40, 30,
        pncf.NCFParams(embed_dim=8, batch_size=256, learning_rate=5e-3,
                       **LEARN_CASES[case]),
        device="cpu",
    )
    assert _learned_clusters(st), case
    assert np.isfinite(st.epoch_losses).all()
    assert st.epoch_losses[-1] < st.epoch_losses[0]
    assert len(st.epoch_seconds) == len(st.epoch_losses)
    assert all(s > 0 for s in st.epoch_seconds)
    assert not any(x.requires_grad for x in pncf.tree_leaves(st.params))


def test_item_bias_toggle():
    users, items = _cluster_interactions(np.random.default_rng(0))
    cfg = dict(embed_dim=8, mlp_layers=(16, 8), num_epochs=20, batch_size=256,
               learning_rate=5e-3)
    with_bias = pncf.train_ncf(users, items, 40, 30,
                               pncf.NCFParams(item_bias=True, **cfg), device="cpu")
    assert with_bias.params["item_bias"].abs().max() > 0
    without = pncf.train_ncf(users, items, 40, 30,
                             pncf.NCFParams(item_bias=False, **cfg), device="cpu")
    assert "item_bias" not in without.params
    s = pncf.score_all_items(without.params, 0).numpy()
    assert s.shape == (30,) and np.isfinite(s).all()


def test_train_is_deterministic_and_wals_weights_count_users():
    rng = np.random.default_rng(7)
    users = rng.integers(0, 9, 70)
    items = rng.integers(0, 6, 70)
    p = pncf.NCFParams(embed_dim=4, mlp_layers=(), loss="wals", num_epochs=3,
                       batch_size=32)
    a = pncf.train_ncf(users, items, 9, 6, p, device="cpu")
    b = pncf.train_ncf(users, items, 9, 6, p, device="cpu")
    assert a.epoch_losses == b.epoch_losses
    assert torch.equal(a.params["user_emb"], b.params["user_emb"])
    stream = pncf.stage_stream(users, items, p, torch.device("cpu"))
    n = len(users)
    w = stream.w.numpy()
    np.testing.assert_allclose(w[:n] * np.bincount(users)[users], 1.0, rtol=1e-6)
    assert not w[n:].any() and not stream.valid[n:].any()


def test_entry_point_needs_cuda_unless_cpu(monkeypatch):
    from predictionio_tpu_torch.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        pncf.train_ncf(np.array([0]), np.array([0]), 1, 1)
    with pytest.raises(DeviceUnavailable):
        pncf.params_from_jax({"out_b": np.zeros(1, np.float32)})


def test_wave_least_work_counts():
    gmf = pncf.ncf_wave_least_work(32, 100, 8, [], 16, True)
    assert gmf["flops"] == 32 * 100 * (2 * 8 + 2)
    assert gmf["bytes"] == 4 * (32 * 8 + 100 * 8 + 1 + 100 + 2 * 32 * 16)
    mlp = pncf.ncf_wave_least_work(32, 100, 16, [(16, 4), (4, 2)], 16, False)
    per_pair = 8 + (2 * 16 * 4 + 8) + (2 * 4 * 2 + 4) + 2 * (8 + 2) + 1
    assert mlp["flops"] == 32 * 100 * per_pair
    assert mlp["bytes"] == 4 * (32 * 16 + 100 * 16 + (1 + 68 + 10 + 10)
                                + 2 * 32 * 16)
