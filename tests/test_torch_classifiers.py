"""The port's classification ops and e2 library against the JAX package's.

- ``ops/classifiers.py``: Naive Bayes statistics (within 1e-6), logistic
  regression weights after 200 steps (within 1e-4 of each tensor's largest
  value) and both score functions, on the same seeded numpy inputs; two
  trains give the same bits; ties of the arg-max take the first index, as
  ``np.argmax`` does in the JAX template.
- ``e2``: every ``tests/test_e2.py`` case on both packages, plus the JAX
  package's counts, tables and k-fold splits compared exactly, and the
  Markov chain's ``-1`` padding summing into its extra bucket.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from predictionio_tpu import e2 as jax_e2
from predictionio_tpu.ops import classifiers as jax_cls
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch import e2 as pt_e2
from predictionio_tpu_torch.models.classification import engine as pt_engine
from predictionio_tpu_torch.ops import classifiers as pt_cls

torch.set_num_threads(2)

#: the e2 library of each package; the port's trains on the CPU
E2 = {"jax": (jax_e2, {}), "torch": (pt_e2, {"device": "cpu"})}


def _data(seed=0, n=600, f=12, c=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    # planted classes over non-negative integer features, as multinomial NB
    # needs
    rates = rng.uniform(0.5, 4.0, (c, f))
    x = rng.poisson(rates[y]).astype(np.float32)
    return x, y, c


def test_naive_bayes_statistics_match_jax():
    x, y, c = _data()
    for lam in (1.0, 0.25):
        pj, tj = jax_cls.train_naive_bayes(x, y, c, lam=lam)
        pp, tp = pt_cls.train_naive_bayes(x, y, c, lam=lam, device="cpu")
        np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=0, atol=1e-6)
        xq = x[:64]
        sj = np.asarray(jax_cls.naive_bayes_scores(pj, tj, xq))
        sp = pt_cls.naive_bayes_scores(pp, tp, torch.from_numpy(xq)).numpy()
        np.testing.assert_allclose(sp, sj, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_logistic_regression_matches_jax_after_200_steps(reg):
    x, y, c = _data(seed=1)
    wj, bj = jax_cls.train_logistic_regression(
        x, y, c, reg=reg, learning_rate=0.1, num_iterations=200
    )
    wp, bp = pt_cls.train_logistic_regression(
        x, y, c, reg=reg, learning_rate=0.1, num_iterations=200, device="cpu"
    )
    wj, bj = np.asarray(wj), np.asarray(bj)
    assert np.abs(wp.numpy() - wj).max() <= 1e-4 * np.abs(wj).max()
    assert np.abs(bp.numpy() - bj).max() <= 1e-4 * np.abs(bj).max()
    xq = x[:64]
    sj = np.asarray(jax_cls.logreg_scores(wj, bj, xq))
    sp = pt_cls.logreg_scores(
        torch.tensor(wj), torch.tensor(bj), torch.from_numpy(xq)
    ).numpy()
    np.testing.assert_allclose(sp, sj, rtol=1e-5, atol=1e-5)


def test_two_trains_give_the_same_bits():
    x, y, c = _data(seed=2)
    a = pt_cls.train_naive_bayes(
        x, y, c, device="cpu"
    ) + pt_cls.train_logistic_regression(x, y, c, num_iterations=50, device="cpu")
    b = pt_cls.train_naive_bayes(
        x, y, c, device="cpu"
    ) + pt_cls.train_logistic_regression(x, y, c, num_iterations=50, device="cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_trains_need_a_card_unless_asked_for_the_cpu(monkeypatch, as_tensor):
    """``device=None`` means CUDA for numpy and CPU-tensor inputs alike:
    without a card both trains raise instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, c = _data(n=40)
    if as_tensor:
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_cls.train_naive_bayes(x, y, c)
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_cls.train_logistic_regression(x, y, c, num_iterations=2)
    pi, _ = pt_cls.train_naive_bayes(x, y, c, device="cpu")
    assert pi.device.type == "cpu"


def test_argmax_ties_take_the_first_index():
    """Equal scores answer the lowest class index, as ``np.argmax`` does
    in the JAX template: two classes with identical statistics and a
    query that favours neither."""
    model = pt_cls.NaiveBayesModel(
        pi=torch.tensor([-1.0, -0.5, -0.5, -0.5]),
        theta=torch.tensor([[-2.0, -2.0], [-1.0, -1.0], [-1.0, -1.0],
                            [-1.0, -1.0]]),
        labels=np.array([0.0, 1.0, 2.0, 3.0], np.float32),
    )
    scores = pt_cls.naive_bayes_scores(
        model.pi, model.theta, torch.tensor([[1.0, 1.0], [0.0, 0.0]])
    )
    assert pt_engine._best(scores).tolist() == [1, 1]
    assert np.argmax(scores.numpy(), 1).tolist() == [1, 1]
    algo = pt_engine.NaiveBayesAlgorithm()
    q = pt_engine.Query(1.0, 1.0, 0.0)
    model3 = pt_cls.NaiveBayesModel(
        pi=torch.zeros(3), theta=torch.zeros(3, 3),
        labels=np.array([5.0, 6.0, 7.0], np.float32),
    )
    assert algo.predict(model3, q).label == 5.0
    assert [p.label for _, p in algo.batch_predict(model3, [(0, q), (1, q)])] == [
        5.0, 5.0,
    ]


# ---------------------------------------------------------------------------
# e2: every tests/test_e2.py case, on both packages
# ---------------------------------------------------------------------------

WEATHER = [
    ("play", ("sunny", "mild", "normal")),
    ("play", ("overcast", "hot", "high")),
    ("play", ("rain", "mild", "high")),
    ("stay", ("rain", "cool", "high")),
    ("stay", ("sunny", "hot", "high")),
    ("stay", ("sunny", "hot", "normal")),
]


def _points(pkg):
    return [pkg.LabeledPoint(l, f) for l, f in WEATHER]


@pytest.fixture(params=sorted(E2))
def e2(request):
    return E2[request.param]


def test_cnb_priors_and_likelihoods(e2):
    pkg, kw = e2
    model = pkg.CategoricalNaiveBayes.train(_points(pkg), **kw)
    assert model.priors["play"] == pytest.approx(math.log(0.5))
    assert model.priors["stay"] == pytest.approx(math.log(0.5))
    assert model.likelihoods["play"][0]["sunny"] == pytest.approx(math.log(1 / 3))
    assert model.likelihoods["stay"][2]["high"] == pytest.approx(math.log(2 / 3))


def test_cnb_log_score_and_predict(e2):
    pkg, kw = e2
    model = pkg.CategoricalNaiveBayes.train(_points(pkg), **kw)
    s = model.log_score(pkg.LabeledPoint("play", ("rain", "mild", "high")))
    assert s == pytest.approx(
        math.log(0.5) + math.log(1 / 3) + math.log(2 / 3) + math.log(2 / 3)
    )
    assert model.log_score(
        pkg.LabeledPoint("play", ("snow", "mild", "high"))
    ) == float("-inf")
    assert model.log_score(pkg.LabeledPoint("nope", ("rain", "mild", "high"))) is None
    assert model.predict(("rain", "mild", "high")) == "play"
    assert model.predict(("sunny", "hot", "high")) == "stay"


def test_cnb_default_likelihood_override(e2):
    pkg, kw = e2
    model = pkg.CategoricalNaiveBayes.train(_points(pkg), **kw)
    s = model.log_score(
        pkg.LabeledPoint("play", ("snow", "mild", "high")),
        default_likelihood=lambda vals: min(vals) - 1.0,
    )
    assert np.isfinite(s)


def test_markov_train_and_predict(e2):
    pkg, kw = e2
    model = pkg.MarkovChain.train(
        [0, 0, 1, 2], [1, 2, 2, 0], [3.0, 1.0, 2.0, 5.0], n_states=3, top_n=2,
        **kw,
    )
    probs = model.predict([1.0, 0.0, 0.0])
    assert probs[1] == pytest.approx(0.75)
    assert probs[2] == pytest.approx(0.25)
    probs = model.predict([0.0, 0.0, 1.0])
    assert probs[0] == pytest.approx(1.0)


def test_markov_top_n_truncation(e2):
    pkg, kw = e2
    model = pkg.MarkovChain.train(
        [0, 0, 0], [1, 2, 3], [5.0, 3.0, 1.0], n_states=4, top_n=2, **kw
    )
    probs = model.predict([1.0, 0.0, 0.0, 0.0])
    assert probs[3] == 0.0
    assert probs[1] == pytest.approx(5 / 9)


def test_binary_vectorizer_fit_and_transform(e2):
    pkg, _ = e2
    maps = [
        {"color": "red", "size": "big", "junk": "x"},
        {"color": "blue", "size": "big"},
    ]
    vec = pkg.BinaryVectorizer.fit(maps, properties={"color", "size"})
    assert vec.num_features == 3
    out = vec.transform([{"color": "red", "size": "big"}])
    assert out.shape == (1, 3)
    assert out.sum() == 2.0
    assert vec.to_binary([("color", "green")]).sum() == 0.0


def test_binary_vectorizer_from_pairs_ordering(e2):
    pkg, _ = e2
    vec = pkg.BinaryVectorizer.from_pairs([("a", "1"), ("b", "2")])
    assert list(vec.to_binary([("b", "2")])) == [0.0, 1.0]


def test_split_data_kfold_partitions(e2):
    pkg, _ = e2
    data = list(range(10))
    folds = pkg.split_data(
        3, data, {"k": 3},
        training_data_creator=list,
        query_creator=lambda d: ("q", d),
        actual_creator=lambda d: ("a", d),
    )
    assert len(folds) == 3
    for fold_idx, (train, info, qa) in enumerate(folds):
        assert info == {"k": 3}
        test_points = {d for (_, d), _ in qa}
        assert all(i % 3 == fold_idx for i in test_points)
        assert sorted(train + list(test_points)) == data


# ---------------------------------------------------------------------------
# e2: exact equality with the JAX package
# ---------------------------------------------------------------------------


def test_cnb_tables_equal_jax_on_random_points():
    rng = np.random.default_rng(4)
    vals = [["a", "b", "c"], ["x", "y"], ["p", "q", "r", "s"]]
    raw = [
        (str(rng.integers(0, 3)), tuple(v[rng.integers(0, len(v))] for v in vals))
        for _ in range(300)
    ]
    mj = jax_e2.CategoricalNaiveBayes.train(
        [jax_e2.LabeledPoint(l, f) for l, f in raw]
    )
    mp = pt_e2.CategoricalNaiveBayes.train(
        [pt_e2.LabeledPoint(l, f) for l, f in raw], device="cpu"
    )
    assert mp.priors == mj.priors
    assert mp.likelihoods == mj.likelihoods
    for feats in [f for _, f in raw[:40]]:
        assert mp.predict(feats) == mj.predict(feats)


def test_markov_chain_equals_jax_with_padding_bucket():
    """Rows with fewer than top_n successors are padded with ``-1``; the
    padding's weight sums into bucket ``n_states`` and is sliced off, so
    the answer equals the JAX package's, and a state with no successors
    contributes nothing."""
    rng = np.random.default_rng(5)
    n = 9
    rows = rng.integers(0, n - 1, 40)  # state n-1 has no successors
    cols = rng.integers(0, n, 40)
    counts = rng.integers(1, 6, 40).astype(np.float64)
    mj = jax_e2.MarkovChain.train(rows, cols, counts, n_states=n, top_n=3)
    mp = pt_e2.MarkovChain.train(
        rows, cols, counts, n_states=n, top_n=3, device="cpu"
    )
    assert np.array_equal(mp.indices.numpy(), np.asarray(mj.indices))
    assert np.array_equal(mp.probs.numpy(), np.asarray(mj.probs))
    assert (mp.indices.numpy() == -1).any()
    for _ in range(5):
        cur = rng.random(n).tolist()
        np.testing.assert_allclose(mp.predict(cur), mj.predict(cur), rtol=1e-6,
                                   atol=1e-7)
    only_last = [0.0] * (n - 1) + [1.0]
    assert mp.predict(only_last) == [0.0] * n


def test_e2_train_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_e2.CategoricalNaiveBayes.train(_points(pt_e2))
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_e2.MarkovChain.train([0], [1], [1.0], n_states=2, top_n=1)


def test_split_data_folds_equal_the_jax_package():
    data = [(i, f"x{i}") for i in range(23)]
    args = dict(
        training_data_creator=lambda sel: [d for d, _ in sel],
        query_creator=lambda d: d[1],
        actual_creator=lambda d: d[0] * 2,
    )
    for k in (1, 4, 5):
        assert pt_e2.split_data(k, data, {"k": k}, **args) == jax_e2.split_data(
            k, data, {"k": k}, **args)
    with pytest.raises(ValueError):
        pt_e2.split_data(0, data, {}, **args)
