"""The port's ALS family (similarproduct, likealgo, cooccurrence,
recommendeduser, ecommerce) against the JAX package's, on the CPU.

Every case of ``tests/test_templates.py`` for ``TestSimilarProduct``,
``TestECommerce``, ``TestLikeAlgorithm`` and ``TestRecommendedUser`` runs
on the same events (written by the JAX package into a fresh home; the port
reads the same sqlite file):

- answers from the same factors: the JAX package trains, its persisted
  dict is carried across by ``from_jax_params``, and both packages answer
  the case's queries: scores within rtol 1e-5 (atol 1e-6), ids equal
  apart from near ties (clustered items score within an ulp of each
  other), and the template test's own assertion holds on the port's
  answer;
- trains from one start: each engine module's ``train_als`` is wrapped in
  the test to pass one seeded ``init_factors`` (no file of the JAX package
  changes); the COO streams the two engines build are equal, and the
  factors within 2e-3, as ``tests/test_torch_als.py`` holds them;
- co-occurrence counts (dense matmul and sparse host paths) and
  ``latest_rating_per_pair`` exactly; ``CategoryIndex``/``exclude_mask``
  exactly;
- the persisted dicts round-trip both ways, key for key;
- ``python -m predictionio_tpu_torch.tools.cli`` app new -> import ->
  train (``--device cpu``) of ``similarproduct`` (``als`` +
  ``cooccurrence``), ``recommendeduser`` and ``ecommerce`` engine.json
  files; both packages deploy each instance and answer alike.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.data.datamap import DataMap as JaxDataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.models import filters as jax_filters
from predictionio_tpu.models.ecommerce import engine as jax_ec
from predictionio_tpu.models.similarproduct import engine as jax_sp
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models import filters as pt_filters
from predictionio_tpu_torch.models.ecommerce import engine as pt_ec
from predictionio_tpu_torch.models.similarproduct import engine as pt_sp
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tools import cli

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
FACTOR_ATOL = 2e-3


# -- the template tests' events ---------------------------------------------------


def _set(etype, eid, props=None):
    return JaxEvent(event="$set", entity_type=etype, entity_id=eid,
                    properties=JaxDataMap(props or {}))


def _act(event, user, target_id, target_type="item", props=None):
    return JaxEvent(event=event, entity_type="user", entity_id=user,
                    target_entity_type=target_type, target_entity_id=target_id,
                    properties=JaxDataMap(props or {}))


def _similar_events():
    ev = [_set("user", f"u{u}") for u in range(12)]
    ev += [_set("item", f"i{i}", {"categories": ["catA" if i < 5 else "catB"]})
           for i in range(10)]
    for u in range(12):
        base = 0 if u < 6 else 5
        ev += [_act("view", f"u{u}", f"i{base + i}") for i in range(5)]
    return ev


def _rated_similar_events():
    """The train-with-rate-event variant: ``rate`` events whose rating is
    the weight, beside the views."""
    ev = _similar_events()
    rng = np.random.default_rng(4)
    for u in range(12):
        base = 0 if u < 6 else 5
        for i in rng.choice(5, 3, replace=False):
            ev.append(_act("rate", f"u{u}", f"i{base + i}",
                           props={"rating": float(rng.integers(1, 11)) / 2}))
    return ev


def _like_events():
    ev = [_set("user", f"u{u}") for u in range(8)]
    ev += [_set("item", f"i{i}") for i in range(6)]
    for u in range(8):
        ev += [_act("like", f"u{u}", "i0"), _act("like", f"u{u}", "i1"),
               _act("like", f"u{u}", "i2"), _act("dislike", f"u{u}", "i2")]
    ev += [_act("like", f"u{u}", "i3") for u in range(4)]
    return ev


def _ecomm_events():
    ev = [_set("user", f"u{u}") for u in range(10)]
    ev += [_set("item", f"i{i}", {"categories": ["electronics" if i < 4 else "books"]})
           for i in range(8)]
    for u in range(10):
        base = 0 if u < 5 else 4
        ev += [_act("view", f"u{u}", f"i{base + i}") for i in range(4)]
    ev += [_act("buy", f"u{u}", "i0") for u in range(5)]
    # rated views (train-with-rate-event): the latest rating per pair wins
    ev += [_act("rate", "u1", "i2", props={"rating": 2.0}),
           _act("rate", "u1", "i2", props={"rating": 4.5}),
           _act("rate", "u6", "i5", props={"rating": 0.5})]
    return ev


def _social_events():
    ev = [_set("user", f"u{u}") for u in range(12)]
    for u in range(12):
        lo = 0 if u < 6 else 6
        ev += [_act("view", f"u{u}", f"u{v}", target_type="user")
               for v in range(lo, lo + 6) if v != u]
    return ev


APPS = {
    "similar": _similar_events,
    "rated": _rated_similar_events,
    "like": _like_events,
    "ecomm": _ecomm_events,
    "social": _social_events,
}


@pytest.fixture()
def home(tmp_path):
    """Open one app's home: the JAX package's storage (the process-wide one,
    which the JAX ecommerce engine reads at serving time) and the port's
    storage over the same sqlite file."""
    opened = []

    def open_app(app: str):
        env = {"PIO_HOME": str(tmp_path / app / "pio_home")}
        jax_storage = jax_reset_storage(JaxStorageConfig.from_env(env))
        app_id = jax_cmd.app_new(jax_storage, app).app.id
        jax_storage.l_events().insert_batch(APPS[app](), app_id)
        storage = StorageRuntime(StorageConfig.from_env(env))
        opened.append((jax_storage, storage))
        return jax_storage, storage, app_id

    yield open_app
    for jax_storage, storage in opened:
        storage.close()
        jax_storage.close()


# -- the engines of both packages -------------------------------------------------

MODS = {
    "similarproduct": (jax_sp, pt_sp),
    "recommendeduser": (jax_sp, pt_sp),
    "ecommerce": (jax_ec, pt_ec),
}


def _variant(app, algos, ds_extra=None):
    ds = {"appName": app, **(ds_extra or {})}
    return {"datasource": {"params": ds},
            "algorithms": [{"name": n, "params": p} for n, p in algos]}


def _engine(mod, factory):
    return getattr(mod, f"{factory}_engine")()


def _jax_train(factory, variant, jax_storage):
    engine = _engine(MODS[factory][0], factory)
    params = engine.params_from_json(variant)
    ctx = JaxEngineContext(storage=jax_storage)
    _, _, algos, serving = engine.instantiate(params)
    return engine, params, algos, serving, engine.train(ctx, params), ctx


def _port_train(factory, variant, storage):
    engine = _engine(MODS[factory][1], factory)
    params = engine.params_from_json(variant)
    ctx = EngineContext(storage=storage, device="cpu")
    _, _, algos, serving = engine.instantiate(params)
    return engine, params, algos, serving, engine.train(ctx, params), ctx


def _carry(jax_algo, jax_model, jax_ctx, storage):
    """The JAX-trained model in the port, through its persisted dict."""
    persisted = jax_algo.make_persistent_model(jax_ctx, jax_model)
    if isinstance(jax_model, jax_ec.ECommModel):
        return pt_ec.ECommModel.from_jax_params(persisted, "cpu", storage=storage)
    if isinstance(jax_model, jax_sp.CooccurrenceModel):
        return pt_sp.CooccurrenceModel.from_jax_params(persisted, "cpu")
    return pt_sp.SimilarProductModel.from_jax_params(persisted, "cpu")


def _pairs(result):
    return [(s.item, s.score) for s in result.item_scores]


def _same(got, want, what):
    """Scores within RTOL; ids equal apart from near ties: an id out of
    place sits where ``want`` has a score within RTOL of the one it holds
    in ``want`` (or, cut off there, of ``want``'s last score).  Clustered
    items score within an ulp of each other, and the two packages' CPU
    matmuls may round them apart."""
    gi, gs = [i for i, _ in got], np.asarray([s for _, s in got])
    wi, ws = [i for i, _ in want], np.asarray([s for _, s in want])
    assert len(gi) == len(wi), what
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL, err_msg=str(what))
    for j in np.flatnonzero(np.asarray(gi, object) != np.asarray(wi, object)):
        ref = ws[wi.index(gi[j])] if gi[j] in wi else ws[-1]
        assert abs(ws[j] - ref) <= RTOL * abs(ws[j]) + ATOL, (what, j)


def _query(mod, cls_name, kw):
    return getattr(mod, cls_name)(**kw)


# -- answers from the same factors: every template case ---------------------------


def _cluster_a(r):
    return r and {i for i, _ in r[:2]} <= {"i1", "i2", "i3", "i4"} \
        and "i0" not in {i for i, _ in r}


def _seen_free(r):
    return r and not ({i for i, _ in r} & {"i0", "i1", "i2", "i3"})


def _unavailable(jax_storage, app_id):
    jax_storage.l_events().insert(
        JaxEvent(event="$set", entity_type="constraint", entity_id="unavailableItems",
                 properties=JaxDataMap({"items": ["i1", "i2"]})), app_id)


def _cold_view(jax_storage, app_id):
    jax_storage.l_events().insert(_act("view", "coldu", "i4"), app_id)


#: case -> (app, factory, algorithms, datasource params, query class,
#: queries, a change to the store after training, the template's check on
#: the answer to the first query)
CASES = {
    "similar_als_clusters": (
        "similar", "similarproduct", [("als", {"rank": 6, "numIterations": 10})], None,
        "Query", [{"items": ("i0",), "num": 4}, {"items": ("i0", "i7"), "num": 10}],
        None, _cluster_a),
    "similar_category_filters": (
        "similar", "similarproduct", [("als", {"rank": 6, "numIterations": 10})], None,
        "Query", [{"items": ("i0",), "num": 8, "categories": ("catA",)},
                  {"items": ("i0",), "num": 8, "category_black_list": ("catA",)}],
        None, lambda r: all(i in {"i1", "i2", "i3", "i4"} for i, _ in r)),
    "similar_white_black_lists": (
        "similar", "similarproduct", [("als", {"rank": 6, "numIterations": 10})], None,
        "Query", [{"items": ("i0",), "num": 8, "white_list": ("i1", "i2")},
                  {"items": ("i0",), "num": 8, "black_list": ("i1",)}],
        None, lambda r: {i for i, _ in r} <= {"i1", "i2"}),
    "similar_unknown_items_empty": (
        "similar", "similarproduct", [("als", {"numIterations": 2})], None,
        "Query", [{"items": ("nope",)}], None, lambda r: r == []),
    "similar_cooccurrence": (
        "similar", "similarproduct", [("cooccurrence", {"n": 5})], None,
        "Query", [{"items": ("i0",), "num": 4}, {"items": ("i0", "i6"), "num": 10,
                                                  "categories": ("catB",)}],
        None, lambda r: {i for i, _ in r} == {"i1", "i2", "i3", "i4"}
        and all(s == 6.0 for _, s in r)),
    "similar_persistence_roundtrip": (
        "similar", "similarproduct", [("als", {"numIterations": 3})], None,
        "Query", [{"items": ("i0",), "num": 3}], None, lambda r: len(r) > 0),
    "similar_multi_algorithm_serve": (
        "rated", "similarproduct",
        [("als", {"rank": 6, "numIterations": 10}), ("cooccurrence", {"n": 5})],
        {"eventNames": ["view", "rate"]},
        "Query", [{"items": ("i0",), "num": 4}, {"items": ("i5", "i9"), "num": 6}],
        None, lambda r: len(r) == 4),
    "ecomm_known_user_unseen_only": (
        "ecomm", "ecommerce", [("ecomm", {"appName": "ecomm", "rank": 6,
                                          "numIterations": 8})], None,
        "Query", [{"user": "u0", "num": 8}, {"user": "u6", "num": 3}],
        None, _seen_free),
    "ecomm_unavailable_items_constraint": (
        "ecomm", "ecommerce", [("ecomm", {"appName": "ecomm", "rank": 6,
                                          "numIterations": 8, "unseenOnly": False})],
        None, "Query", [{"user": "u0", "num": 8}, {"user": "nobody", "num": 8}],
        _unavailable, lambda r: not ({i for i, _ in r} & {"i1", "i2"})),
    "ecomm_cold_user_similar_fallback": (
        "ecomm", "ecommerce", [("ecomm", {"appName": "ecomm", "rank": 6,
                                          "numIterations": 8})], None,
        "Query", [{"user": "coldu", "num": 3}, {"user": "coldu", "num": 20}],
        _cold_view, lambda r: r and "i4" not in {i for i, _ in r}),
    "ecomm_unknown_user_popularity_fallback": (
        "ecomm", "ecommerce", [("ecomm", {"appName": "ecomm", "rank": 6,
                                          "numIterations": 8, "unseenOnly": False})],
        None, "Query", [{"user": "nobody", "num": 3},
                        {"user": "nobody", "num": 8, "black_list": ("i0",)}],
        None, lambda r: r[0] == ("i0", 5.0)),
    "ecomm_category_filter": (
        "ecomm", "ecommerce", [("ecomm", {"appName": "ecomm", "rank": 6,
                                          "numIterations": 8, "unseenOnly": False})],
        None, "Query", [{"user": "u0", "num": 8, "categories": ("books",)},
                        {"user": "u0", "num": 8, "white_list": ("i5", "i1")}],
        None, lambda r: r and {i for i, _ in r} <= {"i4", "i5", "i6", "i7"}),
    "like_dislike_is_negative_signal": (
        "like", "similarproduct", [("likealgo", {"rank": 4, "numIterations": 10})],
        {"eventNames": ["like", "dislike"]},
        "Query", [{"items": ("i0",), "num": 5}],
        None, lambda r: "i1" in [i for i, _ in r] and "i2" not in [i for i, _ in r][:1]),
    "recuser_similar_users_from_same_community": (
        "social", "recommendeduser", [("als", {"rank": 6, "numIterations": 10})],
        {"targetEntityType": "user"},
        "UserQuery", [{"users": ("u0",), "num": 4}, {"users": ("u0", "u8"), "num": 11}],
        None, lambda r: r and {i for i, _ in r[:3]} <= {f"u{n}" for n in range(1, 6)}
        and "u0" not in {i for i, _ in r} and all(s > 0 for _, s in r)),
    "recuser_black_and_white_lists": (
        "social", "recommendeduser", [("als", {"rank": 6, "numIterations": 10})],
        {"targetEntityType": "user"},
        "UserQuery", [{"users": ("u0",), "num": 6, "black_list": ("u1", "u2")},
                      {"users": ("u0",), "num": 6, "white_list": ("u3", "u4")}],
        None, lambda r: {"u1", "u2"}.isdisjoint({i for i, _ in r})),
    "recuser_unknown_users_empty": (
        "social", "recommendeduser", [("als", {"rank": 6, "numIterations": 10})],
        {"targetEntityType": "user"},
        "UserQuery", [{"users": ("nope",)}], None, lambda r: r == []),
    "recuser_persistence_roundtrip": (
        "social", "recommendeduser", [("als", {"rank": 6, "numIterations": 10})],
        {"targetEntityType": "user"},
        "UserQuery", [{"users": ("u7",), "num": 3}], None, lambda r: len(r) == 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_answers_from_the_same_factors_match_jax(home, case):
    app, factory, algos, ds, qcls, queries, change, check = CASES[case]
    jax_storage, storage, app_id = home(app)
    variant = _variant(app, algos, ds)
    _, _, jalgos, jserving, jmodels, jctx = _jax_train(factory, variant, jax_storage)
    pengine = _engine(MODS[factory][1], factory)
    _, _, palgos, pserving = pengine.instantiate(pengine.params_from_json(variant))
    pmodels = [_carry(a, m, jctx, storage) for a, m in zip(jalgos, jmodels)]
    if change is not None:
        change(jax_storage, app_id)
    jmod, pmod = MODS[factory]
    for n, kw in enumerate(queries):
        jq, pq = _query(jmod, qcls, kw), _query(pmod, qcls, kw)
        want = jserving.serve(jq, [a.predict(m, jq) for a, m in zip(jalgos, jmodels)])
        got = pserving.serve(pq, [a.predict(m, pq) for a, m in zip(palgos, pmodels)])
        _same(_pairs(got), _pairs(want), (case, kw))
        if n == 0:
            assert check(_pairs(got)), (case, _pairs(got))


# -- trains from one start --------------------------------------------------------


def _seeded_train_als(monkeypatch, mod, seen):
    """Wrap ``mod.train_als`` so that it starts from factors drawn from one
    seed and records the COO stream it was given."""
    real = mod.train_als

    def wrapped(u, i, r, num_users, num_items, params, **kw):
        rng = np.random.default_rng(11)
        init = tuple(
            (np.abs(rng.standard_normal((n, params.rank))) / np.sqrt(params.rank))
            .astype(np.float32)
            for n in (num_users, num_items)
        )
        seen.append((np.asarray(u), np.asarray(i), np.asarray(r)))
        return real(u, i, r, num_users=num_users, num_items=num_items,
                    params=params, init_factors=init, **kw)

    monkeypatch.setattr(mod, "train_als", wrapped)


TRAIN_CASES = {
    "similar_als": ("similar", "similarproduct",
                    [("als", {"rank": 6, "numIterations": 10, "alpha": 2.0})], None),
    "similar_als_rated": ("rated", "similarproduct",
                          [("als", {"rank": 5, "numIterations": 8})],
                          {"eventNames": ["view", "rate"]}),
    "likealgo": ("like", "similarproduct", [("likealgo", {"rank": 4, "numIterations": 10})],
                 {"eventNames": ["like", "dislike"]}),
    "recommendeduser": ("social", "recommendeduser",
                        [("als", {"rank": 6, "numIterations": 10})],
                        {"targetEntityType": "user"}),
    "ecommerce": ("ecomm", "ecommerce",
                  [("ecomm", {"appName": "ecomm", "rank": 6, "numIterations": 8})], None),
    "ecommerce_rate": ("ecomm", "ecommerce",
                       [("ecomm", {"appName": "ecomm", "rank": 3, "numIterations": 6,
                                   "trainEvents": ["view", "rate"]})],
                       {"eventNames": ["view", "buy", "rate"]}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_trains_from_one_start_match_jax(home, monkeypatch, case):
    app, factory, algos, ds = TRAIN_CASES[case]
    jax_storage, storage, _ = home(app)
    jmod, pmod = MODS[factory]
    jseen, pseen = [], []
    _seeded_train_als(monkeypatch, jmod, jseen)
    _seeded_train_als(monkeypatch, pmod, pseen)
    variant = _variant(app, algos, ds)
    jmodel = _jax_train(factory, variant, jax_storage)[4][0]
    pmodel = _port_train(factory, variant, storage)[4][0]
    for (ju, ji, jr), (pu, pi, pr) in zip(jseen, pseen, strict=True):
        np.testing.assert_array_equal(pu, ju)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pr, jr)
        assert pr.dtype == jr.dtype
    if case == "likealgo":
        assert set(pseen[0][2].tolist()) == {-1.0, 1.0}  # the signed weights
    names = ["item_factors"] + (["user_factors"] if factory == "ecommerce" else [])
    for name in names:
        got = getattr(pmodel, name)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jmodel, name)),
                                   atol=FACTOR_ATOL, err_msg=name)
    np.testing.assert_array_equal(pmodel.item_vocab.keys_array(),
                                  jmodel.item_vocab.keys_array())
    if factory == "ecommerce":
        np.testing.assert_array_equal(pmodel.popular_counts, jmodel.popular_counts)
        assert pmodel.storage is storage


# -- exact host arithmetic --------------------------------------------------------


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
@pytest.mark.parametrize("app", ["similar", "rated"])
def test_cooccurrence_counts_are_exact(home, monkeypatch, app, dense):
    jax_storage, storage, _ = home(app)
    if not dense:  # both packages take the sparse host expansion
        for mod in (jax_sp, pt_sp):
            monkeypatch.setattr(mod.CooccurrenceAlgorithm, "_DENSE_CELL_LIMIT", 0)
    variant = _variant(app, [("cooccurrence", {"n": 4})], {"eventNames": ["view", "rate"]})
    want = _jax_train("similarproduct", variant, jax_storage)[4][0]
    got = _port_train("similarproduct", variant, storage)[4][0]
    assert got.top_cooccurrences == want.top_cooccurrences
    assert got.top_cooccurrences  # something co-occurs


def test_dense_and_sparse_cooccurrence_agree_at_random():
    rng = np.random.default_rng(2)
    u = rng.integers(0, 40, 600)
    i = rng.integers(0, 30, 600)
    pairs = np.unique(np.stack([u, i], axis=1), axis=0)
    src, dst, cnt = pt_sp._sparse_cooccurrence(pairs, 30)
    b = np.zeros((40, 30), np.float32)
    b[pairs[:, 0], pairs[:, 1]] = 1.0
    dense = b.T @ b
    np.fill_diagonal(dense, 0)
    sparse = np.zeros((30, 30))
    sparse[src, dst] = cnt
    np.testing.assert_array_equal(sparse, dense)
    for got, want in zip((src, dst, cnt), jax_sp._sparse_cooccurrence(pairs, 30)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latest_rating_per_pair_is_exact(seed):
    rng = np.random.default_rng(seed)
    n = 500
    u = rng.integers(0, 20, n).astype(np.int64)
    i = rng.integers(0, 15, n).astype(np.int64)
    r = (rng.integers(-2, 11, n) / 2).astype(np.float32)
    t = rng.integers(0, 40, n).astype(np.int64)  # many time ties
    got = pt_ec.latest_rating_per_pair(u, i, r, t, 15)
    want = jax_ec.latest_rating_per_pair(u, i, r, t, 15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # the sequential reference: overwrite in time order, later rows win ties
    last = {}
    for k in np.lexsort((t,)):
        last[(u[k], i[k])] = r[k]
    assert {(a, b): c for a, b, c in zip(*got)} == last
    empty = pt_ec.latest_rating_per_pair(u[:0], i[:0], r[:0], t[:0], 15)
    assert [x.dtype for x in empty] == [np.int32, np.int32, np.float32]


def test_category_index_and_exclude_mask_are_exact():
    rng = np.random.default_rng(5)
    keys = [f"i{n}" for n in range(40)]
    cats = {k: tuple(rng.choice(["a", "b", "c", "d"], rng.integers(0, 3), replace=False))
            for k in keys[:35]}
    cats["ghost"] = ("a",)  # not in the vocabulary
    pv = BiMap.from_keys(keys)
    jv = jax_filters.BiMap.from_keys(keys)
    pidx, jidx = pt_filters.CategoryIndex(pv, cats), jax_filters.CategoryIndex(jv, cats)
    for kw in (
        {}, {"query_idx": {1, 5}}, {"white_list": ["i1", "i2", "zz"]},
        {"black_list": ["i3", "i4"]}, {"categories": ["a"]},
        {"categories": ["b", "zz"], "category_black_list": ["c"]},
        {"white_list": [], "categories": []},
    ):
        np.testing.assert_array_equal(
            pt_filters.exclude_mask(pv, category_index=pidx, **kw),
            jax_filters.exclude_mask(jv, category_index=jidx, **kw),
            err_msg=str(kw),
        )


# -- persistence -------------------------------------------------------------------


def _assert_same_blob(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


PERSIST_CASES = {
    "als": ("similar", "similarproduct", [("als", {"rank": 4, "numIterations": 3})],
            None, "Query", {"items": ("i0", "i6"), "num": 5}),
    "cooccurrence": ("similar", "similarproduct", [("cooccurrence", {"n": 5})], None,
                     "Query", {"items": ("i0",), "num": 5}),
    "recommendeduser": ("social", "recommendeduser", [("als", {"rank": 4})],
                        {"targetEntityType": "user"}, "UserQuery",
                        {"users": ("u7",), "num": 3}),
    "ecommerce": ("ecomm", "ecommerce", [("ecomm", {"appName": "ecomm", "rank": 4})],
                  None, "Query", {"user": "u3", "num": 5}),
}


@pytest.mark.parametrize("case", sorted(PERSIST_CASES))
def test_persisted_dicts_round_trip_both_ways(home, case):
    app, factory, algos, ds, qcls, q = PERSIST_CASES[case]
    jax_storage, storage, _ = home(app)
    variant = _variant(app, algos, ds)
    _, _, (jalgo,), _, (jmodel,), jctx = _jax_train(factory, variant, jax_storage)
    _, _, (palgo,), _, (pmodel,), pctx = _port_train(factory, variant, storage)
    jmod, pmod = MODS[factory]
    jq, pq = _query(jmod, qcls, q), _query(pmod, qcls, q)
    # JAX blob -> the port -> its blob: key for key the same
    jblob = jalgo.make_persistent_model(jctx, jmodel)
    carried = palgo.load_persistent_model(pctx, jblob)
    _assert_same_blob(palgo.make_persistent_model(pctx, carried), jblob)
    _same(_pairs(palgo.predict(carried, pq)), _pairs(jalgo.predict(jmodel, jq)), case)
    # the port's blob -> the JAX package answers as the port does
    pblob = palgo.make_persistent_model(pctx, pmodel)
    assert sorted(pblob) == sorted(jblob)
    back = jalgo.load_persistent_model(jctx, pblob)
    _same(_pairs(jalgo.predict(back, jq)), _pairs(palgo.predict(pmodel, pq)), case)
    _assert_same_blob(jalgo.make_persistent_model(jctx, back), pblob)


# -- the CLI ------------------------------------------------------------------------

CLI_ENGINES = {
    "shop-sim": ("similarproduct", "shop",
                 [("als", {"rank": 4, "numIterations": 5}), ("cooccurrence", {"n": 5})],
                 {"eventNames": ["view", "rate"]}, "Query",
                 [{"items": ["i1"], "num": 4}, {"items": ["i2", "i8"], "num": 6,
                                                "categories": ["catA"]}]),
    "shop-ecomm": ("ecommerce", "shop",
                   [("ecomm", {"appName": "shop", "rank": 4, "numIterations": 5})],
                   None, "Query",
                   [{"user": "u1", "num": 4}, {"user": "coldu", "num": 3},
                    {"user": "nobody", "num": 3}]),
    "social-users": ("recommendeduser", "social", [("als", {"rank": 4})],
                     {"targetEntityType": "user"}, "UserQuery",
                     [{"users": ["u2"], "num": 3}]),
}


def _api_events(events) -> str:
    return "".join(json.dumps(e.to_api_dict()) + "\n" for e in events)


def test_cli_trains_the_als_family_and_both_packages_deploy_it(tmp_path, monkeypatch):
    env = {"PIO_HOME": str(tmp_path / "pio_home")}
    storage = StorageRuntime(StorageConfig.from_env(env))
    monkeypatch.setattr(cli, "get_storage", lambda: storage)
    shop = _rated_similar_events() + [_act("buy", "u2", "i3"), _act("view", "coldu", "i7")]
    (tmp_path / "shop.jsonl").write_text(_api_events(shop))
    (tmp_path / "social.jsonl").write_text(_api_events(_social_events()))
    for app in ("shop", "social"):
        assert cli.main(["app", "new", app]) == 0
        assert cli.main(["import", "--app", app, "--input",
                         str(tmp_path / f"{app}.jsonl")]) == 0
    jax_storage = jax_reset_storage(JaxStorageConfig.from_env(env))
    try:
        for engine_id, (factory, app, algos, ds, qcls, queries) in CLI_ENGINES.items():
            path = tmp_path / f"{engine_id}.json"
            path.write_text(json.dumps({"id": engine_id, "engineFactory": factory,
                                        **_variant(app, algos, ds)}))
            assert cli.main(["train", "--engine-json", str(path), "--device", "cpu"]) == 0
            inst = storage.engine_instances().get_latest_completed(
                engine_id, "default", "default")
            assert inst is not None and inst.engine_factory == factory
            port = pt_server.deploy_engine(factory, storage=storage,
                                           engine_instance_id=inst.id, device="cpu")
            jax = jax_server.deploy_engine(factory, storage=jax_storage,
                                           engine_instance_id=inst.id)
            assert len(port.models) == len(algos)
            for payload in queries:
                _, pres = port.predict(port.extract_query(payload))
                _, jres = jax.predict(jax.extract_query(payload))
                _same(_pairs(pres), _pairs(jres), (engine_id, payload))
                assert pres.item_scores or payload.get("user") == "nobody"
    finally:
        jax_storage.close()
        storage.close()
