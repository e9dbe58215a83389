"""The port's evaluation pipeline against the JAX package's, on the CPU.

- Every metric of ``core/metric.py`` and of the recommendation template's
  ``evaluation.py`` gives the JAX package's value, exactly, on the same
  (query, prediction, actual) triples.
- ``RatingsDataSource.read_eval`` splits one event store into the same
  folds and the same sorted query/actual pairs (every event has its own
  ``eventTime``: tied times come back in store order).
- The recommendation template's folds scored from carried ALS factors give
  the JAX package's metric values exactly (both answer from the host
  replica).
- Over a deterministic stub engine (one source, written for each package),
  ``MetricEvaluator``'s one-liner, JSON and HTML equal the JAX package's
  byte for byte; ``FastEvalEngine`` equals the plain sweep with the same
  cache counts, spills and reloads (on the recommendation engine too,
  spilled models coming back as tensors); evaluation instances written by
  either package read back in the other; ``pio eval`` prints the same lines
  on both CLIs, and sweeps the recommendation template with ``--device
  cpu``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.core import metric as jax_metric
from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import serve_eval_fold as jax_serve_eval_fold
from predictionio_tpu.core import workflow as jax_workflow
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.eval import FastEvalEngine as JaxFastEvalEngine
from predictionio_tpu.eval import MetricEvaluator as JaxMetricEvaluator
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.models.recommendation import evaluation as jax_rec_eval
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core import cleanup
from predictionio_tpu_torch.core import metric as pt_metric
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import serve_eval_fold
from predictionio_tpu_torch.core.workflow import run_evaluation
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.eval import FastEvalEngine, MetricEvaluator
from predictionio_tpu_torch.eval.fast_eval import SpillingModelCache
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.models.recommendation import evaluation as pt_rec_eval
from predictionio_tpu_torch.tools import cli as pt_cli
from predictionio_tpu_torch.tools import commands as pt_cmd

torch.set_num_threads(2)

#: one deterministic engine and evaluation, written against {pkg}
STUB = '''
from dataclasses import dataclass

from {pkg}.core.base import Algorithm, DataSource, Preparator, Serving
from {pkg}.core.engine import Engine, EngineParams
from {pkg}.core.metric import AverageMetric, StdevMetric
from {pkg}.eval.evaluation import Evaluation

TRAINS = []


@dataclass(frozen=True)
class DSParams:
    n_folds: int = 2
    n_queries: int = 3


class DataSource0(DataSource):
    params_class = DSParams

    def __init__(self, params=None):
        self.params = params or DSParams()

    def read_training(self, ctx):
        return 0

    def read_eval(self, ctx):
        # fold f: query q -> actual q + f / 4
        return [(0, {{"fold": f}}, [(q, q + f / 4) for q in range(self.params.n_queries)])
                for f in range(self.params.n_folds)]


@dataclass(frozen=True)
class PrepParams:
    multiplier: int = 1


class Preparator0(Preparator):
    params_class = PrepParams

    def __init__(self, params=None):
        self.params = params or PrepParams()

    def prepare(self, ctx, td):
        return self.params.multiplier


@dataclass(frozen=True)
class AlgoParams:
    offset: float = 0.0


class Algo0(Algorithm):
    params_class = AlgoParams

    def __init__(self, params=None):
        self.params = params or AlgoParams()

    def train(self, ctx, pd):
        TRAINS.append(pd)
        return {{"multiplier": pd}}

    def predict(self, model, q):
        return q * model["multiplier"] + self.params.offset


class Serving0(Serving):
    def serve(self, q, predictions):
        return sum(predictions) / len(predictions)


class AbsError(AverageMetric):
    def calculate_one(self, q, p, a):
        return -abs(p - a)


class Spread(StdevMetric):
    def calculate_one(self, q, p, a):
        return p - a


def engine():
    return Engine({{"ds0": DataSource0}}, {{"prep0": Preparator0}},
                  {{"algo0": Algo0}}, {{"serving0": Serving0}})


def params(offsets=(0.0,), multiplier=1, n_queries=3):
    return EngineParams(
        datasource=("ds0", DSParams(n_queries=n_queries)),
        preparator=("prep0", PrepParams(multiplier=multiplier)),
        algorithms=tuple(("algo0", AlgoParams(offset=o)) for o in offsets),
        serving=("serving0", None),
    )


def sweep(scale=1.0):
    return [params((0.5 * scale,)), params((0.0, 2.0 * scale)),
            params((1.0,), 2), params((0.125,)), params((0.5 * scale,))]


def evaluation(scale=1.0):
    return Evaluation(engine_factory=engine, engine_params_list=sweep(scale),
                      metric=AbsError(), other_metrics=(Spread(),))
'''

REC_EVAL = '''
from predictionio_tpu_torch.eval.evaluation import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import (
    EvalParams, recommendation_engine)
from predictionio_tpu_torch.models.recommendation.evaluation import (
    MAPAtK, PositiveCount, PrecisionAtK, engine_params_list)


def evaluation(app_name):
    return Evaluation(
        engine_factory=recommendation_engine,
        engine_params_list=engine_params_list(
            app_name, ranks=(2, 3), num_iterations=3,
            eval_params=EvalParams(k_fold=2, query_num=5, rating_threshold=3.0)),
        metric=PrecisionAtK(5), other_metrics=(PositiveCount(), MAPAtK(5)))
'''


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    """The stub engine as ``evalstub_jax`` and ``evalstub_port`` (importable
    modules, so ``pio eval`` can name them), and the recommendation
    evaluation as ``evalrec_port``."""
    root = tmp_path_factory.mktemp("evalmods")
    (root / "evalstub_jax.py").write_text(STUB.format(pkg="predictionio_tpu"))
    (root / "evalstub_port.py").write_text(STUB.format(pkg="predictionio_tpu_torch"))
    (root / "evalrec_port.py").write_text(REC_EVAL)
    sys.path.insert(0, str(root))
    try:
        yield {"jax": importlib.import_module("evalstub_jax"),
               "port": importlib.import_module("evalstub_port")}
    finally:
        sys.path.remove(str(root))
        for name in ("evalstub_jax", "evalstub_port", "evalrec_port"):
            sys.modules.pop(name, None)


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    env = {"PIO_HOME": str(tmp_path / "pio_home")}
    # anything that falls back to the process-wide storage stays in tmp
    monkeypatch.setenv("PIO_HOME", env["PIO_HOME"])
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    storage = StorageRuntime(StorageConfig.from_env(env))
    yield {"jax": jax_storage, "port": storage}
    storage.close()
    jax_storage.close()


def _ctxs(homes):
    return (JaxEngineContext(storage=homes["jax"], mode="eval"),
            EngineContext(storage=homes["port"], mode="eval", device="cpu"))


# -- metrics ---------------------------------------------------------------


def _fold_data(rng, with_none: bool):
    out = []
    for f in range(3):
        qpas = []
        for q in range(7):
            a = None if with_none and rng.random() < 0.3 else float(rng.normal())
            qpas.append((q, float(rng.normal()), a))
        out.append(({"fold": f}, qpas))
    return out


KINDS = ["AverageMetric", "OptionAverageMetric", "StdevMetric",
         "OptionStdevMetric", "SumMetric"]


def _metric(mod, kind):
    base = getattr(mod, kind)

    class M(base):
        def calculate_one(self, q, p, a):
            return None if a is None else p * a - q

    return M()


def _same(got, want):
    assert (math.isnan(got) and math.isnan(want)) or got == want, (got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_metrics_match_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    jm, pm = _metric(jax_metric, kind), _metric(pt_metric, kind)
    assert pm.header() == "M" == jm.header()
    for with_none in (False, True):
        data = _fold_data(rng, with_none)
        try:
            want = jm.calculate(data)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                pm.calculate(data)
            continue
        _same(pm.calculate(data), want)
    empty = [({"fold": 0}, [])]
    try:
        want = jm.calculate(empty)
    except ValueError:
        with pytest.raises(ValueError):
            pm.calculate(empty)
    else:
        _same(pm.calculate(empty), want)
    assert pm.comparison(1.0, 2.0) == jm.comparison(1.0, 2.0) == -1
    assert pt_metric.ZeroMetric().calculate(empty) == 0.0


def test_recommendation_metrics_match_jax():
    rng = np.random.default_rng(3)
    items = [f"i{i}" for i in range(15)]
    folds = {"jax": [], "port": []}
    for f in range(2):
        rows = {"jax": [], "port": []}
        for u in range(12):
            ranked = rng.permutation(items)[: rng.integers(0, 12)]
            actual = frozenset(rng.choice(items, rng.integers(0, 5), replace=False))
            for name, mod in (("jax", jax_rec), ("port", pt_rec)):
                pred = mod.PredictedResult(item_scores=tuple(
                    mod.ItemScore(item=str(i), score=float(-j))
                    for j, i in enumerate(ranked)))
                rows[name].append((mod.Query(user=f"u{u}", num=10), pred, actual))
        for name in folds:
            folds[name].append(({"fold": f}, rows[name]))
    for k in (1, 5, 10):
        for cls in ("PrecisionAtK", "MAPAtK"):
            jm, pm = getattr(jax_rec_eval, cls)(k), getattr(pt_rec_eval, cls)(k)
            assert pm.header() == jm.header()
            _same(pm.calculate(folds["port"]), jm.calculate(folds["jax"]))
    _same(pt_rec_eval.PositiveCount().calculate(folds["port"]),
          jax_rec_eval.PositiveCount().calculate(folds["jax"]))


def test_engine_params_list_matches_jax():
    want = jax_rec_eval.engine_params_list("shop", ranks=(4, 6), regs=(0.5,))
    got = pt_rec_eval.engine_params_list("shop", ranks=(4, 6), regs=(0.5,))
    assert [p.to_json_fields() for p in got] == [p.to_json_fields() for p in want]


# -- read_eval and folds over carried models ------------------------------


def _rate_events(rng, n_users=25, n_items=18, n=500):
    out = []
    for j in range(n):
        out.append({
            "event": "rate" if rng.random() < 0.9 else "buy",
            "entityType": "user", "entityId": f"u{rng.integers(n_users)}",
            "targetEntityType": "item", "targetEntityId": f"i{rng.integers(n_items)}",
            "properties": {"rating": float(rng.integers(1, 6))},
            "eventTime": f"2026-02-01T{j // 3600:02d}:{j // 60 % 60:02d}:"
                         f"{j % 60:02d}.000Z",
        })
    return out


@pytest.fixture()
def rated(homes, tmp_path):
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n"
                            for e in _rate_events(np.random.default_rng(0))))
    pt_cmd.app_new(homes["port"], "shop")
    assert pt_cmd.import_events(homes["port"], "shop", path) == 500
    return homes


EVAL = dict(k_fold=3, query_num=7, rating_threshold=3.5)


def _read_eval_both(homes):
    jctx, pctx = _ctxs(homes)
    jds = jax_rec.RatingsDataSource(jax_rec.DataSourceParams(
        app_name="shop", eval_params=jax_rec.EvalParams(**EVAL)))
    pds = pt_rec.RatingsDataSource(pt_rec.DataSourceParams(
        app_name="shop", eval_params=pt_rec.EvalParams(**EVAL)))
    return jds.read_eval(jctx), pds.read_eval(pctx)


def test_read_eval_folds_match_jax(rated):
    want, got = _read_eval_both(rated)
    assert len(got) == len(want) == 3
    for (jtd, jinfo, jqa), (ptd, pinfo, pqa) in zip(want, got):
        assert pinfo == jinfo
        for name in ("users", "items", "ratings"):
            np.testing.assert_array_equal(getattr(ptd, name), getattr(jtd, name))
        assert [(q.user, q.num, a) for q, a in pqa] == [
            (q.user, q.num, a) for q, a in jqa]
        assert [q.user for q, _ in pqa] == sorted(q.user for q, _ in pqa)
        assert all(isinstance(q, pt_rec.Query) for q, _ in pqa)
    # every row is a test row of exactly one fold
    pctx = _ctxs(rated)[1]
    n = len(pt_rec.RatingsDataSource(pt_rec.DataSourceParams(
        app_name="shop")).read_training(pctx).ratings)
    assert sum(len(td.ratings) for td, _, _ in got) == 2 * n
    with pytest.raises(ValueError, match="eval_params"):
        pt_rec.RatingsDataSource(pt_rec.DataSourceParams(app_name="shop")).read_eval(
            _ctxs(rated)[1])


def test_folds_scored_from_carried_factors_give_jax_metrics(rated):
    """Per fold, the JAX package trains; the port serves the same factors
    (``ALSModel.from_jax_params``): the fold's answers and every metric
    are the JAX package's exactly."""
    want_sets, got_sets = _read_eval_both(rated)
    jctx, pctx = _ctxs(rated)
    jalgo = jax_rec.ALSAlgorithm(jax_rec.ALSAlgorithmParams(rank=3, num_iterations=4))
    palgo = pt_rec.ALSAlgorithm(pt_rec.ALSAlgorithmParams(rank=3, num_iterations=4))
    jfolds, pfolds = [], []
    for (jtd, info, jqa), (ptd, _, pqa) in zip(want_sets, got_sets):
        jmodel = jalgo.train(jctx, jax_rec.RatingsPreparator().prepare(jctx, jtd))
        pmodel = pt_rec.ALSModel.from_jax_params(
            jalgo.make_persistent_model(jctx, jmodel), "cpu")
        jfolds.append((info, jax_serve_eval_fold(
            [jalgo], [jmodel], jax_rec.RecommendationServing(), jqa)))
        pfolds.append((info, serve_eval_fold(
            [palgo], [pmodel], pt_rec.RecommendationServing(), pqa)))
    for (_, jrows), (_, prows) in zip(jfolds, pfolds):
        for (jq, jp, ja), (pq, pp, pa) in zip(jrows, prows):
            assert (pq.user, pa) == (jq.user, ja)
            assert [(s.item, s.score) for s in pp.item_scores] == [
                (s.item, s.score) for s in jp.item_scores]
    for cls, k in (("PrecisionAtK", 7), ("MAPAtK", 3)):
        _same(getattr(pt_rec_eval, cls)(k).calculate(pfolds),
              getattr(jax_rec_eval, cls)(k).calculate(jfolds))


# -- the evaluator, FastEvalEngine, instances, the CLI ---------------------


def _evaluate(mod, evaluator_cls, ctx, engine, sweep):
    return evaluator_cls(mod.AbsError(), [mod.Spread()]).evaluate(ctx, engine, sweep)


def test_metric_evaluator_renders_as_the_jax_package(stubs, homes):
    jctx, pctx = _ctxs(homes)
    jm, pm = stubs["jax"], stubs["port"]
    want = _evaluate(jm, JaxMetricEvaluator, jctx, jm.engine(), jm.sweep(1.5))
    got = _evaluate(pm, MetricEvaluator, pctx, pm.engine(), pm.sweep(1.5))
    assert got.best_idx == want.best_idx == 3
    assert got.one_liner() == want.one_liner()
    assert got.to_json() == want.to_json()
    assert got.to_html() == want.to_html()
    assert [r.other_scores for r in got.records] == [r.other_scores for r in want.records]
    with pytest.raises(ValueError, match="must not be empty"):
        MetricEvaluator(pm.AbsError()).evaluate(pctx, pm.engine(), [])


def test_fast_eval_equals_the_plain_sweep_with_spills(stubs, homes, monkeypatch):
    monkeypatch.setenv("PIO_FAST_EVAL_MAX_LIVE", "2")
    jctx, pctx = _ctxs(homes)
    out = {}
    for name, mod, ctx, ev, fast in (
        ("jax", stubs["jax"], jctx, JaxMetricEvaluator, JaxFastEvalEngine),
        ("port", stubs["port"], pctx, MetricEvaluator, FastEvalEngine),
    ):
        sweep = [mod.params((float(o),), 1 + o % 2) for o in range(6)] + mod.sweep()
        plain = _evaluate(mod, ev, ctx, mod.engine(), sweep)
        engine = fast.from_engine(mod.engine())
        mod.TRAINS.clear()
        _evaluate(mod, ev, ctx, engine, sweep)
        trains = engine.counts["train"]
        again = _evaluate(mod, ev, ctx, engine, sweep)  # reloads spilled models
        cache = engine._train_cache
        assert [r.score for r in plain.records] == [r.score for r in again.records]
        assert again.to_json() == plain.to_json()
        assert engine.counts["train"] == trains
        out[name] = (dict(engine.counts), len(mod.TRAINS), cache.live_count,
                     len(cache), cache.reload_count, plain.to_json())
    assert out["port"] == out["jax"]
    assert out["port"][4] > 0 and out["port"][2] <= 2


def test_spilling_cache_keeps_tensors_on_their_device():
    c = SpillingModelCache(max_live=1)
    a = [{"f": torch.arange(5.0)}, np.arange(3.0)]
    c.put("a", a)
    c.put("b", [torch.ones(2)])  # spills "a"
    assert c.live_count == 1 and len(c) == 2 and "a" in c
    got = c.get("a")
    assert isinstance(got[0]["f"], torch.Tensor) and got[0]["f"].device.type == "cpu"
    assert torch.equal(got[0]["f"], a[0]["f"])
    np.testing.assert_array_equal(got[1], a[1])
    assert c.reload_count == 1


def test_fast_eval_of_the_recommendation_engine_spills_and_reloads(rated, monkeypatch):
    monkeypatch.setenv("PIO_FAST_EVAL_MAX_LIVE", "1")
    ctx = _ctxs(rated)[1]
    sweep = pt_rec_eval.engine_params_list(
        "shop", ranks=(2, 3), num_iterations=3,
        eval_params=pt_rec.EvalParams(k_fold=2, query_num=5, rating_threshold=3.0))
    metric = pt_rec_eval.PrecisionAtK(5)
    plain = MetricEvaluator(metric).evaluate(ctx, pt_rec.recommendation_engine(), sweep)
    engine = FastEvalEngine.from_engine(pt_rec.recommendation_engine())
    ev = MetricEvaluator(metric)
    first = ev.evaluate(ctx, engine, sweep)
    second = ev.evaluate(ctx, engine, sweep)
    assert engine.counts == {"datasource": 1, "preparator": 1, "train": 4}
    assert engine._train_cache.reload_count > 0
    assert [r.score for r in first.records] == [r.score for r in plain.records]
    assert second.to_json() == plain.to_json()
    models = engine._train_cache.get(next(iter(engine._train_cache._live)))
    assert isinstance(models[0].user_factors, torch.Tensor)


def test_evaluation_instances_cross_read(stubs, homes):
    jctx, pctx = _ctxs(homes)
    ran = []
    cleanup.add(lambda: ran.append(True))
    got = run_evaluation(stubs["port"].engine(), stubs["port"].sweep(),
                         MetricEvaluator(stubs["port"].AbsError()), ctx=pctx,
                         evaluation_class="evalstub_port:evaluation",
                         storage=homes["port"])
    assert ran == [True]
    want = jax_run_evaluation(stubs["jax"].engine(), stubs["jax"].sweep(),
                              stubs["jax"].AbsError(), ctx=jctx,
                              evaluation_class="evalstub_jax:evaluation",
                              storage=homes["jax"])
    assert got.to_json() == want.to_json()
    for reader in (homes["jax"].evaluation_instances(),
                   homes["port"].evaluation_instances()):
        done = {i.evaluation_class: i for i in reader.get_completed()}
        assert sorted(done) == ["evalstub_jax:evaluation", "evalstub_port:evaluation"]
        for i in done.values():
            assert i.status == "EVALCOMPLETED"
            assert i.evaluator_results == got.one_liner()
            assert i.evaluator_results_html == got.to_html()
            assert json.loads(i.evaluator_results_json)["bestIdx"] == got.best_idx
            assert i.end_time >= i.start_time
        assert len(reader.get_all()) == 2
    jax_row = homes["jax"].evaluation_instances().get(
        done["evalstub_port:evaluation"].id)
    assert vars(jax_row) == vars(done["evalstub_port:evaluation"])

    class Broken(stubs["port"].AbsError):
        def calculate_one(self, q, p, a):
            raise RuntimeError("metric failed")

    with pytest.raises(RuntimeError, match="metric failed"):
        run_evaluation(stubs["port"].engine(), stubs["port"].sweep(), Broken(),
                       ctx=pctx, storage=homes["port"])
    statuses = sorted(i.status for i in homes["jax"].evaluation_instances().get_all())
    assert statuses == ["EVALCOMPLETED", "EVALCOMPLETED", "FAILED"]
    assert homes["port"].evaluation_instances().delete(
        done["evalstub_port:evaluation"].id)


def _cli(main, argv) -> tuple[int, list[str]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_pio_eval_prints_as_the_jax_cli(stubs, homes, monkeypatch):
    monkeypatch.setattr(pt_cli, "get_storage", lambda: homes["port"])
    monkeypatch.setattr(jax_cli, "get_storage", lambda: homes["jax"])
    # the JAX CLI's run_evaluation takes its storage from its own module
    monkeypatch.setattr(jax_workflow, "get_storage", lambda: homes["jax"])
    args = ["--params", json.dumps({"scale": 3.0})]
    rc_j, want = _cli(jax_cli.main, ["eval", "evalstub_jax:evaluation"] + args)
    rc_p, got = _cli(pt_cli.main, ["eval", "evalstub_port:evaluation"] + args
                     + ["--device", "cpu"])
    assert rc_j == rc_p == 0
    assert got == want and got[0].startswith("[AbsError] best score:")
    assert got[1].startswith("Best score: ")
    rows = homes["port"].evaluation_instances().get_completed()
    assert {r.evaluation_class for r in rows} == {
        "evalstub_jax:evaluation", "evalstub_port:evaluation"}


def test_pio_eval_sweeps_the_recommendation_template(rated, stubs, monkeypatch):
    monkeypatch.setattr(pt_cli, "get_storage", lambda: rated["port"])
    argv = ["eval", "evalrec_port:evaluation", "--params",
            json.dumps({"app_name": "shop"})]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailable):
        pt_cli.main(argv)
    rc, lines = _cli(pt_cli.main, argv + ["--device", "cpu"])
    assert rc == 0 and lines[0].startswith("[Precision@5] best score: ")
    assert "(params set " in lines[0] and "of 4)" in lines[0]
    (inst,) = [i for i in rated["port"].evaluation_instances().get_completed()
               if i.evaluation_class == "evalrec_port:evaluation"]
    body = json.loads(inst.evaluator_results_json)
    assert len(body["records"]) == 4
    assert body["otherMetrics"] == ["PositiveCount", "MAP@5"]
    assert float(lines[1].split(": ")[1]) == body["bestScore"]
    assert [r["engineParams"]["algorithms"][0]["als"]["rank"]
            for r in body["records"]] == [2, 2, 3, 3]
