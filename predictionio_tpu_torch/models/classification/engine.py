"""Classification engine template.

The port of the JAX package's ``models/classification/engine.py``
(examples/scala-parallel-classification/add-algorithm): user entities
carry ``$set`` properties attr0/attr1/attr2 (features) and ``plan``
(label); ``naive`` is MLlib-semantics multinomial Naive Bayes
(NaiveBayesAlgorithm.scala:40-56) and ``logreg`` softmax regression, both
from ``ops/classifiers.py`` on the context's device.

- The persisted blob is the JAX package's: a dict of numpy arrays
  (``pi``/``theta``/``labels`` or ``w``/``b``/``labels``), so a model
  written by either package deploys on the other.
- ``predict`` and ``batch_predict`` score on the model's device (a card, or
  the CPU when asked) and take the first of equal maxima, as ``np.argmax``
  does.
- ``read_eval`` splits the same labeled points into k folds with the
  port's ``e2.evaluation.split_data``.

Query {attr0, attr1, attr2} -> PredictedResult(label).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EngineContext,
    IdentityPreparator,
    SanityCheckError,
    Serving,
)
from predictionio_tpu_torch.core.engine import Engine, engine_factory
from predictionio_tpu_torch.ops.classifiers import (
    LogisticRegressionModel,
    NaiveBayesModel,
    logreg_scores,
    naive_bayes_scores,
    train_logistic_regression,
    train_naive_bayes,
)


@dataclass(frozen=True)
class Query:
    attr0: float = 0.0
    attr1: float = 0.0
    attr2: float = 0.0


@dataclass(frozen=True)
class PredictedResult:
    label: float

    def to_json_dict(self) -> dict[str, Any]:
        return {"label": self.label}


@dataclass(frozen=True)
class ActualResult:
    label: float


@dataclass
class TrainingData:
    features: np.ndarray  # [n, 3] float32
    labels: np.ndarray  # [n] float32

    def sanity_check(self):
        if len(self.labels) == 0:
            raise SanityCheckError(
                "no labeled points — need $set user events with "
                "plan/attr0/attr1/attr2 properties"
            )


PreparedData = TrainingData


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = "default"
    eval_k: int | None = None

    params_aliases = {"appName": "app_name", "evalK": "eval_k"}


_ATTRS = ("attr0", "attr1", "attr2")


class ClassificationDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams | None = None):
        self.params = params or DataSourceParams()

    def _read(self, ctx: EngineContext) -> TrainingData:
        props = ctx.p_event_store.aggregate_properties(
            self.params.app_name, "user", required=["plan", *_ATTRS]
        )
        rows = sorted(props.items())
        feats = np.array(
            [[float(p.get(a)) for a in _ATTRS] for _, p in rows], np.float32
        ).reshape(-1, 3)
        labels = np.array([float(p.get("plan")) for _, p in rows], np.float32)
        return TrainingData(features=feats, labels=labels)

    def read_training(self, ctx: EngineContext) -> TrainingData:
        return self._read(ctx)

    def read_eval(self, ctx: EngineContext):
        from predictionio_tpu_torch.e2.evaluation import split_data

        k = self.params.eval_k
        if k is None:
            raise ValueError("DataSourceParams.eval_k must be set for evaluation")
        td = self._read(ctx)
        rows = list(zip(td.features, td.labels))
        return split_data(
            k,
            rows,
            {},
            training_data_creator=lambda sel: TrainingData(
                features=np.array([x for x, _ in sel], np.float32).reshape(-1, 3),
                labels=np.array([y for _, y in sel], np.float32),
            ),
            query_creator=lambda d: Query(
                attr0=float(d[0][0]), attr1=float(d[0][1]), attr2=float(d[0][2])
            ),
            actual_creator=lambda d: ActualResult(label=float(d[1])),
        )


def _encode_labels(labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    classes = np.unique(labels)
    idx = np.searchsorted(classes, labels)
    return classes, idx.astype(np.int32)


def _best(scores: torch.Tensor) -> np.ndarray:
    """Per-row index of the first maximum (``np.argmax``'s rule; torch's
    ``argmax`` returns the first maximal index too)."""
    return torch.argmax(scores, dim=1).cpu().numpy()


def _features(model_tensor: torch.Tensor, queries) -> torch.Tensor:
    x = np.asarray(
        [[q.attr0, q.attr1, q.attr2] for q in queries], np.float32
    ).reshape(-1, 3)
    return torch.from_numpy(x).to(model_tensor.device)


def _labelled(model, queries, scores: torch.Tensor):
    best = _best(scores)
    return [
        (i, PredictedResult(label=float(model.labels[b])))
        for (i, _), b in zip(queries, best)
    ]


@dataclass(frozen=True)
class NaiveBayesParams:
    lam: float = 1.0

    params_aliases = {"lambda": "lam"}


class NaiveBayesAlgorithm(Algorithm):
    flavor = "P2L"
    params_class = NaiveBayesParams
    query_class = Query

    def __init__(self, params: NaiveBayesParams | None = None):
        self.params = params or NaiveBayesParams()

    def train(self, ctx: EngineContext, pd: PreparedData) -> NaiveBayesModel:
        classes, y_idx = _encode_labels(pd.labels)
        pi, theta = train_naive_bayes(
            pd.features, y_idx, len(classes), lam=self.params.lam,
            device=ctx.device,
        )
        return NaiveBayesModel(pi=pi, theta=theta, labels=classes)

    def predict(self, model: NaiveBayesModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model, queries):
        x = _features(model.pi, [q for _, q in queries])
        return _labelled(
            model, queries, naive_bayes_scores(model.pi, model.theta, x)
        )

    def make_persistent_model(self, ctx, model: NaiveBayesModel):
        return {
            "pi": model.pi.detach().cpu().numpy(),
            "theta": model.theta.detach().cpu().numpy(),
            "labels": np.asarray(model.labels),
        }

    def load_persistent_model(self, ctx, data) -> NaiveBayesModel:
        return NaiveBayesModel(
            pi=torch.as_tensor(np.asarray(data["pi"]), device=ctx.device),
            theta=torch.as_tensor(np.asarray(data["theta"]), device=ctx.device),
            labels=np.asarray(data["labels"]),
        )


@dataclass(frozen=True)
class LogisticRegressionParams:
    reg: float = 0.0
    learning_rate: float = 0.5
    num_iterations: int = 300

    params_aliases = {
        "learningRate": "learning_rate",
        "numIterations": "num_iterations",
        "lambda": "reg",
    }


class LogisticRegressionAlgorithm(Algorithm):
    """The second algorithm: softmax regression by full-batch gradient
    descent on the device (the reference adds RandomForest here,
    RandomForestAlgorithm.scala)."""

    flavor = "P2L"
    params_class = LogisticRegressionParams
    query_class = Query

    def __init__(self, params: LogisticRegressionParams | None = None):
        self.params = params or LogisticRegressionParams()

    def train(self, ctx: EngineContext, pd: PreparedData) -> LogisticRegressionModel:
        classes, y_idx = _encode_labels(pd.labels)
        p = self.params
        w, b = train_logistic_regression(
            pd.features,
            y_idx,
            len(classes),
            reg=p.reg,
            learning_rate=p.learning_rate,
            num_iterations=p.num_iterations,
            device=ctx.device,
        )
        return LogisticRegressionModel(w=w, b=b, labels=classes)

    def predict(self, model, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model, queries):
        x = _features(model.w, [q for _, q in queries])
        return _labelled(model, queries, logreg_scores(model.w, model.b, x))

    def make_persistent_model(self, ctx, model):
        return {
            "w": model.w.detach().cpu().numpy(),
            "b": model.b.detach().cpu().numpy(),
            "labels": np.asarray(model.labels),
        }

    def load_persistent_model(self, ctx, data) -> LogisticRegressionModel:
        return LogisticRegressionModel(
            w=torch.as_tensor(np.asarray(data["w"]), device=ctx.device),
            b=torch.as_tensor(np.asarray(data["b"]), device=ctx.device),
            labels=np.asarray(data["labels"]),
        )


class ClassificationServing(Serving):
    def __init__(self, params: Any = None):
        pass

    def serve(self, query, predictions):
        return predictions[0]


@engine_factory("classification")
def classification_engine() -> Engine:
    return Engine(
        ClassificationDataSource,
        IdentityPreparator,
        {"naive": NaiveBayesAlgorithm, "logreg": LogisticRegressionAlgorithm},
        ClassificationServing,
    )
