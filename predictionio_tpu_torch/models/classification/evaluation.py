"""Classification evaluation: Accuracy + lambda sweep.

Parity with examples/scala-parallel-classification/add-algorithm/src/main/
scala/Evaluation.scala:26-66: Accuracy as an AverageMetric over folds and an
engine-params list sweeping the Naive Bayes smoothing lambda {10, 100, 1000}.
"""

from __future__ import annotations

from predictionio_tpu_torch.core.engine import EngineParams
from predictionio_tpu_torch.core.metric import AverageMetric
from predictionio_tpu_torch.eval.evaluation import Evaluation
from predictionio_tpu_torch.models.classification.engine import (
    DataSourceParams,
    NaiveBayesParams,
    classification_engine,
)


class Accuracy(AverageMetric):
    def header(self) -> str:
        return "Accuracy"

    def calculate_one(self, q, p, a) -> float:
        return 1.0 if p.label == a.label else 0.0


def engine_params_list(
    app_name: str = "default", eval_k: int = 5, lams=(10.0, 100.0, 1000.0)
) -> list[EngineParams]:
    return [
        EngineParams(
            datasource=("", DataSourceParams(app_name=app_name, eval_k=eval_k)),
            preparator=("", None),
            algorithms=(("naive", NaiveBayesParams(lam=lam)),),
            serving=("", None),
        )
        for lam in lams
    ]


def evaluation(app_name: str = "default") -> Evaluation:
    return Evaluation(
        engine_factory=classification_engine,
        engine_params_list=lambda: engine_params_list(app_name),
        metric=Accuracy(),
    )
