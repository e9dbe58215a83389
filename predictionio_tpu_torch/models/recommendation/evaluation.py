"""Recommendation evaluation: Precision@K sweep.

The JAX package's ``models/recommendation/evaluation.py``
(examples/scala-parallel-recommendation/blacklist-items/src/main/scala/
Evaluation.scala:38-57): PrecisionAtK (with a rating threshold baked into
the DataSource's relevant-item sets), MAPAtK and PositiveCount, plus an
engine-params generator sweeping hyperparameters.
"""

from __future__ import annotations

from predictionio_tpu_torch.core.engine import EngineParams
from predictionio_tpu_torch.core.metric import OptionAverageMetric, SumMetric
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
    EvalParams,
    PredictedResult,
    Query,
)


class PrecisionAtK(OptionAverageMetric):
    """Fraction of top-k recommended items that are relevant.

    None (skipped) when the user has no relevant items in the test fold —
    matching the reference's Option[Double] semantics.
    """

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_one(self, q: Query, p: PredictedResult, a: frozenset):
        if not a:
            return None
        top = [s.item for s in p.item_scores[: self.k]]
        # denominator is min(k, |relevant|), reference Evaluation.scala:48
        return sum(1 for item in top if item in a) / min(self.k, len(a))


class MAPAtK(OptionAverageMetric):
    """Mean Average Precision @ k over users with relevant items.

    AP@k = (1/min(k, |relevant|)) * sum_{r<=k, hit at r} precision@r — the
    standard ranking metric the BASELINE tracks for ML-20M; None (skipped)
    for users with no relevant items, like PrecisionAtK.
    """

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"MAP@{self.k}"

    def calculate_one(self, q: Query, p: PredictedResult, a: frozenset):
        if not a:
            return None
        hits = 0
        ap = 0.0
        for rank, s in enumerate(p.item_scores[: self.k], start=1):
            if s.item in a:
                hits += 1
                ap += hits / rank
        return ap / min(self.k, len(a))


class PositiveCount(SumMetric):
    """Number of users with at least one relevant item (diagnostic)."""

    def header(self) -> str:
        return "PositiveCount"

    def calculate_one(self, q, p, a) -> float:
        return 1.0 if a else 0.0


def engine_params_list(
    app_name: str,
    ranks=(8, 10),
    num_iterations: int = 10,
    regs=(0.01, 0.1),
    eval_params: EvalParams | None = None,
) -> list[EngineParams]:
    """Hyperparameter sweep (the EngineParamsGenerator role)."""
    ds = DataSourceParams(
        app_name=app_name, eval_params=eval_params or EvalParams()
    )
    return [
        EngineParams(
            datasource=("ratings", ds),
            preparator=("ratings", None),
            algorithms=(
                (
                    "als",
                    ALSAlgorithmParams(
                        rank=rank, num_iterations=num_iterations, reg=reg
                    ),
                ),
            ),
            serving=("first", None),
        )
        for rank in ranks
        for reg in regs
    ]
