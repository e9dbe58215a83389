"""Evaluation metrics and their reducers.

The JAX package's ``core/metric.py``, the same classes (controller/
Metric.scala): a Metric scores (query, predicted, actual) triples over all
eval folds and reduces them.  Reducers: AverageMetric:99,
OptionAverageMetric:124, StdevMetric:151, OptionStdevMetric:179,
SumMetric:205, ZeroMetric:234.  ``calculate`` receives the per-fold data as
[(eval_info, [(q, p, a)])] exactly like evaluateBase.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Generic, Sequence, TypeVar

EI = TypeVar("EI")
Q = TypeVar("Q")
PR = TypeVar("PR")
A = TypeVar("A")

QPA = tuple[Any, Any, Any]  # (query, predicted, actual)
FoldData = Sequence[tuple[Any, Sequence[QPA]]]


class Metric(abc.ABC, Generic[EI, Q, PR, A]):
    """Base metric; larger is better unless comparison() is overridden."""

    @abc.abstractmethod
    def calculate(self, fold_data: FoldData) -> float: ...

    def comparison(self, a: float, b: float) -> int:
        """Ordering hook: >0 if a better than b (Metric.scala Ordering)."""
        return (a > b) - (a < b)

    def header(self) -> str:
        return type(self).__name__


class _PointwiseMetric(Metric):
    """Scores each (q, p, a) and reduces; None scores are handled per subclass."""

    def calculate_one(self, q, p, a) -> float | None:
        raise NotImplementedError

    def _scores(self, fold_data: FoldData) -> list[float | None]:
        return [
            self.calculate_one(q, p, a)
            for _, qpas in fold_data
            for (q, p, a) in qpas
        ]


class AverageMetric(_PointwiseMetric):
    """Mean of all scores; calculate_one must return a float."""

    def calculate(self, fold_data: FoldData) -> float:
        scores = self._scores(fold_data)
        if any(s is None for s in scores):
            raise ValueError(
                f"{type(self).__name__}: calculate_one returned None; "
                "use OptionAverageMetric for skippable scores"
            )
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(_PointwiseMetric):
    """Mean over non-None scores only."""

    def calculate(self, fold_data: FoldData) -> float:
        scores = [s for s in self._scores(fold_data) if s is not None]
        return sum(scores) / len(scores) if scores else float("nan")


class StdevMetric(_PointwiseMetric):
    """Population standard deviation of scores."""

    def calculate(self, fold_data: FoldData) -> float:
        scores = [s for s in self._scores(fold_data)]
        if not scores or any(s is None for s in scores):
            raise ValueError(f"{type(self).__name__}: invalid scores")
        mean = sum(scores) / len(scores)
        return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class OptionStdevMetric(_PointwiseMetric):
    def calculate(self, fold_data: FoldData) -> float:
        scores = [s for s in self._scores(fold_data) if s is not None]
        if not scores:
            return float("nan")
        mean = sum(scores) / len(scores)
        return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class SumMetric(_PointwiseMetric):
    def calculate(self, fold_data: FoldData) -> float:
        return float(sum(s for s in self._scores(fold_data) if s is not None))


class ZeroMetric(Metric):
    """Always 0 — placeholder metric (Metric.scala:234)."""

    def calculate(self, fold_data: FoldData) -> float:
        return 0.0
