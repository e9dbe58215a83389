"""Evaluation of the port: the JAX package's ``eval/`` (``MetricEvaluator``,
``EvaluationResult``, ``FastEvalEngine``) over port engines."""

from predictionio_tpu_torch.eval.evaluator import (
    EvaluationResult,
    MetricEvaluator,
)
from predictionio_tpu_torch.eval.fast_eval import FastEvalEngine

__all__ = ["EvaluationResult", "FastEvalEngine", "MetricEvaluator"]
