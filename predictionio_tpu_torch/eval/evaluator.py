"""MetricEvaluator: score an engine-params sweep and pick the best.

The JAX package's ``eval/evaluator.py`` (controller/MetricEvaluator.scala:
185): for each EngineParams in the sweep, run the engine's eval pipeline,
compute the primary metric (+ any additional metrics), track the best by
the metric's ordering, and render one-liner / HTML / JSON results for the
EvaluationInstance record, byte for byte as the JAX package renders them.
"""

from __future__ import annotations

import html as html_mod
import json
import logging
from dataclasses import dataclass
from typing import Sequence

from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.metric import Metric
from predictionio_tpu_torch.utils.params import params_to_dict

log = logging.getLogger("predictionio_tpu_torch.eval")


@dataclass
class EvaluationRecord:
    engine_params: EngineParams
    score: float
    other_scores: dict[str, float]


@dataclass
class EvaluationResult:
    """All sweep records + the winner (MetricEvaluatorResult:64)."""

    metric_header: str
    other_headers: list[str]
    records: list[EvaluationRecord]
    best_idx: int

    @property
    def best(self) -> EvaluationRecord:
        return self.records[self.best_idx]

    def one_liner(self) -> str:
        b = self.best
        return (
            f"[{self.metric_header}] best score: {b.score:.6f} "
            f"(params set {self.best_idx + 1} of {len(self.records)})"
        )

    def _params_dict(self, ep: EngineParams) -> dict:
        return {
            "datasource": {ep.datasource[0]: params_to_dict(ep.datasource[1])},
            "preparator": {ep.preparator[0]: params_to_dict(ep.preparator[1])},
            "algorithms": [{n: params_to_dict(p)} for n, p in ep.algorithms],
            "serving": {ep.serving[0]: params_to_dict(ep.serving[1])},
        }

    def to_json(self) -> str:
        return json.dumps(
            {
                "metric": self.metric_header,
                "otherMetrics": self.other_headers,
                "bestIdx": self.best_idx,
                "bestScore": self.best.score,
                "records": [
                    {
                        "score": r.score,
                        "otherScores": r.other_scores,
                        "engineParams": self._params_dict(r.engine_params),
                    }
                    for r in self.records
                ],
            },
            default=str,
        )

    def to_html(self) -> str:
        rows = "".join(
            f"<tr{' class=best' if i == self.best_idx else ''}>"
            f"<td>{i + 1}</td><td>{r.score:.6f}</td>"
            f"<td>{''.join(f'{k}={v:.6f} ' for k, v in r.other_scores.items())}</td>"
            f"<td><pre>{html_mod.escape(json.dumps(self._params_dict(r.engine_params), indent=1, default=str))}</pre></td></tr>"
            for i, r in enumerate(self.records)
        )
        return (
            "<table border=1><tr><th>#</th>"
            f"<th>{html_mod.escape(self.metric_header)}</th><th>other metrics</th>"
            f"<th>engine params</th></tr>{rows}</table>"
        )


class MetricEvaluator:
    """Evaluate each EngineParams with the engine and a primary metric."""

    def __init__(
        self, metric: Metric, other_metrics: Sequence[Metric] = ()
    ):
        self.metric = metric
        self.other_metrics = list(other_metrics)

    def evaluate(
        self,
        ctx: EngineContext,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
    ) -> EvaluationResult:
        from predictionio_tpu_torch.obs.tracing import trace

        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        records: list[EvaluationRecord] = []
        best_idx = 0
        for i, ep in enumerate(engine_params_list):
            # one span per params candidate: a sweep's cost decomposes into
            # engine.eval (train+predict per fold) vs metric calculation
            with trace("eval.engine_params"):
                fold_data = engine.eval(ctx, ep)
            with trace("eval.metric.calculate"):
                score = self.metric.calculate(fold_data)
                others = {
                    m.header(): m.calculate(fold_data)
                    for m in self.other_metrics
                }
            records.append(EvaluationRecord(ep, score, others))
            log.info(
                "eval %d/%d: %s = %s",
                i + 1,
                len(engine_params_list),
                self.metric.header(),
                score,
            )
            if self.metric.comparison(score, records[best_idx].score) > 0:
                best_idx = i
        return EvaluationResult(
            metric_header=self.metric.header(),
            other_headers=[m.header() for m in self.other_metrics],
            records=records,
            best_idx=best_idx,
        )
