"""Evaluation binding: engine + engine-params sweep + metrics.

The JAX package's ``eval/evaluation.py`` (controller/Evaluation.scala:
34-124): an ``Evaluation`` names the engine (factory), the list of
EngineParams to sweep, and the metric(s); the CLI's ``eval`` verb imports
one by path (``pkg.module:evaluation_object``) and hands it to
``run_evaluation``.  The reference's `pio eval <Evaluation>
<EngineParamsGenerator>` collapses to one object because params generators
are plain lists/functions here (EngineParamsGenerator.scala:30).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.metric import Metric


@dataclass
class Evaluation:
    """Bind an engine factory to a params sweep and metrics."""

    engine_factory: Callable[[], Engine]
    engine_params_list: Sequence[EngineParams] | Callable[[], Sequence[EngineParams]]
    metric: Metric
    other_metrics: Sequence[Metric] = field(default_factory=tuple)

    def params_list(self) -> Sequence[EngineParams]:
        eps = self.engine_params_list
        return list(eps()) if callable(eps) else list(eps)


def resolve_evaluation(path: str, kwargs: dict | None = None) -> Evaluation:
    """Import an Evaluation by ``pkg.module:attr`` path.

    ``kwargs`` are passed when the attr is a factory callable (the way the
    reference's Evaluation objects bake in appName, user factories here take
    it as a parameter: ``pio eval pkg.mod:evaluation --params '{"app_name":
    "myapp"}'``).
    """
    from predictionio_tpu_torch.utils.registry import resolve_import_path

    obj = resolve_import_path(path)
    if obj is None:
        raise KeyError(f"evaluation {path!r} not found")
    if callable(obj) and not isinstance(obj, Evaluation):
        obj = obj(**(kwargs or {}))
    elif kwargs:
        raise TypeError(
            f"{path!r} is an Evaluation instance; --params only applies to "
            "factory callables"
        )
    if not isinstance(obj, Evaluation):
        raise TypeError(f"{path!r} did not resolve to an Evaluation")
    return obj
