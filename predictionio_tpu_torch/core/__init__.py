"""DASE core of the port: engine context, components, engines, the train
workflow, warm starts, persistence.

The JAX package's ``core`` exports, loaded lazily: ``core.base`` imports
torch, and the event server, the router and the dashboard reach this
package through ``core.metric`` without it.
"""

from predictionio_tpu_torch.utils.lazy import lazy_exports

__all__ = [
    "Algorithm",
    "AverageMetric",
    "AverageServing",
    "DataSource",
    "EmptyParams",
    "Engine",
    "EngineContext",
    "EngineFactory",
    "EngineParams",
    "FirstServing",
    "IdentityPreparator",
    "L",
    "Metric",
    "OptionAverageMetric",
    "OptionStdevMetric",
    "P",
    "P2L",
    "Params",
    "Preparator",
    "SanityCheckError",
    "Serving",
    "SimpleEngine",
    "StdevMetric",
    "SumMetric",
    "ZeroMetric",
]

__getattr__, __dir__ = lazy_exports(
    __name__,
    {
        "predictionio_tpu_torch.core.base": (
            "Algorithm",
            "AverageServing",
            "DataSource",
            "EngineContext",
            "FirstServing",
            "IdentityPreparator",
            "L",
            "P",
            "P2L",
            "Preparator",
            "SanityCheckError",
            "Serving",
        ),
        "predictionio_tpu_torch.core.engine": (
            "Engine",
            "EngineFactory",
            "EngineParams",
            "SimpleEngine",
        ),
        "predictionio_tpu_torch.core.metric": (
            "AverageMetric",
            "Metric",
            "OptionAverageMetric",
            "OptionStdevMetric",
            "StdevMetric",
            "SumMetric",
            "ZeroMetric",
        ),
        "predictionio_tpu_torch.utils.params": ("EmptyParams", "Params"),
    },
)
