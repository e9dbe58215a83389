from predictionio_tpu_torch.models.ecommerce.engine import (
    DataSourceParams,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommDataSource,
    ECommModel,
    ECommPreparator,
    ECommServing,
    Item,
    ItemScore,
    PredictedResult,
    Query,
    ecommerce_engine,
)

__all__ = [
    "DataSourceParams",
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommDataSource",
    "ECommModel",
    "ECommPreparator",
    "ECommServing",
    "Item",
    "ItemScore",
    "PredictedResult",
    "Query",
    "ecommerce_engine",
]
