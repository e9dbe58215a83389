from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    DataSourceParams,
    ItemScore,
    PredictedResult,
    Query,
    RatingsDataSource,
    RatingsPreparator,
    RecommendationServing,
    recommendation_engine,
)

__all__ = [
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "ALSModel",
    "DataSourceParams",
    "ItemScore",
    "PredictedResult",
    "Query",
    "RatingsDataSource",
    "RatingsPreparator",
    "RecommendationServing",
    "recommendation_engine",
]
