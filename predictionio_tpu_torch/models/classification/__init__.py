from predictionio_tpu_torch.models.classification.engine import (
    ClassificationDataSource,
    ClassificationServing,
    DataSourceParams,
    LogisticRegressionAlgorithm,
    LogisticRegressionParams,
    NaiveBayesAlgorithm,
    NaiveBayesParams,
    PredictedResult,
    Query,
    classification_engine,
)
from predictionio_tpu_torch.models.classification.evaluation import (
    Accuracy,
    engine_params_list,
    evaluation,
)

__all__ = [
    "Accuracy",
    "ClassificationDataSource",
    "ClassificationServing",
    "DataSourceParams",
    "LogisticRegressionAlgorithm",
    "LogisticRegressionParams",
    "NaiveBayesAlgorithm",
    "NaiveBayesParams",
    "PredictedResult",
    "Query",
    "classification_engine",
    "engine_params_list",
    "evaluation",
]
