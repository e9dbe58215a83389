"""Reusable algorithm library (the reference's `e2/` module), on torch."""

from predictionio_tpu_torch.e2.engine import (
    BinaryVectorizer,
    CategoricalNaiveBayes,
    CategoricalNaiveBayesModel,
    LabeledPoint,
    MarkovChain,
    MarkovChainModel,
)
from predictionio_tpu_torch.e2.evaluation import split_data

__all__ = [
    "BinaryVectorizer",
    "CategoricalNaiveBayes",
    "CategoricalNaiveBayesModel",
    "LabeledPoint",
    "MarkovChain",
    "MarkovChainModel",
    "split_data",
]
