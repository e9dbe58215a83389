from predictionio_tpu_torch.models.ncf.engine import (
    NCFAlgorithm,
    NCFAlgorithmParams,
    NCFModel,
    ncf_engine,
)

__all__ = ["NCFAlgorithm", "NCFAlgorithmParams", "NCFModel", "ncf_engine"]
