"""Storage for the port: events, app metadata, engine- and
evaluation-instance records and model blobs, in the JAX package's sqlite/localfs layouts (see ``config``
for the env vars)."""

from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EvaluationInstance,
    Models,
)
from predictionio_tpu_torch.data.storage.config import (
    StorageConfig,
    StorageRuntime,
    get_storage,
    reset_storage,
)

__all__ = [
    "EngineInstance",
    "EvaluationInstance",
    "Models",
    "StorageConfig",
    "StorageRuntime",
    "get_storage",
    "reset_storage",
]
