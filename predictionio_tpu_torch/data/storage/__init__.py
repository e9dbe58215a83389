"""Storage for the port: engine-instance records and model blobs, in the
JAX package's sqlite/localfs layouts (see ``config`` for the env vars)."""

from predictionio_tpu_torch.data.storage.base import EngineInstance, Models
from predictionio_tpu_torch.data.storage.config import (
    StorageConfig,
    StorageRuntime,
    get_storage,
    reset_storage,
)

__all__ = [
    "EngineInstance",
    "Models",
    "StorageConfig",
    "StorageRuntime",
    "get_storage",
    "reset_storage",
]
