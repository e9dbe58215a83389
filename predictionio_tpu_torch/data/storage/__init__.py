"""Storage for the port: events, app metadata, engine- and
evaluation-instance records and model blobs, in the JAX package's layouts:
sqlite, localfs, the parquet event log, fsspec model stores and the remote
storage daemon (see ``config`` for the env vars)."""

from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    EventFrame,
    LEvents,
    Models,
    PEvents,
)
from predictionio_tpu_torch.data.storage.config import (
    StorageConfig,
    StorageRuntime,
    get_storage,
    reset_storage,
)

__all__ = [
    "AccessKey",
    "App",
    "Channel",
    "EngineInstance",
    "EvaluationInstance",
    "EventFrame",
    "LEvents",
    "Models",
    "PEvents",
    "StorageConfig",
    "StorageRuntime",
    "get_storage",
    "reset_storage",
]
