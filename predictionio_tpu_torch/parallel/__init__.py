"""Device placement of the port: the mesh of device slots (``mesh``), the
declarative shard layout and the factor-sharded top-k (``placement``), and
the per-model factor cache (``device_cache``)."""

from predictionio_tpu_torch.parallel.mesh import (
    MeshConfig,
    default_mesh,
    make_mesh,
)
from predictionio_tpu_torch.parallel.placement import (
    BoundShards,
    ShardPlan,
    ShardPlanError,
    bind_shards,
    build_sharded_topk,
    gather_rows,
    replicate,
    shard_put,
)

__all__ = [
    "MeshConfig",
    "default_mesh",
    "make_mesh",
    "BoundShards",
    "ShardPlan",
    "ShardPlanError",
    "bind_shards",
    "build_sharded_topk",
    "gather_rows",
    "replicate",
    "shard_put",
]
