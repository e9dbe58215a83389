"""Zero-downtime model lifecycle: crash-safe generations, canary rollout,
and drift-triggered warm-start retraining (the JAX package's
``lifecycle``, exported under the same names).
"""

from predictionio_tpu_torch.lifecycle.canary import (
    CANARY_VARIANT,
    CanaryDecider,
    CanaryPolicy,
    CanaryTracker,
    in_canary_fraction,
)
from predictionio_tpu_torch.lifecycle.controller import (
    LifecycleController,
    LifecyclePolicy,
    default_retrain,
)
from predictionio_tpu_torch.lifecycle.generations import (
    CorruptModelError,
    Generation,
    GenerationStore,
    LifecycleError,
    compute_checksum,
    compute_checksums,
)

__all__ = [
    "CANARY_VARIANT",
    "CanaryDecider",
    "CanaryPolicy",
    "CanaryTracker",
    "CorruptModelError",
    "Generation",
    "GenerationStore",
    "LifecycleController",
    "LifecycleError",
    "LifecyclePolicy",
    "compute_checksum",
    "compute_checksums",
    "default_retrain",
    "in_canary_fraction",
]
