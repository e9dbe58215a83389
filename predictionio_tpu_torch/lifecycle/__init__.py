"""Model lifecycle: the crash-safe generation store and its checksum gate.

The JAX package's ``lifecycle`` minus what is not ported yet: the canary
(``canary.py``) and the closed-loop controller (``controller.py``) come
with a later slice.
"""

from predictionio_tpu_torch.lifecycle.generations import (
    CorruptModelError,
    Generation,
    GenerationStore,
    LifecycleError,
    compute_checksum,
    compute_checksums,
)

__all__ = [
    "CorruptModelError",
    "Generation",
    "GenerationStore",
    "LifecycleError",
    "compute_checksum",
    "compute_checksums",
]
