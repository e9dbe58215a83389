"""predictionio_tpu_torch — the PyTorch + CUDA port of predictionio_tpu.

The port grows slice by slice beside the JAX package and mirrors its module
paths, so every module here has a counterpart of the same name there.  It
imports ``torch`` and numpy, never ``jax`` and never the JAX package.

It trains and serves the ``recommendation`` template (explicit ALS): ALS
training with the hand-written accumulator kernels (``csrc/als_accum.cu``),
and a deploy (``server.prediction_server.create_prediction_server``) whose
asyncio front end coalesces concurrent queries into micro-batched waves;
waves below ``ALSAlgorithm.DEVICE_BATCH_MIN`` queries are answered from a
host numpy replica, larger ones by the hand-written fused score+top-k CUDA
kernel (``csrc/fused_topk.cu``), fenced while the next wave dispatches.
The rest of the ALS family trains implicit ALS on the same kernels and
serves through ``ops.similarity``: ``similarproduct``, ``recommendeduser``
and ``ecommerce`` (whose business rules read the event store live).  A
deploy may hold a canary beside its live generation, run the lifecycle
controller (``lifecycle``) and serve several engines as tenants
(``tenancy``), each wave partitioned by tenant and side.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""

from predictionio_tpu_torch.version import __version__

__all__ = ["__version__"]
