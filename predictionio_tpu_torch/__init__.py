"""predictionio_tpu_torch — the PyTorch + CUDA port of predictionio_tpu.

The port grows slice by slice beside the JAX package and mirrors its module
paths, so every module here has a counterpart of the same name there.  It
imports ``torch`` and numpy, never ``jax`` and never the JAX package.

This slice serves the ``recommendation`` template (explicit ALS): a
persisted model is deployed (``server.prediction_server.deploy_engine``),
solo queries are answered from a host numpy replica, and waves of
``ALSAlgorithm.DEVICE_BATCH_MIN`` queries or more run the hand-written fused
score+top-k CUDA kernel (``csrc/fused_topk.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
