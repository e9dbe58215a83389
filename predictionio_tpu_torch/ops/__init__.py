"""Device ops of the port: top-k (host replicas and the fused CUDA kernel)
and ALS with its segment-accumulator CUDA kernels.

``ALSParams``, ``ALSState`` and ``train_als`` load lazily: ``ops.als``
imports torch.  No import here builds a kernel or touches the card."""

from predictionio_tpu_torch.utils.lazy import lazy_exports

__all__ = ["ALSParams", "ALSState", "train_als"]

__getattr__, __dir__ = lazy_exports(
    __name__,
    {"predictionio_tpu_torch.ops.als": ("ALSParams", "ALSState", "train_als")},
)
