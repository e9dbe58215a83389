"""Params extraction and component registries, as in the JAX package."""

from predictionio_tpu_torch.utils.registry import Registry

__all__ = ["Registry"]
