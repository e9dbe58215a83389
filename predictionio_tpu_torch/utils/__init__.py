"""Params extraction and component registries, as in the JAX package."""
