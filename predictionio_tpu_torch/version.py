"""The port's version, the same string as the JAX package's."""

__version__ = "0.1.0"
