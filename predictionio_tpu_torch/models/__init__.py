"""Engine templates of the port.  Importing this package registers every
bundled engine factory: ``recommendation``, ``similarproduct``,
``recommendeduser``, ``classification``, ``ecommerce``, ``ncf`` and
``external``, the JAX package's list."""

from predictionio_tpu_torch.models import (  # noqa: F401
    classification,
    ecommerce,
    external,
    ncf,
    recommendation,
    similarproduct,
)
