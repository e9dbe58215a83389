"""Engine templates of the port.  Importing this package registers every
bundled engine factory: ``recommendation``, ``similarproduct``,
``recommendeduser``, ``ecommerce`` and ``ncf``."""

from predictionio_tpu_torch.models import (  # noqa: F401
    ecommerce,
    ncf,
    recommendation,
    similarproduct,
)
