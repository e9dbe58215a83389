"""Engine templates of the port.  Importing this package registers every
bundled engine factory (``recommendation`` in this slice)."""

from predictionio_tpu_torch.models import recommendation  # noqa: F401
