"""An NCF step's forward and loss on the card: the device span
``ncf.step.forward`` (a CUDA-event pair in ``train_step``), device seconds
over the steps."""

from portbench import spans


def read(run):
    return spans.per(run, ("ncf.step.forward",), "device_s", "steps")
