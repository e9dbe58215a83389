"""An NCF step's backward on the card: the gradients zeroed and autograd,
the device span ``ncf.step.backward`` (a CUDA-event pair in ``train_step``),
device seconds over the steps."""

from portbench import spans


def read(run):
    return spans.per(run, ("ncf.step.backward",), "device_s", "steps")
