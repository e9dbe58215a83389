"""An NCF step's optimizer on the card: the Adam update of every leaf,
the device span ``ncf.step.optimizer`` (a CUDA-event pair in ``train_step``),
device seconds over the steps."""

from portbench import spans


def read(run):
    return spans.per(run, ("ncf.step.optimizer",), "device_s", "steps")
