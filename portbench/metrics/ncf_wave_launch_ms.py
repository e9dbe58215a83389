"""A wave's launch: the host's enqueue of its kernels and of the
result's copy (``core/device_wave.py``), the span ``wave.launch``, host
seconds over the waves."""

from portbench import spans


def read(run):
    return spans.per(run, ("wave.launch",), "host_s", "waves")
