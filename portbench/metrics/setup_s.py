"""Seconds from the run's start to the window's: imports, the kernels'
build where it is not cached, inputs and weights, the program's set-up and
the warm-up of every shape."""


def read(run):
    return run.setup_s
