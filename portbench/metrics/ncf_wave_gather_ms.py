"""A wave's host gather: the wave stages ``host_gather`` (the users' rows
looked up and padded) and ``h2d`` (the ids' upload enqueued), as the spans
``wave.host_gather`` and ``wave.h2d``, host seconds over the waves."""

from portbench import spans


def read(run):
    return spans.per(run, ("wave.host_gather", "wave.h2d"), "host_s", "waves")
