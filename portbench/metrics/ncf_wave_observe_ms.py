"""A wave's bookkeeping: provenance, the launch signature, the least work
and its cost before the dispatch, the device time's gauges after the
fence, the span ``wave.observe``, host seconds over the waves."""

from portbench import spans


def read(run):
    return spans.per(run, ("wave.observe",), "host_s", "waves")
