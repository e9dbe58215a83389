"""A wave's fence: the host's wait for the wave's event (``compute``) and
its read of the pinned result (``d2h``), the spans ``wave.compute`` and
``wave.d2h``, host seconds over the waves."""

from portbench import spans


def read(run):
    return spans.per(run, ("wave.compute", "wave.d2h"), "host_s", "waves")
