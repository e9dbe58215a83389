"""A wave's render: its answers built from the top-k
(``NCFAlgorithm._render_wave``), the span ``wave.render``, host seconds over
the waves."""

from portbench import spans


def read(run):
    return spans.per(run, ("wave.render",), "host_s", "waves")
