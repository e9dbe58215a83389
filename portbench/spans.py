"""The program's span totals after a traced window: the capture store of
``predictionio_tpu_torch.obs.tracing`` (``capture_totals``), which every
span and wave stage fills while the profiler records the window.  A
program without the store, or a window without the spans, reads None."""

from __future__ import annotations


def per(run, names: tuple, field: str, count: str):
    """Milliseconds of ``field`` (``host_s`` or ``device_s``) summed over
    the spans ``names`` that were captured, over ``run.stats[count]``;
    None when none of them was."""
    n = run.stats.get(count)
    if not n:
        return None
    try:
        from predictionio_tpu_torch.obs import tracing
    except ImportError:
        return None
    totals = getattr(tracing, "capture_totals", None)
    if totals is None:
        return None
    got = totals()
    found = [got[name][field] for name in names if name in got]
    return 1e3 * sum(found) / n if found else None
