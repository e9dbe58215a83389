"""A wave's host time: the window less the waves' summed device time, over
the waves (``batch_predict`` fences each wave before the next, so the two
add up)."""


def read(run):
    s, n = run.stats.get("wave_device_s"), run.stats.get("waves")
    return 1e3 * (run.window_s - s) / n if s and n else None
