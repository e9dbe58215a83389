"""A wave's device time: the CUDA-event pair the program records around
each wave's compute (``core/device_wave.py``), summed through the
``obs/device.py`` wave timeline, over the waves."""


def read(run):
    s, n = run.stats.get("wave_device_s"), run.stats.get("waves")
    return 1e3 * s / n if s and n else None
