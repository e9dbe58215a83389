"""The whole window over every ALS iteration completed in it, host work
between and around the calls included: milliseconds an iteration."""


def read(run):
    n = run.stats.get("iterations")
    return 1e3 * run.window_s / n if n else None
