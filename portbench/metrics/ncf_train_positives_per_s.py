"""Every positive trained in the window, each with its negatives, over the
whole window."""


def read(run):
    n = run.stats.get("positives")
    return n / run.window_s if n else None
