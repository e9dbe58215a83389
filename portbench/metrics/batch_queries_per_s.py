"""Every query answered in the window over the whole window."""


def read(run):
    n = run.stats.get("queries")
    return n / run.window_s if n else None
