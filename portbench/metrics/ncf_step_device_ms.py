"""Device time of an NCF step: every device operation's time in the traced
window over the steps."""


def read(run):
    n = run.stats.get("steps")
    if run.trace is None or not n or not run.trace.device_s:
        return None
    return 1e3 * sum(run.trace.device_s.values()) / n
