"""Reduce a ``torch.profiler`` capture of the measured window to what the
per-layer metrics and the result line read: device-busy seconds (the union
of every device operation's interval), device seconds and counts by
operation name, and the idle gaps between device operations, each named by
the innermost host operation that was running at its middle ("host" where
none was).  Frozen from ``chip_smoke.py`` ``profile_idle``, which sums the
device time by kernel; the union and the gaps are new here.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

#: longest stretch of host events searched back for the one under a gap
_LOOKBACK = 256
#: characters kept of an operation's name in the breakdown
_NAME_CHARS = 64


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float = 0.0
    #: device seconds and launches per operation name
    device_s: dict = field(default_factory=dict)
    device_n: dict = field(default_factory=dict)
    #: idle seconds per name of the host operation under the gap
    gaps_s: dict = field(default_factory=dict)

    def kernel(self, fragment: str) -> tuple[float, int]:
        """Summed seconds and count of the device operations whose name
        contains ``fragment``."""
        s = sum(v for k, v in self.device_s.items() if fragment in k)
        n = sum(v for k, v in self.device_n.items() if fragment in k)
        return s, n

    def breakdown(self) -> dict:
        top = lambda d: [[k[:_NAME_CHARS], v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.device_s), "idle_gaps": top(self.gaps_s)}


def summarize(prof, window_s: float) -> TraceSummary:
    """The summary of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = TraceSummary(window_s=window_s)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            dev.append((start, start + dur))
            out.device_s[name] = out.device_s.get(name, 0.0) + dur / 1e9
            out.device_n[name] = out.device_n.get(name, 0) + 1
        elif dur > 0:
            host.append((start, start + dur, e.name()))
    if not dev:
        return out
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    busy, (lo, hi) = 0, dev[0]
    for s, e in dev[1:]:
        if s > hi:
            busy += hi - lo
            _gap(out, host, starts, hi, s)
            lo, hi = s, e
        else:
            hi = max(hi, e)
    out.busy_s = (busy + hi - lo) / 1e9
    return out


def _gap(out: TraceSummary, host, starts, a: int, b: int) -> None:
    mid = (a + b) // 2
    j = bisect.bisect_right(starts, mid)
    name, best = "host", None
    for s, e, n in host[max(0, j - _LOOKBACK):j]:
        if e >= mid and (best is None or e - s < best):
            name, best = n, e - s
    out.gaps_s[name] = out.gaps_s.get(name, 0.0) + (b - a) / 1e9


@contextlib.contextmanager
def profiled(on_card: bool):
    """A ``torch.profiler.profile`` of host and (on a card) device
    operations; the capture is read with :func:`summarize`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
