"""Resilience layer of the serving front end: deadlines, load shedding and
degraded answers.

The JAX package's ``resilience`` primitives that the serving front end
needs:

- :mod:`deadline` — per-request time budgets bound to the request
  contextvars (``X-Pio-Deadline``), enforced at admission, before each
  MicroBatcher wave and at a pipelined wave's fence;
- :mod:`admission` — bounded in-flight request cap so overload sheds with
  ``503 + Retry-After`` instead of collapsing;
- :mod:`degrade` — answers an engine gave from its model alone when a live
  read failed, counted and stamped ``X-Pio-Degraded``.

- :mod:`faults` — the seeded, plan-driven fault injector
  (``PIO_FAULT_PLAN``) at the micro-batcher, generation-store, swap and
  event-store seams.

Circuit breakers and retry budgets guard the remote storage backend and
come with it.
"""


class LoadShed(Exception):
    """Request rejected by admission control (bounded queue / in-flight
    cap).  Maps to ``503`` with a ``Retry-After`` header so well-behaved
    clients back off instead of hammering a saturated server."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s
