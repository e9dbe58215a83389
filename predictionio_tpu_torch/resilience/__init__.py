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
- :mod:`retry` — bounded retry policy with decorrelated-jitter backoff and
  a retry budget (no retry storms), and :mod:`breaker` — closed, open and
  half-open circuit breakers per storage-daemon endpoint, exported as
  ``pio_breaker_state`` gauges, folded into ``/readyz`` and ``/slo.json``;
  both guard ``RemoteClient``, whose ``remote.send`` and
  ``remote.response`` seams the fault injector also covers.
"""

from predictionio_tpu_torch.resilience.admission import AdmissionController  # noqa: F401
from predictionio_tpu_torch.resilience.breaker import (  # noqa: F401
    BREAKER_STATES,
    CircuitBreaker,
    CircuitOpen,
    breaker_states,
    get_breaker,
    reset_breakers,
)
from predictionio_tpu_torch.resilience.deadline import (  # noqa: F401
    DEADLINE_HEADER,
    DeadlineExceeded,
    deadline_scope,
    get_deadline,
    remaining,
)
from predictionio_tpu_torch.resilience.degrade import (  # noqa: F401
    current_degraded,
    degraded_scope,
    mark_degraded,
)
from predictionio_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjected,
    FaultInjector,
    FaultRule,
)
from predictionio_tpu_torch.resilience.retry import (  # noqa: F401
    RetryBudget,
    RetryPolicy,
)


class LoadShed(Exception):
    """Request rejected by admission control (bounded queue / in-flight
    cap).  Maps to ``503`` with a ``Retry-After`` header so well-behaved
    clients back off instead of hammering a saturated server."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s
