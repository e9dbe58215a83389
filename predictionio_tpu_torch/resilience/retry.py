"""Retry policy: bounded attempts, decorrelated-jitter backoff, and a
retry *budget* so retries can't amplify an outage.

The JAX package's ``resilience/retry.py``, copied: the same policy, the
same draws from the same seeded RNG, so one seed replays the same backoff
sequence in either package.  A :class:`RetryPolicy` makes the attempt
count, backoff curve and jitter of ``RemoteClient`` explicit and testable;
a :class:`RetryBudget` (token bucket fed by successful first attempts)
caps the *fleet-level* retry rate: when a daemon is down, unbudgeted
retries from every serving thread are a synchronized thundering herd at
exactly the moment the daemon restarts.

Backoff uses "decorrelated jitter" (the AWS Architecture Blog variant):
``sleep = min(cap, uniform(base, prev * 3))``, which spreads retries
across the window instead of clustering at powers of two.  The RNG is
injectable so tests are deterministic.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to try and how long to wait between tries.

    ``max_attempts`` counts the first try (2 == one retry, the legacy
    RemoteClient behavior).  ``base_backoff_s``/``max_backoff_s`` bound the
    decorrelated-jitter sleep; attempt 0 never sleeps.
    """

    max_attempts: int = 2
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff_s(
        self, prev_backoff_s: float, rng: random.Random
    ) -> float:
        """Next sleep given the previous one (0.0 before the first retry)."""
        prev = max(prev_backoff_s, self.base_backoff_s)
        return min(
            self.max_backoff_s, rng.uniform(self.base_backoff_s, prev * 3.0)
        )


#: a policy that never retries (breaker-only operation)
NO_RETRY = RetryPolicy(max_attempts=1)


class RetryBudget:
    """Token bucket limiting retries to a fraction of successful traffic.

    Every completed call deposits ``deposit_per_call`` (capped at ``cap``);
    every retry withdraws 1.0.  With the defaults, sustained retries are
    limited to ~10% of call volume — one slow daemon degrades retries to a
    trickle instead of doubling its own load.  Starts full so cold-start
    blips (daemon restarting as the server boots) still get retried.
    """

    def __init__(self, cap: float = 10.0, deposit_per_call: float = 0.1):
        self.cap = float(cap)
        self.deposit_per_call = float(deposit_per_call)
        self._lock = threading.Lock()
        self._tokens = self.cap

    def record_call(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self.deposit_per_call, self.cap)

    def try_spend(self) -> bool:
        """True when a retry may proceed (a token was available)."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        return self._tokens
