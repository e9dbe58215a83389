"""Per-tenant admission quotas: a debtable token bucket.

The bucket refills at ``rate`` units/second up to ``burst``; each admitted
request spends one unit at the front-end choke point (httpd.admit_request),
BEFORE the query can occupy a MicroBatcher slot.  ``debit`` lets the cost
ledger back-charge *measured* usage (device seconds, flops-derived units)
after a wave bills — the balance may go negative, which sheds future
requests until the refill pays the debt off.  That is what "token buckets
fed by the cost ledger's counters" means in practice: admission is cheap
and optimistic, settlement is exact.

Thread-safe; the clock is injectable so tests are deterministic.  The
JAX package's ``tenancy/quota.py``, whole.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable


class TokenBucket:
    """Token bucket with post-hoc debiting (balance may go negative)."""

    def __init__(
        self,
        rate: float,
        burst: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError("rate must be > 0 units/second")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(self.rate, 1.0)
        if self.burst <= 0:
            raise ValueError("burst must be > 0")
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._at = clock()
        self._spent = 0.0
        self._denied = 0

    def _refilled(self, now: float) -> tuple[float, float]:
        """Pure refill: the post-refill (tokens, at) pair.  Callers assign
        the result while holding ``self._lock`` so every write to the
        balance is lexically inside a critical section."""
        elapsed = now - self._at
        tokens = self._tokens
        if elapsed > 0:
            tokens = min(tokens + elapsed * self.rate, self.burst)
        return tokens, now

    def try_spend(self, units: float = 1.0) -> bool:
        """Spend ``units`` if the balance covers them; False = shed."""
        with self._lock:
            self._tokens, self._at = self._refilled(self._clock())
            if self._tokens < units:
                self._denied += 1
                return False
            self._tokens -= units
            self._spent += units
            return True

    def debit(self, units: float) -> None:
        """Back-charge measured usage; may drive the balance negative so
        the NEXT requests pay for work already done (the ledger feed)."""
        if units <= 0:
            return
        with self._lock:
            self._tokens, self._at = self._refilled(self._clock())
            self._tokens -= units
            self._spent += units

    def retry_after_s(self, units: float = 1.0) -> float:
        """Honest Retry-After: seconds until the balance covers ``units``."""
        with self._lock:
            self._tokens, self._at = self._refilled(self._clock())
            short = units - self._tokens
        return max(short / self.rate, 0.0) or 0.05

    @property
    def tokens(self) -> float:
        with self._lock:
            self._tokens, self._at = self._refilled(self._clock())
            return self._tokens

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            self._tokens, self._at = self._refilled(self._clock())
            return {
                "rate": self.rate,
                "burst": self.burst,
                "tokens": round(self._tokens, 3),
                # burn fraction of the sustained rate over the bucket's
                # lifetime would need a window; expose the raw counters and
                # let the dashboard compute burn from two scrapes
                "spent": round(self._spent, 3),
                "denied": self._denied,
            }
