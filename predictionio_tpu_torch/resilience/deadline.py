"""Deadline propagation: a per-request time budget that travels with the
request context.

The JAX package's ``resilience/deadline.py``, copied.  With a deadline
bound at admission (from the ``X-Pio-Deadline`` header or the server's
default budget), every layer can ask :func:`remaining` and stop doing work
nobody will consume:

- the HTTP front ends reject already-expired requests at admission;
- the MicroBatcher resolves expired queued items with
  :class:`DeadlineExceeded` instead of spending device time on them, and
  re-checks at the pipelined wave's fence.

The deadline is stored as an *absolute* monotonic instant in a contextvar,
so nested calls all count down the same budget (gRPC deadline semantics,
not per-hop timeouts).  The wire format is *relative* seconds (clocks are
not shared across hosts).  ``_now`` is module-level so tests can freeze it.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator

#: request header carrying the remaining budget in (fractional) seconds
DEADLINE_HEADER = "X-Pio-Deadline"

_deadline_var: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "pio_torch_deadline", default=None
)


def _now() -> float:
    """Monotonic clock — module-level so tests can freeze it."""
    return time.monotonic()


class DeadlineExceeded(Exception):
    """The request's time budget ran out before the work completed.
    Maps to HTTP 504 on the serving surface."""


def bind_deadline(absolute: float | None) -> contextvars.Token:
    """Bind an absolute monotonic deadline to the current context."""
    return _deadline_var.set(absolute)


def set_deadline(budget_s: float) -> contextvars.Token:
    """Bind a deadline ``budget_s`` seconds from now."""
    return bind_deadline(_now() + budget_s)


def reset_deadline(token: contextvars.Token) -> None:
    _deadline_var.reset(token)


def get_deadline() -> float | None:
    """The absolute monotonic deadline bound to this context, or None."""
    return _deadline_var.get()


def remaining() -> float | None:
    """Seconds of budget left (may be <= 0), or None when no deadline."""
    dl = _deadline_var.get()
    return None if dl is None else dl - _now()


def expired() -> bool:
    dl = _deadline_var.get()
    return dl is not None and dl <= _now()


def check(what: str = "request") -> None:
    """Raise :class:`DeadlineExceeded` when the bound deadline has passed."""
    rem = remaining()
    if rem is not None and rem <= 0:
        raise DeadlineExceeded(
            f"{what} deadline exceeded ({-rem * 1000.0:.0f} ms past budget)"
        )


def parse_budget(value: str | None) -> float | None:
    """Parse a wire budget (seconds, e.g. ``"0.25"``) into a float.
    Malformed or non-finite values yield None — a client typo must not 500
    the request, it just serves without a deadline."""
    if not value:
        return None
    try:
        budget = float(value)
    except ValueError:
        return None
    if budget != budget or budget in (float("inf"), float("-inf")):
        return None
    return budget


@contextlib.contextmanager
def deadline_scope(
    budget_s: float | None = None, absolute: float | None = None
) -> Iterator[None]:
    """Bind a deadline for the duration of a block (no-op when both are
    None).  ``absolute`` wins when given — the MicroBatcher worker re-binds
    a wave's earliest captured deadline this way."""
    if budget_s is None and absolute is None:
        yield
        return
    token = (
        bind_deadline(absolute) if absolute is not None else set_deadline(budget_s)
    )
    try:
        yield
    finally:
        reset_deadline(token)
