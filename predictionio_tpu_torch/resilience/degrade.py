"""Degraded-mode marking: answer worse, loudly, instead of failing.

The port of the JAX package's ``resilience/degrade.py``.  An engine with
live event-store reads on its hot path (ecommerce seen-filtering and
recent items) can still serve a model-only answer when the store is
unreachable.  That fallback must be *visible*: unmarked degradation looks
identical to health until someone notices recommendations repeating items
users already bought.

:func:`mark_degraded` is what a fallback site calls.  It increments
``pio_degraded_total{reason}`` and, when a :func:`degraded_scope` is open,
records the reason so the serving layer can stamp the response
(``X-Pio-Degraded`` header).  Scopes are contextvar based, so they work on
request threads, inside ``run_in_executor`` handlers (via
``copy_context``), and on the MicroBatcher worker (which opens one scope
per wave).  The reason is also annotated on the request's flight-recorder
entry (``obs.flight.annotate(degraded=...)``), so a slow or errored
degraded answer says why.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

from predictionio_tpu_torch.obs.flight import annotate
from predictionio_tpu_torch.obs.metrics import REGISTRY

_degraded_var: contextvars.ContextVar[list[str] | None] = (
    contextvars.ContextVar("pio_degraded", default=None)
)

_m_degraded = REGISTRY.counter(
    "pio_degraded_total",
    "Requests answered in degraded (fallback) mode, by reason",
    labelnames=("reason",),
)


def mark_degraded(reason: str) -> None:
    """Record that the current operation fell back to a degraded answer."""
    _m_degraded.labels(reason).inc()
    annotate(degraded=reason)
    reasons = _degraded_var.get()
    if reasons is not None and reason not in reasons:
        reasons.append(reason)


def current_degraded() -> list[str]:
    """Reasons recorded in the innermost open scope (empty when none)."""
    return list(_degraded_var.get() or ())


@contextlib.contextmanager
def degraded_scope() -> Iterator[list[str]]:
    """Collect degradation reasons for a block; yields the live list."""
    reasons: list[str] = []
    token = _degraded_var.set(reasons)
    try:
        yield reasons
    finally:
        _degraded_var.reset(token)
