"""At-exit cleanup hooks (workflow/CleanupFunctions.scala:29).

The JAX package's ``core/cleanup.py``: workflows and user engines register
callables to run when the workflow finishes (successfully or not), such as
closing storage connections from inside DASE components that have no
lifecycle of their own.
"""

from __future__ import annotations

import logging
from typing import Callable

log = logging.getLogger("predictionio_tpu_torch.cleanup")

_functions: list[Callable[[], None]] = []


def add(fn: Callable[[], None]) -> None:
    """Register a cleanup callable (CleanupFunctions.add)."""
    _functions.append(fn)


def run() -> None:
    """Run and clear all registered cleanups; failures are logged, not
    raised (every hook gets its chance)."""
    global _functions
    fns, _functions = _functions, []
    for fn in reversed(fns):
        try:
            fn()
        except Exception:
            log.exception("cleanup function %r failed", fn)
