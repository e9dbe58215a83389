"""Lock-contention attribution for the process's hot locks.

The JAX package's ``obs/contention.py``, stdlib only.  A degraded
coalescing rate or a lengthened wave tail often traces back to a host
lock: the MicroBatcher condition, the metrics registry, the span-fragment
store.  These wrappers turn that hunch into a gauge.

:class:`ContendedLock` wraps a ``threading.Lock`` (or ``RLock`` with
``reentrant=True``) and meters ONLY the contended path: an uncontended
acquisition is one non-blocking ``acquire(False)`` attempt — no clock
reads, no metric writes — so adopting the wrapper costs the hot path
nothing when the lock is free.  When the fast path loses, the blocking
acquisition is timed into ``pio_lock_wait_seconds{lock}`` and counted in
``pio_lock_contended_total{lock}``.

:class:`ContendedCondition` is a ``threading.Condition`` built over a
:class:`ContendedLock`, so condition re-acquisition after ``wait()`` —
where waiters pile up behind the notifier — is attributed too.

Metric children resolve lazily on first contention (never at import), and
a thread-local re-entrancy guard lets the metrics registry instrument its
OWN lock: resolving the lock metrics walks the registry, which acquires
the registry lock; a resolution already in flight on this thread skips the
observation instead of deadlocking on itself.

:class:`LockWitness` is the runtime half of the static lock-order analysis
in the JAX package: with ``PIO_LOCK_WITNESS=1`` (or
:func:`enable_witness`), every ContendedLock acquisition records the
per-thread held-lock stack, accumulates the executed "held A, acquired B"
edge set, and flags order inversions *actually run* — counted in
``pio_lock_order_violations_total{pair}`` and dumped (with the edge set)
at the debug-gated ``/locks.json`` route.  With the witness off (the
default) the only cost on the uncontended fast path is one module-global
load and a None check.
"""

from __future__ import annotations

import os
import threading
import time

#: re-entrancy guard: True while THIS thread is resolving lock metrics
#: through the registry (whose own lock may be a ContendedLock)
_resolving = threading.local()

#: cap on retained violation records (the counter keeps exact totals)
_WITNESS_MAX_VIOLATIONS = 100


class LockWitness:
    """Runtime lock-order recorder for ContendedLock acquisitions.

    Per-thread held-name stacks live in a ``threading.local``; the shared
    edge table is guarded by a plain ``threading.Lock`` (the witness must
    not instrument itself).  An inversion is recorded the moment an edge
    ``(B, A)`` is executed while ``(A, B)`` was ever executed before — the
    interleaving that deadlocks did not need to happen, only both orders.

    Acquisitions made while this thread is resolving metric children
    (``_resolving.busy``) are invisible: those are the instrumentation's
    own registry walks, not application lock nesting.
    """

    def __init__(self) -> None:
        self._tls = threading.local()
        self._mu = threading.Lock()
        self._edges: dict[tuple[str, str], int] = {}
        self._violations: list[dict] = []

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquired(self, name: str) -> None:
        if getattr(_resolving, "busy", False):
            return
        held = self._held()
        if name in held:
            held.append(name)  # re-entrant: no new ordering fact
            return
        inversions: list[tuple[str, str]] = []
        if held:
            with self._mu:
                for h in dict.fromkeys(held):
                    pair = (h, name)
                    self._edges[pair] = self._edges.get(pair, 0) + 1
                    if (name, h) in self._edges:
                        inversions.append(pair)
                        if len(self._violations) < _WITNESS_MAX_VIOLATIONS:
                            self._violations.append(
                                {
                                    "pair": "|".join(sorted((h, name))),
                                    "held": h,
                                    "acquired": name,
                                    "stack": list(held) + [name],
                                    "thread": threading.current_thread().name,
                                }
                            )
        held.append(name)
        for pair in inversions:
            self._count_violation(pair)

    def note_released(self, name: str) -> None:
        if getattr(_resolving, "busy", False):
            return
        held = getattr(self._tls, "held", None)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def _count_violation(self, pair: tuple[str, str]) -> None:
        """Bump the violations counter OUTSIDE the witness mutex, with the
        metrics-resolution guard set so the registry walk (which acquires
        the registry's own ContendedLock) is not witnessed as more edges."""
        if getattr(_resolving, "busy", False):
            return
        _resolving.busy = True
        try:
            from predictionio_tpu_torch.obs.metrics import REGISTRY

            REGISTRY.counter(
                "pio_lock_order_violations_total",
                "Runtime lock-order inversions observed by the LockWitness",
                labelnames=("pair",),
            ).labels("|".join(sorted(pair))).inc()
        except Exception:
            pass  # telemetry must never take the serving path down
        finally:
            _resolving.busy = False

    def snapshot(self) -> dict:
        """Edge set + retained violations (the /locks.json payload)."""
        with self._mu:
            edges = sorted(self._edges.items())
            violations = list(self._violations)
        return {
            "enabled": True,
            "edges": [
                {"src": a, "dst": b, "count": n} for (a, b), n in edges
            ],
            "violations": violations,
        }

    def edge_set(self) -> set:
        with self._mu:
            return set(self._edges)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._violations.clear()


#: process witness; installed at import when PIO_LOCK_WITNESS=1, or later
#: via enable_witness() (tests).  Read once per acquisition — keep it a
#: single module-global load.
_WITNESS: LockWitness | None = (
    LockWitness() if os.environ.get("PIO_LOCK_WITNESS") == "1" else None
)


def witness() -> LockWitness | None:
    return _WITNESS


def enable_witness() -> LockWitness:
    global _WITNESS
    _WITNESS = LockWitness()
    return _WITNESS


def disable_witness() -> None:
    global _WITNESS
    _WITNESS = None


def witness_snapshot() -> dict:
    w = _WITNESS
    if w is None:
        return {"enabled": False, "edges": [], "violations": []}
    return w.snapshot()


class ContendedLock:
    """A ``with``-able lock whose blocked acquisitions are metered.

    ``reentrant=True`` wraps an ``RLock`` (a re-entrant acquisition by the
    owning thread takes the uncontended fast path, as it should — the
    thread never blocks).  ``registry`` defaults to the process registry,
    resolved lazily so construction order never matters.
    """

    __slots__ = ("name", "_inner", "_registry", "_m_wait", "_m_contended")

    def __init__(
        self,
        name: str,
        registry=None,
        reentrant: bool = False,
    ):
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._registry = registry
        self._m_wait = None
        self._m_contended = None

    def prime(self) -> "ContendedLock":
        """Resolve the metric children NOW, while the caller guarantees
        nothing holds the lock.  Required for a registry instrumenting its
        OWN lock: a lazy resolution inside a contended acquire would walk
        the registry and re-acquire the very lock being reported on —
        self-deadlock on a non-reentrant lock."""
        self._metrics()
        return self

    def _metrics(self):
        """(wait histogram, contended counter) children, or (None, None)
        while a resolution through the registry is already in flight on
        this thread (the registry's own lock instrumenting itself)."""
        if self._m_wait is not None:
            return self._m_wait, self._m_contended
        if getattr(_resolving, "busy", False):
            return None, None
        _resolving.busy = True
        try:
            reg = self._registry
            if reg is None:
                # lazy, and ONLY on the default path: the process registry
                # instruments its own lock with registry=self, and resolves
                # while obs.metrics is still mid-import
                from predictionio_tpu_torch.obs.metrics import REGISTRY

                reg = REGISTRY
            m_wait = reg.histogram(
                "pio_lock_wait_seconds",
                "Time spent blocked acquiring an instrumented hot lock",
                labelnames=("lock",),
            ).labels(self.name)
            # the counter resolves (and publishes) BEFORE the histogram:
            # the early return above keys on _m_wait, so a concurrent
            # caller observing it set must never see _m_contended None —
            # acquire() would .inc() on None with the inner lock held
            self._m_contended = reg.counter(
                "pio_lock_contended_total",
                "Acquisitions of an instrumented hot lock that had to block",
                labelnames=("lock",),
            ).labels(self.name)
            self._m_wait = m_wait
        finally:
            _resolving.busy = False
        return self._m_wait, self._m_contended

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # uncontended fast path: one non-blocking attempt, zero telemetry —
        # histogram mass appears ONLY when an acquisition genuinely blocked
        # (witness off: the only overhead here is one global load + is-None)
        if self._inner.acquire(False):
            w = _WITNESS
            if w is not None:
                w.note_acquired(self.name)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._inner.acquire(True, timeout)
        wait_s = time.perf_counter() - t0
        m_wait, m_contended = self._metrics()
        if m_wait is not None:
            m_contended.inc()
            m_wait.observe(wait_s)
        if ok:
            w = _WITNESS
            if w is not None:
                w.note_acquired(self.name)
        return ok

    def release(self) -> None:
        w = _WITNESS
        if w is not None:
            w.note_released(self.name)
        self._inner.release()

    def __enter__(self) -> "ContendedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        w = _WITNESS
        if w is not None:
            w.note_released(self.name)
        self._inner.release()


class _ReentrantContendedLock(ContendedLock):
    """A reentrant :class:`ContendedLock` that a ``threading.Condition`` can
    wait on: the condition's ownership test and its full release/restore
    around a wait go to the inner ``RLock`` (the stdlib fallbacks assume a
    non-reentrant lock).  The re-acquisition after a wait, at depth one, is
    metered like any other acquisition."""

    __slots__ = ()

    def __init__(self, name: str, registry=None):
        super().__init__(name, registry=registry, reentrant=True)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        w = _WITNESS
        if w is not None:
            w.note_released(self.name)
        return self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        count, _owner = state
        if count == 1:
            self.acquire()
        else:
            self._inner._acquire_restore(state)


class ContendedCondition:
    """``threading.Condition`` over a :class:`ContendedLock`.

    Drop-in for the stdlib Condition surface the servers use (``with``,
    ``wait``, ``wait_for``, ``notify``, ``notify_all``); every blocked
    acquisition — including the re-acquisition inside ``wait`` — lands in
    the lock's wait histogram.  Its lock is reentrant, as a
    ``threading.Condition()``'s is (the JAX package's is not): a thread
    holding the condition may acquire it again.
    """

    __slots__ = ("lock", "_cond")

    def __init__(self, name: str, registry=None):
        self.lock = _ReentrantContendedLock(name, registry=registry)
        self._cond = threading.Condition(self.lock)

    def __enter__(self):
        self._cond.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._cond.__exit__(exc_type, exc, tb)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self.lock.acquire(blocking, timeout)

    def release(self) -> None:
        self.lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        return self._cond.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._cond.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()
