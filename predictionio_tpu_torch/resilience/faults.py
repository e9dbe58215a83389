"""Deterministic fault injection for chaos testing.

The JAX package's ``resilience/faults.py``, whole: the same rules, plan
format, seeded draws and firing order, so one plan and seed fire the same
faults in either package.  The seams the port wires:

- ``batch_fn`` — the MicroBatcher dispatch, where injected errors exercise
  wave-failure isolation (bisection, solo retry);
- ``models.read`` (``corrupt``) — the generation store's checksum reads;
- ``lifecycle.swap`` — ``verify_and_swap`` between verification and the
  manifest commit, where a stall lets a chaos run kill the process
  mid-swap;
- ``eventstore.write`` — the event server, checked before each insert;
- ``canary.predict`` — every answer a canary binding computes (solo, host
  wave, device dispatch), where injected errors trip the canary's error
  guardrail;
- ``lifecycle.swap`` also at the lifecycle controller's promote and
  rollback, and ``lifecycle.retrain`` before its warm-start retrain;
- ``remote.send`` / ``remote.response`` — the ``RemoteClient`` transport
  (connect/send phase and response phase), where injected connection
  resets, timeouts and latency exercise the retry policy and the circuit
  breaker as a dying storage daemon would;
- ``compact.fold`` / ``compact.publish`` — each shard's fold in the
  parquet event log, before the fold and between the compacted segment's
  publish and the unlink of what it supersedes.

Zero overhead when disabled: the seams do
``if faults.ACTIVE is not None: faults.ACTIVE.check(seam, label)`` — one
module-attribute read per call, no allocation, no plan parsing.

Plans are deterministic: rule matching is positional (``after`` skips the
first N matching calls, ``count`` bounds total firings) and probabilistic
rules draw from a ``random.Random(seed)``, so the same plan + seed + call
sequence injects the same faults — chaos tests assert exact outcomes, no
flakes.  Activate via the test API (:func:`install`/:func:`clear`) or the
environment::

    PIO_FAULT_PLAN='[{"seam": "remote.send", "kind": "connection_reset",
                      "match": "GET /v1", "count": 3}]'
    PIO_FAULT_PLAN=@/path/to/plan.json
    PIO_FAULT_SEED=7

See docs/robustness.md for the fault-plan cookbook.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


class FaultInjected(Exception):
    """An injected application-level fault (kind="error")."""


#: kind -> exception factory; "latency"/"slow_response" sleep instead;
#: "corrupt" mutates bytes at data seams (FaultInjector.corrupt) and is
#: inert at raise/delay seams
_KIND_ERRORS: dict[str, Callable[[str], BaseException]] = {
    "error": FaultInjected,
    "connection_reset": ConnectionResetError,
    "connection_refused": ConnectionRefusedError,
    "timeout": TimeoutError,
}

_KINDS = frozenset(_KIND_ERRORS) | {"latency", "slow_response", "corrupt"}


@dataclass
class FaultRule:
    """One line of a fault plan.

    ``seam`` names the injection point; ``match`` is a substring filter on
    the seam's call label (e.g. ``"GET /v1/apps"``); ``after`` skips the
    first N matching calls; ``count`` caps total firings (None =
    unlimited); ``probability`` gates each firing through the seeded RNG;
    ``latency_s`` is the injected delay for latency kinds (which fire and
    then let the call proceed).
    """

    seam: str
    kind: str
    match: str = ""
    after: int = 0
    count: int | None = None
    probability: float = 1.0
    latency_s: float = 0.0
    message: str = "injected fault"
    # bookkeeping (not part of the plan wire format)
    seen: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {sorted(_KINDS)}"
            )


class FaultInjector:
    """Evaluate a plan of :class:`FaultRule` at each instrumented seam."""

    def __init__(
        self,
        rules: Sequence[FaultRule],
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.rules = list(rules)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()

    def check(self, seam: str, label: str = "") -> None:
        """Raise/delay per the plan for one call at ``seam``.  Rules are
        evaluated in order; the first *raising* rule wins, latency rules
        stack with whatever follows."""
        for r in self.rules:
            if r.seam != seam or (r.match and r.match not in label):
                continue
            if r.kind == "corrupt":
                continue  # data-mutation rules only fire through corrupt()
            with self._lock:
                n = r.seen
                r.seen += 1
                if n < r.after:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                if r.probability < 1.0 and self._rng.random() >= r.probability:
                    continue
                r.fired += 1
            if r.kind in ("latency", "slow_response"):
                self._sleep(r.latency_s)
                continue
            raise _KIND_ERRORS[r.kind](
                f"{r.message} [{r.kind} @ {seam} {label}]".strip()
            )

    def latency(self, seam: str, label: str = "") -> float:
        """Latency-kind rules as a QUERY: return the matching rules' total
        injected delay instead of sleeping it, for seams that fold the
        delay into their own clock — the per-shard settle measurement
        (``placement.settle_shards``) defers one device's observed
        readiness rather than stalling the poll over every device.  Same
        after/count/probability bookkeeping as :meth:`check`; raising
        kinds never fire here."""
        total = 0.0
        for r in self.rules:
            if r.seam != seam or r.kind not in ("latency", "slow_response"):
                continue
            if r.match and r.match not in label:
                continue
            with self._lock:
                n = r.seen
                r.seen += 1
                if n < r.after:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                if r.probability < 1.0 and self._rng.random() >= r.probability:
                    continue
                r.fired += 1
            total += r.latency_s
        return total

    def corrupt(self, seam: str, label: str, data: bytes) -> bytes:
        """Data-seam injection: deterministically flip bytes when a
        ``kind="corrupt"`` rule matches (same after/count/probability
        bookkeeping as :meth:`check`).  Used by checksum-verified readers
        (lifecycle generation store) to prove corrupt blobs are refused —
        the mutation is a bit-flip per 1 KiB page, so any real checksum
        catches it."""
        for r in self.rules:
            if r.seam != seam or r.kind != "corrupt":
                continue
            if r.match and r.match not in label:
                continue
            with self._lock:
                n = r.seen
                r.seen += 1
                if n < r.after:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                if r.probability < 1.0 and self._rng.random() >= r.probability:
                    continue
                r.fired += 1
            if not data:
                continue
            out = bytearray(data)
            for i in range(0, len(out), 1024):
                out[i] ^= 0xFF
            return bytes(out)
        return data

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {
                    "seam": r.seam,
                    "kind": r.kind,
                    "match": r.match,
                    "seen": r.seen,
                    "fired": r.fired,
                }
                for r in self.rules
            ]


#: the process-wide injector; None (the overwhelmingly common case) makes
#: every seam a single attribute check
ACTIVE: FaultInjector | None = None


def install(
    rules: Sequence[FaultRule | dict], seed: int = 0, **kwargs: Any
) -> FaultInjector:
    """Install a plan process-wide (test API).  Dicts are FaultRule
    kwargs.  Returns the injector so tests can read firing counts."""
    global ACTIVE
    parsed = [r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules]
    ACTIVE = FaultInjector(parsed, seed=seed, **kwargs)
    return ACTIVE


def clear() -> None:
    global ACTIVE
    ACTIVE = None


def load_env_plan(env: dict[str, str] | None = None) -> FaultInjector | None:
    """Install a plan from ``PIO_FAULT_PLAN`` (inline JSON or ``@path``)
    and ``PIO_FAULT_SEED``.  Called once at import; returns the injector
    (or None).  A malformed plan raises — silently ignoring a chaos plan
    would fake a green chaos run."""
    e = env if env is not None else os.environ
    raw = e.get("PIO_FAULT_PLAN")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], "r", encoding="utf-8") as f:
            raw = f.read()
    plan = json.loads(raw)
    if not isinstance(plan, list):
        raise ValueError("PIO_FAULT_PLAN must be a JSON array of rules")
    return install(plan, seed=int(e.get("PIO_FAULT_SEED", "0")))


load_env_plan()
