"""The lifecycle controller: drift/staleness -> warm-start retrain ->
stage -> canary -> promote-or-rollback.

The JAX package's ``lifecycle/controller.py``: the same policy, env knobs,
metrics, verdicts and fault seams (``lifecycle.swap`` at each flip,
``lifecycle.retrain`` before a retrain).  Its retrain runs on the
controller's thread, on the device the deploy serves from: the port's
``run_train(warm_start_from=...)``, which for the ALS engines is kernel 1's
path on a card.

One controller runs per serving process (a daemon thread owned by the
prediction server when lifecycle is enabled).  Each :meth:`tick` is one
step of the closed loop:

1. **canary in progress** — evaluate the guardrails
   (:class:`~predictionio_tpu_torch.lifecycle.canary.CanaryDecider`) against the
   request stats and the per-variant online metrics; promote or roll back
   when the verdict lands (both are one atomic manifest write followed by
   an in-memory generation flip + drain of the loser);
2. **idle** — when the :class:`~predictionio_tpu_torch.obs.quality.DriftDetector`
   state is ``drifting``, or the live generation is older than
   ``staleness_s``, launch an incremental warm-start retrain from the
   event store (``run_train(warm_start_from=<live instance>)`` — ALS
   factors / NCF embedding tables of the previous generation seed the new
   run), checksum + stage the result, verify it, and start the canary.

Every transition is metered (``pio_lifecycle_*``) and every decision is
clock-injected so tests drive the loop deterministically with ``tick()``
under a frozen clock: no sleeps, no flakes.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from predictionio_tpu_torch.lifecycle.canary import (
    CANARY_VARIANT,
    CONTINUE,
    PROMOTE,
    ROLLBACK,
    CanaryDecider,
    CanaryPolicy,
    CanaryTracker,
)
from predictionio_tpu_torch.lifecycle.generations import (
    CorruptModelError,
    GenerationStore,
    LifecycleError,
)
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.resilience import faults

log = logging.getLogger("predictionio_tpu_torch.lifecycle")

#: pio_lifecycle_state gauge values
IDLE, RETRAINING, CANARYING = 0, 1, 2


@dataclass(frozen=True)
class LifecyclePolicy:
    """Controller knobs on top of the canary policy."""

    canary: CanaryPolicy = CanaryPolicy()
    #: retrain when the live generation is older than this (None = never)
    staleness_s: float | None = None
    #: react to QualityMonitor drift state == "drifting"
    retrain_on_drift: bool = True
    #: minimum seconds between retrain launches (drift stays "drifting"
    #: for many windows; one reaction per episode, not one per tick)
    cooldown_s: float = 300.0
    #: controller thread wake interval
    check_interval_s: float = 5.0

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "LifecyclePolicy":
        """Policy from ``PIO_CANARY_*`` / ``PIO_LIFECYCLE_*`` env knobs
        unset keys keep defaults."""
        import os

        e = env if env is not None else os.environ
        canary = CanaryPolicy(
            fraction=float(e.get("PIO_CANARY_FRACTION", 0.1)),
            min_requests=int(e.get("PIO_CANARY_MIN_REQUESTS", 50)),
            max_error_rate=float(e.get("PIO_CANARY_MAX_ERROR_RATE", 0.05)),
            min_joined=int(e.get("PIO_CANARY_MIN_JOINED", 20)),
            metric=e.get("PIO_CANARY_METRIC", "hit_rate"),
            max_metric_regression=float(
                e.get("PIO_CANARY_MAX_REGRESSION", 0.10)
            ),
            max_canary_s=float(e.get("PIO_CANARY_MAX_S", 3600.0)),
        )
        staleness = e.get("PIO_LIFECYCLE_STALENESS_S")
        return cls(
            canary=canary,
            staleness_s=float(staleness) if staleness else None,
            retrain_on_drift=e.get(
                "PIO_LIFECYCLE_RETRAIN_ON_DRIFT", "1"
            ).lower() in ("1", "on", "true", "yes"),
            cooldown_s=float(e.get("PIO_LIFECYCLE_COOLDOWN_S", 300.0)),
            check_interval_s=float(e.get("PIO_LIFECYCLE_INTERVAL_S", 5.0)),
        )


class LifecycleController:
    """Closed-loop model lifecycle for one deployed engine."""

    def __init__(
        self,
        deployed: Any,  # server.prediction_server.DeployedEngine
        store: GenerationStore,
        quality: Any | None = None,  # obs.quality.QualityMonitor
        retrain: Callable[[str | None], Any] | None = None,
        policy: LifecyclePolicy | None = None,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.deployed = deployed
        self.store = store
        self.quality = quality
        self.policy = policy or LifecyclePolicy()
        self._retrain = retrain
        self._clock = clock
        self.tracker = CanaryTracker(clock=clock)
        self.decider = CanaryDecider(self.policy.canary)
        self._lock = threading.RLock()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._stopping = False
        self._last_retrain_at: float | None = None
        self._last_event: dict[str, Any] | None = None
        reg = registry or REGISTRY
        self._m_state = reg.gauge(
            "pio_lifecycle_state",
            "Lifecycle controller state: 0 idle, 1 retraining, 2 canarying",
        )
        self._m_retrains = reg.counter(
            "pio_lifecycle_retrains_total",
            "Warm-start retrains launched, by trigger",
            labelnames=("trigger",),
        )
        self._m_retrain_failures = reg.counter(
            "pio_lifecycle_retrain_failures_total",
            "Retrain/stage attempts that failed before a canary started",
        )
        self._m_promotions = reg.counter(
            "pio_lifecycle_promotions_total",
            "Canary generations promoted to live",
        )
        self._m_rollbacks = reg.counter(
            "pio_lifecycle_rollbacks_total",
            "Generations rolled back, by reason",
            labelnames=("reason",),
        )
        self._m_corrupt = reg.counter(
            "pio_lifecycle_corrupt_blobs_total",
            "Model blobs refused by checksum verification",
        )
        self._m_age = reg.gauge(
            "pio_lifecycle_generation_age_seconds",
            "Age of the live generation",
        )
        self._m_state.set(IDLE)

    # -- introspection -------------------------------------------------------

    @property
    def last_event(self) -> dict[str, Any] | None:
        with self._lock:
            return dict(self._last_event) if self._last_event else None

    def _note(self, kind: str, **detail: Any) -> None:
        event = {"event": kind, "at": self._clock(), **detail}
        with self._lock:
            self._last_event = event
        log.info("lifecycle %s", kind, extra=detail)

    def snapshot(self) -> dict[str, Any]:
        """The /lifecycle.json controller half."""
        canary_gen = getattr(self.deployed, "canary_instance", None)
        return {
            "enabled": True,
            "canary_in_progress": canary_gen is not None,
            "canary_instance": getattr(canary_gen, "id", None),
            "canary_stats": self.tracker.snapshot(),
            "policy": {
                "fraction": self.policy.canary.fraction,
                "min_requests": self.policy.canary.min_requests,
                "max_error_rate": self.policy.canary.max_error_rate,
                "min_joined": self.policy.canary.min_joined,
                "metric": self.policy.canary.metric,
                "max_metric_regression":
                    self.policy.canary.max_metric_regression,
                "staleness_s": self.policy.staleness_s,
                "retrain_on_drift": self.policy.retrain_on_drift,
            },
            "last_event": self.last_event,
        }

    # -- the loop ------------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="pio-lifecycle", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            thread = self._thread
            self._thread = None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
            try:
                self.tick()
            except Exception:
                log.exception("lifecycle tick failed")
            self._wake.wait(self.policy.check_interval_s)
            self._wake.clear()

    def tick(self) -> str | None:
        """One controller step; returns what happened (for tests/logs):
        None | "promote" | "rollback" | "retrain" | "retrain_failed"."""
        self._update_age_gauge()
        if getattr(self.deployed, "canary_instance", None) is not None:
            return self._tick_canary()
        trigger = self._should_retrain()
        if trigger is None:
            self._m_state.set(IDLE)
            return None
        return self._tick_retrain(trigger)

    def _update_age_gauge(self) -> None:
        live = self.store.live()
        if live is not None:
            anchor = live.promoted_at or live.created_at
            if anchor:
                self._m_age.set(max(self._clock() - anchor, 0.0))

    # -- canary evaluation ---------------------------------------------------

    def _tick_canary(self) -> str | None:
        self._m_state.set(CANARYING)
        comparison = None
        if self.quality is not None:
            comparison = self.quality.compare_variants(
                self.deployed.variant_label,
                CANARY_VARIANT,
                metric=self.policy.canary.metric,
            )
        verdict, reason = self.decider.evaluate(
            self.tracker.snapshot(), comparison, self.tracker.age_s()
        )
        if verdict == CONTINUE:
            return None
        canary = self.deployed.canary_instance
        if verdict == PROMOTE:
            self.promote(canary, reason)
            return PROMOTE
        self.rollback(canary, reason, label=_rollback_label(reason))
        return ROLLBACK

    def promote(self, instance: Any, reason: str = "") -> None:
        """Atomic flip to the canary generation: manifest commit first
        (the crash-safe point), then the in-memory swap, then the old
        generation drains."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("lifecycle.swap", f"promote {instance.id}")
        old = self.store.live()
        self.store.promote(instance.id, note=reason)
        self.deployed.promote_canary()
        self.tracker.stop()
        self._m_promotions.inc()
        self._m_state.set(IDLE)
        self._note(
            "promote", instance=instance.id, reason=reason,
            previous=getattr(old, "instance_id", None),
        )
        if old is not None:
            self.deployed.wait_drained(old.instance_id, timeout=5.0)

    def rollback(
        self, instance: Any, reason: str = "", label: str = "guardrail"
    ) -> None:
        """Abort the canary: manifest first, then drop the in-memory
        binding; live traffic never notices."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("lifecycle.swap", f"rollback {instance.id}")
        try:
            self.store.rollback(instance.id, note=reason)
        except LifecycleError:
            log.warning("rollback of unmanifested generation %s", instance.id)
        self.deployed.clear_canary()
        self.tracker.stop()
        self._m_rollbacks.labels(label).inc()
        self._m_state.set(IDLE)
        self._note("rollback", instance=instance.id, reason=reason)
        self.deployed.wait_drained(instance.id, timeout=5.0)

    # -- retrain trigger + launch -------------------------------------------

    def _should_retrain(self) -> str | None:
        now = self._clock()
        if (
            self._last_retrain_at is not None
            and now - self._last_retrain_at < self.policy.cooldown_s
        ):
            return None
        if (
            self.policy.retrain_on_drift
            and self.quality is not None
            and self.quality.drift_state() == "drifting"
        ):
            return "drift"
        if self.policy.staleness_s is not None:
            live = self.store.live()
            anchor = (
                (live.promoted_at or live.created_at) if live else None
            )
            if anchor and now - anchor > self.policy.staleness_s:
                return "stale"
        return None

    def _tick_retrain(self, trigger: str) -> str:
        self._m_state.set(RETRAINING)
        self._m_retrains.labels(trigger).inc()
        self._last_retrain_at = self._clock()
        live = self.store.live()
        warm_from = live.instance_id if live else None
        self._note("retrain", trigger=trigger, warm_start_from=warm_from)
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.check("lifecycle.retrain", trigger)
            instance = self._run_retrain(warm_from)
            gen = self.store.record(instance.id, status="staged")
            self.store.verify(gen)
            self.deployed.stage_canary(
                instance, fraction=self.policy.canary.fraction
            )
            self.store.start_canary(instance.id)
            self.tracker.start()
        except CorruptModelError as e:
            self._m_corrupt.inc()
            return self._retrain_failed(trigger, e)
        except Exception as e:
            log.exception("warm-start retrain failed")
            return self._retrain_failed(trigger, e)
        self._m_state.set(CANARYING)
        self._note(
            "canary_started", instance=instance.id,
            fraction=self.policy.canary.fraction, trigger=trigger,
        )
        return "retrain"

    def _retrain_failed(self, trigger: str, error: Exception) -> str:
        """Unified failure path: whatever step died, no half-started
        canary may survive it — a binding staged before a later step
        failed would otherwise serve traffic un-tracked (no manifest
        entry, no started tracker, so the max_canary_s fail-safe could
        never fire)."""
        self.deployed.clear_canary()
        self.tracker.stop()
        self._m_retrain_failures.inc()
        self._m_state.set(IDLE)
        self._note("retrain_failed", trigger=trigger, error=str(error))
        return "retrain_failed"

    def _run_retrain(self, warm_start_from: str | None) -> Any:
        """Train a new generation; the default rebuilds the live
        instance's exact engine + params and warm-starts from its model."""
        if self._retrain is not None:
            return self._retrain(warm_start_from)
        return default_retrain(self.deployed, warm_start_from)


def _rollback_label(reason: str) -> str:
    """Map a decider reason to the pio_lifecycle_rollbacks_total{reason}
    label so dashboards can tell error-rate breaches, latency breaches,
    metric regressions, and evidence timeouts apart."""
    if "error rate" in reason:
        return "error_rate"
    if "p95" in reason:
        return "latency"
    if "regressed" in reason:
        return "metric_regression"
    if "burden of proof" in reason:
        return "timeout"
    return "guardrail"


#: one side stream per card for the controller's retrains: the caching
#: allocator keeps a stream's blocks for that stream, so a stream per
#: retrain would strand each retrain's memory in a pool nothing reuses
_RETRAIN_STREAMS: dict[Any, Any] = {}


def default_retrain(deployed: Any, warm_start_from: str | None) -> Any:
    """Retrain the deployed engine's live configuration from the event
    store, warm-starting from the previous generation's model, on the
    device the deploy serves from.  Returns the COMPLETED EngineInstance.

    On a card the train runs on this thread's own CUDA stream (non-blocking
    against the default stream the serving waves use), with the device set
    on the thread: its kernel-1 launches and staging interleave with the
    waves instead of queueing behind them, and its closing synchronize
    waits for its own stream only."""
    import torch

    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.workflow import run_train

    instance = deployed.instance
    device = deployed.ctx.device
    ctx = EngineContext(storage=deployed.storage, mode="train", device=device)

    def train() -> Any:
        return run_train(
            deployed.engine,
            deployed.params,
            ctx=ctx,
            engine_id=instance.engine_id,
            engine_version=instance.engine_version,
            engine_variant=instance.engine_variant,
            engine_factory=instance.engine_factory,
            storage=deployed.storage,
            warm_start_from=warm_start_from,
        )

    if device.type != "cuda":
        return train()
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(device)
    stream = _RETRAIN_STREAMS.get(device)
    if stream is None:
        stream = _RETRAIN_STREAMS.setdefault(device, torch.cuda.Stream(device))
    with torch.cuda.stream(stream):
        return train()
