"""The autoscaler: the controller that closes the capacity loop.

``/capacity.json`` (obs/capacity.py) computes ``recommended_replicas`` per
replica; :func:`~predictionio_tpu_torch.fleet.membership.fleet_capacity`
aggregates the scrapes fleet-wide; this module is what finally *obeys*
the signal — the LifecycleController idiom: a daemon thread around a
test-drivable :meth:`Autoscaler.tick`.

Each tick:

1. refresh membership + scrape every replica's ``/capacity.json``;
2. aggregate into a desired size (an operator pin via
   ``pio fleet scale`` / ``POST /fleet/scale`` overrides the model);
3. apply **hysteresis** (``scale_up_patience`` / ``scale_down_patience``
   consecutive ticks must agree before anything moves — one noisy scrape
   must not flap the fleet) and **cooldown** (no two scaling actions
   within ``cooldown_s`` — a replica that just booted hasn't absorbed
   load yet, scaling again on the same signal would overshoot);
4. scale **up** by spawning one replica through the
   :class:`ReplicaSpawner` (the `pio deploy` daemon machinery), or
   **down** by draining one: quiesce in the
   :class:`~predictionio_tpu_torch.fleet.membership.FleetState` (routing stops
   immediately), wait for the replica's generation-refcount drain (its
   ``/status.json`` reports per-generation in-flight counts and
   micro-batch queue state), then SIGTERM via the pidfile
   (:func:`~predictionio_tpu_torch.tools.daemon.stop_pidfile`).  One action per
   tick: convergence is deliberate, divergence is bounded.

The router tier holds no CUDA context; only the replicas do, so the card's
memory is paid per replica, never per router.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.fleet.membership import FleetState, fleet_capacity
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("predictionio_tpu_torch.fleet")


@dataclass(frozen=True)
class AutoscalerPolicy:
    """Sizing bounds + hysteresis/cooldown knobs (``PIO_FLEET_*``)."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: consecutive ticks that must recommend growing before one spawn
    scale_up_patience: int = 2
    #: consecutive ticks that must recommend shrinking before one drain —
    #: deliberately laxer than up: under-capacity burns the SLO, over-
    #: capacity burns money
    scale_down_patience: int = 3
    #: minimum seconds between scaling actions
    cooldown_s: float = 30.0
    #: controller loop period (the daemon-thread pacing)
    tick_interval_s: float = 5.0
    #: how long a drain may wait on a replica's in-flight work before the
    #: SIGTERM escalation path handles it anyway
    drain_timeout_s: float = 30.0

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "AutoscalerPolicy":
        import os

        e = env or os.environ
        return cls(
            min_replicas=int(e.get("PIO_FLEET_MIN_REPLICAS", 1)),
            max_replicas=int(e.get("PIO_FLEET_MAX_REPLICAS", 4)),
            scale_up_patience=int(e.get("PIO_FLEET_UP_PATIENCE", 2)),
            scale_down_patience=int(e.get("PIO_FLEET_DOWN_PATIENCE", 3)),
            cooldown_s=float(e.get("PIO_FLEET_COOLDOWN_S", 30.0)),
            tick_interval_s=float(e.get("PIO_FLEET_TICK_S", 5.0)),
            drain_timeout_s=float(e.get("PIO_FLEET_DRAIN_TIMEOUT_S", 30.0)),
        )


class ReplicaSpawner:
    """What the autoscaler scales through.  Implementations own the
    replica *processes*; the FleetState owns the *membership*."""

    def spawn(self) -> str:
        """Start one replica; returns its base URL once it answers
        /readyz (or at least binds its port)."""
        raise NotImplementedError

    def drain(self, url: str) -> None:
        """Wait for the (already-quiesced) replica's in-flight work to
        finish, then stop the process."""
        raise NotImplementedError

    def stop_all(self) -> None:
        """Tear down every replica this spawner owns (fleet shutdown)."""


class LocalProcessSpawner(ReplicaSpawner):
    """Replicas as local ``pio deploy`` daemon subprocesses — the
    single-host proof of the loop (a k8s/Ray spawner implements the same
    two methods against its scheduler).

    Each spawn allocates a port, detaches ``python -m
    predictionio_tpu_torch.tools.cli deploy <deploy_args> --device <device>
    --ip <host> --port N`` with a ``$PIO_HOME/pids/replica-<port>.pid``
    pidfile, and waits for ``/readyz`` to answer 200.  ``device`` is the
    port's own addition: each replica binds its model on that device
    (``cuda`` by default, one CUDA context per replica process), and
    ``ready_s`` keeps each replica's spawn-to-ready seconds.  Drain polls the replica's ``/status.json``
    until no generation holds an in-flight request and the micro-batch
    queue is idle, then SIGTERMs (escalating to SIGKILL) via
    :func:`~predictionio_tpu_torch.tools.daemon.stop_pidfile`.
    """

    def __init__(
        self,
        deploy_args: list[str],
        host: str = "127.0.0.1",
        base_port: int | None = None,
        ready_timeout_s: float = 180.0,
        drain_timeout_s: float = 30.0,
        poll_interval_s: float = 0.2,
        device: str = "cuda",
    ):
        self.deploy_args = list(deploy_args)
        self.device = device
        #: url -> seconds from spawn to the first 200 on /readyz
        self.ready_s: dict[str, float] = {}
        self.host = host
        self._next_port = base_port
        self.ready_timeout_s = ready_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.poll_interval_s = poll_interval_s
        self._lock = threading.Lock()
        self._pidfiles: dict[str, Any] = {}  # url -> Path
        self._pacer = threading.Event()

    def _alloc_port(self) -> int:
        import socket

        with self._lock:
            if self._next_port is not None:
                port = self._next_port
                self._next_port += 1
                return port
        with socket.socket() as s:
            s.bind((self.host, 0))
            return s.getsockname()[1]

    def _get_json(self, url: str, timeout: float = 2.0) -> tuple[int, Any]:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.status, json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read().decode("utf-8"))
            except ValueError:
                return e.code, None

    def spawn(self) -> str:
        from predictionio_tpu_torch.tools import daemon

        port = self._alloc_port()
        url = f"http://{self.host}:{port}"
        pidfile = daemon._pid_dir() / f"replica-{port}.pid"
        t0 = time.monotonic()
        daemon.spawn_daemon(
            ["deploy", *self.deploy_args, "--device", self.device,
             "--ip", self.host, "--port", str(port)],
            pidfile,
        )
        with self._lock:
            self._pidfiles[url] = pidfile
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            try:
                status, _ = self._get_json(url + "/readyz")
                if status == 200:
                    with self._lock:
                        self.ready_s[url] = time.monotonic() - t0
                    log.info("replica spawned and ready at %s", url)
                    return url
            except Exception:
                if not daemon.pid_alive(daemon.read_pidfile(pidfile)):
                    raise RuntimeError(
                        f"replica subprocess for {url} died at boot; see "
                        f"its log next to {pidfile}"
                    )
            self._pacer.wait(self.poll_interval_s)
        raise TimeoutError(f"replica {url} never answered /readyz")

    def pid_of(self, url: str) -> int | None:
        """The live pid behind a spawned replica url (None when unknown or
        dead) — chaos harnesses SIGKILL through this instead of groping
        pidfiles."""
        from predictionio_tpu_torch.tools import daemon

        with self._lock:
            pidfile = self._pidfiles.get(url)
        if pidfile is None:
            return None
        pid = daemon.read_pidfile(pidfile)
        return pid if daemon.pid_alive(pid) else None

    def wait_replica_drained(self, url: str, timeout_s: float | None = None) -> bool:
        """Poll the replica's /status.json generation-refcount surface
        until idle; True when it drained inside the timeout."""
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.drain_timeout_s
        )
        while time.monotonic() < deadline:
            try:
                status, body = self._get_json(url + "/status.json")
            except Exception:
                return True  # already gone: nothing left to drain
            if status == 200 and isinstance(body, dict):
                if not body.get("inflightGenerations") and not body.get(
                    "batcherBusy"
                ):
                    return True
            self._pacer.wait(self.poll_interval_s)
        return False

    def drain(self, url: str) -> None:
        from predictionio_tpu_torch.tools import daemon

        drained = self.wait_replica_drained(url)
        if not drained:
            log.warning(
                "replica %s did not drain within %.0fs; stopping anyway",
                url, self.drain_timeout_s,
            )
        with self._lock:
            pidfile = self._pidfiles.pop(url, None)
        if pidfile is not None:
            won = daemon.stop_pidfile(pidfile)
            log.info("replica %s stopped (%s)", url, won or "not running")

    def stop_all(self) -> None:
        from predictionio_tpu_torch.tools import daemon

        with self._lock:
            pidfiles = dict(self._pidfiles)
            self._pidfiles.clear()
        for url, pidfile in pidfiles.items():
            won = daemon.stop_pidfile(pidfile)
            log.info("replica %s stopped (%s)", url, won or "not running")


class Autoscaler:
    """Scrape → aggregate → hysteresis → spawn/drain, one action per tick."""

    def __init__(
        self,
        fleet: FleetState,
        spawner: ReplicaSpawner,
        policy: AutoscalerPolicy | None = None,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
        alerts: Any | None = None,
    ):
        self.fleet = fleet
        self.spawner = spawner
        self.policy = policy or AutoscalerPolicy()
        self._clock = clock
        #: an AlertEvaluator to narrate into: every scale action is
        #: recorded as a synthetic resolved-alert event, so an incident
        #: timeline read hours later explains WHY capacity changed
        self.alerts = alerts
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._stopping = False
        self._target_override: int | None = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at: float | None = None
        self._last_event: dict[str, Any] | None = None
        reg = registry or REGISTRY
        self._m_desired = reg.gauge(
            "pio_autoscaler_desired_replicas",
            "Fleet size the autoscaler is converging toward",
        )
        self._m_actions = reg.counter(
            "pio_autoscaler_actions_total",
            "Scaling actions taken, by direction",
            labelnames=("action",),
        )

    # -- operator override ---------------------------------------------------

    def set_target(self, n: int | None) -> None:
        """Pin the fleet size (None returns to capacity-model control).
        A pin still honors the min/max bounds and the drain protocol, but
        skips hysteresis — the operator already decided."""
        with self._lock:
            self._target_override = n
            self._up_streak = 0
            self._down_streak = 0

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "enabled": True,
                "target_override": self._target_override,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "last_event": dict(self._last_event) if self._last_event else None,
                "policy": {
                    "min_replicas": self.policy.min_replicas,
                    "max_replicas": self.policy.max_replicas,
                    "scale_up_patience": self.policy.scale_up_patience,
                    "scale_down_patience": self.policy.scale_down_patience,
                    "cooldown_s": self.policy.cooldown_s,
                },
            }

    def _note(self, kind: str, **detail: Any) -> None:
        event = {"event": kind, "at": self._clock(), **detail}
        with self._lock:
            self._last_event = event
        log.info("autoscaler %s", kind, extra=detail)
        if self.alerts is not None:
            try:
                self.alerts.note_event(
                    f"autoscaler_{kind}",
                    f"autoscaler {kind}: "
                    + " ".join(f"{k}={v}" for k, v in sorted(detail.items())),
                    severity=(
                        "warning" if kind == "spawn_failed" else "info"
                    ),
                    key=str(detail.get("replica") or ""),
                    **detail,
                )
            except Exception:
                log.exception("autoscaler alert-event note failed")

    # -- the loop ------------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="pio-autoscaler", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            thread = self._thread
            self._thread = None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=10.0)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
            try:
                self.tick()
            except Exception:
                log.exception("autoscaler tick failed")
            self._wake.wait(self.policy.tick_interval_s)
            self._wake.clear()

    # -- one controller step -------------------------------------------------

    def desired_size(self, capacity: Mapping[str, Any]) -> int | None:
        """The size this tick wants: operator pin, else the fleet capacity
        model's recommendation (None when the model has no signal yet),
        clamped to [min_replicas, max_replicas]."""
        with self._lock:
            pinned = self._target_override
        raw = pinned if pinned is not None else capacity.get("recommended_replicas")
        if raw is None:
            if capacity.get("scale_hint") == "up":
                # burn-only signal (no computable ceiling): grow by one
                raw = self.fleet.active_count() + 1
            else:
                return None
        return max(self.policy.min_replicas, min(int(raw), self.policy.max_replicas))

    def tick(self) -> str | None:
        """One step; returns "scale_up" | "scale_down" | None (held)."""
        self.fleet.refresh()
        capacity = fleet_capacity(self.fleet)
        current = self.fleet.active_count()
        desired = self.desired_size(capacity)
        if desired is not None:
            self._m_desired.set(desired)
        with self._lock:
            pinned = self._target_override is not None
            if desired is None or desired == current:
                self._up_streak = 0
                self._down_streak = 0
                return None
            if desired > current:
                self._up_streak += 1
                self._down_streak = 0
                ready = pinned or self._up_streak >= self.policy.scale_up_patience
            else:
                self._down_streak += 1
                self._up_streak = 0
                ready = pinned or self._down_streak >= self.policy.scale_down_patience
            in_cooldown = (
                self._last_action_at is not None
                and self._clock() - self._last_action_at < self.policy.cooldown_s
            )
        if not ready or (in_cooldown and not pinned):
            return None
        if desired > current:
            return self._scale_up(current, desired)
        return self._scale_down(current, desired)

    def _scale_up(self, current: int, desired: int) -> str | None:
        try:
            url = self.spawner.spawn()
        except Exception as e:
            self._note("spawn_failed", error=str(e))
            log.error("replica spawn failed: %s", e)
            return None
        self.fleet.add(url)
        with self._lock:
            self._last_action_at = self._clock()
            self._up_streak = 0
        self._m_actions.labels("scale_up").inc()
        self._note("scale_up", replica=url, size=current + 1, desired=desired)
        return "scale_up"

    def _pick_victim(self) -> str | None:
        """Shrink from the tail of the membership list: the most recently
        added replica carries the fewest affine entities' history."""
        reps = [r for r in self.fleet.replicas() if not r.draining]
        return reps[-1].url if reps else None

    def _scale_down(self, current: int, desired: int) -> str | None:
        victim = self._pick_victim()
        if victim is None:
            return None
        # 1. stop routing (rendezvous hashing re-homes the victim's
        #    entities onto the survivors deterministically)
        self.fleet.quiesce(victim)
        # 2. wait on the replica's generation-refcount drain, then stop it
        try:
            self.spawner.drain(victim)
        except Exception as e:
            log.error("replica drain failed for %s: %s", victim, e)
        # 3. drop it from membership
        self.fleet.remove(victim)
        with self._lock:
            self._last_action_at = self._clock()
            self._down_streak = 0
        self._m_actions.labels("scale_down").inc()
        self._note("scale_down", replica=victim, size=current - 1, desired=desired)
        return "scale_down"
