"""The production-day harness: drive a scenario against the real fleet.

``run_day`` owns the whole topology — N ``pio deploy`` replica
subprocesses behind the real router, event ingest in-process, the alert
evaluator + incident recorder watching the run's own registry — executes
the scenario's phases with the seeded open-loop generator while firing
its timed actions (SIGKILL, deploy flip, storage stall), and hands every
piece of evidence to :func:`predictionio_tpu_torch.obs.verdict.evaluate_day`.
The replicas run on ``device`` (``cuda`` unless asked for the CPU), each
its own process and CUDA context; the device is resolved before any
replica spawns, and a replica that fails on ``cuda`` fails the day.

The mid-peak deploy ("canary_flip") mints a NEW engine generation by
cloning the latest COMPLETED instance (fresh id, same verified bytes —
a deploy's identity flip without a training run's wall time) and
hot-swaps every replica through ``POST /reload``; the verdict then holds
`X-Pio-Engine-Instance` coherence across the flip.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Callable

from predictionio_tpu_torch.obs.verdict import evaluate_day, render_verdict
from predictionio_tpu_torch.replay.scenario import Scenario
from predictionio_tpu_torch.replay.workload import OpenLoopRunner, schedule_digest

__all__ = ["run_day", "seed_demo_home", "clone_generation"]


# ---------------------------------------------------------------------------
# storage helpers
# ---------------------------------------------------------------------------


def seed_demo_home(
    home,
    *,
    users: int = 12,
    items: int = 10,
    app_name: str = "fleet",
    seed: int = 5,
    device=None,
) -> str:
    """Events + one trained recommendation generation in a fresh
    PIO_HOME — the fixture of the mini day.  Returns the engine instance
    id.  The events come from the same ``default_rng(seed)`` draws as the
    JAX package's fixture; the train runs on ``device`` (``None`` means
    ``cuda``, which raises :class:`~predictionio_tpu_torch.device.DeviceUnavailable`
    on a host without a card unless ``"cpu"`` is given), resolved before
    anything is written."""
    import numpy as np

    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import EngineParams, resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.models.recommendation import (  # noqa: F401
        ALSAlgorithmParams,
        DataSourceParams,
        recommendation_engine,
    )

    device = resolve_device(device)
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    app_id = storage.apps().insert(App(id=0, name=app_name))
    le = storage.l_events()
    le.init(app_id)
    rng = np.random.default_rng(seed)
    le.insert_batch(
        [
            Event(
                event="rate",
                entity_type="user",
                entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"m{i}",
                properties=DataMap({"rating": float(rng.uniform(1, 5))}),
            )
            for u in range(users)
            for i in range(items)
            if rng.random() < 0.8
        ],
        app_id,
    )
    engine = resolve_engine_factory("recommendation")()
    params = EngineParams(
        datasource=("ratings", DataSourceParams(app_name=app_name)),
        preparator=("ratings", None),
        algorithms=(("als", ALSAlgorithmParams(rank=4, num_iterations=2)),),
        serving=("first", None),
    )
    inst = run_train(
        engine,
        params,
        ctx=EngineContext(storage=storage, mode="train", device=device),
        storage=storage,
        engine_factory="recommendation",
    )
    storage.close()
    return inst.id


def clone_generation(storage) -> Any:
    """Mint a new COMPLETED engine instance from the latest one: fresh
    id + timestamps, the same (already checksum-verified) model bytes
    copied under the new id.  The replica's gated /reload path records
    and verifies the clone's generation manifest on swap, exactly as it
    would a freshly trained one."""
    from datetime import datetime, timezone

    from predictionio_tpu_torch.data.storage.base import _manifest_part_names
    from predictionio_tpu_torch.lifecycle.generations import SHARD_PLAN_SUFFIX

    instances = storage.engine_instances()
    completed = [i for i in instances.get_all() if i.status == "COMPLETED"]
    if not completed:
        raise RuntimeError("no COMPLETED engine instance to clone")
    latest = max(completed, key=lambda i: i.start_time)
    now = datetime.now(tz=timezone.utc)
    clone = dataclasses.replace(
        latest,
        id=uuid.uuid4().hex,
        start_time=now,
        end_time=now,
        batch="day-flip",
    )
    models = storage.models()
    framed = models.get(f"{latest.id}:manifest")
    if framed is not None:
        manifest = models.get_manifest(latest.id)
        parts = {
            name: models.get_part(latest.id, name)
            for name in _manifest_part_names(framed)
        }
        models.insert_parts(clone.id, manifest, parts)
    else:
        blob = models.get(latest.id)
        if blob is None:
            raise RuntimeError(f"instance {latest.id} has no stored model")
        models.insert(clone.id, blob)
    plan = models.get(f"{latest.id}{SHARD_PLAN_SUFFIX}")
    if plan is not None:
        models.insert(f"{clone.id}{SHARD_PLAN_SUFFIX}", plan)
    instances.insert(clone)
    return clone


def _post_json(url: str, payload: dict | None = None, timeout: float = 30.0):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload or {}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, {}


def _get_json(url: str, timeout: float = 10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, None


# ---------------------------------------------------------------------------
# the day
# ---------------------------------------------------------------------------


def _scrape_device_seconds(fleet, per_replica: dict[str, float]) -> float:
    """Sum of every replica's cost-ledger device seconds.  A killed
    replica's ledger vanishes mid-day; its last-seen total is retained so
    the fleet total (and the per-phase deltas cut from it) stay
    monotone."""
    for rep in list(fleet.replicas()):
        try:
            status, body = _get_json(rep.url + "/costs.json", timeout=5.0)
        except Exception:
            continue
        if status != 200 or not isinstance(body, dict):
            continue
        total = sum(
            float(row.get("device_s", 0.0) or 0.0)
            for row in body.get("totals", [])
        )
        prev = per_replica.get(rep.url, 0.0)
        per_replica[rep.url] = max(total, prev)
    return sum(per_replica.values())


def run_day(
    scenario: Scenario,
    *,
    replicas: int = 2,
    seed: int | None = None,
    engine: str = "recommendation",
    report_path: str | None = None,
    incident_dir: str | None = None,
    disable_incidents: bool = False,
    out: Callable[[str], None] = print,
    device: str | None = None,
) -> tuple[int, dict[str, Any]]:
    """Run one scripted day; returns ``(exit_code, report)`` — 0 when the
    verdict passes, 1 when any clause fails.  ``PIO_HOME`` must already
    hold a trained engine (see :func:`seed_demo_home`).  The replicas
    deploy on ``device`` (``None`` means ``cuda``); it is resolved first,
    so a host without a card raises
    :class:`~predictionio_tpu_torch.device.DeviceUnavailable` before any
    replica spawns.  Beside the JAX package's report this one carries the
    ``evidence`` the verdict was cut from, the ``schedule_digest``, each
    replica's spawn-to-ready seconds, each phase's wall seconds and when
    each action ran (``actions_run``)."""
    import tempfile

    from predictionio_tpu_torch.data.storage.base import AccessKey
    from predictionio_tpu_torch.data.storage.config import get_storage
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.fleet.autoscaler import (
        Autoscaler,
        AutoscalerPolicy,
        LocalProcessSpawner,
    )
    from predictionio_tpu_torch.fleet.membership import FleetState, fleet_capacity
    from predictionio_tpu_torch.fleet.router import create_router_app
    from predictionio_tpu_torch.obs.alerts import AlertEvaluator
    from predictionio_tpu_torch.obs.incident import IncidentRecorder
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.server.event_server import create_event_server_app
    from predictionio_tpu_torch.server.httpd import AppServer

    device = str(resolve_device(device))
    effective_seed = scenario.seed if seed is None else int(seed)
    storage = get_storage()
    apps = storage.apps().get_all()
    if not apps:
        raise RuntimeError("no app in PIO_HOME; seed + train before `pio day`")
    app_row = apps[0]
    keys = storage.access_keys().get_by_appid(app_row.id)
    if keys:
        access_key = keys[0].key
    else:
        access_key = f"day-{uuid.uuid4().hex[:12]}"
        storage.access_keys().insert(AccessKey(key=access_key, appid=app_row.id))

    registry = MetricsRegistry()
    if incident_dir is None:
        incident_dir = tempfile.mkdtemp(prefix="pio-day-incidents-")
    incidents = (
        None
        if disable_incidents
        else IncidentRecorder(directory=incident_dir, registry=registry)
    )
    # Alertmanager-style inhibition: queue_shed is the generic twin of
    # ingest_shed on the same pio_shed_total metric (no label selector),
    # so a scripted storage stall would bundle TWICE for one injected
    # fault and fail reconciliation as spurious.  The specific rule wins.
    from predictionio_tpu_torch.obs.alerts import resolve_rules

    day_rules = [r for r in resolve_rules() if r.name != "queue_shed"]
    alerts = AlertEvaluator(
        registry=registry,
        incidents=incidents,
        interval_s=1.0,
        rules=day_rules,
    )

    baseline = [
        i for i in storage.engine_instances().get_all() if i.status == "COMPLETED"
    ]
    known_instances = {i.id for i in baseline}

    event_app = create_event_server_app(
        storage=storage,
        registry=registry,
        max_write_inflight=scenario.ingest_max_inflight,
    )
    event_server = AppServer(event_app, "127.0.0.1", 0).start_background()

    spawner = LocalProcessSpawner(
        deploy_args=["--engine", engine], device=device, ready_timeout_s=240.0
    )
    out(f"day[{scenario.name}]: spawning {replicas} replica(s) on {device}...")
    urls: list[str | None] = [None] * replicas
    errs: list[BaseException] = []

    def _spawn(i: int) -> None:
        try:
            urls[i] = spawner.spawn()
        except BaseException as e:  # surfaced after join
            errs.append(e)

    threads = [threading.Thread(target=_spawn, args=(i,)) for i in range(replicas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fleet = None
    router = None
    autoscaler = None
    runner = None
    try:
        if errs or any(u is None for u in urls):
            raise RuntimeError(f"replica spawn failed: {errs}")
        for u in urls:
            out(f"day[{scenario.name}]: replica {u} ready in "
                f"{spawner.ready_s[u]:.2f} s")
        fleet = FleetState(
            [u for u in urls if u],
            registry=registry,
            probe_interval_s=0.5,
            eject_after=2,
            # one refused connection opens the replica's breaker: only
            # transport errors count (a 503 shed records success), and the
            # 0.5s prober would otherwise eject the victim before three
            # forwards ever reach it — the breaker_open evidence the
            # verdict reconciles against a scripted SIGKILL must come from
            # the breaker, not the prober
            breaker_threshold=1,
        )
        fleet.probe_once()
        fleet.start()
        auto_conf = dict(scenario.slo.get("autoscaler") or {})
        policy = AutoscalerPolicy(
            min_replicas=int(auto_conf.get("min_replicas", 1)),
            max_replicas=int(auto_conf.get("max_replicas", replicas)),
        )
        autoscaler = Autoscaler(
            fleet, spawner, policy, registry=registry, alerts=alerts
        )
        if auto_conf.get("enabled"):
            autoscaler.start()
        router_app = create_router_app(
            fleet,
            registry=registry,
            autoscaler=autoscaler,
            alerts=alerts,
            incidents=incidents,
        )
        router = AppServer(router_app, "127.0.0.1", 0).start_background()
        alerts.start()

        runner = OpenLoopRunner(
            f"http://127.0.0.1:{router.port}",
            f"http://127.0.0.1:{event_server.port}",
            access_key,
            run=f"day{effective_seed}",
            max_inflight=scenario.max_inflight,
            num_items=scenario.num_items,
            query_num=scenario.query_num,
        )
        schedules = scenario.build_schedules(effective_seed)
        digest = schedule_digest(schedules)
        out(f"day[{scenario.name}]: schedule digest {digest}")

        injected: list[dict[str, Any]] = []
        stall_windows: list[list[float]] = []
        flip_info: dict[str, Any] = {}
        action_errors: list[str] = []
        day_wall_start = time.time()
        t0 = time.monotonic()

        def day_s() -> float:
            return time.monotonic() - t0

        def do_action(action) -> None:
            kind = action.kind
            if kind == "kill_replica":
                victims = [r.url for r in fleet.routable()] or [
                    u for u in urls if u
                ]
                victim = victims[int(action.params.get("replica", 0)) % len(victims)]
                pid = spawner.pid_of(victim)
                if pid is None:
                    action_errors.append(f"kill_replica: no live pid for {victim}")
                    return
                os.kill(pid, signal.SIGKILL)
                out(f"day[{scenario.name}] t={day_s():.1f}s: SIGKILL {victim}")
                injected.append(
                    {
                        "kind": kind,
                        "at_s": action.at_s,
                        "rule": action.expected_rule,
                        "victim": victim,
                    }
                )
            elif kind == "canary_flip":
                clone = clone_generation(storage)
                known_instances.add(clone.id)
                flipped = []
                for u in [r.url for r in fleet.routable()]:
                    status, body = _post_json(u + "/reload")
                    flipped.append((u, status, body.get("engineInstanceId")))
                bad = [f for f in flipped if f[1] != 200 or f[2] != clone.id]
                if bad:
                    action_errors.append(f"canary_flip: reload refused: {bad}")
                flip_info["new"] = clone.id
                # +0.25s slack: the stamp must postdate the last swap's
                # in-flight drain, not race it
                flip_info["flip_completed_s"] = day_s() + 0.25
                out(
                    f"day[{scenario.name}] t={day_s():.1f}s: flipped "
                    f"{len(flipped)} replica(s) to generation {clone.id[:8]}"
                )
                if action.expected_rule:
                    injected.append(
                        {"kind": kind, "at_s": action.at_s,
                         "rule": action.expected_rule}
                    )
            elif kind == "storage_stall":
                seconds = float(action.params.get("seconds", 15.0))
                latency_s = float(action.params.get("latency_s", 10.0))
                faults.install(
                    [
                        {
                            "seam": "eventstore.write",
                            "kind": "latency",
                            "latency_s": latency_s,
                            "message": "scripted storage stall",
                        }
                    ],
                    seed=effective_seed,
                )
                out(
                    f"day[{scenario.name}] t={day_s():.1f}s: storage stall "
                    f"armed ({latency_s:.0f}s latency for {seconds:.0f}s)"
                )
                start = day_s()
                injected.append(
                    {"kind": kind, "at_s": action.at_s,
                     "rule": action.expected_rule}
                )
                time.sleep(seconds)
                faults.clear()
                # amnesty for write sheds: stall window + the tail where
                # still-sleeping writers hold ingest-gate slots
                stall_windows.append([start, start + seconds + latency_s + 5.0])
                out(f"day[{scenario.name}] t={day_s():.1f}s: storage stall cleared")

        #: when each action really ran: day seconds at its start and end,
        #: and the wall clock at its start (to join with the logs' ``ts``)
        actions_run: list[dict[str, Any]] = []

        def action_thread() -> None:
            for action in scenario.actions:
                delay = action.at_s - day_s()
                if delay > 0:
                    time.sleep(delay)
                ran = {"kind": action.kind, "at_s": action.at_s,
                       "started_s": day_s(), "started_wall": time.time()}
                try:
                    do_action(action)
                except Exception as e:
                    action_errors.append(f"{action.kind}: {type(e).__name__}: {e}")
                ran["done_s"] = day_s()
                actions_run.append(ran)

        actions = threading.Thread(target=action_thread, daemon=True)
        actions.start()

        per_replica_cost: dict[str, float] = {}
        snapshots = [registry.render_json()]
        cost_marks = [_scrape_device_seconds(fleet, per_replica_cost)]
        phase_rows = []
        phase_wall_s = []
        for sched in schedules:
            out(
                f"day[{scenario.name}] t={day_s():.1f}s: phase "
                f"{sched.name!r} ({sched.qps:g} qps × {sched.duration_s:g}s, "
                f"{sched.read_frac:.0%} reads)"
            )
            phase_t0 = time.monotonic()
            runner.run_phase(sched, t0)
            phase_wall_s.append(time.monotonic() - phase_t0)
            snapshots.append(registry.render_json())
            cost_marks.append(_scrape_device_seconds(fleet, per_replica_cost))
            phase_rows.append(
                {
                    "name": sched.name,
                    "index": sched.index,
                    "start_s": sched.start_s,
                    "duration_s": sched.duration_s,
                    "qps": sched.qps,
                    "read_frac": sched.read_frac,
                    "p99_ms": sched.p99_ms,
                    "scheduled": len(sched),
                }
            )
        actions.join(timeout=60.0)
        # let the 1s evaluator observe the day's final state (an open
        # breaker fires within one tick) and flush its bundle writes
        time.sleep(2.5)

        cap = fleet_capacity(fleet)
        desired = autoscaler.desired_size(cap)
        evidence = {
            "scenario": scenario.name,
            "seed": effective_seed,
            "phases": phase_rows,
            "outcomes": runner.outcomes,
            "snapshots": snapshots,
            "costs": cost_marks,
            "injected": injected,
            "incident_dir": incident_dir,
            "incidents_after": day_wall_start - 1.0,
            "stall_windows": stall_windows,
            "autoscaler": {
                "desired": desired,
                "actual": len(fleet.routable()),
                "tolerance": int(scenario.slo.get("autoscaler_tolerance", 1)),
                "recommended_replicas": cap.get("recommended_replicas"),
            },
            "instances": {
                "known": sorted(known_instances),
                "new": flip_info.get("new"),
                "flip_completed_s": flip_info.get("flip_completed_s"),
            },
        }
        verdict = evaluate_day(evidence)
        if action_errors:
            verdict["pass"] = False
            verdict["clauses"].append(
                {
                    "clause": "actions_executed",
                    "passed": False,
                    "detail": f"{len(action_errors)} action(s) failed",
                    "evidence": {"errors": action_errors},
                }
            )
        report = {
            "scenario": scenario.to_dict(),
            "seed": effective_seed,
            "replicas": replicas,
            "incident_dir": incident_dir,
            "verdict": verdict,
            "device": device,
            "schedule_digest": digest,
            "replica_ready_s": {u: spawner.ready_s[u] for u in urls},
            "phase_wall_s": phase_wall_s,
            "actions_run": actions_run,
            "evidence": evidence,
        }
        if report_path:
            with open(report_path, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=2, default=str)
        out("")
        out(render_verdict(verdict))
        return (0 if verdict["pass"] else 1), report
    finally:
        faults.clear()
        try:
            alerts.stop()
        except Exception:
            pass
        if autoscaler is not None:
            try:
                autoscaler.stop()
            except Exception:
                pass
        if runner is not None:
            runner.close()
        if router is not None:
            router.shutdown()
        if fleet is not None:
            fleet.stop()
        event_server.shutdown()
        spawner.stop_all()
        try:
            storage.close()
        except Exception:
            pass
