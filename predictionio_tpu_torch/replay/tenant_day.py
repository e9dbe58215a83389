"""The two-tenant production day: noisy-neighbor containment, in-process.

``run_tenant_day`` stands up ONE multi-tenant replica (two resident
tenants over deterministic stub engines, the flooded one armed with a
real admission token bucket), drives Zipf-distributed query traffic on
both tenants at once while the scripted ``quota_flood`` overruns one
tenant's quota by ``flood_factor``×, and watches the run with the real
alert evaluator + incident recorder — the ``tenant_quota_shed_rate``
alert must fire, bundle, and name the offending tenant.  Evidence lands
in :func:`predictionio_tpu_torch.obs.verdict.evaluate_day`, whose
``tenant_isolation`` clause holds three things at once:

1. the flooded tenant IS shed (503 + ``X-Pio-Shed-Reason:
   tenant_quota``) — the quota engaged;
2. the innocent neighbor keeps its availability (and p99 bound, when
   set) — no starvation by a neighbor's flood;
3. zero cross-tenant leakage — every answer's ``X-Pio-App`` names the
   asking tenant and its ``X-Pio-Engine-Instance`` stays inside that
   tenant's instance set.

Everything is in-process (stub engines, no storage, no training): the
tenant day never touches the choice of CPU or card, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

__all__ = ["run_tenant_day", "build_stub_tenant"]


def build_stub_tenant(
    name: str,
    *,
    quota_rps: float | None = None,
    quota_burst: float | None = None,
    predict_sleep_s: float = 0.0,
):
    """A resident :class:`~predictionio_tpu_torch.tenancy.Tenant` over a
    deterministic echo engine (no storage, no card) — the fixture the
    tenant day and the isolation tests share.  The engine instance id is
    ``inst-<name>`` so leakage checks can pin answers to tenants."""
    import types

    import torch

    from predictionio_tpu_torch.core.base import Algorithm, FirstServing
    from predictionio_tpu_torch.server.prediction_server import DeployedEngine
    from predictionio_tpu_torch.tenancy import Tenant, TokenBucket

    class EchoAlgo(Algorithm):
        def train(self, ctx, pd):
            return None

        def predict(self, model, q):
            if predict_sleep_s:
                time.sleep(predict_sleep_s)
            return {"user": q.get("user"), "servedBy": name}

        def batch_predict(self, model, iq):
            return [(i, self.predict(model, q)) for i, q in iq]

    deployed = DeployedEngine.__new__(DeployedEngine)
    deployed._lock = threading.RLock()
    deployed.instance = types.SimpleNamespace(id=f"inst-{name}")
    deployed.storage = None
    deployed.algorithms = [EchoAlgo()]
    deployed.models = [None]
    deployed.serving = FirstServing()
    deployed.extract_query = lambda payload: dict(payload)
    # what the port's DeployedEngine sets in __init__ and the multi-tenant
    # path reads: the live params, the in-flight accounting, an empty
    # canary slot, and a context whose device is the host (the echo engine
    # computes nothing; no device is resolved, so no card is asked for)
    deployed.params = None
    deployed._drain_cond = threading.Condition()
    deployed._inflight = {}
    deployed._canary_binding = None
    deployed._canary_fraction = 0.0
    deployed.ctx = types.SimpleNamespace(device=torch.device("cpu"))
    quota = (
        TokenBucket(quota_rps, quota_burst) if quota_rps is not None else None
    )
    return Tenant(name, deployed, quota=quota, hbm_bytes=0)


def run_tenant_day(
    *,
    duration_s: float = 5.0,
    neighbor_qps: float = 25.0,
    quota_rps: float = 4.0,
    flood_factor: float = 10.0,
    seed: int = 0,
    num_entities: int = 50,
    zipf_exponent: float = 1.1,
    alert_for_s: float = 1.5,
    availability_floor: float = 0.99,
    p99_bound_ms: float | None = None,
    incident_dir: str | None = None,
    report_path: str | None = None,
    out: Callable[[str], None] = print,
) -> tuple[int, dict[str, Any]]:
    """Run the scripted two-tenant flood; ``(exit_code, report)`` — 0 when
    the verdict (tenant_isolation included) passes.  The report carries the
    ``evidence`` beside the verdict.

    Tenant ``alpha`` is the innocent neighbor at ``neighbor_qps`` with no
    quota; tenant ``beta`` carries a ``quota_rps`` token bucket and is
    flooded at ``flood_factor × quota_rps`` for the whole day.
    ``alert_for_s`` rescales the pack rule's sustain window so short test
    days still exercise the full alert → incident-bundle path."""
    import numpy as np

    from predictionio_tpu_torch.obs.alerts import AlertEvaluator, default_rule_pack
    from predictionio_tpu_torch.obs.incident import IncidentRecorder
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.obs.verdict import evaluate_day, render_verdict
    from predictionio_tpu_torch.replay.workload import zipf_entities
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.prediction_server import (
        create_multi_tenant_server_app,
    )
    from predictionio_tpu_torch.tenancy import TenantRegistry

    registry = MetricsRegistry()
    tenants = TenantRegistry(registry=registry)
    alpha = build_stub_tenant("alpha")
    beta = build_stub_tenant(
        "beta", quota_rps=quota_rps, quota_burst=max(quota_rps, 2.0)
    )
    tenants.admit(alpha)
    tenants.admit(beta)
    instance_of = {t.name: t.deployed.instance.id for t in tenants}

    if incident_dir is None:
        incident_dir = tempfile.mkdtemp(prefix="pio-tenant-day-")
    incidents = IncidentRecorder(directory=incident_dir, registry=registry)
    flood_rule = next(
        r for r in default_rule_pack() if r.name == "tenant_quota_shed_rate"
    )
    flood_rule = dataclasses.replace(flood_rule, for_s=float(alert_for_s))
    alerts = AlertEvaluator(
        registry=registry,
        rules=[flood_rule],
        incidents=incidents,
        interval_s=0.25,
    )

    app = create_multi_tenant_server_app(tenants, use_microbatch=True)
    server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{server.port}/queries.json"
    run_tag = uuid.uuid4().hex[:8]
    wall_start = time.time()
    outcomes: list[dict[str, Any]] = []
    olock = threading.Lock()

    def _one(app_name: str, idx: int, entity: int, t0: float, at_s: float):
        target = t0 + at_s
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        rid = f"{run_tag}-{app_name}-{idx}"
        req = urllib.request.Request(
            base,
            data=b'{"user": "u%d"}' % entity,
            headers={
                "Content-Type": "application/json",
                "X-Pio-App": app_name,
                "X-Request-Id": rid,
            },
            method="POST",
        )
        start = time.monotonic()
        status, headers = None, {}
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                status, headers = r.status, dict(r.headers)
                r.read()
        except urllib.error.HTTPError as e:
            status, headers = e.code, dict(e.headers)
            e.read()
        except Exception:
            pass
        rec = {
            "id": rid,
            "app": app_name,
            "kind": "read",
            "phase_index": 0,
            "start_s": at_s,
            "status": status,
            "latency_ms": (time.monotonic() - start) * 1000.0,
            "instance": headers.get("X-Pio-Engine-Instance"),
            "variant": headers.get("X-Pio-Variant"),
            "resp_app": headers.get("X-Pio-App"),
            "shed_reason": headers.get("X-Pio-Shed-Reason"),
        }
        with olock:
            outcomes.append(rec)

    rng = np.random.default_rng(seed)
    flood_qps = flood_factor * quota_rps
    plan: list[tuple[str, int, int, float]] = []
    for app_name, qps in (("alpha", neighbor_qps), ("beta", flood_qps)):
        n = max(int(qps * duration_s), 1)
        ents = zipf_entities(rng, n, num_entities, zipf_exponent, 0)
        for i in range(n):
            plan.append((app_name, i, int(ents[i]), i / qps))
    plan.sort(key=lambda r: r[3])

    verdict: dict[str, Any] = {}
    try:
        alerts.start()
        out(
            f"tenant-day[{run_tag}]: alpha @ {neighbor_qps:g} qps, "
            f"beta flooded @ {flood_qps:g} qps over a {quota_rps:g} rps "
            f"quota, {duration_s:g}s"
        )
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=32) as pool:
            futs = [
                pool.submit(_one, a, i, e, t0, at) for a, i, e, at in plan
            ]
            for f in futs:
                f.result()
        # one more evaluator window so the sustained flood crosses
        # for_s, fires, and the bundle write flushes
        time.sleep(alert_for_s + 1.0)
    finally:
        try:
            alerts.stop()
        except Exception:
            pass
        server.shutdown()

    rows = []
    for app_name in ("alpha", "beta"):
        mine = [o for o in outcomes if o["app"] == app_name]
        answered = [o for o in mine if o["status"] is not None]
        ok = [o for o in answered if 200 <= int(o["status"]) < 300]
        quota_shed = [
            o
            for o in answered
            if int(o["status"]) == 503 and o.get("shed_reason") == "tenant_quota"
        ]
        leaked = [
            o
            for o in ok
            if (o.get("resp_app") not in (None, app_name))
            or (
                o.get("instance") is not None
                and o["instance"] != instance_of[app_name]
            )
        ]
        lats = sorted(o["latency_ms"] for o in ok)
        p99 = lats[min(int(len(lats) * 0.99), len(lats) - 1)] if lats else None
        denom = max(len(answered) - len(quota_shed), 1)
        rows.append(
            {
                "app": app_name,
                "scheduled": len(mine),
                "answered": len(answered),
                "ok": len(ok),
                "quota_shed": len(quota_shed),
                "leaked": len(leaked),
                "availability": round(len(ok) / denom, 6),
                "p99_ms": round(p99, 3) if p99 is not None else None,
                "p99_bound_ms": p99_bound_ms,
            }
        )

    evidence = {
        "scenario": "tenant-day",
        "seed": seed,
        "phases": [
            {
                "name": "flood",
                "index": 0,
                "start_s": 0.0,
                "duration_s": duration_s,
                "qps": neighbor_qps + flood_qps,
                "read_frac": 1.0,
                "scheduled": len(plan),
            }
        ],
        "outcomes": outcomes,
        "snapshots": [],
        "costs": [],
        "injected": [
            {"kind": "quota_flood", "at_s": 0.0,
             "rule": "tenant_quota_shed_rate", "tenant": "beta"}
        ],
        "incident_dir": incident_dir,
        "incidents_after": wall_start - 1.0,
        # one in-process replica, statically sized — present so the
        # clause doesn't read absence as failure
        "autoscaler": {"desired": 1, "actual": 1, "tolerance": 0},
        "instances": {"known": sorted(instance_of.values())},
        "tenants": {
            "rows": rows,
            "flooded": ["beta"],
            "availability_floor": availability_floor,
        },
    }
    verdict = evaluate_day(evidence)
    report = {
        "run": run_tag,
        "incident_dir": incident_dir,
        "tenants": rows,
        "verdict": verdict,
        # the port's addition: what the verdict was cut from
        "evidence": evidence,
    }
    if report_path:
        import json as _json

        with open(report_path, "w", encoding="utf-8") as f:
            _json.dump(report, f, indent=2, default=str)
    out("")
    out(render_verdict(verdict))
    return (0 if verdict["pass"] else 1), report
