"""The SLO verdict engine: did the fleet survive the scripted day?

Joins three evidence sources the production-day harness collects —

1. the traffic generator's own outcome log (one record per request:
   status, latency, replica/instance/variant headers, request id);
2. scraped fleet telemetry: router-side registry snapshots taken at
   every phase boundary, so per-phase quantiles come from histogram
   bucket *deltas* (:func:`~predictionio_tpu_torch.obs.metrics.subtract_snapshots`),
   never from a second histogram family;
3. the run's incident-bundle directory.

— into a machine-readable verdict: a list of clauses, each with
``passed`` and an ``evidence`` payload (metric family, bundle path, or
exemplar request id), plus a per-phase table.  The clause catalog:

- ``phase_p99_bounded`` — every phase with a ``p99_ms`` bound holds it,
  computed from ``pio_router_forward_seconds`` bucket deltas between the
  phase's boundary snapshots;
- ``exactly_once`` — every scheduled request has exactly one outcome and
  an HTTP answer (no transport losses, no duplicate request ids); reads
  must be 2xx; writes may shed 503 only when a storage stall was
  actually injected;
- ``flip_coherence`` — every answered read names a known
  ``X-Pio-Engine-Instance`` + a variant, and once the deploy flip
  completes, only the new generation answers;
- ``autoscaler_converged`` — the live replica count ends within
  ``tolerance`` of the capacity model's recommendation;
- ``fault_reconciliation`` — EXACTLY one incident bundle per injected
  fault, naming its rule; missing, duplicate, or spurious bundles fail
  the run;
- ``tenant_isolation`` (multi-tenant days only) — every flooded tenant
  is actually shed (quota engaged), every innocent neighbor holds its
  availability/p99, and zero answers cross a tenant boundary.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

from predictionio_tpu_torch.obs.metrics import quantile_from_buckets, subtract_snapshots

__all__ = ["evaluate_day", "render_verdict", "LATENCY_FAMILY"]

#: the router-side request-latency family per-phase p99s are cut from
LATENCY_FAMILY = "pio_router_forward_seconds"


def _phase_delta(
    snapshots: list[Mapping[str, Any]], i: int
) -> dict[str, Any] | None:
    if i + 1 >= len(snapshots):
        return None
    return subtract_snapshots(snapshots[i + 1], snapshots[i])


def _family_quantile(
    delta: Mapping[str, Any] | None, family: str, q: float
) -> tuple[float | None, int]:
    """Aggregate a histogram family's series (e.g. per-replica) by
    elementwise bucket sum, then cut the quantile; (value_s, count)."""
    if not delta:
        return None, 0
    fam = delta.get(family)
    if not isinstance(fam, Mapping) or fam.get("type") != "histogram":
        return None, 0
    bounds = list(fam.get("bounds", []))
    agg: list[int] = []
    total = 0
    for s in fam.get("series", ()):
        buckets = list(s.get("buckets", []))
        if len(buckets) > len(agg):
            agg += [0] * (len(buckets) - len(agg))
        for j, b in enumerate(buckets):
            agg[j] += b
        total += int(s.get("count", 0))
    if total == 0:
        return None, 0
    return quantile_from_buckets(bounds, agg, total, q), total


def _counter_total(delta: Mapping[str, Any] | None, family: str) -> float:
    if not delta:
        return 0.0
    fam = delta.get(family)
    if not isinstance(fam, Mapping) or fam.get("type") != "counter":
        return 0.0
    return float(sum(s.get("value", 0.0) for s in fam.get("series", ())))


def _list_bundles(incident_dir: str | None) -> list[dict[str, Any]]:
    """Every readable bundle in the run's incident directory, with its
    path attached (the evidence pointer the verdict carries)."""
    if not incident_dir or not os.path.isdir(incident_dir):
        return []
    out = []
    for name in sorted(os.listdir(incident_dir)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(incident_dir, name)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict):
            doc["_path"] = path
            out.append(doc)
    return out


def _pct(lats: list[float], q: float) -> float | None:
    if not lats:
        return None
    lats = sorted(lats)
    return lats[min(int(len(lats) * q), len(lats) - 1)]


def evaluate_day(evidence: Mapping[str, Any]) -> dict[str, Any]:
    """Evidence (all keys optional unless noted):

    - ``phases`` (required): ``[{name, index, start_s, duration_s, qps,
      read_frac, p99_ms, scheduled}]``;
    - ``outcomes`` (required): the generator's outcome log;
    - ``snapshots``: ``len(phases)+1`` registry ``render_json()`` dumps,
      one per phase boundary (router-side);
    - ``costs``: ``len(phases)+1`` per-boundary device-second totals
      (float, summed over replicas);
    - ``injected``: ``[{kind, at_s, rule}]`` — ``rule`` None means the
      injection must stay bundle-silent (a clean deploy);
    - ``incident_dir``: the run's bundle directory;
    - ``incidents_after``: wall-clock stamp; only bundles recorded at or
      after it count (stale bundles from an earlier run are spurious
      evidence, not this run's);
    - ``autoscaler``: ``{desired, actual, tolerance}``;
    - ``instances``: ``{known: [...], new, flip_completed_s}`` (offsets
      in day seconds);
    - ``stall_windows``: ``[[start_s, end_s], ...]`` write-shed amnesty
      windows (storage stalls actually injected);
    - ``tenants``: ``{rows: [{app, scheduled, answered, ok, quota_shed,
      leaked, availability, p99_ms, p99_bound_ms?}], flooded: [...],
      availability_floor}`` — presence enables the ``tenant_isolation``
      clause.
    """
    phases = list(evidence.get("phases", []))
    outcomes = list(evidence.get("outcomes", []))
    snapshots = list(evidence.get("snapshots", []))
    costs = list(evidence.get("costs", []))
    clauses: list[dict[str, Any]] = []

    by_phase: dict[int, list[dict]] = {}
    for o in outcomes:
        by_phase.setdefault(int(o.get("phase_index", -1)), []).append(o)

    # -- per-phase table (generator view + telemetry view + cost view) ------
    table = []
    for i, p in enumerate(phases):
        rows = by_phase.get(i, [])
        reads = [o for o in rows if o.get("kind") == "read"]
        writes = [o for o in rows if o.get("kind") == "write"]
        read_lat = [o["latency_ms"] for o in reads if o.get("status")]
        delta = _phase_delta(snapshots, i)
        tele_p99_s, tele_n = _family_quantile(delta, LATENCY_FAMILY, 0.99)
        tele_p50_s, _ = _family_quantile(delta, LATENCY_FAMILY, 0.50)
        forwards = _counter_total(delta, "pio_router_forwards_total")
        retries = _counter_total(delta, "pio_router_retry_elsewhere_total")
        shed = _counter_total(delta, "pio_shed_total")
        device_s = None
        if i + 1 < len(costs):
            device_s = round(max(costs[i + 1] - costs[i], 0.0), 6)
        table.append(
            {
                "name": p.get("name", f"phase{i}"),
                "qps": p.get("qps"),
                "read_frac": p.get("read_frac"),
                "scheduled": p.get("scheduled", len(rows)),
                "answered": sum(1 for o in rows if o.get("status") is not None),
                "errors": sum(
                    1
                    for o in rows
                    if o.get("status") is None or int(o.get("status") or 0) >= 400
                ),
                "p50_ms": round(_pct(read_lat, 0.50), 3) if read_lat else None,
                "p99_ms": round(_pct(read_lat, 0.99), 3) if read_lat else None,
                "telemetry_p50_ms": (
                    round(tele_p50_s * 1000, 3) if tele_p50_s is not None else None
                ),
                "telemetry_p99_ms": (
                    round(tele_p99_s * 1000, 3) if tele_p99_s is not None else None
                ),
                "telemetry_requests": tele_n,
                "shed": shed,
                "retry_elsewhere_rate": round(
                    retries / forwards, 6
                ) if forwards else 0.0,
                "device_s": device_s,
                "p99_bound_ms": p.get("p99_ms"),
            }
        )

    # -- clause: phase_p99_bounded ------------------------------------------
    violations = []
    checked = 0
    for i, p in enumerate(phases):
        bound = p.get("p99_ms")
        if bound is None:
            continue
        checked += 1
        row = table[i]
        # telemetry (bucket-delta) p99 is authoritative; the generator's
        # own log is the cross-check when no snapshot pair exists
        got = row["telemetry_p99_ms"]
        source = f"metric:{LATENCY_FAMILY} bucket delta"
        if got is None:
            got = row["p99_ms"]
            source = "outcome log (no boundary snapshots)"
        if got is None:
            violations.append(
                {"phase": row["name"], "bound_ms": bound, "p99_ms": None,
                 "source": "no latency evidence"}
            )
        elif got > bound:
            violations.append(
                {"phase": row["name"], "bound_ms": bound, "p99_ms": got,
                 "source": source}
            )
    clauses.append(
        {
            "clause": "phase_p99_bounded",
            "passed": not violations,
            "detail": (
                f"{checked} bounded phase(s), {len(violations)} violation(s)"
            ),
            "evidence": {
                "metric": LATENCY_FAMILY,
                "phases": [
                    {
                        "phase": t["name"],
                        "p99_ms": t["telemetry_p99_ms"],
                        "bound_ms": t["p99_bound_ms"],
                    }
                    for t in table
                ],
                "violations": violations,
            },
        }
    )

    # -- clause: exactly_once ------------------------------------------------
    scheduled_total = sum(int(p.get("scheduled", 0)) for p in phases)
    ids_seen: dict[str, int] = {}
    for o in outcomes:
        ids_seen[o["id"]] = ids_seen.get(o["id"], 0) + 1
    duplicates = [rid for rid, n in ids_seen.items() if n > 1]
    unanswered = [o["id"] for o in outcomes if o.get("status") is None]
    missing = scheduled_total - len(ids_seen)
    stall_windows = [tuple(w) for w in evidence.get("stall_windows", [])]

    def in_stall(o: dict) -> bool:
        t = float(o.get("start_s", -1.0))
        # generous tail: a write launched inside the window may be
        # answered (shed) after the stall lifts
        return any(w0 - 1.0 <= t <= w1 + 5.0 for w0, w1 in stall_windows)

    # a 503 stamped reason=tenant_quota from a tenant the scenario
    # deliberately flooded is the admission contract WORKING, not a lost
    # read — same spirit as the storage-stall write amnesty above
    flooded_apps = set((evidence.get("tenants") or {}).get("flooded", []))

    def excused_quota_shed(o: dict) -> bool:
        return (
            int(o["status"]) == 503
            and o.get("shed_reason") == "tenant_quota"
            and o.get("app") in flooded_apps
        )

    read_failures = [
        o["id"]
        for o in outcomes
        if o.get("kind") == "read"
        and o.get("status") is not None
        and not 200 <= int(o["status"]) < 300
        and not excused_quota_shed(o)
    ]
    write_failures = [
        o["id"]
        for o in outcomes
        if o.get("kind") == "write"
        and o.get("status") is not None
        and not 200 <= int(o["status"]) < 300
        and not (int(o["status"]) == 503 and in_stall(o))
    ]
    problems = {
        "missing_outcomes": missing,
        "duplicate_ids": duplicates[:5],
        "unanswered": unanswered[:5],
        "read_failures": read_failures[:5],
        "write_failures": write_failures[:5],
    }
    ok = (
        missing == 0
        and not duplicates
        and not unanswered
        and not read_failures
        and not write_failures
    )
    clauses.append(
        {
            "clause": "exactly_once",
            "passed": ok,
            "detail": (
                f"{scheduled_total} scheduled, {len(outcomes)} outcomes, "
                f"{len(unanswered)} unanswered, {len(duplicates)} duplicate "
                f"id(s), {len(read_failures)} failed read(s), "
                f"{len(write_failures)} unexcused failed write(s)"
            ),
            "evidence": problems,
        }
    )

    # -- clause: flip_coherence ---------------------------------------------
    inst_ev = evidence.get("instances") or {}
    known = set(inst_ev.get("known", []))
    new_inst = inst_ev.get("new")
    flip_done = inst_ev.get("flip_completed_s")
    incoherent = []
    stale_after_flip = []
    if known:
        for o in outcomes:
            if o.get("kind") != "read" or o.get("status") != 200:
                continue
            inst = o.get("instance")
            if inst not in known or not o.get("variant"):
                incoherent.append(o["id"])
            elif (
                flip_done is not None
                and new_inst is not None
                and float(o.get("start_s", 0.0)) > float(flip_done)
                and inst != new_inst
            ):
                stale_after_flip.append(o["id"])
    clauses.append(
        {
            "clause": "flip_coherence",
            "passed": not incoherent and not stale_after_flip,
            "detail": (
                f"{len(known)} known instance(s); "
                f"{len(incoherent)} answer(s) outside the known set or "
                f"variant-less, {len(stale_after_flip)} old-generation "
                f"answer(s) after the flip completed"
            ),
            "evidence": {
                "known_instances": sorted(known),
                "new_instance": new_inst,
                "flip_completed_s": flip_done,
                "exemplar_incoherent": incoherent[:5],
                "exemplar_stale_after_flip": stale_after_flip[:5],
            },
        }
    )

    # -- clause: autoscaler_converged ---------------------------------------
    auto = evidence.get("autoscaler") or {}
    desired = auto.get("desired")
    actual = auto.get("actual")
    tolerance = auto.get("tolerance", 1)
    if desired is None or actual is None:
        auto_ok = False
        auto_detail = "no autoscaler evidence (desired/actual missing)"
    else:
        auto_ok = abs(int(actual) - int(desired)) <= int(tolerance)
        auto_detail = (
            f"recommended {desired} replica(s), running {actual}, "
            f"tolerance ±{tolerance}"
        )
    clauses.append(
        {
            "clause": "autoscaler_converged",
            "passed": auto_ok,
            "detail": auto_detail,
            "evidence": dict(auto, metric="pio_autoscaler_desired_replicas"),
        }
    )

    # -- clause: fault_reconciliation ---------------------------------------
    injected = list(evidence.get("injected", []))
    bundles = _list_bundles(evidence.get("incident_dir"))
    after = evidence.get("incidents_after")
    if after is not None:
        # "now" is the bundle's capture stamp; "at" the alert's firing
        # stamp — either proves the bundle belongs to this run
        bundles = [
            b
            for b in bundles
            if float(b.get("now") or b.get("at") or 0.0) >= float(after)
        ]
    expected: dict[str, int] = {}
    for inj in injected:
        rule = inj.get("rule")
        if rule:
            expected[rule] = expected.get(rule, 0) + 1
    got: dict[str, list[str]] = {}
    for b in bundles:
        got.setdefault(str(b.get("rule")), []).append(b["_path"])
    missing_rules = {
        r: n - len(got.get(r, [])) for r, n in expected.items()
        if len(got.get(r, [])) < n
    }
    duplicate_rules = {
        r: got[r] for r, n in expected.items() if len(got.get(r, [])) > n
    }
    spurious = {r: paths for r, paths in got.items() if r not in expected}
    recon_ok = not missing_rules and not duplicate_rules and not spurious
    clauses.append(
        {
            "clause": "fault_reconciliation",
            "passed": recon_ok,
            "detail": (
                f"{sum(expected.values())} injected fault(s) expecting a "
                f"bundle, {len(bundles)} bundle(s) found; "
                f"missing={missing_rules or 'none'} "
                f"duplicate={sorted(duplicate_rules) or 'none'} "
                f"spurious={sorted(spurious) or 'none'}"
            ),
            "evidence": {
                "incident_dir": evidence.get("incident_dir"),
                "expected_rules": expected,
                "bundles": {r: paths for r, paths in got.items()},
                "missing": missing_rules,
                "duplicate": duplicate_rules,
                "spurious": spurious,
            },
        }
    )

    # -- clause: tenant_isolation -------------------------------------------
    # only evaluated for multi-tenant days (evidence carries a "tenants"
    # block built by the tenant-day harness); single-tenant days are
    # unaffected.  Containment means three things at once: the flooded
    # tenant IS shed (quota engaged, reason=tenant_quota), every innocent
    # neighbor keeps its availability/p99, and no answer ever crosses a
    # tenant boundary (X-Pio-App / engine-instance leakage).
    ten_ev = evidence.get("tenants")
    if ten_ev is not None:
        rows = list(ten_ev.get("rows", []))
        flooded = set(ten_ev.get("flooded", []))
        floor = float(ten_ev.get("availability_floor", 0.99))
        leaks = [
            {"app": r.get("app"), "leaked": r.get("leaked")}
            for r in rows
            if int(r.get("leaked", 0) or 0)
        ]
        unshed = [
            r.get("app")
            for r in rows
            if r.get("app") in flooded and not int(r.get("quota_shed", 0) or 0)
        ]
        starved = []
        for r in rows:
            if r.get("app") in flooded:
                continue
            avail = r.get("availability")
            if avail is None or float(avail) < floor:
                starved.append({"app": r.get("app"), "availability": avail})
            bound = r.get("p99_bound_ms")
            p99 = r.get("p99_ms")
            if bound is not None and p99 is not None and p99 > bound:
                starved.append(
                    {"app": r.get("app"), "p99_ms": p99, "bound_ms": bound}
                )
        ten_ok = not leaks and not unshed and not starved
        clauses.append(
            {
                "clause": "tenant_isolation",
                "passed": ten_ok,
                "detail": (
                    f"{len(rows)} tenant(s), {len(flooded)} flooded; "
                    f"leaks={len(leaks)}, quota-not-engaged={unshed or 'none'}, "
                    f"starved-neighbors={len(starved)}"
                ),
                "evidence": {
                    "metric": "pio_tenant_shed_total",
                    "availability_floor": floor,
                    "rows": rows,
                    "leaks": leaks,
                    "flooded_without_shed": unshed,
                    "starved": starved,
                },
            }
        )

    return {
        "pass": all(c["passed"] for c in clauses),
        "scenario": evidence.get("scenario"),
        "seed": evidence.get("seed"),
        "clauses": clauses,
        "phases": table,
        "requests": {
            "scheduled": scheduled_total,
            "answered": sum(1 for o in outcomes if o.get("status") is not None),
        },
    }


def render_verdict(verdict: Mapping[str, Any]) -> str:
    """The human-readable phase table + clause lines ``pio day`` prints."""
    lines = []
    cols = (
        ("phase", 14), ("qps", 6), ("sched", 6), ("ans", 6), ("err", 5),
        ("p50ms", 8), ("p99ms", 8), ("bound", 7), ("shed", 6),
        ("retry%", 7), ("dev_s", 8),
    )
    lines.append(" ".join(f"{name:>{w}}" for name, w in cols))

    def fmt(v, w):
        if v is None:
            return " " * (w - 1) + "-"
        if isinstance(v, float):
            return f"{v:>{w}.2f}"
        return f"{v!s:>{w}}"

    for t in verdict.get("phases", []):
        p99 = t.get("telemetry_p99_ms")
        p50 = t.get("telemetry_p50_ms")
        if p99 is None:
            p99 = t.get("p99_ms")
        if p50 is None:
            p50 = t.get("p50_ms")
        row = (
            t.get("name"), t.get("qps"), t.get("scheduled"), t.get("answered"),
            t.get("errors"), p50, p99, t.get("p99_bound_ms"), t.get("shed"),
            (t.get("retry_elsewhere_rate") or 0.0) * 100, t.get("device_s"),
        )
        lines.append(" ".join(fmt(v, w) for v, (_, w) in zip(row, cols)))
    lines.append("")
    for c in verdict.get("clauses", []):
        mark = "PASS" if c["passed"] else "FAIL"
        lines.append(f"[{mark}] {c['clause']}: {c['detail']}")
        if not c["passed"]:
            lines.append(f"       evidence: {json.dumps(c['evidence'], default=str)}")
    lines.append("")
    lines.append(
        f"VERDICT: {'PASS' if verdict.get('pass') else 'FAIL'}"
    )
    return "\n".join(lines)
