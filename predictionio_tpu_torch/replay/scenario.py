"""The declarative scripted-day format.

A scenario is JSON (inline on the command line or ``@path``): ordered
**phases** (qps, read/write mix, duration, optional p99 bound, optional
entity-offset for a query-distribution shift) plus timed **actions**
(replica SIGKILL, mid-peak deploy flip, storage stall via the existing
fault-plan machinery).  Validation names the offending field —
``pio day`` exits 2 with exactly that message, so a malformed scenario
never half-runs a production day.

The schedule built from a scenario is deterministic in (scenario, seed):
see :func:`predictionio_tpu_torch.replay.workload.schedule_digest`.
Every validation error names the same field with the same message as the
JAX package's ``replay/scenario.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Mapping

from predictionio_tpu_torch.replay.workload import PhaseSchedule, build_phase_schedule

__all__ = ["Scenario", "ScenarioPhase", "ScenarioAction", "ScenarioError", "ACTION_KINDS"]

#: every action kind the day harness knows how to execute; "kill_replica"
#: SIGKILLs a spawned replica mid-traffic, "canary_flip" deploys a new
#: engine generation and hot-swaps every replica onto it, "storage_stall"
#: arms a latency fault plan on the event-store write seam for a bounded
#: window (and disarms it after), "quota_flood" drives one named tenant at
#: a multiple of its admission quota so the day proves noisy-neighbor
#: containment
ACTION_KINDS = frozenset(
    {"kill_replica", "canary_flip", "storage_stall", "quota_flood"}
)

#: the incident-bundle rule each injected action must reconcile against —
#: the verdict engine demands EXACTLY one bundle per injection
ACTION_EXPECTED_RULE = {
    "kill_replica": "breaker_open",
    "storage_stall": "ingest_shed",
    "quota_flood": "tenant_quota_shed_rate",
    # canary_flip is a clean deploy: it must NOT produce a bundle
}


class ScenarioError(ValueError):
    """A malformed scenario; ``field`` names the offending field (e.g.
    ``phases[1].qps``) so the exit-2 message is actionable."""

    def __init__(self, field_name: str, message: str):
        self.field = field_name
        super().__init__(f"{field_name}: {message}")


def _num(d: Mapping, key: str, where: str, default=None, required=False):
    v = d.get(key, default)
    if v is None:
        if required:
            raise ScenarioError(f"{where}.{key}", "required field is missing")
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ScenarioError(f"{where}.{key}", f"must be a number, got {v!r}")
    return float(v)


@dataclass(frozen=True)
class ScenarioPhase:
    name: str
    duration_s: float
    qps: float
    read_frac: float = 1.0
    start_s: float | None = None  # resolved: explicit or cumulative
    p99_ms: float | None = None
    entity_offset: int = 0


@dataclass(frozen=True)
class ScenarioAction:
    at_s: float
    kind: str
    params: dict[str, Any] = field(default_factory=dict)

    @property
    def expected_rule(self) -> str | None:
        return self.params.get("expect_rule", ACTION_EXPECTED_RULE.get(self.kind))


@dataclass(frozen=True)
class Scenario:
    name: str
    phases: tuple[ScenarioPhase, ...]
    actions: tuple[ScenarioAction, ...] = ()
    seed: int = 0
    num_entities: int = 1_000_000
    num_items: int = 100
    zipf_exponent: float = 1.1
    query_num: int = 4
    max_inflight: int = 64
    ingest_max_inflight: int | None = None
    slo: dict[str, Any] = field(default_factory=dict)
    #: multi-tenant days: ``[{name, quota_rps?, quota_burst?, weight?}]``
    #: — each entry becomes a resident tenant; ``weight`` splits the
    #: phase qps across tenants, ``quota_rps`` arms the tenant's
    #: admission token bucket so a ``quota_flood`` action has a ceiling
    #: to overrun
    tenants: tuple[dict[str, Any], ...] = ()

    # -- loading -------------------------------------------------------------

    @classmethod
    def load_arg(cls, arg: str) -> "Scenario":
        """Inline JSON or ``@path`` — the CLI's ``--scenario`` value."""
        raw = arg
        if arg.startswith("@"):
            with open(arg[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        try:
            doc = json.loads(raw)
        except ValueError as e:
            raise ScenarioError("scenario", f"not valid JSON: {e}") from None
        return cls.from_dict(doc)

    @classmethod
    def from_dict(cls, doc: Any) -> "Scenario":
        if not isinstance(doc, Mapping):
            raise ScenarioError("scenario", "must be a JSON object")
        phases_doc = doc.get("phases")
        if not isinstance(phases_doc, list) or not phases_doc:
            raise ScenarioError("phases", "must be a non-empty array")
        phases: list[ScenarioPhase] = []
        cursor = 0.0
        for i, p in enumerate(phases_doc):
            where = f"phases[{i}]"
            if not isinstance(p, Mapping):
                raise ScenarioError(where, "must be a JSON object")
            duration = _num(p, "duration_s", where, required=True)
            if duration <= 0:
                raise ScenarioError(f"{where}.duration_s", "must be > 0")
            qps = _num(p, "qps", where, required=True)
            if qps < 0:
                raise ScenarioError(f"{where}.qps", f"must be >= 0, got {qps}")
            read_frac = _num(p, "read_frac", where, default=1.0)
            if not 0.0 <= read_frac <= 1.0:
                raise ScenarioError(
                    f"{where}.read_frac", f"must be in [0, 1], got {read_frac}"
                )
            start = _num(p, "start_s", where)
            if start is None:
                start = cursor
            elif start < cursor - 1e-9:
                raise ScenarioError(
                    f"{where}.start_s",
                    f"overlaps the previous phase (starts at {start}s, "
                    f"previous phase ends at {cursor}s)",
                )
            p99 = _num(p, "p99_ms", where)
            phases.append(
                ScenarioPhase(
                    name=str(p.get("name", f"phase{i}")),
                    duration_s=duration,
                    qps=qps,
                    read_frac=read_frac,
                    start_s=start,
                    p99_ms=p99,
                    entity_offset=int(p.get("entity_offset", 0)),
                )
            )
            cursor = start + duration
        actions: list[ScenarioAction] = []
        for i, a in enumerate(doc.get("actions", []) or []):
            where = f"actions[{i}]"
            if not isinstance(a, Mapping):
                raise ScenarioError(where, "must be a JSON object")
            kind = a.get("kind")
            if kind not in ACTION_KINDS:
                raise ScenarioError(
                    f"{where}.kind",
                    f"unknown action {kind!r}; have {sorted(ACTION_KINDS)}",
                )
            at_s = _num(a, "at_s", where, required=True)
            if at_s < 0 or at_s > cursor:
                raise ScenarioError(
                    f"{where}.at_s",
                    f"must fall inside the day [0, {cursor}s], got {at_s}",
                )
            params = {
                k: v for k, v in a.items() if k not in ("kind", "at_s")
            }
            actions.append(ScenarioAction(at_s=at_s, kind=str(kind), params=params))
        actions.sort(key=lambda a: a.at_s)
        slo = doc.get("slo", {})
        if slo and not isinstance(slo, Mapping):
            raise ScenarioError("slo", "must be a JSON object")
        tenants_doc = doc.get("tenants", []) or []
        if not isinstance(tenants_doc, list):
            raise ScenarioError("tenants", "must be an array")
        tenants: list[dict[str, Any]] = []
        seen_names: set[str] = set()
        for i, t in enumerate(tenants_doc):
            where = f"tenants[{i}]"
            if not isinstance(t, Mapping):
                raise ScenarioError(where, "must be a JSON object")
            name = t.get("name")
            if not name or not isinstance(name, str):
                raise ScenarioError(f"{where}.name", "required string")
            if name in seen_names:
                raise ScenarioError(f"{where}.name", f"duplicate tenant {name!r}")
            seen_names.add(name)
            quota = _num(t, "quota_rps", where)
            if quota is not None and quota <= 0:
                raise ScenarioError(f"{where}.quota_rps", "must be > 0")
            burst = _num(t, "quota_burst", where)
            weight = _num(t, "weight", where, default=1.0)
            if weight <= 0:
                raise ScenarioError(f"{where}.weight", "must be > 0")
            tenants.append(
                {
                    "name": name,
                    "quota_rps": quota,
                    "quota_burst": burst,
                    "weight": weight,
                }
            )
        for i, a in enumerate(actions):
            if a.kind == "quota_flood":
                target = a.params.get("tenant")
                if not target or target not in seen_names:
                    raise ScenarioError(
                        f"actions[{i}].tenant",
                        f"quota_flood must name a declared tenant, "
                        f"got {target!r}; have {sorted(seen_names)}",
                    )
        ingest_max = doc.get("ingest_max_inflight")
        return cls(
            name=str(doc.get("name", "day")),
            phases=tuple(phases),
            actions=tuple(actions),
            seed=int(doc.get("seed", 0)),
            num_entities=int(doc.get("num_entities", 1_000_000)),
            num_items=int(doc.get("num_items", 100)),
            zipf_exponent=float(doc.get("zipf_exponent", 1.1)),
            query_num=int(doc.get("query_num", 4)),
            max_inflight=int(doc.get("max_inflight", 64)),
            ingest_max_inflight=None if ingest_max is None else int(ingest_max),
            slo=dict(slo),
            tenants=tuple(tenants),
        )

    # -- derived -------------------------------------------------------------

    @property
    def total_duration_s(self) -> float:
        last = self.phases[-1]
        return float((last.start_s or 0.0) + last.duration_s)

    def build_schedules(self, seed: int | None = None) -> list[PhaseSchedule]:
        """Materialize every phase; ``seed`` overrides the scenario's own
        (the CLI's ``--seed``)."""
        s = self.seed if seed is None else int(seed)
        return [
            build_phase_schedule(
                name=p.name,
                index=i,
                start_s=float(p.start_s or 0.0),
                duration_s=p.duration_s,
                qps=p.qps,
                read_frac=p.read_frac,
                num_entities=self.num_entities,
                zipf_exponent=self.zipf_exponent,
                entity_offset=p.entity_offset,
                p99_ms=p.p99_ms,
                seed=s,
            )
            for i, p in enumerate(self.phases)
        ]

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "seed": self.seed,
            "num_entities": self.num_entities,
            "zipf_exponent": self.zipf_exponent,
            "total_duration_s": self.total_duration_s,
            "phases": [
                {
                    "name": p.name,
                    "start_s": p.start_s,
                    "duration_s": p.duration_s,
                    "qps": p.qps,
                    "read_frac": p.read_frac,
                    "p99_ms": p.p99_ms,
                    "entity_offset": p.entity_offset,
                }
                for p in self.phases
            ],
            "actions": [
                {"at_s": a.at_s, "kind": a.kind, **a.params} for a in self.actions
            ],
            "slo": dict(self.slo),
            "tenants": [dict(t) for t in self.tenants],
        }
