"""TenantRegistry: engine → (generations, quality, SLO, quota, cost meters).

A replica hosts a *set* of :class:`Tenant`\\ s instead of one engine.  The
registry is the single authority for:

- **Residency** (device-memory bin-packing): ``admit`` sums the candidate
  generation's stored-blob bytes (``hbm_footprint`` — the manifest parts
  ARE what ``prepare_deploy`` materializes into HBM) against the remaining
  budget and refuses loudly with :class:`TenantAdmissionError` naming the
  shortfall.  A refusal leaves every resident tenant serving; nothing is
  evicted, nothing OOMs.
- **Per-request gating** (``gate``, called from the shared front-end
  choke point ``httpd.admit_request`` so BOTH front ends enforce it):
  resolve the request's tenant (``X-Pio-App`` header, ``?app=`` query,
  or access-key map), spend its quota token bucket (shed 503 +
  Retry-After, ``reason=tenant_quota``), and take its in-flight slot
  (shed ``reason=tenant_inflight``) — all before the MicroBatcher sees
  the query, so a flooding tenant cannot occupy wave slots.
- **Scoped state**: each tenant owns its QualityMonitor, SLOTracker,
  deadline default, and cost identity; tenant A's drift, sheds, breaker
  opens, and SLO burn are invisible to tenant B's surfaces.

``/tenants.json`` (and ``tenants --url`` of the port's CLI) render
:meth:`TenantRegistry.snapshot`.  Admission keeps the JAX package's proxy,
the stored bytes of a generation; on a card the snapshot also records what
``torch.cuda.mem_get_info`` and the caching allocator report
(``device_memory``), beside the proxy and never in its place.
"""

from __future__ import annotations

import threading
from typing import Any, Iterator, Mapping

from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.slo import SLOTracker
from predictionio_tpu_torch.tenancy.quota import TokenBucket

#: request/response header naming the tenant (app) a query belongs to —
#: the router forwards it, replicas stamp it on every answer, and the
#: tests assert it never names another tenant
APP_HEADER = "X-Pio-App"


class TenantAdmissionError(Exception):
    """Residency refused: the candidate's HBM footprint does not fit.

    Structured so the refusal names its shortfall — operators (and the
    CLI) see exactly how many bytes are missing, not a bare OOM later.
    """

    def __init__(
        self,
        app: str,
        required_bytes: int,
        free_bytes: int,
        budget_bytes: int,
        resident: tuple[str, ...] = (),
    ):
        self.app = app
        self.required_bytes = int(required_bytes)
        self.free_bytes = int(free_bytes)
        self.budget_bytes = int(budget_bytes)
        self.shortfall_bytes = max(self.required_bytes - self.free_bytes, 0)
        self.resident = tuple(resident)
        super().__init__(
            f"tenant {app!r} refused residency: needs "
            f"{self.required_bytes} HBM bytes but only {self.free_bytes} of "
            f"{self.budget_bytes} remain (short {self.shortfall_bytes} "
            f"bytes; resident: {', '.join(resident) or 'none'})"
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "error": "tenant_admission_refused",
            "app": self.app,
            "required_bytes": self.required_bytes,
            "free_bytes": self.free_bytes,
            "budget_bytes": self.budget_bytes,
            "shortfall_bytes": self.shortfall_bytes,
            "resident": list(self.resident),
        }


def hbm_footprint(models_store: Any, instance_id: str) -> int:
    """Device-memory footprint of one generation, in bytes: the sum of its
    stored model blobs (manifest + every named part, or the legacy single
    blob).  The stored pytree bytes ARE what ``load_persistent_model``
    re-materializes into device arrays, so stored size is the honest
    admission-time proxy for HBM residency — available BEFORE any device
    allocation happens."""
    if models_store is None:
        return 0
    from predictionio_tpu_torch.data.storage.base import _manifest_part_names

    try:
        raw = models_store.get(f"{instance_id}:manifest")
    except Exception:
        raw = None
    if raw is not None:
        total = len(raw)
        for name in _manifest_part_names(raw):
            part = models_store.get_part(instance_id, name)
            if part is not None:
                total += len(part)
        return total
    blob = models_store.get(instance_id)
    return len(blob) if blob is not None else 0


class Tenant:
    """One resident app: its engine plus every piece of per-tenant state.

    ``deployed`` is a :class:`~predictionio_tpu_torch.server.prediction_server.
    DeployedEngine`; ``quality``/``slo`` are THIS tenant's monitors (never
    shared: sharing would leak one tenant's state into another's).  ``quota`` and ``max_inflight`` bound what the tenant may
    consume; ``None`` means uncapped (the single-tenant default).
    """

    def __init__(
        self,
        name: str,
        deployed: Any,
        quality: Any = None,
        slo: SLOTracker | None = None,
        quota: TokenBucket | None = None,
        max_inflight: int | None = None,
        default_deadline_s: float | None = None,
        hbm_bytes: int | None = None,
        access_key: str | None = None,
        cost_name: str | None = None,
    ):
        self.name = name
        self.deployed = deployed
        self.quality = quality
        self.slo = slo if slo is not None else SLOTracker()
        self.quota = quota
        self.max_inflight = max_inflight
        self.default_deadline_s = default_deadline_s
        self.access_key = access_key
        self.cost_name = cost_name or name
        if hbm_bytes is None:
            store = getattr(
                getattr(deployed, "storage", None), "models", None
            )
            instance = getattr(deployed, "instance", None)
            hbm_bytes = (
                hbm_footprint(store(), instance.id)
                if store is not None and instance is not None
                else 0
            )
        self.hbm_bytes = int(hbm_bytes)
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- per-tenant in-flight cap -------------------------------------------

    def try_acquire_slot(self) -> bool:
        if self.max_inflight is None:
            return True
        with self._inflight_lock:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            return True

    def release_slot(self) -> None:
        if self.max_inflight is None:
            return
        with self._inflight_lock:
            self._inflight = max(self._inflight - 1, 0)

    @property
    def inflight(self) -> int:
        return self._inflight

    # -- scoped health --------------------------------------------------------

    def degraded_reasons(self) -> list[str]:
        """THIS tenant's dependency health: its storage runtime's open
        breakers (tenant A's storage daemon dying degrades only A) and a
        drifting quality monitor."""
        reasons: list[str] = []
        storage = getattr(self.deployed, "storage", None)
        if storage is not None and hasattr(storage, "breakers"):
            try:
                for br in storage.breakers():
                    if br.state == "open":
                        reasons.append(f"breaker_open:{br.name}")
            except Exception:
                pass
        if self.quality is not None:
            try:
                state = self.quality.drift_state()
                if state != "ok":
                    reasons.append(f"drift:{state}")
            except Exception:
                pass
        return reasons

    def snapshot(self) -> dict[str, Any]:
        instance = getattr(self.deployed, "instance", None)
        slo = self.slo.snapshot()
        return {
            "app": self.name,
            "engineInstanceId": getattr(instance, "id", None),
            "variant": getattr(self.deployed, "variant_label", "default"),
            "hbm_bytes": self.hbm_bytes,
            "inflight": self._inflight,
            "max_inflight": self.max_inflight,
            "default_deadline_s": self.default_deadline_s,
            "quota": self.quota.snapshot() if self.quota else None,
            "slo": {
                "status": slo.get("status"),
                "availability": slo.get("availability"),
                "error_burn_rate": slo.get("error_burn_rate"),
                "latency_burn_rate": slo.get("latency_burn_rate"),
                "requests": slo.get("requests"),
            },
            "degraded": self.degraded_reasons(),
        }


class _TenantRelease:
    """Composite releaser handed back by ``gate``: releases the tenant's
    in-flight slot exactly once (the front ends call ``release()`` in a
    finally, same contract as the AdmissionController)."""

    __slots__ = ("_tenant", "_released")

    def __init__(self, tenant: Tenant):
        self._tenant = tenant
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._tenant.release_slot()


class TenantRegistry:
    """The set of resident tenants plus the device-memory bin-packer."""

    def __init__(
        self,
        hbm_budget_bytes: int | None = None,
        registry: MetricsRegistry | None = None,
        default_app: str | None = None,
    ):
        self.hbm_budget_bytes = (
            int(hbm_budget_bytes) if hbm_budget_bytes is not None else None
        )
        self._reg = registry or REGISTRY
        self._lock = threading.Lock()
        self._tenants: dict[str, Tenant] = {}
        self._by_key: dict[str, str] = {}
        self._default_app = default_app
        self._m_resident = self._reg.gauge(
            "pio_tenant_resident_hbm_bytes",
            "Stored-model HBM footprint of each resident tenant",
            labelnames=("app",),
        )
        self._m_util = self._reg.gauge(
            "pio_tenant_hbm_utilization",
            "Fraction of the replica's HBM budget a tenant occupies",
            labelnames=("app",),
        )
        self._m_shed = self._reg.counter(
            "pio_tenant_shed_total",
            "Requests shed at the per-tenant admission gate, by app/reason",
            labelnames=("app", "reason"),
        )
        self._m_refused = self._reg.counter(
            "pio_tenant_hbm_refused_total",
            "Tenant residency admissions refused by the HBM bin-packer",
            labelnames=("app",),
        )

    # -- residency (bin-packing) ---------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(t.hbm_bytes for t in self._tenants.values())

    def admit(self, tenant: Tenant) -> Tenant:
        """Bin-pack ``tenant`` into the remaining HBM budget or refuse.

        Raises :class:`TenantAdmissionError` (refusal is loud and
        structured) and touches NOTHING on refusal: resident tenants keep
        serving on their already-materialized generations."""
        with self._lock:
            if tenant.name in self._tenants:
                raise ValueError(f"tenant {tenant.name!r} already resident")
            if self.hbm_budget_bytes is not None:
                used = sum(t.hbm_bytes for t in self._tenants.values())
                free = self.hbm_budget_bytes - used
                if tenant.hbm_bytes > free:
                    self._m_refused.labels(tenant.name).inc()
                    raise TenantAdmissionError(
                        tenant.name,
                        tenant.hbm_bytes,
                        free,
                        self.hbm_budget_bytes,
                        resident=tuple(self._tenants),
                    )
            self._tenants[tenant.name] = tenant
            if tenant.access_key:
                self._by_key[tenant.access_key] = tenant.name
            if self._default_app is None:
                self._default_app = tenant.name
            self._export_gauges_locked()
        return tenant

    def evict(self, app: str) -> Tenant | None:
        with self._lock:
            tenant = self._tenants.pop(app, None)
            if tenant is not None and tenant.access_key:
                self._by_key.pop(tenant.access_key, None)
            if tenant is not None:
                self._m_resident.labels(app).set(0)
                self._m_util.labels(app).set(0.0)
                self._export_gauges_locked()
            return tenant

    def _export_gauges_locked(self) -> None:
        budget = self.hbm_budget_bytes
        for name, t in self._tenants.items():
            self._m_resident.labels(name).set(t.hbm_bytes)
            if budget:
                self._m_util.labels(name).set(t.hbm_bytes / budget)

    # -- lookup ---------------------------------------------------------------

    def get(self, app: str) -> Tenant | None:
        with self._lock:
            return self._tenants.get(app)

    @property
    def default(self) -> Tenant | None:
        with self._lock:
            if self._default_app is None:
                return None
            return self._tenants.get(self._default_app)

    def apps(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    def __iter__(self) -> Iterator[Tenant]:
        with self._lock:
            return iter(list(self._tenants.values()))

    def resolve(self, req: Any) -> Tenant | None:
        """The request → tenant map, most explicit first: ``X-Pio-App``
        header, ``?app=`` query, the presented access key, then the
        default tenant.  Returns None for an app that is not resident —
        the caller answers 404, never silently serves another tenant."""
        from predictionio_tpu_torch.server.httpd import header_get, presented_key

        name = header_get(getattr(req, "headers", None), APP_HEADER) or (
            getattr(req, "query", None) or {}
        ).get("app")
        if name:
            return self.get(str(name))
        key = presented_key(req) if hasattr(req, "headers") else ""
        if key:
            with self._lock:
                mapped = self._by_key.get(key)
            if mapped is not None:
                return self.get(mapped)
        return self.default

    # -- the per-request gate (front-end choke point) -------------------------

    def gate(self, req: Any):
        """Admission for one request: ``(tenant, releaser, shed_response)``.

        Exactly one of ``releaser``/``shed_response`` is meaningful: a shed
        (or unknown-app 404) response means the request must be answered
        with it NOW; otherwise ``releaser.release()`` must run in the
        caller's finally.  Quota is spent BEFORE the in-flight slot so a
        flood burns its own bucket, not slot capacity."""
        from predictionio_tpu_torch.server.httpd import (
            error_response,
            shed_response,
        )

        tenant = self.resolve(req)
        if tenant is None:
            return None, None, error_response(
                404, "unknown app: no resident tenant matches this request"
            )
        req.tenant = tenant
        if tenant.quota is not None and not tenant.quota.try_spend(1.0):
            self._m_shed.labels(tenant.name, "tenant_quota").inc()
            tenant.slo.record(False, 0.0)
            resp = shed_response(
                f"tenant {tenant.name!r} over quota; retry later "
                "(reason=tenant_quota)",
                tenant.quota.retry_after_s(),
            )
            resp.headers[APP_HEADER] = tenant.name
            resp.headers["X-Pio-Shed-Reason"] = "tenant_quota"
            return tenant, None, resp
        if not tenant.try_acquire_slot():
            self._m_shed.labels(tenant.name, "tenant_inflight").inc()
            tenant.slo.record(False, 0.0)
            resp = shed_response(
                f"tenant {tenant.name!r} at its in-flight cap; retry later "
                "(reason=tenant_inflight)",
                0.2,
            )
            resp.headers[APP_HEADER] = tenant.name
            resp.headers["X-Pio-Shed-Reason"] = "tenant_inflight"
            return tenant, None, resp
        return tenant, _TenantRelease(tenant), None

    def note_shed(self, app: str, reason: str) -> None:
        """Count a shed decided elsewhere (e.g. queue pressure attributed
        to a tenant) under this registry's per-tenant counter family."""
        self._m_shed.labels(app, reason).inc()

    # -- surfaces -------------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """The ``/tenants.json`` body.  Tenants served from a card add
        ``device_memory``: the card's free and total bytes and the bytes
        the caching allocator holds, read now."""
        with self._lock:
            tenants = list(self._tenants.values())
            budget = self.hbm_budget_bytes
            default_app = self._default_app
        resident = sum(t.hbm_bytes for t in tenants)
        out = {
            "count": len(tenants),
            "default_app": default_app,
            "hbm_budget_bytes": budget,
            "hbm_resident_bytes": resident,
            "hbm_free_bytes": (budget - resident) if budget else None,
            "tenants": [t.snapshot() for t in tenants],
        }
        device = _cuda_device(tenants)
        if device is not None:
            out["device_memory"] = device_memory(device)
        return out


def _cuda_device(tenants: list[Tenant]) -> Any:
    """The card the tenants serve from, or None when none is on one."""
    for t in tenants:
        device = getattr(getattr(t.deployed, "ctx", None), "device", None)
        if getattr(device, "type", None) == "cuda":
            return device
    return None


def device_memory(device: Any) -> dict[str, int]:
    """What the card reports now: ``torch.cuda.mem_get_info``'s free and
    total bytes, and the caching allocator's allocated and reserved
    bytes."""
    import torch

    free, total = torch.cuda.mem_get_info(device)
    return {
        "free_bytes": int(free),
        "total_bytes": int(total),
        "allocated_bytes": int(torch.cuda.memory_allocated(device)),
        "reserved_bytes": int(torch.cuda.memory_reserved(device)),
    }


def render_tenants_text(snapshot: Mapping[str, Any]) -> str:
    """One-screen rendering of a /tenants.json snapshot (pio tenants and
    the pio status --url tenant fold)."""
    budget = snapshot.get("hbm_budget_bytes")
    head = (
        f"tenants: {snapshot.get('count', 0)} resident, HBM "
        f"{snapshot.get('hbm_resident_bytes', 0)}"
        + (f"/{budget}" if budget else "")
        + " bytes"
    )
    lines = [head]
    for t in snapshot.get("tenants") or []:
        slo = t.get("slo") or {}
        quota = t.get("quota")
        quota_part = (
            f"quota {quota['tokens']}/{quota['burst']} "
            f"(denied {quota['denied']})"
            if quota
            else "quota -"
        )
        degraded = ",".join(t.get("degraded") or []) or "-"
        lines.append(
            f"  {t.get('app')}: slo={slo.get('status')} "
            f"avail={slo.get('availability')} hbm={t.get('hbm_bytes')}B "
            f"inflight={t.get('inflight')} {quota_part} degraded={degraded}"
        )
    return "\n".join(lines)
