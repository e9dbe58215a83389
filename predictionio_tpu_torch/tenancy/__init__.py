"""Multi-tenant serving: one replica, many apps, hard isolation.

The JAX package's ``tenancy``, whole.  The data tier keys every event row
by app; this package lets one deploy serve several engines, each a
tenant:

- :class:`~predictionio_tpu_torch.tenancy.registry.TenantRegistry` — owns the
  set of resident :class:`Tenant`\\ s (engine + quality monitor + SLO
  tracker + quota + cost identity) and enforces device-memory bin-packing
  at admission: a tenant whose generation does not fit the remaining HBM
  budget is refused loudly (:class:`TenantAdmissionError` names the
  shortfall) instead of OOMing a resident neighbor.
- :class:`~predictionio_tpu_torch.tenancy.quota.TokenBucket` — the per-tenant
  admission quota, debited per request at the front-end choke point and
  (optionally) back-charged with measured device seconds from the cost
  ledger, so a flooding tenant sheds 503 ``reason=tenant_quota`` BEFORE
  its traffic reaches the MicroBatcher.

Isolation invariants: tenant A's quota flood, corrupt generation, or storage outage degrades
only A — every other tenant's p99/availability SLOs hold and no response
ever carries another tenant's instance header, items, or provenance.
"""

from predictionio_tpu_torch.tenancy.quota import TokenBucket
from predictionio_tpu_torch.tenancy.registry import (
    APP_HEADER,
    Tenant,
    TenantAdmissionError,
    TenantRegistry,
    hbm_footprint,
    render_tenants_text,
)

__all__ = [
    "APP_HEADER",
    "Tenant",
    "TenantAdmissionError",
    "TenantRegistry",
    "TokenBucket",
    "hbm_footprint",
    "render_tenants_text",
]
