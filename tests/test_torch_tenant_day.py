"""The port's two-tenant production day against the JAX package's.

- ``run_tenant_day`` (the JAX ``TestTenantDay`` settings: a 3 s day,
  alpha at 20 queries/s, beta flooded at 10x its 4 rps quota, the alert's
  sustain window rescaled to 1 s) exits 0 on the port: ``tenant_isolation``
  and ``fault_reconciliation`` pass, beta is shed and alpha is not, no
  answer leaks, and the ``tenant_quota_shed_rate`` bundle names beta.  The
  port's evidence gives the JAX ``evaluate_day`` the same verdict.
- ``build_stub_tenant`` answers as the JAX stub does: the same statuses,
  ``X-Pio-App`` / ``X-Pio-Engine-Instance`` / shed headers and bodies from
  both packages' multi-tenant apps (the chaos-isolation quota case of
  ``tests/test_tenancy.py``), with no card and no storage.

Every server binds port 0 and is shut down in ``finally``; every client
call has a timeout of 10 s.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from predictionio_tpu.obs import verdict as jax_verdict
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.replay import tenant_day as jax_tenant_day
from predictionio_tpu.server import aio as jax_aio
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tenancy import TenantRegistry as JaxTenantRegistry
from predictionio_tpu_torch.obs import verdict as pt_verdict
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.replay import tenant_day as pt_tenant_day
from predictionio_tpu_torch.server import aio as pt_aio
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.tenancy import APP_HEADER, TenantRegistry

torch.set_num_threads(2)

TIMEOUT = 10


def test_tenant_day_contains_the_flood(tmp_path):
    report_path = tmp_path / "report.json"
    rc, report = pt_tenant_day.run_tenant_day(
        duration_s=3.0, neighbor_qps=20.0, quota_rps=4.0, flood_factor=10.0,
        alert_for_s=1.0, incident_dir=str(tmp_path / "incidents"),
        report_path=str(report_path), out=lambda s: None,
    )
    assert rc == 0, json.dumps(report["verdict"], indent=2, default=str)
    clauses = {c["clause"]: c["passed"] for c in report["verdict"]["clauses"]}
    assert clauses["tenant_isolation"] is True
    assert clauses["fault_reconciliation"] is True
    rows = {r["app"]: r for r in report["tenants"]}
    assert rows["beta"]["quota_shed"] > 0
    assert rows["alpha"]["quota_shed"] == 0
    assert rows["alpha"]["availability"] >= 0.99
    assert rows["alpha"]["leaked"] == 0 and rows["beta"]["leaked"] == 0
    bundles = []
    for name in os.listdir(tmp_path / "incidents"):
        if name.endswith(".json"):
            with open(tmp_path / "incidents" / name) as fh:
                bundles.append(json.load(fh))
    assert any(b.get("rule") == "tenant_quota_shed_rate" and b.get("tenant") == "beta"
               for b in bundles), bundles
    assert report_path.exists()
    # the port's evidence judged by both engines
    evidence = json.loads(json.dumps(report["evidence"], default=str))
    got = pt_verdict.evaluate_day(evidence)
    want = jax_verdict.evaluate_day(evidence)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert {c["clause"]: c["passed"] for c in want["clauses"]} == clauses


def test_stub_tenant_needs_no_card_and_no_storage(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tenant = pt_tenant_day.build_stub_tenant("shop", quota_rps=2.0, quota_burst=3.0)
    assert tenant.name == "shop" and tenant.deployed.storage is None
    assert tenant.deployed.instance.id == "inst-shop"
    assert tenant.deployed.ctx.device == torch.device("cpu")
    assert tenant.quota is not None


def _query(base, app, user):
    req = urllib.request.Request(
        f"{base}/queries.json", data=json.dumps({"user": user}).encode(),
        headers={"Content-Type": "application/json", APP_HEADER: app}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


KEPT = (APP_HEADER, "X-Pio-Engine-Instance", "X-Pio-Shed-Reason")


def _drive(package) -> list:
    """Three stub tenants on one multi-tenant app of ``package``: beta's
    quota of 2 rps (burst 2) under 20 queries, then 10 each for alpha and
    gamma; (status, kept headers, servedBy) per query."""
    if package == "port":
        mod, registry, reg_cls, srv, aio = (pt_tenant_day, TenantRegistry,
                                            MetricsRegistry, pt_server, pt_aio)
    else:
        mod, registry, reg_cls, srv, aio = (jax_tenant_day, JaxTenantRegistry,
                                            JaxRegistry, jax_server, jax_aio)
    tenants = registry(registry=reg_cls())
    for t in (mod.build_stub_tenant("alpha"),
              mod.build_stub_tenant("beta", quota_rps=2.0, quota_burst=2.0),
              mod.build_stub_tenant("gamma")):
        tenants.admit(t)
    app = srv.create_multi_tenant_server_app(tenants, use_microbatch=True)
    server = aio.AsyncAppServer(app, "127.0.0.1", 0).start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        out = [("beta", _query(base, "beta", f"u{i}")) for i in range(20)]
        for victim in ("alpha", "gamma"):
            out += [(victim, _query(base, victim, f"v{i}")) for i in range(10)]
    finally:
        server.shutdown()
    return [(app_name, s, {k: h.get(k) for k in KEPT}, b.get("servedBy"))
            for app_name, (s, h, b) in out]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_stub_tenants_answer_as_the_jax_stub(package):
    """Each package's stub tenants on its own multi-tenant app: beta's
    flood is shed with the tenant_quota reason and beta named, its
    in-quota queries served; the neighbors answer every query, stamped
    with their own app and instance, and echo their own name.  The
    answers of both packages are held to the same rules, the port's
    besides to the JAX package's shapes below."""
    got = _drive(package)
    beta = [g for g in got if g[0] == "beta"]
    shed = [g for g in beta if g[1] == 503]
    served = [g for g in beta if g[1] == 200]
    assert shed and served and len(shed) + len(served) == 20
    for _, _, h, _ in shed:
        assert h[APP_HEADER] == "beta" and h["X-Pio-Shed-Reason"] == "tenant_quota"
    for _, _, h, body in served:
        assert h[APP_HEADER] == "beta" and h["X-Pio-Engine-Instance"] == "inst-beta"
        assert body == "beta"
    for victim in ("alpha", "gamma"):
        mine = [g for g in got if g[0] == victim]
        assert [g[1] for g in mine] == [200] * 10
        assert all(h[APP_HEADER] == victim and h["X-Pio-Engine-Instance"]
                   == f"inst-{victim}" and body == victim for _, _, h, body in mine)


def test_stub_tenant_headers_equal_jax():
    """The same requests to both packages' stub tenants: every 200 carries
    the same kept headers and body, every 503 the same shed headers."""
    port, jax = _drive("port"), _drive("jax")
    assert [g[0] for g in port] == [g[0] for g in jax]
    by_status = {}
    for side, rows in (("port", port), ("jax", jax)):
        for app_name, status, h, body in rows:
            by_status.setdefault((side, app_name, status), set()).add(
                (json.dumps(h, sort_keys=True), body))
    for (side, app_name, status), shapes in by_status.items():
        if side == "port" and ("jax", app_name, status) in by_status:
            assert shapes == by_status[("jax", app_name, status)], (app_name, status)
    # the neighbors, never throttled, answer alike query for query
    assert [g for g in port if g[0] != "beta"] == [g for g in jax if g[0] != "beta"]
