"""Evaluation dashboard (:9000).

The JAX package's ``server/dashboard.py`` on the port's storage and
``obs/``: an HTML index of completed evaluations (newest first) with their
metric scores, a per-instance detail page rendering the evaluator's stored
HTML, ``evaluator_results.json``, and ``/trace/<tid>``'s assembled
waterfall, beside the health, alerts, capacity, fleet, tenants, quality,
device, profiling, traces and metrics panels.  The pages are the JAX
package's byte for byte but for the device panel, which reads the port's
CUDA accounting.  The dashboard never initializes CUDA: the device panel
reads only what this process has already recorded (``obs/device.py``).
"""

from __future__ import annotations

import html
import json
import os
from urllib.parse import quote

from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage
from predictionio_tpu_torch.obs.capacity import capacity_snapshot
from predictionio_tpu_torch.obs.device import device_snapshot
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.quality import QualityMonitor, default_quality
from predictionio_tpu_torch.obs.slo import run_readiness
from predictionio_tpu_torch.obs.timeline import (
    Timeline,
    TraceAssemblyError,
    TraceNode,
    collect_trace,
)
from predictionio_tpu_torch.obs.tracing import recent_traces
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    error_response,
)


#: eight-level unicode sparkline alphabet (min → max of the series)
_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _sparkline(values: list[float]) -> str:
    """Render a sampled series as a fixed-height unicode sparkline."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    top = len(_SPARK_CHARS) - 1
    return "".join(
        _SPARK_CHARS[int((v - lo) / span * top)] for v in values
    )


def _metrics_table_html(registry: MetricsRegistry) -> str:
    """The registry as an HTML table: counters/gauges with their value,
    histograms with count + p50/p95/p99 (computed from the log buckets),
    plus a per-series sparkline from the scrape-fed history ring — which is
    what gives the serving-latency rows their trend at a glance."""
    rows = []
    for name, fam in sorted(registry.render_json().items()):
        for s in fam["series"]:
            label_values = tuple(str(v) for v in s["labels"].values())
            labels = ",".join(f"{k}={v}" for k, v in s["labels"].items())
            if fam["type"] in ("counter", "gauge"):
                detail = f"{s['value']:g}"
            else:
                detail = (
                    f"n={s['count']} p50={s['p50']:.6f} "
                    f"p95={s['p95']:.6f} p99={s['p99']:.6f}"
                )
            spark = _sparkline(registry.history.series(name, label_values))
            rows.append(
                f"<tr><td>{html.escape(name)}</td>"
                f"<td>{html.escape(labels)}</td>"
                f"<td>{html.escape(fam['type'])}</td>"
                f"<td>{html.escape(detail)}</td>"
                f"<td>{html.escape(spark)}</td></tr>"
            )
    return (
        "<h2>Metrics</h2><table border='1'>"
        "<tr><th>metric</th><th>labels</th><th>type</th><th>value</th>"
        "<th>trend</th></tr>"
        + "".join(rows)
        + "</table>"
    )


def _quality_html(quality: QualityMonitor, registry: MetricsRegistry) -> str:
    """Model-quality panel: drift state per distribution and the rolling
    online metrics per engine variant, with sparklines from the history
    ring (``pio_online_metric{variant,metric}``).

    Side effect: the render IS a scrape — ``snapshot()`` refreshes the
    quality gauges and the history ring then samples the registry, in that
    order, so every trend tail on the page (this panel and the metrics
    table below it) matches the value column instead of lagging a render.
    """
    snap = quality.snapshot()
    registry.history.sample(registry)
    drift = snap["drift"]
    drift_rows = "".join(
        f"<tr><td>{html.escape(name)}</td>"
        f"<td>{html.escape(d['state'])}</td>"
        f"<td>{d['psi']:.4f}</td><td>{d['ks']:.4f}</td>"
        f"<td>{d['windows']}</td><td>{d['transitions']}</td>"
        f"<td>{html.escape(_sparkline(registry.history.series('pio_drift_psi', (name,))))}</td></tr>"
        for name, d in drift["distributions"].items()
    )
    variant_rows = []
    for variant, v in snap["variants"].items():
        for metric, value in v["metrics"].items():
            spark = _sparkline(
                registry.history.series("pio_online_metric", (variant, metric))
            )
            variant_rows.append(
                f"<tr><td>{html.escape(variant)}</td>"
                f"<td>{html.escape(metric)}</td>"
                f"<td>{'n/a' if value is None else f'{value:.4f}'}</td>"
                f"<td>{html.escape(spark)}</td></tr>"
            )
        variant_rows.append(
            f"<tr><td>{html.escape(variant)}</td><td>volume</td>"
            f"<td>{v['predictions']} predictions, {v['joined']} joined</td>"
            f"<td></td></tr>"
        )
    return (
        f"<h2>Model quality</h2><p>drift: <b>{html.escape(drift['state'])}</b>"
        f", prediction log {snap['log']['size']}/{snap['log']['capacity']}</p>"
        "<table border='1'><tr><th>distribution</th><th>state</th>"
        "<th>psi</th><th>ks</th><th>windows</th><th>transitions</th>"
        "<th>trend</th></tr>"
        + drift_rows
        + "</table><table border='1'><tr><th>variant</th><th>metric</th>"
        "<th>value</th><th>trend</th></tr>"
        + "".join(variant_rows)
        + "</table>"
    )


def _efficiency_html(registry: MetricsRegistry) -> str:
    """Device-efficiency panel: achieved-vs-peak per entry point (the
    /efficiency.json surface, human-shaped) with trend sparklines from the
    scrape-fed history ring, plus any active launch-shape storm.  It reads
    this process's accounting only and never initializes CUDA."""
    snap = device_snapshot()
    peaks = snap["peaks"]
    rows = []
    for fn, entry in sorted(snap["functions"].items()):
        if "achieved_gbps" not in entry:
            continue  # cost known but never timed: nothing to chart yet
        spark_gbps = _sparkline(
            registry.history.series("pio_device_achieved_gbps", (fn,))
        )
        rows.append(
            f"<tr><td>{html.escape(fn)}</td>"
            f"<td>{entry['calls']}</td>"
            f"<td>{entry['achieved_gbps']:.3f}</td>"
            f"<td>{entry['utilization_hbm']:.2%}</td>"
            f"<td>{entry['achieved_tflops']:.4f}</td>"
            f"<td>{entry['utilization_mxu']:.2%}</td>"
            f"<td>{html.escape(entry.get('source', '?'))}</td>"
            f"<td>{html.escape(spark_gbps)}</td></tr>"
        )
    storms = snap["recompiles"]["active_storms"]
    storm_note = (
        "<p><b>RECOMPILE STORM:</b> "
        + ", ".join(html.escape(fn) for fn in sorted(storms))
        + " — traffic is churning shapes; every wave launches a new "
        "signature</p>"
        if storms
        else ""
    )
    shards = snap.get("shards") or {}
    shard_rows = []
    for fn, per_dev in sorted(shards.get("functions", {}).items()):
        for device, entry in sorted(per_dev.items()):
            shard_rows.append(
                f"<tr><td>{html.escape(fn)}</td>"
                f"<td>{html.escape(device)}</td>"
                f"<td>{entry.get('bytes', 0.0):.0f}</td>"
                f"<td>{entry.get('waves', 0)}</td>"
                f"<td>{entry.get('seconds', 0.0):.4f}</td></tr>"
            )
    shard_html = (
        "<h3>Mesh shards</h3><p>mesh: "
        + html.escape(", ".join(shards.get("devices", [])))
        + "</p><table border='1'><tr><th>fn</th><th>device</th>"
        "<th>bytes</th><th>waves</th><th>seconds</th></tr>"
        + "".join(shard_rows)
        + "</table>"
        if shard_rows
        else ""
    )
    return (
        f"<h2>Device efficiency</h2><p>platform: "
        f"{html.escape(str(snap['platform']))}, peaks: "
        f"{peaks['hbm_gbps']:g} GB/s HBM / {peaks['tflops']:g} TFLOP/s "
        f"({html.escape(str(peaks['source']))})</p>"
        + storm_note
        + "<table border='1'><tr><th>fn</th><th>calls</th>"
        "<th>GB/s</th><th>HBM util</th><th>TFLOP/s</th><th>compute util</th>"
        "<th>cost source</th><th>trend</th></tr>"
        + "".join(rows)
        + "</table>"
        + shard_html
    )


def _traces_table_html(n: int = 15, access_key: str | None = None) -> str:
    """Recent root spans; rows with a request id link to the matching
    flight-recorder entry for the full per-request record, and rows with a
    trace id link to the ASSEMBLED cross-process waterfall (``/trace/<id>``)
    — not just this process's fragment of it.  On a key-gated dashboard
    every link carries the accessKey so clicking through from an
    authenticated page doesn't 401."""
    key_amp = f"&accessKey={quote(access_key)}" if access_key else ""
    key_q = f"?accessKey={quote(access_key)}" if access_key else ""
    rows = []
    for t in recent_traces(n):
        rid = t.get("request_id") or ""
        rid_cell = (
            f"<a href='/debug/flight.json?request_id={quote(rid)}"
            f"{key_amp}'>{html.escape(rid)}</a>"
            if rid
            else ""
        )
        tid = t.get("trace_id") or ""
        tid_cell = (
            f"<a href='/trace/{quote(tid)}{key_q}'>{html.escape(tid)}</a>"
            if tid
            else ""
        )
        # the decision-provenance click-through: request_id= is already a
        # query param, so the key joins with '&' (key_amp, never key_q —
        # a second '?' would truncate the gated link's request id)
        explain_cell = (
            f"<a href='/explain.json?request_id={quote(rid)}"
            f"{key_amp}'>why</a>"
            if rid
            else ""
        )
        children = ", ".join(
            c.get("name", "") for c in t.get("children", [])
        )
        rows.append(
            f"<tr><td>{html.escape(t.get('name', ''))}</td>"
            f"<td>{t.get('duration_s', 0):.6f}</td>"
            f"<td>{rid_cell}</td>"
            f"<td>{tid_cell}</td>"
            f"<td>{explain_cell}</td>"
            f"<td>{html.escape(t.get('error') or '')}</td>"
            f"<td>{html.escape(children)}</td></tr>"
        )
    return (
        "<h2>Recent traces</h2><table border='1'>"
        "<tr><th>span</th><th>seconds</th><th>request</th><th>trace</th>"
        "<th>explain</th><th>error</th><th>children</th></tr>"
        + "".join(rows)
        + "</table>"
    )


def _waterfall_html(tl: Timeline, access_key: str | None = None) -> str:
    """One assembled trace as an HTML waterfall: a lane per process (device
    tracks indented under theirs), each span a positioned bar over the
    trace's full wall-clock extent plus the indented name/timing text the
    text renderer prints.  Pure inline-styled HTML — the dashboard has no
    static assets."""
    t0 = tl.t0
    end = max(
        (n.start_s + n.duration_s for n in tl.nodes.values()), default=t0
    )
    span_ms = max((end - t0) * 1e3, 1e-6)
    key_amp = f"&accessKey={quote(access_key)}" if access_key else ""
    parts = [
        f"<h2>Trace {html.escape(tl.trace_id)}</h2>"
        f"<p>{len(tl.processes)} process(es), {tl.span_count} span(s), "
        f"{span_ms:.1f} ms"
        f" — <a href='/spans.json?trace_id={quote(tl.trace_id)}{key_amp}'>"
        "this process's raw fragments</a>, "
        f"<a href='/trace/{quote(tl.trace_id)}?format=perfetto{key_amp}'>"
        "Perfetto JSON</a> (open in https://ui.perfetto.dev); assemble "
        f"across daemons with <code>pio trace {html.escape(tl.trace_id)} "
        "--from URL,URL --perfetto out.json</code></p>"
    ]
    for err in tl.source_errors:
        parts.append(f"<p><b>source error:</b> {html.escape(err)}</p>")
    by_process: dict[str, list[tuple[int, TraceNode]]] = {}

    def index(node: TraceNode, depth: int) -> None:
        by_process.setdefault(node.process, []).append((depth, node))
        for c in node.children:
            index(c, depth + 1)

    for root in tl.roots:
        index(root, 0)
    for proc in tl.processes:
        rows = []
        for depth, node in by_process.get(proc, []):
            left = (node.start_s - t0) * 1e3 / span_ms * 100.0
            width = max(node.duration_s * 1e3 / span_ms * 100.0, 0.2)
            device = node.track != "spans"
            color = "#8bc" if device else "#c86"
            label = (
                f"{'&nbsp;' * (2 * depth)}{html.escape(node.name)}"
                f"{' [' + html.escape(node.track) + ']' if device else ''}"
                f" +{(node.start_s - t0) * 1e3:.2f}ms "
                f"{node.duration_s * 1e3:.3f}ms"
                f"{' ORPHAN' if node.orphan else ''}"
                + (
                    " ERROR: " + html.escape(str(node.fragment["error"]))
                    if node.fragment.get("error")
                    else ""
                )
            )
            rows.append(
                "<tr>"
                f"<td style='white-space:nowrap'>{label}</td>"
                "<td style='width:50%'><div style='position:relative;"
                "height:10px;background:#eee'>"
                f"<div style='position:absolute;left:{left:.2f}%;"
                f"width:{width:.2f}%;height:10px;background:{color}'>"
                "</div></div></td></tr>"
            )
        parts.append(
            f"<h3>{html.escape(proc)}</h3>"
            "<table border='0' style='width:100%'>" + "".join(rows)
            + "</table>"
        )
    return "".join(parts)


def _health_html(app: HTTPApp) -> str:
    """SLO window + readiness checks as a panel (the /healthz, /readyz,
    /slo.json surface, human-shaped)."""
    slo = app.slo.snapshot()
    ready, checks = run_readiness(app.readiness)
    slo_rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in slo.items()
    )
    check_rows = "".join(
        f"<tr><td>{html.escape(name)}</td>"
        f"<td>{'ok' if ok else 'FAILING'}</td></tr>"
        for name, ok in checks.items()
    )
    return (
        f"<h2>Health</h2><p>status: <b>{html.escape(slo['status'])}</b>, "
        f"ready: <b>{'yes' if ready else 'NO'}</b></p>"
        "<table border='1'><tr><th>slo</th><th>value</th></tr>"
        + slo_rows
        + "</table><table border='1'><tr><th>readiness check</th>"
        "<th>state</th></tr>"
        + check_rows
        + "</table>"
    )


def _capacity_html(app: HTTPApp) -> str:
    """Capacity panel: the headroom model (obs/capacity.py) over this
    process's registry — max-sustainable QPS, which ceiling binds, and the
    recommended replica count an autoscaler would act on."""
    snap = capacity_snapshot(app, REGISTRY)
    headroom = snap.get("headroom_frac")
    inputs = snap.get("inputs", {})
    input_rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in inputs.items()
        if v is not None
    )
    ceiling_rows = "".join(
        f"<tr><td>{html.escape(name)}"
        f"{' (binding)' if name == snap.get('binding_ceiling') else ''}</td>"
        f"<td>{qps:g} qps</td></tr>"
        for name, qps in snap.get("ceilings_qps", {}).items()
    )
    caveats = "".join(
        f"<li>{html.escape(c)}</li>" for c in snap.get("caveats", [])
    )
    return (
        "<h2>Capacity</h2><p>headroom: <b>"
        + (f"{headroom:.1%}" if headroom is not None else "unknown")
        + "</b>, max sustainable: <b>"
        + (
            f"{snap['max_sustainable_qps']:g} qps"
            if snap.get("max_sustainable_qps") is not None
            else "unknown"
        )
        + f"</b>, recommended replicas: "
        f"<b>{snap.get('recommended_replicas') or '?'}</b>, "
        f"scale hint: <b>{html.escape(str(snap.get('scale_hint')))}</b></p>"
        "<table border='1'><tr><th>ceiling</th><th>qps</th></tr>"
        + ceiling_rows
        + "</table><table border='1'><tr><th>input</th><th>value</th></tr>"
        + input_rows
        + "</table>"
        + (f"<ul>{caveats}</ul>" if caveats else "")
    )


def _fleet_html(fleet_url: str, access_key: str | None = None) -> str:
    """Fleet panel: the router's /fleet.json membership registry — who the
    replicas are, which are routable, and what each last said about its
    capacity.  A dead router costs one bounded fetch and renders as a
    one-line notice (the dashboard must not die with the fleet)."""
    import urllib.request

    headers = {}
    if access_key:
        headers["Authorization"] = f"Bearer {access_key}"
    try:
        req = urllib.request.Request(
            fleet_url.rstrip("/") + "/fleet.json", headers=headers
        )
        with urllib.request.urlopen(req, timeout=3.0) as r:
            body = json.loads(r.read().decode("utf-8"))
    except Exception as e:
        return (
            "<h2>Fleet</h2><p>router at "
            f"<code>{html.escape(fleet_url)}</code> unreachable: "
            f"{html.escape(str(e))}</p>"
        )
    rows = []
    for rep in body.get("replicas", []):
        state = "ok"
        if rep.get("draining"):
            state = "draining"
        elif not rep.get("healthy"):
            state = "EJECTED"
        elif rep.get("breaker") == "open":
            state = "BREAKER-OPEN"
        cap = rep.get("capacity") or {}
        headroom = cap.get("headroom_frac")
        rows.append(
            f"<tr><td>{html.escape(str(rep.get('replica')))}</td>"
            f"<td>{state}</td>"
            f"<td>{html.escape(str(rep.get('breaker')))}</td>"
            f"<td>{rep.get('inflight', 0)}</td>"
            f"<td>{_esc_num(cap.get('max_sustainable_qps'))}</td>"
            "<td>"
            + (
                f"{headroom:.1%}"
                if isinstance(headroom, (int, float))
                else "n/a"
            )
            + "</td></tr>"
        )
    auto = body.get("autoscaler") or {}
    auto_line = ""
    if auto:
        pol = auto.get("policy", {})
        auto_line = (
            "<p>autoscaler: "
            f"[{pol.get('min_replicas')}..{pol.get('max_replicas')}] "
            + (
                f"pinned at {auto['target_override']}"
                if auto.get("target_override") is not None
                else "capacity-driven"
            )
            + "</p>"
        )
    return (
        f"<h2>Fleet</h2><p>{body.get('total', 0)} replicas, "
        f"<b>{body.get('routable', 0)}</b> routable "
        f"(router: <code>{html.escape(fleet_url)}</code>)</p>"
        "<table border='1'><tr><th>replica</th><th>state</th><th>breaker</th>"
        "<th>inflight</th><th>max qps</th><th>headroom</th></tr>"
        + "".join(rows)
        + "</table>"
        + auto_line
    )


def _esc_num(v) -> str:
    return f"{v:g}" if isinstance(v, (int, float)) else "n/a"


def _tenants_html(serving_url: str, access_key: str | None = None) -> str:
    """Tenants panel: a running replica's /tenants.json — one row per
    resident tenant (SLO state, quota burn, resident HBM bytes, in-flight
    count, degraded reasons).  A dead replica costs one bounded fetch and
    renders as a one-line notice (the dashboard must not die with it)."""
    import urllib.request

    headers = {}
    if access_key:
        headers["Authorization"] = f"Bearer {access_key}"
    base = serving_url.rstrip("/")
    try:
        req = urllib.request.Request(
            base + "/tenants.json", headers=headers
        )
        with urllib.request.urlopen(req, timeout=3.0) as r:
            body = json.loads(r.read().decode("utf-8"))
    except Exception as e:
        return (
            "<h2>Tenants</h2><p>replica at "
            f"<code>{html.escape(serving_url)}</code> unreachable: "
            f"{html.escape(str(e))}</p>"
        )
    # gated drill-down links reuse the single-`?` access-key join: the key
    # (when configured) claims the `?`, every further param joins with `&`
    # — a second `?` would truncate the query string at the replica
    key_q = f"?accessKey={quote(access_key)}" if access_key else ""
    amp = "&" if access_key else "?"
    rows = []
    for t in body.get("tenants", []):
        slo = t.get("slo") or {}
        quota = t.get("quota") or {}
        degraded = ",".join(t.get("degraded") or []) or "-"
        name = str(t.get("app"))
        link = f"{base}/tenants.json{key_q}{amp}app={quote(name)}"
        rows.append(
            f"<tr><td><a href='{html.escape(link)}'>"
            f"{html.escape(name)}</a></td>"
            f"<td>{html.escape(str(slo.get('status')))}</td>"
            f"<td>{_esc_num(slo.get('availability'))}</td>"
            f"<td>{quota.get('denied', 0) if quota else '-'}</td>"
            f"<td>{t.get('hbm_bytes', 0)}</td>"
            f"<td>{t.get('inflight', 0)}</td>"
            f"<td>{html.escape(degraded)}</td></tr>"
        )
    budget = body.get("hbm_budget_bytes")
    return (
        f"<h2>Tenants</h2><p>{body.get('count', 0)} resident, HBM "
        f"{body.get('hbm_resident_bytes', 0)}"
        + (f"/{budget}" if budget else "")
        + f" bytes (replica: <code>{html.escape(serving_url)}</code>)</p>"
        "<table border='1'><tr><th>app</th><th>slo</th>"
        "<th>availability</th><th>quota denied</th><th>hbm bytes</th>"
        "<th>inflight</th><th>degraded</th></tr>"
        + "".join(rows)
        + "</table>"
    )


def _alerts_html(
    app: HTTPApp, fleet_url: str | None = None, access_key: str | None = None
) -> str:
    """Alerts panel: the evaluator's firing/pending table (age + rule +
    value, with links to the matching incident bundle and the assembled
    ``/trace/<id>`` waterfall where an exemplar exists) and the recorded
    Incidents list.  With a fleet router configured, the local snapshot is
    swapped for the router's federated /alerts.json so the panel shows the
    whole fleet replica-tagged."""
    key_q = f"?accessKey={quote(access_key)}" if access_key else ""
    evaluator = getattr(app, "alerts", None)
    snap: dict = {}
    source = "local"
    if fleet_url:
        import urllib.request

        headers = {}
        if access_key:
            headers["Authorization"] = f"Bearer {access_key}"
        try:
            req = urllib.request.Request(
                fleet_url.rstrip("/") + "/alerts.json", headers=headers
            )
            with urllib.request.urlopen(req, timeout=3.0) as r:
                snap = json.loads(r.read().decode("utf-8"))
            source = f"fleet router {fleet_url}"
        except Exception as e:
            snap = {}
            source = f"router alerts unreachable ({e}); local state below"
    if not snap and evaluator is not None:
        snap = evaluator.snapshot()
    recorder = getattr(app, "incidents", None)
    incidents = recorder.list() if recorder is not None else []
    by_rule = {}
    for inc in incidents:
        by_rule.setdefault(inc.get("rule"), inc)
    rows = []
    for a in snap.get("alerts", []):
        inc = by_rule.get(a.get("rule"))
        inc_cell = (
            f"<a href='/incidents/{quote(str(inc.get('id')))}.json{key_q}'>"
            f"{html.escape(str(inc.get('id')))}</a>"
            if inc and inc.get("id")
            else ""
        )
        tid = (inc or {}).get("exemplar_trace_id") or ""
        trace_cell = (
            f"<a href='/trace/{quote(str(tid))}{key_q}'>{html.escape(str(tid))}</a>"
            if tid
            else ""
        )
        age = a.get("age_s")
        rows.append(
            f"<tr><td><b>{html.escape(str(a.get('state', '')).upper())}</b></td>"
            f"<td>{html.escape(str(a.get('rule')))}</td>"
            f"<td>{html.escape(str(a.get('key') or ''))}</td>"
            f"<td>{html.escape(str(a.get('replica') or ''))}</td>"
            f"<td>{html.escape(str(a.get('value')))}</td>"
            + (
                f"<td>{age:.0f}s</td>"
                if isinstance(age, (int, float))
                else "<td></td>"
            )
            + f"<td>{html.escape(str(a.get('severity')))}</td>"
            f"<td>{inc_cell}</td><td>{trace_cell}</td></tr>"
        )
    inc_rows = "".join(
        f"<tr><td><a href='/incidents/{quote(str(i.get('id')))}.json{key_q}'>"
        f"{html.escape(str(i.get('id')))}</a></td>"
        f"<td>{html.escape(str(i.get('rule')))}</td>"
        f"<td>{html.escape(str(i.get('severity')))}</td>"
        f"<td>{i.get('spans', 0)}</td>"
        f"<td>{html.escape(str(i.get('exemplar_trace_id') or ''))}</td></tr>"
        for i in incidents[:15]
    )
    return (
        f"<h2>Alerts</h2><p><b>{snap.get('firing', 0)}</b> firing, "
        f"{snap.get('pending', 0)} pending "
        f"({len(snap.get('rules', []) or [])} rules; source: "
        f"{html.escape(source)})</p>"
        + "".join(
            f"<p><b>source error:</b> {html.escape(str(e))}</p>"
            for e in snap.get("source_errors", [])
        )
        + "<table border='1'><tr><th>state</th><th>rule</th><th>key</th>"
        "<th>replica</th><th>value</th><th>age</th><th>severity</th>"
        "<th>incident</th><th>trace</th></tr>"
        + "".join(rows)
        + "</table>"
        "<h3>Incidents</h3><table border='1'><tr><th>bundle</th>"
        "<th>rule</th><th>severity</th><th>spans</th><th>exemplar</th></tr>"
        + inc_rows
        + "</table><p>replay offline: <code>pio incident show &lt;id&gt;"
        "</code> · <code>pio trace &lt;trace-id&gt; --file "
        "&lt;bundle.json&gt;</code></p>"
    )


def _profiling_html(access_key: str | None = None) -> str:
    """Profiling panel: the on-demand device profile and the continuous
    host stack sampler, side by side — one answers "what is the device
    doing", the other "where is the host spending its milliseconds", and a
    slow request usually needs both."""
    qs = f"?accessKey={quote(access_key)}" if access_key else ""
    amp = "&" if access_key else "?"
    return (
        "<h2>Profiling</h2><table border='1'>"
        "<tr><th>device (on-demand)</th><th>host (continuous)</th></tr>"
        "<tr><td>torch.profiler capture: "
        f"<code>POST /debug/profile{qs}{amp}seconds=N</code> "
        f"(<a href='/debug/profile{qs}'>status</a>); open the capture's "
        "trace.json in https://ui.perfetto.dev</td>"
        f"<td><a href='/debug/stacks.json{qs}'>stack summary</a> · "
        f"<a href='/debug/stacks.json{qs}{amp}format=speedscope'>"
        "speedscope</a> · "
        f"<a href='/debug/stacks.json{qs}{amp}format=collapsed'>"
        "collapsed</a> (first click arms the sampler; see also "
        "<code>pio profile --stacks</code>)</td></tr></table>"
    )


def create_dashboard_app(
    storage: StorageRuntime | None = None,
    access_key: str | None = None,
    quality: QualityMonitor | None = None,
    trace_sources: list[str] | None = None,
    fleet_url: str | None = None,
    serving_url: str | None = None,
) -> HTTPApp:
    """``access_key`` gates every route but ``/healthz``; TLS comes from the
    AppServer layer below.

    ``trace_sources`` (default: ``PIO_TRACE_SOURCES``, comma-separated base
    URLs) names the other daemons' ``/spans.json`` endpoints the
    ``/trace/<id>`` waterfall assembles across — unset, the waterfall shows
    this process's fragments only (still useful for a `pio deploy` whose
    embedded servers share one store).

    ``fleet_url`` (default: ``PIO_FLEET_URL``) names a fleet router whose
    ``/fleet.json`` renders as the Fleet panel — replica membership,
    ejections, and per-replica capacity at a glance.

    ``serving_url`` (default: ``PIO_SERVING_URL``) names a prediction
    replica whose ``/tenants.json`` renders as the Tenants panel — one
    row per resident tenant with SLO state, quota burn, resident HBM
    bytes, and degraded reasons."""
    storage = storage or get_storage()
    app = HTTPApp("dashboard", access_key=access_key)
    quality = quality or default_quality()
    if trace_sources is None:
        trace_sources = [
            u.strip()
            for u in os.environ.get("PIO_TRACE_SOURCES", "").split(",")
            if u.strip()
        ]
    if fleet_url is None:
        fleet_url = os.environ.get("PIO_FLEET_URL") or None
    if serving_url is None:
        serving_url = os.environ.get("PIO_SERVING_URL") or None

    def _metadata_ready() -> bool:
        storage.evaluation_instances().get_completed()
        return True

    # the dashboard runs its own watch loop over the process registry and
    # reads the SAME incident directory the serving process writes (a
    # co-located `pio deploy`'s bundles list here with zero config);
    # PIO_ALERTS=0 disables it like everywhere else
    from predictionio_tpu_torch.obs.alerts import AlertEvaluator
    from predictionio_tpu_torch.obs.incident import IncidentRecorder

    alerts_on = os.environ.get("PIO_ALERTS", "1").lower() not in (
        "0", "off", "false", "no",
    )
    incidents = IncidentRecorder(app=app) if alerts_on else None
    alerts = (
        AlertEvaluator(app=app, incidents=incidents) if alerts_on else None
    )

    # app-level access_key (when set) gates these; /healthz stays public
    add_observability_routes(
        app,
        readiness={"metadata_store": _metadata_ready},
        quality=quality,
        alerts=alerts,
        incidents=incidents,
    )
    # started by AppServer when the dashboard actually serves (app
    # construction stays thread-free — the httpd.AppServer contract)
    app.alerts_autostart = alerts is not None

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        # rendered before the page body: _quality_html refreshes the
        # quality gauges and advances the sparkline ring (see its
        # docstring), so the panels self-populate with CURRENT values even
        # with no external Prometheus scraper
        quality_html = _quality_html(quality, REGISTRY)
        instances = storage.evaluation_instances().get_completed()
        rows = "".join(
            f"<tr><td><a href='/engine_instances/{html.escape(i.id)}'>"
            f"{html.escape(i.id)}</a></td>"
            f"<td>{html.escape(i.evaluation_class)}</td>"
            f"<td>{html.escape(i.start_time.isoformat())}</td>"
            f"<td>{html.escape(i.end_time.isoformat())}</td>"
            f"<td>{html.escape(i.evaluator_results or '')}</td></tr>"
            for i in instances
        )
        return Response(
            200,
            "<html><head><title>PredictionIO-TPU Dashboard</title></head><body>"
            "<h1>Completed evaluations</h1>"
            "<table border='1'><tr><th>id</th><th>evaluation</th>"
            f"<th>started</th><th>finished</th><th>result</th></tr>{rows}"
            f"</table>{_health_html(app)}"
            f"{_alerts_html(app, fleet_url=fleet_url, access_key=access_key)}"
            f"{_capacity_html(app)}"
            + (
                _fleet_html(fleet_url, access_key=access_key)
                if fleet_url
                else ""
            )
            + (
                _tenants_html(serving_url, access_key=access_key)
                if serving_url
                else ""
            )
            + f"{quality_html}"
            f"{_efficiency_html(REGISTRY)}"
            f"{_profiling_html(access_key=access_key)}"
            f"{_traces_table_html(access_key=access_key)}"
            f"{_metrics_table_html(REGISTRY)}</body></html>",
        )

    @app.route("GET", "/trace/(?P<tid>[^/]+)")
    def trace_waterfall(req: Request) -> Response:
        # the assembled cross-process view the Recent-traces rows link to:
        # local fragments + every configured daemon's /spans.json, merged
        # into per-process lanes (dead daemons cost their fragments only)
        tid = req.params["tid"]
        try:
            # short per-source timeout: this blocks a dashboard serving
            # thread, and fetches run concurrently, so a dead daemon in
            # trace_sources costs one bounded wait — not 10 s per corpse
            tl = collect_trace(
                tid,
                urls=trace_sources,
                include_local=True,
                access_key=access_key,
                timeout=3.0,
            )
        except TraceAssemblyError as e:
            return error_response(404, str(e))
        if req.query.get("format") == "perfetto":
            return Response(
                200,
                json.dumps(tl.to_chrome_trace()),
                content_type="application/json",
            )
        return Response(
            200,
            "<html><head><title>Trace "
            f"{html.escape(tid)}</title></head><body>"
            + _waterfall_html(tl, access_key=access_key)
            + "</body></html>",
        )

    @app.route("GET", "/engine_instances/(?P<iid>[^/]+)")
    def detail(req: Request) -> Response:
        inst = storage.evaluation_instances().get(req.params["iid"])
        if inst is None:
            return error_response(404, "Not Found")
        return Response(
            200,
            f"<html><body><h1>Evaluation {html.escape(inst.id)}</h1>"
            f"{inst.evaluator_results_html or '<p>(no results)</p>'}"
            "</body></html>",
        )

    @app.route("GET", "/engine_instances/(?P<iid>[^/]+)/evaluator_results\\.json")
    def detail_json(req: Request) -> Response:
        inst = storage.evaluation_instances().get(req.params["iid"])
        if inst is None:
            return error_response(404, "Not Found")
        return Response(
            200, inst.evaluator_results_json or "{}", content_type="application/json"
        )

    return app


def create_dashboard_server(
    host: str = "0.0.0.0",
    port: int = 9000,
    storage: StorageRuntime | None = None,
    access_key: str | None = None,
    ssl_certfile: str | None = None,
    ssl_keyfile: str | None = None,
) -> AppServer:
    return AppServer(
        create_dashboard_app(storage, access_key=access_key),
        host,
        port,
        ssl_certfile=ssl_certfile,
        ssl_keyfile=ssl_keyfile,
    )
