"""The port's per-app cost ledger (``obs/costs.py``) held to the JAX
package's, on the CPU.

The cases of the JAX package's ``tests/test_costs.py`` that do not need
the fleet run on both packages (``pkg`` is ``jax`` or ``port``): the
request-scoped record, the wave shares, conservation under 16 billing
threads, persistence (roll, reload, schema mismatch, a SIGKILLed biller
losing at most the open window), the ``costs.*`` alert selectors, the
freshness lag and its rule, and the snapshot and its text.  Then, exact
across the packages: the same bill sequence under one frozen clock gives
the same ``/costs.json`` body and the same ``costs`` text.  Last, the
port's own hooks: the parquet log bills its scans on the thread that
asked (a request record, else the open wave timeline, never a pool
thread), and the batcher's meta carries ``wave_storage_bytes``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

from predictionio_tpu.data import event as j_event
from predictionio_tpu.data.storage import compactor as j_compactor
from predictionio_tpu.data.storage import parquet_backend as j_parquet
from predictionio_tpu.obs import alerts as j_alerts
from predictionio_tpu.obs import costs as j_costs
from predictionio_tpu.obs import metrics as j_metrics
from predictionio_tpu_torch.data import event as p_event
from predictionio_tpu_torch.data.storage import compactor as p_compactor
from predictionio_tpu_torch.data.storage import parquet_backend as p_parquet
from predictionio_tpu_torch.obs import alerts as p_alerts
from predictionio_tpu_torch.obs import costs as p_costs
from predictionio_tpu_torch.obs import device as p_device
from predictionio_tpu_torch.obs import metrics as p_metrics

torch.set_num_threads(2)

REPO_ROOT = Path(__file__).resolve().parents[1]

PKGS = {
    "jax": types.SimpleNamespace(
        name="predictionio_tpu", costs=j_costs, alerts=j_alerts,
        metrics=j_metrics, parquet=j_parquet, compactor=j_compactor,
        event=j_event,
    ),
    "port": types.SimpleNamespace(
        name="predictionio_tpu_torch", costs=p_costs, alerts=p_alerts,
        metrics=p_metrics, parquet=p_parquet, compactor=p_compactor,
        event=p_event,
    ),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def ledger(pkg, **kw):
    kw.setdefault("registry", pkg.metrics.MetricsRegistry())
    return pkg.costs.CostLedger(**kw)


# ---------------------------------------------------------------------------
# the request-scoped record


def test_context_bills_on_exit(pkg):
    led = ledger(pkg)
    with pkg.costs.request_cost("app:a", "/queries.json", "v1", ledger=led) as rec:
        rec.add(device_s=0.25, storage_bytes=100.0)
        assert pkg.costs.current_cost() is rec
    assert pkg.costs.current_cost() is None
    row = led.snapshot()["totals"][0]
    assert (row["app"], row["route"], row["variant"]) == ("app:a", "/queries.json", "v1")
    assert row["requests"] == 1.0
    assert row["device_s"] == pytest.approx(0.25)
    assert row["storage_bytes"] == pytest.approx(100.0)


def test_bills_when_the_handler_raises_and_notes_storage(pkg):
    led = ledger(pkg)
    with pytest.raises(RuntimeError):
        with pkg.costs.request_cost("a", "/r", ledger=led) as rec:
            rec.add(device_s=0.1)
            raise RuntimeError("handler blew up")
    led2 = ledger(pkg)
    with pkg.costs.request_cost("a", "/r", ledger=led2):
        pkg.costs.note_storage_read(4096)
        pkg.costs.note_storage_read(1024)
    pkg.costs.note_storage_read(1 << 30)  # no scope: a no-op
    assert led.snapshot()["totals"][0]["device_s"] == pytest.approx(0.1)
    assert led2.snapshot()["totals"][0]["storage_bytes"] == pytest.approx(5120.0)
    with pytest.raises(ValueError):
        pkg.costs.RequestCost("a", "/r").add(gpu_seconds=1.0)


def test_prorated_wave_shares_sum_to_wave_totals(pkg):
    meta = {"wave_size": 4, "device_s": 0.4, "wave_flops": 400.0,
            "wave_bytes": 800.0, "wave_storage_bytes": 4000.0,
            "queue_wait_s": 0.01}
    share = pkg.costs.prorated_from_meta(meta)
    assert share["device_s"] == pytest.approx(0.1)
    assert share["flops"] == pytest.approx(100.0)
    assert share["hbm_bytes"] == pytest.approx(200.0)
    assert share["storage_bytes"] == pytest.approx(1000.0)
    assert share["queue_s"] == pytest.approx(0.01)
    led = ledger(pkg)
    for _ in range(4):
        led.bill_meta("a", "/q", "v", meta)
    led.bill_meta("a", "/q", "v", meta, queue_only=True)
    row = led.snapshot()["totals"][0]
    assert row["device_s"] == pytest.approx(0.4)
    assert row["requests"] == 5.0 and row["queue_s"] == pytest.approx(0.05)


def test_16_thread_sums_match_the_registry(pkg):
    reg = pkg.metrics.MetricsRegistry()
    led = pkg.costs.CostLedger(window_s=0.02, retention=100_000, registry=reg)
    apps = [f"app:{i}" for i in range(4)]

    def worker(tid: int) -> None:
        for _ in range(200):
            led.bill_values(apps[tid % 4], "/queries.json", "default",
                            requests=1.0, device_s=0.001, storage_bytes=10.0)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    per_app = {a: [0.0, 0.0] for a in apps}
    for row in led.snapshot()["totals"]:
        per_app[row["app"]][0] += row["device_s"]
        per_app[row["app"]][1] += row["requests"]
    counter = {a: 0.0 for a in apps}
    for labels, c in reg.get("pio_cost_device_seconds_total").series():
        counter[labels[0]] += c.value
    for a in apps:
        assert per_app[a][1] == pytest.approx(800)
        assert per_app[a][0] == pytest.approx(0.8, rel=0.01)
        assert per_app[a][0] == pytest.approx(counter[a], rel=0.01)


# ---------------------------------------------------------------------------
# persistence


def test_roll_persists_reloads_and_refuses_another_schema(pkg, tmp_path):
    path = str(tmp_path / "costs.json")
    clock = Clock()
    led = ledger(pkg, window_s=60.0, path=path, clock=clock)
    led.bill_values("a", "/r", requests=1.0, device_s=0.5)
    clock.advance(61.0)
    led.roll()
    doc = json.loads(Path(path).read_text())
    assert doc["schema"] == 1 and len(doc["closed"]) == 1
    assert ledger(pkg, window_s=60.0, path=path).snapshot()["totals"][0][
        "device_s"] == pytest.approx(0.5)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 999, "closed": [{"rows": []}]}))
    assert ledger(pkg, path=str(bad)).snapshot()["windows"] == []


def test_a_ledger_file_reads_in_the_other_package(tmp_path):
    path = str(tmp_path / "costs.json")
    clock = Clock()
    led = ledger(PKGS["port"], window_s=60.0, path=path, clock=clock)
    led.bill_values("app:1", "/queries.json", "default", requests=2.0,
                    device_s=0.25, storage_bytes=64.0)
    clock.advance(61.0)
    led.roll()
    totals = [ledger(p, window_s=60.0, path=path).snapshot()["totals"]
              for p in PKGS.values()]
    assert totals[0] == totals[1] and totals[0][0]["storage_bytes"] == 64.0


def test_sigkill_loses_at_most_the_open_window(pkg, tmp_path):
    path = str(tmp_path / "costs.json")
    child = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO_ROOT)!r})\n"
        f"from {pkg.name}.obs.costs import CostLedger\n"
        f"led = CostLedger(window_s=60.0, path={path!r})\n"
        "for i in range(5):\n"
        "    led.bill_values('app:durable', '/events.json', 'ingest',\n"
        "                    requests=1.0, device_s=0.01, storage_bytes=100.0)\n"
        "led.roll(now=time.time() + 120.0)\n"
        "led.bill_values('app:doomed', '/events.json', 'ingest',\n"
        "                requests=1.0, device_s=9.9)\n"
        "print('READY', flush=True)\n"
        "time.sleep(120)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", child], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        text=True,
    )
    try:
        assert proc.stdout.readline().strip() == "READY"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    by_app = {r["app"]: r for r in ledger(pkg, window_s=60.0, path=path)
              .snapshot()["totals"]}
    assert by_app["app:durable"]["requests"] == pytest.approx(5.0)
    assert by_app["app:durable"]["storage_bytes"] == pytest.approx(500.0)
    assert "app:doomed" not in by_app


# ---------------------------------------------------------------------------
# the costs.* alert selectors


def test_cost_skew_fires_exactly_once_for_the_noisy_app(pkg):
    clock = Clock()
    reg = pkg.metrics.MetricsRegistry()
    led = pkg.costs.CostLedger(window_s=3600.0, registry=reg, clock=clock)
    led.bill_values("app:noisy", "/queries.json", requests=90.0, device_s=0.9)
    led.bill_values("app:quiet", "/queries.json", requests=10.0, device_s=0.1)
    rule = [r for r in pkg.alerts.default_rule_pack() if r.name == "cost_skew"]
    ev = pkg.alerts.AlertEvaluator(
        registry=reg, rules=rule, app=types.SimpleNamespace(costs=led),
        clock=clock)
    assert ev.tick()["pending"] == 1
    clock.advance(11.0)
    assert ev.tick()["firing"] == 1
    fired = [a for a in ev.snapshot()["alerts"] if a["state"] == "firing"]
    assert len(fired) == 1 and "app:noisy" in fired[0]["key"]
    for _ in range(5):
        clock.advance(5.0)
        assert ev.tick()["firing"] == 1
    assert sum(c.value for lv, c in reg.get(
        "pio_alerts_transitions_total").series() if lv[1] == "firing") == 1


def test_device_share_and_burn_vs_budget(pkg):
    led = ledger(pkg)
    led.bill_values("only-app", "/r", requests=1.0, device_s=5.0)
    assert led.signal("device_share") == {}
    clock = Clock()
    led = ledger(pkg, window_s=60.0, budgets={"app:hot": 1.0},
                 default_budget=None, clock=clock)
    clock.advance(30.0)
    led.bill_values("app:hot", "/r", requests=1.0, device_s=1.0)
    led.bill_values("app:unbudgeted", "/r", requests=1.0, device_s=9.0)
    sig = led.signal("burn_vs_budget")
    assert sig["app:hot"] == pytest.approx(2.0)
    assert "app:unbudgeted" not in sig
    reg = pkg.metrics.MetricsRegistry()
    led = pkg.costs.CostLedger(window_s=3600.0, budgets={"a": 0.001},
                               default_budget=None, registry=reg, clock=clock)
    clock.advance(60.0)
    led.bill_values("a", "/r", requests=1.0, device_s=10.0)
    ev = pkg.alerts.AlertEvaluator(
        registry=reg, rules=[pkg.alerts.AlertRule(
            "cost_burn", "costs.burn_vs_budget", 1.0)],
        app=types.SimpleNamespace(costs=led), clock=clock)
    assert ev.tick()["firing"] == 1


def test_budgets_from_env(pkg):
    budgets, default = pkg.costs.budgets_from_env({
        "PIO_COST_BUDGETS": '{"a": 2, "b": 0.5}',
        "PIO_COST_BUDGET_DEVICE_S_PER_MIN": "3"})
    assert budgets == {"a": 2.0, "b": 0.5} and default == 3.0
    with pytest.raises(ValueError):
        pkg.costs.budgets_from_env({"PIO_COST_BUDGETS": "[1]"})


# ---------------------------------------------------------------------------
# event-to-visible freshness


def test_compaction_observes_row_weighted_visibility_lag(pkg, tmp_path):
    h = pkg.parquet._metrics()["visibility_lag"]
    before = h.count
    store = pkg.parquet.ParquetEventStore(pkg.parquet.ParquetClient(tmp_path / "ev"))
    store.append_events([
        pkg.event.Event(event="rate", entity_type="user", entity_id=str(i),
                        target_entity_type="item", target_entity_id="1",
                        properties={"rating": 4.0})
        for i in range(40)], 1, None)
    store.compact(1)
    assert h.count - before >= 40
    assert 0.0 < pkg.parquet._metrics()["visibility_lag_p99"].value < 60.0
    st = pkg.compactor.Compactor(store.client, pkg.compactor.CompactionPolicy()).status()
    assert st["visibility"]["rows_observed"] >= 1


def test_freshness_lag_alert_fires_under_stall_and_clears(pkg):
    rules = [r for r in pkg.alerts.default_rule_pack() if r.name == "freshness_lag"]
    clock = Clock()
    reg = pkg.metrics.MetricsRegistry()
    g = reg.gauge("pio_event_visibility_lag_p99_seconds", "p99 visibility lag")
    ev = pkg.alerts.AlertEvaluator(registry=reg, rules=rules, clock=clock)
    g.set(5.0)
    assert ev.tick()["firing"] == 0
    g.set(300.0)
    ev.tick()
    clock.advance(16.0)
    assert ev.tick()["firing"] == 1
    g.set(55.0)
    clock.advance(5.0)
    assert ev.tick()["firing"] == 1
    g.set(5.0)
    clock.advance(5.0)
    assert ev.tick()["firing"] == 0


# ---------------------------------------------------------------------------
# the snapshot and its text


def test_windows_param_limits_closed_windows(pkg):
    clock = Clock()
    led = ledger(pkg, window_s=10.0, clock=clock)
    for _ in range(3):
        led.bill_values("a", "/r", requests=1.0, device_s=0.1)
        clock.advance(11.0)
    snap = led.snapshot(windows=1)
    assert len(snap["windows"]) == 1
    assert snap["totals"][0]["requests"] == pytest.approx(1.0)
    assert led.snapshot()["totals"][0]["requests"] == pytest.approx(3.0)


def test_render_and_registry_mirror(pkg):
    reg = pkg.metrics.MetricsRegistry()
    led = pkg.costs.CostLedger(registry=reg)
    led.bill_values("app:a", "/queries.json", "default", requests=3.0,
                    device_s=0.5, storage_bytes=2048.0)
    text = pkg.costs.render_costs_text(led.snapshot())
    assert "app:a" in text and "/queries.json" in text and "2.0KiB" in text
    for field, metric in (
        ("requests", "pio_cost_requests_total"),
        ("device_s", "pio_cost_device_seconds_total"),
        ("flops", "pio_cost_flops_total"),
        ("hbm_bytes", "pio_cost_hbm_bytes_total"),
        ("storage_bytes", "pio_cost_storage_bytes_total"),
        ("queue_s", "pio_cost_queue_seconds_total"),
        ("sheds", "pio_cost_sheds_total"),
    ):
        assert field in pkg.costs.COST_FIELDS and reg.get(metric) is not None


def _billed(pkg):
    """One bill sequence under a frozen clock, through three windows."""
    clock = Clock()
    led = ledger(pkg, window_s=30.0, budgets={"app:1": 0.5},
                 default_budget=2.0, clock=clock)
    for step in range(9):
        led.bill_meta("app:1", "/queries.json", "default", {
            "wave_size": 3, "device_s": 0.012 * (step + 1), "wave_flops": 9e6,
            "wave_bytes": 4.5e5, "wave_storage_bytes": 3072.0,
            "queue_wait_s": 0.001 * step, "cache_hits": 3})
        led.bill_meta("app:2", "/queries.json", "canary", {
            "wave_size": 1, "device_s": 0.002, "queue_wait_s": 0.0005},
            queue_only=step % 3 == 0)
        if step % 4 == 0:
            led.note_shed("app:2", "/queries.json")
        clock.advance(11.0)
    snap = led.snapshot()
    snap.pop("generated_at")
    return snap, pkg.costs.render_costs_text(led.snapshot(windows=2)), {
        k: led.signal(k) for k in ("burn_vs_budget", "device_share")}


def test_same_bills_give_the_same_body_text_and_signals():
    got = {name: _billed(p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    snap = got["port"][0]
    assert len(snap["windows"]) == 3 and snap["totals"][0]["app"] == "app:1"


# ---------------------------------------------------------------------------
# the port's hooks: the parquet log's scans and the wave meta


def _port_store(tmp_path):
    store = p_parquet.ParquetEventStore(p_parquet.ParquetClient(tmp_path / "ev",
                                                                n_shards=4))
    store.append_events([
        p_event.Event(event="rate", entity_type="user", entity_id=f"u{i}",
                      target_entity_type="item", target_entity_id=f"i{i % 7}",
                      properties={"rating": float(i % 5)})
        for i in range(64)], 1, None)
    return store


def test_parquet_scans_bill_the_calling_request(tmp_path):
    store = _port_store(tmp_path)
    pevents = p_parquet.ParquetPEvents(store.client)
    read = p_parquet._metrics()["bytes_read"]
    led = ledger(PKGS["port"])
    before = sum(c.value for _, c in read.series())
    with p_costs.request_cost("app:1", "/scan", ledger=led):
        frame = pevents.find(1)
    scanned = sum(c.value for _, c in read.series()) - before
    assert len(frame.event) == 64 and scanned > 0
    assert led.snapshot()["totals"][0]["storage_bytes"] == pytest.approx(scanned)
    # the entity path (the serving read) bills too
    levents = p_parquet.ParquetLEvents(store.client)
    before = sum(c.value for _, c in read.series())
    with p_costs.request_cost("app:1", "/entity", ledger=led):
        got = list(levents.find(1, filter=p_parquet.EventFilter(
            entity_type="user", entity_id="u3")))
    assert len(got) == 1
    rows = {r["route"]: r for r in led.snapshot()["totals"]}
    assert rows["/entity"]["storage_bytes"] == pytest.approx(
        sum(c.value for _, c in read.series()) - before)


def test_parquet_scans_inside_a_wave_land_in_its_meta(tmp_path):
    """A scan on the batcher's thread bills the open wave timeline, and
    the compaction's folds on the client pool bill nobody."""
    from predictionio_tpu_torch.server.microbatch import MicroBatcher

    store = _port_store(tmp_path)
    pevents = p_parquet.ParquetPEvents(store.client)

    def batch_fn(items):
        pevents.find(1)
        return [f"r{i}" for i in items]

    import asyncio

    async def run():
        mb = MicroBatcher(batch_fn, max_batch=8, registry=p_metrics.MetricsRegistry(),
                          max_inflight_waves=0)
        try:
            meta: dict = {}
            out = await mb.submit(1, meta)
            return out, meta
        finally:
            mb.close()

    out, meta = asyncio.run(run())
    assert out == "r1" and meta["wave_storage_bytes"] > 0
    share = p_costs.prorated_from_meta(meta)
    assert share["storage_bytes"] == pytest.approx(meta["wave_storage_bytes"])
    with p_device.wave_timeline() as tl:
        store.compact(1)
    assert tl.storage_bytes == 0.0
