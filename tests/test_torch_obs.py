"""The port's stdlib observability modules against the JAX package's.

For each module that the port carries as its own copy (metrics exposition,
logging, tracing, disttrace, flight, slo, contention, hotpath, capacity,
provenance, sampling), the same inputs go to the JAX module and to the
port's, and the outputs must be equal: the Prometheus text byte for byte
for one sequence of observations, the JSON exposition and window algebra,
and the SLO, capacity and hot-path snapshots under an injected clock.
Random ids (span ids, process labels) are the only fields normalized, and
the speedscope export's ``exporter`` names its package.

The sampler's overhead check is the port's copy of the JAX package's
acceptance test (a micro-batched deploy under concurrent load from a
client process), run in a serving process of its own and bounded by the
sampler thread's own CPU time per pass (``time.thread_time``), the median
over every pass in units of a reference work timed beside it, so the
check does not move with the load on a shared host.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from predictionio_tpu.obs import capacity as jax_capacity
from predictionio_tpu.obs import contention as jax_contention
from predictionio_tpu.obs import disttrace as jax_disttrace
from predictionio_tpu.obs import flight as jax_flight
from predictionio_tpu.obs import hotpath as jax_hotpath
from predictionio_tpu.obs import logging as jax_logging
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import provenance as jax_provenance
from predictionio_tpu.obs import sampling as jax_sampling
from predictionio_tpu.obs import slo as jax_slo
from predictionio_tpu.obs import tracing as jax_tracing
from predictionio_tpu_torch.obs import capacity as pt_capacity
from predictionio_tpu_torch.obs import contention as pt_contention
from predictionio_tpu_torch.obs import disttrace as pt_disttrace
from predictionio_tpu_torch.obs import flight as pt_flight
from predictionio_tpu_torch.obs import hotpath as pt_hotpath
from predictionio_tpu_torch.obs import logging as pt_logging
from predictionio_tpu_torch.obs import metrics as pt_metrics
from predictionio_tpu_torch.obs import provenance as pt_provenance
from predictionio_tpu_torch.obs import sampling as pt_sampling
from predictionio_tpu_torch.obs import slo as pt_slo
from predictionio_tpu_torch.obs import tracing as pt_tracing

torch.set_num_threads(2)

TIMEOUT = 10


class FakeClock:
    """One monotonic clock both packages read (time.perf_counter/time.time
    and the SLO module's _now are patched to it)."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(time, "perf_counter", c)
    monkeypatch.setattr(time, "time", c)
    monkeypatch.setattr(time, "monotonic", c)
    return c


# ---------------------------------------------------------------------------
# metrics


def _observations(seed: int):
    """One seeded sequence of registry operations: (kind, name, labels,
    value, n) with counters, gauges and histograms on every bucket set."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(400):
        kind = rng.choice(["counter", "gauge", "histogram", "many"])
        lab = str(rng.choice(["a", "b", 'q"uo\\te', "new\nline"]))
        if kind == "counter":
            ops.append(("counter", "pio_c_total", (lab,), float(rng.integers(1, 5)), 1))
        elif kind == "gauge":
            ops.append(("gauge", "pio_g", (lab,), float(rng.normal()), 1))
        else:
            v = float(10.0 ** rng.uniform(-6, 4))
            n = int(rng.integers(1, 9)) if kind == "many" else 1
            ops.append(("histogram", "pio_h_seconds", (lab,), v, n))
    return ops


def _apply(mod, reg, ops):
    c = reg.counter("pio_c_total", "a counter", labelnames=("k",))
    g = reg.gauge("pio_g", "a gauge", labelnames=("k",))
    h = reg.histogram("pio_h_seconds", "latency", labelnames=("k",))
    hs = reg.histogram("pio_size", "sizes", buckets=mod.SIZE_BUCKETS)
    hst = reg.histogram("pio_stage", "stages", buckets=mod.STAGE_BUCKETS)
    ht = reg.histogram("pio_train", "train", buckets=mod.TRAIN_BUCKETS)
    plain = reg.counter("pio_plain_total", "no labels")
    for kind, _, labels, value, n in ops:
        if kind == "counter":
            c.labels(*labels).inc(value)
            plain.inc()
        elif kind == "gauge":
            g.labels(*labels).set(value)
        else:
            if n == 1:
                h.labels(*labels).observe(value)
            else:
                h.labels(*labels).observe_many(value, n)
            hs.observe(value * 100)
            hst.observe(value)
            ht.observe(value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_is_byte_equal(seed):
    ops = _observations(seed)
    regs = []
    for mod in (jax_metrics, pt_metrics):
        reg = mod.MetricsRegistry()
        _apply(mod, reg, ops)
        regs.append(reg)
    jr, pr = regs
    assert pr.render_prometheus() == jr.render_prometheus()
    assert pr.render_prometheus().encode() == jr.render_prometheus().encode()
    assert pr.render_json() == jr.render_json()
    assert pr.histogram_quantiles("pio_h_seconds") == jr.histogram_quantiles(
        "pio_h_seconds"
    )
    assert pt_metrics.render_json_line(pr, ["pio_h_seconds", "pio_size"]) == (
        jax_metrics.render_json_line(jr, ["pio_h_seconds", "pio_size"])
    )


def test_bucket_bounds_and_quantiles_equal():
    for name in ("LATENCY_BUCKETS", "SIZE_BUCKETS", "STAGE_BUCKETS", "TRAIN_BUCKETS"):
        assert getattr(pt_metrics, name) == getattr(jax_metrics, name), name
    rng = np.random.default_rng(5)
    bounds = pt_metrics.LATENCY_BUCKETS
    for _ in range(50):
        counts = [int(x) for x in rng.integers(0, 20, len(bounds) + 1)]
        total = sum(counts)
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert pt_metrics.quantile_from_buckets(bounds, counts, total, q) == (
                jax_metrics.quantile_from_buckets(bounds, counts, total, q)
            )
    h_pt, h_jax = pt_metrics.Histogram(), jax_metrics.Histogram()
    for v in rng.uniform(0, 0.1, 300):
        h_pt.observe(float(v))
        h_jax.observe(float(v))
    assert h_pt.snapshot() == h_jax.snapshot()
    assert h_pt.quantile(0.9) == h_jax.quantile(0.9)


def test_window_algebra_and_history_equal(monkeypatch):
    ops = _observations(7)
    outs = []
    for mod in (jax_metrics, pt_metrics):
        monkeypatch.setenv("PIO_METRICS_HISTORY_DEPTH", "5")
        assert mod.history_depth_from_env() == 5
        monkeypatch.setenv("PIO_METRICS_HISTORY_DEPTH", "five")
        assert mod.history_depth_from_env() == 60
        reg = mod.MetricsRegistry()
        hist = mod.MetricsHistory(depth=4)
        _apply(mod, reg, ops[:200])
        base = reg.delta_snapshot()
        hist.sample(reg)
        _apply(mod, reg, ops[200:])
        hist.sample(reg)
        delta = reg.delta_snapshot(base)
        sub = mod.subtract_snapshots(reg.render_json(), base)
        outs.append((delta, sub, hist.snapshot(), hist.items("pio_g"),
                     hist.series("pio_g", ("a",))))
    assert outs[0] == outs[1]


def test_registry_guards_equal():
    for mod in (jax_metrics, pt_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("pio_x_total", "x", labelnames=("a",))
        with pytest.raises(ValueError):
            reg.gauge("pio_x_total", "x", labelnames=("a",))
        reg.histogram("pio_y", "y")
        with pytest.raises(ValueError):
            reg.histogram("pio_y", "y", buckets=mod.SIZE_BUCKETS)
        with pytest.raises(ValueError):
            reg.counter("pio_x_total", "x", labelnames=("a",)).labels("1", "2")
        with pytest.raises(ValueError):
            reg.counter("pio_z_total").inc(-1)


# ---------------------------------------------------------------------------
# logging


def test_json_line_formatter_and_record_fields_equal():
    rec = logging.LogRecord("predictionio_tpu_torch.x", logging.WARNING, "f.py",
                            3, "hello %s", ("world",), None)
    rec.wave_size = 4
    rec.request_ids = ["r1", "r2"]
    outs = []
    for mod in (jax_logging, pt_logging):
        tokens = mod.set_request_context("rid-1", "trace-1")
        try:
            outs.append((mod.JsonLineFormatter().format(rec), mod.record_fields(rec)))
        finally:
            mod.reset_request_context(tokens)
        assert mod.get_request_id() is None
    assert outs[0] == outs[1]
    assert pt_logging.REQUEST_ID_HEADER == jax_logging.REQUEST_ID_HEADER
    rid = pt_logging.new_request_id()
    assert len(rid) == 16 and int(rid, 16) >= 0


def test_log_ring_filters_equal():
    records = []
    for i in range(30):
        r = logging.LogRecord("n", [logging.DEBUG, logging.INFO, logging.ERROR][i % 3],
                              "f.py", i, f"m{i}", (), None)
        records.append(r)
    outs = []
    for mod in (jax_logging, pt_logging):
        ring = mod.LogRing(maxlen=16)
        for i, r in enumerate(records):
            tokens = mod.set_request_context(f"r{i % 4}")
            try:
                ring.emit(r)
            finally:
                mod.reset_request_context(tokens)
        ring.append_fields({"ts": 1.0, "level": "DEBUG", "message": "wave",
                            "request_ids": ["r1", "zz"]})
        outs.append([
            ring.records(limit=100),
            ring.records(limit=5, request_id="r1"),
            ring.records(request_id="zz"),
            ring.records(min_level="info"),
            ring.records(limit=-1),
        ])
    assert outs[0] == outs[1]


def test_ring_debug_reaches_the_ring_in_both():
    outs = []
    for mod, name in ((jax_logging, "predictionio_tpu.t"),
                      (pt_logging, "predictionio_tpu_torch.t")):
        ring = mod.ensure_ring()
        tokens = mod.set_request_context("rid-9")
        try:
            mod.ring_debug(logging.getLogger(name), "wave", wave_size=3,
                           request_ids=["rid-9", "rid-8"])
        finally:
            mod.reset_request_context(tokens)
        got = ring.records(limit=1, request_id="rid-8")[0]
        got.pop("ts")
        got.pop("logger")
        outs.append(got)
    assert outs[0] == outs[1] == {
        "level": "DEBUG", "message": "wave", "request_id": "rid-9",
        "wave_size": 3, "request_ids": ["rid-9", "rid-8"],
    }


# ---------------------------------------------------------------------------
# tracing + disttrace


def _span_tree(mod, disttrace, clock, reg, fail: bool):
    tokens = None
    log_mod = jax_logging if mod is jax_tracing else pt_logging
    tokens = log_mod.set_request_context("req-1", "trace-1")
    ptoken = disttrace.bind_parent_span("parent-span")
    try:
        with mod.trace("root", registry=reg) as root:
            clock.advance(0.001)
            with mod.trace("child.a", registry=reg):
                clock.advance(0.002)
                with mod.trace("grand", registry=reg, record=False):
                    clock.advance(0.0005)
            with mod.trace("child.a", registry=reg):
                clock.advance(0.004)
            try:
                with mod.trace("child.b", registry=reg):
                    clock.advance(0.01)
                    if fail:
                        raise KeyError("boom")
            except KeyError:
                pass
            root.tags = {"route": "/q", "status": 200}
    finally:
        disttrace.reset_parent_span(ptoken)
        log_mod.reset_request_context(tokens)
    return root


def _norm_fragments(frags):
    ids = {}
    out = []
    for f in sorted(frags, key=lambda f: (f["start_ts"], f["name"])):
        f = dict(f)
        for key in ("span_id", "parent_id"):
            if key in f:
                f[key] = ids.setdefault(f[key], f"id{len(ids)}")
        f.pop("process")
        out.append(f)
    return out


@pytest.mark.parametrize("fail", [False, True])
def test_span_trees_equal(clock, fail):
    outs = []
    for mod, dt in ((jax_tracing, jax_disttrace), (pt_tracing, pt_disttrace)):
        reg = (jax_metrics if mod is jax_tracing else pt_metrics).MetricsRegistry()
        store = dt.FragmentStore()
        mod.clear_traces()
        clock.t = 1000.0
        root = _span_tree(mod, dt, clock, reg, fail)
        dt.collect(root, store=store)
        outs.append((
            root.to_dict(),
            root.breakdown(),
            mod.recent_traces(5),
            reg.render_prometheus(),
            _norm_fragments(store.fragments("trace-1")),
            store.trace_ids(),
        ))
    assert outs[0] == outs[1]


def test_trace_context_propagation_equal():
    cases = [
        {}, {"X-Pio-Trace-Id": "t1"}, {"x-pio-trace-id": "t2", "x-pio-parent-span": "p"},
        {"X-Pio-Trace-Id": "x" * 100, "X-Pio-Parent-Span": "y" * 100},
        {"X-Pio-Trace-Id": "  ", "X-Pio-Parent-Span": "ok"},
    ]
    for h in cases:
        assert pt_disttrace.adopt_trace_context(h, "rid") == (
            jax_disttrace.adopt_trace_context(h, "rid")
        )
    assert (pt_disttrace.TRACE_ID_HEADER, pt_disttrace.PARENT_SPAN_HEADER) == (
        jax_disttrace.TRACE_ID_HEADER, jax_disttrace.PARENT_SPAN_HEADER
    )
    outs = []
    for dt, lg, tr in ((jax_disttrace, jax_logging, jax_tracing),
                       (pt_disttrace, pt_logging, pt_tracing)):
        assert dt.current_trace_context() == (None, None)
        tokens = lg.set_request_context("r", "t")
        ptoken = dt.bind_parent_span("caller")
        try:
            outside = dt.current_trace_context()
            with tr.trace("s", record=False) as sp:
                tid, sid = dt.current_trace_context()
                outs.append((outside, tid, sid == sp.span_id,
                             sp.parent_id, dt.get_parent_span()))
        finally:
            dt.reset_parent_span(ptoken)
            lg.reset_request_context(tokens)
    assert outs[0] == outs[1] == (("t", "caller"), "t", True, "caller", "caller")


def test_wave_events_and_fragment_store_equal(clock):
    meta = {
        "wave_t0": 5000.0, "wave_seq": 3, "wave_size": 600,
        "wave_device": "cuda:0",
        "device_breakdown": {"host_gather": 0.001, "h2d": 0.0002,
                             "compute": 0.003, "d2h": 0.0004, "other": 0.0001},
    }
    bare = {"wave_t0": 6000.0, "wave_seq": 4, "wave_size": 1,
            "device_breakdown": {"other": 0.002}}
    outs = []
    for dt, lg in ((jax_disttrace, jax_logging), (pt_disttrace, pt_logging)):
        store = dt.FragmentStore(max_traces=2, max_spans_per_trace=3)
        tokens = lg.set_request_context("r", "tr")
        try:
            dt.note_wave_events(meta, parent=SimpleNamespace(span_id="P"), store=store)
            dt.note_wave_events(bare, store=store)
            dt.note_wave_events(None, store=store)
            dt.record_fragment("x", 1.0, 0.5, trace_id="other", store=store,
                               track="t", tags={"a": 1, "b": None}, error="e")
            dt.record_fragment("y", 1.0, 0.5, trace_id="third", store=store)
        finally:
            lg.reset_request_context(tokens)
        snap = store.snapshot()
        snap.pop("process")
        snap.pop("pid")
        outs.append((_norm_fragments(store.fragments("tr")),
                     _norm_fragments(store.fragments("other")),
                     store.trace_ids(), snap))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# flight recorder


def test_flight_recorder_equal(clock):
    rng = np.random.default_rng(3)
    entries = []
    for i in range(120):
        status = int(rng.choice([200, 200, 200, 400, 500, 503]))
        entries.append({
            "request_id": f"r{i}", "trace_id": f"t{i % 7}", "status": status,
            "duration_s": float(rng.uniform(0, 1)), "time": 1.0,
            **({"error": "x"} if i % 17 == 0 else {}),
        })
    outs = []
    for mod in (jax_flight, pt_flight):
        fr = mod.FlightRecorder(keep_slowest=8, keep_errors=5)
        for e in entries:
            fr.record(dict(e))
        outs.append([
            fr.snapshot(), fr.snapshot(request_id="r3"),
            fr.snapshot(trace_id="t2", limit=2), fr.would_retain(0.5),
            fr.would_retain(2.0),
        ])
        token = mod.begin_annotations()
        try:
            mod.annotate(a=1)
            mod.annotate(b=[1, 2], a=3)
            outs[-1].append(mod.current_annotations())
        finally:
            mod.end_annotations(token)
        mod.annotate(ignored=True)  # no scope: a no-op
        outs[-1].append(mod.current_annotations())
        fr.clear()
        outs[-1].append(fr.snapshot())
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# SLO + readiness


def test_slo_snapshots_equal_under_an_injected_clock(clock, monkeypatch):
    rng = np.random.default_rng(4)
    events = [
        (bool(rng.random() > 0.05), float(rng.exponential(0.2)),
         float(rng.uniform(0, 15)))
        for _ in range(500)
    ]
    outs = []
    for mod in (jax_slo, pt_slo):
        monkeypatch.setattr(mod, "_now", clock)
        clock.t = 1000.0
        tr = mod.SLOTracker(window_s=120, bucket_s=10, latency_threshold_s=0.3)
        snaps = []
        for i, (ok, dur, dt) in enumerate(events):
            tr.record(ok, dur, trace_id=f"t{i}" if i % 3 else None,
                      request_id=f"r{i}")
            clock.advance(dt / 10)
            if i % 100 == 99:
                snaps.append(tr.snapshot())
        clock.advance(500)  # the window ages out
        snaps.append(tr.snapshot())
        snaps.append(tr.healthz())
        outs.append(snaps)
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        pt_slo.SLOTracker(window_s=1, bucket_s=10)


def test_readiness_equal():
    def boom():
        raise RuntimeError("down")

    checks = {"a": lambda: True, "b": lambda: 0, "c": boom}
    assert pt_slo.run_readiness(checks) == jax_slo.run_readiness(checks)
    assert pt_slo.run_readiness({}) == jax_slo.run_readiness({}) == (True, {})


# ---------------------------------------------------------------------------
# contention


def test_lock_witness_and_metering_equal():
    outs = []
    for mod, mmod in ((jax_contention, jax_metrics), (pt_contention, pt_metrics)):
        w = mod.enable_witness()
        try:
            reg = mmod.MetricsRegistry()
            a = mod.ContendedLock("a", registry=reg)
            b = mod.ContendedLock("b", registry=reg)
            r = mod.ContendedLock("r", registry=reg, reentrant=True)
            with a:
                with b:
                    with r:
                        with r:
                            pass
            with b:
                with a:  # the inversion
                    pass
            # one genuinely contended acquisition
            held = threading.Event()
            release = threading.Event()

            def holder():
                with a:
                    held.set()
                    release.wait(TIMEOUT)

            t = threading.Thread(target=holder, daemon=True)
            t.start()
            held.wait(TIMEOUT)
            threading.Timer(0.05, release.set).start()
            assert a.acquire()
            a.release()
            t.join(TIMEOUT)
            snap = w.snapshot()
            for v in snap["violations"]:
                v.pop("thread")
            fam = reg.get("pio_lock_contended_total")
            contended = {lv: c.value for lv, c in fam.series()}
            outs.append((snap, sorted(w.edge_set()), contended))
        finally:
            mod.disable_witness()
        assert mod.witness_snapshot() == {
            "enabled": False, "edges": [], "violations": []
        }
    assert outs[0] == outs[1]
    assert outs[0][2][("a",)] == 1.0


def test_contended_condition_waits_notifies_and_reenters():
    reg = pt_metrics.MetricsRegistry()
    cond = pt_contention.ContendedCondition("c", registry=reg)
    box = []

    def waiter():
        with cond:
            assert cond.wait_for(lambda: box, TIMEOUT)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.02)
    with cond:
        with cond:  # a holder may take it again
            box.append(1)
        cond.notify_all()
    t.join(TIMEOUT)
    assert not t.is_alive()
    with cond:
        with cond:
            assert not cond.wait(0.0)  # a wait releases every level
    assert cond.acquire(blocking=False)
    cond.release()
    with pytest.raises(RuntimeError):
        cond.wait(0.0)  # not held


# ---------------------------------------------------------------------------
# hot path + capacity


def _hotpath_snapshot(mod, mmod, clock) -> dict:
    rng = np.random.default_rng(6)
    tracker = mod.HotPathTracker(mmod.MetricsRegistry())
    for _ in range(200):
        c = mod.StageClock()
        clock.advance(float(rng.uniform(1e-5, 1e-3)))
        c.lap("parse")
        c.add("queue_wait", float(rng.uniform(0, 1e-3)))
        clock.advance(float(rng.uniform(1e-5, 2e-3)))
        c.split({mod.WAVE_STAGE_MAP["host_gather"]: 1e-4,
                 mod.WAVE_STAGE_MAP["compute"]: float(rng.uniform(0, 3e-3))},
                remainder="block_until_ready")
        clock.advance(float(rng.uniform(1e-5, 1e-4)))
        c.lap("serialize")
        tracker.observe_clock(c)
    tracker.observe(0.0, {"parse": 1.0})  # ignored
    return tracker.snapshot()


def test_hotpath_snapshots_equal(clock):
    outs = [_hotpath_snapshot(mod, mmod, clock)
            for mod, mmod in ((jax_hotpath, jax_metrics), (pt_hotpath, pt_metrics))]
    assert outs[0] == outs[1]
    assert pt_hotpath.STAGE_ORDER == jax_hotpath.STAGE_ORDER


def test_render_hotpath_text_equals_the_jax_table(clock):
    snap = _hotpath_snapshot(pt_hotpath, pt_metrics, clock)
    text = pt_hotpath.render_hotpath_text(snap)
    assert text == jax_hotpath.render_hotpath_text(snap)
    assert text.splitlines()[0].startswith("requests: 200")
    empty = pt_hotpath.HotPathTracker(pt_metrics.MetricsRegistry()).snapshot()
    assert pt_hotpath.render_hotpath_text(empty) == jax_hotpath.render_hotpath_text(empty)
    assert pt_hotpath.render_hotpath_text({}) == jax_hotpath.render_hotpath_text({})


@pytest.mark.parametrize("samples", [[0.25], [1e-4, 3.5, 0.02, 120.0]])
def test_observe_span_feeds_the_span_histogram_as_jax(samples):
    regs = []
    for tmod, mmod in ((jax_tracing, jax_metrics), (pt_tracing, pt_metrics)):
        reg = mmod.MetricsRegistry()
        for i, s in enumerate(samples):
            tmod.observe_span(f"stage{i % 2}", s, registry=reg)
        regs.append(reg.render_prometheus())
    assert regs[0] == regs[1]
    assert 'pio_span_seconds_count{span="stage0"}' in regs[1]


def test_memstats_interval_and_aio_logger():
    from predictionio_tpu_torch.obs import profiler as pt_profiler
    from predictionio_tpu_torch.server import aio as pt_aio

    # the port reads the allocator on every scrape: no throttle window
    assert pt_profiler.MEMSTATS_MIN_INTERVAL_S == 0.0
    assert pt_aio.log.name == "predictionio_tpu_torch.aio"


def _capacity_app(slo_mod, clock, inflight_cap: bool):
    slo = slo_mod.SLOTracker(window_s=60, bucket_s=10)
    for i in range(40):
        slo.record(i % 9 != 0, 0.01 * (i % 5))
        clock.advance(0.5)
    return SimpleNamespace(
        slo=slo,
        admission=(SimpleNamespace(max_inflight=16, inflight=3)
                   if inflight_cap else None),
        microbatcher=SimpleNamespace(max_queue=256),
    )


@pytest.mark.parametrize("waves", [False, True])
@pytest.mark.parametrize("inflight_cap", [False, True])
def test_capacity_snapshots_equal_under_an_injected_clock(
    clock, monkeypatch, waves, inflight_cap
):
    outs = []
    for slo_mod, cap, mmod in ((jax_slo, jax_capacity, jax_metrics),
                               (pt_slo, pt_capacity, pt_metrics)):
        monkeypatch.setattr(slo_mod, "_now", clock)
        clock.t = 2000.0
        reg = mmod.MetricsRegistry()
        reg.histogram("pio_request_latency_seconds", "l",
                      labelnames=("route", "status")).labels("/q", "200").observe(0.02)
        if waves:
            bs = reg.histogram("pio_microbatch_batch_size", "b",
                               buckets=mmod.SIZE_BUCKETS)
            ds = reg.histogram("pio_microbatch_device_seconds", "d")
            for n in (8, 32, 600):
                bs.observe(n)
                ds.observe(n * 1e-5)
            reg.gauge("pio_microbatch_queue_depth", "q").set(200)
        app = _capacity_app(slo_mod, clock, inflight_cap)
        outs.append((cap.capacity_snapshot(app, reg),
                     cap.capacity_snapshot(None, reg)))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# provenance


def test_provenance_records_equal(clock):
    req = SimpleNamespace(path="/queries.json")
    resp = SimpleNamespace(status=200)
    outs = []
    for mod in (jax_provenance, pt_provenance):
        store = mod.ProvenanceStore(capacity=3)
        for i, deep in enumerate([False, True, False, True, False]):
            headers = {"X-Pio-Explain": "1"} if deep else {}
            token = mod.begin_capture(deep=mod.wants_deep(headers))
            try:
                mod.note(engine_path="als.device_topk", n=i)
                mod.note_deep(seen=mod.clip(range(100), 4))
                w = mod.begin_wave()
                mod.note(in_wave=True)
                mod.note_deep(wave_deep=[1, 2])
                collected = mod.end_wave(w)
                mod.note(collected=collected)
                mod.note_answer({"itemScores": [{"item": "a", "score": 1.5},
                                                {"item": "b", "score": -0.0}]})
                span = SimpleNamespace(request_id=f"r{i}", trace_id=f"t{i}")
                mod.finalize_record(store, "predictionserver", req, resp, 0.25, span)
            finally:
                mod.end_capture(token)
        token = mod.begin_capture()
        try:
            mod.note_answer({"other": 1})
            mod.finalize_record(store, "s", req, resp, 0.1,
                                SimpleNamespace(request_id="r9", trace_id=None))
        finally:
            mod.end_capture(token)
        token = mod.begin_capture()
        try:  # nothing noted: no record
            mod.finalize_record(store, "s", req, resp, 0.1,
                                SimpleNamespace(request_id="rX", trace_id=None))
        finally:
            mod.end_capture(token)
        outs.append((store.snapshot(), store.get("r4"), store.get("r0"),
                     mod.item_scores([1]), mod.item_scores({"itemScores": 3})))
        store.clear()
        outs[-1] += (store.snapshot(),)
    assert outs[0] == outs[1]


def test_binding_fields_equal():
    inst = SimpleNamespace(id="inst-1", engine_variant="v2",
                           engine_factory="recommendation")
    binding = SimpleNamespace(instance=inst, role="live")
    jax_deployed = SimpleNamespace(
        binding_label=lambda b: inst.engine_variant, generation_store=None
    )
    assert pt_provenance.binding_fields(SimpleNamespace(), binding) == (
        jax_provenance.binding_fields(jax_deployed, binding)
    )
    bare = SimpleNamespace(instance=SimpleNamespace(id="i", engine_variant=""))
    assert pt_provenance.binding_fields(None, bare) == {
        "instance_id": "i", "variant": "default", "role": "live",
    }


# ---------------------------------------------------------------------------
# sampling


def _stack_a():
    return sys._getframe()


def _stack_b():
    return _stack_a()


def test_sampler_exports_equal():
    codes = [_stack_a.__code__, _stack_b.__code__, test_sampler_exports_equal.__code__]
    counts = {
        ("microbatcher", (codes[2], codes[1], codes[0])): 7,
        ("aio-loop", (codes[2], codes[0])): 3,
        ("main", (codes[2],)): 11,
    }
    outs = []
    for mod in (jax_sampling, pt_sampling):
        s = mod.StackSampler(hz=50.0)
        s._counts = dict(counts)
        s._samples = 21
        speed = s.speedscope()
        assert speed.pop("exporter") == mod.__name__.rsplit(".obs", 1)[0]
        snap = s.snapshot()
        snap.pop("duration_s")
        snap.pop("started_at")
        outs.append((s.collapsed(), speed, snap))
        for name in ("microbatch-finalize", "predictionserver-aio",
                     "Thread-3", "pio-profiler", "x-http", "other"):
            assert mod.thread_role(name) == jax_sampling.thread_role(name)
    assert outs[0] == outs[1]


#: the serving process of the sampler check: a seeded ALS model behind the
#: port's default deploy on the CPU, the sampler metered pass by pass, and
#: the load from a client process; prints the sampler's figures as JSON
_SAMPLED_SERVER = r"""
import json, statistics, subprocess, sys, time
from datetime import datetime, timezone
import numpy as np, torch
torch.set_num_threads(2)
from predictionio_tpu_torch.core.engine import EngineParams
from predictionio_tpu_torch.core.persistence import save_models
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as rec
from predictionio_tpu_torch.obs import sampling
from predictionio_tpu_torch.server import prediction_server as ps

home, clients, seconds = sys.argv[1], sys.argv[2], sys.argv[3]
rng = np.random.default_rng(0)
storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": home}))
params = EngineParams(algorithms=(("als", rec.ALSAlgorithmParams(rank=4)),))
now = datetime.now(tz=timezone.utc)
storage.engine_instances().insert(EngineInstance(
    id="obs", status="COMPLETED", start_time=now, end_time=now,
    engine_id="default", engine_version="default", engine_variant="default",
    engine_factory="recommendation", **params.to_json_fields()))
save_models(storage.models(), "obs", [{
    "user_factors": rng.standard_normal((40, 4)).astype(np.float32),
    "item_factors": rng.standard_normal((60, 4)).astype(np.float32),
    "user_vocab": np.array([f"u{i}" for i in range(40)]),
    "item_vocab": np.array([f"i{i}" for i in range(60)])}])
server = ps.create_prediction_server(
    "recommendation", host="127.0.0.1", port=0, storage=storage,
    device="cpu").start_background()

def reference_work():
    acc = 0
    for i in range(400):
        acc ^= hash((i, i + 1, "x"))
    return acc

passes, refs = [], []

class Metered(sampling.StackSampler):
    def _sample_once(self):
        c0 = time.thread_time()
        super()._sample_once()
        c1 = time.thread_time()
        reference_work()
        passes.append(c1 - c0)
        refs.append(time.thread_time() - c1)

sampler = Metered(hz=100.0).start()
out = subprocess.run(
    [sys.executable, "-c", sys.stdin.read(),
     f"http://127.0.0.1:{server.port}", clients, seconds],
    capture_output=True, text=True, timeout=120)
snap = sampler.snapshot()
roles = [p["name"] for p in sampler.speedscope()["profiles"]]
sampler.stop()
server.shutdown()
storage.close()
print(json.dumps({
    "rc": out.returncode, "served": out.stdout.strip(), "err": out.stderr[-800:],
    "samples": snap["samples"], "dropped": snap["dropped_stacks"],
    "pass_s": statistics.median(passes), "ref_s": statistics.median(refs),
    "roles": roles}))
"""

#: what a sampler pass may cost, in units of the reference work: the JAX
#: package's budget of 2 % of the 10 ms period (200 us) over the reference
#: work's ~130 us on an unloaded x86 server core.  Both are CPU time on the
#: sampler's thread, taken pass by pass, so a loaded host slows them alike
PASS_BUDGET_REFS = 1.5


def test_sampler_under_concurrent_load_with_bounded_overhead(tmp_path):
    """The port's copy of the JAX package's acceptance test: the sampler
    runs in a serving process (a micro-batched deploy of its own, so the
    threads it walks are the server's) under 16-way load from a client
    process, and its export shows the serving threads.  The overhead bound
    is the sampler thread's own CPU time per pass (``time.thread_time``
    around each pass, on the sampler thread), the median over every pass,
    held in units of a fixed reference work timed the same way right after
    each pass: neither the wall-clock share a loaded host gives the thread
    nor the slower CPU time of a contended host moves it."""
    client = (
        "import sys, json, threading, time, urllib.request\n"
        "base, clients, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])\n"
        "stop = time.time() + seconds\n"
        "count = [0] * clients\n"
        "def run(i):\n"
        "    n = 0\n"
        "    while time.time() < stop:\n"
        "        body = json.dumps({'user': 'u%d' % ((i * 31 + n) % 40), 'num': 3}).encode()\n"
        "        req = urllib.request.Request(base + '/queries.json', data=body,\n"
        "            headers={'Content-Type': 'application/json'})\n"
        "        with urllib.request.urlopen(req, timeout=30) as r:\n"
        "            r.read()\n"
        "        n += 1\n"
        "    count[i] = n\n"
        "ts = [threading.Thread(target=run, args=(i,)) for i in range(clients)]\n"
        "for t in ts: t.start()\n"
        "for t in ts: t.join()\n"
        "print(sum(count))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", _SAMPLED_SERVER, str(tmp_path / "pio_home"),
         "16", "2.5"],
        input=client, capture_output=True, text=True, timeout=180,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0, got["err"]
    assert int(got["served"]) > 16  # real sustained load
    assert got["samples"] > 50 and got["dropped"] == 0
    assert got["pass_s"] <= PASS_BUDGET_REFS * got["ref_s"], got
    assert {"microbatcher", "aio-loop"} <= set(got["roles"]), got["roles"]
