"""The port's device observability (``obs/device.py``, ``obs/profiler.py``)
against the JAX package's, on the CPU.

- the H100 peak rows, keyed on the card's name with the most specific
  prefix winning, and the ``PIO_DEVICE_PEAK_*`` overrides;
- ``EfficiencyTracker``'s arithmetic held to the JAX tracker's on the same
  costs and seconds (gauges, counters and ``/efficiency.json`` functions);
- the launch-shape storm detection held to the JAX ``RecompileTracker``
  under a frozen clock;
- ``split_breakdown`` summing to ``device_s`` and equal to the JAX split;
- ``als.pallas_step``'s installed cost equal to the two half-steps'
  ``als_accum_least_work`` (fused) and to the chunks' summed
  ``segment_accum_least_work`` (chunked);
- ``sample_runtime_gauges`` never calling ``torch.cuda.memory_stats`` in a
  process that has not initialized CUDA (stubbed), and reading it when it
  has;
- the profiler route's 202 / 409 / 501 / 403 with the trace functions
  stubbed, a real CPU capture, and a CUDA capture on a card-less torch
  failing loudly in its status;
- the kernel build's span and compile metrics with a stand-in ``nvcc``;
- the recommendation engine's device wave on the CPU feeding
  ``als.fused_topk`` with its launch shape and least-work cost, and waves
  of eight sizes raising no launch-shape storm (the row count is not part
  of the launch shape).
"""

from __future__ import annotations

import os
import stat
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.obs import device as jax_device
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu_torch.obs import device as pt_device
from predictionio_tpu_torch.obs import metrics as pt_metrics
from predictionio_tpu_torch.obs import profiler as pt_profiler
from predictionio_tpu_torch.ops import als as pt_als
from predictionio_tpu_torch.ops import als_accum
from predictionio_tpu_torch.ops.topk import fused_topk_least_work, query_block

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# peaks


@pytest.mark.parametrize(
    "name,row",
    [
        ("NVIDIA H100 80GB HBM3", ("nvidia h100 80gb hbm3", 3350.0, 67.0)),
        ("NVIDIA H100 PCIe", ("nvidia h100 pcie", 2000.0, 51.0)),
        ("NVIDIA H100 NVL", ("nvidia h100 nvl", 3900.0, 60.0)),
        ("cpu", ("cpu", 25.0, 0.5)),
        ("gpu", ("gpu", 900.0, 100.0)),
        ("Some Accelerator", ("default", 25.0, 0.5)),
    ],
)
def test_peak_rows(monkeypatch, name, row):
    monkeypatch.delenv("PIO_DEVICE_PEAK_GBPS", raising=False)
    monkeypatch.delenv("PIO_DEVICE_PEAK_TFLOPS", raising=False)
    peaks = pt_device.device_peaks(name)
    assert (peaks.source, peaks.hbm_gbps, peaks.tflops) == row


def test_cpu_process_reads_the_cpu_row(monkeypatch):
    monkeypatch.delenv("PIO_DEVICE_PEAK_GBPS", raising=False)
    monkeypatch.delenv("PIO_DEVICE_PEAK_TFLOPS", raising=False)
    assert not torch.cuda.is_initialized()
    assert pt_device._platform_kind() == "cpu"
    assert pt_device.device_peaks().source == "cpu"
    got, want = pt_device.device_peaks(), jax_device.device_peaks("cpu")
    assert (got.hbm_gbps, got.tflops, got.source) == (
        want.hbm_gbps, want.tflops, want.source
    )


@pytest.mark.parametrize(
    "gbps,tflops",
    [("1000", None), (None, "12.5"), ("1000", "12.5"), ("abc", None),
     ("abc", "7"), (None, "x")],
)
def test_peak_env_override_matches_jax(monkeypatch, gbps, tflops):
    for var, value in (("PIO_DEVICE_PEAK_GBPS", gbps),
                       ("PIO_DEVICE_PEAK_TFLOPS", tflops)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    got = pt_device.device_peaks("cpu")
    want = jax_device.device_peaks("cpu")
    assert (got.hbm_gbps, got.tflops, got.source) == (
        want.hbm_gbps, want.tflops, want.source
    )


# ---------------------------------------------------------------------------
# efficiency tracker + recompiles


def test_efficiency_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    regs, snaps = [], []
    for mod, mmod in ((jax_device, jax_metrics), (pt_device, pt_metrics)):
        reg = mmod.MetricsRegistry()
        peaks = mod.DevicePeaks(hbm_gbps=3350.0, tflops=67.0, source="row")
        eff = mod.EfficiencyTracker(registry=reg, peaks=peaks)
        rng = np.random.default_rng(1)
        eff.observe("als.fused_topk", 0.001)  # no cost yet: a no-op
        for sig in range(3):
            eff.record_cost("als.fused_topk", float(rng.uniform(1e6, 1e9)),
                            float(rng.uniform(1e6, 1e9)), signature=(sig,),
                            source="least_work")
            for _ in range(4):
                eff.observe("als.fused_topk", float(rng.uniform(1e-5, 1e-2)))
            eff.observe("als.fused_topk", float(rng.uniform(1e-5, 1e-2)),
                        signature=(0,))
        eff.record_cost("als.pallas_step", 5e9, 2e9, signature=("fused",),
                        source="least_work")
        eff.observe("als.pallas_step", 0.004)
        eff.observe("als.pallas_step", 0.0)  # ignored
        assert eff.cached_cost("als.pallas_step", ("fused",))["bytes"] == 2e9
        assert eff.cached_cost("als.pallas_step", ("nope",)) is None
        snap = eff.snapshot()
        snap.pop("platform")
        snaps.append(snap)
        regs.append(reg.render_prometheus())
    assert snaps[0] == snaps[1]
    # the same families and samples; only the help texts name the yardstick
    assert _families(regs[0]) == _families(regs[1])
    assert _samples(regs[0]) == _samples(regs[1])


def _families(text: str) -> set[str]:
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}


def _samples(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith("#")]


def test_storm_detection_matches_jax():
    outs = []
    for mod, mmod in ((jax_device, jax_metrics), (pt_device, pt_metrics)):
        reg = mmod.MetricsRegistry()
        rt = mod.RecompileTracker(registry=reg, storm_threshold=3, window_s=10)
        seen = []
        t = 100.0
        for i, (fn, b) in enumerate(
            [("als.fused_topk", 512), ("als.fused_topk", 512),
             ("als.fused_topk", 600), ("als.fused_topk", 700),
             ("als.batch_topk", 512), ("als.fused_topk", 800),
             ("als.fused_topk", 900), ("als.fused_topk", 1000)]
        ):
            t += 1.0 if i != 6 else 30.0
            seen.append(rt.note_signature(fn, (b, 10, (50, 8), (90, 8)), now=t))
            if i == 3:
                seen.append(rt.active_storms(now=t))
        outs.append((seen, rt.snapshot(now=t), rt.snapshot(now=t + 100),
                     _samples(reg.render_prometheus())))
    assert outs[0] == outs[1]
    assert outs[1][0][:4] == [True, False, True, True]
    assert "als.fused_topk" in outs[1][0][4]


def test_split_breakdown_sums_to_device_s():
    rng = np.random.default_rng(2)
    for _ in range(50):
        tl_pt, tl_jax = pt_device.WaveTimeline(), jax_device.WaveTimeline()
        stages = {s: float(rng.uniform(0, 1e-3))
                  for s in ("host_gather", "h2d", "compute", "d2h")
                  if rng.random() > 0.3}
        tl_pt.stages.update(stages)
        tl_jax.stages.update(stages)
        device_s = sum(stages.values()) + float(rng.uniform(0, 1e-3))
        got = pt_device.split_breakdown(tl_pt, device_s)
        assert got == jax_device.split_breakdown(tl_jax, device_s)
        assert list(got) == list(pt_device.WAVE_STAGES) + ["other"]
        assert abs(sum(got.values()) - device_s) <= 5e-6
    # marks past the window clamp "other" at zero, nothing is rescaled
    tl = pt_device.WaveTimeline()
    tl.stages["compute"] = 2.0
    assert pt_device.split_breakdown(tl, 1.0)["other"] == 0.0
    assert pt_device.split_breakdown(None, 0.5) == jax_device.split_breakdown(None, 0.5)


def test_wave_timeline_notes_and_merge():
    reg = pt_metrics.MetricsRegistry()
    before = pt_device.transfer_totals()
    with pt_device.wave_timeline() as a:
        with pt_device.wave_stage("host_gather"):
            time.sleep(0.001)
        pt_device.note_transfer("h2d", 4096, registry=reg)
        pt_device.note_cache_hit(2)
        pt_device.note_cache_miss()
        pt_device.note_cache_fill(64)
        pt_device.note_wave_device("cuda:0")
    with pt_device.wave_timeline() as b:
        with pt_device.wave_stage("compute"):
            pass
        pt_device.note_wave_kernel(0.002)
        pt_device.note_wave_cost("als.fused_topk", {"flops": 10.0, "bytes": 20.0})
        pt_device.note_transfer("d2h", 80, registry=reg)
    # outside any scope every note is a no-op
    pt_device.note_wave_kernel(1.0)
    with pt_device.wave_stage("compute"):
        pass
    b.merge(a)
    assert b.stages["host_gather"] >= 0.001 and "compute" in b.stages
    assert (b.device, b.fn, b.flops, b.bytes, b.kernel_s) == (
        "cuda:0", "als.fused_topk", 10.0, 20.0, 0.002
    )
    assert (b.cache_hits, b.cache_misses, b.cache_miss_bytes) == (2, 1, 64.0)
    assert b.transfers == {"h2d": 4096, "d2h": 80}
    after = pt_device.transfer_totals()
    assert after["h2d"] - before["h2d"] == 4096
    assert after["d2h"] - before["d2h"] == 80
    fam = reg.get("pio_device_transfer_bytes_total")
    assert {lv: c.value for lv, c in fam.series()} == {("d2h",): 80.0, ("h2d",): 4096.0}
    assert pt_device.device_label(torch.zeros(1)) == "cpu:0"
    assert pt_device.device_label(np.zeros(1)) == "host"
    snap = pt_device.device_snapshot()
    assert set(snap) == {"platform", "peaks", "functions", "recompiles", "transfers",
                         "shards"}
    assert set(snap["transfers"]) == {"h2d_bytes", "d2h_bytes"}


# ---------------------------------------------------------------------------
# the train's roofline


def _ratings(seed, nnz=3000, n_users=70, n_items=90):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    r = rng.integers(1, 6, nnz).astype(np.float32)
    return u, i, r, n_users, n_items


@pytest.mark.parametrize("mode", ["fused", "chunked"])
def test_pallas_step_cost_is_the_half_steps_least_work(mode):
    u, i, r, n_users, n_items = _ratings(3)
    rank = 4
    p = pt_als.ALSParams(rank=rank, num_iterations=2, pallas_mode=mode)
    eff = pt_device.default_efficiency()
    pt_als.train_als(u, i, r, n_users, n_items, params=p, device="cpu")
    nu_pad = max((n_users + 127) // 128 * 128, 128)
    ni_pad = max((n_items + 127) // 128 * 128, 128)
    up = als_accum.build_plan(u.astype(np.int64), nu_pad)
    ip = als_accum.build_plan(i.astype(np.int64), ni_pad)
    if mode == "fused":
        halves = [
            als_accum.als_accum_least_work(up.padded_len, rank, nu_pad, ni_pad, len(u)),
            als_accum.als_accum_least_work(ip.padded_len, rank, ni_pad, nu_pad, len(u)),
        ]
        rows = (up.padded_len, ip.padded_len)
    else:
        width = als_accum.row_width(rank)
        tpc = als_accum.chunk_tiles(width)
        halves, rows = [], []
        for plan in (up, ip):
            cp = als_accum.chunk_plan(plan, tpc)
            n = cp.tiles_per_chunk * als_accum.T
            rows.append(cp.n_chunks * n)
            for c in range(cp.n_chunks):
                halves.append(als_accum.segment_accum_least_work(
                    n, width,
                    int(np.unique(cp.block_map[c]).size) * als_accum.S,
                    int((~cp.pad_mask[c * n:(c + 1) * n]).sum()),
                ))
        rows = tuple(rows)
    want = {k: sum(h[k] for h in halves) for k in ("bytes", "flops")}
    cost = eff.cached_cost("als.pallas_step", (mode, *rows, rank))
    assert cost == {"bytes": want["bytes"], "flops": want["flops"],
                    "source": "least_work"}
    entry = eff.snapshot()["functions"]["als.pallas_step"]
    assert entry["calls"] >= 1 and entry["seconds_total"] > 0
    assert entry["source"] == "least_work"


# ---------------------------------------------------------------------------
# runtime gauges


def test_runtime_gauges_do_not_touch_an_uninitialized_card(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a scrape read the card in a process without CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_stats", forbidden)
    monkeypatch.setattr(torch.cuda, "mem_get_info", forbidden)
    monkeypatch.setattr(torch.cuda, "current_device", forbidden)
    reg = pt_metrics.MetricsRegistry()
    assert pt_profiler.sample_runtime_gauges(reg) is False
    assert reg.get("pio_jax_device_memory_bytes") is None
    fam = reg.get("pio_device_transfer_bytes")
    assert {lv[0] for lv, _ in fam.series()} == {"h2d", "d2h"}
    assert reg.get("pio_runtime_sample_seconds").labels().count == 1


def test_runtime_gauges_read_an_initialized_card(monkeypatch):
    stats = {"allocated_bytes.all.current": 1234,
             "reserved_bytes.all.current": 4096,
             "allocated_bytes.all.peak": 2000}
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: calls.append(("stats", d)) or stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: calls.append(("info", d)) or (7, 80))
    reg = pt_metrics.MetricsRegistry()
    assert pt_profiler.sample_runtime_gauges(reg) is True
    assert calls == [("stats", 0), ("info", 0)]

    def value(name):
        return reg.get(name).labels("0").value

    assert value("pio_jax_device_memory_bytes") == 1234
    assert value("pio_cuda_memory_reserved_bytes") == 4096
    assert value("pio_cuda_memory_peak_bytes") == 2000
    assert value("pio_cuda_memory_free_bytes") == 7
    assert value("pio_cuda_memory_total_bytes") == 80


# ---------------------------------------------------------------------------
# profiler


def _profile_app(access_key="k"):
    from predictionio_tpu_torch.obs.http import add_observability_routes
    from predictionio_tpu_torch.server.httpd import HTTPApp, Request

    app = HTTPApp("predictionserver")
    add_observability_routes(app, pt_metrics.MetricsRegistry(),
                             access_key=access_key)

    def call(method, path, query=None):
        q = dict(query or {})
        if access_key:
            q["accessKey"] = access_key
        return app.handle(Request(method, path, q, {}))

    return app, call


def _wait_idle(timeout=20.0):
    deadline = time.monotonic() + timeout
    while pt_profiler.PROFILER.status()["running"]:
        assert time.monotonic() < deadline, "capture never finished"
        time.sleep(0.02)
    return pt_profiler.PROFILER.status()["last"]


def test_profiler_route_codes_with_stubbed_traces(monkeypatch, tmp_path):
    _wait_idle()
    started, stopped = [], []
    monkeypatch.setattr(pt_profiler, "_start_trace",
                        lambda cuda: started.append(cuda) or "handle")
    monkeypatch.setattr(
        pt_profiler, "_stop_trace",
        lambda prof, out, cuda: stopped.append((prof, out, cuda)) or {
            "trace": "t.json", "table": "k.txt", "device_ops": []
        },
    )
    _, call = _profile_app()
    resp = call("POST", "/debug/profile", {"seconds": "0.3", "dir": str(tmp_path)})
    assert resp.status == 202
    assert resp.body == {"profiling": True, "seconds": 0.3,
                         "dir": str(tmp_path), "activities": ["cpu"]}
    busy = call("POST", "/debug/profile", {"seconds": "1"})
    assert busy.status == 409
    status = call("GET", "/debug/profile")
    assert status.status == 200 and status.body["running"] is True
    last = _wait_idle()
    assert last["error"] is None and last["trace"] == "t.json"
    assert started == [False] and stopped == [("handle", str(tmp_path), False)]
    assert call("POST", "/debug/profile", {"seconds": "0"}).status == 400
    assert call("POST", "/debug/profile", {"seconds": "x"}).status == 400
    assert call("POST", "/debug/profile", {"seconds": "301"}).status == 400

    def refuse(cuda):
        raise RuntimeError("CUPTI_ERROR_INSUFFICIENT_PRIVILEGES")

    monkeypatch.setattr(pt_profiler, "_start_trace", refuse)
    unsupported = call("POST", "/debug/profile", {"seconds": "1"})
    assert unsupported.status == 501
    assert "CUPTI_ERROR_INSUFFICIENT_PRIVILEGES" in unsupported.body["message"]
    assert pt_profiler.PROFILER.status()["running"] is False
    # no key configured anywhere: arming the profiler is refused
    _, open_call = _profile_app(access_key=None)
    assert open_call("POST", "/debug/profile", {"seconds": "1"}).status == 403


def test_profiler_passes_the_apps_device(monkeypatch):
    _wait_idle()
    seen = []
    monkeypatch.setattr(pt_profiler, "_start_trace", lambda cuda: seen.append(cuda))
    monkeypatch.setattr(pt_profiler, "_stop_trace",
                        lambda prof, out, cuda: {"device_ops": []})
    app, call = _profile_app()
    app.profile_cuda = True
    resp = call("POST", "/debug/profile", {"seconds": "0.05"})
    assert resp.status == 202 and resp.body["activities"] == ["cpu", "cuda"]
    _wait_idle()
    assert seen == [True]


def test_a_cuda_capture_answers_once_its_guard_has_passed(monkeypatch):
    # the 202 of a CUDA capture comes DEVICE_CLOCK_GUARD_S after the
    # profiler started, so device work launched after it lies inside the
    # window; a CPU capture answers at once
    _wait_idle()
    started = []
    monkeypatch.setattr(pt_profiler, "DEVICE_CLOCK_GUARD_S", 2.0)
    monkeypatch.setattr(pt_profiler, "_start_trace",
                        lambda cuda: started.append(time.monotonic()))
    monkeypatch.setattr(pt_profiler, "_stop_trace",
                        lambda prof, out, cuda: {"device_ops": []})
    waits = {}
    for cuda in (True, False):
        pt_profiler.PROFILER.start(0.05, cuda=cuda)
        waits[cuda] = time.monotonic() - started[-1]
        _wait_idle()
    assert waits[True] >= 2.0 > waits[False], waits


def test_real_cpu_capture_writes_trace_and_table(tmp_path):
    _wait_idle()
    out = tmp_path / "cap"
    pt_profiler.PROFILER.start(0.3, str(out), cuda=False)
    x = torch.randn(64, 64)
    for _ in range(20):
        x = x @ x.T / 64
    last = _wait_idle()
    assert last["error"] is None, last
    assert os.path.getsize(last["trace"]) > 0
    assert "Name" in open(last["table"]).read()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card would be traced")
def test_cuda_capture_without_device_events_fails_loudly(tmp_path):
    _wait_idle()
    try:
        pt_profiler.PROFILER.start(0.2, str(tmp_path / "cap"), cuda=True)
    except pt_profiler.ProfilerUnsupported as e:
        assert "torch.profiler unavailable" in str(e)
        return
    last = _wait_idle()
    assert last["error"] and "no device events" in last["error"], last


# ---------------------------------------------------------------------------
# kernel build span


def test_kernel_build_span_and_compile_metrics(monkeypatch, tmp_path):
    from predictionio_tpu_torch.obs.metrics import REGISTRY
    from predictionio_tpu_torch.ops import _kernels

    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    # a stand-in compiler: writes the -o file and a line of "ptxas" output
    nvcc.write_text(
        "#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then shift; "
        "echo lib > \"$1\"; fi; shift; done\necho 'ptxas info: ok'\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("PIO_KERNEL_BUILD_DIR", str(tmp_path / "build"))
    total = REGISTRY.counter(
        "pio_jax_compile_total",
        "Compile events by event name (nvcc/<source>: one kernel build)",
        labelnames=("event",),
    ).labels("nvcc/fused_topk.cu")
    span = REGISTRY.histogram(
        "pio_span_seconds", "Duration of named stages (trace spans)",
        labelnames=("span",), buckets=pt_metrics.TRAIN_BUCKETS,
    ).labels("kernel.build")
    n0, s0 = total.value, span.count
    seconds = _kernels.build(["fused_topk"])
    assert set(seconds) == {"fused_topk.cu"}
    assert total.value == n0 + 1 and span.count == s0 + 1
    assert _kernels.build(["fused_topk"]) == {}  # built: no span, no event
    assert span.count == s0 + 1


# ---------------------------------------------------------------------------
# the engine's device wave on the CPU


def test_engine_device_wave_feeds_the_roofline():
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.recommendation import engine as rec

    rng = np.random.default_rng(9)
    n_users, n_items, rank, k = 600, 300, 6, 10
    U = rng.standard_normal((n_users, rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    model = rec.ALSModel(
        user_factors=torch.from_numpy(U), item_factors=torch.from_numpy(V),
        user_vocab=BiMap.from_keys(np.array([f"u{i}" for i in range(n_users)])),
        item_vocab=BiMap.from_keys(np.array([f"i{i}" for i in range(n_items)])),
    )
    algo = rec.ALSAlgorithm()
    queries = [(j, rec.Query(user=f"u{j}", num=k)) for j in range(550)]
    eff = pt_device.default_efficiency()
    before = pt_device.transfer_totals()
    with pt_device.wave_timeline() as tl:
        fin = algo.dispatch_batch(model, queries)
        out = fin()
    assert len(out) == 550
    sig = (550, k, n_users, rank, n_items, rank)
    cost = fused_topk_least_work(550, rank, n_items, k)
    assert eff.cached_cost("als.fused_topk", sig) == {**cost, "source": "least_work"}
    launch = (k, query_block(550, k), n_users, rank, n_items, rank)
    assert launch in pt_device.default_recompiles()._seen["als.fused_topk"]
    assert tl.fn == "als.fused_topk" and tl.device == "cpu:0"
    assert tl.kernel_s > 0 and {"host_gather", "compute", "d2h"} <= set(tl.stages)
    # nothing crosses on the CPU: no copy, no transfer bytes
    assert pt_device.transfer_totals() == before and tl.transfers == {}
    assert eff.snapshot()["functions"]["als.fused_topk"]["calls"] >= 1


def test_wave_sizes_trip_no_launch_shape_storm(monkeypatch):
    """Micro-batched waves come in every size; the kernels are built once,
    so a burst of distinct wave sizes is one launch shape per query block
    and raises no storm."""
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.recommendation import engine as rec

    rng = np.random.default_rng(10)
    n_users, n_items, rank, k = 1100, 300, 6, 10
    U = rng.standard_normal((n_users, rank)).astype(np.float32)
    V = rng.standard_normal((n_items, rank)).astype(np.float32)
    model = rec.ALSModel(
        user_factors=torch.from_numpy(U), item_factors=torch.from_numpy(V),
        user_vocab=BiMap.from_keys(np.array([f"u{i}" for i in range(n_users)])),
        item_vocab=BiMap.from_keys(np.array([f"i{i}" for i in range(n_items)])),
    )
    reg = pt_metrics.MetricsRegistry()
    tracker = pt_device.RecompileTracker(registry=reg, storm_threshold=4,
                                         window_s=60)
    monkeypatch.setattr(pt_device, "RECOMPILES", tracker)
    algo = rec.ALSAlgorithm()
    sizes = [512, 513, 600, 777, 900, 1000, 1024, 640]
    for b in sizes:
        queries = [(j, rec.Query(user=f"u{j}", num=k)) for j in range(b)]
        assert len(algo.dispatch_batch(model, queries)()) == b
    assert tracker.active_storms() == {}
    assert 'pio_recompile_storm_total' not in "".join(
        ln for ln in reg.render_prometheus().splitlines()
        if not ln.startswith("#"))
    # one signature per query block the sizes used (8 up to 1,024 rows)
    blocks = {query_block(b, k) for b in sizes}
    assert len(tracker._seen["als.fused_topk"]) == len(blocks)


@pytest.mark.parametrize("args", [
    (),
    (np.zeros((3, 4), np.float32), 7, "x"),
    (np.arange(5, dtype=np.int64), None, (1, 2), {"k": 1}),
    (np.float32(2.5), np.ones((0, 2), np.float16), 1.5, True),
])
def test_signature_of_equals_the_jax_function(args):
    assert pt_device.signature_of(*args) == jax_device.signature_of(*args)


def test_signature_of_a_tensor_is_its_shape_and_dtype():
    t = torch.zeros((4, 2), dtype=torch.float32)
    assert pt_device.signature_of(t, 3) == (((4, 2), "torch.float32"), "3")
