"""The port's span capture on the CPU (``obs/tracing.py``): profiler
ranges and per-name totals for every span, wave stage and device span
while a capture is on, nothing while none is; the benchmark's readers of
the totals; ``POST /debug/profile`` holding a capture for its window; and
``pio train``'s DASE stages as spans.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.obs import profiler as pt_profiler
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.ops import ncf

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

#: the wave stages a CPU wave marks, each once a wave; ``observe`` twice
#: (before the dispatch and after the fence)
CPU_WAVE_STAGES = ("wave.host_gather", "wave.compute", "wave.d2h", "wave.render")
STEP_PHASES = ("ncf.step.forward", "ncf.step.backward", "ncf.step.optimizer")

P = ncf.NCFParams(embed_dim=8, mlp_layers=(16, 8), batch_size=64,
                  negatives_per_positive=2)
N_USERS, N_ITEMS = 90, 70


@pytest.fixture(autouse=True)
def _clear_store():
    tracing.clear_capture_totals()
    yield
    tracing.clear_capture_totals()


def _model():
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.ncf import engine as ncf_engine

    params = ncf.init_ncf(torch.Generator().manual_seed(4), N_USERS, N_ITEMS, P)
    blob = {"params": ncf.host_params(params), "n_users": N_USERS,
            "n_items": N_ITEMS, "config": dataclasses.asdict(P),
            "user_vocab": BiMap.from_keys(
                np.array([f"u{i}" for i in range(N_USERS)])).to_state(),
            "item_vocab": BiMap.from_keys(
                np.array([f"i{i}" for i in range(N_ITEMS)])).to_state()}
    algo = ncf_engine.NCFAlgorithm()
    return algo, algo.load_persistent_model(EngineContext(device="cpu"), blob)


def _two_waves():
    """A ``batch_predict`` of two waves: (user, [(item, score)]) per query."""
    from predictionio_tpu_torch.models.recommendation.engine import Query

    algo, model = _model()
    queries = [(j, Query(user=f"u{j * 5 % N_USERS}", num=6))
               for j in range(2 * algo.MAX_WAVE)]
    out = algo.batch_predict(model, queries)
    return [(j, [(s.item, s.score) for s in r.item_scores]) for j, r in out]


def _two_steps():
    """A ``train_epoch`` of two steps from a fixed start and fixed draws:
    the epoch's loss and the parameters after it."""
    params = ncf.init_ncf(torch.Generator().manual_seed(5), N_USERS, N_ITEMS, P)
    for leaf in ncf.tree_leaves(params):
        leaf.requires_grad_(True)
    opt = ncf.make_optimizer(params, P)
    rng = np.random.default_rng(6)
    n = 2 * P.batch_size
    stream = ncf.stage_stream(rng.integers(0, N_USERS, n),
                              rng.integers(0, N_ITEMS, n), P,
                              torch.device("cpu"))
    assert stream.n_steps == 2
    neg = torch.from_numpy(rng.integers(0, N_ITEMS, (2, P.batch_size, 2)))
    loss = ncf.train_epoch(params, opt, stream, P, N_ITEMS,
                           perm=torch.arange(n), negatives=neg.__getitem__)
    return float(loss), [x.detach().clone() for x in ncf.tree_leaves(params)]


# ---------------------------------------------------------------------------
# the capture's two triggers


def test_a_profiler_capture_names_every_stage_and_phase():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.capturing()
        _two_waves()
        _two_steps()
    assert not tracing.capturing()
    names = {e.name for e in prof.events()}
    wanted = set(CPU_WAVE_STAGES) | {"wave.observe"} | set(STEP_PHASES)
    assert wanted <= names, wanted - names
    # host operations, not user annotations, which the profiler would
    # also project onto the device timeline as device operations
    assert not [e.name for e in prof.events()
                if e.name in wanted and e.is_user_annotation]
    totals = tracing.capture_totals()
    for name in CPU_WAVE_STAGES + STEP_PHASES:
        assert totals[name]["count"] == 2, (name, totals[name])
        assert totals[name]["host_s"] > 0
    assert totals["wave.observe"]["count"] == 4
    # on the CPU a device span's device time is its host span
    for name in STEP_PHASES:
        assert totals[name]["device_s"] == totals[name]["host_s"]
    assert totals["wave.render"]["device_s"] == 0.0


def test_no_capture_opens_no_range_and_moves_nothing(monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        waves_on, steps_on = _two_waves(), _two_steps()
    tracing.clear_capture_totals()

    def refuse(name):
        raise AssertionError(f"a range was opened outside a capture: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not tracing.capturing()
    waves_off, steps_off = _two_waves(), _two_steps()
    assert tracing.capture_totals() == {}
    assert waves_off == waves_on
    assert steps_off[0] == steps_on[0]
    for a, b in zip(steps_off[1], steps_on[1]):
        assert torch.equal(a, b)


def test_a_process_capture_holds_every_thread():
    seen = {}

    def other():
        seen["capturing"] = tracing.capturing()
        with tracing.trace("probe.thread", record=False, ring=False):
            pass

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
    assert not t.is_alive() and seen["capturing"] is False
    assert "probe.thread" not in tracing.capture_totals()
    with tracing.process_capture():
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
    assert not t.is_alive() and seen["capturing"] is True
    assert tracing.capture_totals()["probe.thread"]["count"] == 1
    assert not tracing.capturing()


def test_spans_nest_and_add_up_under_a_capture():
    from predictionio_tpu_torch.obs import device as device_obs

    with tracing.process_capture():
        with tracing.trace("outer", record=False, ring=False) as root:
            for _ in range(3):
                with device_obs.wave_stage("render"):
                    time.sleep(0.002)
            with tracing.device_span("inner.device"):
                time.sleep(0.002)
    totals = tracing.capture_totals()
    assert totals["wave.render"]["count"] == 3
    assert totals["wave.render"]["host_s"] >= 0.006
    assert totals["outer"]["host_s"] == root.duration_s
    assert totals["outer"]["host_s"] >= (totals["wave.render"]["host_s"]
                                         + totals["inner.device"]["host_s"])
    assert totals["inner.device"]["device_s"] == totals["inner.device"]["host_s"]


class _Event:
    """A stand-in CUDA event: done once ``query`` has been asked ``after``
    times, ``synchronize`` marks it done."""

    def __init__(self, at_ms: float, after: int = 0):
        self.at_ms, self.after, self.waited = at_ms, after, False

    def query(self) -> bool:
        self.after -= 1
        return self.after < 0 or self.waited

    def synchronize(self) -> None:
        self.waited = True

    def elapsed_time(self, end) -> float:
        return end.at_ms - self.at_ms


def test_device_pairs_are_read_when_done_and_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_PENDING", 4)
    with tracing._capture_lock:
        tracing._entry("d")
        for i in range(3):
            tracing._pending.append(("d", _Event(0.0), _Event(2.0, after=99)))
        tracing._pending.append(("d", _Event(0.0), _Event(5.0)))
    # a read takes what has completed and leaves the rest pending
    assert tracing.capture_totals()["d"]["device_s"] == pytest.approx(5e-3)
    assert len(tracing._pending) == 3
    # past the bound the oldest are waited for, down to half of it
    with tracing._capture_lock:
        tracing._pending.extend(
            ("d", _Event(0.0), _Event(1.0, after=99)) for _ in range(2))
        tracing._settle(tracing.MAX_PENDING // 2)
    assert len(tracing._pending) == 2
    assert tracing.capture_totals()["d"]["device_s"] == pytest.approx(
        5e-3 + 3 * 2e-3)
    tracing.clear_capture_totals()
    assert tracing.capture_totals() == {} and not tracing._pending


# ---------------------------------------------------------------------------
# the benchmark's readers of the totals

READERS = {
    # metric: (span names, field, stats count)
    "ncf_wave_gather_ms": (("wave.host_gather", "wave.h2d"), "host_s", "waves"),
    "ncf_wave_launch_ms": (("wave.launch",), "host_s", "waves"),
    "ncf_wave_fence_ms": (("wave.compute", "wave.d2h"), "host_s", "waves"),
    "ncf_wave_render_ms": (("wave.render",), "host_s", "waves"),
    "ncf_wave_observe_ms": (("wave.observe",), "host_s", "waves"),
    "ncf_step_forward_ms": (("ncf.step.forward",), "device_s", "steps"),
    "ncf_step_backward_ms": (("ncf.step.backward",), "device_s", "steps"),
    "ncf_step_optimizer_ms": (("ncf.step.optimizer",), "device_s", "steps"),
}


def _run(count: str, n: int) -> harness.Run:
    cell = harness.Cell("cell", 1, {}, {}, [], [])
    return harness.Run(cell, "cpu", 1.0, 10.0, {count: n})


@pytest.mark.parametrize("metric", sorted(READERS))
def test_a_span_reader_reads_its_spans_over_the_count(monkeypatch, metric):
    names, field, count = READERS[metric]
    reader = harness.load_module(harness.ROOT / "metrics" / f"{metric}.py")
    run = _run(count, 40)
    assert reader.read(run) is None  # an empty store
    other = "host_s" if field == "device_s" else "device_s"
    store = {name: {field: 0.25 * (i + 1), other: 9.0, "count": 40}
             for i, name in enumerate(names)}
    store["wave.unrelated"] = {"host_s": 7.0, "device_s": 7.0, "count": 1}
    monkeypatch.setattr(tracing, "capture_totals", lambda: store)
    want = 1e3 * sum(0.25 * (i + 1) for i in range(len(names))) / 40
    assert reader.read(run) == pytest.approx(want)
    assert reader.read(_run(count, 0)) is None
    # a program without the store (the parent of this reader) reads None
    monkeypatch.delattr(tracing, "capture_totals")
    assert reader.read(run) is None


# ---------------------------------------------------------------------------
# /debug/profile


def _wait_idle(timeout: float = 20.0):
    deadline = time.monotonic() + timeout
    while pt_profiler.PROFILER.status()["running"]:
        assert time.monotonic() < deadline, "capture never finished"
        time.sleep(0.02)
    return pt_profiler.PROFILER.status()["last"]


def test_debug_profile_captures_every_threads_spans(monkeypatch, tmp_path):
    _wait_idle()
    monkeypatch.setattr(pt_profiler, "_start_trace", lambda cuda: "handle")
    monkeypatch.setattr(
        pt_profiler, "_stop_trace",
        lambda prof, out, cuda: {"trace": "t.json", "table": "k.txt",
                                 "device_ops": [{"name": "op", "count": 1,
                                                 "device_time_us": 3.0}]},
    )
    with tracing.process_capture():
        with tracing.trace("before.capture", record=False, ring=False):
            pass
    pt_profiler.PROFILER.start(0.5, str(tmp_path), cuda=False)
    assert tracing.capturing()

    def serve():
        with tracing.trace("probe.served", record=False, ring=False):
            time.sleep(0.01)

    t = threading.Thread(target=serve)
    t.start()
    t.join(10)
    assert not t.is_alive()
    last = _wait_idle()
    assert not tracing.capturing()
    assert last["error"] is None and last["device_ops"][0]["name"] == "op"
    assert set(last["spans"]) == {"probe.served"}  # cleared at the start
    assert last["spans"]["probe.served"]["count"] == 1
    assert last["spans"]["probe.served"]["host_s"] >= 0.01
