"""The port's self-gate: its own analyzer turned on ``predictionio_tpu_torch/``.

The scan must leave no finding outside the port's checked-in baseline
(``predictionio_tpu_torch/.pio-check-baseline.json``, paths relative to the
repo root), every entry must carry a real justification and still match a
live finding, and no PIO-LOCK finding may remain or be baselined: a lock
held across a blocking call is repaired, never excused.  The static lock
graph must be acyclic and must see the port's ContendedLocks, at least
every edge the runtime witness observes.

The two lock repairs are held here too, by behavior: ``ops._kernels.load``
runs no compiler under its lock (a fake ``nvcc`` that sleeps stands in for
the real one), and ``Compactor.tick`` awaits no shard-fold future under
``Compactor._lock``.
"""

from __future__ import annotations

import stat
import sys
import threading
import time
import types
from collections import Counter
from pathlib import Path

import pytest

from predictionio_tpu_torch.analysis import Baseline, Severity, analyze_paths

REPO_ROOT = Path(__file__).resolve().parents[1]
PACKAGE = REPO_ROOT / "predictionio_tpu_torch"
BASELINE = PACKAGE / ".pio-check-baseline.json"


@pytest.fixture(scope="module")
def report():
    """The package scan, computed once for the module (~10 s)."""
    return analyze_paths([PACKAGE], root=REPO_ROOT)


@pytest.fixture(scope="module")
def program():
    """The package's call/lock graph."""
    from predictionio_tpu_torch.analysis.analyzer import iter_python_files
    from predictionio_tpu_torch.analysis.callgraph import build_program
    from predictionio_tpu_torch.analysis.rules import parse_module

    mods = []
    for path in iter_python_files([PACKAGE]):
        rel = path.resolve().relative_to(REPO_ROOT).as_posix()
        mods.append(parse_module(path, rel, path.read_text()))
    return build_program(mods)


def test_package_parses_clean(report):
    assert report.errors == []
    assert report.files_scanned > 100


def test_no_unbaselined_findings(report):
    remaining, _ = Baseline.load(BASELINE).filter(report.findings)
    highs = [f for f in remaining if f.severity >= Severity.HIGH]
    assert highs == [], "new HIGH findings:\n" + "\n".join(
        f.text() for f in highs
    )
    assert remaining == [], "new findings (fix or baseline with " \
        "justification):\n" + "\n".join(f.text() for f in remaining)


def test_baseline_entries_are_justified():
    baseline = Baseline.load(BASELINE)
    assert baseline.entries
    for e in baseline.entries:
        assert e.justification.strip(), f"unjustified baseline entry: {e}"
        assert not e.justification.lower().startswith("todo"), e
        assert e.file.startswith("predictionio_tpu_torch/"), e


def test_baseline_holds_exactly_the_reviewed_entries():
    """12 entries: the JAX baseline's counterparts (the daemon's two
    cross-process waits, the costs/quality process defaults, the e2
    next-state read, the external engine's host-side .item()) and the
    port's one-sync-per-answer reads at the serving boundary."""
    got = Counter(
        (e.rule, e.file.removeprefix("predictionio_tpu_torch/"))
        for e in Baseline.load(BASELINE).entries
    )
    assert got == Counter({
        ("PIO-CONC002", "tools/daemon.py"): 2,
        ("PIO-CONC004", "obs/costs.py"): 1,
        ("PIO-CONC004", "obs/quality.py"): 1,
        ("PIO-TORCH001", "e2/engine.py"): 2,
        ("PIO-TORCH008", "models/external/engine.py"): 1,
        ("PIO-TORCH008", "models/classification/engine.py"): 1,
        ("PIO-TORCH008", "models/ecommerce/engine.py"): 1,
        ("PIO-TORCH008", "models/similarproduct/engine.py"): 1,
        ("PIO-TORCH008", "parallel/placement.py"): 2,
    })


def test_baseline_has_no_stale_entries(report):
    live = Counter((f.rule, f.file, f.source) for f in report.findings)
    stale = [e for e in Baseline.load(BASELINE).entries if not live[e.key]]
    assert stale == [], "stale baseline entries:\n" + "\n".join(
        f"{e.file}: {e.rule}: {e.source}" for e in stale
    )


def test_no_lock_order_findings_package_wide(report):
    """Zero PIO-LOCK001/002 findings, and none baselined: the compiler
    under ``_kernels._lock`` and the shard folds under ``Compactor._lock``
    are repaired, not excused."""
    lock = [f for f in report.findings if f.rule.startswith("PIO-LOCK")]
    assert lock == [], "\n".join(f.text() for f in lock)
    assert [
        e for e in Baseline.load(BASELINE).entries
        if e.rule.startswith("PIO-LOCK")
    ] == []


def test_the_two_deliberate_polls_carry_their_pragmas():
    for rel in ("parallel/placement.py", "data/storage/remote_backend.py"):
        r = analyze_paths([PACKAGE / rel], root=REPO_ROOT)
        assert [f for f in r.findings if f.rule == "PIO-CONC002"] == [], rel
        assert r.pragma_suppressed == 1, rel


def test_busy_wait_fix_stays_fixed():
    r = analyze_paths([PACKAGE / "server" / "microbatch.py"], root=REPO_ROOT)
    assert [f for f in r.findings if f.rule == "PIO-CONC002"] == []
    assert r.pragma_suppressed == 0


def test_obs_modules_lint_clean(report):
    r = analyze_paths([PACKAGE / "obs"], root=REPO_ROOT)
    assert r.errors == []
    remaining, _ = Baseline.load(BASELINE).filter(r.findings)
    assert remaining == [], "\n".join(f.text() for f in remaining)
    assert sorted((f.rule, f.file) for f in r.findings) == [
        ("PIO-CONC004", "predictionio_tpu_torch/obs/costs.py"),
        ("PIO-CONC004", "predictionio_tpu_torch/obs/quality.py"),
    ]
    assert r.pragma_suppressed == 0


def test_analysis_modules_lint_clean_with_zero_pragmas():
    """The tool that gates the package gets no exemptions from itself."""
    r = analyze_paths([PACKAGE / "analysis"], root=REPO_ROOT)
    assert r.errors == [] and r.files_scanned == 14
    assert r.findings == [], "\n".join(f.text() for f in r.findings)
    assert r.pragma_suppressed == 0
    assert [
        e for e in Baseline.load(BASELINE).entries
        if e.file.startswith("predictionio_tpu_torch/analysis/")
    ] == []


def test_torch_findings_are_all_baselined(report):
    torch_fs = [f for f in report.findings if f.rule.startswith("PIO-TORCH")]
    remaining, suppressed = Baseline.load(BASELINE).filter(torch_fs)
    assert remaining == [] and suppressed == 8


def test_static_lock_graph_is_acyclic_and_sees_contended_locks(program):
    edges = {(e.src, e.dst) for e in program.lock_edges()}
    assert edges, "lock graph empty: the scan stopped seeing the package"
    assert [(a, b) for a, b in edges if (b, a) in edges] == []
    named = [n for n in program.locks.values() if n.witness]
    assert len(named) >= 5  # the port's ContendedLock/Condition adopters


def test_runtime_edges_are_subgraph_of_static_graph():
    from predictionio_tpu_torch.analysis.callgraph import build_program
    from predictionio_tpu_torch.analysis.rules import parse_module
    from predictionio_tpu_torch.obs import contention
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry

    src = (
        "from predictionio_tpu_torch.obs.contention import ContendedLock\n"
        "A = ContendedLock('tsg-alpha')\n"
        "B = ContendedLock('tsg-beta')\n"
        "def ab():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
    )
    allow = build_program([parse_module(None, "sg_mod.py", src)]).witness_edge_allowlist()
    assert allow == {("tsg-alpha", "tsg-beta")}
    w = contention.enable_witness()
    try:
        a = contention.ContendedLock("tsg-alpha", registry=MetricsRegistry())
        b = contention.ContendedLock("tsg-beta", registry=MetricsRegistry())
        with a:
            with b:
                pass
        assert {e for e in w.edge_set() if e[0].startswith("tsg-")} <= allow
        assert ("tsg-alpha", "tsg-beta") in w.edge_set()
    finally:
        contention.disable_witness()


def test_witness_e2e_serving_exercise_within_static_graph(program):
    """Hammer the ContendedLock adopters a serving process runs per request
    (microbatch waves, quality observations, admission, a metrics scrape)
    with the witness on: no inversion, and every executed edge lies inside
    the static graph's witness allowlist."""
    import asyncio

    from predictionio_tpu_torch.obs import contention
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.obs.quality import QualityMonitor
    from predictionio_tpu_torch.resilience.admission import AdmissionController
    from predictionio_tpu_torch.server.microbatch import MicroBatcher

    w = contention.enable_witness()
    try:
        reg = MetricsRegistry()
        quality = QualityMonitor(registry=reg)
        admission = AdmissionController(max_inflight=8, registry=reg)

        async def one_caller(b, n):
            return [await b.submit(i) for i in range(n)]

        def run_loop():
            async def main():
                b = MicroBatcher(lambda xs: [x * 2 for x in xs], max_batch=4,
                                 registry=reg)
                await asyncio.gather(*(one_caller(b, 8) for _ in range(4)))
                b.close()

            asyncio.run(main())

        callers = [threading.Thread(target=run_loop) for _ in range(2)]
        for t in callers:
            t.start()
        for i in range(200):
            quality.observe_prediction(f"e2e-{i}", {"q": i}, {"p": i})
            if admission.try_acquire():
                admission.release()
        for t in callers:
            t.join()
        reg.render_prometheus()
        snap = w.snapshot()
        assert snap["violations"] == [], snap["violations"]
        allow = program.witness_edge_allowlist()
        assert w.edge_set() <= allow, sorted(w.edge_set() - allow)
    finally:
        contention.disable_witness()


# -- the two lock repairs, by behavior ----------------------------------------

_FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(f"start {{os.getpid()}} {{time.monotonic()}} {{sys.argv[-1]}}\\n")
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "1.0")))
with open(out, "w") as f:
    f.write("built:" + os.path.basename(sys.argv[-1]))
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(f"end {{os.getpid()}} {{time.monotonic()}} {{sys.argv[-1]}}\\n")
"""


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """A ``$CUDA_HOME/bin/nvcc`` that sleeps, then writes its -o file; the
    loader's ctypes open is stubbed, since the file is no library."""
    from predictionio_tpu_torch.ops import _kernels

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("PIO_KERNEL_BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_kernels, "_loaded", {})
    monkeypatch.setattr(_kernels, "_building", {}, raising=False)
    opened = []

    def fake_cdll(path):
        opened.append(path)
        assert Path(path).read_text().startswith("built:")
        return types.SimpleNamespace(**{
            entry: types.SimpleNamespace() for _, entry, _ in _kernels.KERNELS.values()
        })

    monkeypatch.setattr(_kernels.ctypes, "CDLL", fake_cdll)
    return _kernels, log, opened


def _spawns(log: Path) -> list[str]:
    return [ln for ln in log.read_text().splitlines() if ln.startswith("start")]


def test_one_build_per_source_for_two_threads(fake_nvcc, monkeypatch):
    _kernels, log, opened = fake_nvcc
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.0")
    got, errors = [], []

    def load():
        try:
            got.append(_kernels.load("fused_topk"))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errors == []
    assert len(got) == 2 and got[0] is got[1]
    assert len(_spawns(log)) == 1  # one compiler for one source
    lib = _kernels.library_path("fused_topk")
    assert lib.read_text() == "built:fused_topk.cu"
    assert list(lib.parent.glob("*.tmp")) == []
    # the other entry point of the same library needs no second build
    _kernels.load("fused_topk_smem")
    assert len(_spawns(log)) == 1


def test_a_built_source_never_waits_on_another_build(fake_nvcc, monkeypatch):
    """While kernel 1's source builds (slowly) in one thread, a thread that
    wants kernel 3, already built, gets it at once: the loader holds no
    lock across the compiler."""
    _kernels, log, _ = fake_nvcc
    topk = _kernels.library_path("fused_topk")
    topk.parent.mkdir(parents=True, exist_ok=True)
    topk.write_text("built:fused_topk.cu")
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "3.0")
    slow = threading.Thread(target=_kernels.load, args=("als_fused_accum",))
    slow.start()
    deadline = time.monotonic() + 20
    while not _spawns(log) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _spawns(log), "the slow build never started"
    t0 = time.perf_counter()
    _kernels.load("fused_topk")
    waited = time.perf_counter() - t0
    assert slow.is_alive()  # the slow build was in flight throughout
    slow.join(timeout=30)
    assert waited < 1.0, f"waited {waited:.2f} s on another source's build"
    assert _kernels.library_path("als_fused_accum").read_text() == "built:als_accum.cu"


def test_two_sources_build_side_by_side(fake_nvcc, monkeypatch):
    _kernels, log, _ = fake_nvcc
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.5")
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=_kernels.load, args=(name,))
        for name in ("als_fused_accum", "fused_topk", "als_segment_accum",
                     "fused_topk_smem")
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    spent = time.perf_counter() - t0
    spawns = _spawns(log)
    assert sorted(s.rsplit("/", 1)[1] for s in spawns) == [
        "als_accum.cu", "fused_topk.cu"
    ]
    assert spent < 2 * 1.5, f"{spent:.2f} s: the two builds ran one after the other"


def test_compactor_awaits_no_fold_under_its_lock(tmp_path):
    """While a pass is folding, ``Compactor._lock`` is free; a second
    concurrent tick waits for the pass, then folds nothing: each app is
    folded once and the counters add up to one pass's."""
    from datetime import datetime, timedelta, timezone

    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.compactor import (
        CompactionPolicy,
        Compactor,
    )
    from predictionio_tpu_torch.data.storage.parquet_backend import (
        ParquetClient,
        ParquetEventStore,
        ParquetLEvents,
    )

    client = ParquetClient(tmp_path / "pq", n_shards=2)
    le = ParquetLEvents(client)
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    for app in (1, 2):
        le.init(app)
        for batch in range(3):
            le.insert_batch([
                Event(event="view", entity_type="user", entity_id=f"u{j}",
                      event_time=t0 + timedelta(seconds=batch * 10 + j))
                for j in range(8)
            ], app)
    comp = Compactor(client, CompactionPolicy(min_hot_segments=2))
    entered, release = threading.Event(), threading.Event()
    folds: list[int] = []
    real = ParquetEventStore.compact

    def gated(store, app_id, channel_id=None):
        folds.append(app_id)
        entered.set()
        release.wait(timeout=30)
        return real(store, app_id, channel_id)

    comp.store.compact = types.MethodType(gated, comp.store)
    out: list[dict] = []
    first = threading.Thread(target=lambda: out.append(comp.tick()))
    first.start()
    assert entered.wait(timeout=30)
    # mid-fold: the lock is not held across the store's futures
    assert comp._lock.acquire(timeout=2.0), "Compactor._lock held across a fold"
    comp._lock.release()
    second = threading.Thread(target=lambda: out.append(comp.tick()))
    second.start()
    time.sleep(0.2)
    assert folds == [1]  # the second pass waits for the first
    release.set()
    first.join(timeout=60)
    second.join(timeout=60)
    assert sorted(folds) == [1, 2]
    assert sum(s["apps_compacted"] for s in out) == 2
    assert sum(s["rows_folded"] for s in out) == max(s["rows_folded"] for s in out) > 0
    assert [s["errors"] for s in out] == [[], []]
    assert len(list(le.find(1))) == 24 and len(list(le.find(2))) == 24
