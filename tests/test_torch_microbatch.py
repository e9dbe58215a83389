"""The port's MicroBatcher (``predictionio_tpu_torch.server.microbatch``)
against the JAX package's, case for case.

Every case runs on both batchers (parametrised ``impl``): the JAX
package's ``tests/test_serving_async.py::TestMicroBatcher`` and
``tests/test_resilience.py::TestMicroBatcherShedding``/``SoloRetry`` cases
(the fault-seam case aside: the port has no fault injector), then the
pipelined cases: FIFO resolution, the bound on waves between dispatch and
fence, a deadline re-checked at the fence, the fence's meta, a failed fence
retried item by item, and pipelining off.  Waits are on conditions, not
fixed sleeps, wherever the order matters; every wait is bounded.
"""

from __future__ import annotations

import asyncio
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu.resilience import LoadShed as JaxLoadShed
from predictionio_tpu.resilience import deadline as jax_deadline
from predictionio_tpu.server import microbatch as jax_mb
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience import LoadShed
from predictionio_tpu_torch.resilience import deadline as pt_deadline
from predictionio_tpu_torch.server import microbatch as pt_mb

torch.set_num_threads(2)

IMPLS = {
    "torch": SimpleNamespace(
        MicroBatcher=pt_mb.MicroBatcher, PendingWave=pt_mb.PendingWave,
        LoadShed=LoadShed, deadline=pt_deadline, Registry=MetricsRegistry,
    ),
    "jax": SimpleNamespace(
        MicroBatcher=jax_mb.MicroBatcher, PendingWave=jax_mb.PendingWave,
        LoadShed=JaxLoadShed, deadline=jax_deadline, Registry=JaxRegistry,
    ),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=20))


async def _until(pred, timeout: float = 5.0) -> None:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached")
        await asyncio.sleep(0.002)


def _value(reg, name, *labels):
    return reg.get(name).labels(*labels).value


def _held():
    """(started, release): a batch_fn sets ``started`` once its held wave
    is inside it, and waits on ``release``."""
    return threading.Event(), threading.Event()


# -- the JAX package's TestMicroBatcher cases ---------------------------------


def test_coalesces_concurrent_submits(impl):
    waves: list[int] = []

    def batch_fn(items):
        waves.append(len(items))
        time.sleep(0.02)  # hold the dispatch so others queue
        return [i * 2 for i in items]

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=64, registry=impl.Registry())
        return await asyncio.gather(*(b.submit(i) for i in range(32)))

    assert _run(run()) == [i * 2 for i in range(32)]
    assert sum(waves) == 32
    assert max(waves) > 1  # later waves coalesced while wave 1 slept


def test_max_batch_cap(impl):
    waves: list[int] = []

    def batch_fn(items):
        waves.append(len(items))
        time.sleep(0.01)
        return list(items)

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=4, registry=impl.Registry())
        return await asyncio.gather(*(b.submit(i) for i in range(20)))

    assert _run(run()) == list(range(20))
    assert max(waves) <= 4


@pytest.mark.parametrize(
    "batch_fn,match",
    [
        (lambda items: (_ for _ in ()).throw(RuntimeError("boom")), "boom"),
        (lambda items: list(items) + [99], "results"),  # one result too many
    ],
    ids=["error_propagates", "wrong_result_count_raises"],
)
def test_batch_fn_failure_reaches_the_caller(impl, batch_fn, match):
    async def run():
        b = impl.MicroBatcher(batch_fn, registry=impl.Registry())
        with pytest.raises(RuntimeError, match=match):
            await b.submit(1)

    _run(run())


def test_close_fails_queued_and_rejects_new_submits(impl):
    started, release = _held()

    def batch_fn(items):
        started.set()
        release.wait(5)  # hold wave 1 so later submits stay queued
        return list(items)

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=1, registry=impl.Registry())
        first = asyncio.ensure_future(b.submit(1))
        await _until(started.is_set)
        queued = asyncio.ensure_future(b.submit(2))
        await _until(lambda: len(b._pending) == 1)
        close_task = asyncio.get_running_loop().run_in_executor(None, b.close)
        await _until(lambda: b.draining)
        release.set()
        await close_task
        assert await first == 1  # the in-flight wave still resolves
        with pytest.raises(RuntimeError, match="closed"):
            await queued
        with pytest.raises(RuntimeError, match="closed"):
            await b.submit(3)

    _run(run())


def test_close_wakes_on_wave_end_without_polling(impl):
    started, release = _held()

    def batch_fn(items):
        started.set()
        release.wait(5)
        return list(items)

    reg = impl.Registry()

    async def run():
        b = impl.MicroBatcher(batch_fn, drain_timeout_s=10.0, registry=reg)
        fut = asyncio.ensure_future(b.submit(1))
        await _until(started.is_set)
        close_task = asyncio.get_running_loop().run_in_executor(None, b.close)
        await _until(lambda: b.draining)
        t0 = time.perf_counter()
        release.set()
        await close_task
        waited = time.perf_counter() - t0
        assert await fut == 1
        return waited

    assert _run(run()) < 1.0  # a condition wakeup, not the drain deadline
    assert _value(reg, "pio_microbatch_drain_timeout_total") == 0


def test_close_drain_timeout_still_bounded(impl):
    started, hang = _held()

    def batch_fn(items):
        started.set()
        hang.wait(5)
        return list(items)

    reg = impl.Registry()

    async def run():
        b = impl.MicroBatcher(batch_fn, drain_timeout_s=0.1, registry=reg)
        fut = asyncio.ensure_future(b.submit(1))
        await _until(started.is_set)
        t0 = time.perf_counter()
        await asyncio.get_running_loop().run_in_executor(None, b.close)
        elapsed = time.perf_counter() - t0
        hang.set()  # release the abandoned daemon worker
        fut.cancel()
        return elapsed

    assert _run(run()) < 2.0  # bounded by drain_timeout_s, not by batch_fn
    assert _value(reg, "pio_microbatch_drain_timeout_total") == 1


def test_wave_histogram_snapshot_under_load(impl):
    stop = threading.Event()
    errors: list[BaseException] = []

    async def run():
        b = impl.MicroBatcher(
            lambda items: list(items), max_batch=8, registry=impl.Registry()
        )

        def reader():
            try:
                while not stop.is_set():
                    for size, n in b.wave_histogram().items():
                        assert size > 0 and n > 0
            except BaseException as e:  # the failure signal
                errors.append(e)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for _ in range(50):
            await asyncio.gather(*(b.submit(i) for i in range(8)))
        stop.set()
        t.join(timeout=2)
        return b

    b = _run(run())
    assert not errors
    assert sum(size * n for size, n in b.wave_histogram().items()) == 400


# -- the JAX package's TestMicroBatcherShedding cases -------------------------


def test_bounded_queue_sheds(impl):
    reg = impl.Registry()
    started, release = _held()

    def batch_fn(items):
        started.set()
        release.wait(5)
        return list(items)

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=1, max_queue=2, registry=reg)
        first = asyncio.ensure_future(b.submit("w"))
        await _until(started.is_set)
        q1 = asyncio.ensure_future(b.submit(1))
        q2 = asyncio.ensure_future(b.submit(2))
        await _until(lambda: len(b._pending) == 2)  # the queue is full
        with pytest.raises(impl.LoadShed) as ei:
            await b.submit(3)
        assert ei.value.retry_after_s > 0
        release.set()
        assert await first == "w"
        assert await q1 == 1 and await q2 == 2

    _run(run())
    assert _value(reg, "pio_shed_total", "queue") == 1


def test_expired_items_resolve_before_dispatch(impl):
    reg = impl.Registry()
    started, release = _held()
    dispatched: list[list] = []

    def batch_fn(items):
        if items == ["warm"]:
            started.set()
            release.wait(5)
            return ["warm-ok"]
        dispatched.append(list(items))
        return [i * 2 for i in items]

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=8, registry=reg)
        warm = asyncio.ensure_future(b.submit("warm"))
        await _until(started.is_set)  # wave 1 held: a queue forms behind it
        tok = impl.deadline.set_deadline(0.01)  # 10 ms budget
        doomed = asyncio.ensure_future(b.submit(7))
        impl.deadline.reset_deadline(tok)
        healthy = asyncio.ensure_future(b.submit(5))
        await asyncio.sleep(0.1)  # past doomed's budget, still queued
        release.set()
        assert await warm == "warm-ok"
        with pytest.raises(impl.deadline.DeadlineExceeded):
            await doomed
        assert await healthy == 10

    _run(run())
    assert dispatched == [[5]]  # the expired item never reached batch_fn
    assert _value(reg, "pio_microbatch_deadline_expired_total") == 1


def test_wave_binds_earliest_deadline_around_batch_fn(impl):
    seen: list[float | None] = []
    started, release = _held()

    def batch_fn(items):
        if items == ["warm"]:
            started.set()
            release.wait(5)
            return ["warm-ok"]
        seen.append(impl.deadline.remaining())
        return list(items)

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=8, registry=impl.Registry())
        warm = asyncio.ensure_future(b.submit("warm"))
        await _until(started.is_set)
        tok = impl.deadline.set_deadline(30.0)
        a = asyncio.ensure_future(b.submit("a"))
        impl.deadline.reset_deadline(tok)
        c = asyncio.ensure_future(b.submit("c"))  # no deadline
        await _until(lambda: len(b._pending) == 2)
        release.set()
        await asyncio.gather(warm, a, c)

    _run(run())
    # batch_fn saw the wave's tightest budget (~30 s, not None)
    assert len(seen) == 1 and seen[0] is not None and seen[0] < 30.0


# -- the JAX package's TestMicroBatcherSoloRetry cases ------------------------


def test_poison_fails_alone_wave_mates_succeed(impl):
    reg = impl.Registry()
    started, release = _held()

    def batch_fn(items):
        if items == ["warm"]:
            started.set()
            release.wait(5)
            return ["warm-ok"]
        if "poison" in items:
            if len(items) > 1:
                raise RuntimeError("wave poisoned")
            raise ValueError("poison alone")
        return [i * 2 for i in items]

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=8, registry=reg)
        warm = asyncio.ensure_future(b.submit("warm"))
        await _until(started.is_set)
        futs = [asyncio.ensure_future(b.submit(x)) for x in [1, "poison", 3]]
        await _until(lambda: len(b._pending) == 3)  # one wave of three
        release.set()
        assert await warm == "warm-ok"
        assert await futs[0] == 2
        # the poison item fails with ITS OWN error, not the wave's
        with pytest.raises(ValueError, match="poison alone"):
            await futs[1]
        assert await futs[2] == 6

    _run(run())
    assert _value(reg, "pio_microbatch_solo_retry_total") == 1


def test_solo_retry_disabled_fails_whole_wave(impl):
    started, release = _held()

    def batch_fn(items):
        if items == ["warm"]:
            started.set()
            release.wait(5)
            return ["warm-ok"]
        raise RuntimeError("wave boom")

    async def run():
        b = impl.MicroBatcher(
            batch_fn, max_batch=8, solo_retry=False, registry=impl.Registry()
        )
        warm = asyncio.ensure_future(b.submit("warm"))
        await _until(started.is_set)
        futs = [asyncio.ensure_future(b.submit(x)) for x in (1, 2)]
        await _until(lambda: len(b._pending) == 2)
        release.set()
        await warm
        for f in futs:
            with pytest.raises(RuntimeError, match="wave boom"):
                await f

    _run(run())


def test_close_racing_solo_retry_stays_bounded(impl):
    started, release_warm = _held()
    solo_started, release_solo = threading.Event(), threading.Event()

    def batch_fn(items):
        if items == ["warm"]:
            started.set()
            release_warm.wait(5)
            return ["warm-ok"]
        if len(items) > 1:
            raise RuntimeError("wave boom")
        solo_started.set()
        release_solo.wait(5)  # hold the FIRST solo item
        return [items[0] * 10]

    async def run():
        b = impl.MicroBatcher(
            batch_fn, max_batch=8, drain_timeout_s=5.0, registry=impl.Registry()
        )
        warm = asyncio.ensure_future(b.submit("warm"))
        await _until(started.is_set)
        futs = [asyncio.ensure_future(b.submit(x)) for x in (1, 2, 3)]
        await _until(lambda: len(b._pending) == 3)
        release_warm.set()  # wave [1, 2, 3] -> boom -> the solo pass
        await _until(solo_started.is_set)
        close_task = asyncio.get_running_loop().run_in_executor(None, b.close)
        await _until(lambda: b.draining)
        t0 = time.perf_counter()
        release_solo.set()
        await close_task
        closed_in = time.perf_counter() - t0
        assert await warm == "warm-ok"
        assert await futs[0] == 10  # the in-flight solo item still lands
        for f in futs[1:]:  # the rest: the wave error, not leaked
            with pytest.raises(RuntimeError, match="wave boom"):
                await f
        return closed_in

    assert _run(run()) < 2.0


def test_shutdown_resolves_expired_and_queued_items(impl):
    reg = impl.Registry()
    started, release = _held()

    def batch_fn(items):
        started.set()
        release.wait(5)
        return list(items)

    async def run():
        b = impl.MicroBatcher(batch_fn, max_batch=1, registry=reg)
        warm = asyncio.ensure_future(b.submit("w"))
        await _until(started.is_set)
        tok = impl.deadline.set_deadline(0.005)
        expired_fut = asyncio.ensure_future(b.submit("late"))
        impl.deadline.reset_deadline(tok)
        fresh_fut = asyncio.ensure_future(b.submit("fresh"))
        await _until(lambda: len(b._pending) == 2)
        await asyncio.sleep(0.05)  # "late" is now past its budget
        close_task = asyncio.get_running_loop().run_in_executor(None, b.close)
        await _until(lambda: b.draining)
        release.set()
        await close_task
        assert await warm == "w"
        with pytest.raises(impl.deadline.DeadlineExceeded):
            await expired_fut
        with pytest.raises(RuntimeError, match="closed"):
            await fresh_fut

    _run(run())
    assert _value(reg, "pio_microbatch_deadline_expired_total") == 1


# -- pipelined waves ----------------------------------------------------------


class _Pipeline:
    """A batch_fn whose waves dispatch at once and fence on a per-wave
    event: it counts dispatches and fences and records resolution order."""

    def __init__(self, impl, fail_fence_of=None, auto_open=False):
        self.impl = impl
        self.lock = threading.Lock()
        self.gates: list[threading.Event] = []
        self.dispatched = 0
        self.fenced = 0
        self.fail_fence_of = fail_fence_of
        self.auto_open = auto_open

    def __call__(self, items):
        with self.lock:
            self.dispatched += 1
            gate = threading.Event()
            if self.auto_open:
                gate.set()
            self.gates.append(gate)

        def finalize():
            gate.wait(5)
            with self.lock:
                self.fenced += 1
            if self.fail_fence_of in items and len(items) > 1:
                raise RuntimeError("fence failed")
            return [f"r{i}" for i in items]

        return self.impl.PendingWave(finalize)

    def open(self, n=None):
        with self.lock:
            for g in self.gates[:n]:
                g.set()


def test_pipelined_waves_resolve_fifo_with_their_meta(impl):
    pipe = _Pipeline(impl)
    order: list[int] = []

    async def run():
        b = impl.MicroBatcher(
            pipe, max_batch=1, max_inflight_waves=2, registry=impl.Registry()
        )
        metas = [{} for _ in range(4)]
        futs = [asyncio.ensure_future(b.submit(i, metas[i])) for i in range(4)]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _f, i=i: order.append(i))
        await _until(lambda: pipe.dispatched == 4)  # all dispatched unfenced
        pipe.gates[3].set()  # the last wave's fence first: must not jump
        pipe.gates[2].set()
        await asyncio.sleep(0.05)
        assert order == []
        pipe.open()
        assert await asyncio.gather(*futs) == ["r0", "r1", "r2", "r3"]
        return metas

    metas = _run(run())
    assert order == [0, 1, 2, 3]
    for m in metas:
        assert m["pipelined"] is True and m["wave_size"] == 1
        assert 1 <= m["inflight_depth"] <= 2
        assert m["dispatch_s"] >= 0 and m["finalize_s"] >= 0
        assert m["device_s"] == pytest.approx(
            m["dispatch_s"] + m["finalize_s"], abs=2e-6
        )
    assert [m["wave_seq"] for m in metas] == sorted(m["wave_seq"] for m in metas)
    assert any(m["inflight_depth"] == 2 for m in metas)


@pytest.mark.parametrize("depth", [1, 2])
def test_at_most_depth_waves_wait_for_the_fence(impl, depth):
    pipe = _Pipeline(impl)

    async def run():
        b = impl.MicroBatcher(
            pipe, max_batch=1, max_inflight_waves=depth, registry=impl.Registry()
        )
        futs = [asyncio.ensure_future(b.submit(i)) for i in range(8)]
        # wave 1 fencing, `depth` waves queued behind it, and one more
        # dispatched and blocked on the bound: no further dispatch
        await _until(lambda: pipe.dispatched == depth + 2)
        await asyncio.sleep(0.05)
        assert pipe.dispatched == depth + 2 and pipe.fenced == 0
        assert len(b._inflight) == depth
        assert b.busy
        pipe.open()
        while not all(f.done() for f in futs):
            pipe.open()
            await asyncio.sleep(0.002)
        assert [f.result() for f in futs] == [f"r{i}" for i in range(8)]
        await _until(lambda: not b.busy)

    _run(run())
    assert pipe.fenced == 8


def test_deadline_rechecked_at_the_fence(impl):
    pipe = _Pipeline(impl)
    reg = impl.Registry()

    async def run():
        b = impl.MicroBatcher(pipe, max_batch=8, registry=reg)
        hold = asyncio.ensure_future(b.submit("hold"))
        await _until(lambda: pipe.dispatched == 1)  # wave 1 waits at its fence
        tok = impl.deadline.set_deadline(0.05)
        meta: dict = {}
        doomed = asyncio.ensure_future(b.submit("doomed", meta))
        impl.deadline.reset_deadline(tok)
        mate = asyncio.ensure_future(b.submit("mate"))
        # wave 2 dispatches inside its budget, then outlives it in the pipe
        await _until(lambda: pipe.dispatched >= 2)
        await asyncio.sleep(0.1)
        pipe.open()
        assert await hold == "rhold"
        with pytest.raises(impl.deadline.DeadlineExceeded):
            await doomed
        assert await mate == "rmate"
        return meta

    meta = _run(run())
    assert meta["deadline_expired"] is True
    assert pipe.fenced == pipe.dispatched  # every fence ran (it releases slots)
    assert _value(reg, "pio_microbatch_deadline_expired_total") == 1


def test_failed_fence_is_retried_item_by_item(impl):
    pipe = _Pipeline(impl, fail_fence_of="bad")
    reg = impl.Registry()

    async def run():
        b = impl.MicroBatcher(
            pipe, max_batch=8, max_inflight_waves=1, registry=reg
        )
        # three held waves: one fencing, one queued, one dispatched and
        # blocked on the bound — so the next three items form one wave
        holds = []
        for n in range(3):
            holds.append(asyncio.ensure_future(b.submit(f"h{n}")))
            await _until(lambda: pipe.dispatched == n + 1)
        futs = [asyncio.ensure_future(b.submit(x)) for x in ("a", "bad", "c")]
        await _until(lambda: len(b._pending) == 3)
        while not all(f.done() for f in futs):
            pipe.open()
            await asyncio.sleep(0.002)
        assert await asyncio.gather(*holds) == ["rh0", "rh1", "rh2"]
        # the solo pass answers each item alone, fence included
        assert [f.result() for f in futs] == ["ra", "rbad", "rc"]

    _run(run())
    assert _value(reg, "pio_microbatch_solo_retry_total") == 1
    assert pipe.dispatched == 3 + 1 + 3


def test_stress_pipelined_waves_lose_no_item(impl):
    # many small pipelined waves with the interpreter switching threads as
    # often as it can: a lost update of the queue, the in-flight deque or
    # the histogram would drop, repeat or misroute an item
    import sys

    pipe = _Pipeline(impl, auto_open=True)
    n = 1000

    async def run():
        b = impl.MicroBatcher(
            pipe, max_batch=8, max_inflight_waves=2, max_queue=None,
            registry=impl.Registry(),
        )
        got = await asyncio.gather(*(b.submit(i) for i in range(n)))
        await _until(lambda: not b.busy)
        return got, b.wave_histogram()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, waves = _run(run())
    finally:
        sys.setswitchinterval(switch)
    assert got == [f"r{i}" for i in range(n)]
    assert sum(size * k for size, k in waves.items()) == n
    assert pipe.dispatched == pipe.fenced == sum(waves.values())


def test_pipelining_off_finalizes_inline(impl):
    pipe = _Pipeline(impl, auto_open=True)

    async def run():
        b = impl.MicroBatcher(
            pipe, max_batch=4, max_inflight_waves=0, registry=impl.Registry()
        )
        metas = [{} for _ in range(6)]
        got = await asyncio.gather(*(b.submit(i, metas[i]) for i in range(6)))
        assert b._finalizer is None  # no finalizer thread: fenced inline
        return got, metas

    got, metas = _run(run())
    assert got == [f"r{i}" for i in range(6)]
    assert all(m["pipelined"] and m["inflight_depth"] == 0 for m in metas)
