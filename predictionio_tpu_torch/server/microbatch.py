"""Query micro-batching: coalesce concurrent in-flight queries into one
wave.

The JAX package's ``server/microbatch.py``.  ``MicroBatcher`` implements
*natural batching* (no artificial delay): the first query dispatches
immediately; queries arriving while a wave is in flight queue up and go out
together in the next wave, capped at ``max_batch``.  At low load every
query is solo (minimum latency); at high load waves grow to the cap
(maximum throughput).  Waves run on ONE long-lived daemon worker thread,
which also serializes device dispatch — daemon so a wedged ``batch_fn`` (a
stalled device wave) can never block interpreter exit.

Resilience semantics:

- the queue is *bounded* (``max_queue``): past the bound, ``submit`` sheds
  with :class:`~predictionio_tpu_torch.resilience.LoadShed` (503 +
  Retry-After) instead of letting the backlog grow without limit;
- each item captures the submitter's deadline; items whose deadline passed
  while queued resolve with ``DeadlineExceeded`` *before* the wave
  dispatches, and the wave's earliest deadline is re-bound around
  ``batch_fn``;
- a ``batch_fn`` exception on a multi-item wave triggers ONE bounded
  solo-retry pass, so a poison query fails alone instead of failing its
  wave-mates.

**Pipelined dispatch**: a ``batch_fn`` that returns a :class:`PendingWave`
splits the wave into a *dispatch* half (parse, gather, upload, the
asynchronous kernel launch and device-to-host copy — everything up to the
fence) and a *finalize* half (wait for the wave's CUDA event, render) that
runs on a dedicated finalizer thread.  The worker is then free to dispatch
wave N+1 while wave N's fence drains, bounded by ``max_inflight_waves``.
Results resolve in wave order (one FIFO finalizer); deadline, solo-retry
and ``close()`` semantics are those of the synchronous path, and per-item
meta carries the ``dispatch_s``/``finalize_s`` split, ``pipelined: True``
and the ``inflight_depth`` the wave was enqueued at.

**Observability**: every ``batch_fn`` call runs inside a wave timeline
(``obs.device.wave_timeline``) that collects the engine's stage marks; a
pipelined wave's dispatch-half timeline rides to the finalizer thread and
is merged with the finalize half's, so one breakdown covers the wave.  The
breakdown (``host_gather``/``h2d``/``compute``/``d2h`` + ``other``, host
time that sums to ``device_s``) lands in ``pio_microbatch_stage_seconds``
and in each item's meta as ``device_breakdown``, beside the wave's device
time ``wave_kernel_s`` (CUDA events on a card), its entry point and cost,
its device, its dispatch wall clock ``wave_t0`` and its request ids.  The
first member's request and trace context are re-bound around ``batch_fn``,
each wave's request ids go to the ``/logs.json`` ring, and the condition
every thread serializes on is a ``ContendedCondition`` (its blocked waits
land in ``pio_lock_wait_seconds{lock="microbatch"}``).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Sequence

from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs.contention import ContendedCondition
from predictionio_tpu_torch.obs.disttrace import (
    bind_fragments,
    bind_parent_span,
    current_trace_context,
    fragments_wanted,
    reset_fragments,
    reset_parent_span,
)
from predictionio_tpu_torch.obs.logging import (
    get_request_id,
    reset_request_context,
    ring_debug,
    set_request_context,
)
from predictionio_tpu_torch.obs.metrics import (
    REGISTRY,
    SIZE_BUCKETS,
    MetricsRegistry,
)
from predictionio_tpu_torch.resilience import LoadShed, faults
from predictionio_tpu_torch.resilience.admission import shed_counter
from predictionio_tpu_torch.resilience.deadline import (
    DeadlineExceeded,
    deadline_scope,
    get_deadline,
)
from predictionio_tpu_torch.resilience.deadline import _now as _deadline_now

log = logging.getLogger("predictionio_tpu_torch.microbatch")


class PendingWave:
    """A dispatched-but-unfenced wave: ``batch_fn`` returns one of these
    when it has already done the pre-fence work (gather, upload, the
    asynchronous launch; NO blocking) and defers the fence.  ``finalize()``
    runs on the MicroBatcher's finalizer thread, waits for the wave's
    device results, and returns one result per item in order — the only
    place the pipeline synchronizes."""

    __slots__ = ("finalize",)

    def __init__(self, finalize: Callable[[], Sequence[Any]]):
        self.finalize = finalize


class _Entry:
    """One submitted item: its future, enqueue time, the caller's meta dict,
    the deadline captured at submit, and the submitter's request id and
    trace context (trace id + innermost open span; None for a request that
    records no cross-process fragments)."""

    __slots__ = ("item", "fut", "t_enq", "meta", "deadline", "rid", "tctx")

    def __init__(self, item, fut, t_enq, meta, deadline, rid, tctx):
        self.item = item
        self.fut = fut
        self.t_enq = t_enq
        self.meta = meta
        self.deadline = deadline
        self.rid = rid
        self.tctx = tctx


class _InflightWave:
    """One dispatched wave waiting for its finalize fence."""

    __slots__ = (
        "live", "pending", "wave_seq", "loop", "t_dispatch", "wave_t0",
        "dispatch_s", "timeline", "wave_deadline", "depth_at_enqueue",
    )

    def __init__(self, **kw):
        for name, value in kw.items():
            setattr(self, name, value)


class MicroBatcher:
    """Coalesce ``submit``-ed items into batched ``batch_fn`` calls.

    ``batch_fn(items) -> results`` must return one result per item, in
    order (or a :class:`PendingWave` that will).  It runs on a *dedicated*
    single worker thread, not the loop's default executor, so sync route
    handlers never delay a wave.

    Per-wave telemetry lands in ``registry`` (default: the process
    registry): queue depth, batch size, and the queue-wait vs device-time
    split of a query's latency.
    """

    def __init__(
        self,
        batch_fn: Callable[[Sequence[Any]], Sequence[Any]],
        max_batch: int = 64,
        drain_timeout_s: float = 5.0,
        registry: MetricsRegistry | None = None,
        max_queue: int | None = 1024,
        solo_retry: bool = True,
        max_inflight_waves: int = 2,
    ):
        self.batch_fn = batch_fn
        #: label for the batch_fn fault-injection seam
        self._fault_label = getattr(
            batch_fn, "__qualname__", getattr(batch_fn, "__name__", "batch_fn")
        )
        self.max_batch = max_batch
        #: pipelined waves allowed between dispatch and the finalize fence;
        #: 0 finalizes inline on the worker (pipelining off)
        self.max_inflight_waves = max(int(max_inflight_waves), 0)
        #: how long close() waits for the in-flight waves before abandoning
        #: the daemon threads
        self.drain_timeout_s = drain_timeout_s
        #: queued (not in-flight) items past which submit() sheds with
        #: LoadShed -> 503 + Retry-After; None = unbounded
        self.max_queue = max_queue
        #: retry a failed multi-item wave one item at a time so a poison
        #: query fails alone (one bounded pass, never recursive)
        self.solo_retry = solo_retry
        self._pending: deque[_Entry] = deque()
        #: every submitter, the worker and the finalizer serialize on this
        #: condition; its blocked acquisitions are metered.  Reentrant: a
        #: caller holding it may submit (a burst enqueued under one hold)
        self._cond = ContendedCondition("microbatch", registry=registry)
        self._worker: threading.Thread | None = None
        self._in_wave = False
        self._closed = False
        #: dispatched waves waiting for their fence (FIFO: results resolve
        #: in wave order) + the finalizer's busy flag — close() and ``busy``
        #: treat an unfenced wave exactly like an in-flight one
        self._inflight: deque[_InflightWave] = deque()
        self._finalizing = False
        self._finalizer: threading.Thread | None = None
        #: wave-size histogram for the status page ({batch_size: count})
        self.wave_sizes: dict[int, int] = {}
        #: rolling window of recent wave sizes feeding the coalescing gauge
        self._recent_waves: deque[int] = deque(maxlen=64)
        #: monotonically increasing wave number, exposed through meta
        self._wave_seq = 0
        reg = registry or REGISTRY
        self._m_queue_depth = reg.gauge(
            "pio_microbatch_queue_depth",
            "Queries queued behind the in-flight wave",
        )
        self._m_batch_size = reg.histogram(
            "pio_microbatch_batch_size",
            "Queries coalesced per dispatch wave",
            buckets=SIZE_BUCKETS,
        )
        self._m_queue_wait = reg.histogram(
            "pio_microbatch_queue_wait_seconds",
            "Per-query wait from submit to wave dispatch",
        )
        self._m_device_time = reg.histogram(
            "pio_microbatch_device_seconds",
            "Per-wave batch_fn (device dispatch) duration",
        )
        #: the 4-way split of device_s (host_gather/h2d/compute/d2h, plus
        #: the unattributed remainder as "other"), labeled by the device
        #: the engine marked
        self._m_stage_time = reg.histogram(
            "pio_microbatch_stage_seconds",
            "Per-wave duration split by timeline stage and device",
            labelnames=("stage", "device"),
            buckets=device_obs.WAVE_STAGE_BUCKETS,
        )
        self._m_drain_timeout = reg.counter(
            "pio_microbatch_drain_timeout_total",
            "close() deadlines expired with a wave still in flight",
        )
        self._m_shed = shed_counter(reg).labels("queue")
        self._m_expired = reg.counter(
            "pio_microbatch_deadline_expired_total",
            "Queued queries resolved with a deadline error before dispatch",
        )
        self._m_solo_retry = reg.counter(
            "pio_microbatch_solo_retry_total",
            "Failed waves retried item-by-item to isolate a poison query",
        )
        self._m_coalescing = reg.gauge(
            "pio_microbatch_coalescing_rate",
            "Queries coalesced per dispatch wave over a rolling window",
        )

    def wave_histogram(self) -> dict[int, int]:
        """Consistent snapshot of the wave-size histogram (the worker
        mutates ``wave_sizes`` under the condition)."""
        with self._cond:
            return dict(self.wave_sizes)

    @property
    def draining(self) -> bool:
        """True once close() began."""
        return self._closed

    @property
    def busy(self) -> bool:
        """True while queries are queued, a wave is mid-dispatch, or a
        pipelined wave awaits its fence — the queue-side half of the drain
        check (the generation-refcount half is
        ``DeployedEngine.inflight_snapshot``)."""
        with self._cond:
            return (
                bool(self._pending)
                or self._in_wave
                or bool(self._inflight)
                or self._finalizing
            )

    async def submit(self, item: Any, meta: dict | None = None) -> Any:
        """Queue ``item`` for the next wave.  ``meta``, when given, is
        filled by the worker with this item's queue_wait_s / device_s /
        device_breakdown / wave_kernel_s / wave_size / wave_seq /
        wave_request_ids (and the pipelined split) before the result future
        resolves — the per-request latency decomposition for the flight
        recorder.

        Sheds with :class:`LoadShed` when ``max_queue`` items are already
        queued, and captures the caller's deadline (if one is bound) so the
        worker can expire it instead of dispatching it late."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if (
                self.max_queue is not None
                and len(self._pending) >= self.max_queue
            ):
                self._m_shed.inc()
                raise LoadShed(
                    f"microbatch queue full ({self.max_queue} queued)",
                    retry_after_s=1.0,
                )
            self._pending.append(
                _Entry(
                    item, fut, time.perf_counter(), meta, get_deadline(),
                    get_request_id(),
                    # re-bound around batch_fn so a wave's outbound calls
                    # join the request's cross-process trace (None: the
                    # request records no fragments)
                    current_trace_context() if fragments_wanted() else None,
                )
            )
            self._m_queue_depth.set(len(self._pending))
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, name="microbatch", daemon=True
                )
                self._worker.start()
            # notify_all, not notify: the worker AND the finalizer sleep on
            # this condition — one notify could wake only the finalizer
            self._cond.notify_all()
        return await fut

    def close(self) -> None:
        """Stop accepting work, fail anything still queued, and wait
        BOUNDEDLY for the in-flight waves: past ``drain_timeout_s`` the
        daemon threads are abandoned.  Queued items whose deadline already
        passed resolve with DeadlineExceeded; the rest get the shutdown
        error."""
        with self._cond:
            self._closed = True
            dropped = list(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        err = RuntimeError("MicroBatcher closed during shutdown")
        now = _deadline_now()
        for e in dropped:
            item_err: BaseException = err
            if e.deadline is not None and e.deadline <= now:
                self._m_expired.inc()
                item_err = DeadlineExceeded(
                    "query deadline expired while queued (server shutdown)"
                )
            try:
                e.fut.get_loop().call_soon_threadsafe(
                    _fail_if_pending, e.fut, item_err
                )
            except RuntimeError:
                pass  # the futures' loop is already closed
        # sleep on the condition until the worker clears _in_wave AND the
        # pipeline drains (the finalizer notifies after every fence)
        with self._cond:
            if not self._cond.wait_for(
                lambda: not self._in_wave
                and not self._inflight
                and not self._finalizing,
                timeout=self.drain_timeout_s,
            ):
                self._m_drain_timeout.inc()

    def _drain(self) -> None:
        """Persistent worker loop: sleep on the condition until work (or
        close), then dispatch waves."""
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                wave = [
                    self._pending.popleft()
                    for _ in range(min(len(self._pending), self.max_batch))
                ]
                self._in_wave = True
                self._wave_seq += 1
                wave_seq = self._wave_seq
                self._m_queue_depth.set(len(self._pending))
            try:
                self._dispatch_wave(wave, wave_seq)
            finally:
                wave = None  # hold no wave's items while idle
                with self._cond:
                    self._in_wave = False
                    self._cond.notify_all()  # wake close() waiters

    @staticmethod
    def _validated(results, items: list[Any]) -> Sequence[Any]:
        if len(results) != len(items):
            raise RuntimeError(
                f"batch_fn returned {len(results)} results "
                f"for {len(items)} items"
            )
        return results

    def _call_batch_fn(self, items: list[Any]):
        """The batch_fn fault-injection seam (``resilience.faults``); one
        attribute check when no plan is installed.  May return either the
        results or a :class:`PendingWave` (pipelined dispatch)."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("batch_fn", self._fault_label)
        return self.batch_fn(items)

    def _run_batch_sync(self, items: list[Any]) -> Sequence[Any]:
        """Dispatch + finalize inline — the solo-retry path."""
        results = self._call_batch_fn(items)
        if isinstance(results, PendingWave):
            results = results.finalize()
        return self._validated(results, items)

    def _fail_or_retry(
        self, live: list[_Entry], e: BaseException, wave_seq: int, loop
    ) -> None:
        if len(live) == 1 or not self.solo_retry:
            self._post(loop, [x.fut for x in live], None, e)
        else:
            self._solo_retry_pass(live, e, wave_seq)

    def _dispatch_wave(self, wave: list[_Entry], wave_seq: int) -> None:
        t_dispatch = time.perf_counter()
        # deadline re-check at dispatch: items that expired while queued
        # resolve with DeadlineExceeded instead of spending device time
        now = _deadline_now()
        live: list[_Entry] = []
        for e in wave:
            if e.deadline is not None and e.deadline <= now:
                self._m_expired.inc()
                if e.meta is not None:
                    e.meta["queue_wait_s"] = round(t_dispatch - e.t_enq, 6)
                    e.meta["deadline_expired"] = True
                _post_one(
                    e.fut,
                    error=DeadlineExceeded(
                        "query deadline expired while queued behind the "
                        "in-flight wave"
                    ),
                )
            else:
                live.append(e)
        if not live:
            return
        items = [e.item for e in live]
        rids = [e.rid for e in live if e.rid]
        deadlines = [e.deadline for e in live if e.deadline is not None]
        wave_deadline = min(deadlines) if deadlines else None
        self._m_batch_size.observe(len(items))
        for e in live:
            self._m_queue_wait.observe(t_dispatch - e.t_enq)
        # the correlation line: a wave's log entry names the requests it
        # coalesced, so one slow query's request id finds its wave mates
        # (ring_debug reaches /logs.json whatever the logging config)
        ring_debug(
            log,
            "microbatch wave dispatched",
            wave_size=len(items),
            wave_seq=wave_seq,
            request_ids=rids,
        )
        # every future of a wave comes from submit() on the same server
        # loop; resolve them with ONE loop wakeup
        loop = live[0].fut.get_loop()
        wave_t0 = time.time()
        try:
            # re-bind the wave's tightest deadline around batch_fn; the wave
            # timeline collects the engine's stage marks, and the first
            # member's request/trace context is bound for its outbound calls
            with device_obs.wave_timeline() as timeline:
                with deadline_scope(absolute=wave_deadline):
                    with _wave_context(live[0]):
                        results = self._call_batch_fn(items)
        except Exception as e:
            self._fail_or_retry(live, e, wave_seq, loop)
            return
        if isinstance(results, PendingWave):
            # pipelined wave: the fence moves to the finalizer thread and
            # THIS thread is immediately free to dispatch the next wave; the
            # dispatch half's timeline travels with it
            job = _InflightWave(
                live=live,
                pending=results,
                wave_seq=wave_seq,
                loop=loop,
                t_dispatch=t_dispatch,
                wave_t0=wave_t0,
                dispatch_s=time.perf_counter() - t_dispatch,
                timeline=timeline,
                wave_deadline=wave_deadline,
                depth_at_enqueue=0,
            )
            if self.max_inflight_waves > 0:
                self._enqueue_inflight(job)
            else:
                self._finalize_wave(job)
            return
        try:
            results = self._validated(results, items)
        except Exception as e:
            self._fail_or_retry(live, e, wave_seq, loop)
            return
        device_s = time.perf_counter() - t_dispatch
        self._m_device_time.observe(device_s)
        breakdown = self._observe_timeline(timeline, device_s)
        self._fill_meta(
            live, t_dispatch, device_s, wave_seq, breakdown, timeline,
            wave_t0, rids,
        )
        self._note_wave(len(items))
        self._post(loop, [e.fut for e in live], results, None)

    @staticmethod
    def _fill_meta(
        live: list[_Entry],
        t_dispatch: float,
        device_s: float,
        wave_seq: int,
        breakdown: dict[str, float],
        timeline: "device_obs.WaveTimeline",
        wave_t0: float,
        rids: list[str],
        extra: dict | None = None,
    ) -> None:
        """Fill per-item timing meta BEFORE resolving the futures:
        call_soon_threadsafe orders these writes before the submitter's
        read on the loop thread."""
        for e in live:
            meta = e.meta
            if meta is None:
                continue
            meta["queue_wait_s"] = round(t_dispatch - e.t_enq, 6)
            meta["device_s"] = round(device_s, 6)
            #: host time: where the host waited, summing to device_s
            meta["device_breakdown"] = breakdown
            meta["wave_device"] = timeline.device
            #: wall-clock dispatch time — the distributed timeline's anchor
            #: for the wave's device-track events
            meta["wave_t0"] = round(wave_t0, 6)
            if timeline.kernel_s:
                #: the card's own time for the wave (CUDA events)
                meta["wave_kernel_s"] = round(timeline.kernel_s, 9)
            if timeline.fn:
                meta["wave_fn"] = timeline.fn
                meta["wave_flops"] = timeline.flops
                meta["wave_bytes"] = timeline.bytes
            if timeline.transfers:
                meta["wave_transfers"] = dict(timeline.transfers)
            if timeline.cache_hits:
                # factor-cache hits in this wave: a repeat entity whose
                # gather was skipped (flight entries prove gather ~ 0)
                meta["cache_hits"] = timeline.cache_hits
            if timeline.cache_misses:
                meta["cache_misses"] = timeline.cache_misses
                if timeline.cache_miss_bytes:
                    meta["cache_miss_bytes"] = round(
                        timeline.cache_miss_bytes, 1
                    )
            meta["wave_size"] = len(live)
            meta["wave_seq"] = wave_seq
            #: process-unique wave handle (dispatch wall-ms + seq):
            #: provenance records cite it
            meta["wave_id"] = f"{int(wave_t0 * 1000):x}-{wave_seq}"
            meta["wave_request_ids"] = rids
            if extra:
                meta.update(extra)

    def _observe_timeline(
        self, timeline: "device_obs.WaveTimeline", device_s: float
    ) -> dict[str, float]:
        """Turn the engine's stage marks into the 4-way (+other) breakdown
        that sums to ``device_s`` and record the per-stage histograms,
        labeled by the device the engine marked.  (The roofline gauges are
        the engine's: it observes its kernel's CUDA-event time into the
        efficiency tracker after the wave's fence.)"""
        breakdown = device_obs.split_breakdown(timeline, device_s)
        for stage, seconds in breakdown.items():
            if seconds > 0.0 or stage == "other":
                self._m_stage_time.labels(stage, timeline.device).observe(
                    seconds
                )
        return breakdown

    # -- pipelined finalize ---------------------------------------------------

    def _enqueue_inflight(self, job: _InflightWave) -> None:
        """Hand a dispatched wave to the finalizer, blocking while the
        in-flight depth is at the bound (the worker must not run
        unboundedly ahead of the fence)."""
        with self._cond:
            while (
                len(self._inflight) >= self.max_inflight_waves
                and not self._closed
            ):
                self._cond.wait()
            # close() raced this dispatch: an idle finalizer may already
            # have seen (closed, empty) and exited — enqueueing now would
            # strand the wave's futures.  Finalize inline instead: close()
            # is still waiting on _in_wave.
            closed = self._closed
            if not closed:
                job.depth_at_enqueue = len(self._inflight) + 1
                self._inflight.append(job)
                if self._finalizer is None or not self._finalizer.is_alive():
                    self._finalizer = threading.Thread(
                        target=self._finalize_loop,
                        name="microbatch-finalize",
                        daemon=True,
                    )
                    self._finalizer.start()
                self._cond.notify_all()
        if closed:
            self._finalize_wave(job)

    def _finalize_loop(self) -> None:
        """FIFO fence runner: results resolve in wave order, one wave's
        finalize at a time, overlapping the worker's next dispatch."""
        while True:
            with self._cond:
                while not self._inflight and not self._closed:
                    self._cond.wait()
                if not self._inflight:
                    return  # closed and drained
                job = self._inflight.popleft()
                self._finalizing = True
                self._cond.notify_all()  # wake a worker blocked on depth
            try:
                self._finalize_wave(job)
            finally:
                # drop the wave before idling: its closure holds the
                # generation it ran on (a /reload must be able to free it)
                job = None
                with self._cond:
                    self._finalizing = False
                    self._cond.notify_all()  # wake close() waiters

    def _finalize_wave(self, job: _InflightWave) -> None:
        live = job.live
        items = [e.item for e in live]
        # deadline re-check at the fence: an item whose budget ran out while
        # its wave sat in the pipeline still answers an honest 504.  The
        # finalize itself still runs (it releases serving slots).
        now = _deadline_now()
        expired: set[int] = set()
        for j, e in enumerate(live):
            if e.deadline is not None and e.deadline <= now:
                self._m_expired.inc()
                if e.meta is not None:
                    e.meta["deadline_expired"] = True
                expired.add(j)
        t_fin = time.perf_counter()
        try:
            with device_obs.wave_timeline() as ftl:
                with deadline_scope(absolute=job.wave_deadline):
                    with _wave_context(live[0]):
                        results = self._validated(
                            job.pending.finalize(), items
                        )
        except Exception as e:
            self._fail_or_retry(live, e, job.wave_seq, job.loop)
            return
        if expired:
            for j in sorted(expired):
                _post_one(
                    live[j].fut,
                    error=DeadlineExceeded(
                        "query deadline expired while pipelined behind "
                        "the in-flight wave"
                    ),
                )
            live = [e for j, e in enumerate(live) if j not in expired]
            results = [r for j, r in enumerate(results) if j not in expired]
            if not live:
                return
        finalize_s = time.perf_counter() - t_fin
        device_s = job.dispatch_s + finalize_s
        self._m_device_time.observe(device_s)
        # one breakdown covering both halves: host_gather/h2d from the
        # dispatch, compute/d2h from the fence
        ftl.merge(job.timeline)
        breakdown = self._observe_timeline(ftl, device_s)
        self._fill_meta(
            live, job.t_dispatch, device_s, job.wave_seq, breakdown, ftl,
            job.wave_t0, [e.rid for e in job.live if e.rid],
            extra={
                "pipelined": True,
                "dispatch_s": round(job.dispatch_s, 6),
                "finalize_s": round(finalize_s, 6),
                "inflight_depth": job.depth_at_enqueue,
            },
        )
        self._note_wave(len(items))
        self._post(job.loop, [e.fut for e in live], results, None)

    def _note_wave(self, size: int) -> None:
        """Record one wave's size under the condition (``wave_histogram``
        reads it from other threads) and refresh the coalescing gauge."""
        with self._cond:
            self.wave_sizes[size] = self.wave_sizes.get(size, 0) + 1
            self._recent_waves.append(size)
            self._m_coalescing.set(
                sum(self._recent_waves) / len(self._recent_waves)
            )

    def _solo_retry_pass(
        self, live: list[_Entry], wave_error: BaseException, wave_seq: int
    ) -> None:
        """ONE bounded re-dispatch of a failed wave, item by item, so a
        poison query fails alone instead of failing its wave-mates.  A
        close() arriving mid-pass fails the remaining items at once with the
        wave error instead of holding shutdown hostage."""
        self._m_solo_retry.inc()
        log.warning(
            "wave %d (%d items) failed (%s: %s); solo-retrying to isolate",
            wave_seq,
            len(live),
            type(wave_error).__name__,
            wave_error,
        )
        now = _deadline_now()
        for e in live:
            if self._closed:
                _post_one(e.fut, error=wave_error)
                continue
            if e.deadline is not None and e.deadline <= now:
                self._m_expired.inc()
                if e.meta is not None:
                    e.meta["deadline_expired"] = True
                _post_one(
                    e.fut,
                    error=DeadlineExceeded(
                        "query deadline expired during wave retry"
                    ),
                )
                continue
            t0 = time.perf_counter()
            t0_wall = time.time()
            try:
                with device_obs.wave_timeline() as timeline:
                    with deadline_scope(absolute=e.deadline):
                        with _wave_context(e):
                            # dispatch + finalize inline: a retried item
                            # never re-enters the pipeline
                            result = self._run_batch_sync([e.item])[0]
            except Exception as err:
                _post_one(e.fut, error=err)
                continue
            solo_s = time.perf_counter() - t0
            breakdown = self._observe_timeline(timeline, solo_s)
            self._fill_meta(
                [e], t0, solo_s, wave_seq, breakdown, timeline, t0_wall,
                [e.rid] if e.rid else [], extra={"solo_retry": True},
            )
            self._note_wave(1)
            _post_one(e.fut, result=result)
            now = _deadline_now()

    @staticmethod
    def _post(loop, futures, results, error) -> None:
        try:
            loop.call_soon_threadsafe(_resolve_wave, futures, results, error)
        except RuntimeError:
            pass  # loop already closed during shutdown


@contextlib.contextmanager
def _wave_context(entry: _Entry):
    """Re-bind one wave member's request + trace context around a dispatch
    on the worker (or finalizer) thread, so log records and outbound calls
    inside ``batch_fn`` carry that request's ids.  No-op for submitters
    that carried no context."""
    tid, sid = entry.tctx or (None, None)
    if not entry.rid and not tid:
        yield
        return
    tokens = set_request_context(entry.rid, tid)
    ptoken = bind_parent_span(sid)
    ftoken = bind_fragments(entry.tctx is not None)
    try:
        yield
    finally:
        reset_fragments(ftoken)
        reset_parent_span(ptoken)
        reset_request_context(tokens)


def _post_one(fut: asyncio.Future, result=None, error=None) -> None:
    """Resolve one future from the worker thread (loop-safe)."""
    try:
        fut.get_loop().call_soon_threadsafe(_resolve_one, fut, result, error)
    except RuntimeError:
        pass  # loop already closed during shutdown


def _resolve_one(fut: asyncio.Future, result, error) -> None:
    if fut.done():
        return
    if error is not None:
        fut.set_exception(error)
    else:
        fut.set_result(result)


def _fail_if_pending(fut: asyncio.Future, err: BaseException) -> None:
    if not fut.done():
        fut.set_exception(err)


def _resolve_wave(futures, results, error) -> None:
    if error is not None:
        for fut in futures:
            if not fut.done():
                fut.set_exception(error)
    else:
        for fut, res in zip(futures, results):
            if not fut.done():
                fut.set_result(res)
