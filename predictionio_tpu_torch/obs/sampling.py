"""Continuous host-path stack sampling: the always-available profiler.

The JAX package's ``obs/sampling.py``, stdlib only.  The on-demand
``torch.profiler`` capture (obs/profiler.py) answers device questions but
needs a bounded window and a trace viewer.  This module is the host-side
complement: a daemon thread walks
``sys._current_frames()`` at a configurable rate (default 100 Hz),
aggregates every thread's stack into bounded folded-stack counts, and
exports them as collapsed-flamegraph text (``flamegraph.pl`` /
``inferno-flamegraph`` input) or speedscope JSON (https://speedscope.app) —
so "where is the host spending the solo path's time" is answerable on any
device, against a live server, with no restart.

Threads are labeled by serving role (aio loop, executor workers,
MicroBatcher worker, lifecycle controller, HTTP serve threads, storage
daemon) so the flamegraph reads as the serving architecture, not a pile of
``Thread-7``\\ s.

Overhead is self-metered: every sampling pass's wall duration is timed
into ``pio_stack_sampler_seconds``, and the sampler thread's cumulative
CPU time (``time.thread_time`` — the GIL share the sampler actually
steals from serving threads; a pass's WALL time under load mostly counts
other threads' progress while the walk is preempted) over wall time is
reported as ``overhead_frac`` — tested <2 % of one core at 100 Hz.
Memory is bounded: at most ``max_stacks`` distinct (role, stack) keys are
retained; beyond that new stacks count into ``dropped`` instead of growing
the table.  A key hashes its code objects by identity, once (the JAX
package's plain tuple keys re-hash every code object on every lookup, the
bulk of a pass's cost); the exports are the same.

Surfaces: debug-gated ``GET /debug/stacks.json`` (first request arms the
process sampler) and ``pio profile --stacks [--speedscope OUT.json]``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any

from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

#: sampling rate when none is configured (PIO_STACK_SAMPLER_HZ overrides)
DEFAULT_HZ = 100.0

#: hard bounds on the configurable rate — 1 kHz of frame walks would spend
#: the overhead budget on telemetry
MIN_HZ, MAX_HZ = 1.0, 500.0

#: distinct (role, stack) keys retained before new ones are dropped
DEFAULT_MAX_STACKS = 8192

#: frames walked per thread before the stack is truncated (deep recursion
#: must not make one pass unbounded)
MAX_FRAMES = 64

#: CO_GENERATOR | CO_COROUTINE | CO_ASYNC_GENERATOR — frames of these code
#: objects outlive a single call and get their ``f_back`` re-linked to
#: whichever caller resumes them, so the leaf cache must never trust them
_GEN_CO_FLAGS = 0x20 | 0x80 | 0x200

#: thread-name prefix/exact-name → serving role.  Ordered: first match wins.
_ROLE_RULES: tuple[tuple[str, str], ...] = (
    ("microbatch", "microbatcher"),
    ("pio-lifecycle", "lifecycle-controller"),
    ("pio-profiler", "profiler"),
    ("pio-cost-capture", "cost-capture"),
    ("pio-trace-fetch", "trace-fetch"),
    ("plugin-sniffers", "plugin-sniffers"),
    ("asyncio_", "executor-worker"),
    ("ThreadPoolExecutor", "executor-worker"),
    ("pio-executor", "executor-worker"),
    ("storage-server", "storage-daemon"),
    ("MainThread", "main"),
)


def thread_role(name: str) -> str:
    """Serving role for a thread name — the flamegraph's top-level frame."""
    for prefix, role in _ROLE_RULES:
        if name.startswith(prefix):
            return role
    if name.endswith("-aio"):
        return "aio-loop"
    if name.endswith("-http"):
        return "http-serve"
    if name.startswith("Thread-"):
        # ThreadingHTTPServer connection handlers get stdlib default names
        return "http-serve"
    return name


def _frame_label(code) -> str:
    """``func (file.py)`` — no line numbers, so one function is one frame
    regardless of which line the sample landed on."""
    return f"{code.co_name} ({os.path.basename(code.co_filename)})"


class _StackKey(tuple):
    """An aggregation key ``(role, codes)`` whose hash is computed once,
    from the code objects' identities.  A plain tuple re-hashes every code
    object (its name, bytecode and constants) on each dict lookup, once per
    thread per pass; the key of a cached leaf is looked up again every
    pass.  Equality stays the tuple's (identity first per element), and the
    key unpacks as ``(role, codes)``."""

    def __new__(cls, role: str, codes: list):
        key = super().__new__(cls, (role, tuple(codes)))
        key._hash = hash((role, tuple(map(id, codes))))
        return key

    def __hash__(self) -> int:
        return self._hash


class StackSampler:
    """Daemon-thread wall-clock sampler over ``sys._current_frames()``.

    ``start()`` is idempotent; ``snapshot()`` / ``collapsed()`` /
    ``speedscope()`` read the aggregation without stopping it; ``reset()``
    clears counts but keeps sampling.  One instance per process is enough
    (:data:`SAMPLER`); tests build their own for isolation.
    """

    def __init__(
        self,
        hz: float | None = None,
        max_stacks: int = DEFAULT_MAX_STACKS,
        registry: MetricsRegistry | None = None,
    ):
        self._configured_hz = hz
        self.hz = hz or DEFAULT_HZ
        self.max_stacks = max_stacks
        self._registry = registry or REGISTRY
        self._lock = threading.Lock()
        #: (role, tuple-of-code-objects root-first) -> sample count
        self._counts: dict[tuple[str, tuple], int] = {}
        #: tid -> cached thread name (threading.enumerate() is per-pass
        #: cost otherwise; refreshed when an unknown tid appears)
        self._names: dict[int, str] = {}
        #: tid -> (leaf frame object, aggregation key).  A plain function
        #: frame's f_back chain is immutable for the frame object's
        #: lifetime and the labels carry no line numbers, so the SAME leaf
        #: frame object (thread blocked in a wait, or spinning inside one
        #: function) yields the same key without re-walking the stack —
        #: the steady state for most serving threads, and the difference
        #: between a ~0.5 % and a ~4 % sampling tax under 32-way load.
        #: Generator/coroutine leaf frames are exempt (never cached): they
        #: outlive calls and get f_back re-linked per resumption
        self._leaf_cache: dict[int, tuple[Any, tuple[str, tuple]]] = {}
        self._samples = 0
        self._dropped = 0
        self._sample_seconds = 0.0
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._started_wall: float | None = None
        self._started_perf: float | None = None
        self._m_pass = self._registry.histogram(
            "pio_stack_sampler_seconds",
            "Duration of one stack-sampling pass over all threads",
        )

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "StackSampler":
        """Arm the sampler (idempotent, and atomic: two concurrent first
        requests to /debug/stacks.json both race here, and a double-start
        would double-count every stack forever).  The rate comes from the
        constructor, else ``PIO_STACK_SAMPLER_HZ``, else 100 Hz — read at
        start so a deploy script can tune a running image via env."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            hz = self._configured_hz
            if hz is None:
                try:
                    hz = float(
                        os.environ.get("PIO_STACK_SAMPLER_HZ", "") or 0
                    )
                except ValueError:
                    hz = 0.0
            self.hz = min(max(hz or DEFAULT_HZ, MIN_HZ), MAX_HZ)
            stop_event = threading.Event()
            self._stop_event = stop_event
            self._started_wall = time.time()
            self._started_perf = time.perf_counter()
            self._thread = threading.Thread(
                target=self._run,
                args=(stop_event,),
                name="pio-stack-sampler",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        # the event is captured here and passed to _run at start, so a
        # stop() racing a restart can only ever stop ITS thread — never a
        # freshly-started one observing a recycled event
        with self._lock:
            t = self._thread
            self._thread = None
            self._stop_event.set()
        if t is not None:
            t.join(timeout=2.0)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._samples = 0
            self._dropped = 0
            self._sample_seconds = 0.0
            self._started_wall = time.time()
            self._started_perf = time.perf_counter()

    # -- the sampling loop ---------------------------------------------------

    def _run(self, stop_event: threading.Event) -> None:
        period = 1.0 / self.hz
        next_t = time.perf_counter() + period
        while not stop_event.is_set():
            t0 = time.perf_counter()
            c0 = time.thread_time()
            try:
                self._sample_once()
            except Exception:
                # a telemetry thread must never die on a transient (e.g. a
                # thread exiting mid-walk); skip the pass
                pass
            dt = time.perf_counter() - t0
            cpu = time.thread_time() - c0
            self._m_pass.observe(dt)
            with self._lock:
                self._sample_seconds += cpu
            delay = next_t - time.perf_counter()
            if delay <= 0:
                # overran the period (GC pause, huge thread count): re-anchor
                # instead of spinning to catch up
                next_t = time.perf_counter() + period
                delay = period
            else:
                next_t += period
            stop_event.wait(delay)

    def _sample_once(self) -> None:
        frames = sys._current_frames()
        names = self._names
        cache = self._leaf_cache
        if any(tid not in names for tid in frames):
            names.update((t.ident, t.name) for t in threading.enumerate())
        own = threading.get_ident()
        entries: list[tuple[str, tuple]] = []
        for tid, frame in frames.items():
            if tid == own:
                continue  # never sample the sampler
            reusable = not (frame.f_code.co_flags & _GEN_CO_FLAGS)
            if reusable:
                cached = cache.get(tid)
                if cached is not None and cached[0] is frame:
                    entries.append(cached[1])
                    continue
            codes = []
            append = codes.append
            f = frame
            depth = 0
            while f is not None and depth < MAX_FRAMES:
                append(f.f_code)
                f = f.f_back
                depth += 1
            codes.reverse()  # root first, leaf last (folded-stack order)
            role = thread_role(names.get(tid) or f"tid-{tid}")
            key = _StackKey(role, codes)
            if reusable:
                cache[tid] = (frame, key)
            entries.append(key)
        if len(cache) > 2 * len(frames) + 8:
            # prune exited threads: a dead tid's cache entry pins its frame
            # (and that frame's locals) forever otherwise
            for tid in list(cache):
                if tid not in frames:
                    del cache[tid]
                    names.pop(tid, None)
        with self._lock:
            self._samples += 1
            counts = self._counts
            for key in entries:
                n = counts.get(key)
                if n is None:
                    if len(counts) >= self.max_stacks:
                        self._dropped += 1
                        continue
                    counts[key] = 1
                else:
                    counts[key] = n + 1

    # -- reads ---------------------------------------------------------------

    def _read(self) -> tuple[dict[tuple[str, tuple], int], int, int, float]:
        with self._lock:
            return (
                dict(self._counts),
                self._samples,
                self._dropped,
                self._sample_seconds,
            )

    def snapshot(self) -> dict[str, Any]:
        """The ``/debug/stacks.json`` body (sans the stack texts): sampler
        state, self-metered overhead, and per-role sample totals."""
        counts, samples, dropped, sample_s = self._read()
        elapsed = (
            time.perf_counter() - self._started_perf
            if self._started_perf is not None
            else 0.0
        )
        roles: dict[str, int] = {}
        for (role, _), n in counts.items():
            roles[role] = roles.get(role, 0) + n
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": samples,
            "distinct_stacks": len(counts),
            "max_stacks": self.max_stacks,
            "dropped_stacks": dropped,
            "duration_s": round(elapsed, 3),
            #: sampler-thread CPU seconds — the GIL share sampling stole
            "sample_seconds_total": round(sample_s, 6),
            #: the self-meter: fraction of one core spent sampling
            "overhead_frac": round(sample_s / elapsed, 6) if elapsed > 0 else 0.0,
            "started_at": self._started_wall,
            "threads": dict(sorted(roles.items())),
        }

    def collapsed(self) -> str:
        """Collapsed flamegraph text: ``role;frame;frame;... count`` lines,
        role as the root frame — pipe into flamegraph.pl / inferno."""
        counts, _, _, _ = self._read()
        lines = []
        for (role, codes), n in counts.items():
            stack = ";".join([role] + [_frame_label(c) for c in codes])
            lines.append(f"{stack} {n}")
        return "\n".join(sorted(lines)) + ("\n" if lines else "")

    def speedscope(self) -> dict[str, Any]:
        """Speedscope file-format JSON: one sampled profile per thread role
        (weights in seconds — count × sampling period), loadable at
        https://speedscope.app with zero build steps."""
        counts, samples, _, _ = self._read()
        period = 1.0 / self.hz if self.hz else 0.0
        frame_index: dict[str, int] = {}
        frames: list[dict[str, str]] = []

        def fidx(label: str) -> int:
            i = frame_index.get(label)
            if i is None:
                i = frame_index[label] = len(frames)
                frames.append({"name": label})
            return i

        by_role: dict[str, list[tuple[tuple, int]]] = {}
        for (role, codes), n in counts.items():
            by_role.setdefault(role, []).append((codes, n))
        profiles = []
        for role in sorted(by_role):
            stacks = by_role[role]
            sample_rows = [
                [fidx(_frame_label(c)) for c in codes] for codes, _ in stacks
            ]
            weights = [n * period for _, n in stacks]
            profiles.append(
                {
                    "type": "sampled",
                    "name": role,
                    "unit": "seconds",
                    "startValue": 0,
                    "endValue": round(sum(weights), 6),
                    "samples": sample_rows,
                    "weights": weights,
                }
            )
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "name": f"pio host stacks ({samples} samples @ {self.hz:g} Hz)",
            "activeProfileIndex": 0,
            "exporter": "predictionio_tpu_torch",
        }


#: the process sampler — armed by the first /debug/stacks.json request (or
#: explicitly via StackSampler.start / `pio profile --stacks` locally)
SAMPLER = StackSampler()
