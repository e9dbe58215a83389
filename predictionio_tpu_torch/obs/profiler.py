"""On-demand ``torch.profiler`` capture + runtime gauges for a live server.

The counterpart of the JAX package's ``obs/profiler.py`` (which drives
``jax.profiler``).  ``POST /debug/profile?seconds=N`` starts a capture on a
running server without restarting it, with the JAX package's contract:

- one capture at a time (:class:`ProfilerBusy` -> 409);
- the request thread answers at once (202): the capture runs on a daemon
  thread, which starts the profiler, waits ``seconds`` and stops it, so a
  stalled profiler never holds an event-loop executor slot; a CUDA
  capture answers once it has recorded for ``DEVICE_CLOCK_GUARD_S``, so
  device work launched after the 202 lies inside its window;
- a capture that cannot start raises :class:`ProfilerUnsupported` (-> 501
  with the error text);
- ``GET /debug/profile`` reports the running capture or the last one.

A server whose model lives on the card profiles CPU and CUDA activity; a
``device="cpu"`` deploy (and the event server) profiles CPU activity only.
The capture writes ``export_chrome_trace`` (``trace.json``) into the
capture directory with the ``key_averages()`` table beside it
(``key_averages.txt``), and its status names the device operations it saw
with their device time.  A capture that asked for CUDA activity and saw no
device events is a FAILED capture: its status carries the error, never a
quiet CPU-only success.  For its window the capture holds every thread's
spans captured (``obs.tracing.process_capture``, the store cleared at the
start), so the trace names the program's stages (``wave.<stage>``, the
``trace`` spans) and the status lists their totals under ``spans``.

:func:`sample_runtime_gauges` refreshes the card's memory gauges from
``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` and mirrors the
transfer tallies; the metrics routes call it on each scrape.  It reads the
card only when this process has already initialized CUDA: a scrape of a
process that never touched the card (``pio eventserver``) creates no CUDA
context.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from typing import Any

from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs import tracing
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

#: upper bound on one capture; profiles are for debugging, not surveillance
MAX_CAPTURE_SECONDS = 300.0

#: device operations listed in a finished capture's status
TOP_DEVICE_OPS = 20

#: how long a CUDA capture records before it counts as started.  Kineto
#: keeps a device record only when its start, mapped from the card's clock
#: onto the host's, falls inside the capture window, and that mapping
#: jitters: on an H100 a kernel has been stamped up to 5.2 ms before the
#: host's stamp of its own launch, where it is usually stamped 40-170 us
#: after.  A kernel launched in the window's first instants is then
#: dropped as out of range (2-4 captures in 100 lost a launch made as the
#: capture started).  Answering once this guard has passed keeps the work
#: a caller releases after the 202 inside the window.
DEVICE_CLOCK_GUARD_S = 0.1


class ProfilerUnsupported(RuntimeError):
    """torch.profiler is unavailable or refused to start."""


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (one trace at a time)."""


def _start_trace(cuda: bool):
    """Start a ``torch.profiler`` capture and return its handle
    (indirection point: tests stub this and :func:`_stop_trace`).

    The capture runs on its own thread while the serving threads do the
    work, so it asks Kineto to record every thread's CPU operations
    (``profile_all_threads``); a torch without that option records the
    capture thread's alone.  CUDA activity (CUPTI) is process-wide either
    way."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        config = None
    prof = torch.profiler.profile(
        activities=activities, experimental_config=config
    )
    prof.start()
    return prof


def _device_time_us(evt: Any) -> float:
    """Self device time of one ``key_averages()`` row in microseconds (the
    attribute was renamed from ``cuda`` to ``device`` across versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _stop_trace(prof, out_dir: str, cuda: bool) -> dict[str, Any]:
    """Stop the capture, write the chrome trace and the ``key_averages()``
    table into ``out_dir``, and return what the status reports: the files
    and the device operations by device time.  Raises when CUDA activity
    was asked for and no device event was recorded."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace_path)
    averages = prof.key_averages()
    table_path = os.path.join(out_dir, "key_averages.txt")
    sort_by = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    try:
        table = averages.table(sort_by=sort_by, row_limit=40)
    except Exception:
        table = averages.table(row_limit=40)
    with open(table_path, "w", encoding="utf-8") as f:
        f.write(table)
    ops = sorted(
        (
            {
                "name": e.key,
                "count": int(e.count),
                "device_time_us": round(_device_time_us(e), 3),
            }
            for e in averages
            if _device_time_us(e) > 0
        ),
        key=lambda d: -d["device_time_us"],
    )
    if cuda and not ops:
        raise ProfilerUnsupported(
            "CUDA activity was requested but the capture recorded no device "
            "events (CUPTI did not trace the card)"
        )
    return {
        "trace": trace_path,
        "table": table_path,
        "device_ops": ops[:TOP_DEVICE_OPS],
    }


class ProfilerController:
    """One capture at a time, run on a daemon thread.

    ``start`` hands the start, the wait and the stop to one thread (the
    profiler is started and stopped on the same thread) and waits only for
    the start's outcome; ``status`` reports the in-flight capture or the
    last finished one."""

    #: how long ``start`` waits for the capture thread to arm the profiler
    START_TIMEOUT_S = 30.0

    def __init__(self):
        self._lock = threading.Lock()
        self._running: dict[str, Any] | None = None
        self._last: dict[str, Any] | None = None
        self._wakeup = threading.Event()

    def start(
        self, seconds: float, out_dir: str | None = None, cuda: bool = False
    ) -> dict[str, Any]:
        if not 0 < seconds <= MAX_CAPTURE_SECONDS:
            raise ValueError(
                f"seconds must be in (0, {MAX_CAPTURE_SECONDS:g}]"
            )
        out_dir = out_dir or os.path.join(
            tempfile.gettempdir(), "pio-profile"
        )
        with self._lock:
            if self._running is not None:
                raise ProfilerBusy(
                    f"capture already running into {self._running['dir']}"
                )
            self._running = {
                "dir": out_dir,
                "seconds": seconds,
                "cuda": cuda,
                "started": time.time(),
            }
        self._wakeup.clear()
        armed = threading.Event()
        outcome: dict[str, Any] = {}
        threading.Thread(
            target=self._capture,
            args=(seconds, out_dir, cuda, armed, outcome),
            name="pio-profiler",
            daemon=True,
        ).start()
        if not armed.wait(self.START_TIMEOUT_S):
            outcome.setdefault(
                "error", TimeoutError("the profiler did not start in time")
            )
        err = outcome.get("error")
        if err is not None:
            raise ProfilerUnsupported(
                f"torch.profiler unavailable: {type(err).__name__}: {err}"
            ) from err
        return {
            "profiling": True,
            "seconds": seconds,
            "dir": out_dir,
            "activities": ["cpu", "cuda"] if cuda else ["cpu"],
        }

    def _capture(self, seconds, out_dir, cuda, armed, outcome) -> None:
        try:
            prof = _start_trace(cuda)
        except Exception as e:
            outcome["error"] = e
            with self._lock:
                self._running = None
            armed.set()
            return
        tracing.clear_capture_totals()
        with tracing.process_capture():
            if cuda:
                # a kernel of the window's first instants may be stamped
                # before its start and dropped (DEVICE_CLOCK_GUARD_S)
                self._wakeup.wait(DEVICE_CLOCK_GUARD_S)
            armed.set()
            # paced by an Event, not a sleep poll: interruptible
            self._wakeup.wait(seconds)
        error: str | None = None
        result: dict[str, Any] = {}
        try:
            result = _stop_trace(prof, out_dir, cuda)
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        # device spans still running are left out (``capture_totals``)
        result["spans"] = tracing.capture_totals()
        with self._lock:
            done = self._running or {}
            self._running = None
            self._last = {
                "dir": out_dir,
                "seconds": seconds,
                "cuda": cuda,
                "started": done.get("started"),
                "finished": time.time(),
                "error": error,
                **result,
            }

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "running": self._running is not None,
                "current": dict(self._running) if self._running else None,
                "last": dict(self._last) if self._last else None,
            }


#: The JAX package skips its per-device ``memory_stats`` walk when the last
#: walk was under this many seconds ago.  The port reads one card's
#: allocator (two calls) on every scrape, so its interval is 0: each
#: scrape's memory gauges are the allocator's at that scrape.  Kept for the
#: JAX package's name: nothing in the port reads it.
MEMSTATS_MIN_INTERVAL_S = 0.0

#: the process-wide controller — the profiler is global to the process
PROFILER = ProfilerController()


def sample_runtime_gauges(registry: MetricsRegistry | None = None) -> bool:
    """Refresh the runtime gauges on a scrape.

    Always: the process-cumulative host<->device transfer tallies the
    device-efficiency layer keeps (``pio_device_transfer_bytes{direction}``,
    the JAX package's mirror).  Only when this process has ALREADY
    initialized CUDA (``torch.cuda.is_initialized()``), for the current
    card: ``torch.cuda.memory_stats`` (allocated, reserved and peak bytes:
    ``pio_jax_device_memory_bytes{device}`` keeps the JAX name for bytes in
    use, ``pio_cuda_memory_reserved_bytes`` and
    ``pio_cuda_memory_peak_bytes`` beside it) and ``torch.cuda.mem_get_info``
    (``pio_cuda_memory_free_bytes`` / ``pio_cuda_memory_total_bytes``).
    Every probe is fenced — telemetry must never break a scrape — and the
    call self-meters into ``pio_runtime_sample_seconds``.  Returns whether
    the card was read."""
    reg = registry or REGISTRY
    t_start = time.perf_counter()
    try:
        fam = reg.gauge(
            "pio_device_transfer_bytes",
            "Process-cumulative host<->device transfer bytes by direction",
            labelnames=("direction",),
        )
        for direction, total in device_obs.transfer_totals().items():
            fam.labels(direction).set(total)
    except Exception:
        pass
    read_card = False
    torch = sys.modules.get("torch")
    try:
        initialized = torch is not None and torch.cuda.is_initialized()
    except Exception:
        initialized = False
    if initialized:
        try:
            dev = torch.cuda.current_device()
            label = str(dev)
            stats = torch.cuda.memory_stats(dev)
            reg.gauge(
                "pio_jax_device_memory_bytes",
                "Bytes in use per device (torch.cuda allocated bytes)",
                labelnames=("device",),
            ).labels(label).set(stats.get("allocated_bytes.all.current", 0))
            reg.gauge(
                "pio_cuda_memory_reserved_bytes",
                "Bytes the CUDA caching allocator holds per device",
                labelnames=("device",),
            ).labels(label).set(stats.get("reserved_bytes.all.current", 0))
            reg.gauge(
                "pio_cuda_memory_peak_bytes",
                "Peak allocated bytes per device since start or reset",
                labelnames=("device",),
            ).labels(label).set(stats.get("allocated_bytes.all.peak", 0))
            free, total = torch.cuda.mem_get_info(dev)
            reg.gauge(
                "pio_cuda_memory_free_bytes",
                "Free device memory per device (cudaMemGetInfo)",
                labelnames=("device",),
            ).labels(label).set(free)
            reg.gauge(
                "pio_cuda_memory_total_bytes",
                "Total device memory per device (cudaMemGetInfo)",
                labelnames=("device",),
            ).labels(label).set(total)
            read_card = True
        except Exception:
            pass
    reg.histogram(
        "pio_runtime_sample_seconds",
        "Cost of one sample_runtime_gauges pass (runs on every /metrics "
        "scrape)",
    ).observe(time.perf_counter() - t_start)
    return read_card
