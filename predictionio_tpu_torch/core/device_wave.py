"""A device wave's dispatch and fence, shared by the engines' wave paths
(the ALS family's fused top-k, NCF's scored waves).

On a card, everything is enqueued at dispatch on the tables' device and
its current stream: the ids' upload from pinned memory, the wave's compute
between two timing events, the result's copy into a pinned host buffer
(``non_blocking``), then a CUDA event.  The fence waits for that event
alone, so a pipelined wave N's fence never waits for wave N+1's work, which
the micro-batcher's worker enqueues behind it on the same stream (a
blocking ``.cpu()`` there would).  After the wait, the timing pair's
elapsed time is the wave's own time on the card: that, never the host's
wait or its enqueue gaps, is what the roofline observes.  On the CPU the
compute runs inline and its device time is the host span.

The host stages land on the wave timeline (``h2d`` the ids' enqueue,
``launch`` the enqueue of the compute and the result's copy on a card,
``compute`` the wait in the fence or the inline compute, ``observe`` the
caller's bookkeeping of the device time, ``d2h`` the read of the result),
with the bytes that cross (none on the CPU, where no copy happens).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from predictionio_tpu_torch.obs import device as device_obs


def dispatch_wave(
    ids: np.ndarray,
    device: torch.device,
    compute: Callable[[torch.Tensor, tuple | None], torch.Tensor],
    observe: Callable[[float], None],
) -> Callable[[], np.ndarray]:
    """Launch ``compute(ids on device, timing)`` without blocking and return
    the fence, which waits for the wave, hands ``observe`` the wave's device
    seconds and returns the result as numpy.  ``timing`` is a pair of CUDA
    events for ``compute`` to record around its device work (None on the
    CPU)."""
    ids_t = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
    if device.type != "cuda":
        t0 = time.perf_counter()
        with device_obs.wave_stage("compute"):
            packed = compute(ids_t, None)
        kernel_s = time.perf_counter() - t0
        with device_obs.wave_stage("observe"):
            observe(kernel_s)

        def fence_cpu() -> np.ndarray:
            with device_obs.wave_stage("d2h"):
                return packed.numpy()

        return fence_cpu
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        with device_obs.wave_stage("h2d"):
            ids_t = ids_t.pin_memory().to(device, non_blocking=True)
        with device_obs.wave_stage("launch"):
            timing = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            packed = compute(ids_t, timing)
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
    device_obs.note_transfer("h2d", ids_t.numel() * ids_t.element_size())

    def fence() -> np.ndarray:
        with device_obs.wave_stage("compute"):
            done.synchronize()
        with device_obs.wave_stage("observe"):
            # both timing events precede ``done`` on the stream: complete
            observe(timing[0].elapsed_time(timing[1]) / 1e3)
        with device_obs.wave_stage("d2h"):
            out = host.numpy()
        device_obs.note_transfer("d2h", host.numel() * host.element_size())
        return out

    return fence
