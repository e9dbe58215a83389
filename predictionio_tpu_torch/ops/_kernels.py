"""Build and load the port's hand-written CUDA kernels.

Each kernel is a plain C entry point in a ``csrc/*.cu`` file (one file may
hold several), compiled by ``nvcc`` for ``sm_90a`` into one shared library
per file and called through ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries are built at first use, named by a hash of the source
and the flags, into
:func:`build_dir`: ``$PIO_KERNEL_BUILD_DIR`` when set, else the git-ignored
``build/kernels/`` when the package runs from a checkout, else a per-user
cache.  A failed build raises :class:`KernelBuildError` with the
compiler's output.  A build is a recorded ``kernel.build`` span, and each
source's ``nvcc`` time lands under the compile metrics
(``obs.tracing.observe_kernel_build``): the port's counterpart of the JAX
package's compile listener.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from predictionio_tpu_torch.obs.tracing import observe_kernel_build, trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: the checkout the package runs from, when it does (it has the project file)
_CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: entry name -> (source file in csrc/, C entry point, argtypes): the
#: kernels' launchers, and what the fused top-k's wrapper asks its library
KERNELS: dict[str, tuple[str, str, list]] = {
    # q, t, B, N, r, k, limit, queries per CTA, rows_per_split, n_splits,
    # cand_v, cand_i, out, stream, timing events (started, ended; or null)
    "fused_topk": (
        "fused_topk.cu", "pio_fused_topk",
        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    ),
    # r, k, queries per CTA -> pass 1's shared-memory bytes
    "fused_topk_smem": ("fused_topk.cu", "pio_fused_topk_smem", [_I, _I, _I]),
    # device, int[3] out: shared memory per CTA (opt-in), per SM, reserved
    "device_smem": ("fused_topk.cu", "pio_device_smem", [_I, _P]),
    # seg, block_map, oth, wrv, factors, n_tiles, k, width, bf16,
    # out, carry, carry_seg, stream
    "als_fused_accum": (
        "als_accum.cu", "pio_als_fused_accum",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
    # seg, block_map, rows, n_tiles, width, bf16, out, carry, carry_seg,
    # stream
    "als_segment_accum": (
        "als_accum.cu", "pio_als_segment_accum",
        [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    ),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (str(Path(home) / "bin" / "nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are built from csrc/ at first use"
    )


def build_dir() -> Path:
    """Where built kernel libraries go: ``$PIO_KERNEL_BUILD_DIR`` when set;
    else ``build/kernels/`` of the checkout the package runs from; else
    (an installed package) ``$XDG_CACHE_HOME`` or ``~/.cache``, under
    ``predictionio_tpu_torch/kernels``."""
    env = os.environ.get("PIO_KERNEL_BUILD_DIR")
    if env:
        return Path(env)
    if (_CHECKOUT / "pyproject.toml").is_file():
        return _CHECKOUT / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "predictionio_tpu_torch" / "kernels"


def library_path(name: str) -> Path:
    """The shared library that holds kernel ``name`` (one per source)."""
    source = KERNELS[name][0]
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"{Path(source).stem}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of the source of ``name``, or "" when it was not built by
    this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=None) -> dict[str, float]:
    """Compile the source of every named kernel (default: all) whose library
    is missing, one ``nvcc`` process per source, all started together.
    Returns the build seconds of each source compiled now."""
    names = list(KERNELS if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        source = KERNELS[name][0]
        out = library_path(name)
        if source in started or out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[source] = (proc, tmp, out, time.perf_counter())
    seconds, failures = {}, []
    if not started:
        return seconds
    with trace("kernel.build"):
        for name, (proc, tmp, out, t0) in started.items():
            text, _ = proc.communicate()
            out.with_suffix(".log").write_text(text)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            seconds[name] = time.perf_counter() - t0
            observe_kernel_build(name, seconds[name])
    if failures:
        raise KernelBuildError("\n".join(failures))
    return seconds


def load(name: str):
    """The C entry point ``name`` of :data:`KERNELS`, its library built
    first if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build([name])
            _, entry, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
