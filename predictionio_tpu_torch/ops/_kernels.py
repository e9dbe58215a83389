"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, compiled by
``nvcc`` for ``sm_90a`` into a shared library and called through ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries are built at
first use, named by a hash of the source and the flags, into
:func:`build_dir`: ``$PIO_KERNEL_BUILD_DIR`` when set, else the git-ignored
``build/kernels/`` when the package runs from a checkout, else a per-user
cache.  A failed build raises :class:`KernelBuildError` with the
compiler's output.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: the checkout the package runs from, when it does (it has the project file)
_CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: kernel name -> (source file in csrc/, C entry point, argtypes)
KERNELS: dict[str, tuple[str, str, list]] = {
    # q, t, B, N, r, k, limit, tile_rows, rows_per_split, n_splits,
    # cand_v, cand_i, out, stream
    "fused_topk": (
        "fused_topk.cu", "pio_fused_topk",
        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
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
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) from
    the build of ``name``, or "" when it was not built by this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=None) -> dict[str, float]:
    """Compile every named kernel (default: all) whose library is missing,
    one ``nvcc`` process per source, all started together.  Returns the
    build seconds of each kernel compiled now."""
    names = list(KERNELS if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        seconds[name] = time.perf_counter() - t0
    if failures:
        raise KernelBuildError("\n".join(failures))
    return seconds


def load(name: str):
    """The C entry point of kernel ``name``, built first if needed."""
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
