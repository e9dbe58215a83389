"""Top-k for serving paths: host replicas AND the fused device kernel.

Host half: solo queries are answered from a host numpy replica of the
factor tables (the reference's P2L local-model serving,
controller/P2LAlgorithm.scala:46-76).  ``host_topk``/``host_topk_batch`` are
the JAX package's, verbatim: their tie order (argpartition, then argsort
reversed) is part of the host-path contract.

Device half (:func:`fused_topk_batch`): ``queries [B, r] x table [N, r] ->
packed [2, B, k]`` with selection by ``(value desc, global id asc)`` —
exactly ``lax.top_k``'s tie rule, the contract of the JAX package's Pallas
kernel.  On CUDA tensors it launches the hand-written kernel in
``csrc/fused_topk.cu``, which never materializes the ``[B, N]`` score row;
on CPU tensors it runs :func:`fused_topk_plain`, the plain PyTorch version
of the same function.  There is no other path: a CUDA tensor either
launches the kernel or raises.

Shapes off the fused menu (``k`` past :data:`MAX_FUSED_K`) raise
:class:`FusedTopKUnsupported` here.  :func:`full_row_topk` answers them
under the same tie rule, on the CPU or on the card, counted with
:func:`note_full_row_fallback`, as the JAX package answers them outside
its Pallas kernel.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.ops import _kernels

log = logging.getLogger("predictionio_tpu_torch.ops.topk")

#: the JAX kernel's score-slab rows per grid step (kept for its roofline
#: model, :func:`fused_topk_roofline`)
TILE_ROWS = 1024

#: the JAX kernel's batch rows per block
BATCH_BLOCK = 128

#: largest k on the fused menu (the CUDA kernel keeps k/32 register slots
#: per lane, at most 4)
MAX_FUSED_K = 128

#: retired-entry / padding sentinel id — a power of two, exactly
#: representable in f32, above the 2^24 packed-id ceiling; must match
#: kRetiredId in csrc/fused_topk.cu
RETIRED_ID = float(1 << 25)

#: table rows per shared-memory tile of the CUDA kernel (``kTileRows`` in
#: csrc/fused_topk.cu, which refuses a slab that is not whole tiles)
TILE_ROWS_CUDA = 64

#: queries per pass-1 CTA the CUDA kernel is built for (:func:`query_block`
#: picks one): blocks of 8 for a wave of at most :data:`SMALL_WAVE` queries,
#: whose few blocks then still fill the card without cutting N into many
#: short slabs, and for a k past :data:`WIDE_K`, whose merges then spread
#: over more CTAs; blocks of 32 else
QUERY_BLOCKS = (8, 32)
SMALL_WAVE = 1024
WIDE_K = 64

#: pass-1 CTAs aimed for per SM at most (fewer where shared memory binds),
#: so small waves still fill the card
CTAS_PER_SM = 4

#: the most recent fused launch per name: its route ("cuda" or "plain"),
#: the widest score slab it held (``rows_tile``: a kernel tile on CUDA, the
#: whole row for the plain version) and its grid
LAST_KERNEL_SHAPES: dict[str, dict] = {}

#: launches of each hand-written kernel, counted where it is launched
KERNEL_LAUNCHES: dict[str, int] = {"fused_topk": 0}

#: full-score-row top-k dispatches per ``where`` (off-menu shapes)
FULL_ROW_FALLBACKS: dict[str, int] = {}

_CARDS: dict[int, "CardLimits"] = {}


class FusedTopKUnsupported(ValueError):
    """The requested (batch, k, n_items) shape is off the fused menu."""


def host_topk(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k (values, indices) of a 1-D score vector, sorted descending."""
    n = scores.shape[0]
    k = min(k, n)
    if k <= 0:
        return scores[:0], np.zeros((0,), np.int64)
    if k < n:
        idx = np.argpartition(scores, n - k)[n - k:]
    else:
        idx = np.arange(n)
    order = np.argsort(scores[idx])[::-1]
    idx = idx[order]
    return scores[idx], idx


def host_topk_batch(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise top-k of a [B, n] score matrix, each row sorted descending."""
    b, n = scores.shape
    k = min(k, n)
    if k <= 0:
        return scores[:, :0], np.zeros((b, 0), np.int64)
    if k < n:
        idx = np.argpartition(scores, n - k, axis=1)[:, n - k:]
    else:
        idx = np.broadcast_to(np.arange(n), (b, n)).copy()
    vals = np.take_along_axis(scores, idx, axis=1)
    order = np.argsort(vals, axis=1)[:, ::-1]
    idx = np.take_along_axis(idx, order, axis=1)
    return np.take_along_axis(scores, idx, axis=1), idx


def fused_supported(batch: int, k: int, n_items: int) -> bool:
    """True when (batch, k, n_items) is on the fused menu."""
    return 0 < k <= MAX_FUSED_K and k <= n_items and batch > 0


#: shapes already warned about — the counter ticks per dispatch, the log
#: once per distinct shape
_WARNED_FALLBACK_SHAPES: set[tuple] = set()


def note_full_row_fallback(
    batch: int, k: int, n_items: int, where: str
) -> None:
    """Count (and name, once per shape) one top-k that had to score the
    whole ``[batch, n_items]`` row because its shape is off the fused
    menu."""
    FULL_ROW_FALLBACKS[where] = FULL_ROW_FALLBACKS.get(where, 0) + 1
    shape = (where, batch, k, n_items)
    if shape not in _WARNED_FALLBACK_SHAPES:
        _WARNED_FALLBACK_SHAPES.add(shape)
        log.warning(
            "full-score-row top-k fallback at %s: batch=%d k=%d n_items=%d "
            "(off the fused menu: k<=%d; counted per dispatch in "
            "FULL_ROW_FALLBACKS, logged once per shape)",
            where, batch, k, n_items, MAX_FUSED_K,
        )


def fused_topk_plain(
    q: torch.Tensor, t: torch.Tensor, k: int, limit: int
) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel: the full score row,
    the limit mask, a stable descending sort (equal values keep id order:
    id ascending) and the first k.  ``torch.topk`` promises no tie order,
    so it is not used."""
    # + 0.0 turns -0.0 into +0.0: the kernel's sums start from +0, and the
    # two zeros must tie by id, not order by sign bit
    scores = q @ t.T + 0.0
    if limit < t.shape[0]:
        scores[:, max(limit, 0):] = float("-inf")
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return torch.stack([vals[:, :k], idx[:, :k].to(torch.float32)])


@dataclass(frozen=True)
class CardLimits:
    """What the card offers a pass-1 CTA: its SMs, the shared memory one CTA
    may opt into, the shared memory of one SM, and what the system reserves
    per CTA (bytes)."""

    sm_count: int
    smem_per_cta: int
    smem_per_sm: int
    smem_reserved: int


def query_block(batch: int, k: int) -> int:
    """Queries per pass-1 CTA for a wave of ``batch`` queries keeping ``k``
    each (``chip_smoke.py``'s kernel_launch_shapes phase times both sizes
    beside the one picked)."""
    small = batch <= SMALL_WAVE or k > WIDE_K
    return QUERY_BLOCKS[0] if small else QUERY_BLOCKS[1]


def kernel_geometry(
    batch: int, n_rows: int, qpc: int, smem_bytes: int, card: CardLimits
) -> dict[str, int]:
    """The CUDA kernel's launch shape for blocks of ``qpc`` queries whose
    pass-1 CTA needs ``smem_bytes`` of shared memory (the library's count,
    :func:`kernel_smem_bytes`): how many such CTAs fit on an SM, and N cut
    into ``n_splits`` slabs of ``rows_per_split`` rows (whole 64-row tiles)
    so that the card holds about as many pass-1 CTAs as fit at once, even
    for small waves.  Refuses a CTA that does not fit the card."""
    if smem_bytes < 0:
        raise FusedTopKUnsupported(
            f"fused top-k: the kernel takes no rank, k or block of {qpc} queries "
            "like this one"
        )
    if smem_bytes > card.smem_per_cta:
        raise FusedTopKUnsupported(
            f"fused top-k: a pass-1 CTA needs {smem_bytes} bytes of shared "
            f"memory, past the card's {card.smem_per_cta} per CTA"
        )
    ctas_per_sm = max(
        1, min(CTAS_PER_SM, card.smem_per_sm // (smem_bytes + card.smem_reserved))
    )
    n_qblocks = -(-batch // qpc)
    n_tiles = -(-n_rows // TILE_ROWS_CUDA)
    n_splits = min(n_tiles, max(1, ctas_per_sm * card.sm_count // n_qblocks))
    tiles_per_split = -(-n_tiles // n_splits)
    return {
        "queries_per_cta": qpc,
        "tile_rows": TILE_ROWS_CUDA,
        "rows_per_split": tiles_per_split * TILE_ROWS_CUDA,
        "n_splits": -(-n_tiles // tiles_per_split),
        "n_qblocks": n_qblocks,
        "n_tiles": n_tiles,
        "smem_bytes": smem_bytes,
        "ctas_per_sm": ctas_per_sm,
    }


def kernel_smem_bytes(rank: int, k: int, qpc: int) -> int:
    """Shared memory of one pass-1 CTA, as csrc/fused_topk.cu lays it out
    (``pio_fused_topk_smem``; -1 for an input the kernel refuses)."""
    return int(_kernels.load("fused_topk_smem")(rank, k, qpc))


def card_limits(device: torch.device) -> CardLimits:
    """The SM count (from PyTorch) and the shared-memory limits (from the
    CUDA runtime, ``pio_device_smem``) of a card, read once per card."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CARDS:
        limits = (ctypes.c_int * 3)()
        err = _kernels.load("device_smem")(idx, ctypes.addressof(limits))
        if err != 0:
            raise RuntimeError(f"pio_device_smem failed: CUDA error {err}")
        _CARDS[idx] = CardLimits(
            torch.cuda.get_device_properties(idx).multi_processor_count, *limits
        )
    return _CARDS[idx]


def cuda_geometry(
    batch: int, n_rows: int, rank: int, k: int, device: torch.device,
    qpc: int | None = None,
) -> dict[str, int]:
    """:func:`kernel_geometry` on ``device`` for this wave (queries per CTA
    from :func:`query_block` unless ``qpc`` is given)."""
    qpc = query_block(batch, k) if qpc is None else qpc
    return kernel_geometry(
        batch, n_rows, qpc, kernel_smem_bytes(rank, k, qpc), card_limits(device)
    )


def fused_topk_cuda(
    q: torch.Tensor, t: torch.Tensor, k: int, limit: int, geo: dict[str, int],
    timing: tuple[torch.cuda.Event, torch.cuda.Event] | None = None,
) -> torch.Tensor:
    """Launch ``csrc/fused_topk.cu`` on the current stream (no sync) and
    return the packed ``[2, B, k]`` output; raises on any input the kernel
    does not take and on a refused launch.

    ``timing``, a pair of ``torch.cuda.Event(enable_timing=True)``, is
    recorded by the launcher itself, just before the first pass and just
    after the last, so ``timing[0].elapsed_time(timing[1])`` is the
    kernel's own time, with no host enqueue gap in it."""
    for name, x in (("queries", q), ("table", t)):
        if x.device.type != "cuda":
            raise ValueError(f"fused_topk_cuda: {name} is on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"fused_topk_cuda: {name} is {x.dtype}, not float32")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"fused_topk_cuda: {name} must be 2-D contiguous")
    if q.device != t.device:
        raise ValueError(f"fused_topk_cuda: queries on {q.device}, table on {t.device}")
    b, rank = q.shape
    n = t.shape[0]
    if t.shape[1] != rank:
        raise ValueError(f"fused_topk_cuda: rank {rank} vs table {tuple(t.shape)}")
    if not fused_supported(b, k, n) or n >= 1 << 24:
        raise FusedTopKUnsupported(
            f"fused_topk_cuda: batch={b} k={k} n_items={n} (k in 1..{MAX_FUSED_K}, "
            "k <= n_items < 2^24)"
        )
    fn = _kernels.load("fused_topk")
    splits = geo["n_splits"]
    # the slab lists pass 2 merges; one slab writes the output directly
    scratch = (b, splits, k) if splits > 1 else (0,)
    cand_v = torch.empty(scratch, dtype=torch.float32, device=q.device)
    cand_i = torch.empty(scratch, dtype=torch.int32, device=q.device)
    out = torch.empty((2, b, k), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    events = (None, None)
    if timing is not None:
        # torch creates an event at its first record; the launcher's own
        # records replace these
        for ev in timing:
            ev.record(stream)
        events = tuple(ev.cuda_event for ev in timing)
    err = fn(
        q.data_ptr(), t.data_ptr(), b, n, rank, k, min(max(limit, 0), n),
        geo["queries_per_cta"], geo["rows_per_split"], splits,
        cand_v.data_ptr(), cand_i.data_ptr(), out.data_ptr(),
        stream.cuda_stream, *events,
    )
    if err != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["fused_topk"] += 1
    return out


def fused_topk_batch(
    queries,
    table,
    k: int,
    limit: int | None = None,
    *,
    name: str = "fused_topk",
    timing: tuple[torch.cuda.Event, torch.cuda.Event] | None = None,
) -> torch.Tensor:
    """Fused score+top-k: ``queries [B, r] x table [N, r] -> packed
    [2, B, k]`` f32 (row 0 scores, row 1 global row ids, exact < 2^24).

    ``limit`` is the number of valid table rows (default N): rows at or
    past it score ``-inf`` and keep their real ids, so they surface only
    when ``k`` exceeds it.  CUDA tensors launch the kernel (asynchronously,
    on the current stream); CPU tensors take :func:`fused_topk_plain`.
    ``timing`` is :func:`fused_topk_cuda`'s (unused on the CPU).

    Raises :class:`FusedTopKUnsupported` off the menu."""
    q = torch.as_tensor(queries, dtype=torch.float32)
    t = torch.as_tensor(table)
    b, rank = q.shape
    n_rows = t.shape[0]
    if not fused_supported(b, k, n_rows):
        raise FusedTopKUnsupported(
            f"fused top-k menu: batch={b} k={k} n_items={n_rows} "
            f"(k must be in 1..{MAX_FUSED_K} and <= n_items)"
        )
    limit = n_rows if limit is None else int(limit)
    if q.device.type == "cuda":
        geo = cuda_geometry(b, n_rows, rank, k, q.device)
        LAST_KERNEL_SHAPES[name] = {
            "route": "cuda",
            "rows_tile": min(geo["tile_rows"], n_rows),
            "batch": b,
            "batch_block": geo["queries_per_cta"],
            "k": k,
            "n_rows": n_rows,
            "n_tiles": geo["n_tiles"],
            "n_splits": geo["n_splits"],
        }
        return fused_topk_cuda(q, t, k, limit, geo, timing)
    if q.device.type != "cpu" or t.device.type != "cpu":
        raise ValueError(
            f"fused_topk_batch: queries on {q.device}, table on {t.device}"
        )
    LAST_KERNEL_SHAPES[name] = {
        "route": "plain",
        "rows_tile": n_rows,
        "batch": b,
        "batch_block": b,
        "k": k,
        "n_rows": n_rows,
        "n_tiles": 1,
        "n_splits": 1,
    }
    return fused_topk_plain(q, t.to(torch.float32), k, limit)


#: the most bytes one slice of an off-menu wave may hold on the card: its
#: score row, the sorted values and their int64 ids (:func:`full_row_slices`)
FULL_ROW_SLICE_BYTES = 1 << 30

#: bytes per score of an off-menu slice, with headroom: the f32 score row,
#: the sorted f32 value, its int64 id and the sort's own scratch peak at
#: 48.5 per score at the ML-20M shape on an H100 (``chip_smoke.py``'s
#: off_menu_wave phase reports it as ``peak_bytes_per_score``)
_FULL_ROW_BYTES_PER_SCORE = 56


def full_row_slices(batch: int, n_rows: int) -> int:
    """Queries per slice of an off-menu wave on the card, so that one
    slice's score row and its sort stay within
    :data:`FULL_ROW_SLICE_BYTES` (at least one query)."""
    per_query = _FULL_ROW_BYTES_PER_SCORE * max(n_rows, 1)
    return max(1, min(batch, FULL_ROW_SLICE_BYTES // per_query))


def full_row_sliced(
    queries: torch.Tensor, table: torch.Tensor, k: int, rows_per_slice: int
) -> torch.Tensor:
    """The off-menu route's body: for ``rows_per_slice`` queries at a time,
    the whole score row ``q @ t.T`` (in the process's fp32 matmul
    precision: full fp32 unless the caller opted into TF32; ``+ 0`` makes
    every ``-0`` a ``+0``, as the fused kernel's sums start from ``+0``), a
    stable descending sort (equal values keep id order) and its first k,
    into one packed ``[2, B, k]`` output.  Each query's answer depends on
    its own row only, so each slice gives the same answer as the whole."""
    b = queries.shape[0]
    out = torch.empty((2, b, k), dtype=torch.float32, device=queries.device)
    for lo in range(0, b, rows_per_slice):
        hi = min(b, lo + rows_per_slice)
        scores = queries[lo:hi] @ table.T
        scores += 0.0  # in place: no second score row
        vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        del scores
        out[0, lo:hi] = vals[:, :k]
        out[1, lo:hi] = idx[:, :k]
    return out


def full_row_topk(
    queries: torch.Tensor, table: torch.Tensor, k: int, *, where: str
) -> torch.Tensor:
    """Top-k over the whole ``[B, N]`` score row for shapes off the fused
    menu (``k`` past :data:`MAX_FUSED_K`): the same packed ``[2, B, k]``
    output and (value desc, id asc) tie rule as :func:`fused_topk_batch`,
    counted per ``where`` in :data:`FULL_ROW_FALLBACKS`.

    This is the counterpart of the JAX package's off-menu route
    (``_device_score_topk``: a jitted matmul and ``lax.top_k`` in XLA,
    outside any Pallas kernel), not the fused kernel's plain version
    (:func:`fused_topk_plain`, which it does not call).  It scores with
    ``torch.matmul`` and a stable descending sort (``torch.topk`` promises
    no tie order), :func:`full_row_sliced`: on CPU tensors the whole wave
    at once; on CUDA tensors a slice of queries at a time, so that an
    off-menu wave never holds more than :data:`FULL_ROW_SLICE_BYTES`.  Any
    other device raises ``ValueError``."""
    b, n_rows = queries.shape[0], table.shape[0]
    dev = {queries.device.type, table.device.type}
    if dev not in ({"cpu"}, {"cuda"}) or queries.device != table.device:
        raise ValueError(
            f"{where}: off-menu top-k runs on CPU or CUDA tensors; queries on "
            f"{queries.device}, table on {table.device}"
        )
    if not 0 < k <= n_rows:
        raise FusedTopKUnsupported(f"{where}: k={k} with {n_rows} rows")
    note_full_row_fallback(b, k, n_rows, where)
    q, t = queries.to(torch.float32), table.to(torch.float32)
    rows = b if dev == {"cpu"} else full_row_slices(b, n_rows)
    return full_row_sliced(q, t, k, rows)


def fused_topk_roofline(
    batch: int, rank: int, n_items: int, k: int
) -> dict[str, float]:
    """Analytic per-launch HBM bytes and flops of the JAX package's fused
    kernel (its tiling: the table read once per ``BATCH_BLOCK`` batch
    block, the queries once per ``TILE_ROWS`` tile, the winners written
    once)."""
    nb = -(-batch // BATCH_BLOCK)
    nt = -(-n_items // TILE_ROWS)
    bytes_moved = (
        n_items * rank * 4.0 * nb         # table slabs, once per batch block
        + batch * rank * 4.0 * nt         # query block re-read per tile
        + 2.0 * batch * k * 4.0           # packed winners out
    )
    flops = 2.0 * batch * n_items * rank  # the score contraction
    return {"bytes": bytes_moved, "flops": flops}


def fused_topk_least_work(
    batch: int, rank: int, n_items: int, k: int
) -> dict[str, float]:
    """The least work of one fused top-k: each input read once, the packed
    output written once, and the score contraction's flops (the bound a
    time on the card is held against)."""
    return {
        "bytes": 4.0 * (batch * rank + n_items * rank + 2 * batch * k),
        "flops": 2.0 * batch * n_items * rank,
    }
