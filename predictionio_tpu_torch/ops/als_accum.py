"""Segment accumulators for the ALS normal equations.

The port of the JAX package's ``ops/als_pallas.py``.  Every half-step of ALS
sums, for each entity being solved (a *segment*), the flat rows
``[vec(w * v v^T) | rhs * v | valid | 0 ...]`` of its COO ratings, where ``v``
is the opposite entity's factor row and ``(w, rhs)`` come from
``ops.als.confidence_weights``.  The result has the **row layout**
``[n_blocks * S, row_width(k)]``: column ``a*k + b`` holds the sum of
``w * v[a] * v[b]``, then ``rhs * v``, then the count, then zeros.

1. Host, once per training run: :func:`build_plan` sorts the stream by
   segment and pads it so every ``T``-row tile lies in one ``S``-segment
   block (the JAX package's layout, verbatim; :func:`chunk_plan` cuts the
   tiles into chunks of :func:`chunk_tiles` tiles).
2. Device, per half-step: :func:`segment_stats_fused` gathers the opposite
   factors and sums the rows it builds from them (kernel
   ``pio_als_fused_accum``); :func:`segment_stats_chunked` uploads and
   builds the rows a chunk at a time with torch ops and sums each chunk
   into a running output (kernel ``pio_als_segment_accum``, through
   :func:`segment_accum`).

Both kernels are hand-written CUDA C++ in ``csrc/als_accum.cu``.  On CUDA
tensors the wrappers launch them (or raise); on CPU tensors they run the
plain PyTorch versions beside them (:func:`segment_stats_fused_plain`,
:func:`segment_accum_plain`, :func:`segment_stats_chunked_plain`), which
``index_add_`` the same rows.  Precision: ``"highest"`` and ``"hilo"`` sum
fp32 rows in fp32; ``"bf16"`` rounds every row value to bf16 before adding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.ops import _kernels

S = 128   # accumulator rows (segments) per output block
T = 1024  # COO rows per tile

PRECISIONS = ("highest", "hilo", "bf16")

#: launches of each hand-written kernel, counted where it is launched
KERNEL_LAUNCHES: dict[str, int] = {"als_fused_accum": 0, "als_segment_accum": 0}

#: rows the plain versions build at once (bounds their [rows, width] temp)
_PLAIN_ROWS = 1 << 17


def row_width(rank: int) -> int:
    """Flat update row width for ``rank``: vec(A) | b | count, padded to
    whole 128-column slabs."""
    need = rank * rank + rank + 1
    return (need + 127) // 128 * 128


@dataclass(frozen=True)
class SegmentPlan:
    """Host-side layout for one direction (by-user or by-item), static
    across training iterations: the argsort happens once."""

    seg3: np.ndarray          # [nt, T//128, 128] int32 local ids, -1 = pad
    dest_perm: np.ndarray     # [P] original-row index feeding each slot
    pad_mask: np.ndarray      # [P] bool, True where slot is padding
    block_map: np.ndarray     # [nt] int32 output block per tile
    first: np.ndarray         # [nt] int32 1 on a block's first tile
    n_blocks: int
    n_tiles: int
    padded_len: int


def build_plan(seg: np.ndarray, num_seg_pad: int) -> SegmentPlan:
    """Sort by segment and pad each block to whole tiles (an empty block
    gets one tile of padding)."""
    if num_seg_pad % S != 0:
        raise ValueError(f"num_seg_pad must be a multiple of {S}")
    if len(seg) and (int(seg.min()) < 0 or int(seg.max()) >= num_seg_pad):
        # an out-of-range id would index past the output through block_map
        raise ValueError(
            f"segment ids must be in [0, {num_seg_pad}); got "
            f"[{int(seg.min())}, {int(seg.max())}]"
        )
    # int32 keys: numpy's stable sort is a radix sort for ints, so half
    # the key bytes is fewer passes
    order = np.argsort(seg.astype(np.int32), kind="stable")
    seg_sorted = seg[order]
    n_blocks = num_seg_pad // S
    blk = seg_sorted // S
    counts = np.bincount(blk, minlength=n_blocks)
    padded_counts = np.maximum((counts + T - 1) // T * T, T)
    starts = np.concatenate([[0], np.cumsum(padded_counts)[:-1]])
    P = int(padded_counts.sum())
    within = np.arange(len(seg)) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]]
    )[blk]
    dest = starts[blk] + within
    seg_local = np.full(P, -1, np.int32)
    seg_local[dest] = (seg_sorted - blk * S).astype(np.int32)
    nt = P // T
    block_map = np.repeat(
        np.arange(n_blocks, dtype=np.int32), padded_counts // T
    )
    first = np.zeros(nt, np.int32)
    first[starts // T] = 1
    dest_perm = np.zeros(P, np.int64)
    dest_perm[dest] = order
    return SegmentPlan(
        seg3=seg_local.reshape(nt, T // 128, 128),
        dest_perm=dest_perm,
        pad_mask=seg_local < 0,
        block_map=block_map,
        first=first,
        n_blocks=n_blocks,
        n_tiles=nt,
        padded_len=P,
    )


@dataclass(frozen=True)
class ChunkedPlan:
    """Per-chunk tile layout: the stream is processed ``tiles_per_chunk``
    tiles at a time, bounding the [rows, width] built rows to one chunk."""

    seg3: np.ndarray       # [C, tpc, T//128, 128]
    block_map: np.ndarray  # [C, tpc]
    first: np.ndarray      # [C, tpc] 1 on a block's first tile IN THE CHUNK
    visited: np.ndarray    # [C, n_blocks] f32 1.0 where the chunk touched
    dest_perm: np.ndarray  # [C*tpc*T] original row per slot (0 for filler)
    pad_mask: np.ndarray   # [C*tpc*T] True at padding/filler slots
    n_blocks: int
    n_chunks: int
    tiles_per_chunk: int


def chunk_plan(plan: SegmentPlan, tiles_per_chunk: int = 1024) -> ChunkedPlan:
    tpc = min(tiles_per_chunk, max(plan.n_tiles, 1))
    C = (plan.n_tiles + tpc - 1) // tpc
    nt2 = C * tpc
    fill = nt2 - plan.n_tiles
    seg3 = np.concatenate(
        [plan.seg3, np.full((fill, T // 128, 128), -1, np.int32)]
    )
    # filler tiles are all padding; they target block 0 and add nothing
    block_map = np.concatenate([plan.block_map, np.zeros(fill, np.int32)])
    first = np.concatenate([plan.first, np.ones(fill, np.int32)]).astype(
        np.int32
    )
    # a block continuing across a chunk boundary starts anew in the chunk
    first = first.copy()
    first[np.arange(0, nt2, tpc)] = 1
    visited = np.zeros((C, plan.n_blocks), np.float32)
    for c in range(C):
        visited[c, np.unique(block_map[c * tpc : (c + 1) * tpc])] = 1.0
    dest_perm = np.concatenate(
        [plan.dest_perm, np.zeros(fill * T, np.int64)]
    )
    pad_mask = np.concatenate(
        [plan.pad_mask, np.ones(fill * T, bool)]
    )
    return ChunkedPlan(
        seg3=seg3.reshape(C, tpc, T // 128, 128),
        block_map=block_map.reshape(C, tpc),
        first=first.reshape(C, tpc),
        visited=visited,
        dest_perm=dest_perm,
        pad_mask=pad_mask,
        n_blocks=plan.n_blocks,
        n_chunks=C,
        tiles_per_chunk=tpc,
    )


#: the most bytes one chunk's built fp32 rows may take on the chunked path
CHUNK_ROW_BYTES = 1 << 29


def chunk_tiles(width: int) -> int:
    """Tiles per chunk on the chunked path: 1,024 (the JAX package's
    default), or fewer where one chunk's ``[tiles * T, width]`` rows would
    pass :data:`CHUNK_ROW_BYTES` (341 at width 384, 113 at width 1152)."""
    return max(1, min(1024, CHUNK_ROW_BYTES // (T * width * 4)))


def make_wrv(rating2d: torch.Tensor, valid2d: torch.Tensor,
             implicit_prefs: bool, alpha: float) -> torch.Tensor:
    """Static per-row weights of the fused kernel, ``[nt, 3, T]``:
    A-weight | rhs | valid.  Depends on the data and the train
    hyperparameters only: made once per train, not per iteration."""
    from predictionio_tpu_torch.ops.als import confidence_weights

    w, rhs = confidence_weights(rating2d, valid2d, implicit_prefs, alpha)
    return torch.stack([w, rhs, valid2d.to(torch.float32)], dim=1)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")


def _flat_rows(v, w, rhs, val, width: int, out=None) -> torch.Tensor:
    """``[vec((v v^T) * w) | v * rhs | val | 0]`` per row: the kernel's
    row, with the same product order, written in place into ``out`` (a
    fresh ``[n, width]`` buffer if None), so no temporary as large as the
    rows is made."""
    n, k = v.shape
    kk = k * k
    rows = v.new_empty((n, width)) if out is None else out
    outer = rows[:, :kk].view(n, k, k)
    torch.mul(v[:, :, None], v[:, None, :], out=outer)
    outer.mul_(w[:, None, None])
    torch.mul(v, rhs[:, None], out=rows[:, kk:kk + k])
    rows[:, kk + k] = val
    rows[:, kk + k + 1:] = 0
    return rows


def _round(rows: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return rows.to(torch.bfloat16).to(torch.float32)
    return rows


def _global_seg(block_map: torch.Tensor, seg3: torch.Tensor) -> torch.Tensor:
    """Each stream row's output row (block * S + local id), -1 at padding."""
    seg = seg3.reshape(block_map.shape[0], T).to(torch.int64)
    g = block_map.to(torch.int64)[:, None] * S + seg
    return torch.where(seg >= 0, g, -1).reshape(-1)


# -- kernel 1: the fused accumulator ----------------------------------------


def segment_stats_fused_plain(
    plan_args: tuple,
    other_idx2d: torch.Tensor,
    wrv: torch.Tensor,
    other_factors: torch.Tensor,
    n_blocks: int,
    precision: str = "hilo",
) -> torch.Tensor:
    """The plain version of the fused kernel: gather, outer product,
    weights, then ``index_add_`` of the valid rows, a slice at a time."""
    _check_precision(precision)
    block_map, seg3 = plan_args
    k = other_factors.shape[1]
    width = row_width(k)
    out = torch.zeros(
        (n_blocks * S, width), dtype=torch.float32, device=other_factors.device
    )
    g = _global_seg(block_map, seg3)
    keep = torch.nonzero(g >= 0).squeeze(1)
    g = g[keep]
    oth = other_idx2d.reshape(-1)[keep]
    w, rhs, val = (wrv[:, j, :].reshape(-1)[keep] for j in range(3))
    for lo in range(0, len(g), _PLAIN_ROWS):
        sl = slice(lo, lo + _PLAIN_ROWS)
        rows = _flat_rows(
            other_factors[oth[sl].to(torch.int64)], w[sl], rhs[sl], val[sl],
            width,
        )
        out.index_add_(0, g[sl], _round(rows, precision))
    return out


def _check_cuda(name: str, **tensors) -> torch.device:
    dev = None
    for label, (x, dtype) in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {label} is {x.dtype}, not {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if dev is not None and x.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {x.device}")
        dev = x.device
    return dev


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1


def _scratch(n_tiles: int, width: int, device):
    carry = torch.empty((n_tiles, 2, width), dtype=torch.float32, device=device)
    carry_seg = torch.empty((n_tiles, 2), dtype=torch.int32, device=device)
    return carry, carry_seg


def fused_accum_cuda(
    plan_args: tuple,
    other_idx2d: torch.Tensor,
    wrv: torch.Tensor,
    other_factors: torch.Tensor,
    n_blocks: int,
    precision: str,
) -> torch.Tensor:
    """Launch ``pio_als_fused_accum`` on the current stream (no sync);
    raises on any input the kernel does not take and on a refused launch.
    Index values (segments, blocks, opposite rows) are the caller's
    contract: :func:`build_plan` and ``train_als`` check them on the host."""
    _check_precision(precision)
    block_map, seg3 = plan_args
    f32, i32 = torch.float32, torch.int32
    dev = _check_cuda(
        "fused_accum_cuda", block_map=(block_map, i32), seg3=(seg3, i32),
        other_idx2d=(other_idx2d, i32), wrv=(wrv, f32),
        other_factors=(other_factors, f32),
    )
    nt = seg3.shape[0]
    k = other_factors.shape[1] if other_factors.dim() == 2 else 0
    if not 1 <= k <= 32:
        raise ValueError(f"fused_accum_cuda: rank {k} outside 1..32")
    if (
        block_map.shape != (nt,) or seg3.numel() != nt * T
        or other_idx2d.numel() != nt * T or wrv.shape != (nt, 3, T)
    ):
        raise ValueError(
            "fused_accum_cuda: shapes do not match the plan: "
            f"block_map {tuple(block_map.shape)}, seg3 {tuple(seg3.shape)}, "
            f"other_idx2d {tuple(other_idx2d.shape)}, wrv {tuple(wrv.shape)}"
        )
    width = row_width(k)
    out = torch.zeros((n_blocks * S, width), dtype=f32, device=dev)
    carry, carry_seg = _scratch(nt, width, dev)
    _launch(
        "als_fused_accum", _kernels.load("als_fused_accum"),
        seg3.data_ptr(), block_map.data_ptr(), other_idx2d.data_ptr(),
        wrv.data_ptr(), other_factors.data_ptr(), nt, k, width,
        int(precision == "bf16"), out.data_ptr(), carry.data_ptr(),
        carry_seg.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def segment_stats_fused(
    plan_args: tuple,
    other_idx2d: torch.Tensor,
    wrv: torch.Tensor,
    other_factors: torch.Tensor,
    n_blocks: int,
    precision: str = "hilo",
) -> torch.Tensor:
    """Per-segment stats ``[n_blocks * S, row_width(k)]`` over the whole
    stream.  ``plan_args = (block_map [nt], seg3 [nt, 8, 128])`` int32,
    ``other_idx2d [nt, T]`` int32 opposite rows, ``wrv [nt, 3, T]`` from
    :func:`make_wrv`, ``other_factors [n_other, k]`` f32.  A CUDA tensor
    launches the fused kernel; a CPU tensor takes the plain version."""
    if other_factors.device.type == "cuda":
        return fused_accum_cuda(
            plan_args, other_idx2d, wrv, other_factors, n_blocks, precision
        )
    return segment_stats_fused_plain(
        plan_args, other_idx2d, wrv, other_factors, n_blocks, precision
    )


# -- kernel 2: the chunk accumulator ----------------------------------------


def segment_accum_plain(
    out: torch.Tensor,
    block_map: torch.Tensor,
    seg3: torch.Tensor,
    rows: torch.Tensor,
    precision: str = "hilo",
) -> torch.Tensor:
    """The plain version of the chunk kernel: ``index_add_`` of the given
    rows (padding rows skipped) into ``out``, in place."""
    _check_precision(precision)
    g = _global_seg(block_map, seg3)
    keep = torch.nonzero(g >= 0).squeeze(1)
    return out.index_add_(0, g[keep], _round(rows[keep], precision))


def segment_accum_cuda(
    out: torch.Tensor,
    block_map: torch.Tensor,
    seg3: torch.Tensor,
    rows: torch.Tensor,
    precision: str = "hilo",
) -> torch.Tensor:
    """Launch ``pio_als_segment_accum`` on the current stream (no sync),
    adding each segment's sum of ``rows [nt * T, width]`` into ``out``."""
    _check_precision(precision)
    f32, i32 = torch.float32, torch.int32
    dev = _check_cuda(
        "segment_accum_cuda", out=(out, f32), block_map=(block_map, i32),
        seg3=(seg3, i32), rows=(rows, f32),
    )
    nt = block_map.shape[0]
    width = out.shape[1] if out.dim() == 2 else 0
    if (
        block_map.dim() != 1 or seg3.numel() != nt * T
        or rows.shape != (nt * T, width) or width % 128 or width == 0
        or out.shape[0] % S
    ):
        raise ValueError(
            "segment_accum_cuda: shapes do not match: "
            f"out {tuple(out.shape)}, block_map {tuple(block_map.shape)}, "
            f"seg3 {tuple(seg3.shape)}, rows {tuple(rows.shape)}"
        )
    if seg3.data_ptr() % 16 or rows.data_ptr() % 16 or out.data_ptr() % 16:
        # the kernel reads seg3 and rows and reads and writes out 16 bytes
        # at a time
        raise ValueError("segment_accum_cuda: seg3, rows and out must be 16-byte aligned")
    carry, carry_seg = _scratch(nt, width, dev)
    _launch(
        "als_segment_accum", _kernels.load("als_segment_accum"),
        seg3.data_ptr(), block_map.data_ptr(), rows.data_ptr(), nt, width,
        int(precision == "bf16"), out.data_ptr(), carry.data_ptr(),
        carry_seg.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def segment_accum(
    out: torch.Tensor,
    block_map: torch.Tensor,
    seg3: torch.Tensor,
    rows: torch.Tensor,
    precision: str = "hilo",
) -> torch.Tensor:
    """Add each segment's sum of ``rows`` into ``out`` (in place): the
    chunk kernel on CUDA tensors, its plain version on CPU tensors."""
    if out.device.type == "cuda":
        return segment_accum_cuda(out, block_map, seg3, rows, precision)
    return segment_accum_plain(out, block_map, seg3, rows, precision)


def _chunked(accum, plan_args, other_idx_p, rating_p, valid_p,
             other_factors, implicit_prefs, alpha, n_blocks, precision):
    from predictionio_tpu_torch.ops.als import confidence_weights

    block_map, seg3 = plan_args
    dev = other_factors.device
    width = row_width(other_factors.shape[1])
    out = torch.zeros((n_blocks * S, width), dtype=torch.float32, device=dev)
    rows = None  # one chunk's built rows, reused chunk after chunk
    for c in range(block_map.shape[0]):
        # the chunk's streams go to the factors' device (a no-op where they
        # are already there; from pinned host memory the copy is async)
        bm, sg, oth, rat, val = (
            x[c].to(dev, non_blocking=True)
            for x in (block_map, seg3, other_idx_p, rating_p, valid_p)
        )
        w, rhs = confidence_weights(rat, val, implicit_prefs, alpha)
        rows = _flat_rows(other_factors[oth.to(torch.int64)], w, rhs, val,
                          width, out=rows)
        accum(out, bm, sg, rows, precision)
    return out


def segment_stats_chunked(
    plan_args: tuple,
    other_idx_p: torch.Tensor,
    rating_p: torch.Tensor,
    valid_p: torch.Tensor,
    other_factors: torch.Tensor,
    implicit_prefs: bool,
    alpha: float,
    n_blocks: int,
    precision: str = "hilo",
) -> torch.Tensor:
    """Per-segment stats ``[n_blocks * S, row_width(k)]``, a chunk at a
    time: ``plan_args = (block_map [C, tpc], seg3 [C, tpc, 8, 128])`` of a
    :class:`ChunkedPlan`, the padded streams ``[C, tpc * T]``, on the
    factors' device or in host memory (each chunk is uploaded in turn).
    Each chunk's rows are built with torch ops into one reused buffer and
    summed into the running output by :func:`segment_accum` (the chunk
    kernel on CUDA tensors), so a block that crosses chunks needs no
    mask."""
    return _chunked(
        segment_accum, plan_args, other_idx_p, rating_p, valid_p,
        other_factors, implicit_prefs, alpha, n_blocks, precision,
    )


def segment_stats_chunked_plain(
    plan_args: tuple,
    other_idx_p: torch.Tensor,
    rating_p: torch.Tensor,
    valid_p: torch.Tensor,
    other_factors: torch.Tensor,
    implicit_prefs: bool,
    alpha: float,
    n_blocks: int,
    precision: str = "hilo",
) -> torch.Tensor:
    """:func:`segment_stats_chunked` with :func:`segment_accum_plain` for
    every chunk, on any device."""
    return _chunked(
        segment_accum_plain, plan_args, other_idx_p, rating_p, valid_p,
        other_factors, implicit_prefs, alpha, n_blocks, precision,
    )


# -- least work (the bound a time on the card is held against) --------------


def als_accum_least_work(
    rows: int, k: int, n_seg_pad: int, n_oth_pad: int,
    valid_rows: int | None = None,
) -> dict[str, float]:
    """The least work of one fused accumulation over ``rows`` stream rows,
    ``valid_rows`` of them not padding (default: all): every row's segment
    id read once, and per valid row its opposite index and three weights
    (a padding row's segment id says it adds nothing); the block map and
    the opposite factor table read once; the ``[n_seg_pad,
    row_width(k)]`` output written once; and per valid row the
    ``3k^2 + 2k + 1`` fp32 operations that form and add its row."""
    valid = rows if valid_rows is None else valid_rows
    return {
        "bytes": 4.0 * (
            rows + valid * (1 + 3) + rows // T + n_oth_pad * k
            + n_seg_pad * row_width(k)
        ),
        "flops": float(valid) * (3 * k * k + 2 * k + 1),
    }


def segment_accum_least_work(
    rows: int, width: int, n_seg_touched: int,
    valid_rows: int | None = None,
) -> dict[str, float]:
    """The least work of one chunk accumulation over ``rows`` built rows,
    ``valid_rows`` of them not padding (default: all): every row's segment
    id and the block map read once, each valid row's ``width`` columns read
    once, the running output read and written once for the
    ``n_seg_touched`` segments of the blocks the chunk's tiles map to (the
    rest of it is untouched), and one fp32 add per valid row and column."""
    valid = rows if valid_rows is None else valid_rows
    return {
        "bytes": 4.0 * (
            rows + rows // T + valid * width + 2 * n_seg_touched * width
        ),
        "flops": float(valid) * width,
    }
