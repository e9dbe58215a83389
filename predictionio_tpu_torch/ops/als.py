"""Alternating least squares on one device, in PyTorch.

The port of the JAX package's ``ops/als.py`` single-device path.  Explicit
feedback solves  (Vu^T Vu + reg * I) x = Vu^T r_u  with MLlib's ALS-WR
option of scaling reg by the per-entity rating count; implicit feedback
(Hu-Koren) solves  (V^T V + Vu^T diag(alpha r) Vu + reg I) x =
Vu^T (1 + alpha r) 1.

Each half-step accumulates the per-entity normal equations with the segment
accumulators of :mod:`predictionio_tpu_torch.ops.als_accum` (hand-written
CUDA kernels on a card, their plain versions on the CPU) and solves the
batched k x k systems with ``torch.linalg.cholesky_ex`` +
``torch.cholesky_solve``.  The same code runs on either device; only the
accumulator wrappers dispatch.

A train places itself on the live roofline as the JAX package's does
(``_record_pallas_efficiency``): ``als.pallas_step`` is observed with the
wall time of the iterations over their count, after the train's closing
``torch.cuda.synchronize``, against the least work of one iteration — the
two half-steps' ``als_accum_least_work`` (fused), or the chunks' summed
``segment_accum_least_work`` (chunked).
"""

from __future__ import annotations

import hashlib
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import als_accum


@dataclass(frozen=True)
class ALSParams:
    """Hyperparameters; defaults mirror the reference template's engine.json
    (rank=10, numIterations=20, lambda=0.01, seed=3).  The fields and
    defaults are the JAX package's (the engine-params contract)."""

    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    implicit_prefs: bool = False
    alpha: float = 1.0  # implicit confidence scale
    scale_reg_with_count: bool = True  # MLlib ALS-WR lambda * n_u scaling
    seed: int = 3
    #: COO entries per scan step of the JAX package's scatter path; the
    #: port's accumulators tile the stream themselves and do not read it
    chunk_size: int = 1 << 19
    #: accumulator precision: "hilo" and "highest" sum fp32 rows in fp32,
    #: "bf16" rounds each row value to bf16 before adding
    pallas_precision: str = "hilo"
    #: "auto" takes the fused accumulator unless its staged streams would
    #: take more than half the card's free memory, else the chunked one;
    #: "fused"/"chunked" force a path
    pallas_mode: str = "auto"


@dataclass
class ALSState:
    """Trained factors: torch tensors on the training device."""

    user_factors: Any  # [num_users, rank]
    item_factors: Any  # [num_items, rank]


def confidence_weights(rating, valid, implicit_prefs: bool, alpha: float):
    """(A-weight, rhs) per COO row: the one home of the MLlib semantics.

    Explicit: plain least squares (weight = valid, rhs = r).  Implicit
    (Hu-Koren / trainImplicit): confidence from |r|, preference = 1 iff
    r > 0, so negative ratings are high-confidence negatives."""
    if implicit_prefs:
        conf_minus_1 = alpha * rating.abs() * valid
        pref = (rating > 0).to(rating.dtype)
        return conf_minus_1, (1.0 + conf_minus_1) * pref * valid  # c * p
    return valid, rating * valid


def _solve_factors(A, b, counts, reg, scale_reg, gram=None):
    """Solve (A + reg' I [+ gram]) x = b batched over the leading axis by
    Cholesky; reg' is reg * max(count, 1) under ALS-WR.  No pivoting: the
    operands are SPD + ridge."""
    k = b.shape[-1]
    if scale_reg:
        reg_eff = reg * torch.clamp(counts, min=1.0)
    else:
        reg_eff = torch.full_like(counts, reg)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    lhs = A + reg_eff[:, None, None] * eye
    if gram is not None:
        lhs = lhs + gram
    L, _ = torch.linalg.cholesky_ex(lhs)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


#: diagnostics from the most recent staging and train: padded row counts,
#: block counts, chunks per direction, mode and the staging seconds
LAST_PLAN_INFO: dict = {}

#: single-entry staging cache: the host sort/permute and the upload of the
#: streams depend only on the data, so retraining on the same ratings (a
#: benchmark's repeats, a hyperparameter sweep) reuses the staged tensors.
#: Keyed by a content hash of the raw arrays; one dataset at a time, so
#: stale streams do not pin device memory.
_STAGE_CACHE: dict = {}


def _data_fingerprint(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _is_oom_error(e: BaseException) -> bool:
    """Device memory exhaustion, the one error the mode ladder reacts to."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _init_factors(p: ALSParams, num_users_pad, num_items_pad, num_users,
                  num_items, device) -> tuple[torch.Tensor, torch.Tensor]:
    """MLlib-style nonnegative init, abs(normal) / sqrt(rank), drawn for the
    real entity counts from a host ``torch.Generator`` seeded with
    ``p.seed`` (so a CPU and a CUDA train start from the same factors);
    padded rows are zero, so the implicit Gram sees only real entities."""
    g = torch.Generator(device="cpu")
    g.manual_seed(p.seed)
    scale = float(np.sqrt(p.rank))
    U = torch.zeros((num_users_pad, p.rank), dtype=torch.float32)
    V = torch.zeros((num_items_pad, p.rank), dtype=torch.float32)
    U[:num_users] = torch.randn((num_users, p.rank), generator=g).abs() / scale
    V[:num_items] = torch.randn((num_items, p.rank), generator=g).abs() / scale
    return U.to(device), V.to(device)


def train_als(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    rating: np.ndarray,
    num_users: int,
    num_items: int,
    params: ALSParams | None = None,
    device: torch.device | str | None = None,
    init_factors: tuple[np.ndarray, np.ndarray] | None = None,
) -> ALSState:
    """Train ALS factors from COO ratings on ``device`` (``None`` means
    CUDA, and raises without a card unless ``device="cpu"``).

    ``init_factors`` warm-starts the solve: ``(U0, V0)`` host arrays of
    shape ``[num_users, rank]`` / ``[num_items, rank]``, aligned to the
    caller's vocabularies, replace the random init.  Factors, ratings and
    the accumulators are float32."""
    p = params or ALSParams()
    if not 1 <= p.rank <= 32:
        raise ValueError(f"train_als: rank {p.rank} outside 1..32")
    if p.pallas_mode not in ("auto", "fused", "chunked"):
        raise ValueError(f"unknown pallas_mode {p.pallas_mode!r}")
    if p.pallas_precision not in als_accum.PRECISIONS:
        raise ValueError(f"unknown pallas_precision {p.pallas_precision!r}")
    dev = resolve_device(device)
    user_idx = np.asarray(user_idx)
    item_idx = np.asarray(item_idx)
    rating = np.asarray(rating)
    if not len(user_idx) == len(item_idx) == len(rating):
        raise ValueError("user_idx, item_idx and rating differ in length")
    for name, idx, n in (("user", user_idx, num_users), ("item", item_idx, num_items)):
        if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(
                f"{name} ids must be in [0, {n}); got "
                f"[{int(idx.min())}, {int(idx.max())}]"
            )
    if init_factors is not None:
        Uw, Vw = init_factors
        if Uw.shape != (num_users, p.rank) or Vw.shape != (num_items, p.rank):
            raise ValueError(
                f"init_factors shapes {Uw.shape}/{Vw.shape} do not match "
                f"({num_users}, {p.rank})/({num_items}, {p.rank})"
            )
    return _train(user_idx, item_idx, rating, num_users, num_items, p, dev,
                  init_factors)


def _train(user_idx, item_idx, rating, num_users, num_items, p: ALSParams,
           device, init_factors=None) -> ALSState:
    """The one single-device path, with the mode ladder ``fused ->
    chunked``.  The fused rung keeps both directions' streams on the
    device: 28 bytes per stream row (segment id, opposite row, rating and
    validity, staged; weight, rhs and validity, per train).  The chunked
    rung keeps them in host memory (pinned) and uploads one chunk at a
    time, so besides the factors and the stats the device holds one
    chunk's built rows, at most ``als_accum.CHUNK_ROW_BYTES`` (512 MiB).
    It needs less device memory than fused once the fused streams pass
    that, from about 10 M ratings on; below that, fused needs less.  On
    device-memory exhaustion (and only then) fused gives way to chunked.
    The chunked rung also dispatches one iteration at a time, as eager
    PyTorch always does, so it takes the place of the JAX package's third
    rung (per-iteration dispatch) as well.  Any other error is raised as
    it is."""
    mode = p.pallas_mode
    if mode == "auto":
        mode = "fused"
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            est_rows = int(len(user_idx) * 1.06) + als_accum.T
            # the fused rung's 7 four-byte values per row, both directions
            if 2 * est_rows * 4 * 7 > free // 2:
                mode = "chunked"
    ladder = [mode] + (["chunked"] if mode == "fused" else [])
    for i, m in enumerate(ladder):
        try:
            return _train_mode(user_idx, item_idx, rating, num_users,
                               num_items, p, device, m, init_factors)
        except Exception as e:
            if not _is_oom_error(e) or i == len(ladder) - 1:
                raise
            warnings.warn(
                f"ALS {m} accumulation ran out of device memory "
                f"({type(e).__name__}); retrying as {ladder[i + 1]}",
                RuntimeWarning,
                stacklevel=2,
            )
        # out of the handler, the failed attempt's frames and the tensors
        # they held are gone: drop its staged streams and return the memory
        _STAGE_CACHE.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    raise AssertionError("unreachable")


def _stage(seg, oth, rating, num_seg_pad, mode, device,
           tiles_per_chunk: int = 1024):
    """One direction's plan and its streams: int32 local segment ids and
    opposite rows, f32 ratings and validity, in tile (fused) or chunk
    (chunked, ``tiles_per_chunk`` tiles) layout.  The fused streams go to
    ``device``; the chunked ones stay in host memory, pinned for a card,
    and the accumulator uploads them a chunk at a time."""
    plan = als_accum.build_plan(np.asarray(seg, np.int64), num_seg_pad)
    if mode == "chunked":
        plan = als_accum.chunk_plan(plan, tiles_per_chunk)
        shape2 = (plan.n_chunks, plan.tiles_per_chunk * als_accum.T)
    else:
        shape2 = (plan.n_tiles, als_accum.T)
    oth_p = np.asarray(oth, np.int32)[plan.dest_perm]
    rat_p = np.asarray(rating, np.float32)[plan.dest_perm]
    oth_p[plan.pad_mask] = 0
    rat_p[plan.pad_mask] = 0.0

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if mode != "chunked":
            return t.to(device)
        return t.pin_memory() if device.type == "cuda" else t

    return {
        "plan": plan,
        "plan_args": (put(plan.block_map), put(plan.seg3)),
        "oth": put(oth_p.reshape(shape2)),
        "rat": put(rat_p.reshape(shape2)),
        "val": put((~plan.pad_mask).astype(np.float32).reshape(shape2)),
    }


def _train_mode(user_idx, item_idx, rating, num_users, num_items,
                p: ALSParams, device, mode: str, init_factors=None) -> ALSState:
    num_users_pad = max((num_users + 127) // 128 * 128, 128)
    num_items_pad = max((num_items + 127) // 128 * 128, 128)
    tpc = als_accum.chunk_tiles(als_accum.row_width(p.rank))
    cache_key = (
        _data_fingerprint(user_idx, item_idx, rating),
        num_users_pad, num_items_pad, mode,
        tpc if mode == "chunked" else None, str(device),
    )
    staged = _STAGE_CACHE.get(cache_key)
    if staged is None:
        # evict before staging: holding the old dataset's streams while
        # uploading the new ones would transiently double device memory
        _STAGE_CACHE.clear()
        t0 = time.perf_counter()
        # the two directions stage concurrently: numpy radix sorts and
        # permutes, which release the GIL
        with ThreadPoolExecutor(2) as pool:
            fu = pool.submit(_stage, user_idx, item_idx, rating,
                             num_users_pad, mode, device, tpc)
            fi = pool.submit(_stage, item_idx, user_idx, rating,
                             num_items_pad, mode, device, tpc)
            staged = (fu.result(), fi.result())
        LAST_PLAN_INFO["stage_s"] = time.perf_counter() - t0
        _STAGE_CACHE[cache_key] = staged
    su, si = staged
    up, ip = su["plan"], si["plan"]
    if mode == "fused":
        rows_u, rows_i = up.padded_len, ip.padded_len
        chunks_u = chunks_i = 1
        tiles_per_chunk = None
    else:
        rows_u = up.n_chunks * up.tiles_per_chunk * als_accum.T
        rows_i = ip.n_chunks * ip.tiles_per_chunk * als_accum.T
        chunks_u, chunks_i = up.n_chunks, ip.n_chunks
        tiles_per_chunk = up.tiles_per_chunk
    LAST_PLAN_INFO.update(
        tiles_per_chunk=tiles_per_chunk,
        rank=p.rank,
        width=als_accum.row_width(p.rank),
        rows_user=rows_u,
        rows_item=rows_i,
        blocks_user=up.n_blocks,
        blocks_item=ip.n_blocks,
        chunks_user=chunks_u,
        chunks_item=chunks_i,
        nnz=len(user_idx),
        precision=p.pallas_precision,
        mode=mode,
        device=str(device),
    )

    U, V = _init_factors(p, num_users_pad, num_items_pad, num_users,
                         num_items, device)
    if init_factors is not None:
        U[:num_users] = torch.as_tensor(
            np.asarray(init_factors[0], np.float32), device=device
        )
        V[:num_items] = torch.as_tensor(
            np.asarray(init_factors[1], np.float32), device=device
        )
    if mode == "fused":
        # per train, not per iteration: the weights depend only on the
        # data and the hyperparameters
        for s in staged:
            s["wrv"] = als_accum.make_wrv(s["rat"], s["val"],
                                          p.implicit_prefs, p.alpha)
    t0 = time.perf_counter()
    for _ in range(p.num_iterations):
        U = solve(accumulate(su, V, p, mode), V, p)
        V = solve(accumulate(si, U, p, mode), U, p)
    if device.type == "cuda":
        # the train ends when the card is done with it (and a fault surfaces
        # here, inside the mode ladder); its own stream only, so a retrain
        # on a side stream does not wait for a deploy's waves
        torch.cuda.current_stream(device).synchronize()
    _record_pallas_efficiency(time.perf_counter() - t0, p, su, si, mode,
                              len(user_idx))
    return ALSState(user_factors=U[:num_users], item_factors=V[:num_items])


def iteration_least_work(su: dict, si: dict, rank: int, mode: str,
                         nnz: int) -> dict[str, float]:
    """The least work of one ALS iteration's accumulations, the yardstick
    of ``als.pallas_step``: fused, the two half-steps'
    ``als_accum_least_work`` (each over its padded stream, ``nnz`` rows of
    it real, its segments against the other side's factor rows); chunked,
    ``segment_accum_least_work`` summed over every chunk of both
    directions (the rows a chunk builds, its real rows, and the segments of
    the blocks it touches)."""
    up, ip = su["plan"], si["plan"]
    S, T = als_accum.S, als_accum.T
    total = {"bytes": 0.0, "flops": 0.0}
    if mode == "fused":
        halves = [
            als_accum.als_accum_least_work(
                up.padded_len, rank, up.n_blocks * S, ip.n_blocks * S, nnz
            ),
            als_accum.als_accum_least_work(
                ip.padded_len, rank, ip.n_blocks * S, up.n_blocks * S, nnz
            ),
        ]
    else:
        width = als_accum.row_width(rank)
        halves = []
        for plan in (up, ip):
            rows = plan.tiles_per_chunk * T
            valid = (~plan.pad_mask).reshape(plan.n_chunks, rows).sum(axis=1)
            touched = plan.visited.sum(axis=1) * S
            halves += [
                als_accum.segment_accum_least_work(
                    rows, width, int(touched[c]), int(valid[c])
                )
                for c in range(plan.n_chunks)
            ]
    for work in halves:
        total["bytes"] += work["bytes"]
        total["flops"] += work["flops"]
    return total


def _record_pallas_efficiency(wall_s: float, p: ALSParams, su: dict,
                              si: dict, mode: str, nnz: int) -> None:
    """Place the train on the live roofline as ``als.pallas_step`` (the JAX
    package's entry-point name): the least work of one iteration
    (:func:`iteration_least_work`) over the measured wall time per
    iteration."""
    from predictionio_tpu_torch.obs import device as device_obs

    if p.num_iterations <= 0:
        return
    cost = iteration_least_work(su, si, p.rank, mode, nnz)
    sig = (mode, LAST_PLAN_INFO.get("rows_user"),
           LAST_PLAN_INFO.get("rows_item"), p.rank)
    eff = device_obs.default_efficiency()
    eff.record_cost("als.pallas_step", flops=cost["flops"],
                    nbytes=cost["bytes"], signature=sig, source="least_work")
    eff.observe("als.pallas_step", wall_s / p.num_iterations, signature=sig)


def accumulate(staged: dict, other_factors: torch.Tensor, p: ALSParams,
               mode: str) -> torch.Tensor:
    """One half-step's per-segment stats ``[n_seg_pad, row_width]``: the
    normal equations of every segment of ``staged`` against
    ``other_factors``."""
    n_blocks = staged["plan"].n_blocks
    if mode == "fused":
        return als_accum.segment_stats_fused(
            staged["plan_args"], staged["oth"], staged["wrv"], other_factors,
            n_blocks, precision=p.pallas_precision,
        )
    return als_accum.segment_stats_chunked(
        staged["plan_args"], staged["oth"], staged["rat"], staged["val"],
        other_factors, p.implicit_prefs, p.alpha, n_blocks,
        precision=p.pallas_precision,
    )


def solve(acc: torch.Tensor, other_factors: torch.Tensor,
          p: ALSParams) -> torch.Tensor:
    """Factors from the stats: A | b | count columns, the implicit Gram."""
    k = p.rank
    A = acc[:, : k * k].reshape(-1, k, k)
    b = acc[:, k * k : k * k + k]
    counts = acc[:, k * k + k]
    gram = other_factors.T @ other_factors if p.implicit_prefs else None
    return _solve_factors(A, b, counts, p.reg, p.scale_reg_with_count, gram)
