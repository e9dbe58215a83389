"""Alternating least squares in PyTorch, on one device or over a mesh.

The port of the JAX package's ``ops/als.py``.  Explicit
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

**Over a mesh** (``train_als(mesh=)`` with more than one slot, and
``train_als_global``; JAX ``_half_step`` / ``_make_train_step(shard_state=
True)``): the COO stream is split over the ``data`` axis and each data
position's owner slot stages its chunk with the same ``_stage``.  Each
half-step runs kernel 1 (kernel 2 on the chunked rung) once per data
slot, on the slot's CUDA stream, giving that slot's partial
``[n_seg_pad, width]`` stats; the partials are summed in slot order on the
merge device (the JAX ``psum``: no float atomics, so a mesh train repeats
bit for bit) and, across ranks, by ``dist.all_reduce(SUM)``; each slot
solves only its own row slice, and the factor state stays row-sharded
between iterations, the opposite table gathered for each half-step
(``torch.cat`` in one process, ``dist.all_gather`` across ranks).  Slots
along ``model`` hold copies.  The train goes on the roofline as
``als.train_step`` (the least work of every local slot's kernels and of
the solve), meters ``als.factors`` per slot, and with
``PIO_TRAIN_STEP_TIMELINE`` set and a trace id bound records one
``als.train_step[i]`` fragment per iteration, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
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
    #: port's accumulators tile the stream themselves, and only
    #: ``train_als_global``'s length check reads it
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
    mesh=None,
) -> ALSState:
    """Train ALS factors from COO ratings on ``device`` (``None`` means
    CUDA, and raises without a card unless ``device="cpu"``).

    ``init_factors`` warm-starts the solve: ``(U0, V0)`` host arrays of
    shape ``[num_users, rank]`` / ``[num_items, rank]``, aligned to the
    caller's vocabularies, replace the random init.  Factors, ratings and
    the accumulators are float32.

    ``mesh`` (a ``parallel.mesh.Mesh`` with a ``data`` axis) of more than
    one slot trains over its slots, which then name the devices
    (``device`` is not read); in a multi-process mesh every rank passes
    the identical full COO and stages only its own slots' rows.  A mesh of
    one slot, or None, trains on ``device``.  The factors come back on the
    merge device."""
    p = _check_params(params)
    user_idx = np.asarray(user_idx)
    item_idx = np.asarray(item_idx)
    rating = np.asarray(rating)
    _check_inputs(user_idx, item_idx, rating, num_users, num_items, p,
                  init_factors)
    if mesh is not None and mesh.devices.size > 1:
        n_data, _, mine = _mesh_layout(mesh)
        step = -(-len(user_idx) // n_data)
        chunks = {
            pos: tuple(a[pos * step:(pos + 1) * step]
                       for a in (user_idx, item_idx, rating))
            for pos in mine
        }
        return _train_mesh(chunks, num_users, num_items, p, mesh, init_factors)
    dev = resolve_device(device)
    return _train(user_idx, item_idx, rating, num_users, num_items, p, dev,
                  init_factors)


def _check_params(params: ALSParams | None) -> ALSParams:
    p = params or ALSParams()
    if not 1 <= p.rank <= 32:
        raise ValueError(f"train_als: rank {p.rank} outside 1..32")
    if p.pallas_mode not in ("auto", "fused", "chunked"):
        raise ValueError(f"unknown pallas_mode {p.pallas_mode!r}")
    if p.pallas_precision not in als_accum.PRECISIONS:
        raise ValueError(f"unknown pallas_precision {p.pallas_precision!r}")
    return p


def _check_inputs(user_idx, item_idx, rating, num_users, num_items,
                  p: ALSParams, init_factors) -> None:
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
    mode = _auto_mode(p, {device: len(user_idx)})
    return _run_ladder(
        mode,
        lambda m: _train_mode(user_idx, item_idx, rating, num_users,
                              num_items, p, device, m, init_factors),
        [device],
    )


def _auto_mode(p: ALSParams, rows_by_device: dict) -> str:
    """``p.pallas_mode``, where ``"auto"`` is fused unless the fused
    streams staged on some card would take more than half its free
    memory."""
    if p.pallas_mode != "auto":
        return p.pallas_mode
    for device, rows in rows_by_device.items():
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            est_rows = int(rows * 1.06) + als_accum.T
            # the fused rung's 7 four-byte values per row, both directions
            if 2 * est_rows * 4 * 7 > free // 2:
                return "chunked"
    return "fused"


def _run_ladder(mode: str, attempt, devices, retry: bool = True) -> ALSState:
    """``attempt(mode)``, and on device-memory exhaustion of the fused
    rung (only then, and only with ``retry``) ``attempt("chunked")``."""
    ladder = [mode] + (["chunked"] if mode == "fused" and retry else [])
    for i, m in enumerate(ladder):
        try:
            return attempt(m)
        except Exception as e:
            if not _is_oom_error(e) or i == len(ladder) - 1:
                raise
            warnings.warn(
                f"ALS {m} accumulation ran out of device memory "
                f"({type(e).__name__}); retrying as {ladder[i + 1]}",
                RuntimeWarning,
                stacklevel=3,
            )
        # out of the handler, the failed attempt's frames and the tensors
        # they held are gone: drop its staged streams and return the memory
        _STAGE_CACHE.clear()
        if any(d.type == "cuda" for d in devices):
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
    # an empty stream (a mesh slot that holds no rows) is all padding,
    # whose slots index row 0 and are zeroed below
    oth = np.asarray(oth, np.int32) if len(oth) else np.zeros(1, np.int32)
    rating = np.asarray(rating, np.float32) if len(rating) else np.zeros(1, np.float32)
    oth_p = oth[plan.dest_perm]
    rat_p = rating[plan.dest_perm]
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


# -- over a mesh -------------------------------------------------------------


def solve_least_work(rows: int, k: int) -> dict[str, float]:
    """The least work of solving ``rows`` k x k systems from their stats:
    each row's ``A | b | count`` columns read once and its ``k`` factors
    written once; per row a Cholesky factorization (``k^3 / 3``
    multiply-adds), the two triangular solves (``k^2``) and the ridge on
    the diagonal (``k``)."""
    return {
        "bytes": 4.0 * rows * (k * k + 2 * k + 1),
        "flops": float(rows) * (2 * k ** 3 / 3 + 2 * k * k + k),
    }


def _mesh_layout(mesh) -> tuple[int, list[int], list[int]]:
    """(size of the ``data`` axis, the owner slot of each data position,
    the positions this process computes).  A position's owner is the first
    slot holding it; slots along ``model`` hold copies."""
    if "data" not in mesh.shape:
        raise ValueError(f"train_als: the mesh has no 'data' axis: {mesh.shape}")
    n_data = int(mesh.shape["data"])
    owners = mesh.owners("data")
    local = set(mesh.local_slots)
    mine = [pos for pos, slot in enumerate(owners) if slot in local]
    if mesh.is_multiprocess:
        per_rank = {r: 0 for r in set(mesh.process_ids)}
        for slot in owners:
            per_rank[mesh.process_ids[slot]] += 1
        if len(set(per_rank.values())) != 1:
            raise ValueError(
                "train_als: every rank must own as many 'data' positions as "
                f"the others, got {per_rank}"
            )
    return n_data, owners, mine


class _PhaseClock:
    """Milliseconds per phase of a mesh train: CUDA events on the merge
    device's current stream, read once at the train's end (so a phase
    that spans the slots' streams reads from its start to the merge's wait
    on them), or the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: list = []
        self.host: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            yield
            self.host[name] = self.host.get(name, 0.0) + 1e3 * (
                time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self.device))
        yield
        end.record(torch.cuda.current_stream(self.device))
        self.events.append((name, start, end))

    def ms(self) -> dict[str, float]:
        out = dict(self.host)
        for name, start, end in self.events:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def _tensors(tree):
    """The tensors of a result: a tensor, or lists, tuples and dicts of
    them (anything else holds none)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _on_slots(mesh, work: dict, owners: list, uses) -> dict:
    """``{pos: fn()}`` for ``work = {pos: fn}``, each on its owner slot: a
    CUDA slot's work on the slot's stream after everything queued so far
    on its device's current stream, the current streams then waiting on
    every slot (``uses(pos)`` names the tensors of the current stream that
    the slot reads; the results, tensors or lists, tuples and dicts of
    them, cross the other way).  On the CPU, one after another."""
    out, streams = {}, {}
    for pos, fn in work.items():
        slot = owners[pos]
        dev = mesh.slots[slot]
        if dev.type != "cuda":
            out[pos] = fn()
            continue
        stream = mesh.stream(slot)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out[pos] = fn()
        for t in _tensors(uses(pos)):
            t.record_stream(stream)
        streams[slot] = (stream, dev)
    for stream, dev in streams.values():
        torch.cuda.current_stream(dev).wait_stream(stream)
    for pos, result in out.items():
        dev = mesh.slots[owners[pos]]
        if dev.type == "cuda":
            for t in _tensors(result):
                t.record_stream(torch.cuda.current_stream(t.device))
    return out


def _gather_table(mesh, parts: dict, n_data: int, owners: list) -> dict:
    """The whole table from the row slices (``parts``: this process's
    positions), on every local device: ``torch.cat`` in position order in
    one process, ``dist.all_gather`` of each rank's slices across ranks."""
    from predictionio_tpu_torch.parallel.mesh import all_gather_tensors

    merge = mesh.merge_device
    if mesh.is_multiprocess:
        mine = sorted(parts)
        every = all_gather_tensors(torch.cat([parts[pos].to(merge) for pos in mine]))
        by_pos = {}
        for rank, block in enumerate(every):
            held = [pos for pos in range(n_data)
                    if mesh.process_ids[owners[pos]] == rank]
            for pos, piece in zip(held, block.chunk(len(held))):
                by_pos[pos] = piece
        full = torch.cat([by_pos[pos] for pos in range(n_data)])
    else:
        full = torch.cat([parts[pos].to(merge) for pos in range(n_data)])
    return {dev: full if dev == merge else full.to(dev)
            for dev in mesh.physical_devices}


def _together(mesh, fn, what: str = "train_als"):
    """``fn()``, this rank's part of a step of ``what``.  In a multi-process mesh every
    rank then learns whether any rank's part raised (after its queued
    device work ran, so that a failed launch counts), and if one did,
    every rank raises: the one that failed its own error, its peers a
    ``RuntimeError`` naming it.  No rank is left waiting in a collective
    that a peer never reaches, and none retries alone."""
    from predictionio_tpu_torch.parallel.mesh import failed_ranks

    if not mesh.is_multiprocess:
        return fn()
    try:
        out = fn()
        for dev in mesh.physical_devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
    except Exception:
        failed_ranks(True)
        raise
    failed = failed_ranks(False)
    if failed:
        raise RuntimeError(
            f"{what}: rank(s) {failed} failed their part of the step; "
            f"rank {mesh.process_index} stops with them"
        )
    return out


def _mesh_half_step(mesh, staged: dict, tables: dict, p: ALSParams, mode: str,
                    n_seg_pad: int, owners: list, clock: _PhaseClock) -> dict:
    """One half-step over the mesh: each data slot's partial stats
    (:func:`accumulate`, kernel 1 or 2 on the slot's stream), their sum in
    slot order on the merge device (then ``all_reduce`` across ranks), and
    each slot's solve of its own row slice.  ``staged`` and the result map
    data position -> that slot's streams / factor slice; ``tables`` holds
    the opposite table on each local device."""
    from predictionio_tpu_torch.parallel.mesh import all_reduce_sum

    n_data = len(owners)
    merge = mesh.merge_device

    def dev_of(pos):
        return mesh.slots[owners[pos]]

    def stats():
        with clock("accumulate"):
            partials = _on_slots(
                mesh,
                {pos: (lambda pos=pos: accumulate(
                    staged[pos], tables[dev_of(pos)], p, mode))
                 for pos in sorted(staged)},
                owners,
                lambda pos: (tables[dev_of(pos)],),
            )
        with clock("sum"):
            total = None
            for pos in sorted(partials):
                part = partials[pos].to(merge)
                total = part if total is None else total.add_(part)
        return total

    total = _together(mesh, stats)
    if mesh.is_multiprocess:
        with clock("collective"):
            all_reduce_sum(total)
    rows = n_seg_pad // n_data

    def solves():
        with clock("solve"):
            return _on_slots(
                mesh,
                {pos: (lambda pos=pos: solve(
                    total[pos * rows:(pos + 1) * rows].to(dev_of(pos)),
                    tables[dev_of(pos)], p))
                 for pos in sorted(staged)},
                owners,
                lambda pos: (total, tables[dev_of(pos)]),
            )

    return _together(mesh, solves)


def _train_mesh(chunks: dict, num_users: int, num_items: int, p: ALSParams,
                mesh, init_factors=None) -> ALSState:
    """The mesh path; ``chunks`` maps each data position this process
    computes to its ``(user_idx, item_idx, rating)`` rows.  In one process
    it has the single-device path's mode ladder.  Across processes the
    ranks first agree on one mode (:func:`_agree_mode`), and the ladder
    does not retry: a rank that runs out of device memory raises, and its
    peers with it (:func:`_together`)."""
    _, owners, _ = _mesh_layout(mesh)
    rows: dict = {}
    for pos, chunk in chunks.items():
        dev = mesh.slots[owners[pos]]
        rows[dev] = rows.get(dev, 0) + len(chunk[0])
    mode = _auto_mode(p, rows)
    if mesh.is_multiprocess:
        mode = _agree_mode(p, mode)
    return _run_ladder(
        mode,
        lambda m: _train_mesh_mode(chunks, num_users, num_items, p, mesh, m,
                                   init_factors),
        mesh.physical_devices,
        retry=not mesh.is_multiprocess,
    )


def _agree_mode(p: ALSParams, mode: str) -> str:
    """The one accumulation mode of a multi-process train, the same on
    every rank: the ranks must ask for the same ``pallas_mode`` (else
    every rank raises ``ValueError`` alike), and under ``"auto"`` the
    chunked rung is taken if any rank's card would take it."""
    from predictionio_tpu_torch.parallel.mesh import all_gather_objects

    every = all_gather_objects((p.pallas_mode, mode))
    asked = [a for a, _ in every]
    if len(set(asked)) > 1:
        raise ValueError(
            f"train_als: the ranks ask for pallas_mode {asked}; every rank "
            "must pass the same params"
        )
    return "chunked" if any(m == "chunked" for _, m in every) else "fused"


def _train_mesh_mode(chunks: dict, num_users: int, num_items: int,
                     p: ALSParams, mesh, mode: str,
                     init_factors=None) -> ALSState:
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.obs.disttrace import record_fragment
    from predictionio_tpu_torch.obs.logging import get_trace_id
    from predictionio_tpu_torch.parallel.mesh import (
        collective_backend,
        meter_shards,
    )
    from predictionio_tpu_torch.parallel.placement import ShardedTensor

    n_data, owners, mine = _mesh_layout(mesh)
    # every slot's slice of the stats is whole 128-row blocks' worth of
    # equal size
    lane = math.lcm(als_accum.S, n_data)
    nu_pad = max(-(-num_users // lane) * lane, lane)
    ni_pad = max(-(-num_items // lane) * lane, lane)
    tpc = als_accum.chunk_tiles(als_accum.row_width(p.rank))
    devs = {pos: mesh.slots[owners[pos]] for pos in mine}
    cache_key = (
        "mesh", _data_fingerprint(*[a for pos in mine for a in chunks[pos]]),
        tuple(mine), n_data, nu_pad, ni_pad, mode,
        tpc if mode == "chunked" else None,
        tuple(str(devs[pos]) for pos in mine),
    )
    ru, ri = nu_pad // n_data, ni_pad // n_data

    def stage_and_place():
        staged = _STAGE_CACHE.get(cache_key)
        if staged is None:
            _STAGE_CACHE.clear()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(min(8, 2 * len(mine))) as pool:
                futures = {
                    pos: (
                        pool.submit(_stage, u, i, r, nu_pad, mode, devs[pos], tpc),
                        pool.submit(_stage, i, u, r, ni_pad, mode, devs[pos], tpc),
                    )
                    for pos, (u, i, r) in ((pos, chunks[pos]) for pos in mine)
                }
                staged = {pos: (fu.result(), fi.result())
                          for pos, (fu, fi) in futures.items()}
            LAST_PLAN_INFO["stage_s"] = time.perf_counter() - t0
            _STAGE_CACHE[cache_key] = staged
        U0, V0 = _init_factors(p, nu_pad, ni_pad, num_users, num_items, "cpu")
        if init_factors is not None:
            U0[:num_users] = torch.as_tensor(np.asarray(init_factors[0], np.float32))
            V0[:num_items] = torch.as_tensor(np.asarray(init_factors[1], np.float32))
        U = {pos: U0[pos * ru:(pos + 1) * ru].to(devs[pos]) for pos in mine}
        V = {pos: V0[pos * ri:(pos + 1) * ri].to(devs[pos]) for pos in mine}
        if mode == "fused":
            for pos in mine:
                for s in staged[pos]:
                    s["wrv"] = als_accum.make_wrv(s["rat"], s["val"],
                                                  p.implicit_prefs, p.alpha)
        return staged, U, V

    staged, U, V = _together(mesh, stage_and_place)
    su = {pos: staged[pos][0] for pos in mine}
    si = {pos: staged[pos][1] for pos in mine}

    def padded_rows(s):
        plan = s["plan"]
        if mode == "fused":
            return plan.padded_len
        return plan.n_chunks * plan.tiles_per_chunk * als_accum.T

    nnz = sum(len(chunks[pos][0]) for pos in mine)
    LAST_PLAN_INFO.update(
        tiles_per_chunk=su[mine[0]]["plan"].tiles_per_chunk
        if mode == "chunked" else None,
        rank=p.rank,
        width=als_accum.row_width(p.rank),
        rows_user=sum(padded_rows(s) for s in su.values()),
        rows_item=sum(padded_rows(s) for s in si.values()),
        blocks_user=nu_pad // als_accum.S,
        blocks_item=ni_pad // als_accum.S,
        chunks_user=sum(s["plan"].n_chunks if mode == "chunked" else 1
                        for s in su.values()),
        chunks_item=sum(s["plan"].n_chunks if mode == "chunked" else 1
                        for s in si.values()),
        nnz=nnz,
        precision=p.pallas_precision,
        mode=mode,
        device=str(mesh.merge_device),
        mesh=dict(mesh.shape),
        data_slots=n_data,
        local_positions=list(mine),
        collective_backend=collective_backend() or "in-process",
    )

    merge = mesh.merge_device
    clock = _PhaseClock(merge)
    n_dev = int(mesh.devices.size)
    emit_steps = (
        bool(os.environ.get("PIO_TRAIN_STEP_TIMELINE"))
        and get_trace_id() is not None
    )

    def sync():
        for dev in mesh.physical_devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    t0 = time.perf_counter()
    for it in range(p.num_iterations):
        t_step = time.time()
        with clock("gather"):
            Vt = _gather_table(mesh, V, n_data, owners)
        U = _mesh_half_step(mesh, su, Vt, p, mode, nu_pad, owners, clock)
        with clock("gather"):
            Ut = _gather_table(mesh, U, n_data, owners)
        V = _mesh_half_step(mesh, si, Ut, p, mode, ni_pad, owners, clock)
        if emit_steps:
            sync()
            record_fragment(
                f"als.train_step[{it}]",
                t_step,
                time.time() - t_step,
                track=f"train:{n_dev}dev",
                tags={"iteration": it, "devices": n_dev},
            )
    Uf = _gather_table(mesh, U, n_data, owners)[merge]
    Vf = _gather_table(mesh, V, n_data, owners)[merge]
    sync()
    wall_s = time.perf_counter() - t0
    LAST_PLAN_INFO["mesh_ms"] = clock.ms()
    LAST_PLAN_INFO["iterations_s"] = wall_s

    if p.num_iterations > 0:
        cost = {"bytes": 0.0, "flops": 0.0}
        for pos in mine:
            work = iteration_least_work(su[pos], si[pos], p.rank, mode,
                                        len(chunks[pos][0]))
            for key in cost:
                cost[key] += work[key]
        for n_rows in (ru * len(mine), ri * len(mine)):
            work = solve_least_work(n_rows, p.rank)
            for key in cost:
                cost[key] += work[key]
        sig = ("mesh", mode, n_data, LAST_PLAN_INFO["rows_user"],
               LAST_PLAN_INFO["rows_item"], p.rank)
        eff = device_obs.default_efficiency()
        eff.record_cost("als.train_step", flops=cost["flops"],
                        nbytes=cost["bytes"], signature=sig,
                        source="least_work")
        eff.observe("als.train_step", wall_s / p.num_iterations, signature=sig)

    # the live per-slot parts: each local slot's slice of the row-sharded
    # state (slots along ``model`` share their position's)
    positions = mesh.positions("data")

    def placed(parts, full, rows_per):
        locals_: list = [None] * len(mesh.slots)
        for slot in mesh.local_slots:
            pos = positions[slot]
            locals_[slot] = parts[pos] if pos in parts else (
                full[pos * rows_per:(pos + 1) * rows_per])
        return ShardedTensor(mesh, "data", locals_, tuple(full.shape))

    meter_shards("als.factors", (placed(U, Uf, ru), placed(V, Vf, ri)),
                 seconds=wall_s)
    return ALSState(user_factors=Uf[:num_users], item_factors=Vf[:num_items])


def train_als_global(
    user_idx,
    item_idx,
    rating,
    valid,
    num_users: int,
    num_items: int,
    mesh,
    params: ALSParams | None = None,
) -> ALSState:
    """The multi-process entry point: the COO inputs are global arrays
    sharded along the mesh's ``data`` axis (``parallel.mesh.
    global_data_array`` after ``balance_local_chunks``), each rank holding
    only the rows it read plus the ``valid`` mask zeroing its padding.
    Every rank calls this with its own parts (``ShardedTensor``s); the
    factors come back as host numpy, identical on every rank."""
    p = _check_params(params)
    arrays = (user_idx, item_idx, rating, valid)
    n_dev = mesh.devices.size
    if arrays[0].shape[0] % (n_dev * p.chunk_size) != 0:
        raise ValueError(
            f"global COO length {arrays[0].shape[0]} must be a multiple of "
            f"n_devices * chunk_size = {n_dev} * {p.chunk_size}"
        )
    _, owners, mine = _mesh_layout(mesh)

    def local_rows():
        chunks = {}
        for pos in mine:
            u, i, r, v = (a.locals[owners[pos]].cpu().numpy() for a in arrays)
            keep = v > 0
            chunks[pos] = (u[keep], i[keep], r[keep])
            _check_inputs(*chunks[pos], num_users, num_items, p, None)
        return chunks

    # a rank whose rows fail the checks stops its peers with it
    chunks = _together(mesh, local_rows)
    state = _train_mesh(chunks, num_users, num_items, p, mesh)
    return ALSState(user_factors=state.user_factors.cpu().numpy(),
                    item_factors=state.item_factors.cpu().numpy())
