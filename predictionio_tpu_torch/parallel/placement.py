"""Shard placement: the declarative layout serving consumes.

The port of the JAX package's ``parallel/placement.py``, single-process
and multi-device.  ``parallel/mesh.py`` answers "what slots do I have";
this module answers "where does each ARRAY live", as data:

- :class:`ShardPlan` is a serializable description of a model's placement:
  mesh axes plus a partition tuple per named array.  It rides inside the
  persisted model and the lifecycle generation manifest (the same JSON as
  the JAX package's), and ``deploy`` re-binds it onto the slots the serving
  host has (``rebind`` re-shards on a count mismatch).
- :func:`shard_put` pads a table's rows and splits it into one tensor per
  slot, each on its slot's device (a :class:`ShardedTensor`);
  :func:`replicate` keeps one copy per distinct physical device;
  :func:`gather_rows` puts looked-up rows on the merge device (slot 0's).
- :func:`build_sharded_topk` is the factor-sharded top-k: each slot scores
  a query batch against only the catalog rows it owns and keeps its k best
  (on a card, each slot on its own CUDA stream, through the fused top-k
  kernel of ``ops/topk.py``), then the ``S x k`` winners are gathered onto
  the merge device in shard-major order and merged by a stable descending
  sort, so equal scores resolve to the lowest global row id, as an
  unsharded top-k does (JAX: a ``shard_map`` with an ``all_gather`` of the
  winners and ``lax.top_k``).
- :func:`settle_shards` is the per-slot settle clock the straggler board
  reads, and :func:`run_observed_wave` one instrumented sharded wave.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    make_mesh,
    pad_to_multiple,
    shard_attribution,
    visible_devices,
)

#: ShardPlan wire-format version (rides inside model blobs and generation
#: manifests; bump on incompatible layout changes)
PLAN_SCHEMA_VERSION = 1

#: the most recent sharded top-k's PER-SHARD shapes, keyed by kernel name:
#: the test hook proving no slot scores a full catalog row (``rows_local``
#: below the catalog size) and saying whether the local step was fused
LAST_KERNEL_SHAPES: dict[str, dict[str, int]] = {}


class ShardPlanError(ValueError):
    """A plan cannot be applied (unknown array, bad axes, no such axis)."""


@dataclass(frozen=True)
class ShardPlan:
    """Declarative per-array placement over a named mesh.

    ``axes`` maps mesh axis name -> size; -1 means "all slots available at
    bind time" (training records the layout, deploy decides the width).
    ``specs`` maps array name -> a partition tuple with one entry per
    dimension: an axis name shards that dimension, ``None`` leaves it whole.
    Arrays not named in ``specs`` are replicated.  ``rows`` records each
    array's REAL leading row count (before padding)."""

    axes: dict[str, int] = field(default_factory=lambda: {"model": -1})
    specs: dict[str, tuple] = field(default_factory=dict)
    rows: dict[str, int] = field(default_factory=dict)

    # -- serialization (model blob + generation manifest) --------------------

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": PLAN_SCHEMA_VERSION,
            "axes": dict(self.axes),
            "specs": {k: list(v) for k, v in self.specs.items()},
            "rows": dict(self.rows),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "ShardPlan | None":
        if not d:
            return None
        return cls(
            axes=dict(d.get("axes") or {"model": -1}),
            specs={k: tuple(v) for k, v in (d.get("specs") or {}).items()},
            rows=dict(d.get("rows") or {}),
        )

    @classmethod
    def model_parallel(
        cls,
        sharded: Sequence[str],
        rows: Mapping[str, int] | None = None,
        axis: str = "model",
        ndims: Mapping[str, int] | None = None,
    ) -> "ShardPlan":
        """The standard embedding-table plan: each named table row-sharded
        over ``axis`` (2-D ``(axis, None)`` unless ``ndims`` says 1-D, e.g.
        a per-item bias vector); everything else replicated."""
        specs = {}
        for name in sharded:
            nd = (ndims or {}).get(name, 2)
            specs[name] = (axis,) + (None,) * (nd - 1)
        return cls(axes={axis: -1}, specs=specs, rows=dict(rows or {}))

    # -- binding -------------------------------------------------------------

    def rebind(self, n_devices: int) -> "ShardPlan":
        """Re-shard the plan for ``n_devices`` slots: axis names are kept,
        sizes re-solved.  A single -1 axis absorbs all slots; fixed axes
        whose product no longer matches collapse onto the FIRST axis that
        appears in a spec (the sharding axis)."""
        n_devices = max(int(n_devices), 1)
        sizes = dict(self.axes) or {"model": -1}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ShardPlanError("at most one plan axis may be -1")
        fixed = int(np.prod([v for v in sizes.values() if v != -1] or [1]))
        if wild and n_devices % fixed == 0:
            sizes[wild[0]] = n_devices // fixed
        elif int(np.prod(list(sizes.values()))) != n_devices:
            shard_axis = next(
                (e for spec in self.specs.values() for e in spec if e),
                next(iter(sizes)),
            )
            sizes = {k: 1 for k in sizes}
            sizes[shard_axis] = n_devices
        return ShardPlan(axes=sizes, specs=dict(self.specs), rows=dict(self.rows))

    def mesh(self, devices: Sequence[Any] | None = None) -> Mesh:
        """The mesh this plan describes over the given (default: every
        visible CUDA device) slots, sizes re-solved for their count."""
        devices = list(devices if devices is not None else visible_devices())
        plan = self.rebind(len(devices))
        return make_mesh(MeshConfig(axes=dict(plan.axes)), devices=devices)

    def spec(self, name: str) -> tuple:
        return tuple(self.specs.get(name, ()))

    def shard_multiple(self, mesh: Mesh, name: str) -> int:
        """Leading-dim divisibility requirement for ``name`` on ``mesh``."""
        entries = self.specs.get(name, ())
        if not entries or entries[0] is None:
            return 1
        axis = entries[0]
        if axis not in mesh.shape:
            raise ShardPlanError(
                f"plan shards {name!r} over axis {axis!r} but the mesh has "
                f"axes {dict(mesh.shape)}"
            )
        return int(mesh.shape[axis])


# ---------------------------------------------------------------------------
# placed arrays


class ShardedTensor:
    """One array placed over a mesh: ``locals[i]`` is what slot ``i`` holds
    (its block of rows when ``axis`` names the sharding axis, the whole
    array when ``axis`` is None), ``shape`` the padded global shape.  Slots
    on one physical device that hold the same block share one tensor; in a
    multi-process mesh another rank's slots hold None.  ``slot_marks``
    says when each slot's part was ready (see :func:`settle_shards`)."""

    def __init__(self, mesh: Mesh, axis: str | None, locals_: list,
                 shape: tuple, slot_marks: dict[str, Any] | None = None):
        self.mesh = mesh
        self.axis = axis
        self.locals = locals_
        self.shape = tuple(shape)
        self.slot_marks = slot_marks or {}

    def slot_shards(self) -> list[tuple[str, torch.Tensor]]:
        return [(label, t) for label, t in zip(self.mesh.labels, self.locals)
                if t is not None]


def _mark(device: torch.device) -> Any:
    """A slot's readiness mark: a CUDA event recorded now on the device's
    current stream, or, for a host slot whose work is already done, the
    host clock's stamp of now."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def _host_array(array: Any) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def shard_put(
    mesh: Mesh, plan: ShardPlan, name: str, array: Any
) -> tuple[ShardedTensor, int]:
    """Pad + place one named array per the plan; returns ``(placed,
    real_rows)``.  Leading-dim sharding pads rows to the axis size so every
    slot owns an equal block (padding is masked downstream: the sharded
    top-k never surfaces rows past ``real_rows``)."""
    spec = plan.spec(name)
    if any(e is not None for e in spec[1:]):
        raise ShardPlanError(
            f"plan shards {name!r} as {spec}: the port shards the leading "
            "dimension only"
        )
    arr = _host_array(array)
    mult = plan.shard_multiple(mesh, name)
    padded, n = pad_to_multiple(arr, mult, axis=0)
    host = torch.from_numpy(np.array(padded, order="C"))
    axis = spec[0] if spec else None
    if axis is None:
        return replicate(mesh, host), n
    rows_local = host.shape[0] // mult
    positions = mesh.positions(axis)
    placed: dict[tuple, torch.Tensor] = {}
    locals_, marks = [], {}
    for slot, dev in enumerate(mesh.slots):
        key = (dev, positions[slot])
        if key not in placed:
            block = host[positions[slot] * rows_local:(positions[slot] + 1) * rows_local]
            placed[key] = block.to(dev, copy=True)
        locals_.append(placed[key])
        marks[mesh.labels[slot]] = _mark(dev)
    return ShardedTensor(mesh, axis, locals_, host.shape, marks), n


def replicate(mesh: Mesh, array: Any) -> ShardedTensor:
    """Place an array whole for every slot of the mesh: one copy per
    distinct physical device, shared by that device's slots."""
    host = torch.as_tensor(np.array(_host_array(array)))
    copies: dict[torch.device, torch.Tensor] = {}
    locals_, marks = [], {}
    for slot, dev in enumerate(mesh.slots):
        if dev not in copies:
            copies[dev] = host.to(dev, copy=True)
        locals_.append(copies[dev])
        marks[mesh.labels[slot]] = _mark(dev)
    return ShardedTensor(mesh, None, locals_, host.shape, marks)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_put_tree(
    mesh: Mesh, plan: ShardPlan, tree: Mapping[str, Any]
) -> tuple[dict[str, Any], dict[str, int]]:
    """Place a flat name->array mapping: arrays named in the plan shard
    (real rows recorded), everything else replicates leaf by leaf (lists of
    MLP layer dicts recurse; non-array leaves pass through)."""
    out: dict[str, Any] = {}
    rows: dict[str, int] = {}
    for name, value in tree.items():
        if name in plan.specs:
            out[name], rows[name] = shard_put(mesh, plan, name, value)
        else:
            out[name] = _tree_map(
                lambda x: replicate(mesh, x)
                if hasattr(x, "shape") or isinstance(x, (int, float))
                else x,
                value,
            )
    return out, rows


def _local(value: Any, slot: int) -> Any:
    """What slot ``slot`` computes with: its part of a placed array, the
    same walk through containers, any other value as it is."""
    if isinstance(value, ShardedTensor):
        return value.locals[slot]
    if isinstance(value, Mapping):
        return {k: _local(v, slot) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_local(v, slot) for v in value)
    return value


def gather_rows(mesh: Mesh, table: ShardedTensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` rows on the merge device from a (row-sharded) table:
    each slot looks up the ids it owns, and the merge device keeps each
    row from its owner (the model-parallel embedding lookup)."""
    merge = mesh.merge_device
    idx = idx.to(torch.int64)
    if table.axis is None:
        return table.locals[0].index_select(0, idx.to(table.locals[0].device)).to(merge)
    out = None
    for pos, slot in enumerate(mesh.owners(table.axis)):
        local = table.locals[slot]
        n_local = local.shape[0]
        rel = idx.to(local.device) - pos * n_local
        rows = local.index_select(0, rel.clamp(0, n_local - 1)).to(merge)
        if out is None:
            out = rows
        else:
            own = ((rel >= 0) & (rel < n_local)).to(merge)
            out = torch.where(own[:, None], rows, out)
    return out


# ---------------------------------------------------------------------------
# the factor-sharded top-k


@dataclass
class ShardedResult:
    """A sharded computation's merged output on the merge device, with each
    slot's readiness mark (:func:`settle_shards`)."""

    packed: torch.Tensor
    slot_marks: dict[str, Any]


def build_sharded_topk(
    mesh: Mesh,
    local_scores_fn: Callable[..., torch.Tensor] | None,
    n_items: int,
    k: int,
    axis: str = "model",
    name: str = "sharded_topk",
    local_topk_fn: Callable[..., tuple] | None = None,
) -> Callable[..., ShardedResult]:
    """A factor-sharded top-k: ``fn(params..., queries) -> ShardedResult``
    whose ``packed`` is the ``[2, B, k]`` float32 (row 0 scores, row 1
    global row ids, exact below 2^24) on the merge device.

    ``local_scores_fn(*local_params, queries)`` returns ``[B, rows_local]``
    scores for the rows one slot owns.  Per slot:

    1. rows past the real catalog (``n_items``) are masked to -inf;
    2. the slot's top ``min(k, rows_local)`` by a stable descending sort,
       offset to global ids, padded to ``k`` with -inf when the slot owns
       fewer than ``k`` rows;

    then the ``S x k`` winners gather onto the merge device in shard-major
    order and merge by a stable descending sort: equal scores keep the
    lowest position, i.e. the lowest global row id (``torch.topk`` promises
    no tie order and is not used).

    ``local_topk_fn(*local_params, queries, kc, limit)``, when given,
    replaces steps 1-2 with a FUSED local top-k that returns ``(values,
    local_ids)`` and masks local rows at or past ``limit`` (the catalog
    tail on the last shard), so no slot holds even its local score block.

    On a card each slot runs on its own CUDA stream (queries and results
    cross streams under ``record_stream``, the merge waits on each slot's
    event); on the CPU the slots run one after another.  Each parameter is
    placed already (:func:`shard_put`, :func:`replicate`, or a container
    of them): a slot computes with the part it holds, so the JAX
    signature's plan and parameter names have no counterpart here."""
    n_shards = int(mesh.shape[axis])
    owners = mesh.owners(axis)
    positions = mesh.positions(axis)

    def local_topk(local: list, q: torch.Tensor, pos: int):
        rows_local = int(local[0].shape[0])
        base = pos * rows_local
        kc = min(k, rows_local)
        if local_topk_fn is not None:
            limit = min(max(n_items - base, 0), rows_local)
            v, li = local_topk_fn(*local, q, kc, limit)
            gi = li.to(torch.int64) + base
            fused = 1
        else:
            # + 0.0: every -0 a +0, as the fused kernel's sums start at +0
            scores = local_scores_fn(*local, q) + 0.0
            rows_local = int(scores.shape[-1])
            kc = min(k, rows_local)
            gidx = base + torch.arange(rows_local, device=scores.device)
            scores = torch.where(
                gidx[None, :] < n_items, scores,
                torch.full_like(scores, float("-inf")),
            )
            vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
            v, gi = vals[:, :kc], idx[:, :kc] + base
            fused = 0
        if kc < k:  # a shard owns fewer rows than k: pad its candidates
            v = torch.nn.functional.pad(v, (0, k - kc), value=float("-inf"))
            gi = torch.nn.functional.pad(gi, (0, k - kc), value=0)
        return v, gi, {"rows_local": rows_local, "fused": fused}

    def run(*args) -> ShardedResult:
        *params, queries = args
        merge = mesh.merge_device
        merge_stream = (
            torch.cuda.current_stream(merge) if merge.type == "cuda" else None
        )
        parts = []
        shapes: dict[str, int] = {}
        for pos, slot in enumerate(owners):
            dev = mesh.slots[slot]
            local = [_local(p, slot) for p in params]
            if dev.type == "cuda":
                stream = mesh.stream(slot)
                stream.wait_stream(merge_stream)
                with torch.cuda.stream(stream):
                    q = queries.to(dev, non_blocking=True)
                    if q is queries:
                        queries.record_stream(stream)
                    v, gi, shapes = local_topk(local, q, pos)
                    mark = _mark(dev)
            else:
                v, gi, shapes = local_topk(local, queries.to(dev), pos)
                mark = _mark(dev)
            parts.append((v, gi, mark))
        vs, gis = [], []
        for v, gi, mark in parts:
            if merge_stream is not None and v.device.type == "cuda":
                merge_stream.wait_event(mark)
                v.record_stream(merge_stream)
                gi.record_stream(merge_stream)
            vs.append(v.to(merge))
            gis.append(gi.to(merge))
        # fan-in: only the k winners of each shard, shard-major
        allv, alli = torch.cat(vs, dim=1), torch.cat(gis, dim=1)
        mv, mpos = torch.sort(allv, dim=1, descending=True, stable=True)
        mi = torch.gather(alli, 1, mpos[:, :k])
        packed = torch.stack([mv[:, :k], mi.to(torch.float32)])
        LAST_KERNEL_SHAPES[name] = {
            "rows_local": shapes["rows_local"],
            "batch": int(queries.shape[0]),
            "k": int(k),
            "n_shards": n_shards,
            "n_items": int(n_items),
            "fused": shapes["fused"],
        }
        marks = {
            label: parts[positions[slot]][2]
            for slot, label in enumerate(mesh.labels)
        }
        return ShardedResult(packed, marks)

    return run


# ---------------------------------------------------------------------------
# one sharded wave, fully instrumented


#: settle-poll cadence (per-slot resolution ~200 µs) and the wait after
#: which the settle clock stops attributing and charges the stragglers
_SETTLE_POLL_S = 0.0002
_SETTLE_MAX_WAIT_S = 30.0


def settle_shards(result: Any, t0: float) -> dict[str, float]:
    """Per-slot **settle clock** of one sharded dispatch, ``{slot label:
    seconds}``.

    On a card each slot's mark is a CUDA event on its stream: every mark's
    ``query()`` is polled on a fixed cadence and the seconds from ``t0``
    (the dispatch) at which it was first seen done are recorded, so a
    straggling slot shows a larger settle time wherever it sits in slot
    order.  A probe that raises counts as done (it must not wedge the
    wave), and a wave stuck past ``_SETTLE_MAX_WAIT_S`` charges its
    pending slots the wait so far.  On the CPU each slot's mark is the
    host clock's stamp of its completion, read by the same poll: the slots
    run synchronously, one after another, so every stamp precedes the
    first poll and every slot reads as settled there (as the JAX package's
    readiness poll reads its CPU mesh).

    The ``shard.settle`` fault seam rides here as a QUERY
    (``faults.FaultInjector.latency``): a latency rule matching a slot
    label defers that slot's observed time instead of sleeping.  Returns
    ``{}`` for anything without slot marks (a host tensor, an unsharded
    result) and for fewer than two slots."""
    from predictionio_tpu_torch.resilience import faults

    marks = getattr(result, "slot_marks", None)
    if not isinstance(marks, Mapping) or len(marks) < 2:
        return {}
    out: dict[str, float] = {}
    pending = dict(marks)
    give_up = t0 + _SETTLE_MAX_WAIT_S
    # this poll IS the measurement: sampling every slot's event on one
    # cadence is what clocks each slot independently of slot order
    # pio: ignore[PIO-CONC002]
    while pending:
        now = time.perf_counter()
        for label in list(pending):
            mark = pending[label]
            try:
                ready = mark <= now if isinstance(mark, float) else mark.query()
            except Exception:
                ready = True
            if ready:
                out[label] = now - t0
                del pending[label]
        if not pending:
            break
        if now > give_up:
            for label in pending:
                out[label] = time.perf_counter() - t0
            break
        time.sleep(_SETTLE_POLL_S)
    out = {label: out[label] for label in marks}
    if faults.ACTIVE is not None:
        for label in out:
            out[label] += faults.ACTIVE.latency("shard.settle", label)
    return out


def run_observed_wave(
    fn: str,
    *,
    device: torch.device,
    sig: tuple,
    cost: Mapping[str, float],
    host_input: np.ndarray,
    compute: Callable[[torch.Tensor], ShardedResult],
    shard_arrays: Mapping[str, Any],
) -> np.ndarray:
    """Dispatch one sharded serving wave under the instrumentation every
    engine shares: the launch signature, the least-work ``cost`` on the
    roofline, the ids' upload (``h2d``), the timed compute with the
    per-slot settle clock (``compute``), the read of the packed result
    (``d2h``), and the per-slot attribution on the wave timeline
    (``wave_shards``, ``wave_shard_seconds``) and the straggler board.

    ``compute(ids on device)`` launches the wave and returns its
    :class:`ShardedResult`.  On a card the wave's device time is two CUDA
    events on the merge device's stream around it (the slots' streams wait
    on the first; the merge, on every slot); on the CPU, the host span.
    Returns the packed ``[2, B, k]`` result as numpy."""
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.parallel.mesh import meter_shards

    eff = device_obs.default_efficiency()
    device_obs.default_recompiles().note_signature(fn, sig)
    eff.record_cost(fn, cost["flops"], cost["bytes"], signature=sig,
                    source="least_work")
    on_card = device.type == "cuda"
    with device_obs.wave_stage("h2d"):
        ids = torch.from_numpy(np.ascontiguousarray(host_input, np.int64))
        if on_card:
            ids = ids.to(device)
            device_obs.note_transfer("h2d", host_input.nbytes)
    timing = (
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True)) if on_card else None
    )
    t_dev = time.perf_counter()
    with device_obs.wave_stage("compute"):
        if timing is not None:
            timing[0].record(torch.cuda.current_stream(device))
        result = compute(ids)
        if timing is not None:
            timing[1].record(torch.cuda.current_stream(device))
        # each slot's own settle time (the straggler board's input), then
        # the whole wave
        shard_seconds = settle_shards(result, t_dev)
        if timing is not None:
            timing[1].synchronize()
    compute_s = time.perf_counter() - t_dev
    kernel_s = (
        timing[0].elapsed_time(timing[1]) / 1e3 if timing is not None
        else compute_s
    )
    device_obs.note_wave_device(device_obs.device_label(result.packed))
    device_obs.note_wave_cost(fn, cost)
    device_obs.note_wave_kernel(kernel_s)
    with device_obs.wave_stage("d2h"):
        packed = result.packed.cpu().numpy()
        if on_card:
            device_obs.note_transfer("d2h", packed.nbytes)
    eff.observe(fn, kernel_s, signature=sig)
    attribution = meter_shards(
        fn, shard_arrays, seconds=shard_seconds or compute_s
    )
    device_obs.note_wave_shards(attribution)
    if shard_seconds:
        device_obs.note_shard_seconds(shard_seconds)
        device_obs.default_stragglers().record_wave(
            fn,
            shard_seconds,
            {dev: e.get("bytes", 0.0) for dev, e in attribution.items()},
        )
    return packed


# ---------------------------------------------------------------------------
# serving-side bundle: what an engine keeps after binding a plan


@dataclass
class BoundShards:
    """One model's sharded serving state: the bound mesh, the placed arrays,
    their real row counts, and a per-(batch, k) kernel cache."""

    plan: ShardPlan
    mesh: Mesh
    arrays: dict[str, Any]
    rows: dict[str, int]
    _kernels: dict[tuple, Any] = field(default_factory=dict)

    @property
    def n_shards(self) -> int:
        axis = next(
            (e for spec in self.plan.specs.values() for e in spec if e),
            None,
        )
        return int(self.mesh.shape[axis]) if axis else 1

    def kernel(self, key: tuple, build: Callable[[], Any]) -> Any:
        fn = self._kernels.get(key)
        if fn is None:
            fn = self._kernels[key] = build()
        return fn

    def attribution(self) -> dict[str, dict[str, float]]:
        """Per-slot byte attribution of the sharded arrays."""
        return shard_attribution(
            {k: v for k, v in self.arrays.items() if k in self.plan.specs}
        )


def bind_shards(
    plan: ShardPlan,
    arrays: Mapping[str, Any],
    devices: Sequence[Any] | None = None,
) -> BoundShards:
    """Re-bind a recorded plan onto the slots at hand (default: every
    visible CUDA device): re-solve axis sizes for their count, pad and
    place every array.  The deploy-time half of the ShardPlan lifecycle."""
    mesh = plan.mesh(devices)
    bound_plan = plan.rebind(mesh.devices.size)
    placed, rows = shard_put_tree(mesh, bound_plan, arrays)
    # plan-recorded real row counts win over inferred ones (an array may
    # arrive pre-padded from a checkpoint)
    for name, n in bound_plan.rows.items():
        if name in rows:
            rows[name] = min(rows[name], int(n))
    return BoundShards(plan=bound_plan, mesh=mesh, arrays=placed, rows=rows)
