"""Device-mesh construction and per-slot attribution.

The port of the JAX package's ``parallel/mesh.py``.  Where
JAX builds a ``jax.sharding.Mesh`` over the TPU slice, the port builds a
:class:`Mesh`: a numpy object array of ``torch.device`` *slots*, shaped by
named axes.  A slot is a place an array's part lives and its work runs;
one device may fill several slots (``[torch.device("cpu")] * 8`` in the
tests, ``[torch.device("cuda", 0)] * 4`` on a one-card host), the
counterpart of JAX's virtual 8-device CPU mesh.  Every slot is labelled
``f"{type}:{position}"`` (``cpu:0`` ... ``cpu:7``), the labels JAX gives
its virtual mesh, so per-slot bodies compare equal across the packages.

Axis convention (the JAX package's):
  - ``data``  — batch/data parallelism (events, queries, rating rows)
  - ``model`` — parameter sharding (embedding/factor-table rows)

The multi-process half runs on ``torch.distributed`` under the JAX
package's env contract (``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES``,
``PIO_PROCESS_ID``): :func:`initialize_distributed` joins the group and
picks the collective backend, :func:`make_hybrid_mesh` and
:func:`make_mesh` lay every rank's local slots out on one global grid (a
slot knows its owning rank, only a rank's own slots hold tensors, labels
stay ``f"{type}:{position}"`` over the grid), :func:`global_data_array` and
:func:`global_replicated_array` place a rank's rows, and
:func:`balance_local_chunks` all-gathers the ranks' lengths.

**The backend rule** (the counterpart of the JAX package's gloo-on-CPU
switch): every process first joins a gloo group and all-gathers each
rank's device (type and, on CUDA, the card's UUID).  NCCL carries the CUDA
tensors' collectives only when every rank holds a card of its own; where
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU, the collectives are gloo's, which take CUDA tensors as they are; the
compute never leaves the card.  Every rank decides alike from the same
gathered list, so no rank takes another path than its peers.
"""

from __future__ import annotations

import atexit
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceUnavailable


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape, recorded into EngineInstance.mesh_conf.

    ``axes`` maps axis name -> size; a size of -1 means "all remaining
    devices".  Empty axes = one-device mesh (local/L-flavor compute).
    """

    axes: dict[str, int] = field(default_factory=lambda: {"data": -1})

    def to_dict(self) -> dict[str, Any]:
        return {"axes": dict(self.axes)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "MeshConfig":
        if not d or not d.get("axes"):
            return cls()
        return cls(axes=dict(d["axes"]))


class Mesh:
    """Named axes over a grid of device slots (``devices``: a numpy object
    array of ``torch.device``; ``shape``: axis name -> size, like
    ``jax.sharding.Mesh.shape``).  Slot ``i`` of the flattened grid is
    labelled ``f"{type}:{i}"``.  The merge device of a sharded computation
    is the first local slot's.  Each CUDA slot gets its own stream at first
    use.

    ``process_ids`` gives each slot's owning rank (default: every slot
    this process's); a slot of another rank names that rank's device and
    holds nothing here (``local_slots`` are this process's own)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_ids: Sequence[int] | None = None):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dimensions given {len(axis_names)} "
                "axis names"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.slots: list[torch.device] = list(devices.flat)
        self.labels: list[str] = [
            f"{d.type}:{i}" for i, d in enumerate(self.slots)
        ]
        self.process_index = process_index()
        self.process_ids: list[int] = (
            [self.process_index] * len(self.slots) if process_ids is None
            else [int(r) for r in process_ids]
        )
        if len(self.process_ids) != len(self.slots):
            raise ValueError("process_ids must name one rank per slot")
        self.local_slots: list[int] = [
            i for i, r in enumerate(self.process_ids) if r == self.process_index
        ]
        self._streams: dict[int, Any] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def is_multiprocess(self) -> bool:
        return len(set(self.process_ids)) > 1

    @property
    def merge_device(self) -> torch.device:
        return self.slots[self.local_slots[0]]

    @property
    def physical_devices(self) -> list[torch.device]:
        """The distinct local devices behind the slots, in slot order."""
        return list(dict.fromkeys(self.slots[i] for i in self.local_slots))

    def positions(self, axis: str) -> list[int]:
        """Each slot's index along ``axis``."""
        i = self.axis_names.index(axis)
        grid = np.indices(self.devices.shape)[i]
        return [int(p) for p in grid.flat]

    def owners(self, axis: str) -> list[int]:
        """For each index along ``axis``, the first slot holding it (the one
        a single-controller computation runs that index on)."""
        pos = self.positions(axis)
        return [pos.index(p) for p in range(self.shape[axis])]

    def stream(self, slot: int):
        """The CUDA stream of one slot (made at first use)."""
        s = self._streams.get(slot)
        if s is None:
            s = self._streams[slot] = torch.cuda.Stream(device=self.slots[slot])
        return s


def _slot_device(d: Any) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device; raises :class:`DeviceUnavailable` on a
    host without a card (pass the slots explicitly to run on the CPU)."""
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            "a device mesh needs CUDA, which is not available on this host; "
            "pass devices=[torch.device('cpu')] * n to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    config: MeshConfig | None = None,
    devices: Sequence[Any] | None = None,
) -> Mesh:
    """Build a Mesh from a MeshConfig over the given slots (default: every
    visible CUDA device, or in a process group every rank's slots); a
    device may be given more than once."""
    config = config or MeshConfig()
    owners = None
    if devices is None and process_count() > 1:
        # every rank's local slots, rank-major: the global grid
        devices, owners = [], []
        for rank, slots in enumerate(_DIST.slots):
            devices += [torch.device(d) for d in slots]
            owners += [rank] * len(slots)
    devices = [
        _slot_device(d) if owners is None else d
        for d in (devices if devices is not None else visible_devices())
    ]
    axes = dict(config.axes) or {"data": -1}
    names = list(axes)
    sizes = list(axes.values())
    n = len(devices)
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    n_wild = sum(1 for s in sizes if s == -1)
    if n_wild > 1:
        raise ValueError("at most one mesh axis may be -1 (auto)")
    if n_wild == 1:
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by fixed axes product {fixed}"
            )
        sizes = [n // fixed if s == -1 else s for s in sizes]
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, have {n}")
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape(sizes), axis_names=tuple(names),
                process_ids=None if owners is None else owners[:total])


def default_mesh() -> Mesh:
    """Every slot on one ``data`` axis: the visible CUDA devices, or in a
    multi-process group every rank's local slots."""
    return make_mesh(MeshConfig())


def make_hybrid_mesh(
    ici_axes: Mapping[str, int] | None = None,
    dcn_axes: Mapping[str, int] | None = None,
    devices: Sequence[Any] | None = None,
) -> Mesh:
    """The multi-host mesh: ``ici_axes`` lay out each process's local
    slots (``devices``, default :func:`local_devices`), ``dcn_axes`` the
    processes.  An axis's global size is the product of the two; along it
    the process's coordinate is the outer index and the local slot's the
    inner one.  Defaults: pure data parallelism, every local slot and
    every process on ``data``.  In one process it collapses to
    :func:`make_mesh` with the combined shape."""
    n_processes = process_count()
    local = list(devices) if devices is not None else local_devices()
    ici = dict(ici_axes or {"data": len(local), "model": 1})
    dcn = dict(dcn_axes or {"data": n_processes, "model": 1})
    names = tuple(ici)
    if tuple(dcn) != names:
        raise ValueError(f"ici/dcn axis names must match: {names} vs {tuple(dcn)}")
    if n_processes == 1:
        # single host: collapse to a plain mesh with the combined shape
        sizes = {k: ici[k] * dcn[k] for k in names}
        return make_mesh(MeshConfig(axes=sizes), devices=local)
    ici_shape = [ici[k] for k in names]
    dcn_shape = [dcn[k] for k in names]
    if int(np.prod(dcn_shape)) != n_processes:
        raise ValueError(
            f"dcn axes {dcn} need {int(np.prod(dcn_shape))} processes, "
            f"have {n_processes}"
        )
    per_rank = [len(s) for s in _DIST.slots]
    if any(n != int(np.prod(ici_shape)) for n in per_rank):
        raise ValueError(
            f"ici axes {ici} need {int(np.prod(ici_shape))} local slots a "
            f"process, the processes have {per_rank}"
        )
    shape = [a * b for a, b in zip(ici_shape, dcn_shape)]
    grid = np.empty(shape, dtype=object)
    owners = np.empty(shape, dtype=np.int64)
    for rank, slots in enumerate(_DIST.slots):
        outer = np.unravel_index(rank, dcn_shape)
        for j, d in enumerate(slots):
            inner = np.unravel_index(j, ici_shape)
            at = tuple(int(o) * n + int(x)
                       for o, n, x in zip(outer, ici_shape, inner))
            grid[at] = torch.device(d)
            owners[at] = rank
    return Mesh(grid, axis_names=names, process_ids=owners.reshape(-1).tolist())


# -- the multi-process half --------------------------------------------------


@dataclass
class _DistState:
    """This process's view of the group (set by
    :func:`initialize_distributed`)."""

    rank: int = 0
    world: int = 1
    #: the backend of CUDA tensors' collectives ("nccl" or "gloo"); CPU
    #: tensors always go through gloo
    backend: str = "gloo"
    #: each rank's local slots, as device strings
    slots: list = field(default_factory=list)
    cuda_group: Any = None


_DIST = _DistState()

#: per collective: calls, seconds (from the input ready to the result
#: ready, on the host clock) and the bytes this rank put in
COLLECTIVE_STATS: dict[str, dict[str, float]] = {}


def process_count() -> int:
    return _DIST.world


def process_index() -> int:
    return _DIST.rank


def local_devices() -> list[torch.device]:
    """This process's slots: the ones it joined the group with, else every
    visible CUDA device."""
    if _DIST.world > 1:
        return [torch.device(d) for d in _DIST.slots[_DIST.rank]]
    return visible_devices()


def collective_backend() -> str | None:
    """The backend of the CUDA tensors' collectives; None in one process."""
    return _DIST.backend if _DIST.world > 1 else None


def _device_id(dev: torch.device) -> dict[str, str]:
    if dev.type != "cuda":
        return {"type": dev.type, "uuid": ""}
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return {"type": "cuda",
            "uuid": str(uuid) if uuid is not None else f"{props.name}:{dev.index}"}


def choose_backend(devices: Sequence[Mapping[str, str]]) -> str:
    """NCCL when every rank holds a CUDA card of its own, else gloo."""
    if devices and all(d["type"] == "cuda" for d in devices):
        uuids = [d["uuid"] for d in devices]
        if len(set(uuids)) == len(uuids):
            return "nccl"
    return "gloo"


def initialize_distributed(
    device: str | torch.device | None = None,
    local_devices: Sequence[Any] | None = None,
) -> None:
    """Join the process group the env names (``PIO_COORDINATOR_ADDRESS``,
    rank 0's host:port; ``PIO_NUM_PROCESSES``; ``PIO_PROCESS_ID``); a
    no-op without the address, and once joined.

    ``device`` is this rank's device (``None`` means CUDA and raises
    without a card; pass ``"cpu"`` for the CPU), ``local_devices`` its
    slots (default ``[device]``).  The group is gloo's; each rank's device
    is all-gathered and :func:`choose_backend` decides whether a second,
    NCCL group carries the CUDA tensors' collectives."""
    import torch.distributed as dist

    from predictionio_tpu_torch.device import resolve_device

    addr = os.environ.get("PIO_COORDINATOR_ADDRESS")
    if not addr or _DIST.world > 1:
        return
    world = int(os.environ.get("PIO_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("PIO_PROCESS_ID", "0"))
    dev = _slot_device(resolve_device(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    slots = [_slot_device(d) for d in (local_devices or [dev])]
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank
        )
        atexit.register(_destroy_group)
    mine = {**_device_id(dev), "slots": [str(d) for d in slots]}
    every: list = [None] * world
    dist.all_gather_object(every, mine)
    backend = choose_backend(every)
    # every rank decides alike from the same gathered list, so either every
    # rank makes the NCCL group (new_group is collective) or none does
    cuda_group = dist.new_group(backend="nccl") if backend == "nccl" else None
    _DIST.rank, _DIST.world, _DIST.backend = rank, world, backend
    _DIST.slots = [e["slots"] for e in every]
    _DIST.cuda_group = cuda_group


def _destroy_group() -> None:
    """Destroy the process group at exit, so that its threads end before
    the interpreter does: a process that exits with them running can
    abort ("terminate called without an active exception")."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _collective(name: str, t: torch.Tensor, run) -> Any:
    """Run one collective on ``t`` under the backend rule, timed on the
    host clock from ``t`` ready to the result ready.  ``run(t, group)``
    issues it on the group the rule chose: the NCCL group for a CUDA
    tensor when every rank holds its own card, else gloo's (``None``, the
    default group)."""
    on_card = t.device.type == "cuda"
    if on_card:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    group = _DIST.cuda_group if on_card and _DIST.backend == "nccl" else None
    out = run(t, group)
    if on_card:
        torch.cuda.current_stream(t.device).synchronize()
    stats = COLLECTIVE_STATS.setdefault(
        name, {"calls": 0, "seconds": 0.0, "bytes": 0.0}
    )
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    stats["bytes"] += float(t.numel() * t.element_size())
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank, in place (``dist.all_reduce(SUM)``)."""
    import torch.distributed as dist

    def run(x, group):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    return _collective("all_reduce", t, run)


def all_gather_tensors(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in rank order, on
    ``t``'s device (``dist.all_gather``)."""
    return _gather("all_gather", t)


def _gather(name: str, t: torch.Tensor) -> list[torch.Tensor]:
    import torch.distributed as dist

    def run(x, group):
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(_DIST.world)]
        dist.all_gather(outs, x, group=group)
        return outs

    return _collective(name, t, run)


def all_gather_objects(obj: Any) -> list[Any]:
    """Every rank's picklable ``obj``, in rank order (gloo's group)."""
    import torch.distributed as dist

    every: list = [None] * _DIST.world
    dist.all_gather_object(every, obj)
    return every


def failed_ranks(failed: bool) -> list[int]:
    """Every rank says whether its part of a step failed; the ranks that
    did, the same list on every rank.  A collective: each rank calls it
    once per step, failed or not, so that a rank whose part raised stops
    its peers instead of leaving them waiting in the step's next
    collective.  Timed under ``COLLECTIVE_STATS["status"]``."""
    flags = _gather("status", torch.tensor([int(failed)], dtype=torch.int64))
    return [rank for rank, f in enumerate(flags) if int(f)]


def balance_local_chunks(
    arrays: Sequence[np.ndarray], multiple: int
) -> tuple[list[np.ndarray], np.ndarray]:
    """Equalize the ranks' COO chunk lengths for a global data-sharded
    array: all-gathers the local lengths, pads every array to the common
    (chunk-aligned) target with zeros, and returns the padded arrays plus
    a float32 valid-mask (1.0 real rows), the weight-0 padding
    ``train_als`` uses, so padding rows are inert.  A rank that read fewer
    rows than its peers (zero, in the remainder-on-last-host case) pads to
    the same length, its extra rows valid=0."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    if not arrays:
        raise ValueError("balance_local_chunks needs at least one array")
    n_local = len(arrays[0])
    if any(len(a) != n_local for a in arrays):
        raise ValueError(
            "balance_local_chunks arrays must share one local length, got "
            f"{[len(a) for a in arrays]}"
        )
    max_n = n_local
    if process_count() > 1:
        lens = all_gather_tensors(torch.tensor([n_local], dtype=torch.int64))
        max_n = int(max(int(x) for x in lens))
    target = max((max_n + multiple - 1) // multiple * multiple, multiple)
    out = []
    for a in arrays:
        padded = np.zeros(target, a.dtype)
        padded[:n_local] = a
        out.append(padded)
    valid = np.zeros(target, np.float32)
    valid[:n_local] = 1.0
    return out, valid


def global_data_array(mesh: Mesh, local: np.ndarray, axis: str = "data"):
    """This rank's rows as its slots' parts of one array sharded along
    ``axis`` (a ``placement.ShardedTensor`` whose other ranks' slots hold
    nothing): the rows split evenly, in position order, over the
    positions along ``axis`` that this rank's slots hold.  In one process
    every position is local, and ``local`` is the whole array."""
    from predictionio_tpu_torch.parallel.placement import ShardedTensor

    local = np.ascontiguousarray(local)
    positions = mesh.positions(axis)
    mine = sorted({positions[s] for s in mesh.local_slots})
    if len(local) % len(mine):
        raise ValueError(
            f"{len(local)} local rows do not split over {len(mine)} "
            f"positions of {axis!r}"
        )
    n = len(local) // len(mine)
    host = torch.from_numpy(local)
    placed: dict[tuple, torch.Tensor] = {}
    locals_: list = [None] * len(mesh.slots)
    for slot in mesh.local_slots:
        dev, pos = mesh.slots[slot], positions[slot]
        if (dev, pos) not in placed:
            j = mine.index(pos)
            placed[(dev, pos)] = host[j * n:(j + 1) * n].to(dev, copy=True)
        locals_[slot] = placed[(dev, pos)]
    shape = (n * mesh.shape[axis],) + tuple(local.shape[1:])
    return ShardedTensor(mesh, axis, locals_, shape)


def global_replicated_array(mesh: Mesh, value):
    """``value`` whole for every local slot of a (possibly multi-process)
    mesh, one copy per distinct device; every rank passes the same
    value."""
    from predictionio_tpu_torch.parallel.placement import ShardedTensor

    host = torch.as_tensor(np.array(value))
    copies: dict[torch.device, torch.Tensor] = {}
    locals_: list = [None] * len(mesh.slots)
    for slot in mesh.local_slots:
        dev = mesh.slots[slot]
        if dev not in copies:
            copies[dev] = host.to(dev, copy=True)
        locals_[slot] = copies[dev]
    return ShardedTensor(mesh, None, locals_, tuple(host.shape))


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _slot_parts(leaf: Any) -> list[tuple[str, Any]] | None:
    """(slot label, local tensor) of a placed array; one part for a plain
    torch tensor (on its device's label), None for host values."""
    parts = getattr(leaf, "slot_shards", None)
    if parts is not None:
        return parts()
    if isinstance(leaf, torch.Tensor):
        dev = leaf.device
        return [(f"{dev.type}:{dev.index or 0}", leaf)]
    return None


def shard_attribution(tree: Any) -> dict[str, dict[str, float]]:
    """Per-slot byte/part attribution of a tree of placed tensors: each
    slot reports the bytes of the local tensor it holds (padding rows
    included), so an imbalanced placement shows as imbalanced bytes.  Host
    numpy leaves contribute nothing."""
    out: dict[str, dict[str, float]] = {}
    for leaf in _leaves(tree):
        parts = _slot_parts(leaf)
        if parts is None:
            continue
        for label, local in parts:
            entry = out.setdefault(label, {"bytes": 0.0, "shards": 0})
            entry["bytes"] += float(local.numel() * local.element_size())
            entry["shards"] += 1
    return out


def meter_shards(
    fn: str,
    tree: Any,
    seconds: float | Mapping[str, float] | None = None,
    registry=None,
) -> dict[str, dict[str, float]]:
    """The per-slot attribution hook: record where ``fn``'s arrays live.

    Sets ``pio_shard_bytes{fn,device}`` per slot and, when ``seconds`` is
    given, observes ``pio_shard_seconds{fn,device}``: a scalar is one wall
    clock over every slot, a ``{slot: seconds}`` mapping each slot's own
    settle time (``placement.settle_shards``, what the straggler board
    skews on).  Returns the attribution map."""
    from predictionio_tpu_torch.obs.metrics import REGISTRY, STAGE_BUCKETS

    reg = registry or REGISTRY
    attribution = shard_attribution(tree)
    if not attribution:
        return attribution
    g_bytes = reg.gauge(
        "pio_shard_bytes",
        "Bytes of a named array group held per device",
        labelnames=("fn", "device"),
    )
    h_seconds = reg.histogram(
        "pio_shard_seconds",
        "Wall seconds of a named sharded step, per participating device",
        labelnames=("fn", "device"),
        buckets=STAGE_BUCKETS,
    )
    per_device = seconds if isinstance(seconds, Mapping) else None
    for label, entry in attribution.items():
        g_bytes.labels(fn, label).set(entry["bytes"])
        if per_device is not None:
            if label in per_device:
                h_seconds.labels(fn, label).observe(float(per_device[label]))
        elif seconds is not None:
            h_seconds.labels(fn, label).observe(seconds)
    return attribution


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad an array along ``axis`` so its size divides evenly for sharding.

    Returns (padded, original_size).  An EMPTY axis still pads up to one
    full multiple (each shard must own a non-empty equal slice; size 0
    reports 0 real rows), and a non-positive ``multiple`` raises."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    size = arr.shape[axis]
    target = max(((size + multiple - 1) // multiple) * multiple, multiple)
    if target == size:
        return arr, size
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, target - size)
    return np.pad(arr, pad_widths, constant_values=fill), size
