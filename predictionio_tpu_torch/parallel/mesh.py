"""Device-mesh construction and per-slot attribution.

The port of the JAX package's ``parallel/mesh.py``, single-process.  Where
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

The multi-process half (``make_hybrid_mesh``, ``initialize_distributed``,
``global_data_array``, ``global_replicated_array`` and the all-gather of
:func:`balance_local_chunks`) comes with the port's mesh training, on
``torch.distributed``.
"""

from __future__ import annotations

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
    is slot 0's.  Each CUDA slot gets its own stream at first use."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
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
        self._streams: dict[int, Any] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def merge_device(self) -> torch.device:
        return self.slots[0]

    @property
    def physical_devices(self) -> list[torch.device]:
        """The distinct devices behind the slots, in slot order."""
        return list(dict.fromkeys(self.slots))

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
    """Build a Mesh from a MeshConfig over the given (default: every visible
    CUDA device) slots; a device may be given more than once."""
    config = config or MeshConfig()
    devices = [
        _slot_device(d)
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
    return Mesh(grid.reshape(sizes), axis_names=tuple(names))


def default_mesh() -> Mesh:
    """All visible CUDA devices on one ``data`` axis."""
    return make_mesh(MeshConfig())


def balance_local_chunks(
    arrays: Sequence[np.ndarray], multiple: int
) -> tuple[list[np.ndarray], np.ndarray]:
    """Pad this process's COO chunk arrays to one chunk-aligned length with
    zeros; returns the padded arrays plus a float32 valid-mask (1.0 real
    rows), the weight-0 padding ``train_als`` uses, so padding rows are
    inert.  A process that read zero rows still contributes one full
    (all-padding) chunk.  Single-process: the target is this process's own
    length (the JAX package all-gathers every process's first)."""
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
    target = max((n_local + multiple - 1) // multiple * multiple, multiple)
    out = []
    for a in arrays:
        padded = np.zeros(target, a.dtype)
        padded[:n_local] = a
        out.append(padded)
    valid = np.zeros(target, np.float32)
    valid[:n_local] = 1.0
    return out, valid


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
