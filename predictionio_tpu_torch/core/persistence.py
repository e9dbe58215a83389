"""Model serialization: the JAX package's sharded pickle format.

Every torch tensor is copied to host numpy before pickling, so a checkpoint
never depends on the device it was made on and the JAX package can read it
(and this module reads the JAX package's checkpoints byte for byte).  A
class of the JAX package in a checkpoint (``predictionio_tpu.<module>``,
such as the NCF template's ``NCFParams``) loads as the port's class of the
same module and name, so loading never imports the JAX package.
``serialize_models_sharded`` spills every numpy leaf of ``PART_THRESHOLD``
bytes or more into its own named part (raw ``.npy`` bytes) via the pickle
``persistent_id`` hook, leaving a small manifest that references them;
``Models.insert_parts`` stores each part as its own keyed blob.  A
persistent-model manifest is written under the JAX package's class name
(``_JaxNamingPickler``), so the JAX package reads the port's manifests too.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, Callable

import numpy as np
import torch

#: leaves at or above this many bytes become standalone parts
PART_THRESHOLD = 1 << 20


def _to_host(obj: Any) -> Any:
    """Map torch tensors to numpy throughout dicts, lists, tuples and
    dataclass instances (the containers a persisted model is made of)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    if isinstance(obj, tuple):
        out = [_to_host(v) for v in obj]
        return type(obj)(*out) if hasattr(obj, "_fields") else tuple(out)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{
                f.name: _to_host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.init
            },
        )
    return obj


class _SpillingParts:
    """Spills big ndarray leaves into a side table of parts (mixed into a
    pickler)."""

    def __init__(self, buf: io.BytesIO, threshold: int):
        super().__init__(buf, protocol=pickle.HIGHEST_PROTOCOL)
        self.parts: dict[str, bytes] = {}
        self.threshold = threshold
        # persistent_id runs before pickle's own memoization, so aliased
        # arrays (one table referenced from two fields) are deduped here
        self._seen: dict[int, str] = {}
        self._keepalive: list[Any] = []

    def persistent_id(self, obj: Any):
        if isinstance(obj, np.ndarray) and obj.nbytes >= self.threshold:
            name = self._seen.get(id(obj))
            if name is None:
                name = f"leaf{len(self.parts):05d}"
                part = io.BytesIO()
                np.save(part, obj, allow_pickle=False)
                self.parts[name] = part.getvalue()
                self._seen[id(obj)] = name
                self._keepalive.append(obj)  # pin id() for the dump's life
            return ("pio-part", name)
        return None


class _ShardingPickler(_SpillingParts, pickle.Pickler):
    """Pickler that spills big ndarray leaves into a side table of parts."""


#: the JAX package's top-level module, whose classes map onto the port's
JAX_PACKAGE = "predictionio_tpu"


def _jax_named_classes() -> dict[type, tuple[str, str]]:
    """The port's classes that a checkpoint names by the JAX package's
    module, so the JAX package unpickles its own class: the persistent
    model manifest (its loader checks ``isinstance`` against its class)."""
    from predictionio_tpu_torch.core.persistent_model import (
        PersistentModelManifest,
    )

    return {
        PersistentModelManifest: (
            JAX_PACKAGE + ".core.persistent_model", "PersistentModelManifest"
        )
    }


class _JaxNamingPickler(_SpillingParts, pickle._Pickler):
    """The pure-Python pickler, writing each class of
    :func:`_jax_named_classes` under the JAX package's module name without
    importing that module (the C pickler resolves every global it writes).
    Used only for model lists that hold such an object."""

    def __init__(self, buf: io.BytesIO, threshold: int):
        super().__init__(buf, threshold)
        self._jax_names = _jax_named_classes()

    def save_global(self, obj, name=None):
        alias = self._jax_names.get(obj) if isinstance(obj, type) else None
        if alias is None:
            return super().save_global(obj, name)
        self.save(alias[0])
        self.save(alias[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _PortUnpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to the port's."""

    def find_class(self, module: str, name: str):
        if module == JAX_PACKAGE or module.startswith(JAX_PACKAGE + "."):
            module = "predictionio_tpu_torch" + module[len(JAX_PACKAGE):]
        return super().find_class(module, name)


class _ShardingUnpickler(_PortUnpickler):
    def __init__(self, buf: io.BytesIO, get_part: Callable[[str], bytes | None]):
        super().__init__(buf)
        self.get_part = get_part
        self._loaded: dict[str, np.ndarray] = {}

    def persistent_load(self, pid: Any) -> Any:
        kind, name = pid
        if kind != "pio-part":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        # memoized so aliased references restore as one shared array
        if name not in self._loaded:
            blob = self.get_part(name)
            if blob is None:
                raise pickle.UnpicklingError(f"missing model part {name!r}")
            self._loaded[name] = np.load(io.BytesIO(blob), allow_pickle=False)
        return self._loaded[name]


def serialize_models(models: list[Any]) -> bytes:
    """Single-blob format (legacy/small models): one pickle of the model
    list, every tensor copied to host numpy first."""
    buf = io.BytesIO()
    pickle.Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(
        [_to_host(m) for m in models]
    )
    return buf.getvalue()


def deserialize_models(blob: bytes) -> list[Any]:
    """Inverse of either package's ``serialize_models``."""
    return _PortUnpickler(io.BytesIO(blob)).load()


def serialize_models_sharded(
    models: list[Any], threshold: int = PART_THRESHOLD
) -> tuple[bytes, dict[str, bytes]]:
    """Return (manifest blob, {part name: raw .npy bytes})."""
    buf = io.BytesIO()
    named = tuple(_jax_named_classes())
    pickler = (
        _JaxNamingPickler if any(isinstance(m, named) for m in models)
        else _ShardingPickler
    )
    p = pickler(buf, threshold)
    p.dump([_to_host(m) for m in models])
    return buf.getvalue(), p.parts


def deserialize_models_sharded(
    manifest: bytes, get_part: Callable[[str], bytes | None]
) -> list[Any]:
    """Inverse of ``serialize_models_sharded``; parts are fetched lazily
    through ``get_part`` as the manifest references them."""
    return _ShardingUnpickler(io.BytesIO(manifest), get_part).load()


def save_models(
    models_store, instance_id: str, models: list[Any],
    threshold: int | None = None,
) -> None:
    """Persist a model list under an engine-instance id (sharded format)."""
    manifest, parts = serialize_models_sharded(
        models, threshold if threshold is not None else PART_THRESHOLD
    )
    models_store.insert_parts(instance_id, manifest, parts)


def load_models(models_store, instance_id: str) -> list[Any] | None:
    """Load a model list saved by either package's ``save_models``, or the
    legacy single-blob format (checked in that order)."""
    manifest = models_store.get_manifest(instance_id)
    if manifest is not None:
        return deserialize_models_sharded(
            manifest, lambda name: models_store.get_part(instance_id, name)
        )
    blob = models_store.get(instance_id)
    if blob is None:
        return None
    return deserialize_models(blob)


def _tensor_from_spill(array: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(array).to(device)


class _SpillPickler(pickle.Pickler):
    """Pickles each tensor as its numpy copy and its device."""

    def reducer_override(self, obj: Any):
        if isinstance(obj, torch.Tensor):
            return _tensor_from_spill, (obj.detach().cpu().numpy(), str(obj.device))
        return NotImplemented


def serialize_spill(models: list[Any]) -> bytes:
    """Models pickled for a spill that this process reads back
    (``deserialize_spill``): unlike a checkpoint, every tensor comes back
    as a tensor on the device it left."""
    buf = io.BytesIO()
    _SpillPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(models)
    return buf.getvalue()


def deserialize_spill(blob: bytes) -> list[Any]:
    """Inverse of :func:`serialize_spill`."""
    return pickle.loads(blob)
