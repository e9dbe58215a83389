"""Custom model persistence (controller/PersistentModel.scala:67,92).

Algorithms whose models are too big or too special for the default
checkpoint path implement ``PersistentModel`` — ``save`` writes the model
wherever it likes and the framework stores only a manifest
(workflow/PersistentModelManifest.scala:21); at deploy, the class named in
the manifest is imported and its ``load`` re-materializes the model.

``LocalFileSystemPersistentModel`` (LocalFileSystemPersistentModel.scala:43)
is the ready-made flavor pickling the model under ``$PIO_HOME/pmodels``.

The port of the JAX package's ``core/persistent_model.py``, with the same
manifest class, the same file layout and the same default home, so a
model saved by either package deploys on the other: a manifest pickled by
the JAX package unpickles as this module's class (``core/persistence.py``
maps the JAX package's modules onto the port's), and a file pickled by the
JAX package loads through the same mapping.
"""

from __future__ import annotations

import abc
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Any, ClassVar

from predictionio_tpu_torch.utils.registry import resolve_import_path


@dataclass(frozen=True)
class PersistentModelManifest:
    """Stored instead of the model blob: names the loader class."""

    class_path: str  # "pkg.module:Class"


class PersistentModel(abc.ABC):
    """Mixin for models that persist themselves."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Any) -> bool:
        """Persist; returning False falls back to default serialization."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Any) -> "PersistentModel":
        """Inverse of save, called at deploy."""

    @classmethod
    def class_path(cls) -> str:
        return f"{cls.__module__}:{cls.__qualname__}"


def load_from_manifest(manifest: PersistentModelManifest, instance_id: str, params: Any):
    """Resolve the loader class and re-materialize (SparkWorkflowUtils.
    getPersistentModel role)."""
    cls = resolve_import_path(manifest.class_path)
    if cls is None:
        raise ImportError(
            f"persistent model class {manifest.class_path!r} not importable"
        )
    return cls.load(instance_id, params)


class LocalFileSystemPersistentModel(PersistentModel):
    """Pickle the object under a well-known local path keyed by instance id."""

    #: override to relocate; resolved lazily so PIO_HOME applies
    base_dir: ClassVar[str | None] = None

    @classmethod
    def _path(cls, instance_id: str) -> Path:
        import os

        base = cls.base_dir or os.path.join(
            os.environ.get("PIO_HOME", str(Path.home() / ".predictionio_tpu")),
            "pmodels",
        )
        return Path(base) / f"{instance_id}-{cls.__name__}.pkl"

    def save(self, instance_id: str, params: Any) -> bool:
        path = self._path(instance_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)
        return True

    @classmethod
    def load(cls, instance_id: str, params: Any):
        from predictionio_tpu_torch.core.persistence import _PortUnpickler

        with open(cls._path(instance_id), "rb") as f:
            return _PortUnpickler(f).load()
