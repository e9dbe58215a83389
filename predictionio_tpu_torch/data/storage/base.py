"""Storage contracts that deploy needs: the engine-instance record and the
model blob store with its multipart (manifest + named parts) layout.

The layout is the JAX package's, byte for byte (``<id>:manifest`` framed by
the sorted part-name list, ``<id>:part:<name>`` per part), so either package
reads a checkpoint the other wrote.  Event DAOs and the app/key/channel
metadata arrive with a later slice.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Any, Mapping


@dataclass(frozen=True)
class EngineInstance:
    """Record of one training run — the deploy handle.

    Mirrors EngineInstances.scala:46: every parameter that produced the model
    is frozen into this row as JSON.
    """

    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: datetime
    end_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, Any] = field(default_factory=dict)
    datasource_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"

    def completed(self) -> "EngineInstance":
        return replace(
            self, status="COMPLETED", end_time=datetime.now(tz=timezone.utc)
        )


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> EngineInstance | None: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None: ...


class Models(abc.ABC):
    """Model blob store keyed by engine-instance id (Models.scala:33).

    Besides the single-blob contract, every backend supports the multipart
    checkpoint layout: each part is an ordinary keyed blob
    (``<id>:part:<name>``) and the manifest is written last as the commit
    point.
    """

    @abc.abstractmethod
    def insert(self, instance_id: str, blob: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> bytes | None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...

    # -- multipart (sharded checkpoints) -------------------------------------
    def insert_parts(
        self, instance_id: str, manifest: bytes, parts: Mapping[str, bytes]
    ) -> None:
        # re-saving an id: drop the old manifest FIRST so readers see
        # "absent" rather than the old part list paired with new bytes,
        # then remove the old parts so fewer new parts leak no orphans
        old = self.get(f"{instance_id}:manifest")
        if old is not None:
            self.delete(f"{instance_id}:manifest")
            for name in _manifest_part_names(old):
                self.delete(f"{instance_id}:part:{name}")
        for name, blob in parts.items():
            self.insert(f"{instance_id}:part:{name}", blob)
        # manifest last: readers treat its presence as "all parts written"
        self.insert(f"{instance_id}:manifest", _manifest_blob(manifest, parts))

    def get_manifest(self, instance_id: str) -> bytes | None:
        raw = self.get(f"{instance_id}:manifest")
        return None if raw is None else _manifest_payload(raw)

    def get_part(self, instance_id: str, name: str) -> bytes | None:
        return self.get(f"{instance_id}:part:{name}")


def _manifest_blob(manifest: bytes, parts: Mapping[str, bytes]) -> bytes:
    """Frame the part-name list in front of the manifest payload so a
    cleanup can enumerate parts without deserializing models."""
    names = ",".join(sorted(parts)).encode()
    return len(names).to_bytes(4, "big") + names + manifest


def _manifest_payload(raw: bytes) -> bytes:
    n = int.from_bytes(raw[:4], "big")
    return raw[4 + n:]


def _manifest_part_names(raw: bytes) -> list[str]:
    n = int.from_bytes(raw[:4], "big")
    names = raw[4 : 4 + n].decode()
    return names.split(",") if names else []
