"""Crash-safe model generation store: the manifest behind every swap.

A *generation* is one trained engine instance plus lifecycle bookkeeping:
its blob checksum, its status in the rollout state machine, and when it
was promoted.  One JSON manifest per engine (keyed by
``engine_id/engine_version/engine_variant``) records every generation this
engine has rolled through::

    staged ──> canary ──> live ──> retired
                  │
                  └─────> rolled_back

The JAX package's ``lifecycle/generations.py``, ported whole: the same
manifest JSON under the same key, the same checksums over the same stored
bytes, so either package reads and advances a manifest the other wrote
over one store.  (The two packages pickle a model differently, so the
checksums agree only where the stored bytes are the same.)

The manifest is stored THROUGH the Models backend (localfs / sqlite), so
it inherits each backend's atomic-visibility primitive — the fsync'd
tmp-write + ``os.replace`` on localfs (data/storage/localfs_models.py), a
transactional row on SQLite.  Every manifest update is one whole-blob write: a crash
(SIGKILL included) between any two writes leaves the previous manifest
intact, so a restarting server always binds a *whole* generation — either
the old live or the new one, never a torn mix.

Checksums are SHA-256 over the stored model bytes (sharded manifest +
parts, or the legacy single blob).  ``verify`` recomputes and compares, so
a corrupt blob is refused at bind time and the binder falls back to the
most recent previously-live generation instead of crashing (or worse,
serving garbage).  The ``models.read`` fault seam lets the chaos suite
inject deterministic corruption here.

Pure stdlib; never touches a device.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from dataclasses import asdict, dataclass
from typing import Any

from predictionio_tpu_torch.data.storage.base import (
    Models,
    _manifest_part_names,
)
from predictionio_tpu_torch.obs.contention import ContendedLock
from predictionio_tpu_torch.resilience import faults

log = logging.getLogger("predictionio_tpu_torch.lifecycle")

#: manifest wire-format version
SCHEMA_VERSION = 1

#: rollout state machine statuses
STAGED, CANARY, LIVE, ROLLED_BACK, RETIRED = (
    "staged", "canary", "live", "rolled_back", "retired",
)
STATUSES = (STAGED, CANARY, LIVE, ROLLED_BACK, RETIRED)

#: storage key prefix for lifecycle manifests (instance ids are uuid hex,
#: so the prefix can never collide with a real model blob)
_MANIFEST_PREFIX = "__lifecycle__"


class LifecycleError(Exception):
    """Manifest-level failure (unknown generation, bad transition)."""


class CorruptModelError(LifecycleError):
    """Stored model bytes do not match the generation's checksum."""


def _now() -> float:
    """Wall clock for manifest timestamps — module-level so tests freeze it."""
    return time.time()


@dataclass
class Generation:
    """One row of the manifest."""

    instance_id: str
    checksum: str
    status: str = STAGED
    created_at: float = 0.0
    promoted_at: float | None = None
    rolled_back_at: float | None = None
    note: str = ""
    #: per-part SHA-256 over the sharded-checkpoint layout ("manifest" +
    #: one entry per named part) — verify() pinpoints WHICH factor shard
    #: went bad instead of just "bytes differ"; None for legacy single-blob
    part_checksums: dict[str, str] | None = None
    #: the serving plan dict (the JAX package's ``ShardPlan.to_dict()``)
    #: this generation was trained to serve under; recorded for either
    #: package's reader, ignored by the port's one-device deploy
    shard_plan: dict[str, Any] | None = None

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Generation":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


def shard_axes(shard_plan: dict[str, Any] | None) -> dict[str, int] | None:
    """The mesh axes of a recorded serving plan (axis name -> size; -1 =
    all devices at bind time), or None for unsharded generations.  The
    compact identity a per-answer provenance record carries — the full
    plan (specs + real row counts) stays in the manifest."""
    if not shard_plan:
        return None
    axes = shard_plan.get("axes")
    return dict(axes) if axes else None


#: storage-key suffix of the serving-layout sidecar blob (kept OUTSIDE the
#: checksummed model bytes: the manifest entry is the authoritative copy)
SHARD_PLAN_SUFFIX = ":shardplan"


def read_shard_plan(models_store: Models, instance_id: str) -> dict | None:
    """The serving plan (dict form) that ``run_train`` (either package's)
    stores beside a sharded model, or None when the model is unsharded or
    predates plans."""
    raw = models_store.get(f"{instance_id}{SHARD_PLAN_SUFFIX}")
    if raw is None:
        return None
    try:
        return json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None


def compute_checksums(
    models_store: Models, instance_id: str
) -> tuple[str, dict[str, str] | None]:
    """One pass over the stored bytes of an engine instance's model:
    ``(whole_checksum, part_checksums)``.

    The whole checksum is SHA-256 over either layout (sharded manifest +
    parts, or the legacy single blob).  For the sharded layout the second
    element maps ``{"manifest": ..., "part:<name>": ...}`` to per-blob
    digests (one corrupt factor shard is named, not just detected); for the
    single-blob layout it is None.  Each blob is fetched ONCE — a multi-GB
    sharded checkpoint on a remote backend is not downloaded twice just to
    produce both granularities.

    Reads go through the ``models.read`` fault seam so chaos plans can
    corrupt bytes deterministically between write and verify.
    """
    h = hashlib.sha256()
    manifest = _read_blob(models_store, f"{instance_id}:manifest")
    if manifest is not None:
        h.update(b"manifest\x00")
        h.update(manifest)
        parts = {"manifest": hashlib.sha256(manifest).hexdigest()}
        for name in sorted(_manifest_part_names(manifest)):
            part = _read_blob(models_store, f"{instance_id}:part:{name}")
            if part is None:
                raise CorruptModelError(
                    f"model part {name!r} of instance {instance_id} is missing"
                )
            h.update(name.encode() + b"\x00")
            h.update(part)
            parts[f"part:{name}"] = hashlib.sha256(part).hexdigest()
        return h.hexdigest(), parts
    blob = _read_blob(models_store, instance_id)
    if blob is None:
        raise CorruptModelError(f"no model bytes for instance {instance_id}")
    h.update(b"blob\x00")
    h.update(blob)
    return h.hexdigest(), None


def compute_checksum(models_store: Models, instance_id: str) -> str:
    """Whole-model SHA-256 (either layout); see :func:`compute_checksums`."""
    return compute_checksums(models_store, instance_id)[0]


def compute_part_checksums(
    models_store: Models, instance_id: str
) -> dict[str, str] | None:
    """Per-part SHA-256 of a sharded checkpoint, or None for the legacy
    single-blob layout; see :func:`compute_checksums`."""
    return compute_checksums(models_store, instance_id)[1]


def _read_blob(models_store: Models, key: str) -> bytes | None:
    blob = models_store.get(key)
    if blob is not None and faults.ACTIVE is not None:
        blob = faults.ACTIVE.corrupt("models.read", key, blob)
    return blob


class GenerationStore:
    """The per-engine manifest: generation CRUD + the rollout transitions.

    Thread-safe within one process (all mutations under one lock); the
    commit point of every transition is a single whole-manifest write
    through the Models backend, so cross-process readers see either the
    previous or the next manifest, never a partial one.
    """

    def __init__(
        self,
        models_store: Models,
        engine_id: str = "default",
        engine_version: str = "default",
        engine_variant: str = "default",
        max_history: int = 32,
    ):
        self.models_store = models_store
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.max_history = max(max_history, 2)
        # manifest read-modify-write sections serialize here (reentrant:
        # transitions call read/write helpers under the same lock); metered
        # so a slow storage backend holding the manifest lock shows up as
        # pio_lock_wait_seconds{lock="generation_store"} on the other paths
        self._lock = ContendedLock("generation_store", reentrant=True)

    @property
    def engine_key(self) -> str:
        return f"{self.engine_id}/{self.engine_version}/{self.engine_variant}"

    @property
    def manifest_key(self) -> str:
        return f"{_MANIFEST_PREFIX}:{self.engine_key}"

    # -- manifest I/O --------------------------------------------------------

    def read(self) -> dict[str, Any]:
        raw = self.models_store.get(self.manifest_key)
        if raw is None:
            return {
                "schema": SCHEMA_VERSION,
                "engine": self.engine_key,
                "generations": [],
            }
        try:
            manifest = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise LifecycleError(
                f"lifecycle manifest for {self.engine_key} is unreadable: {e}"
            ) from e
        return manifest

    def _write(self, manifest: dict[str, Any]) -> None:
        gens = manifest["generations"]
        if len(gens) > self.max_history:
            # keep the tail (most recent) plus anything still active
            active = [
                g for g in gens[: -self.max_history]
                if g["status"] in (LIVE, CANARY)
            ]
            manifest["generations"] = active + gens[-self.max_history:]
        manifest["updated_at"] = _now()
        self.models_store.insert(
            self.manifest_key,
            json.dumps(manifest, sort_keys=True).encode("utf-8"),
        )

    def exists(self) -> bool:
        return self.models_store.get(self.manifest_key) is not None

    # -- queries -------------------------------------------------------------

    def generations(self) -> list[Generation]:
        return [
            Generation.from_dict(g) for g in self.read()["generations"]
        ]

    def get(self, instance_id: str) -> Generation | None:
        for g in self.generations():
            if g.instance_id == instance_id:
                return g
        return None

    def live(self) -> Generation | None:
        for g in reversed(self.generations()):
            if g.status == LIVE:
                return g
        return None

    def canary(self) -> Generation | None:
        for g in reversed(self.generations()):
            if g.status == CANARY:
                return g
        return None

    def bind_candidates(self) -> list[Generation]:
        """Generations a restarting server may bind, best first: the live
        one, then previously-live (retired) generations newest-first — the
        last-good fallback chain when a checksum refuses the head."""
        gens = self.generations()
        out = [g for g in reversed(gens) if g.status == LIVE]
        out.extend(g for g in reversed(gens) if g.status == RETIRED)
        return out

    # -- transitions (each one atomic manifest write) ------------------------

    def record(
        self,
        instance_id: str,
        status: str = STAGED,
        checksum: str | None = None,
        note: str = "",
    ) -> Generation:
        """Add (or re-checksum) a generation.  Computes the blob checksum
        when not given — the staging step that makes later corruption
        detectable.  Sharded checkpoints additionally record PER-PART
        checksums (one corrupt factor shard is named, not just detected),
        and the generation embeds the serving plan that the JAX package's
        ``run_train`` left beside a sharded model (see
        :func:`read_shard_plan`)."""
        if status not in STATUSES:
            raise LifecycleError(f"unknown generation status {status!r}")
        with self._lock:
            part_checksums = None
            if checksum is None:
                checksum, part_checksums = compute_checksums(
                    self.models_store, instance_id
                )
            shard_plan = read_shard_plan(self.models_store, instance_id)
            manifest = self.read()
            now = _now()
            entry = Generation(
                instance_id=instance_id,
                checksum=checksum,
                status=status,
                created_at=now,
                promoted_at=now if status == LIVE else None,
                part_checksums=part_checksums,
                shard_plan=shard_plan,
            )
            if note:
                entry.note = note
            gens = [
                g for g in manifest["generations"]
                if g["instance_id"] != instance_id
            ]
            if status == LIVE:
                for g in gens:
                    if g["status"] == LIVE:
                        g["status"] = RETIRED
            gens.append(entry.to_dict())
            manifest["generations"] = gens
            self._write(manifest)
            return entry

    def _transition(
        self, instance_id: str, from_statuses: tuple[str, ...], to: str,
        stamp: str | None = None, retire_live: bool = False, note: str = "",
    ) -> Generation:
        with self._lock:
            manifest = self.read()
            target = None
            for g in manifest["generations"]:
                if g["instance_id"] == instance_id:
                    target = g
                    break
            if target is None:
                raise LifecycleError(
                    f"generation {instance_id} not in manifest {self.engine_key}"
                )
            if from_statuses and target["status"] not in from_statuses:
                raise LifecycleError(
                    f"generation {instance_id} is {target['status']!r}; "
                    f"expected one of {from_statuses} to move to {to!r}"
                )
            if retire_live:
                for g in manifest["generations"]:
                    if g["status"] == LIVE and g["instance_id"] != instance_id:
                        g["status"] = RETIRED
            target["status"] = to
            if stamp:
                target[stamp] = _now()
            if note:
                target["note"] = note
            # ONE write is the commit point: a SIGKILL before this line
            # leaves the old manifest; after it, the new one — whole either
            # way
            self._write(manifest)
            return Generation.from_dict(target)

    def start_canary(self, instance_id: str) -> Generation:
        return self._transition(instance_id, (STAGED,), CANARY)

    def promote(self, instance_id: str, note: str = "") -> Generation:
        """Flip a canary (or staged, for direct /reload swaps) generation
        to live; the previous live retires in the same atomic write.
        Promoting the CURRENT live is a no-op (idempotent /reload), and a
        retired/rolled-back generation may be re-promoted — the operator's
        explicit flip-back path."""
        current = self.get(instance_id)
        if current is not None and current.status == LIVE:
            return current
        return self._transition(
            instance_id, (CANARY, STAGED, RETIRED, ROLLED_BACK), LIVE,
            stamp="promoted_at", retire_live=True, note=note,
        )

    def rollback(self, instance_id: str, note: str = "") -> Generation:
        """Abort a canary: the generation is marked rolled_back and the
        live one keeps serving untouched."""
        return self._transition(
            instance_id, (CANARY, STAGED), ROLLED_BACK,
            stamp="rolled_back_at", note=note,
        )

    def mark_corrupt(self, instance_id: str, reason: str = "") -> None:
        """Demote a generation whose bytes failed verification so the
        fallback walk never retries it.  Tolerates a missing entry (the
        manifest may predate the blob)."""
        try:
            self._transition(
                instance_id, (), ROLLED_BACK, stamp="rolled_back_at",
                note=f"corrupt: {reason}" if reason else "corrupt",
            )
        except LifecycleError:
            log.warning(
                "could not mark corrupt generation in manifest",
                extra={"instance": instance_id, "engine": self.engine_key},
            )

    # -- verification --------------------------------------------------------

    def verify(self, gen: Generation | str) -> None:
        """Recompute the stored-bytes checksum and compare; raises
        :class:`CorruptModelError` on mismatch or missing bytes.

        Generations recorded with per-part checksums verify part-by-part,
        so ONE corrupt factor shard is reported BY NAME (and still trips
        the same last-good fallback walk at bind time)."""
        if isinstance(gen, str):
            found = self.get(gen)
            if found is None:
                raise LifecycleError(
                    f"generation {gen} not in manifest {self.engine_key}"
                )
            gen = found
        if gen.part_checksums:
            actual_parts = compute_part_checksums(
                self.models_store, gen.instance_id
            )
            if actual_parts is not None:
                bad = sorted(
                    set(gen.part_checksums.items())
                    ^ set(actual_parts.items())
                )
                bad_names = sorted({name for name, _ in bad})
                if bad_names:
                    raise CorruptModelError(
                        f"model shards {bad_names} of generation "
                        f"{gen.instance_id} do not match their manifest "
                        "checksums — refusing to serve a corrupt model"
                    )
                return
            # layout changed under the manifest (sharded -> single blob):
            # fall through to the whole-bytes comparison below
        actual = compute_checksum(self.models_store, gen.instance_id)
        if actual != gen.checksum:
            raise CorruptModelError(
                f"model bytes for generation {gen.instance_id} do not match "
                f"the manifest checksum (stored {gen.checksum[:12]}…, "
                f"recomputed {actual[:12]}…) — refusing to serve a corrupt "
                "model"
            )

    def rollback_stats(self) -> dict[str, Any]:
        """Recent-rollback summary for status surfaces."""
        gens = self.generations()
        last_rb = max(
            (g.rolled_back_at or 0.0 for g in gens if g.status == ROLLED_BACK),
            default=None,
        )
        return {
            "rolled_back": sum(1 for g in gens if g.status == ROLLED_BACK),
            "last_rollback_at": last_rb,
        }

    def snapshot(self) -> dict[str, Any]:
        """The /lifecycle.json manifest half."""
        manifest = self.read()
        live = canary = live_plan = None
        for g in manifest["generations"]:
            if g["status"] == LIVE:
                live = g["instance_id"]
                live_plan = g.get("shard_plan")
            elif g["status"] == CANARY:
                canary = g["instance_id"]
        return {
            "engine": self.engine_key,
            "schema": manifest.get("schema", SCHEMA_VERSION),
            "live": live,
            "canary": canary,
            # the live generation's serving layout (mesh axes + per-array
            # specs) — what `pio status`/the dashboard show as "mesh shape"
            "shard_plan": live_plan,
            "generations": manifest["generations"],
            **self.rollback_stats(),
        }
