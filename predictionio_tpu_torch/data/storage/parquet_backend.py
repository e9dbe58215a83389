"""Partitioned columnar parquet event backend — the scalable event store.

The JAX package's ``data/storage/parquet_backend.py``, ported whole: the
same directory layout, schema, footer stats, seq clock, watermarks and
fault seams (``compact.fold``, ``compact.publish``), so a root written by
either package reads in the other to the same rows, ids, tombstones and
shard split.  Value-level factorization runs through arrow's hash kernel
(``dictionary_encode``) where the JAX package calls pandas; the port needs
no pandas, and this module and ``compactor.py`` are the only ones that
import pyarrow.

The reference's distributed event backends partition by an entity-hash row
key: HBase prefixes each row with ``MD5(entityType-entityId)`` so entities
spread uniformly and scans parallelize (storage/hbase/.../HBEventsUtil.scala:
83-131); JDBC partitions bulk scans by time range (JDBCPEvents.scala:33-79);
Elasticsearch shards server-side (ESLEvents.scala:41).  The equivalent
here is an **append-only parquet event log sharded by entity hash**:

    <root>/app_<appId>[_c<channelId>]/
        _meta.json                   # {"n_shards": N}
        shard=<k>/seg-<seq>.parquet  # write-hot segments, append-only
        shard=<k>/cseg-<w>.parquet   # compacted segment, watermark w
        _tombstones/del-<seq>.parquet# deleted event ids (app-global)

Write model: every insert/write appends new segments (no in-place update),
fanned out **concurrently across shards** on the client's thread pool.
Each row carries a monotonic ``seq``; reads dedup by ``event_id`` keeping
the highest seq (so re-inserting an existing id upserts, LEvents contract)
and drop ids whose latest op is a tombstone.

Compaction model (docs/data_plane.md): ``compact()`` folds the write-hot
segments at or below a **watermark** — the highest segment seq it saw —
into ONE ``cseg-<watermark>.parquet`` per shard, deduped, tombstoned, and
sorted by (entity, time) with small row groups, published with the
tmp + fsync + ``os.replace`` discipline.  Readers use only the newest
cseg plus hot segments *above* its watermark, so a SIGKILL between the
cseg publish and the source-segment unlink leaves every row readable
exactly once; the next compaction (or tick of the background
:class:`~predictionio_tpu_torch.data.storage.compactor.Compactor`) removes the
superseded files.

Read model: per-shard scans with predicate/column pushdown into the
pyarrow reader.  String columns are dictionary-encoded on disk (repeated
entities cost one dictionary entry, not N string copies) and decoded back
through the dictionary, so a 20M-row scan materializes ~vocabulary-many
Python strings instead of 20M per column.  ``LEvents`` point lookups with
an entity filter touch exactly one shard (the row-key benefit), skip
segments whose footer stats exclude the entity, and within a compacted
segment read only the row groups whose parquet statistics admit it —
``find_by_entity`` is fast enough to sit on the serving path.
``ParquetPEvents.iter_shards`` yields one EventFrame per shard so bulk
training scans never materialize the whole log, and multi-host workers
can each take a shard range (SURVEY §7 step 9).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import datetime, timezone
from heapq import merge as heap_merge
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pa_ds
import pyarrow.parquet as pq

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    EventFilter,
    EventFrame,
    LEvents,
    PEvents,
    entity_shard,  # canonical home is base.py (pyarrow-free); re-exported
    frame_shard_of,
    ptr_factorize,
    run_concurrent,
)
from predictionio_tpu_torch.data.storage.base import value_factorize
from predictionio_tpu_torch.data.storage.frame_codec import dictionary_to_objects
from predictionio_tpu_torch.obs.costs import note_storage_read
from predictionio_tpu_torch.resilience import faults

log = logging.getLogger("predictionio_tpu_torch.data.parquet")

DEFAULT_N_SHARDS = 16

#: row-group size for compacted segments: small enough that an entity
#: point read decodes one or two groups (<10 ms) and touches a small
#: fraction of the shard's bytes, large enough that per-group statistics
#: and dictionaries stay a negligible fraction of the file
COMPACT_ROW_GROUP = 16384

_SCHEMA = pa.schema(
    [
        ("event_id", pa.string()),
        ("seq", pa.int64()),
        ("event", pa.string()),
        ("entity_type", pa.string()),
        ("entity_id", pa.string()),
        ("target_entity_type", pa.string()),
        ("target_entity_id", pa.string()),
        ("event_time_ms", pa.int64()),
        ("creation_time_ms", pa.int64()),
        ("properties", pa.string()),  # JSON
        ("tags", pa.string()),  # JSON list
        ("pr_id", pa.string()),
    ]
)

_ALL_COLS = tuple(f.name for f in _SCHEMA)

#: EventFrame-facing columns (``seq`` is storage-internal)
FRAME_COLS = tuple(c for c in _ALL_COLS if c != "seq")

#: columns dictionary-encoded on disk when repetitive (entity vocabularies
#: are ~100x smaller than event counts at ML scale); ``event_id``/``pr_id``
#: stay plain — they are null or unique, so a dictionary is pure overhead
_DICT_COLS = frozenset(
    {
        "event",
        "entity_type",
        "entity_id",
        "target_entity_type",
        "target_entity_id",
        "properties",
        "tags",
    }
)

_TOMB_SCHEMA = pa.schema([("event_id", pa.string()), ("seq", pa.int64())])

#: parquet footer key carrying per-segment stats for segment skipping
_STATS_KEY = b"pio_seg"


def _to_ms(dt: datetime) -> int:
    return int(dt.timestamp() * 1000)


def _from_ms(ms: int) -> datetime:
    return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)


# ---------------------------------------------------------------------------
# Metrics (lazy: importing the backend must not build registry families for
# processes that never touch the event store)
# ---------------------------------------------------------------------------

_M: dict[str, Any] | None = None
_M_LOCK = threading.Lock()


def _metrics() -> dict[str, Any]:
    global _M
    if _M is None:
        with _M_LOCK:
            if _M is None:
                from predictionio_tpu_torch.obs.metrics import (
                    REGISTRY,
                    TRAIN_BUCKETS,
                )

                _M = {
                    "write_s": REGISTRY.histogram(
                        "pio_eventstore_write_seconds",
                        "Event-store write latency by kind (row|bulk)",
                        labelnames=("kind",),
                        buckets=TRAIN_BUCKETS,
                    ),
                    "rows_written": REGISTRY.counter(
                        "pio_eventstore_rows_written_total",
                        "Rows appended to the event store",
                    ),
                    "scan_s": REGISTRY.histogram(
                        "pio_eventstore_scan_seconds",
                        "Event-store read latency by kind "
                        "(full|shard|entity|id)",
                        labelnames=("kind",),
                        buckets=TRAIN_BUCKETS,
                    ),
                    "bytes_read": REGISTRY.counter(
                        "pio_eventstore_bytes_read_total",
                        "Segment bytes actually read, by scan kind",
                        labelnames=("kind",),
                    ),
                    "bytes_skipped": REGISTRY.counter(
                        "pio_eventstore_bytes_skipped_total",
                        "Segment bytes skipped via footer/row-group stats, "
                        "by scan kind",
                        labelnames=("kind",),
                    ),
                    "segments": REGISTRY.gauge(
                        "pio_eventstore_segments",
                        "Live segment files by state (hot|compacted)",
                        labelnames=("state",),
                    ),
                    "backlog": REGISTRY.gauge(
                        "pio_eventstore_compaction_backlog",
                        "Write-hot segments not yet folded below a "
                        "compaction watermark",
                    ),
                    "watermark_lag": REGISTRY.gauge(
                        "pio_eventstore_watermark_lag_seconds",
                        "Age of the oldest shard watermark (seconds since "
                        "that shard last compacted)",
                    ),
                    "compactions": REGISTRY.counter(
                        "pio_eventstore_compactions_total",
                        "Completed compaction passes",
                    ),
                    "compact_s": REGISTRY.histogram(
                        "pio_eventstore_compaction_seconds",
                        "Wall time of one compaction pass",
                        buckets=TRAIN_BUCKETS,
                    ),
                    "visibility_lag": REGISTRY.histogram(
                        "pio_event_visibility_lag_seconds",
                        "Event-to-visible lag: publish-to-compaction age of "
                        "each row folded out of the hot tier",
                        buckets=TRAIN_BUCKETS,
                    ),
                    "visibility_lag_p99": REGISTRY.gauge(
                        "pio_event_visibility_lag_p99_seconds",
                        "p99 of pio_event_visibility_lag_seconds (alertable "
                        "scalar mirror)",
                    ),
                    # the per-tenant split of the two families above: the
                    # fleet-global pair stays (dashboards + the default
                    # freshness_lag alert rule key on it); these carry the
                    # app label so one tenant's compaction backlog is
                    # attributable — and alertable — without implicating
                    # its neighbors
                    "visibility_lag_app": REGISTRY.histogram(
                        "pio_event_app_visibility_lag_seconds",
                        "Event-to-visible lag per app: publish-to-compaction "
                        "age of each row folded out of the hot tier",
                        labelnames=("app",),
                        buckets=TRAIN_BUCKETS,
                    ),
                    "visibility_lag_app_p99": REGISTRY.gauge(
                        "pio_event_app_visibility_lag_p99_seconds",
                        "p99 of pio_event_app_visibility_lag_seconds per app "
                        "(alertable scalar mirror)",
                        labelnames=("app",),
                    ),
                }
    return _M


class _SeqClock:
    """Strictly-increasing int64: ns timestamp, bumped on collision.

    ``reserve``/``release`` track seqs handed to writers whose segments
    are not yet published: a concurrent compaction must never set a
    watermark at or above an in-flight seq, or the segment published
    moments later would land at-or-below the watermark and be read as
    superseded — acked rows silently lost.  ``barrier()`` is the highest
    seq a fold may safely include."""

    def __init__(self):
        self._last = 0
        self._lock = threading.Lock()
        self._inflight: set[int] = set()

    def next(self) -> int:
        with self._lock:
            now = time.time_ns()
            self._last = max(self._last + 1, now)
            return self._last

    def reserve(self) -> int:
        with self._lock:
            now = time.time_ns()
            self._last = max(self._last + 1, now)
            self._inflight.add(self._last)
            return self._last

    def release(self, seq: int) -> None:
        with self._lock:
            self._inflight.discard(seq)

    def barrier(self) -> int:
        """Fold-safety horizon: strictly below every in-flight seq."""
        with self._lock:
            if not self._inflight:
                return 1 << 62  # nothing in flight: no bound
            return min(self._inflight) - 1


def acquire_root_ownership(root: str | Path):
    """Advisory EXCLUSIVE owner lock on a storage root (``flock`` on
    ``<root>/.pio_owner.lock``), or None when another process holds it.

    The fold-vs-ingest safety of compaction rests on the seq clock's
    in-flight reservations, which are per-process: a storage daemon takes
    this lock for its lifetime, and ``pio eventstore compact`` (local
    mode) refuses to fold a root whose owner is alive — the operator is
    pointed at the daemon's ``--url`` surface instead.  Best-effort on
    platforms without ``fcntl``."""
    path = Path(root) / ".pio_owner.lock"
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        # raw fd: this is a LOCK file, never written through — the
        # tmp+rename persistence discipline does not apply
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    except OSError:
        return None
    try:
        import fcntl

        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except ImportError:
        return _OwnerLock(fd)  # no flock here: best-effort pass-through
    except OSError:
        os.close(fd)
        return None
    return _OwnerLock(fd)


class _OwnerLock:
    """Holds the owner flock fd; ``close()`` releases it."""

    def __init__(self, fd: int):
        self._fd = fd

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None


class ParquetClient:
    """Root-directory handle shared by the L/P DAO pair.

    Owns the per-backend thread pool used to fan segment writes out
    across shards concurrently, and a footer-stats cache (segment files
    are immutable once published, so stats are cached by (path, size))."""

    def __init__(self, root: str | Path, n_shards: int = DEFAULT_N_SHARDS):
        self.root = Path(root)
        self.n_shards_default = n_shards
        self.seq = _SeqClock()
        self.root.mkdir(parents=True, exist_ok=True)
        self._pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self._stats_cache: dict[tuple[str, int], dict | None] = {}
        self._stats_lock = threading.Lock()
        #: tombstone map per app dir, keyed by the del-file listing
        #: signature — the serving-path point read must not re-decode
        #: every tombstone file per lookup
        self._tomb_cache: dict[str, tuple[tuple, dict[str, int]]] = {}
        #: one fold at a time per root: the manual surfaces (CLI, daemon
        #: route) and the background Compactor share this, so two folds
        #: never race each other's unlink loop
        self.compact_lock = threading.Lock()

    def pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(8, os.cpu_count() or 1),
                    thread_name_prefix="pio-pq",
                )
            return self._pool

    def app_dir(self, app_id: int, channel_id: int | None) -> Path:
        name = f"app_{app_id}" + (
            f"_c{channel_id}" if channel_id is not None else ""
        )
        return self.root / name

    def n_shards(self, app_dir: Path) -> int:
        meta = app_dir / "_meta.json"
        if meta.exists():
            return json.loads(meta.read_text())["n_shards"]
        return self.n_shards_default

    def init(self, app_id: int, channel_id: int | None) -> Path:
        d = self.app_dir(app_id, channel_id)
        d.mkdir(parents=True, exist_ok=True)
        meta = d / "_meta.json"
        if not meta.exists():
            # tmp + atomic replace: a crash mid-write must not leave a torn
            # _meta.json that breaks every later n_shards() read
            tmp = d / f"_meta.{os.getpid()}.tmp"
            tmp.write_text(json.dumps({"n_shards": self.n_shards_default}))
            os.replace(tmp, meta)
        return d

    def seg_stats(self, path: Path) -> dict | None:
        """Footer stats of a published segment (None when absent — e.g.
        segments written before the stats footer existed)."""
        try:
            size = path.stat().st_size
        except OSError:
            return None
        key = (str(path), size)
        with self._stats_lock:
            if key in self._stats_cache:
                return self._stats_cache[key]
        try:
            meta = pq.ParquetFile(path).metadata.metadata or {}
            raw = meta.get(_STATS_KEY)
            stats = json.loads(raw.decode("utf-8")) if raw else None
        except Exception:  # torn/foreign file: treat as stat-less
            stats = None
        with self._stats_lock:
            if len(self._stats_cache) > 65536:
                self._stats_cache.clear()  # unbounded growth guard
            self._stats_cache[key] = stats
        return stats

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


# ---------------------------------------------------------------------------
# Columnar conversion: pointer-identity dictionary encoding
# ---------------------------------------------------------------------------


def _arrow_factorize(col: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """(codes, uniques) by value through arrow's hash kernel, uniques in
    first-occurrence order with None rows folded into an explicit None
    slot; None when a row is not a string."""
    try:
        arr = pa.array(col, pa.string())
    except (pa.ArrowInvalid, pa.ArrowTypeError):
        return None
    d = arr.dictionary_encode()
    uniq = np.asarray(d.dictionary.to_numpy(zero_copy_only=False), object)
    if d.null_count:
        codes = pc.fill_null(d.indices, len(uniq))
        uniq = np.append(uniq, None)
    else:
        codes = d.indices
    return codes.to_numpy(zero_copy_only=False).astype(np.int64), uniq


def _factorize_col(
    col: np.ndarray, max_card_frac: float = 0.25
) -> tuple[np.ndarray, np.ndarray] | None:
    """(codes, uniques) via the cheap pointer pass, falling back to a
    value-level factorization, gated by a small sample so a genuinely
    high-cardinality column never pays a full wasted hash pass."""
    f = ptr_factorize(col, max_card_frac)
    if f is not None:
        return f
    n = len(col)
    if n > 8192:
        try:
            if len(set(col[:4096])) > 2048:
                return None  # mostly distinct by value too
        except TypeError:
            return None  # unhashable rows (raw dicts): caller's row path
    f = _arrow_factorize(col)
    if f is None or len(f[1]) > max(int(n * max_card_frac), 64):
        return None
    return f


def _codes_any(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, uniques) unconditionally: the cheap pointer pass when it
    collapses, else a full value-level factorization."""
    f = ptr_factorize(col)
    if f is not None:
        return f
    f = _arrow_factorize(col)
    return f if f is not None else value_factorize(col)


def _dict_from_codes(codes: np.ndarray, uniq: np.ndarray) -> pa.Array:
    """DictionaryArray from factorization output, None-values masked."""
    null_uniq = np.fromiter((v is None for v in uniq), bool, len(uniq))
    if null_uniq.any():
        uniq = uniq.copy()
        uniq[null_uniq] = ""  # masked rows never read the value
        idx = pa.array(codes.astype(np.int32), mask=null_uniq[codes])
    else:
        idx = pa.array(codes.astype(np.int32))
    return pa.DictionaryArray.from_arrays(idx, pa.array(uniq, pa.string()))


def _string_array(col: np.ndarray) -> pa.Array:
    """Object column -> arrow string or dictionary<string> array."""
    f = _factorize_col(col)
    if f is None:
        return pa.array(col, pa.string())
    return _dict_from_codes(*f)


def _json_array(col: np.ndarray | None, n: int, as_list: bool) -> pa.Array:
    """properties/tags column -> lazy-JSON string array, serializing each
    UNIQUE value once when the column is repetitive (ratings/tags take a
    handful of distinct documents at ML scale)."""
    if col is None:
        return pa.array(np.full(n, "", object), pa.string())

    def ser(v):
        if isinstance(v, str):
            return v  # already-serialized (lazy) row
        if not v:
            return ""
        return json.dumps(list(v) if as_list else v)

    f = _factorize_col(col)
    if f is not None:
        codes, uniq = f
        docs = np.array([ser(v) for v in uniq], object)
        return _dict_from_codes(codes, docs)
    out = np.empty(n, object)
    for i, v in enumerate(col):
        out[i] = ser(v)
    return pa.array(out, pa.string())


def _shard_codes(
    ft: tuple[np.ndarray, np.ndarray],
    fi: tuple[np.ndarray, np.ndarray],
    n_shards: int,
) -> np.ndarray:
    """Per-row shard index from the entity factorizations the arrow
    conversion already paid for — the pair-coding arithmetic itself has
    exactly one home, ``base.frame_shard_of``."""
    return frame_shard_of(None, None, n_shards, factorized=(ft, fi))


# ---------------------------------------------------------------------------
# Segment files
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SegInfo:
    """One published segment file of a shard."""

    path: Path
    seq: int  # hot: write seq; compacted: watermark
    compacted: bool
    size: int


def _list_segments(shard_dir: Path) -> tuple[list[SegInfo], list[SegInfo]]:
    """(compacted, hot), each sorted by seq ascending."""
    csegs: list[SegInfo] = []
    hots: list[SegInfo] = []
    try:
        entries = list(os.scandir(shard_dir))
    except OSError:
        return [], []
    for e in entries:
        name = e.name
        if not name.endswith(".parquet"):
            continue
        try:
            if name.startswith("cseg-"):
                csegs.append(
                    SegInfo(
                        Path(e.path), int(name[5:-8]), True, e.stat().st_size
                    )
                )
            elif name.startswith("seg-"):
                hots.append(
                    SegInfo(
                        Path(e.path), int(name[4:-8]), False, e.stat().st_size
                    )
                )
        except (ValueError, OSError):
            continue
    csegs.sort(key=lambda s: s.seq)
    hots.sort(key=lambda s: s.seq)
    return csegs, hots


def _active_segments(
    shard_dir: Path,
) -> tuple[SegInfo | None, list[SegInfo], list[SegInfo], int]:
    """(newest cseg, hot segments above its watermark, superseded files,
    watermark).  The newest cseg supersedes every older cseg AND every hot
    segment at or below its watermark — this is what makes the
    publish-then-unlink compaction sequence crash-safe: whichever subset
    of unlinks survived a SIGKILL, each row is readable exactly once."""
    csegs, hots = _list_segments(shard_dir)
    cseg = csegs[-1] if csegs else None
    w = cseg.seq if cseg is not None else -1
    live_hot = [s for s in hots if s.seq > w]
    superseded = csegs[:-1] + [s for s in hots if s.seq <= w]
    return cseg, live_hot, superseded, w


def _localize_dicts(t: pa.Table) -> pa.Table:
    """Re-encode dictionary columns against THIS table's values only.

    A dictionary-typed arrow column writes its ENTIRE dictionary as the
    dictionary page of every parquet row group it spans — a point read of
    one 64k-row group would decode the full 139k-entity vocabulary.  A
    compacted segment therefore writes each row group with a dictionary
    trimmed to the values that group actually contains."""
    for i, name in enumerate(t.column_names):
        col = t.column(i)
        if pa.types.is_dictionary(col.type):
            enc = pc.dictionary_encode(col.cast(pa.string()))
            t = t.set_column(i, pa.field(name, enc.type), enc)
    return t


def _publish_segment(
    shard_dir: Path,
    final_name: str,
    table: pa.Table,
    stats: dict,
    row_group_size: int | None = None,
) -> None:
    """tmp + fsync + os.replace publish with footer stats.

    With ``row_group_size`` set (compacted segments), each row group is
    written from a slice with a localized dictionary so entity point
    reads never decode the whole vocabulary."""
    shard_dir.mkdir(parents=True, exist_ok=True)
    table = table.replace_schema_metadata(
        {_STATS_KEY: json.dumps(stats).encode("utf-8")}
    )
    tmp = shard_dir / f".{final_name}.{uuid.uuid4().hex}.tmp"
    try:
        if row_group_size is None:
            pq.write_table(table, tmp, compression="zstd")
        else:
            schema = _localize_dicts(table.slice(0, 0)).schema
            with pq.ParquetWriter(tmp, schema, compression="zstd") as w:
                for off in range(0, max(table.num_rows, 1), row_group_size):
                    sl = table.slice(off, row_group_size)
                    if sl.num_rows:
                        w.write_table(_localize_dicts(sl.combine_chunks()))
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, shard_dir / final_name)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def _segment_stats(table: pa.Table) -> dict:
    """Footer stats for segment skipping: entity/time min-max + whether
    every event_id is null (bulk-ingest rows, which never need dedup)."""
    n = table.num_rows
    stats: dict[str, Any] = {"rows": n}
    if n:
        ent = table.column("entity_id")
        if pa.types.is_dictionary(ent.type):
            ent = ent.cast(pa.string())
        mm = pc.min_max(ent).as_py()
        stats["entity_min"], stats["entity_max"] = mm["min"], mm["max"]
        mm = pc.min_max(table.column("event_time_ms")).as_py()
        stats["time_min"], stats["time_max"] = mm["min"], mm["max"]
        stats["all_null_ids"] = (
            table.column("event_id").null_count == n
        )
    return stats


def _canon(t: pa.Table) -> pa.Table:
    """Normalize a segment table to the canonical column encodings so
    tables from old (plain-string) and new (dictionary) segments concat:
    dictionary-encode the repetitive columns, keep id columns plain."""
    if "shard" in t.column_names:  # stray column from pre-seed compacts
        t = t.drop(["shard"])
    for i, name in enumerate(t.column_names):
        col = t.column(i)
        if name in _DICT_COLS and pa.types.is_string(col.type):
            enc = pc.dictionary_encode(col)
            t = t.set_column(i, pa.field(name, enc.type), enc)
        elif name not in _DICT_COLS and pa.types.is_dictionary(col.type):
            t = t.set_column(
                i, pa.field(name, pa.string()), col.cast(pa.string())
            )
    return t


def _read_segment(
    path: Path, columns: Sequence[str], expr=None
) -> pa.Table:
    """One segment with column projection and (optional) predicate
    pushdown.  Uses the dataset API with NO partitioning so the
    ``shard=<k>/`` path never hive-infers a phantom column, and row
    groups whose parquet statistics refute the predicate are skipped."""
    dset = pa_ds.dataset(str(path), format="parquet")
    return _canon(dset.to_table(columns=list(columns), filter=expr))


def _write_segment(shard_dir: Path, rows: list[dict], seq: int) -> None:
    """Write one hot segment from row dicts (the row-path unit; kept as a
    seam for tests that fabricate legacy segments)."""
    table = pa.Table.from_pylist(rows, schema=_SCHEMA)
    _publish_segment(
        shard_dir, f"seg-{seq}.parquet", _canon(table), _segment_stats(table)
    )


def _event_row(e: Event, seq: int, event_id: str) -> dict:
    return {
        "event_id": event_id,
        "seq": seq,
        "event": e.event,
        "entity_type": e.entity_type,
        "entity_id": e.entity_id,
        "target_entity_type": e.target_entity_type,
        "target_entity_id": e.target_entity_id,
        "event_time_ms": _to_ms(e.event_time),
        "creation_time_ms": _to_ms(e.creation_time),
        "properties": json.dumps(e.properties.fields) if e.properties.fields else "",
        "tags": json.dumps(list(e.tags)) if e.tags else "",
        "pr_id": e.pr_id,
    }


def _filter_expression(f: EventFilter | None):
    """Compile the EventFilter algebra to a pyarrow dataset predicate
    (everything except limit/reversed, which apply post-sort)."""
    if f is None:
        return None
    exprs = []
    fld = pc.field
    if f.start_time is not None:
        exprs.append(fld("event_time_ms") >= _to_ms(f.start_time))
    if f.until_time is not None:
        exprs.append(fld("event_time_ms") < _to_ms(f.until_time))
    if f.entity_type is not None:
        exprs.append(fld("entity_type") == f.entity_type)
    if f.entity_id is not None:
        exprs.append(fld("entity_id") == f.entity_id)
    if f.event_names is not None:
        exprs.append(fld("event").isin(list(f.event_names)))
    if f.target_entity_type is not None:
        want = f.target_entity_type or None
        exprs.append(
            fld("target_entity_type") == want
            if want is not None
            else fld("target_entity_type").is_null()
        )
    if f.target_entity_id is not None:
        want = f.target_entity_id or None
        exprs.append(
            fld("target_entity_id") == want
            if want is not None
            else fld("target_entity_id").is_null()
        )
    out = None
    for e in exprs:
        out = e if out is None else out & e
    return out


def _filter_columns(f: EventFilter | None) -> set[str]:
    """Columns a filter expression reads (needed when the predicate must
    run AFTER dedup on a projected read)."""
    if f is None:
        return set()
    cols = set()
    if f.start_time is not None or f.until_time is not None:
        cols.add("event_time_ms")
    if f.entity_type is not None:
        cols.add("entity_type")
    if f.entity_id is not None:
        cols.add("entity_id")
    if f.event_names is not None:
        cols.add("event")
    if f.target_entity_type is not None:
        cols.add("target_entity_type")
    if f.target_entity_id is not None:
        cols.add("target_entity_id")
    return cols


class ParquetEventStore:
    """Shared scan/mutation engine for the L and P DAO facades."""

    def __init__(self, client: ParquetClient):
        self.client = client

    # -- namespace lifecycle -------------------------------------------------
    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        self.client.init(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        d = self.client.app_dir(app_id, channel_id)
        if d.exists():
            shutil.rmtree(d)
            return True
        return False

    # -- writes --------------------------------------------------------------
    def append_events(
        self, events: Sequence[Event], app_id: int, channel_id: int | None
    ) -> list[str]:
        t0 = time.perf_counter()
        d = self.client.init(app_id, channel_id)
        n_shards = self.client.n_shards(d)
        by_shard: dict[int, list[dict]] = {}
        ids = []
        # reserved until published: a concurrent fold must not watermark
        # past this seq while the segments are still in flight
        seq = self.client.seq.reserve()
        try:
            for e in events:
                # Generate an id when the caller didn't supply one,
                # mirroring SQLiteLEvents.insert and the per-event UUID
                # baked into the HBase rowkey (HBEventsUtil.scala:83-131)
                # — without it every anonymous insert would collide on a
                # null id.
                eid = e.event_id or uuid.uuid4().hex
                shard = entity_shard(e.entity_type, e.entity_id, n_shards)
                by_shard.setdefault(shard, []).append(
                    _event_row(e, seq, eid)
                )
                ids.append(eid)

            def write_one(shard: int, rows: list[dict]) -> None:
                table = pa.Table.from_pylist(rows, schema=_SCHEMA)
                _publish_segment(
                    d / f"shard={shard}",
                    f"seg-{seq}.parquet",
                    _canon(table),
                    _segment_stats(table),
                )

            self._fan_out(
                [(write_one, (k, rows)) for k, rows in by_shard.items()]
            )
        finally:
            self.client.seq.release(seq)
        m = _metrics()
        m["write_s"].labels("row").observe(time.perf_counter() - t0)
        m["rows_written"].inc(len(ids))
        return ids

    def _fan_out(self, calls: list[tuple[Any, tuple]]) -> None:
        """Run per-shard segment writes concurrently on the client pool
        (parquet encode releases the GIL); a single write stays inline."""
        run_concurrent(
            self.client.pool(),
            [(lambda fn=fn, args=args: fn(*args)) for fn, args in calls],
        )

    def append_frame(
        self, frame, app_id: int, channel_id: int | None
    ) -> None:
        """Columnar bulk write: per-shard arrow tables built straight from
        the EventFrame's numpy columns — no per-event Python objects.

        This is the Spark-bulk-write role (JDBCPEvents.write:96,
        HBPEvents.scala:80) at the scale the reference handles.  Repetitive
        string columns (bulk ingest builds them as ``vocabulary[codes]``)
        are dictionary-encoded by pointer identity, the frame is split into
        shards by ONE counting sort instead of n_shards mask filters, and
        the per-shard segment writes fan out on the client thread pool.
        Rows without ids are written with a NULL event_id (the "legacy
        data" class the dedup logic treats as always-distinct) — bulk-
        imported analytics streams don't pay 20M uuid4 calls; point-
        mutation callers go through append_events.
        """
        n = len(frame)
        if n == 0:
            return
        t0 = time.perf_counter()
        d = self.client.init(app_id, channel_id)
        n_shards = self.client.n_shards(d)
        # reserved until published: a concurrent fold must not watermark
        # past this seq while the conversion below is still running
        seq = self.client.seq.reserve()
        try:
            self._append_frame_reserved(frame, d, n_shards, seq, n)
        finally:
            self.client.seq.release(seq)
        m = _metrics()
        m["write_s"].labels("bulk").observe(time.perf_counter() - t0)
        m["rows_written"].inc(n)

    def _append_frame_reserved(
        self, frame, d: Path, n_shards: int, seq: int, n: int
    ) -> None:
        ctimes = (
            frame.creation_time_ms
            if frame.creation_time_ms is not None
            else frame.event_time_ms
        )
        # factorize the entity columns ONCE, shared between the arrow
        # conversion and the shard hashing below.  Conversions run
        # concurrently on the client pool: the pointer-level factorize
        # hashes int64 arrays with the GIL released, so independent
        # columns genuinely overlap (~3x at 20M rows)
        pool = self.client.pool()
        f_ft = pool.submit(_codes_any, frame.entity_type)
        f_fi = pool.submit(_codes_any, frame.entity_id)
        conv = {
            "event": pool.submit(_string_array, frame.event),
            "target_entity_type": pool.submit(
                _string_array, frame.target_entity_type
            ),
            "target_entity_id": pool.submit(
                _string_array, frame.target_entity_id
            ),
            "properties": pool.submit(
                _json_array, frame.properties, n, False
            ),
            "tags": pool.submit(_json_array, frame.tags, n, True),
        }

        def entity_arr(f: tuple, col: np.ndarray) -> pa.Array:
            codes, uniq = f
            if len(uniq) * 4 > max(n, 256):
                return pa.array(col, pa.string())
            return _dict_from_codes(codes, uniq)

        ft, fi = f_ft.result(), f_fi.result()
        arrays = {
            "event_id": (
                pa.array(frame.event_id, pa.string())
                if frame.event_id is not None
                else pa.nulls(n, pa.string())
            ),
            "seq": pa.array(np.full(n, seq, np.int64)),
            "event": conv["event"].result(),
            "entity_type": entity_arr(ft, frame.entity_type),
            "entity_id": entity_arr(fi, frame.entity_id),
            "target_entity_type": conv["target_entity_type"].result(),
            "target_entity_id": conv["target_entity_id"].result(),
            "event_time_ms": pa.array(
                np.ascontiguousarray(frame.event_time_ms, np.int64)
            ),
            "creation_time_ms": pa.array(
                np.ascontiguousarray(ctimes, np.int64)
            ),
            "properties": conv["properties"].result(),
            "tags": conv["tags"].result(),
            "pr_id": (
                pa.array(frame.pr_id, pa.string())
                if frame.pr_id is not None
                else pa.nulls(n, pa.string())
            ),
        }
        table = pa.table({name: arrays[name] for name in _ALL_COLS})

        # ONE radix sort groups rows by shard; per-shard slices are then
        # gathered + encoded concurrently (take on dictionary columns moves
        # int32 codes, not strings)
        shard_of = _shard_codes(ft, fi, n_shards)
        order = np.argsort(shard_of.astype(np.int16), kind="stable")
        counts = np.bincount(shard_of, minlength=n_shards)
        offs = np.concatenate(([0], np.cumsum(counts)))

        def write_one(k: int, idx: np.ndarray) -> None:
            sub = table.take(pa.array(idx))
            _publish_segment(
                d / f"shard={k}",
                f"seg-{seq}.parquet",
                sub,
                _segment_stats(sub),
            )

        self._fan_out(
            [
                (write_one, (k, order[offs[k]:offs[k + 1]]))
                for k in range(n_shards)
                if counts[k]
            ]
        )

    def append_tombstones(
        self, event_ids: Sequence[str], app_id: int, channel_id: int | None
    ) -> None:
        d = self.client.init(app_id, channel_id)
        tomb = d / "_tombstones"
        tomb.mkdir(parents=True, exist_ok=True)
        seq = self.client.seq.next()
        table = pa.Table.from_pylist(
            [{"event_id": i, "seq": seq} for i in event_ids],
            schema=_TOMB_SCHEMA,
        )
        tmp = tomb / f".del-{seq}.parquet.tmp"
        pq.write_table(table, tmp)
        tmp.rename(tomb / f"del-{seq}.parquet")

    # -- reads ---------------------------------------------------------------
    def _tombstones(self, d: Path) -> dict[str, int]:
        """id -> newest deletion seq, cached against the del-file listing
        (tombstone files are immutable; the set only grows or gets
        pruned, so the (name, size) signature is a sound cache key)."""
        tomb = d / "_tombstones"
        files: list[Path] = []
        sig: list[tuple[str, int]] = []
        try:
            for e in sorted(os.scandir(tomb), key=lambda e: e.name):
                if e.name.startswith("del-") and e.name.endswith(".parquet"):
                    files.append(Path(e.path))
                    sig.append((e.name, e.stat().st_size))
        except OSError:
            return {}
        key = str(tomb)
        sig_t = tuple(sig)
        cl = self.client
        with cl._stats_lock:
            hit = cl._tomb_cache.get(key)
            if hit is not None and hit[0] == sig_t:
                return hit[1]
        out: dict[str, int] = {}
        for f in files:
            t = pq.ParquetFile(f).read(columns=["event_id", "seq"])
            for eid, seq in zip(
                t.column("event_id").to_pylist(), t.column("seq").to_pylist()
            ):
                out[eid] = max(out.get(eid, 0), seq)
        with cl._stats_lock:
            if len(cl._tomb_cache) > 1024:
                cl._tomb_cache.clear()
            cl._tomb_cache[key] = (sig_t, out)
        return out

    @staticmethod
    def _apply_tombstones(t: pa.Table, tombs: dict[str, int]) -> pa.Table:
        """Drop rows whose id's latest op is a deletion.  Tombstones touch
        only their own ids: the Python loop runs over candidate rows only
        (deletions are sparse relative to the scan)."""
        if not tombs or not t.num_rows:
            return t
        ids_col = t.column("event_id").combine_chunks()
        cand = pc.fill_null(
            pc.is_in(ids_col, value_set=pa.array(list(tombs.keys()))), False
        ).to_numpy(zero_copy_only=False)
        cand_idx = np.flatnonzero(cand)
        if not len(cand_idx):
            return t
        keep = np.ones(t.num_rows, dtype=bool)
        seqs_col = t.column("seq")
        for i in cand_idx:
            eid = ids_col[int(i)].as_py()
            if tombs[eid] >= seqs_col[int(i)].as_py():
                keep[i] = False  # deleted
        return t if keep.all() else t.filter(pa.array(keep))

    @staticmethod
    def _dedup_newest_wins(t: pa.Table) -> pa.Table:
        """Newest-wins dedup by event_id: an upsert whose latest version
        no longer matches a filter must hide its superseded versions too
        (INSERT OR REPLACE semantics), so the winner per id is decided on
        unfiltered rows.  Null-id rows (legacy/bulk data) are always
        distinct — never collapsed against each other."""
        n = t.num_rows
        if n <= 1:
            return t
        ids_col = t.column("event_id")
        if ids_col.null_count == n:
            return t  # bulk-ingest store: every row is its own group
        order = pc.sort_indices(
            t, sort_keys=[("event_id", "ascending"), ("seq", "descending")]
        )
        t = t.take(order)
        ids_col = t.column("event_id").combine_chunks()
        keep = np.ones(n, dtype=bool)
        # Vectorized newest-wins: after the sort, an older duplicate is a
        # row whose id equals its predecessor's.  Arrow's kernels do the
        # shifted compare in C; null-id rows never equal anything
        # (pc.equal yields null -> filled False), so they stay distinct.
        dup = pc.fill_null(
            pc.equal(ids_col.slice(1), ids_col.slice(0, n - 1)), False
        )
        keep[1:] = ~dup.to_numpy(zero_copy_only=False)
        return t if keep.all() else t.filter(pa.array(keep))

    def _read_columns(
        self,
        columns: Sequence[str] | None,
        filter: EventFilter | None,
        need_merge: bool,
    ) -> tuple[list[str], bool]:
        """(columns to read, projected?) — a projected read must still
        carry the dedup/tombstone keys and the filter's own columns when
        the predicate can only run post-dedup."""
        if columns is None:
            return list(_ALL_COLS), False
        want = {"event", *columns}
        if need_merge:
            want |= {"event_id", "seq"}
            want |= _filter_columns(filter)
        ordered = [c for c in _ALL_COLS if c in want]
        return ordered, True

    def _shard_table(
        self,
        shard_dir: Path,
        filter: EventFilter | None,
        tombs: dict[str, int],
        pre_filter=None,
        columns: Sequence[str] | None = None,
        kind: str = "shard",
        max_seq: int | None = None,
        bill: bool = True,
    ) -> pa.Table | None:
        """Read one shard: compacted segment + write-hot head, newest-wins
        dedup, tombstones, then filter.

        ``pre_filter`` is an optional predicate that is provably safe to
        apply BEFORE dedup (it must select whole event_id groups, e.g. an
        event_id equality) — point lookups use it so they never dedup the
        full shard.  The filter expression itself pushes down into the
        parquet reads whenever that is provably equivalent: always for the
        compacted segment (it is already deduped; the hot head decides
        winners independently), and for hot segments only when every hot
        row carries a null id (bulk-ingest stores, where each row is its
        own dedup group)."""
        cseg, hots, _, _ = _active_segments(shard_dir)
        if max_seq is not None:  # fold reads stop at the in-flight barrier
            hots = [s for s in hots if s.seq <= max_seq]
        if cseg is None and not hots:
            return None
        expr = _filter_expression(filter)
        read_bytes = 0
        m = _metrics()

        hot_stats = [self.client.seg_stats(s.path) for s in hots]
        hot_null_ids = all(
            st is not None and st.get("all_null_ids") for st in hot_stats
        )
        hot_push = hot_null_ids and not tombs
        need_merge = not hot_null_ids or bool(tombs) or (
            cseg is not None and hots
        )
        cols, projected = self._read_columns(columns, filter, need_merge)

        def seg_filter(seg_stats: dict | None) -> bool:
            """Footer-level segment skipping against the time window (the
            entity check has its own path in read_entity)."""
            if seg_stats is None or filter is None:
                return True
            tmin, tmax = seg_stats.get("time_min"), seg_stats.get("time_max")
            if tmin is None or tmax is None:
                return True
            if filter.start_time is not None and tmax < _to_ms(filter.start_time):
                return False
            if filter.until_time is not None and tmin >= _to_ms(filter.until_time):
                return False
            return True

        pre = pre_filter
        if pre is not None and expr is not None and hot_push:
            hot_expr = pre & expr
        elif pre is not None:
            hot_expr = pre
        elif hot_push:
            hot_expr = expr
        else:
            hot_expr = None

        parts: list[pa.Table] = []
        hot_claim_ids = None
        # footer time-window skipping applies to hot segments ONLY when
        # every hot row carries a null id: a skipped id-bearing segment
        # could hold the NEWEST version of an event whose superseded
        # cseg copy would then escape the claim step and resurrect
        if hot_null_ids:
            live_hots = [
                s for s, st in zip(hots, hot_stats) if seg_filter(st)
            ]
        else:
            live_hots = hots
        skipped = sum(s.size for s in hots) - sum(s.size for s in live_hots)
        if live_hots:
            hot_tables = [
                _read_segment(s.path, cols, hot_expr) for s in live_hots
            ]
            read_bytes += sum(s.size for s in live_hots)
            hot_t = (
                hot_tables[0]
                if len(hot_tables) == 1
                else pa.concat_tables(hot_tables)
            )
            if not hot_push:
                hot_t = self._dedup_newest_wins(hot_t)
                hot_t = self._apply_tombstones(hot_t, tombs)
                if not hot_null_ids:
                    # claim ids BEFORE the predicate: a superseded
                    # compacted version must stay hidden even when its
                    # replacement no longer matches the filter
                    hot_claim_ids = (
                        hot_t.column("event_id").combine_chunks().drop_null()
                    )
                if expr is not None and hot_t.num_rows:
                    hot_t = hot_t.filter(expr)
            if hot_t.num_rows:
                parts.append(hot_t)

        if cseg is not None and seg_filter(self.client.seg_stats(cseg.path)):
            cexpr = expr if pre is None else (
                pre if expr is None else pre & expr
            )
            ct = _read_segment(cseg.path, cols, cexpr)
            read_bytes += cseg.size
            if ct.num_rows:
                # the hot head claims its ids: a re-inserted id supersedes
                # the compacted version (tombstones folded at/below the
                # watermark are already applied inside the cseg; newer
                # tombstones apply here)
                if hot_claim_ids is not None and len(hot_claim_ids):
                    claimed = pc.fill_null(
                        pc.is_in(
                            ct.column("event_id"), value_set=hot_claim_ids
                        ),
                        False,
                    )
                    ct = ct.filter(pc.invert(claimed))
                ct = self._apply_tombstones(ct, tombs)
                if ct.num_rows:
                    parts.append(ct)
        elif cseg is not None:
            skipped += cseg.size

        m["bytes_read"].labels(kind).inc(read_bytes)
        if bill:
            # on the thread that asked for the scan, once per shard read:
            # a pool thread sees no request or wave scope (``bill=False``
            # for the compaction's folds, which run there)
            note_storage_read(read_bytes)
        if skipped:
            m["bytes_skipped"].labels(kind).inc(skipped)
        if not parts:
            return None
        t = parts[0] if len(parts) == 1 else pa.concat_tables(parts)
        if projected and columns is not None:
            keep = [c for c in t.column_names if c in set(columns) | {"event"}]
            t = t.select(keep)
        return t if t.num_rows else None

    def shard_dirs(
        self, app_id: int, channel_id: int | None
    ) -> list[tuple[int, Path]]:
        d = self.client.app_dir(app_id, channel_id)
        if not d.exists():
            return []
        n = self.client.n_shards(d)
        return [(k, d / f"shard={k}") for k in range(n)]

    def scan_shards(
        self,
        app_id: int,
        channel_id: int | None,
        filter: EventFilter | None = None,
        shards: Sequence[int] | None = None,
        columns: Sequence[str] | None = None,
    ) -> Iterator[tuple[int, pa.Table]]:
        """Yield (shard index, deduped arrow table) per non-empty shard.

        When the filter pins an entity, only its home shard is read —
        through the row-group-skipping entity path."""
        d = self.client.app_dir(app_id, channel_id)
        if not d.exists():
            return
        n = self.client.n_shards(d)
        if (
            filter is not None
            and filter.entity_type is not None
            and filter.entity_id is not None
        ):
            home = entity_shard(filter.entity_type, filter.entity_id, n)
            if shards is None or home in shards:
                t = self.read_entity(
                    app_id,
                    channel_id,
                    filter.entity_type,
                    filter.entity_id,
                    filter=filter,
                    columns=columns,
                )
                if t is not None:
                    yield home, t
            return
        t0 = time.perf_counter()
        tombs = self._tombstones(d)
        kind = "shard" if shards is not None else "full"
        for k, shard_dir in self.shard_dirs(app_id, channel_id):
            if shards is not None and k not in shards:
                continue
            t = self._shard_table(
                shard_dir, filter, tombs, columns=columns, kind=kind
            )
            if t is not None:
                yield k, t
        _metrics()["scan_s"].labels(kind).observe(time.perf_counter() - t0)

    def read_entity(
        self,
        app_id: int,
        channel_id: int | None,
        entity_type: str,
        entity_id: str,
        filter: EventFilter | None = None,
        columns: Sequence[str] | None = None,
    ) -> pa.Table | None:
        """Per-entity history read — the serving-path access pattern.

        Touches only the entity's home shard; skips segments whose footer
        stats exclude the entity; within the compacted segment (sorted by
        entity) reads only the row groups whose parquet statistics admit
        it.  The write-hot head is read in full (it is bounded by the
        compaction watermark) so upsert/tombstone semantics stay exact."""
        t0 = time.perf_counter()
        d = self.client.app_dir(app_id, channel_id)
        if not d.exists():
            return None
        n = self.client.n_shards(d)
        home = entity_shard(entity_type, entity_id, n)
        shard_dir = d / f"shard={home}"
        cseg, hots, _, _ = _active_segments(shard_dir)
        if cseg is None and not hots:
            return None
        tombs = self._tombstones(d)
        if filter is None or filter.entity_id != entity_id:
            filter = EventFilter(entity_type=entity_type, entity_id=entity_id)
        expr = _filter_expression(filter)
        cols, projected = self._read_columns(columns, filter, True)
        m = _metrics()
        read_bytes = 0
        skipped = 0

        def admits(seg: SegInfo) -> bool:
            st = self.client.seg_stats(seg.path)
            if st is None:
                return True
            emin, emax = st.get("entity_min"), st.get("entity_max")
            if emin is None or emax is None:
                return st.get("rows", 1) > 0
            return emin <= entity_id <= emax

        parts: list[pa.Table] = []
        hot_t = None
        hot_null_ids = True
        # entity-range skipping of hot segments needs the same guard as
        # the time-window case: an id-bearing hot segment outside the
        # probe's entity range may still hold the upsert that supersedes
        # an in-range cseg row — its claim must be seen
        stats_null = all(
            (st := self.client.seg_stats(s.path)) is not None
            and st.get("all_null_ids")
            for s in hots
        )
        live_hots = [s for s in hots if admits(s)] if stats_null else hots
        skipped += sum(s.size for s in hots) - sum(s.size for s in live_hots)
        if live_hots:
            # full read of the bounded hot head: dedup groups stay whole
            hot_tables = [
                _read_segment(s.path, cols) for s in live_hots
            ]
            read_bytes += sum(s.size for s in live_hots)
            hot_t = (
                hot_tables[0]
                if len(hot_tables) == 1
                else pa.concat_tables(hot_tables)
            )
            hot_null_ids = (
                hot_t.column("event_id").null_count == hot_t.num_rows
            )
            if not hot_null_ids:
                hot_t = self._dedup_newest_wins(hot_t)
            hot_t = self._apply_tombstones(hot_t, tombs)
            ht = hot_t.filter(expr) if expr is not None else hot_t
            if ht.num_rows:
                parts.append(ht)

        if cseg is not None and admits(cseg):
            ct, nbytes, nskip = self._read_entity_rowgroups(
                cseg.path, entity_id, cols
            )
            read_bytes += nbytes
            skipped += nskip
            if ct.num_rows:
                ct = ct.filter(expr)
            if ct.num_rows:
                if (
                    hot_t is not None
                    and hot_t.num_rows
                    and not hot_null_ids
                ):
                    hot_ids = hot_t.column("event_id").drop_null()
                    if len(hot_ids):
                        claimed = pc.fill_null(
                            pc.is_in(ct.column("event_id"), value_set=hot_ids),
                            False,
                        )
                        ct = ct.filter(pc.invert(claimed))
                ct = self._apply_tombstones(ct, tombs)
                if ct.num_rows:
                    parts.append(ct)
        elif cseg is not None:
            skipped += cseg.size

        m["bytes_read"].labels("entity").inc(read_bytes)
        note_storage_read(read_bytes)
        m["bytes_skipped"].labels("entity").inc(skipped)
        m["scan_s"].labels("entity").observe(time.perf_counter() - t0)
        if not parts:
            return None
        t = parts[0] if len(parts) == 1 else pa.concat_tables(parts)
        if projected and columns is not None:
            keep = [c for c in t.column_names if c in set(columns) | {"event"}]
            t = t.select(keep)
        return t if t.num_rows else None

    @staticmethod
    def _read_entity_rowgroups(
        path: Path, entity_id: str, cols: Sequence[str]
    ) -> tuple[pa.Table, int, int]:
        """(matching rows of one compacted segment, bytes read, bytes
        skipped) — row groups whose entity_id statistics refute the
        lookup are never decoded; byte accounting is per column chunk so
        the ``pio_eventstore_bytes_*`` counters prove the skipping."""
        pf = pq.ParquetFile(path)
        md = pf.metadata
        names = pf.schema_arrow.names
        ent_idx = names.index("entity_id")
        col_idx = [names.index(c) for c in cols if c in names]
        keep: list[int] = []
        nbytes = 0
        nskip = 0
        for g in range(md.num_row_groups):
            rg = md.row_group(g)
            st = rg.column(ent_idx).statistics
            group_bytes = sum(
                rg.column(j).total_compressed_size for j in col_idx
            )
            if (
                st is not None
                and st.has_min_max
                and not (st.min <= entity_id <= st.max)
            ):
                nskip += group_bytes
                continue
            keep.append(g)
            nbytes += group_bytes
        if not keep:
            return pf.schema_arrow.empty_table().select(list(cols)), 0, nskip
        t = pf.read_row_groups(keep, columns=list(cols))
        return (
            _canon(t.filter(pc.field("entity_id") == entity_id)),
            nbytes,
            nskip,
        )

    def get_by_id(
        self, event_id: str, app_id: int, channel_id: int | None
    ) -> pa.Table | None:
        d = self.client.app_dir(app_id, channel_id)
        if not d.exists():
            return None
        tombs = self._tombstones(d)
        # id equality selects a whole dedup group, so it can run before the
        # dedup pass — point lookups stay O(matching rows), not O(shard).
        pre = pc.field("event_id") == event_id
        for _, shard_dir in self.shard_dirs(app_id, channel_id):
            t = self._shard_table(
                shard_dir, None, tombs, pre_filter=pre, kind="id"
            )
            if t is not None:
                return t
        return None

    # -- maintenance ---------------------------------------------------------
    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        """Fold hot segments + tombstones into one sorted, deduped
        ``cseg-<watermark>`` per shard; returns the number of live rows.
        Idempotent and crash-safe: every publish is tmp+fsync+replace, and
        a SIGKILL at any point leaves each row readable exactly once (the
        newest cseg supersedes everything at or below its watermark).  The
        shards fold concurrently on the client pool (arrow's read, sort and
        encode release the GIL; each shard's fold is independent), and the
        tombstones are pruned once every fold has ended."""
        d = self.client.app_dir(app_id, channel_id)
        if not d.exists():
            return 0
        t0 = time.perf_counter()
        with self.client.compact_lock:
            tombs = self._tombstones(d)
            total = sum(
                run_concurrent(
                    self.client.pool(),
                    [
                        (
                            lambda sd=shard_dir: self._compact_shard(
                                sd, tombs, app_label=str(app_id)
                            )
                        )
                        for _, shard_dir in self.shard_dirs(app_id, channel_id)
                    ],
                )
            )
            self._prune_tombstones(d)
        m = _metrics()
        m["compactions"].inc()
        m["compact_s"].observe(time.perf_counter() - t0)
        return total

    def _compact_shard(
        self,
        shard_dir: Path,
        tombs: dict[str, int],
        app_label: str | None = None,
    ) -> int:
        cseg, hots, superseded, _ = _active_segments(shard_dir)
        # never fold past an in-flight write: a writer that reserved its
        # seq before this fold started may publish its segment AFTER the
        # new cseg lands — a watermark at or above that seq would read it
        # as superseded and silently drop acked rows
        barrier = self.client.seq.barrier()
        hots = [s for s in hots if s.seq <= barrier]
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("compact.fold", shard_dir.name)
        # nothing to fold when there is no hot head AND every known
        # tombstone has already been applied to the compacted segment
        # (recorded in its footer as ``tombs_applied``): report live rows,
        # clean superseded leftovers
        max_tomb = max(tombs.values()) if tombs else -1
        cstats = (
            self.client.seg_stats(cseg.path) if cseg is not None else None
        )
        applied = int(cstats.get("tombs_applied", -1)) if cstats else -1
        if not hots and (cseg is None or max_tomb <= applied):
            for s in superseded:
                s.path.unlink(missing_ok=True)
            self._sweep_tmps(shard_dir)
            if cseg is None:
                return 0
            if cstats is not None and "rows" in cstats:
                return int(cstats["rows"])
            return pq.ParquetFile(cseg.path).metadata.num_rows
        # the watermark is the highest seq among the FILES being folded —
        # never the clock — so a segment published concurrently (its seq is
        # necessarily larger) always stays above it
        watermark = max(
            [s.seq for s in hots] + ([cseg.seq] if cseg is not None else [])
        )
        # the fold read is bounded by the WATERMARK (exactly the files
        # enumerated above), not the barrier: a segment published between
        # the listing and the read carries a larger seq and must stay a
        # live hot segment, never be folded-but-not-unlinked (duplicates)
        t = self._shard_table(
            shard_dir, None, tombs, max_seq=watermark, bill=False
        )
        folded = ([cseg] if cseg is not None else []) + hots
        new_path = shard_dir / f"cseg-{watermark}.parquet"
        if t is not None:
            # sort by (entity, time): entity point reads decode one or two
            # row groups, time-windowed training scans stay row-group
            # prunable via the parquet statistics
            skey = pa.table(
                {
                    "et": t.column("entity_type").cast(pa.string()),
                    "ei": t.column("entity_id").cast(pa.string()),
                    "tm": t.column("event_time_ms"),
                    "sq": t.column("seq"),
                }
            )
            order = pc.sort_indices(
                skey,
                sort_keys=[
                    ("et", "ascending"),
                    ("ei", "ascending"),
                    ("tm", "ascending"),
                    ("sq", "ascending"),
                ],
            )
            t = t.take(order)
            stats = _segment_stats(t)
            stats["tombs_applied"] = max(max_tomb, applied)
            _publish_segment(
                shard_dir,
                new_path.name,
                t,
                stats,
                row_group_size=COMPACT_ROW_GROUP,
            )
        if faults.ACTIVE is not None:
            faults.ACTIVE.check("compact.publish", shard_dir.name)
        # event-to-visible freshness: each hot segment's seq is its publish
        # timestamp (ns), so now - seq is exactly how long its rows sat in
        # the write-hot tier before this fold made them compaction-visible.
        # Row-weighted so one giant stale segment moves the quantile as much
        # as many small ones.  Measured before the unlink (the footer read
        # needs the file) but after the publish, so a crash between the two
        # can at worst double-observe, never lose the segment itself.
        if hots:
            m = _metrics()
            lag_now = time.time()
            for s in hots:
                try:
                    sstats = self.client.seg_stats(s.path)
                    rows = int(sstats.get("rows", 0)) if sstats else 0
                except Exception:
                    rows = 0
                if rows <= 0:
                    rows = 1
                lag = max(lag_now - s.seq / 1e9, 0.0)
                m["visibility_lag"].observe_many(lag, rows)
                if app_label is not None:
                    m["visibility_lag_app"].labels(app_label).observe_many(
                        lag, rows
                    )
            m["visibility_lag_p99"].set(m["visibility_lag"].quantile(0.99))
            if app_label is not None:
                h_app = m["visibility_lag_app"].labels(app_label)
                m["visibility_lag_app_p99"].labels(app_label).set(
                    h_app.quantile(0.99)
                )
        for s in folded + superseded:
            if s.path != new_path or t is None:
                s.path.unlink(missing_ok=True)
        self._sweep_tmps(shard_dir)
        return 0 if t is None else t.num_rows

    @staticmethod
    def _sweep_tmps(shard_dir: Path, min_age_s: float = 300.0) -> None:
        """Remove orphaned publish tmps left by a crashed writer.  Only
        tmps older than ``min_age_s`` go — a live writer's in-flight tmp
        must never be swept from under it."""
        now = time.time()
        try:
            entries = list(os.scandir(shard_dir))
        except OSError:
            return
        for e in entries:
            if e.name.startswith(".") and e.name.endswith(".tmp"):
                try:
                    if now - e.stat().st_mtime > min_age_s:
                        os.unlink(e.path)
                except OSError:
                    continue

    def _prune_tombstones(self, d: Path) -> None:
        """Delete tombstone files every shard has durably folded.

        File del-<t> is prunable for a shard when (a) no write-hot segment
        holds rows with seq <= t, and (b) the compacted segment (if any)
        was folded with tombstones up to at least t (its footer records
        ``tombs_applied``).  Shards with no data never need a tombstone —
        future rows always carry a larger seq."""
        tomb = d / "_tombstones"
        if not tomb.exists():
            return
        threshold: int | None = None

        def shrink(v: int) -> None:
            nonlocal threshold
            threshold = v if threshold is None else min(threshold, v)

        for k, shard_dir in self.shard_dirs(*self._app_key_of(d)):
            cseg, hots, _, _ = _active_segments(shard_dir)
            if cseg is not None:
                st = self.client.seg_stats(cseg.path)
                shrink(int(st.get("tombs_applied", -1)) if st else -1)
            if hots:
                shrink(min(s.seq for s in hots) - 1)
        if threshold is None:
            threshold = self.client.seq.next()  # no data: all prunable
        # never prune past an in-flight write: a writer that reserved its
        # seq before a newer tombstone was minted may still publish rows
        # that tombstone must kill — the del file has to outlive the
        # reservation (the delete-side twin of the watermark barrier)
        threshold = min(threshold, self.client.seq.barrier())
        removed_all = True
        for f in sorted(tomb.glob("del-*.parquet")):
            try:
                seq = int(f.name[4:-8])
            except ValueError:
                continue
            if seq <= threshold:
                f.unlink(missing_ok=True)
            else:
                removed_all = False
        if removed_all:
            shutil.rmtree(tomb, ignore_errors=True)

    @staticmethod
    def _app_key_of(d: Path) -> tuple[int, int | None]:
        """(app_id, channel_id) back out of an app directory name."""
        name = d.name[4:]  # strip "app_"
        if "_c" in name:
            app, chan = name.split("_c", 1)
            return int(app), int(chan)
        return int(name), None

    def status(
        self, app_id: int, channel_id: int | None = None
    ) -> dict[str, Any]:
        """Layout stats for the CLI / daemon status surface: per-shard
        segment counts and bytes, compaction backlog, watermark lag, and
        byte skew.  Also refreshes the pio_eventstore_* gauges."""
        d = self.client.app_dir(app_id, channel_id)
        out: dict[str, Any] = {
            "app_id": app_id,
            "channel_id": channel_id,
            "n_shards": 0,
            "shards": [],
            "rows_hint": 0,
            "segments_hot": 0,
            "segments_compacted": 0,
            "backlog_segments": 0,
            "backlog_bytes": 0,
            "bytes": 0,
            "byte_skew_frac": 0.0,
            "watermark_lag_s": None,
        }
        if not d.exists():
            return out
        out["n_shards"] = self.client.n_shards(d)
        per_bytes = []
        anchor = None  # oldest seq not yet folded anywhere in the app
        now_ns = time.time_ns()
        for k, shard_dir in self.shard_dirs(app_id, channel_id):
            cseg, hots, superseded, w = _active_segments(shard_dir)
            nbytes = (cseg.size if cseg else 0) + sum(s.size for s in hots)
            rows = 0
            for s in ([cseg] if cseg else []) + hots:
                st = self.client.seg_stats(s.path)
                rows += int(st.get("rows", 0)) if st else 0
            out["shards"].append(
                {
                    "shard": k,
                    "hot": len(hots),
                    "compacted": 1 if cseg else 0,
                    "superseded": len(superseded),
                    "bytes": nbytes,
                    "watermark": w,
                }
            )
            out["segments_hot"] += len(hots)
            out["segments_compacted"] += 1 if cseg else 0
            out["backlog_segments"] += len(hots)
            out["backlog_bytes"] += sum(s.size for s in hots)
            out["rows_hint"] += rows
            out["bytes"] += nbytes
            per_bytes.append(nbytes)
            # a shard's lag anchor: its oldest UNFOLDED data (oldest hot
            # segment), else its watermark.  A populated shard that has
            # never compacted anchors at its oldest hot segment — the
            # lag must GROW during a compaction outage, not vanish
            if hots:
                shard_anchor = min(s.seq for s in hots)
            elif cseg is not None:
                shard_anchor = w
            else:
                shard_anchor = None
            if shard_anchor is not None:
                anchor = (
                    shard_anchor
                    if anchor is None
                    else min(anchor, shard_anchor)
                )
        if per_bytes and max(per_bytes) > 0:
            mean = sum(per_bytes) / len(per_bytes)
            out["byte_skew_frac"] = round(
                max(per_bytes) / mean - 1.0, 4
            ) if mean else 0.0
        if anchor is not None and anchor >= 0:
            out["watermark_lag_s"] = round(
                max(now_ns - anchor, 0) / 1e9, 3
            )
        m = _metrics()
        m["segments"].labels("hot").set(out["segments_hot"])
        m["segments"].labels("compacted").set(out["segments_compacted"])
        m["backlog"].set(out["backlog_segments"])
        if out["watermark_lag_s"] is not None:
            m["watermark_lag"].set(out["watermark_lag_s"])
        return out


# ---------------------------------------------------------------------------
# Table -> Python conversions
# ---------------------------------------------------------------------------


def _table_to_events(t: pa.Table) -> list[Event]:
    cols = {name: t.column(name).to_pylist() for name in (
        "event_id", "event", "entity_type", "entity_id",
        "target_entity_type", "target_entity_id", "event_time_ms",
        "creation_time_ms", "properties", "tags", "pr_id",
    )}
    out = []
    for i in range(t.num_rows):
        out.append(
            Event(
                event=cols["event"][i],
                entity_type=cols["entity_type"][i],
                entity_id=cols["entity_id"][i],
                target_entity_type=cols["target_entity_type"][i],
                target_entity_id=cols["target_entity_id"][i],
                properties=DataMap(
                    json.loads(cols["properties"][i])
                    if cols["properties"][i]
                    else {}
                ),
                event_time=_from_ms(cols["event_time_ms"][i]),
                event_id=cols["event_id"][i],
                tags=tuple(json.loads(cols["tags"][i])) if cols["tags"][i] else (),
                pr_id=cols["pr_id"][i],
                creation_time=_from_ms(cols["creation_time_ms"][i]),
            )
        )
    return out


def _decode_str_col(chunked) -> np.ndarray:
    """Arrow string-ish column -> numpy object array.  Dictionary columns
    decode through the vocabulary: ~unique-many Python strings get
    materialized instead of one per row (the 20M-row scan win)."""
    arr = (
        chunked.combine_chunks()
        if isinstance(chunked, pa.ChunkedArray)
        else chunked
    )
    if pa.types.is_dictionary(arr.type):
        return dictionary_to_objects(arr)
    return arr.to_numpy(zero_copy_only=False)


def _decode_tags_col(chunked, n: int) -> np.ndarray:
    """tags column -> object array of tuples, parsing each UNIQUE JSON
    document once when the column is dictionary-encoded."""
    arr = (
        chunked.combine_chunks()
        if isinstance(chunked, pa.ChunkedArray)
        else chunked
    )

    def parse(s):
        return tuple(json.loads(s)) if s else ()

    if pa.types.is_dictionary(arr.type):
        return dictionary_to_objects(arr, null_value=(), transform=parse)
    raw = arr.to_numpy(zero_copy_only=False)
    out = np.empty(n, dtype=object)
    for i, s in enumerate(raw):
        out[i] = parse(s)
    return out


def _table_to_frame(t: pa.Table) -> EventFrame:
    present = set(t.column_names)

    def col(name) -> np.ndarray | None:
        if name not in present:
            return None
        return _decode_str_col(t.column(name))

    def i64(name) -> np.ndarray | None:
        if name not in present:
            return None
        return t.column(name).to_numpy(zero_copy_only=False).astype(np.int64)

    # properties stay as RAW JSON strings ("" = empty): the EventFrame
    # contract decodes them lazily (property_column parses columnar at C
    # speed; to_events decodes row-wise) — a 20M-row scan skips 20M
    # json.loads calls it may never need.  Dictionary decode hands back
    # INTERNED documents, so property_column's pointer fast path parses
    # each distinct document once.
    return EventFrame(
        event=col("event"),
        entity_type=col("entity_type"),
        entity_id=col("entity_id"),
        target_entity_type=col("target_entity_type"),
        target_entity_id=col("target_entity_id"),
        event_time_ms=i64("event_time_ms"),
        properties=col("properties"),
        event_id=col("event_id"),
        tags=(
            _decode_tags_col(t.column("tags"), t.num_rows)
            if "tags" in present
            else None
        ),
        pr_id=col("pr_id"),
        creation_time_ms=i64("creation_time_ms"),
    )


def _sort_limit(t: pa.Table, filter: EventFilter | None) -> pa.Table:
    direction = (
        "descending" if (filter is not None and filter.reversed) else "ascending"
    )
    t = t.take(
        pc.sort_indices(
            t, sort_keys=[("event_time_ms", direction), ("seq", direction)]
        )
    )
    if filter is not None and filter.limit is not None and filter.limit >= 0:
        t = t.slice(0, filter.limit)
    return t


def write_rows_parquet(rows: list[dict], path: str | Path) -> None:
    """One parquet file of plain row dicts (``pio export --format
    parquet``), column types inferred by arrow."""
    pq.write_table(pa.Table.from_pylist(rows), str(path))


class ParquetLEvents(LEvents):
    """Row-level DAO over the parquet log (the ESLEvents/HBLEvents role)."""

    def __init__(self, client: ParquetClient):
        self.store = ParquetEventStore(client)

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        return self.store.init(app_id, channel_id)

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        return self.store.remove(app_id, channel_id)

    def close(self) -> None:
        self.store.client.close()

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        return self.store.append_events([event], app_id, channel_id)[0]

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        return self.store.append_events(events, app_id, channel_id)

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        t = self.store.get_by_id(event_id, app_id, channel_id)
        if t is None:
            return None
        return _table_to_events(t)[0]

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        if self.store.get_by_id(event_id, app_id, channel_id) is None:
            return False
        self.store.append_tombstones([event_id], app_id, channel_id)
        return True

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> Iterator[Event]:
        reverse = filter is not None and filter.reversed
        limit = filter.limit if filter is not None else None

        def shard_iter(t: pa.Table) -> Iterator[tuple]:
            t = _sort_limit(t, filter)  # per-shard pre-limit is sound
            for e in _table_to_events(t):
                key = _to_ms(e.event_time)
                yield (-key if reverse else key, e)

        streams = [
            shard_iter(t)
            for _, t in self.store.scan_shards(app_id, channel_id, filter)
        ]
        count = 0
        for _, e in heap_merge(*streams, key=lambda pair: pair[0]):
            if limit is not None and 0 <= limit <= count:
                return
            count += 1
            yield e

    def find_by_entity(
        self,
        app_id: int,
        entity_type: str,
        entity_id: str,
        channel_id: int | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        """Per-entity history via the segment-skipping point read — the
        serving-path access pattern (sequence engines, business rules)."""
        flt = EventFilter(
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=tuple(event_names) if event_names else None,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=reversed,
        )
        t = self.store.read_entity(
            app_id, channel_id, entity_type, entity_id, filter=flt
        )
        if t is None:
            return iter(())
        return iter(_table_to_events(_sort_limit(t, flt)))


class ParquetPEvents(PEvents):
    """Bulk columnar DAO (the HBPEvents/JDBCPEvents role): per-shard
    EventFrames for memory-bounded scans and multi-host shard ranges."""

    def __init__(self, client: ParquetClient):
        self.store = ParquetEventStore(client)

    def n_shards(self, app_id: int, channel_id: int | None = None) -> int:
        c = self.store.client
        return c.n_shards(c.app_dir(app_id, channel_id))

    def compact(self, app_id: int, channel_id: int | None = None) -> int:
        """Fold append-only segments + tombstones into one compacted
        segment per shard (the HBase major-compaction role, run on demand
        via ``pio eventstore compact`` or continuously by the background
        Compactor); returns live-row count."""
        return self.store.compact(app_id, channel_id)

    def status(self, app_id: int, channel_id: int | None = None) -> dict:
        return self.store.status(app_id, channel_id)

    def iter_shards(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
        shards: Sequence[int] | None = None,
        columns: Sequence[str] | None = None,
    ) -> Iterator[tuple[int, EventFrame]]:
        """One EventFrame per shard.  Rows within a shard are unordered
        (training consumers are order-free; ``find`` sorts).  ``columns``
        projects the read down to the named EventFrame columns — absent
        optional columns come back as None (``event`` is always read)."""
        for k, t in self.store.scan_shards(
            app_id, channel_id, filter, shards, columns=columns
        ):
            yield k, _table_to_frame(t)

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        filter: EventFilter | None = None,
    ) -> EventFrame:
        tables = [
            t for _, t in self.store.scan_shards(app_id, channel_id, filter)
        ]
        if not tables:
            return EventFrame.from_events([])
        t = _sort_limit(pa.concat_tables(tables), filter)
        return _table_to_frame(t)

    def write(
        self, frame: EventFrame, app_id: int, channel_id: int | None = None
    ) -> None:
        self.store.append_frame(frame, app_id, channel_id)

    def delete(
        self, event_ids: Sequence[str], app_id: int, channel_id: int | None = None
    ) -> None:
        if event_ids:
            self.store.append_tombstones(event_ids, app_id, channel_id)
