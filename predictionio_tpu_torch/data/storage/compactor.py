"""Background segment compaction with watermarks.

The JAX package's ``data/storage/compactor.py``, ported whole (the same
policy knobs ``PIO_COMPACT_INTERVAL_S``, ``PIO_COMPACT_MIN_SEGMENTS`` and
``PIO_COMPACT_BACKLOG_BUDGET``, the same status shape).

The write path appends one segment per (batch, shard) and never rewrites a
closed file; left alone, a high-rate ingest stream grows thousands of
small write-hot segments and every scan pays their per-file overhead plus
the full dedup sort.  The :class:`Compactor` is the daemon that keeps the
store read-optimal: each tick it walks the parquet root, finds apps whose
write-hot head exceeds the policy threshold, and folds them through
``ParquetEventStore.compact`` — deduped, tombstoned, sorted by (entity,
time) under a per-shard watermark, crash-safe via tmp + fsync +
``os.replace``.

Follows the LifecycleController idiom: a daemon thread drives test-driven
``tick()`` steps, so the chaos suite can run the loop deterministically
with no sleeps.  One compactor runs per storage-owning process (the
storage daemon, or an embedded single-VM deploy).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping

from predictionio_tpu_torch.data.storage.parquet_backend import (
    ParquetEventStore,
    ParquetClient,
)

log = logging.getLogger("predictionio_tpu_torch.data.compactor")


@dataclass(frozen=True)
class CompactionPolicy:
    """Knobs for the background compactor.

    ``min_hot_segments`` is the write-hot head a SHARD may accumulate
    before a tick folds the app (compacting after every batch would
    rewrite the whole shard per batch — write amplification with no read
    win; since one batch adds at most one segment per shard, the gate is
    per-shard depth, not the app-wide total, which any single batch
    inflates by n_shards); ``backlog_budget_segments`` is the operator
    alert/WARNING line: a backlog above it means compaction is not
    keeping up with ingest.
    """

    interval_s: float = 30.0
    min_hot_segments: int = 8
    backlog_budget_segments: int = 64

    @classmethod
    def from_env(
        cls, env: Mapping[str, str] | None = None
    ) -> "CompactionPolicy":
        e = env if env is not None else os.environ

        def f(key: str, default: float) -> float:
            try:
                return float(e.get(key, default))
            except ValueError:
                return default

        return cls(
            interval_s=f("PIO_COMPACT_INTERVAL_S", cls.interval_s),
            min_hot_segments=int(
                f("PIO_COMPACT_MIN_SEGMENTS", cls.min_hot_segments)
            ),
            backlog_budget_segments=int(
                f("PIO_COMPACT_BACKLOG_BUDGET", cls.backlog_budget_segments)
            ),
        )


class Compactor:
    """Daemon thread + test-driven ``tick()`` over one parquet root."""

    def __init__(
        self,
        client: ParquetClient,
        policy: CompactionPolicy | None = None,
    ):
        self.client = client
        self.policy = policy or CompactionPolicy()
        self.store = ParquetEventStore(client)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # guards _pass_running only: one pass at a time (a manual compact
        # against the daemon) without holding a lock across the folds,
        # whose shard futures the store awaits
        self._lock = threading.Lock()
        self._pass_ended = threading.Condition(self._lock)
        self._pass_running = False
        self.last_tick: dict[str, Any] = {}

    # -- discovery -----------------------------------------------------------
    def app_keys(self) -> list[tuple[int, int | None]]:
        """(app_id, channel_id) for every app directory under the root."""
        out = []
        try:
            entries = sorted(os.scandir(self.client.root), key=lambda e: e.name)
        except OSError:
            return []
        for e in entries:
            if not e.is_dir() or not e.name.startswith("app_"):
                continue
            try:
                out.append(ParquetEventStore._app_key_of(e))
            except ValueError:
                continue
        return out

    # -- the loop ------------------------------------------------------------
    def tick(self) -> dict[str, Any]:
        """One compaction pass: fold every app whose write-hot head
        exceeds the policy threshold.  Returns a summary (also kept as
        ``last_tick`` for the status surface)."""
        summary: dict[str, Any] = {
            "apps_seen": 0,
            "apps_compacted": 0,
            "rows_folded": 0,
            "backlog_segments": 0,
            "errors": [],
        }
        with self._lock:
            while self._pass_running:
                self._pass_ended.wait()
            self._pass_running = True
        try:
            self._fold_all(summary)
        finally:
            with self._lock:
                self._pass_running = False
                self._pass_ended.notify_all()
        self.last_tick = summary
        return summary

    def _fold_all(self, summary: dict[str, Any]) -> None:
        for app_id, channel_id in self.app_keys():
            summary["apps_seen"] += 1
            try:
                st = self.store.status(app_id, channel_id)
                deepest = max(
                    (s["hot"] for s in st["shards"]), default=0
                )
                if deepest < self.policy.min_hot_segments:
                    summary["backlog_segments"] += st["backlog_segments"]
                    continue
                rows = self.store.compact(app_id, channel_id)
                summary["apps_compacted"] += 1
                summary["rows_folded"] += rows
                after = self.store.status(app_id, channel_id)
                summary["backlog_segments"] += after["backlog_segments"]
            except Exception as e:  # keep the daemon alive
                log.warning(
                    "compaction of app %s failed", app_id, exc_info=True
                )
                summary["errors"].append(f"app {app_id}: {e}")

    def start(self) -> "Compactor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pio-compactor", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        # Event.wait paces the loop (interruptible, not a busy-wait)
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("compactor tick crashed; continuing")

    # -- status --------------------------------------------------------------
    def status(self) -> dict[str, Any]:
        """Aggregate status across apps for /eventstore.json and the CLI."""
        apps = []
        for app_id, channel_id in self.app_keys():
            try:
                apps.append(self.store.status(app_id, channel_id))
            except Exception as e:
                apps.append(
                    {"app_id": app_id, "channel_id": channel_id, "error": str(e)}
                )
        backlog = sum(a.get("backlog_segments", 0) for a in apps)
        lags = [
            a["watermark_lag_s"]
            for a in apps
            if a.get("watermark_lag_s") is not None
        ]
        return {
            "generated_at": time.time(),
            "policy": {
                "interval_s": self.policy.interval_s,
                "min_hot_segments": self.policy.min_hot_segments,
                "backlog_budget_segments": self.policy.backlog_budget_segments,
            },
            "running": self.running,
            "backlog_segments": backlog,
            "over_budget": backlog > self.policy.backlog_budget_segments,
            "watermark_lag_s": max(lags) if lags else None,
            "visibility": self._visibility(),
            "apps": apps,
            "last_tick": self.last_tick,
        }

    @staticmethod
    def _visibility() -> dict[str, Any]:
        """Event-to-visible freshness quantiles (process lifetime, row
        weighted) from the ``pio_event_visibility_lag_seconds`` histogram
        this process's compaction passes feed."""
        from predictionio_tpu_torch.data.storage.parquet_backend import _metrics

        h = _metrics()["visibility_lag"]
        return {
            "rows_observed": h.count,
            "lag_p50_s": h.quantile(0.50) if h.count else None,
            "lag_p99_s": h.quantile(0.99) if h.count else None,
        }
