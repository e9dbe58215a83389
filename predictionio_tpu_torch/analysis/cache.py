"""Check-result cache: memoized `pio check` findings keyed by content hash.

The train/deploy DASE pre-flight (and every CI `pio check`) used to re-parse
the whole package per launch.  This cache stores, under
``$PIO_HOME/check-cache.json``:

  - per-file entries keyed by ``(file sha256, rule-set version)`` holding
    the post-pragma local-rule findings, and
  - one program-level entry keyed by a digest over every ``(path, sha)``
    pair, holding the whole-program (PIO-LOCK/TORCH008) findings.

The rule-set version is a hash over the ``analysis/*.py`` sources
themselves, so editing any rule invalidates everything automatically.
When every file and the program digest hit, ``analyze_paths`` skips
parsing entirely; on a partial hit it still parses (program rules need
every AST) but reuses the hit files' local findings.  Entries whose
version no longer matches are evicted on load; the table is LRU-capped.
Persistence is atomic (tmp + fsync + rename) and a corrupt or unreadable
cache degrades to a cold one — the cache can never change findings, only
how fast they arrive.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any

from predictionio_tpu_torch.analysis.findings import Finding

DEFAULT_CACHE_NAME = "check-cache.json"

#: LRU cap on per-file entries; generous for a package-sized scan
_MAX_FILES = 8192

_ruleset_version_memo: str | None = None


def ruleset_version() -> str:
    """Hash of the analysis package's own sources — the rule-set version."""
    global _ruleset_version_memo
    if _ruleset_version_memo is None:
        h = hashlib.sha256()
        pkg = Path(__file__).parent
        for f in sorted(pkg.glob("*.py")):
            h.update(f.name.encode())
            try:
                h.update(f.read_bytes())
            except OSError:
                h.update(b"?")
        _ruleset_version_memo = h.hexdigest()[:16]
    return _ruleset_version_memo


def file_sha(source_bytes: bytes) -> str:
    return hashlib.sha256(source_bytes).hexdigest()


def program_digest(entries: list[tuple[str, str]]) -> str:
    """Digest over every (rel path, sha) pair of a scan, order-independent."""
    h = hashlib.sha256()
    for rel, sha in sorted(entries):
        h.update(rel.encode())
        h.update(sha.encode())
    return h.hexdigest()[:16]


class CheckCache:
    """One load/save cycle of the on-disk cache for a single scan."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._clock = 0
        self._files: dict[str, dict[str, Any]] = {}
        self._program: dict[str, Any] | None = None
        self._load()

    def _load(self) -> None:
        try:
            raw = json.loads(self.path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return
        if not isinstance(raw, dict) or raw.get("version") != 1:
            return
        if raw.get("ruleset") != ruleset_version():
            return  # stale rule-set: evict everything
        files = raw.get("files")
        if isinstance(files, dict):
            for k, v in files.items():
                if isinstance(v, dict) and "sha" in v and "findings" in v:
                    self._files[str(k)] = v
                    self._clock = max(self._clock, int(v.get("used", 0)))
        prog = raw.get("program")
        if isinstance(prog, dict) and "digest" in prog:
            self._program = prog

    # -- per-file ------------------------------------------------------------

    def lookup(self, rel: str, sha: str) -> dict[str, Any] | None:
        e = self._files.get(rel)
        if e is None or e.get("sha") != sha:
            self.misses += 1
            return None
        self.hits += 1
        self._clock += 1
        e["used"] = self._clock
        self._dirty = True
        return e

    def store(
        self, rel: str, sha: str, findings: list[Finding], suppressed: int
    ) -> None:
        self._clock += 1
        self._files[rel] = {
            "sha": sha,
            "findings": [f.to_json_dict() for f in findings],
            "pragma_suppressed": suppressed,
            "used": self._clock,
        }
        self._dirty = True

    # -- whole-program -------------------------------------------------------

    def lookup_program(self, digest: str) -> dict[str, Any] | None:
        p = self._program
        if p is None or p.get("digest") != digest:
            return None
        return p

    def store_program(
        self, digest: str, findings: list[Finding], suppressed: int
    ) -> None:
        self._program = {
            "digest": digest,
            "findings": [f.to_json_dict() for f in findings],
            "pragma_suppressed": suppressed,
        }
        self._dirty = True

    # -- persistence ---------------------------------------------------------

    def save(self) -> None:
        if not self._dirty:
            return
        files = self._files
        if len(files) > _MAX_FILES:
            keep = sorted(
                files.items(), key=lambda kv: kv[1].get("used", 0)
            )[-_MAX_FILES:]
            files = dict(keep)
        payload = {
            "version": 1,
            "ruleset": ruleset_version(),
            "files": files,
            "program": self._program,
        }
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=str(self.path.parent), prefix=".check-cache-"
            )
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as fh:
                    json.dump(payload, fh, separators=(",", ":"))
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass  # a cache that cannot persist is just a cold cache
        self._dirty = False

    def stats_line(self) -> str:
        return f"cache: {self.hits} hit(s), {self.misses} miss(es)"
