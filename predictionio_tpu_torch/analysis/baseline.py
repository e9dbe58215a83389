"""Checked-in suppression baseline for `pio check`.

A baseline entry matches a finding by ``(rule, file, source)`` — the
stripped text of the flagged line — NOT by line number, so edits elsewhere
in the file don't invalidate suppressions.  Matching is count-aware: two
identical findings need two identical entries.  Every entry carries a
``justification`` string; the self-gate test rejects empty or TODO ones.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from predictionio_tpu_torch.analysis.findings import Finding

#: the file `pio check` auto-discovers in the working directory
DEFAULT_BASELINE_NAME = ".pio-check-baseline.json"

_FORMAT_VERSION = 1


class BaselineError(ValueError):
    """Malformed baseline file."""


@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    file: str
    source: str
    justification: str = ""
    line: int = 0  # informational only; matching ignores it

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.file, self.source)


@dataclass
class Baseline:
    entries: list[BaselineEntry] = field(default_factory=list)
    path: Path | None = None

    @classmethod
    def load(cls, path: Path | str) -> "Baseline":
        path = Path(path)
        try:
            data = json.loads(path.read_text())
        except OSError as e:
            raise BaselineError(f"cannot read baseline {path}: {e}") from e
        except json.JSONDecodeError as e:
            raise BaselineError(f"baseline {path} is not valid JSON: {e}") from e
        if not isinstance(data, dict) or "entries" not in data:
            raise BaselineError(
                f"baseline {path}: expected an object with an 'entries' list"
            )
        entries = []
        for i, raw in enumerate(data["entries"]):
            try:
                entries.append(
                    BaselineEntry(
                        rule=raw["rule"],
                        file=raw["file"],
                        source=raw["source"],
                        justification=raw.get("justification", ""),
                        line=int(raw.get("line", 0)),
                    )
                )
            except (KeyError, TypeError) as e:
                raise BaselineError(
                    f"baseline {path}: entry #{i} malformed: {e}"
                ) from e
        return cls(entries=entries, path=path)

    def filter(
        self, findings: Iterable[Finding]
    ) -> tuple[list[Finding], int]:
        """(non-baselined findings, count suppressed by the baseline)."""
        budget = Counter(e.key for e in self.entries)
        remaining: list[Finding] = []
        suppressed = 0
        for f in findings:
            key = (f.rule, f.file, f.source)
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                suppressed += 1
            else:
                remaining.append(f)
        return remaining, suppressed

    @staticmethod
    def write(
        path: Path | str,
        findings: Iterable[Finding],
        justification: str | None = None,
    ) -> int:
        """Write a baseline covering ``findings``; returns the count.

        New entries get a per-(rule, file) placeholder naming exactly what
        must be justified — the self-gate rejects any ``TODO…``
        justification, so a freshly written baseline is deliberately NOT
        yet acceptable (``pio check --write-baseline`` exits 1 listing the
        entries left to edit).  A refresh must not destroy curation:
        entries whose (rule, file, source) key already exists in the
        target file keep their written justification (duplicate keys carry
        over positionally); unedited placeholders are not curation and do
        not carry.  Synthetic findings (``file`` like ``<engine>``, e.g.
        an unresolvable factory) are never written: their empty source
        would baseline-match every future failure of the same kind.
        """
        carried: dict[tuple[str, str, str], list[str]] = {}
        if Path(path).exists():
            try:
                for e in Baseline.load(path).entries:
                    j = e.justification.strip()
                    if j and not j.lower().startswith("todo"):
                        carried.setdefault(e.key, []).append(e.justification)
            except BaselineError:
                pass  # unreadable old file: rewrite from scratch

        def _justify(f: Finding) -> str:
            pool = carried.get((f.rule, f.file, f.source))
            if pool:
                return pool.pop(0)
            return justification or (
                f"TODO({f.rule}): justify suppression in {f.file}"
            )

        entries = [
            {
                "rule": f.rule,
                "file": f.file,
                "line": f.line,
                "source": f.source,
                "justification": _justify(f),
            }
            for f in sorted(
                findings, key=lambda f: (f.file, f.line, f.rule)
            )
            if not f.file.startswith("<")
        ]
        Path(path).write_text(
            json.dumps(
                {"version": _FORMAT_VERSION, "entries": entries}, indent=2
            )
            + "\n"
        )
        return len(entries)
