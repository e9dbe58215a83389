"""Finding and severity model for `pio check`.

The reference framework gets its pre-flight guarantees from the JVM
compiler (Scala type-checks the DASE wiring before `pio train` ever runs);
this package is the Python port's replacement: every rule reports
:class:`Finding` records with a ``file:line`` anchor so violations surface
before an engine reaches the device, not under load.

Kept stdlib-only on purpose — the analyzer must be importable (and fast)
in CI containers that have no torch wheel at all.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class Severity(enum.IntEnum):
    """Ordered severity; comparisons follow the int value."""

    LOW = 10
    MEDIUM = 20
    HIGH = 30

    @classmethod
    def parse(cls, text: str) -> "Severity":
        try:
            return cls[str(text).strip().upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {text!r}; expected one of "
                f"{[s.name.lower() for s in cls]}"
            ) from None

    def __str__(self) -> str:  # render as 'high', parse back with parse()
        return self.name.lower()


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line.

    ``source`` carries the stripped text of the flagged line: the baseline
    matches on (rule, file, source) rather than line numbers, so unrelated
    edits above a baselined site do not invalidate the suppression.
    """

    rule: str
    severity: Severity
    file: str
    line: int
    col: int
    message: str
    source: str = ""

    def text(self) -> str:
        return (
            f"{self.file}:{self.line}:{self.col}: "
            f"{self.severity.name} {self.rule} {self.message}"
        )

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": str(self.severity),
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "source": self.source,
        }

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "Finding":
        """Inverse of :meth:`to_json_dict` (check-cache round trips)."""
        return cls(
            rule=str(d["rule"]),
            severity=Severity.parse(str(d["severity"])),
            file=str(d["file"]),
            line=int(d["line"]),
            col=int(d["col"]),
            message=str(d["message"]),
            source=str(d.get("source", "")),
        )
