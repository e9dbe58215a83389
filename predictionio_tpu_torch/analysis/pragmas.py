"""Inline suppression pragmas: ``# pio: ignore[RULE]``.

A pragma on the flagged line suppresses matching findings on that line; a
pragma on a comment-only line suppresses findings on the next line (for
sites where the flagged statement has no room for a trailing comment).
``# pio: ignore[*]`` suppresses every rule on the line.
"""

from __future__ import annotations

import re

from predictionio_tpu_torch.analysis.findings import Finding

PRAGMA_RE = re.compile(r"#\s*pio:\s*ignore\[([A-Za-z0-9_*,\-\s]*)\]")


def pragma_map(lines: list[str]) -> dict[int, set[str]]:
    """1-based line number -> set of suppressed rule ids ('*' = all)."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = PRAGMA_RE.search(text)
        if not m:
            continue
        ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
        if not ids:
            continue
        out.setdefault(i, set()).update(ids)
        if text.lstrip().startswith("#"):  # comment-only line: covers next
            out.setdefault(i + 1, set()).update(ids)
    return out


def is_suppressed(finding: Finding, pragmas: dict[int, set[str]]) -> bool:
    ids = pragmas.get(finding.line)
    return bool(ids) and ("*" in ids or finding.rule in ids)
