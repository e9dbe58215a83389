"""The analyzer: walk files, run rules, apply suppressions, render.

Stdlib-``ast`` only — analyzing a tree never imports the analyzed code, so
`pio check` is safe to run on broken or torch-dependent modules from any
environment (the DASE contract checks in ``contract.py`` are the one
deliberate exception: they import engine factories on request).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Sequence

from predictionio_tpu_torch.analysis.findings import Finding, Severity
from predictionio_tpu_torch.analysis.pragmas import is_suppressed, pragma_map
from predictionio_tpu_torch.analysis.rules import (
    ALL_RULES,
    ProgramRule,
    Rule,
    parse_module,
)

#: directories never descended into during a scan
_SKIP_DIRS = frozenset(
    ("__pycache__", ".git", ".venv", "venv", "node_modules", ".eggs")
)


@dataclass
class AnalysisReport:
    """Findings after pragma suppression (baseline applies later)."""

    findings: list[Finding] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)  # unparseable files etc.
    files_scanned: int = 0
    pragma_suppressed: int = 0
    baseline_suppressed: int = 0

    def summary(self) -> dict[str, Any]:
        by_sev: dict[str, int] = {}
        for f in self.findings:
            by_sev[str(f.severity)] = by_sev.get(str(f.severity), 0) + 1
        return {
            "files_scanned": self.files_scanned,
            "total": len(self.findings),
            "by_severity": by_sev,
            "pragma_suppressed": self.pragma_suppressed,
            "baseline_suppressed": self.baseline_suppressed,
            "errors": len(self.errors),
        }


def iter_python_files(paths: Sequence[Path | str]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file():
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # skip-dirs are judged relative to the scan root: a repo
                # that happens to live UNDER a directory named venv/ must
                # still scan (only nested venvs inside the tree are skipped)
                if not any(part in _SKIP_DIRS for part in f.relative_to(p).parts):
                    out.append(f)
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    # de-dup while preserving order (overlapping path args)
    seen: set[Path] = set()
    uniq = []
    for f in out:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            uniq.append(f)
    return uniq


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def analyze_source(
    source: str,
    rel: str = "<string>",
    path: Path | None = None,
    rules: Iterable[Rule] | None = None,
) -> list[Finding]:
    """Analyze one source string (fixture tests, editor integrations).

    Program rules run over a one-module Program, so single-file fixtures
    exercise them too (cross-module edges obviously need analyze_paths).
    """
    mod = parse_module(path or Path(rel), rel, source)
    active = list(rules) if rules is not None else list(ALL_RULES.values())
    pragmas = pragma_map(mod.lines)
    findings: list[Finding] = []
    program_rules = [r for r in active if isinstance(r, ProgramRule)]
    for r in active:
        findings.extend(
            f for f in r.check(mod) if not is_suppressed(f, pragmas)
        )
    if program_rules:
        from predictionio_tpu_torch.analysis.callgraph import build_program

        program = build_program([mod])
        for r in program_rules:
            findings.extend(
                f
                for f in r.check_program(program)
                if not is_suppressed(f, pragmas)
            )
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def analyze_paths(
    paths: Sequence[Path | str],
    root: Path | str | None = None,
    rules: Iterable[Rule] | None = None,
    cache=None,
) -> AnalysisReport:
    """Run every (or the given) rule over all .py files under ``paths``.

    ``root`` anchors the relative paths used in findings and baseline
    matching; it defaults to the current working directory.

    ``cache`` is an optional :class:`predictionio_tpu_torch.analysis.cache
    .CheckCache`; it is honored only for full-rule-set runs (a subset run
    must not poison entries computed under different rules).  A full hit —
    every file sha plus the program digest — skips parsing entirely; a
    partial hit still parses every file (whole-program rules need all
    ASTs) but reuses hit files' local findings.
    """
    root = Path(root) if root is not None else Path.cwd()
    active = list(rules) if rules is not None else list(ALL_RULES.values())
    local_rules = [r for r in active if not isinstance(r, ProgramRule)]
    program_rules = [r for r in active if isinstance(r, ProgramRule)]
    use_cache = cache is not None and rules is None
    report = AnalysisReport()
    files = iter_python_files(paths)

    loaded: list[tuple[Path, str, str, str]] = []  # (path, rel, source, sha)
    for path in files:
        rel = _relpath(path, root)
        try:
            raw = path.read_bytes()
            source = raw.decode("utf-8")
        except (OSError, ValueError) as e:
            report.errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        sha = ""
        if use_cache:
            from predictionio_tpu_torch.analysis.cache import file_sha

            sha = file_sha(raw)
        loaded.append((path, rel, source, sha))

    cached_entries: dict[str, dict | None] = {}
    if use_cache:
        for _p, rel, _s, sha in loaded:
            cached_entries[rel] = cache.lookup(rel, sha)

    if use_cache and not report.errors:
        fast = _assemble_from_cache(cache, loaded, cached_entries, report)
        if fast is not None:
            return fast

    mods = []
    pragma_maps: dict[str, dict] = {}
    for path, rel, source, sha in loaded:
        try:
            mod = parse_module(path, rel, source)
        except (SyntaxError, ValueError) as e:
            report.errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        report.files_scanned += 1
        mods.append((mod, sha))
        pragmas = pragma_map(mod.lines)
        pragma_maps[rel] = pragmas
        cached = cached_entries.get(rel) if use_cache else None
        if cached is not None:
            for d in cached["findings"]:
                report.findings.append(Finding.from_json_dict(d))
            report.pragma_suppressed += int(cached.get("pragma_suppressed", 0))
            continue
        kept: list[Finding] = []
        suppressed = 0
        for r in local_rules:
            for f in r.check(mod):
                if is_suppressed(f, pragmas):
                    suppressed += 1
                else:
                    kept.append(f)
        report.findings.extend(kept)
        report.pragma_suppressed += suppressed
        if use_cache:
            cache.store(rel, sha, kept, suppressed)

    if program_rules and mods:
        digest = None
        prog_cached = None
        if use_cache and not report.errors:
            from predictionio_tpu_torch.analysis.cache import program_digest

            digest = program_digest([(m.rel, sha) for m, sha in mods])
            prog_cached = cache.lookup_program(digest)
        if prog_cached is not None:
            for d in prog_cached["findings"]:
                report.findings.append(Finding.from_json_dict(d))
            report.pragma_suppressed += int(
                prog_cached.get("pragma_suppressed", 0)
            )
        else:
            from predictionio_tpu_torch.analysis.callgraph import build_program

            program = build_program([m for m, _sha in mods])
            kept = []
            suppressed = 0
            for r in program_rules:
                for f in r.check_program(program):
                    if is_suppressed(f, pragma_maps.get(f.file, {})):
                        suppressed += 1
                    else:
                        kept.append(f)
            report.findings.extend(kept)
            report.pragma_suppressed += suppressed
            if digest is not None:
                cache.store_program(digest, kept, suppressed)
    if use_cache:
        cache.save()
    report.findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return report


def _assemble_from_cache(
    cache,
    loaded: list[tuple[Path, str, str, str]],
    cached_entries: dict[str, dict | None],
    report: AnalysisReport,
) -> AnalysisReport | None:
    """Full-hit fast path: every file and the program entry cached."""
    from predictionio_tpu_torch.analysis.cache import program_digest

    entries = [cached_entries.get(rel) for _p, rel, _s, _sha in loaded]
    digest = program_digest([(rel, sha) for _p, rel, _s, sha in loaded])
    prog = cache.lookup_program(digest)
    if prog is None or any(e is None for e in entries):
        return None
    for e in entries:
        assert e is not None
        for d in e["findings"]:
            report.findings.append(Finding.from_json_dict(d))
        report.pragma_suppressed += int(e.get("pragma_suppressed", 0))
    for d in prog["findings"]:
        report.findings.append(Finding.from_json_dict(d))
    report.pragma_suppressed += int(prog.get("pragma_suppressed", 0))
    report.files_scanned = len(loaded)
    cache.save()
    report.findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return report


def filter_severity(
    findings: Iterable[Finding], threshold: Severity
) -> list[Finding]:
    return [f for f in findings if f.severity >= threshold]


def render_text(report: AnalysisReport) -> str:
    lines = [f.text() for f in report.findings]
    lines += [f"error: {e}" for e in report.errors]
    s = report.summary()
    suppressed = s["pragma_suppressed"] + s["baseline_suppressed"]
    tail = (
        f"{s['total']} finding(s) in {s['files_scanned']} file(s)"
        + (f", {suppressed} suppressed" if suppressed else "")
        + (f", {s['errors']} file error(s)" if s["errors"] else "")
    )
    lines.append(tail)
    return "\n".join(lines)


def render_json(report: AnalysisReport) -> dict[str, Any]:
    return {
        "version": 1,
        "findings": [f.to_json_dict() for f in report.findings],
        "errors": list(report.errors),
        "summary": report.summary(),
    }


#: SARIF severity levels by our Severity (SARIF 2.1.0 §3.27.10)
_SARIF_LEVELS = {"low": "note", "medium": "warning", "high": "error"}


def render_sarif(report: AnalysisReport) -> dict[str, Any]:
    """SARIF 2.1.0 log for CI annotation tooling.

    Deterministic for a given report: rule metadata comes from the shipped
    registry (sorted by id), result order follows the report's findings
    order, and URIs are the report's root-relative posix paths.  Parse
    errors surface as tool-execution notifications (the exit-code contract
    still reports them as 2).
    """
    rule_ids = sorted(ALL_RULES)
    rules = [
        {
            "id": rid,
            "shortDescription": {"text": ALL_RULES[rid].summary},
            "defaultConfiguration": {
                "level": _SARIF_LEVELS[str(ALL_RULES[rid].severity)]
            },
        }
        for rid in rule_ids
    ]
    index = {rid: i for i, rid in enumerate(rule_ids)}
    results = []
    for f in report.findings:
        r: dict[str, Any] = {
            "ruleId": f.rule,
            "level": _SARIF_LEVELS.get(str(f.severity), "warning"),
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.file},
                        "region": {
                            "startLine": f.line,
                            "startColumn": f.col,
                        },
                    }
                }
            ],
        }
        if f.rule in index:
            r["ruleIndex"] = index[f.rule]
        results.append(r)
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
            "Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "pio-check",
                        "informationUri": (
                            "https://predictionio-tpu.invalid/docs/"
                            "static_analysis"
                        ),
                        "rules": rules,
                    }
                },
                "results": results,
                "invocations": [
                    {
                        "executionSuccessful": not report.errors,
                        "toolExecutionNotifications": [
                            {"level": "error", "message": {"text": e}}
                            for e in report.errors
                        ],
                    }
                ],
            }
        ],
    }
