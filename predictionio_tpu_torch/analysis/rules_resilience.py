"""Resilience lints (rule family PIO-RES*).

Motivating cases come from the failure modes the resilience layer
(predictionio_tpu_torch/resilience/) exists to kill: an HTTP call with no
timeout turns one dead dependency into a permanently wedged thread, and a
silent ``except Exception: pass`` on a serving path swallows
``RemoteStorageError`` so a storage outage looks like healthy traffic —
degradation must be *marked* (``resilience.degrade.mark_degraded``), never
silent.
"""

from __future__ import annotations

import ast
from typing import Iterable

from predictionio_tpu_torch.analysis.findings import Finding, Severity
from predictionio_tpu_torch.analysis.rules import (
    ModuleInfo,
    Rule,
    enclosing_function,
    resolve_call,
    resolve_name,
    rule,
)
from predictionio_tpu_torch.analysis.rules_torch import _is_hot_function

#: calls that open a network round trip, mapped to the 0-based POSITIONAL
#: index of their ``timeout`` parameter (so a positional timeout is
#: recognized, not just the keyword spelling)
_TIMEOUT_CALLS = {
    "urllib.request.urlopen": 2,  # urlopen(url, data, timeout)
    "http.client.HTTPConnection": 2,  # (host, port, timeout)
    "http.client.HTTPSConnection": 2,
    "socket.create_connection": 1,  # (address, timeout)
}


@rule
class NetworkCallWithoutTimeout(Rule):
    """PIO-RES001: blocking network call without an explicit timeout."""

    id = "PIO-RES001"
    severity = Severity.MEDIUM
    summary = (
        "network call without an explicit timeout=; a dead peer wedges the "
        "calling thread forever"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = resolve_call(mod, node)
            if callee not in _TIMEOUT_CALLS:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs may carry it; don't guess
            if len(node.args) > _TIMEOUT_CALLS[callee]:
                continue  # timeout passed positionally
            if any(isinstance(a, ast.Starred) for a in node.args):
                continue  # *args may carry it; don't guess
            yield self.finding(
                mod,
                node,
                f"{callee}(...) has no explicit timeout=: the default is "
                "block-forever, so one unreachable peer pins this thread "
                "until process restart; pass timeout= (capped by the "
                "request deadline where one is bound)",
            )


def _is_broad_handler(mod: ModuleInfo, handler: ast.ExceptHandler) -> bool:
    """bare ``except:`` or ``except Exception/BaseException``."""
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if resolve_name(mod, n) in ("Exception", "BaseException"):
            return True
    return False


def _is_silent_body(body: list[ast.stmt]) -> bool:
    """True when the handler does literally nothing (pass / ...)."""
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis
        ):
            continue
        return False
    return True


#: attribute spellings that publish bytes/text to a path
_WRITE_ATTRS = ("write_bytes", "write_text")

#: resolved call names that atomically commit a tmp write (attribute
#: spellings like ``tmp.replace(final)`` are arity-checked in
#: ``_is_commit_call`` so ``str.replace(old, new)`` never qualifies)
_COMMIT_CALLS = ("os.replace", "os.rename", "os.renames", "shutil.move")


def _write_mode(call: ast.Call, mode_pos: int) -> bool:
    """True when an ``open(...)``/``.open(...)`` call's mode argument
    spells write/append.  ``mode_pos`` is the positional index of the
    mode: 1 for builtin ``open(path, mode)``, 0 for the ``Path.open(mode)``
    method spelling."""
    mode = None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None and len(call.args) > mode_pos:
        mode = call.args[mode_pos]
    if not isinstance(mode, ast.Constant) or not isinstance(mode.value, str):
        return False
    return any(c in mode.value for c in "wax+")


def _is_commit_call(node: ast.Call, mod: ModuleInfo) -> bool:
    """An atomic-rename commit step.  Attribute spellings are arity-
    checked so ``str.replace(old, new)`` (two args) never passes for
    ``Path.replace(target)`` (one arg); ``os.replace``/``shutil.move``
    resolve by name regardless of arity."""
    if resolve_call(mod, node) in _COMMIT_CALLS:
        return True
    if not isinstance(node.func, ast.Attribute):
        return False
    attr = node.func.attr
    if attr in ("replace", "rename") and len(node.args) == 1:
        return True  # pathlib: tmp.replace(final) / tmp.rename(final)
    if attr in ("mv", "move", "renames"):
        return True  # fsspec/shutil-style two-arg movers; str has neither
    return False


def _function_commits(fn: ast.AST, mod: ModuleInfo) -> bool:
    """Does this function ever rename/replace something into place?"""
    return any(
        isinstance(node, ast.Call) and _is_commit_call(node, mod)
        for node in ast.walk(fn)
    )


@rule
class DirectWriteToPersistencePath(Rule):
    """PIO-RES003: storage-module write without a tmp-write + rename
    commit step."""

    id = "PIO-RES003"
    severity = Severity.MEDIUM
    summary = (
        "direct write to a final persistence path; a crash mid-write "
        "leaves a torn blob readers will load — write a tmp file and "
        "rename/replace it into place"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        # persistence modules only: the data/storage backends and fixtures
        # shaped like them — the tmp-write + atomic-rename contract is what
        # makes lifecycle generation flips crash-safe
        if "storage" not in mod.rel.replace("\\", "/"):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            is_write = (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _WRITE_ATTRS
            )
            if not is_write:
                if resolve_call(mod, node) == "open":
                    is_write = _write_mode(node, mode_pos=1)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "open"
                ):
                    # method spelling: Path.open("w") / fs.open(path, "wb")
                    # — the mode may sit at either position
                    is_write = _write_mode(node, mode_pos=0) or _write_mode(
                        node, mode_pos=1
                    )
            if not is_write:
                continue
            fn = enclosing_function(node)
            if fn is not None and _function_commits(fn, mod):
                continue  # tmp-write + rename/replace: the durable pattern
            if fn is None and _function_commits(mod.tree, mod):
                continue  # module-level write with a module-level commit
            target = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else "open"
            )
            yield self.finding(
                mod,
                node,
                f"{target}(...) writes the final persistence path directly: "
                "a crash between the first byte and the last leaves a torn "
                "blob that later reads will trust; write to a uniquely-"
                "named tmp file, fsync it, then os.replace() it into place "
                "(see data/storage/localfs_models.py)",
            )


#: keyword names that bound a parquet read (either prunes what is
#: materialized): projection or predicate
_READ_BOUND_KWARGS = frozenset({"columns", "filters", "filter"})


@rule
class FullTableMaterializationInStoragePath(Rule):
    """PIO-RES004: unbounded parquet read in a storage-pathed module."""

    id = "PIO-RES004"
    severity = Severity.MEDIUM
    summary = (
        "full-table parquet materialization: read_table/to_table/"
        "ParquetFile(...).read() without columns= or filters= decodes "
        "every row group and column of the file"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        # storage modules only: the event tier at 100M+ rows lives or
        # dies on predicate/column pushdown (docs/data_plane.md); an
        # unbounded read_table on a scan path silently drags the whole
        # log through memory
        if "storage" not in mod.rel.replace("\\", "/"):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs may carry a bound; don't guess
            kwargs = {kw.arg for kw in node.keywords}
            if kwargs & _READ_BOUND_KWARGS:
                continue
            callee = resolve_call(mod, node)
            what = None
            if callee == "pyarrow.parquet.read_table":
                what = "pyarrow.parquet.read_table(...)"
            elif isinstance(node.func, ast.Attribute):
                if node.func.attr == "to_table":
                    what = ".to_table(...)"
                elif (
                    node.func.attr == "read"
                    and isinstance(node.func.value, ast.Call)
                    and resolve_call(mod, node.func.value)
                    == "pyarrow.parquet.ParquetFile"
                ):
                    what = "pyarrow.parquet.ParquetFile(...).read()"
            if what is None:
                continue
            yield self.finding(
                mod,
                node,
                f"{what} without columns= or filters= materializes the "
                "whole file; scans at event-store scale must push the "
                "projection/predicate into the reader (pass columns= "
                "and/or filters=/filter=, even if spelled out in full, "
                "so the read is a deliberate bound)",
            )


@rule
class SilentExceptionSwallowOnHotPath(Rule):
    """PIO-RES002: ``except Exception: pass`` inside a serving hot-path
    function."""

    id = "PIO-RES002"
    severity = Severity.HIGH
    summary = (
        "broad except with an empty body on a serving hot path; storage "
        "outages (RemoteStorageError) vanish silently — mark degraded "
        "instead"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_handler(mod, node):
                continue
            if not _is_silent_body(node.body):
                continue
            fn = enclosing_function(node)
            if fn is None or not _is_hot_function(fn):
                continue
            yield self.finding(
                mod,
                node,
                f"broad except with an empty body inside hot-path function "
                f"{fn.name!r}: a RemoteStorageError here makes a storage "
                "outage indistinguishable from health; at minimum call "
                "resilience.degrade.mark_degraded(...) (and log) so the "
                "fallback is visible in metrics and responses",
            )
