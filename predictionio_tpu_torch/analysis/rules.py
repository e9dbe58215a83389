"""Rule framework: per-module AST context, rule registry, shared helpers.

Rules operate on a :class:`ModuleInfo` — a parsed module with parent links
annotated on every node and an import-alias table so ``F.linear`` and
``torch.nn.functional.linear`` resolve to the same canonical name.  Registration is a
decorator (:func:`rule`); the analyzer runs every registered rule unless a
subset is requested.
"""

from __future__ import annotations

import abc
import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

from predictionio_tpu_torch.analysis.findings import Finding, Severity

#: attribute set on every AST node pointing at its syntactic parent
_PARENT = "_pio_parent"


@dataclass
class ModuleInfo:
    """One parsed module handed to every rule."""

    path: Path  # absolute filesystem path
    rel: str  # posix path relative to the analysis root (finding.file)
    source: str
    lines: list[str] = field(default_factory=list)
    tree: ast.Module | None = None
    aliases: dict[str, str] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


def parse_module(path: Path, rel: str, source: str) -> ModuleInfo:
    tree = ast.parse(source, filename=str(path))
    annotate_parents(tree)
    return ModuleInfo(
        path=path,
        rel=rel,
        source=source,
        lines=source.splitlines(),
        tree=tree,
        aliases=build_aliases(tree),
    )


def annotate_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            setattr(child, _PARENT, node)


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, _PARENT, None)


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing_function(
    node: ast.AST,
) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
    for a in ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return a
    return None


def build_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> canonical dotted path, from module-level imports
    (including those under module-level if/try, but NOT function-local
    imports — a `from time import sleep` inside one function must not make
    a bare `sleep` in another function resolve to time.sleep).

    ``import numpy as np`` -> {'np': 'numpy'};
    ``from torch import compile`` -> {'compile': 'torch.compile'};
    ``import torch.nn.functional as F`` -> {'F': 'torch.nn.functional'}.
    """
    aliases: dict[str, str] = {}
    for node in walk_skipping_defs(tree.body):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.partition(".")[0]] = (
                    a.name if a.asname else a.name.partition(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted_name(expr: ast.AST) -> str | None:
    """'a.b.c' for Name/Attribute chains; None for anything else."""
    parts: list[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def resolve_name(mod: ModuleInfo, expr: ast.AST) -> str:
    """Canonical dotted name of an expression through the alias table.

    Attribute access on a non-name receiver (``x.item``) renders as
    ``*.item`` so rules can match method names independent of the receiver.
    """
    d = dotted_name(expr)
    if d is None:
        if isinstance(expr, ast.Attribute):
            return "*." + expr.attr
        return ""
    head, dot, rest = d.partition(".")
    base = mod.aliases.get(head, head)
    return base + dot + rest if rest else base


def resolve_call(mod: ModuleInfo, node: ast.Call) -> str:
    return resolve_name(mod, node.func)


def walk_skipping_defs(body: Iterable[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class defs
    or lambda bodies — code in those scopes is deferred, not inline."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


# -- compile decorator introspection (shared by the PyTorch rules) ----------

#: wrappers that trace/compile a Python function into a graph
_COMPILE_NAMES = frozenset(("torch.compile", "torch.jit.script"))

#: parameter annotations the compiler specializes on as guarded Python
#: constants (the counterpart of JAX's static_argnames): branching on such
#: a value is resolved at trace time, never on a tensor
_STATIC_ANNOTATIONS = frozenset(("bool", "int", "float", "str"))


def _is_compile_expr(mod: ModuleInfo, expr: ast.AST) -> bool:
    return resolve_name(mod, expr) in _COMPILE_NAMES


def compile_decorator_info(
    mod: ModuleInfo, fn: ast.FunctionDef | ast.AsyncFunctionDef
) -> tuple[bool, set[str]]:
    """(is_compiled, static_argnames) from the decorator list and signature.

    Recognizes ``@torch.compile``, ``@torch.compile(...)``,
    ``@torch.jit.script``, ``@compile`` (aliased import) and
    ``@partial(torch.compile, ...)``.  Parameters annotated with a Python
    scalar type (``flag: bool``) are the static ones.
    """
    compiled = False
    for dec in fn.decorator_list:
        if _is_compile_expr(mod, dec):
            compiled = True
        elif isinstance(dec, ast.Call):
            callee = resolve_name(mod, dec.func)
            if callee in _COMPILE_NAMES or (
                callee == "functools.partial"
                and dec.args
                and _is_compile_expr(mod, dec.args[0])
            ):
                compiled = True
    static_names: set[str] = set()
    if compiled:
        args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        for a in args:
            ann = a.annotation
            if isinstance(ann, ast.Name) and ann.id in _STATIC_ANNOTATIONS:
                static_names.add(a.arg)
    return compiled, static_names


# -- registry ---------------------------------------------------------------


class Rule(abc.ABC):
    """One lint: an id, a fixed severity, and an AST check."""

    id: str = ""
    severity: Severity = Severity.MEDIUM
    summary: str = ""

    @abc.abstractmethod
    def check(self, mod: ModuleInfo) -> Iterable[Finding]: ...

    def finding(self, mod: ModuleInfo, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=self.id,
            severity=self.severity,
            file=mod.rel,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            source=mod.line_text(line),
        )


class ProgramRule(Rule):
    """Whole-program rule: runs once over every parsed module at a time.

    Per-module ``check`` is a no-op; the analyzer calls ``check_program``
    with a :class:`predictionio_tpu_torch.analysis.callgraph.Program` built from
    all modules in the scan.  Findings still carry a per-file ``rel`` path,
    so pragma and baseline suppression work unchanged.  Note the scan scope
    IS the analysis scope: running a program rule on a single file cannot
    see edges into other modules.
    """

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        return ()

    @abc.abstractmethod
    def check_program(self, program) -> Iterable[Finding]: ...


#: id -> rule instance; populated by the @rule decorator at import time
ALL_RULES: dict[str, Rule] = {}


def rule(cls: type[Rule]) -> type[Rule]:
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in ALL_RULES:
        raise ValueError(f"duplicate rule id {inst.id}")
    ALL_RULES[inst.id] = inst
    return cls
