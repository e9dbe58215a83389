"""Whole-program engine: intra-package call graph + lock acquisition graph.

The per-module rules (PIO-TORCH/CONC/...) are deliberately local — they see
one function at a time.  This module is the interprocedural half: it takes
every :class:`ModuleInfo` in a scan, resolves calls *within the scanned
package* (module functions, methods via ``self``/``cls``, import aliases,
class constructors, nested defs), and derives two graphs:

  - the **call graph** — ``caller qname -> [CallSite]`` with bounded-depth
    reachability queries (PIO-TORCH008 walks it from the serving seams), and
  - the **lock acquisition graph** — nodes are lock *definitions*
    (``module:Class.attr`` / ``module:VAR`` over threading.Lock/RLock/
    Condition and the ContendedLock/ContendedCondition wrappers), edges are
    "held A while acquiring B" facts, both intra-function (``with a:`` then
    ``with b:``) and through calls (holding A, call g(), g acquires B).
    Each edge carries the acquisition path so a lock-order inversion report
    can show both sides of the cycle (PIO-LOCK001).

Resolution limits (documented in docs/static_analysis.md): attribute calls
on unresolvable receivers (``self.batcher.submit()``) produce no edge;
dynamic dispatch through dicts/callbacks is invisible; ``held`` sets are
an over-approximation (an acquire() in a branch is assumed held until the
matching release() in the same function).  Everything here is stdlib-ast
only — building a Program never imports the analyzed code.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

from predictionio_tpu_torch.analysis.rules import ModuleInfo, dotted_name

#: constructors whose result participates in the lock acquisition graph
_LOCK_CTORS = frozenset(
    (
        "threading.Lock",
        "threading.RLock",
        "threading.Condition",
        "predictionio_tpu_torch.obs.contention.ContendedLock",
        "predictionio_tpu_torch.obs.contention.ContendedCondition",
    )
)

#: ctor names whose first positional string argument is the runtime witness
#: name (what LockWitness records at acquisition time)
_WITNESS_CTORS = frozenset(
    (
        "predictionio_tpu_torch.obs.contention.ContendedLock",
        "predictionio_tpu_torch.obs.contention.ContendedCondition",
    )
)

#: attribute names that look like a synchronization primitive even when the
#: constructor is out of view (lock injected via a parameter); mirrors the
#: CONC003 heuristic
_LOCK_ATTR_RE = re.compile(r"^_?(lock|cond|condition|mutex|rlock)$|_lock$|_cond$")


def module_name(rel: str) -> str:
    """Dotted module name from a root-relative posix path."""
    p = rel[:-3] if rel.endswith(".py") else rel
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<module>"


@dataclass
class FunctionInfo:
    """One def (module function, method, or nested function)."""

    qname: str  # "pkg.mod:C.m" / "pkg.mod:f" / "pkg.mod:f.<locals>.g"
    name: str  # bare def name
    mod: ModuleInfo
    node: ast.FunctionDef | ast.AsyncFunctionDef
    cls_name: str | None  # dotted class path within the module, if a method
    parent_fn: str | None = None  # qname of the lexically enclosing function
    nested: dict[str, str] = field(default_factory=dict)  # bare -> qname


@dataclass(frozen=True)
class CallSite:
    """One resolved intra-package call."""

    callee: str  # qname
    file: str
    line: int


@dataclass
class LockNode:
    """One lock definition (or first lock-like reference)."""

    key: str  # "pkg.mod:C.attr" or "pkg.mod:VAR"
    file: str
    line: int
    witness: str | None = None  # ContendedLock/Condition runtime name


@dataclass(frozen=True)
class Acquisition:
    lock: str  # LockNode key
    file: str
    line: int
    held: tuple[str, ...]  # lock keys already held at this point


@dataclass(frozen=True)
class HeldCall:
    """A call made while holding at least one lock (resolved or not)."""

    node: ast.Call
    held: tuple[str, ...]


@dataclass
class FnSummary:
    """Per-function lock facts feeding the acquisition graph."""

    acquisitions: list[Acquisition] = field(default_factory=list)
    #: resolved calls with the held set at the call site (held may be empty)
    calls: list[tuple[str, int, tuple[str, ...]]] = field(default_factory=list)
    #: every raw Call node made while holding a lock (for PIO-LOCK002)
    held_calls: list[HeldCall] = field(default_factory=list)


@dataclass(frozen=True)
class LockEdge:
    """'held ``src`` while acquiring ``dst``', with the acquisition path."""

    src: str
    dst: str
    #: (fn qname, file, line) chain: call sites leading to dst's acquisition
    path: tuple[tuple[str, str, int], ...]


class Program:
    """All modules of one scan, indexed for interprocedural queries."""

    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}  # module name -> info
        self.module_by_rel: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.call_edges: dict[str, list[CallSite]] = {}
        self.locks: dict[str, LockNode] = {}
        self.summaries: dict[str, FnSummary] = {}
        # -- indices populated while the program is built --
        self._mod_functions: dict[str, dict[str, str]] = {}
        self._methods: dict[tuple[str, str], dict[str, str]] = {}
        self._bases: dict[tuple[str, str], list[tuple[str, str]]] = {}
        #: (module, class, attr) -> (module, class) for `self.attr = C(...)`
        self._attr_types: dict[tuple[str, str, str], tuple[str, str]] = {}
        #: (module, var) -> (module, class) for module-level `V = C(...)`
        self._var_types: dict[tuple[str, str], tuple[str, str]] = {}
        self._lock_edges: list[LockEdge] | None = None

    # -- call graph queries -------------------------------------------------

    def callees(self, qname: str) -> list[CallSite]:
        return self.call_edges.get(qname, [])

    def reachable(
        self, roots: Iterable[str], max_depth: int = 4
    ) -> dict[str, tuple[tuple[str, str, int], ...]]:
        """BFS from ``roots``: reached qname -> shortest call chain.

        The chain is ``((caller, file, line), ...)`` for each hop; roots map
        to an empty chain.  Ties break on discovery order, which is the
        sorted-qname order of the roots and then call-site order, so the
        result is deterministic.
        """
        out: dict[str, tuple[tuple[str, str, int], ...]] = {}
        frontier = [(q, ()) for q in sorted(set(roots)) if q in self.functions]
        for q, _chain in frontier:
            out[q] = ()
        depth = 0
        while frontier and depth < max_depth:
            depth += 1
            nxt: list[tuple[str, tuple[tuple[str, str, int], ...]]] = []
            for q, chain in frontier:
                for site in self.call_edges.get(q, []):
                    if site.callee in out:
                        continue
                    hop = chain + ((q, site.file, site.line),)
                    out[site.callee] = hop
                    nxt.append((site.callee, hop))
            frontier = nxt
        return out

    # -- lock graph queries -------------------------------------------------

    def transitive_acquisitions(
        self, qname: str, max_depth: int = 4
    ) -> dict[str, tuple[tuple[str, str, int], ...]]:
        """Locks ``qname`` may acquire (itself or via calls, bounded depth).

        Returns lock key -> ``((fn, file, line), ...)`` chain ending at the
        acquisition site.
        """
        return self._acq(qname, max_depth, (qname,))

    def _acq(
        self, qname: str, depth: int, stack: tuple[str, ...]
    ) -> dict[str, tuple[tuple[str, str, int], ...]]:
        out: dict[str, tuple[tuple[str, str, int], ...]] = {}
        s = self.summaries.get(qname)
        if s is None:
            return out
        for a in s.acquisitions:
            out.setdefault(a.lock, ((qname, a.file, a.line),))
        if depth <= 0:
            return out
        fi = self.functions.get(qname)
        file = fi.mod.rel if fi else ""
        for callee, line, _held in s.calls:
            if callee in stack:
                continue
            for lk, chain in self._acq(
                callee, depth - 1, stack + (callee,)
            ).items():
                out.setdefault(lk, ((qname, file, line),) + chain)
        return out

    def lock_edges(self, max_depth: int = 4) -> list[LockEdge]:
        """The full acquisition-order edge set (deduped, first path wins)."""
        if self._lock_edges is not None:
            return self._lock_edges
        edges: dict[tuple[str, str], LockEdge] = {}

        def add(src: str, dst: str, path: tuple[tuple[str, str, int], ...]):
            if src != dst:
                edges.setdefault((src, dst), LockEdge(src, dst, path))

        for qname in sorted(self.summaries):
            s = self.summaries[qname]
            for a in s.acquisitions:
                for h in a.held:
                    add(h, a.lock, ((qname, a.file, a.line),))
            fi = self.functions.get(qname)
            file = fi.mod.rel if fi else ""
            for callee, line, held in s.calls:
                if not held:
                    continue
                for lk, chain in self.transitive_acquisitions(
                    callee, max_depth - 1
                ).items():
                    for h in held:
                        add(h, lk, ((qname, file, line),) + chain)
        self._lock_edges = [edges[k] for k in sorted(edges)]
        return self._lock_edges

    def witness_edge_allowlist(self, max_depth: int = 4) -> set[tuple[str, str]]:
        """Static ordered pairs in runtime-witness names.

        Maps every static edge (and its transitive closure, since a witness
        sees the whole held *stack*, not just the innermost lock) through
        the ContendedLock witness names; pairs involving locks without a
        witness name (plain threading locks — invisible at runtime) drop
        out.  The LockWitness's observed edge set must be a subset of this.
        """
        direct: dict[str, set[str]] = {}
        for e in self.lock_edges(max_depth):
            direct.setdefault(e.src, set()).add(e.dst)
        # transitive closure (the graphs here are tiny)
        closed: dict[str, set[str]] = {k: set(v) for k, v in direct.items()}
        changed = True
        while changed:
            changed = False
            for src, dsts in closed.items():
                for d in list(dsts):
                    for d2 in closed.get(d, ()):
                        if d2 not in dsts:
                            dsts.add(d2)
                            changed = True
        out: set[tuple[str, str]] = set()
        for src, dsts in closed.items():
            w1 = self.locks[src].witness if src in self.locks else None
            if not w1:
                continue
            for dst in dsts:
                w2 = self.locks[dst].witness if dst in self.locks else None
                if w2 and w1 != w2:
                    out.add((w1, w2))
        return out

    # -- serialization (pio check --graph) ----------------------------------

    def to_json(self, max_depth: int = 4) -> dict:
        return {
            "version": 1,
            "callgraph": {
                "functions": sorted(self.functions),
                "edges": [
                    {
                        "caller": q,
                        "callee": s.callee,
                        "file": s.file,
                        "line": s.line,
                    }
                    for q in sorted(self.call_edges)
                    for s in self.call_edges[q]
                ],
            },
            "locks": {
                "nodes": [
                    {
                        "key": n.key,
                        "file": n.file,
                        "line": n.line,
                        "witness": n.witness,
                    }
                    for _, n in sorted(self.locks.items())
                ],
                "edges": [
                    {
                        "src": e.src,
                        "dst": e.dst,
                        "path": [
                            {"fn": fn, "file": f, "line": ln}
                            for fn, f, ln in e.path
                        ],
                    }
                    for e in self.lock_edges(max_depth)
                ],
            },
        }


# -- construction ------------------------------------------------------------


def build_program(mods: Sequence[ModuleInfo]) -> Program:
    b = _Builder()
    for mod in mods:
        b.index_module(mod)
    b.resolve()
    return b.program


class _Builder:
    def __init__(self) -> None:
        self.program = Program()

    # -- pass 1: index defs, classes, lock definitions ----------------------

    def index_module(self, mod: ModuleInfo) -> None:
        p = self.program
        mname = module_name(mod.rel)
        p.modules[mname] = mod
        p.module_by_rel[mod.rel] = mod
        p._mod_functions.setdefault(mname, {})
        self._index_body(
            mod, mname, mod.tree.body, scope=(), cls_path=None, parent_fn=None
        )
        self._index_module_locks(mod, mname)

    def _index_body(
        self,
        mod: ModuleInfo,
        mname: str,
        body: Iterable[ast.stmt],
        scope: tuple[str, ...],
        cls_path: str | None,
        parent_fn: str | None,
    ) -> None:
        p = self.program
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                path = scope + (node.name,)
                qname = f"{mname}:{'.'.join(path)}"
                fi = FunctionInfo(
                    qname=qname,
                    name=node.name,
                    mod=mod,
                    node=node,
                    cls_name=cls_path,
                    parent_fn=parent_fn,
                )
                p.functions[qname] = fi
                if parent_fn is not None and parent_fn in p.functions:
                    p.functions[parent_fn].nested[node.name] = qname
                if not scope:
                    p._mod_functions[mname][node.name] = qname
                elif cls_path is not None and scope == tuple(
                    cls_path.split(".")
                ):
                    p._methods.setdefault((mname, cls_path), {})[
                        node.name
                    ] = qname
                # nested defs close over self: keep the class context
                self._index_body(
                    mod,
                    mname,
                    node.body,
                    path + ("<locals>",),
                    cls_path,
                    qname,
                )
            elif isinstance(node, ast.ClassDef):
                new_cls = (
                    f"{cls_path}.{node.name}" if cls_path else node.name
                )
                self._index_class_bases(mod, mname, new_cls, node)
                self._index_body(
                    mod,
                    mname,
                    node.body,
                    scope + (node.name,),
                    new_cls,
                    parent_fn,
                )
            elif isinstance(node, (ast.If, ast.Try)):
                # defs under module-level guards still exist at runtime
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, ast.stmt):
                        self._index_body(
                            mod, mname, [sub], scope, cls_path, parent_fn
                        )

    def _index_class_bases(
        self, mod: ModuleInfo, mname: str, cls_path: str, node: ast.ClassDef
    ) -> None:
        resolved: list[tuple[str, str]] = []
        for base in node.bases:
            d = dotted_name(base)
            if d is None:
                continue
            head, dot, rest = d.partition(".")
            full = mod.aliases.get(head, head) + (dot + rest if rest else "")
            if "." not in full:
                resolved.append((mname, full))  # same-module base
            else:
                m, _, c = full.rpartition(".")
                resolved.append((m, c))
        self.program._bases[(mname, cls_path)] = resolved

    def _index_module_locks(self, mod: ModuleInfo, mname: str) -> None:
        """Module-level ``X = threading.Lock()`` style definitions, plus
        ``self.attr = <ctor>`` lock attributes anywhere in the module."""
        p = self.program
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            ctor = _resolve_in(mod, node.value.func)
            if ctor not in _LOCK_CTORS:
                continue
            witness = None
            if ctor in _WITNESS_CTORS and node.value.args:
                a0 = node.value.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    witness = a0.value
            for tgt in node.targets:
                key = None
                if isinstance(tgt, ast.Name):
                    # only module-level names define module locks
                    from predictionio_tpu_torch.analysis.rules import (
                        enclosing_function,
                    )

                    if enclosing_function(node) is None:
                        key = f"{mname}:{tgt.id}"
                elif (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in ("self", "cls")
                ):
                    cls = _enclosing_class_path(node)
                    if cls:
                        key = f"{mname}:{cls}.{tgt.attr}"
                if key is None:
                    continue
                prior = p.locks.get(key)
                if prior is None or prior.witness is None:
                    p.locks[key] = LockNode(
                        key=key,
                        file=mod.rel,
                        line=node.lineno,
                        witness=witness or (prior.witness if prior else None),
                    )

    # -- pass 1.5: single-assignment instance typing ------------------------

    def _index_instance_types(self) -> None:
        """``self.attr = C(...)`` and module-level ``V = C(...)`` where C is
        an intra-package class: the attribute/var is typed C, so method
        calls through it resolve.  Best-effort — conditional or re-bound
        attributes keep whatever assignment is seen last."""
        p = self.program
        for mname in sorted(p.modules):
            mod = p.modules[mname]
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign):
                    continue
                if not isinstance(node.value, ast.Call):
                    continue
                cls_key = self._class_of_ctor(mod, mname, node.value.func)
                if cls_key is None:
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id in ("self", "cls")
                    ):
                        cls = _enclosing_class_path(node)
                        if cls:
                            p._attr_types[(mname, cls, tgt.attr)] = cls_key
                    elif isinstance(tgt, ast.Name):
                        from predictionio_tpu_torch.analysis.rules import (
                            enclosing_function,
                        )

                        if enclosing_function(node) is None:
                            p._var_types[(mname, tgt.id)] = cls_key

    def _class_of_ctor(
        self, mod: ModuleInfo, mname: str, func: ast.AST
    ) -> tuple[str, str] | None:
        d = dotted_name(func)
        if d is None:
            return None
        head, dot, rest = d.partition(".")
        full = mod.aliases.get(head, head) + (dot + rest if rest else "")
        if "." not in full:
            key = (mname, full)
            return key if self._is_class(key) else None
        m, _, c = full.rpartition(".")
        key = (m, c)
        return key if self._is_class(key) else None

    def _is_class(self, key: tuple[str, str]) -> bool:
        p = self.program
        return key in p._methods or key in p._bases

    # -- pass 2: resolve calls + lock scopes per function -------------------

    def resolve(self) -> None:
        p = self.program
        self._index_instance_types()
        for qname in sorted(p.functions):
            fi = p.functions[qname]
            scanner = _FnScanner(self, fi)
            scanner.run()
            p.call_edges[qname] = scanner.sites
            p.summaries[qname] = scanner.summary

    # -- shared resolution helpers ------------------------------------------

    def resolve_dotted(self, mname: str, full: str) -> str | None:
        """qname for a canonical dotted path, trying (in order) same-module
        class methods, intra-package module functions/classes, and
        cross-module ``pkg.mod.C.m`` references."""
        p = self.program
        parts = full.split(".")
        # same-module Class.method (head is a class in mname)
        if len(parts) >= 2:
            meth = p._methods.get((mname, ".".join(parts[:-1])))
            if meth and parts[-1] in meth:
                return meth[parts[-1]]
        for i in range(len(parts) - 1, 0, -1):
            m = ".".join(parts[:i])
            if m not in p.modules:
                continue
            rest = parts[i:]
            if len(rest) == 1:
                fn = p._mod_functions.get(m, {}).get(rest[0])
                if fn:
                    return fn
                return self.method_on_class(m, rest[0], "__init__")
            if len(rest) == 2:
                hit = self.method_on_class(m, rest[0], rest[1])
                if hit:
                    return hit
            return None
        return None

    def method_on_class(
        self, mname: str, cls: str, meth: str
    ) -> str | None:
        """Method lookup through the intra-package MRO (bounded)."""
        p = self.program
        seen: set[tuple[str, str]] = set()
        queue = [(mname, cls)]
        while queue:
            key = queue.pop(0)
            if key in seen:
                continue
            seen.add(key)
            hit = p._methods.get(key, {}).get(meth)
            if hit:
                return hit
            queue.extend(p._bases.get(key, ()))
        return None

    def resolve_call_target(
        self, fi: FunctionInfo, call: ast.Call
    ) -> str | None:
        p = self.program
        mod = fi.mod
        mname = module_name(mod.rel)
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            # lexical scope chain of nested defs
            cur: FunctionInfo | None = fi
            while cur is not None:
                if name in cur.nested:
                    return cur.nested[name]
                cur = (
                    p.functions.get(cur.parent_fn)
                    if cur.parent_fn
                    else None
                )
            hit = p._mod_functions.get(mname, {}).get(name)
            if hit:
                return hit
            hit = self.method_on_class(mname, name, "__init__")
            if hit:
                return hit
            target = mod.aliases.get(name)
            if target:
                return self.resolve_dotted(mname, target)
            return None
        if isinstance(func, ast.Attribute):
            recv = func.value
            if (
                isinstance(recv, ast.Name)
                and recv.id in ("self", "cls")
                and fi.cls_name
            ):
                return self.method_on_class(mname, fi.cls_name, func.attr)
            # typed instance attribute: self.batcher.submit() where
            # __init__ did `self.batcher = MicroBatcher(...)`
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id in ("self", "cls")
                and fi.cls_name
            ):
                t = self._attr_type(mname, fi.cls_name, recv.attr)
                if t is not None:
                    return self.method_on_class(t[0], t[1], func.attr)
            d = dotted_name(func)
            if d is not None:
                head, dot, rest = d.partition(".")
                full = mod.aliases.get(head, head) + (
                    dot + rest if rest else ""
                )
                hit = self.resolve_dotted(mname, full)
                if hit:
                    return hit
                # typed module-level instance: REGISTRY.counter(...)
                if "." in full:
                    owner, _, meth = full.rpartition(".")
                    om, _, ovar = owner.rpartition(".")
                    t = self.program._var_types.get(
                        (om or mname, ovar)
                    ) or self.program._var_types.get((mname, owner))
                    if t is not None:
                        return self.method_on_class(t[0], t[1], meth)
        return None

    def _attr_type(
        self, mname: str, cls: str, attr: str
    ) -> tuple[str, str] | None:
        hit = self.program._attr_types.get((mname, cls, attr))
        if hit is not None:
            return hit
        for bm, bc in self._mro(mname, cls):
            hit = self.program._attr_types.get((bm, bc, attr))
            if hit is not None:
                return hit
        return None

    def lock_key(self, fi: FunctionInfo, expr: ast.AST) -> str | None:
        """Lock-graph node key for an acquired expression, or None."""
        p = self.program
        mod = fi.mod
        mname = module_name(mod.rel)
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id in ("self", "cls")
            and fi.cls_name
        ):
            key = f"{mname}:{fi.cls_name}.{expr.attr}"
            if key in p.locks or _LOCK_ATTR_RE.search(expr.attr):
                if key not in p.locks:
                    p.locks[key] = LockNode(
                        key=key, file=mod.rel, line=expr.lineno
                    )
                return key
            # inherited lock attribute: match a base class definition
            for bm, bc in self._mro(mname, fi.cls_name):
                bkey = f"{bm}:{bc}.{expr.attr}"
                if bkey in p.locks:
                    return bkey
            return None
        d = dotted_name(expr)
        if d is None:
            return None
        head, dot, rest = d.partition(".")
        full = mod.aliases.get(head, head) + (dot + rest if rest else "")
        if "." not in full:
            key = f"{mname}:{full}"
            return key if key in p.locks else None
        m, _, var = full.rpartition(".")
        key = f"{m}:{var}"
        return key if key in p.locks else None

    def _mro(self, mname: str, cls: str) -> Iterator[tuple[str, str]]:
        seen: set[tuple[str, str]] = set()
        queue = list(self.program._bases.get((mname, cls), ()))
        while queue:
            key = queue.pop(0)
            if key in seen:
                continue
            seen.add(key)
            yield key
            queue.extend(self.program._bases.get(key, ()))


class _FnScanner:
    """Statement-ordered walk of one function body: resolved call sites,
    lock acquisitions with the held set, and calls made under a lock."""

    def __init__(self, builder: _Builder, fi: FunctionInfo) -> None:
        self.b = builder
        self.fi = fi
        self.sites: list[CallSite] = []
        self.summary = FnSummary()
        self.held: list[str] = []

    def run(self) -> None:
        for stmt in self.fi.node.body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return  # separate scope; scanned as its own FunctionInfo
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            entered: list[str] = []
            for item in stmt.items:
                self._expr(item.context_expr, skip_lock_call=True)
                if item.optional_vars is not None:
                    self._expr(item.optional_vars)
                key = self._lock_of(item.context_expr)
                if key is not None:
                    self._record_acquire(key, item.context_expr)
                    if key not in self.held:
                        self.held.append(key)
                        entered.append(key)
            for sub in stmt.body:
                self._stmt(sub)
            for key in entered:
                self.held.remove(key)
            return
        for fname, value in ast.iter_fields(stmt):
            if isinstance(value, ast.stmt):
                self._stmt(value)
            elif isinstance(value, ast.expr):
                self._expr(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._stmt(v)
                    elif isinstance(v, ast.expr):
                        self._expr(v)
                    elif isinstance(v, (ast.withitem, ast.excepthandler)):
                        self._generic(v)
                    elif isinstance(v, getattr(ast, "match_case", ())):
                        self._generic(v)

    def _generic(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, ast.expr):
                self._expr(child)
            else:
                self._generic(child)

    def _expr(self, expr: ast.expr, skip_lock_call: bool = False) -> None:
        """Find Call nodes inside an expression, in source order, without
        descending into lambda bodies (deferred code)."""
        for node in _walk_expr(expr):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr == "acquire":
                    key = self._lock_of(func.value)
                    if key is not None:
                        if not skip_lock_call:
                            self._record_acquire(key, node)
                            if key not in self.held:
                                self.held.append(key)
                        continue
                elif func.attr == "release":
                    key = self._lock_of(func.value)
                    if key is not None:
                        if key in self.held:
                            self.held.remove(key)
                        continue
            callee = self.b.resolve_call_target(self.fi, node)
            if callee is not None:
                self.sites.append(
                    CallSite(callee, self.fi.mod.rel, node.lineno)
                )
                self.summary.calls.append(
                    (callee, node.lineno, tuple(self.held))
                )
            if self.held:
                self.summary.held_calls.append(
                    HeldCall(node, tuple(self.held))
                )

    def _lock_of(self, expr: ast.AST) -> str | None:
        return self.b.lock_key(self.fi, expr)

    def _record_acquire(self, key: str, node: ast.AST) -> None:
        self.summary.acquisitions.append(
            Acquisition(
                lock=key,
                file=self.fi.mod.rel,
                line=getattr(node, "lineno", 1),
                held=tuple(self.held),
            )
        )


def _walk_expr(expr: ast.expr) -> Iterator[ast.AST]:
    stack: list[ast.AST] = [expr]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, ast.Lambda):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


# -- module-local helpers -----------------------------------------------------


def _resolve_in(mod: ModuleInfo, expr: ast.AST) -> str:
    from predictionio_tpu_torch.analysis.rules import resolve_name

    return resolve_name(mod, expr)


def _enclosing_class_path(node: ast.AST) -> str | None:
    from predictionio_tpu_torch.analysis.rules import ancestors

    parts: list[str] = []
    for a in ancestors(node):
        if isinstance(a, ast.ClassDef):
            parts.append(a.name)
    if not parts:
        return None
    return ".".join(reversed(parts))
