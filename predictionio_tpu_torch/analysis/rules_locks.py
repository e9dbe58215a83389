"""Whole-program lock-order rules (rule family PIO-LOCK*).

Both rules run over the lock acquisition graph built by
``analysis/callgraph.py`` — nodes are lock definitions, edges are "held A
while acquiring B" facts collected intra-function and through resolved
calls (bounded depth).  The motivating hazard is this codebase's own
serving process: ~20 locks coordinate MicroBatcher waves, generation
swaps, breakers and the cost ledger, and no local rule can see an
inversion between two modules or a ``future.result()`` two calls below a
``with self._lock:``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator

from predictionio_tpu_torch.analysis.callgraph import LockEdge, Program
from predictionio_tpu_torch.analysis.findings import Finding, Severity
from predictionio_tpu_torch.analysis.rules import (
    ModuleInfo,
    ProgramRule,
    parent,
    resolve_call,
    resolve_name,
    rule,
    walk_skipping_defs,
)
from predictionio_tpu_torch.analysis.rules_concurrency import (
    _BLOCKING_CALLS,
    _BLOCKING_METHODS,
)

#: how deep interprocedural lock propagation follows resolved calls
LOCK_GRAPH_DEPTH = 4


def _fmt_path(path: tuple[tuple[str, str, int], ...]) -> str:
    return " -> ".join(f"{fn} ({file}:{line})" for fn, file, line in path)


def _program_finding(
    rule_obj, program: Program, file: str, line: int, message: str
) -> Finding:
    mod = program.module_by_rel.get(file)
    src = mod.line_text(line) if mod is not None else ""
    return Finding(
        rule=rule_obj.id,
        severity=rule_obj.severity,
        file=file,
        line=line,
        col=1,
        message=message,
        source=src,
    )


@rule
class LockOrderInversion(ProgramRule):
    """PIO-LOCK001: two lock-acquisition paths with opposite order."""

    id = "PIO-LOCK001"
    severity = Severity.HIGH
    summary = (
        "lock-order inversion: the same two locks are acquired in opposite "
        "orders on different paths — deadlock under concurrency"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        edges = {
            (e.src, e.dst): e for e in program.lock_edges(LOCK_GRAPH_DEPTH)
        }
        reported: set[frozenset[str]] = set()
        # pairwise inversions (A->B and B->A both observed)
        for a, b in sorted(edges):
            if a >= b or (b, a) not in edges:
                continue
            e1, e2 = edges[(a, b)], edges[(b, a)]
            reported.add(frozenset((a, b)))
            yield self._inversion_finding(program, e1, e2)
        # longer cycles (A->B->C->A with no direct back edge): one finding
        # per strongly-connected component not already covered pairwise
        adj: dict[str, set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        for scc in _sccs(adj):
            if len(scc) < 2:
                continue
            if any(
                frozenset((a, b)) in reported for a in scc for b in scc if a < b
            ):
                continue
            cycle = _find_cycle(sorted(scc), adj)
            if cycle is None:
                continue
            chain = [edges[(cycle[i], cycle[i + 1])] for i in range(len(cycle) - 1)]
            first = chain[0].path[0]
            msg = (
                "lock-order cycle through "
                + " -> ".join(f"'{k}'" for k in cycle)
                + ": "
                + "; ".join(
                    f"'{e.src}' -> '{e.dst}' via {_fmt_path(e.path)}"
                    for e in chain
                )
                + " — threads traversing different arcs of this cycle can "
                "deadlock; pick one global acquisition order"
            )
            yield _program_finding(self, program, first[1], first[2], msg)

    def _inversion_finding(
        self, program: Program, e1: LockEdge, e2: LockEdge
    ) -> Finding:
        first = e1.path[0]
        msg = (
            f"lock-order inversion between '{e1.src}' and '{e1.dst}': "
            f"'{e1.src}' is held while acquiring '{e1.dst}' via "
            f"{_fmt_path(e1.path)}, but '{e2.src}' is held while acquiring "
            f"'{e2.dst}' via {_fmt_path(e2.path)}; two threads taking these "
            "paths concurrently can deadlock — pick one global acquisition "
            "order"
        )
        return _program_finding(self, program, first[1], first[2], msg)


def _sccs(adj: dict[str, set[str]]) -> list[set[str]]:
    """Tarjan strongly-connected components (iterative)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[set[str]] = []
    counter = [0]
    nodes = sorted(set(adj) | {d for v in adj.values() for d in v})

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                comp: set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.add(w)
                    if w == v:
                        break
                out.append(comp)
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    for n in nodes:
        if n not in index:
            strongconnect(n)
    return out


def _find_cycle(
    nodes: list[str], adj: dict[str, set[str]]
) -> list[str] | None:
    """A simple cycle through the smallest node of an SCC (BFS back-path)."""
    start = nodes[0]
    scc = set(nodes)
    prev: dict[str, str] = {}
    queue = [start]
    seen = {start}
    while queue:
        v = queue.pop(0)
        for w in sorted(adj.get(v, ())):
            if w not in scc:
                continue
            if w == start:
                cycle = [start]
                cur = v
                back = []
                while cur != start:
                    back.append(cur)
                    cur = prev[cur]
                cycle.extend(reversed(back))
                cycle.append(start)
                return cycle
            if w not in seen:
                seen.add(w)
                prev[w] = v
                queue.append(w)
    return None


#: receiver-name fragments that mark a ``.join()`` as a thread/process wait
#: (str.join is everywhere — the receiver must look like an executor)
_JOIN_RECV_RE = re.compile(r"thread|worker|proc|executor|pool", re.I)


def _has_timeout(node: ast.Call) -> bool:
    """True when the call passes a (non-None) timeout: first positional arg
    or ``timeout=`` keyword — ``fut.result(5)``, ``t.join(timeout=2)``."""
    if node.args and not (
        isinstance(node.args[0], ast.Constant) and node.args[0].value is None
    ):
        return True
    for kw in node.keywords:
        if kw.arg == "timeout" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ):
            return True
    return False


def blocking_label(mod: ModuleInfo, node: ast.Call) -> str | None:
    """Label when ``node`` blocks the calling thread (exemptions applied):
    awaited calls yield the loop; ``.result``/``.join`` with a timeout are
    bounded waits.  Network/subprocess/sleep are flagged regardless of
    timeout — holding a lock across I/O is the hazard itself."""
    if isinstance(parent(node), ast.Await):
        return None
    callee = resolve_call(mod, node)
    if callee in _BLOCKING_CALLS:
        return callee
    if not isinstance(node.func, ast.Attribute):
        return None
    method = node.func.attr
    if method in _BLOCKING_METHODS:
        return f"*.{method}"
    if method == "result":
        recv = node.func.value
        if isinstance(recv, ast.Constant):
            return None
        return None if _has_timeout(node) else "*.result"
    if method == "join":
        recv_name = resolve_name(mod, node.func.value)
        if not _JOIN_RECV_RE.search(recv_name):
            return None
        return None if _has_timeout(node) else "*.join"
    return None


@rule
class BlockingCallUnderLock(ProgramRule):
    """PIO-LOCK002: blocking call while holding a lock (direct or through
    resolved calls within bounded depth)."""

    id = "PIO-LOCK002"
    severity = Severity.HIGH
    summary = (
        "blocking call (socket/urlopen/result/sleep/join/subprocess) while "
        "holding a lock; every other thread needing the lock stalls behind "
        "the I/O — or deadlocks if the waited work needs the same lock"
    )

    def check_program(self, program: Program) -> Iterable[Finding]:
        direct = self._direct_blocking(program)
        seen: set[tuple[str, int, str]] = set()
        # direct: the blocking call itself sits under a `with lock:`
        for qname in sorted(program.summaries):
            s = program.summaries[qname]
            fi = program.functions.get(qname)
            if fi is None:
                continue
            for hc in s.held_calls:
                label = blocking_label(fi.mod, hc.node)
                if label is None:
                    continue
                key = (fi.mod.rel, hc.node.lineno, label)
                if key in seen:
                    continue
                seen.add(key)
                yield _program_finding(
                    self,
                    program,
                    fi.mod.rel,
                    hc.node.lineno,
                    f"blocking call {label}(...) while holding lock "
                    f"'{hc.held[-1]}': the critical section now spans the "
                    "wait; move the call outside the lock (snapshot under "
                    "the lock, wait after release)",
                )
        # transitive: a call made under a lock reaches a blocking call
        for qname in sorted(program.summaries):
            s = program.summaries[qname]
            fi = program.functions.get(qname)
            if fi is None:
                continue
            for callee, line, held in s.calls:
                if not held:
                    continue
                for label, chain in self._reach_blocking(
                    program, direct, callee, LOCK_GRAPH_DEPTH - 1, (callee,)
                ):
                    key = (fi.mod.rel, line, label)
                    if key in seen:
                        continue
                    seen.add(key)
                    path = ((qname, fi.mod.rel, line),) + chain
                    yield _program_finding(
                        self,
                        program,
                        fi.mod.rel,
                        line,
                        f"this call reaches blocking {label}(...) while "
                        f"holding lock '{held[-1]}' (via {_fmt_path(path)}); "
                        "the wait happens inside the critical section — "
                        "restructure so the lock is released first",
                    )

    def _direct_blocking(
        self, program: Program
    ) -> dict[str, list[tuple[str, str, int]]]:
        """qname -> [(label, file, line)] of blocking calls in its own body."""
        out: dict[str, list[tuple[str, str, int]]] = {}
        for qname in sorted(program.functions):
            fi = program.functions[qname]
            hits: list[tuple[str, str, int]] = []
            for node in walk_skipping_defs(fi.node.body):
                if isinstance(node, ast.Call):
                    label = blocking_label(fi.mod, node)
                    if label is not None:
                        hits.append((label, fi.mod.rel, node.lineno))
            if hits:
                out[qname] = hits
        return out

    def _reach_blocking(
        self,
        program: Program,
        direct: dict[str, list[tuple[str, str, int]]],
        qname: str,
        depth: int,
        stack: tuple[str, ...],
    ) -> Iterator[tuple[str, tuple[tuple[str, str, int], ...]]]:
        for label, file, line in direct.get(qname, ()):
            yield label, ((qname, file, line),)
        if depth <= 0:
            return
        s = program.summaries.get(qname)
        if s is None:
            return
        fi = program.functions.get(qname)
        file = fi.mod.rel if fi else ""
        for callee, line, _held in s.calls:
            if callee in stack:
                continue
            for label, chain in self._reach_blocking(
                program, direct, callee, depth - 1, stack + (callee,)
            ):
                yield label, ((qname, file, line),) + chain
