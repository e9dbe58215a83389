"""Concurrency lints (rule family PIO-CONC*).

Motivating cases come from this codebase's own serving stack: the asyncio
front end (server/aio.py) where one blocking call in an ``async def`` stalls
every connection, the microbatch worker where a polling loop burns a core
and adds latency quantization, and lock-guarded shared state (obs registry,
microbatch queue) where one unlocked writer defeats every locked one.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator

from predictionio_tpu_torch.analysis.findings import Finding, Severity
from predictionio_tpu_torch.analysis.rules import (
    ModuleInfo,
    Rule,
    ancestors,
    parent,
    resolve_call,
    rule,
    walk_skipping_defs,
)

#: canonical names of calls that block the calling thread
_BLOCKING_CALLS = frozenset(
    (
        "time.sleep",
        "subprocess.run",
        "subprocess.call",
        "subprocess.check_call",
        "subprocess.check_output",
        "subprocess.Popen",
        "os.system",
        "os.popen",
        "os.waitpid",
        "os.wait",
        "urllib.request.urlopen",
        "requests.get",
        "requests.post",
        "requests.put",
        "requests.delete",
        "requests.head",
        "requests.request",
        "socket.create_connection",
    )
)

#: blocking *method* names on arbitrary receivers.  Kept to names that are
#: unambiguous on any receiver: sock.recv/accept and serve_forever.  NOT
#: `.join` — str.join is everywhere and the receiver type is unknowable
#: statically.
_BLOCKING_METHODS = frozenset(("serve_forever", "recv", "accept"))


@rule
class BlockingCallInAsync(Rule):
    """PIO-CONC001: blocking call directly inside an `async def` body."""

    id = "PIO-CONC001"
    severity = Severity.HIGH
    summary = (
        "blocking call inside async def; stalls the event loop — use "
        "asyncio equivalents or run_in_executor"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in walk_skipping_defs(fn.body):
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(parent(node), ast.Await):
                    continue  # awaited calls yield the loop — not blocking
                callee = resolve_call(mod, node)
                method = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else ""
                )
                if callee in _BLOCKING_CALLS or method in _BLOCKING_METHODS:
                    label = callee if callee in _BLOCKING_CALLS else method
                    yield self.finding(
                        mod,
                        node,
                        f"blocking call {label}(...) inside async function "
                        f"{fn.name!r} stalls the event loop for every "
                        "connection; await an asyncio equivalent or push it "
                        "to an executor (loop.run_in_executor)",
                    )


@rule
class BusyWaitPoll(Rule):
    """PIO-CONC002: while-loop polling with time.sleep (busy-wait)."""

    id = "PIO-CONC002"
    severity = Severity.HIGH
    summary = (
        "polling busy-wait (while + time.sleep); use an Event/Condition "
        "wakeup instead"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.While):
                continue
            for sub in walk_skipping_defs(node.body):
                if (
                    isinstance(sub, ast.Call)
                    and resolve_call(mod, sub) == "time.sleep"
                    # a nested while owns its own sleep; report once, at the
                    # innermost loop that contains the call
                    and not any(
                        isinstance(a, ast.While) and a is not node
                        for a in _ancestors_until(sub, node)
                    )
                ):
                    yield self.finding(
                        mod,
                        node,
                        "busy-wait: this loop polls with time.sleep, which "
                        "burns CPU and quantizes wakeup latency to the poll "
                        "interval; wait on a threading.Event/Condition (or "
                        "asyncio.Event) that the producer notifies",
                    )
                    break


def _ancestors_until(node: ast.AST, stop: ast.AST) -> Iterator[ast.AST]:
    for a in ancestors(node):
        if a is stop:
            return
        yield a


#: self-attributes that look like synchronization primitives
_LOCK_ATTR_RE = re.compile(r"^_?(lock|cond|condition|mutex|rlock)$|_lock$|_cond$")

#: threading constructors whose result is a lock-like guard.  The metered
#: wrappers (obs/contention.py) count too: adopting ContendedLock on a hot
#: lock must not silently retire the unlocked-mutation check for the state
#: it guards.
_LOCK_CTORS = frozenset(
    (
        "threading.Lock",
        "threading.RLock",
        "threading.Condition",
        "threading.Semaphore",
        "threading.BoundedSemaphore",
        "predictionio_tpu_torch.obs.contention.ContendedLock",
        "predictionio_tpu_torch.obs.contention.ContendedCondition",
    )
)

#: container methods that mutate their receiver
_MUTATING_METHODS = frozenset(
    (
        "append",
        "appendleft",
        "extend",
        "insert",
        "add",
        "update",
        "pop",
        "popleft",
        "popitem",
        "remove",
        "discard",
        "clear",
        "setdefault",
    )
)


@rule
class UnlockedGuardedMutation(Rule):
    """PIO-CONC003: attribute mutated under a lock in one method, mutated
    without it in another."""

    id = "PIO-CONC003"
    severity = Severity.HIGH
    summary = (
        "lock-guarded attribute mutated outside the lock; one unlocked "
        "writer defeats every locked one"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(mod, cls)

    def _check_class(
        self, mod: ModuleInfo, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        lock_attrs = self._lock_attrs(mod, cls)
        if not lock_attrs:
            return
        guarded: set[str] = set()
        unlocked: list[tuple[str, ast.AST, str]] = []  # (attr, node, method)
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            in_init = item.name == "__init__"
            for attr, node, under_lock in self._mutations(item, lock_attrs):
                if under_lock:
                    guarded.add(attr)
                elif not in_init:
                    unlocked.append((attr, node, item.name))
        for attr, node, method in unlocked:
            if attr in guarded:
                yield self.finding(
                    mod,
                    node,
                    f"self.{attr} is mutated under a lock elsewhere in "
                    f"{cls.name} but written here ({method}) without "
                    "holding it; acquire the same lock (or move the write "
                    "inside the existing critical section)",
                )

    def _lock_attrs(self, mod: ModuleInfo, cls: ast.ClassDef) -> set[str]:
        attrs: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and isinstance(node.value, ast.Call)
                        and resolve_call(mod, node.value) in _LOCK_CTORS
                    ):
                        attrs.add(tgt.attr)
        for node in ast.walk(cls):
            if isinstance(node, ast.With):
                for withitem in node.items:
                    ce = withitem.context_expr
                    if (
                        isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"
                        and _LOCK_ATTR_RE.search(ce.attr)
                    ):
                        attrs.add(ce.attr)
        return attrs

    def _mutations(
        self,
        fn: ast.FunctionDef | ast.AsyncFunctionDef,
        lock_attrs: set[str],
    ) -> Iterator[tuple[str, ast.AST, bool]]:
        """(attr, node, under_lock) for every self.<attr> mutation in fn."""
        for node in walk_skipping_defs(fn.body):
            attrs: list[str] = []
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                else:  # AugAssign / AnnAssign: one target
                    # a bare annotation (`self.x: int`) binds nothing
                    if isinstance(node, ast.AnnAssign) and node.value is None:
                        continue
                    targets = [node.target]
                for tgt in targets:
                    attrs.extend(_target_attrs(tgt))
            elif isinstance(node, ast.Delete):
                # del self.d[k] mutates the guarded container too
                for tgt in node.targets:
                    attrs.extend(_target_attrs(tgt))
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in _MUTATING_METHODS:
                    a = _self_attr_target(node.func.value)
                    if a is not None:
                        attrs.append(a)
            for attr in attrs:
                if attr in lock_attrs:
                    continue
                yield attr, node, self._under_lock(node, lock_attrs)

    @staticmethod
    def _under_lock(node: ast.AST, lock_attrs: set[str]) -> bool:
        for anc in ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
            if isinstance(anc, ast.With):
                for withitem in anc.items:
                    ce = withitem.context_expr
                    if (
                        isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"
                        and ce.attr in lock_attrs
                    ):
                        return True
        return False


def _target_attrs(tgt: ast.AST):
    """self-attribute names in an assignment target, unpacking tuples/lists
    and starred elements (``self.a, *self.b = ...``)."""
    if isinstance(tgt, (ast.Tuple, ast.List)):
        for elt in tgt.elts:
            yield from _target_attrs(elt)
    elif isinstance(tgt, ast.Starred):
        yield from _target_attrs(tgt.value)
    else:
        attr = _self_attr_target(tgt)
        if attr is not None:
            yield attr


def _self_attr_target(tgt: ast.AST) -> str | None:
    """'x' for self.x / self.x[...] / self.x[...][...] targets, else None
    (nested subscript chains unwrap to the root attribute)."""
    while isinstance(tgt, ast.Subscript):
        tgt = tgt.value
    if (
        isinstance(tgt, ast.Attribute)
        and isinstance(tgt.value, ast.Name)
        and tgt.value.id == "self"
    ):
        return tgt.attr
    return None


#: constructors of per-tenant serving state.  One instance of any of these
#: parked in a module-level global is shared by every tenant co-resident in
#: the replica — exactly the cross-tenant leak the TenantRegistry exists to
#: prevent (docs/robustness.md#multi-tenancy).  Matched by terminal class
#: name so `QualityMonitor()`, `quality.QualityMonitor()`, and an aliased
#: import all resolve; generic process infrastructure (MetricsRegistry,
#: thread pools, lock witnesses) is deliberately NOT listed — those are
#: process-scoped by design.
_TENANT_STATE_CTORS = frozenset(
    (
        "QualityMonitor",
        "SLOTracker",
        "CostLedger",
        "TokenBucket",
        "DeployedEngine",
        "TenantRegistry",
        "Tenant",
    )
)


def _tenant_state_ctor(mod: ModuleInfo, expr: ast.AST) -> str | None:
    """Terminal class name when expr constructs per-tenant state."""
    if not isinstance(expr, ast.Call):
        return None
    callee = resolve_call(mod, expr)
    name = callee.rsplit(".", 1)[-1]
    return name if name in _TENANT_STATE_CTORS else None


@rule
class ModuleLevelTenantSingleton(Rule):
    """PIO-CONC004: module-level singleton holding per-tenant state.

    Two shapes, both the `default_quality()` pattern family:

    * eager — ``_MONITOR = QualityMonitor()`` at module scope
    * lazy  — a function that does ``global _MONITOR`` and assigns it a
      per-tenant-state constructor result (memoized getter)

    Either way the instance is per-*process*: the moment a replica hosts a
    second tenant, both tenants' quality windows / SLO burn / quota state
    land in the same object.  Per-tenant state must be owned by the
    Tenant/TenantRegistry (or passed in explicitly), never reached through
    a module global.  Function-local and instance-attribute construction
    is fine and not flagged.
    """

    id = "PIO-CONC004"
    severity = Severity.HIGH
    summary = (
        "module-level singleton of per-tenant state; every tenant in the "
        "replica shares it — own it in the TenantRegistry instead"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            cls = _tenant_state_ctor(mod, node.value)
            if cls and any(isinstance(t, ast.Name) for t in node.targets):
                name = next(
                    t.id for t in node.targets if isinstance(t, ast.Name)
                )
                yield self.finding(
                    mod,
                    node,
                    f"module-level {cls} singleton {name!r}: every tenant "
                    "in the replica shares this instance, so one tenant's "
                    "state bleeds into another's; construct it per tenant "
                    "and own it in the TenantRegistry",
                )
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            declared: set[str] = set()
            for sub in walk_skipping_defs(fn.body):
                if isinstance(sub, ast.Global):
                    declared.update(sub.names)
            if not declared:
                continue
            for sub in walk_skipping_defs(fn.body):
                if not isinstance(sub, ast.Assign):
                    continue
                cls = _tenant_state_ctor(mod, sub.value)
                if cls is None:
                    continue
                hit = next(
                    (
                        t.id
                        for t in sub.targets
                        if isinstance(t, ast.Name) and t.id in declared
                    ),
                    None,
                )
                if hit is not None:
                    yield self.finding(
                        mod,
                        sub,
                        f"lazy module-level {cls} singleton {hit!r} "
                        f"(global in {fn.name!r}): the memoized instance "
                        "is per-process, so co-resident tenants share it; "
                        "construct per-tenant state in the TenantRegistry "
                        "or thread it through explicitly",
                    )
