"""PyTorch hot-path lints (rule family PIO-TORCH*).

The failure modes these catch are the classic CUDA-serving ones: a silent
host<->device sync inside the per-query path (each ``.item()`` or
``.cpu()`` drains the stream the wave was queued on), CUDA work at module
import (creates the CUDA context before the caller picked a device, and in
a process that may fork), Python control flow on tensors inside a compiled
function (a graph break, an error under ``fullgraph=True``, or a recompile
per value), and per-iteration ``torch.compile`` construction (every wrap is
a fresh compile cache).  Each rule number keeps the hazard of the JAX
package's PIO-JAX rule with the same number, in PyTorch's spellings.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from predictionio_tpu_torch.analysis.findings import Finding, Severity
from predictionio_tpu_torch.analysis.rules import (
    ModuleInfo,
    ProgramRule,
    Rule,
    ancestors,
    compile_decorator_info,
    parent,
    resolve_call,
    resolve_name,
    rule,
    walk_skipping_defs,
)

#: DASE serving-surface method names + microbatch dispatch conventions —
#: the functions that run once per query (or per wave) under load.
HOT_FUNCTION_NAMES = frozenset(
    ("predict", "batch_predict", "serve", "supplement")
)
HOT_NAME_FRAGMENTS = ("serve_wave", "batch_fn")

#: tensor methods that copy device memory to the host (no-argument calls)
_SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy"))

#: calls that force a device->host transfer when applied to a CUDA tensor
_SYNC_CALLS = frozenset(
    ("torch.cuda.synchronize", "numpy.asarray", "numpy.array", "numpy.copy")
)


def _is_hot_function(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    name = fn.name
    return name in HOT_FUNCTION_NAMES or any(
        frag in name for frag in HOT_NAME_FRAGMENTS
    )


def _hot_functions(
    mod: ModuleInfo,
) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _is_hot_function(node):
                yield node


def _method(node: ast.Call) -> str | None:
    """``m`` for a ``<receiver>.m(...)`` call, else None."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _no_arg_method(node: ast.Call) -> str | None:
    if node.args or node.keywords:
        return None
    return _method(node)


@rule
class HotPathDeviceSync(Rule):
    """PIO-TORCH001: implicit device sync inside a serving hot-path function."""

    id = "PIO-TORCH001"
    severity = Severity.MEDIUM
    summary = (
        "host sync (.item()/.cpu()/.tolist()/synchronize/np.asarray) inside "
        "a hot-path function; sync once per batch, not per query"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for fn in _hot_functions(mod):
            for node in walk_skipping_defs(fn.body):
                if not isinstance(node, ast.Call):
                    continue
                callee = resolve_call(mod, node)
                meth = _no_arg_method(node)
                if callee in _SYNC_CALLS:
                    yield self.finding(
                        mod,
                        node,
                        f"{callee}(...) in hot-path function {fn.name!r} "
                        "synchronizes device buffers to host; hoist the "
                        "transfer out of the per-query path",
                    )
                elif meth in _SYNC_METHODS:
                    yield self.finding(
                        mod,
                        node,
                        f".{meth}() in hot-path function {fn.name!r} forces "
                        "a device->host sync per call; pull the batched "
                        "output once (one .cpu() of the wave) outside the "
                        "per-query loop",
                    )
                elif _method(node) == "synchronize":
                    yield self.finding(
                        mod,
                        node,
                        f".synchronize() in hot-path function {fn.name!r} "
                        "blocks the host until the device drains; wait on "
                        "the wave's result once, at the batch fence",
                    )


def _is_cuda_device(mod: ModuleInfo, expr: ast.AST) -> bool:
    """True for a device expression that names a CUDA device: ``"cuda"``,
    ``"cuda:1"``, an ordinal ``0``, or ``torch.device(...)`` of those."""
    if isinstance(expr, ast.Constant):
        v = expr.value
        if isinstance(v, str):
            return v.startswith("cuda")
        return isinstance(v, int) and not isinstance(v, bool)
    if isinstance(expr, ast.Call) and resolve_call(mod, expr) == "torch.device":
        return bool(expr.args) and _is_cuda_device(mod, expr.args[0])
    return False


def _device_kwarg(node: ast.Call) -> ast.AST | None:
    for kw in node.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _import_time_cuda_label(mod: ModuleInfo, node: ast.Call) -> str | None:
    callee = resolve_call(mod, node)
    if callee.startswith("torch.cuda."):
        return callee
    meth = _method(node)
    if meth == "cuda":
        return ".cuda"
    dev = _device_kwarg(node)
    if meth == "to":
        targets = list(node.args[:1]) + ([dev] if dev is not None else [])
        if any(_is_cuda_device(mod, t) for t in targets):
            return ".to"
    if (
        callee.startswith("torch.")
        and dev is not None
        and _is_cuda_device(mod, dev)
    ):
        return callee
    return None


@rule
class ImportTimeDeviceWork(Rule):
    """PIO-TORCH002: CUDA work executed at module import time."""

    id = "PIO-TORCH002"
    severity = Severity.HIGH
    summary = (
        "torch.cuda call or CUDA tensor/generator at module import time; "
        "the CUDA context is created before device selection"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in self._import_time_nodes(mod.tree.body):
            if not isinstance(node, ast.Call):
                continue
            label = _import_time_cuda_label(mod, node)
            if label is not None:
                yield self.finding(
                    mod,
                    node,
                    f"{label}(...) runs at import time: PyTorch creates the "
                    "CUDA context and allocates device memory before the "
                    "application picks its device (and before any fork); "
                    "build the value lazily inside a function",
                )

    def _import_time_nodes(self, body: list[ast.stmt]) -> Iterator[ast.AST]:
        """Module and class bodies execute at import (at any nesting depth
        under module-level if/try/with); function and lambda bodies do not —
        but their decorators and default arguments DO, so those subtrees are
        still walked.  The `if __name__ == '__main__'` block is exempt."""
        stack: list[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(node.decorator_list)
                stack.extend(d for d in node.args.defaults)
                stack.extend(d for d in node.args.kw_defaults if d is not None)
                continue
            if isinstance(node, ast.Lambda):
                stack.extend(node.args.defaults)
                stack.extend(d for d in node.args.kw_defaults if d is not None)
                continue
            if isinstance(node, ast.If) and _is_main_guard(node):
                # the guarded body is script-only, but the else arm runs on
                # every import (it IS the non-__main__ case)
                stack.extend(node.orelse)
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))


def _is_main_guard(stmt: ast.If) -> bool:
    """True only for the literal ``if __name__ == "__main__":`` shape —
    an ``!=`` (or a different comparand) still executes at import."""
    t = stmt.test
    if not (
        isinstance(t, ast.Compare)
        and len(t.ops) == 1
        and isinstance(t.ops[0], ast.Eq)
    ):
        return False
    sides = (t.left, t.comparators[0])
    return any(
        isinstance(s, ast.Name) and s.id == "__name__" for s in sides
    ) and any(
        isinstance(s, ast.Constant) and s.value == "__main__" for s in sides
    )


#: attribute reads on a tensor that are static metadata (safe to branch on)
_STATIC_ATTRS = frozenset(
    ("shape", "ndim", "dtype", "size", "dim", "numel", "device", "is_cuda")
)


@rule
class TracedPythonBranch(Rule):
    """PIO-TORCH003: Python if/while on a tensor argument in a compiled fn."""

    id = "PIO-TORCH003"
    severity = Severity.HIGH
    summary = (
        "Python control flow on a tensor inside torch.compile/jit.script; "
        "use torch.where/torch.cond or pass the value as a Python scalar"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            compiled, static_names = compile_decorator_info(mod, fn)
            if not compiled:
                continue
            args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
            traced = {a.arg for a in args if a.arg not in static_names}
            traced.discard("self")
            for node in walk_skipping_defs(fn.body):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                name = _traced_name_in_test(node.test, traced)
                if name is not None:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield self.finding(
                        mod,
                        node,
                        f"Python `{kind}` on tensor argument {name!r} inside "
                        f"compiled function {fn.name!r}: this breaks the "
                        "graph (an error under fullgraph=True) or recompiles "
                        "per value; use torch.where/torch.cond or annotate "
                        "the argument as a Python scalar",
                    )


def _traced_name_in_test(test: ast.AST, traced: set[str]) -> str | None:
    """First tensor param the test depends on concretely, else None.

    Exemptions are scoped to the exact subtree they cover — `y is not None
    and x > 0` exempts only the identity check (and still flags ``x``), and
    an isinstance() call exempts only its own operands, never a tensor
    comparison elsewhere in the same compound condition.
    """
    exempt: set[int] = set()
    for node in ast.walk(test):
        concrete = (
            # identity checks are resolved on the Python value, not traced
            isinstance(node, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
        ) or (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "isinstance"
        )
        if concrete:
            exempt.update(id(sub) for sub in ast.walk(node))
    for node in ast.walk(test):
        if (
            isinstance(node, ast.Name)
            and node.id in traced
            and id(node) not in exempt
        ):
            par = parent(node)
            if isinstance(par, ast.Attribute) and par.attr in _STATIC_ATTRS:
                continue
            if (  # len(x) of a tensor is its static leading dim
                isinstance(par, ast.Call)
                and isinstance(par.func, ast.Name)
                and par.func.id == "len"
            ):
                continue
            return node.id
    return None


#: wrappers whose construction inside a loop recompiles every iteration
_COMPILE_CALLS = frozenset(("torch.compile", "torch.jit.script"))


@rule
class CompileConstructionInLoop(Rule):
    """PIO-TORCH004: torch.compile(...) wrapped inside a loop body."""

    id = "PIO-TORCH004"
    severity = Severity.HIGH
    summary = (
        "torch.compile(...) constructed inside a loop; each wrap is a fresh "
        "compile cache — hoist the compiled callable out of the loop"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = resolve_call(mod, node)
            if callee not in _COMPILE_CALLS:
                continue
            for anc in ancestors(node):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break  # built per *call* of an inner fn, not per iter
                if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                    yield self.finding(
                        mod,
                        node,
                        f"{callee}(...) inside a loop creates a new compiled "
                        "callable every iteration (no cache reuse, repeated "
                        "Dynamo traces and Inductor compiles); hoist it out "
                        "of the loop",
                    )
                    break


#: the port's mesh helpers that (re)place data onto devices — correct at
#: bind/load time, a per-wave resharding hazard inside a serving loop body
_PLACEMENT_SUFFIXES = (".global_data_array", ".shard_put", ".bind_shards")
_PLACEMENT_NAMES = frozenset(
    ("global_data_array", "shard_put", "bind_shards")
)
#: tensor constructors that copy host data to the device named by device=
_PLACING_FACTORIES = frozenset(
    ("torch.as_tensor", "torch.tensor", "torch.from_numpy")
)


def _is_dtype_expr(mod: ModuleInfo, expr: ast.AST) -> bool:
    """``torch.float32``-like: a ``.to(dtype)`` cast, not a placement."""
    name = resolve_name(mod, expr)
    return name.startswith("torch.") and name.count(".") == 1 and (
        name[6:].startswith(("float", "int", "uint", "bool", "bfloat", "half",
                             "double", "long", "complex"))
    )


def _placement_label(mod: ModuleInfo, node: ast.Call) -> str | None:
    callee = resolve_call(mod, node)
    if callee in _PLACEMENT_NAMES or callee.endswith(_PLACEMENT_SUFFIXES):
        return callee
    meth = _method(node)
    if meth == "cuda":
        return ".cuda"
    if meth == "to":
        if _device_kwarg(node) is not None:
            return ".to"
        if node.args and not _is_dtype_expr(mod, node.args[0]):
            return ".to"
        return None
    if callee in _PLACING_FACTORIES and _device_kwarg(node) is not None:
        return callee
    return None


@rule
class ReshardInHotLoop(Rule):
    """PIO-TORCH006: device placement inside a hot-path loop body."""

    id = "PIO-TORCH006"
    severity = Severity.MEDIUM
    summary = (
        ".to(device)/.cuda()/shard_put inside a predict/batch_fn loop body; "
        "placement belongs at model bind time, not per wave"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        seen: set[int] = set()
        for fn in _hot_functions(mod):
            for loop in walk_skipping_defs(fn.body):
                if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                    continue
                for node in walk_skipping_defs(loop.body + loop.orelse):
                    if not isinstance(node, ast.Call) or id(node) in seen:
                        continue
                    label = _placement_label(mod, node)
                    if label is not None:
                        seen.add(id(node))
                        yield self.finding(
                            mod,
                            node,
                            f"{label}(...) inside a loop body of hot-path "
                            f"function {fn.name!r}: every iteration pays a "
                            "host->device transfer and may re-shard the "
                            "tensor per wave; place tensors once at model "
                            "bind/load time and reuse the device copies",
                        )


#: function-name fragments marking the PRE-FENCE half of a pipelined wave:
#: dispatch_batch (engine async halves), _dispatch_wave (MicroBatcher), any
#: *dispatch* helper on the serving path.  Nested ``def``s inside them (the
#: finalize closures) are the fence region and are exempt — that is exactly
#: where the sync belongs.
_DISPATCH_FRAGMENT = "dispatch"


@rule
class DispatchRegionSync(Rule):
    """PIO-TORCH007: host sync inside the dispatch (pre-fence) region."""

    id = "PIO-TORCH007"
    severity = Severity.MEDIUM
    summary = (
        "synchronize()/.item()/.cpu() inside a dispatch-phase function; the "
        "sync belongs at the finalize fence"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if _DISPATCH_FRAGMENT not in fn.name:
                continue
            # walk_skipping_defs: nested defs (the finalize closures) are
            # the post-fence region — syncs there are the design
            for node in walk_skipping_defs(fn.body):
                if not isinstance(node, ast.Call):
                    continue
                callee = resolve_call(mod, node)
                if callee == "torch.cuda.synchronize":
                    yield self.finding(
                        mod,
                        node,
                        f"torch.cuda.synchronize(...) in dispatch-phase "
                        f"function {fn.name!r} synchronizes before the "
                        "fence; the dispatch half must stay non-blocking",
                    )
                elif _method(node) == "synchronize":
                    yield self.finding(
                        mod,
                        node,
                        f".synchronize() in dispatch-phase function "
                        f"{fn.name!r} blocks the worker before the fence; "
                        "return the pending result and sync in the "
                        "finalize closure instead",
                    )
                elif _no_arg_method(node) in ("item", "cpu"):
                    yield self.finding(
                        mod,
                        node,
                        f".{_method(node)}() in dispatch-phase function "
                        f"{fn.name!r} forces a device->host sync before the "
                        "fence; defer the read to the finalize closure",
                    )


#: bounded call depth for the transitive hot-path walk; deep enough to see
#: "predict -> _gather -> _pull", shallow enough that utility plumbing far
#: from the seam does not drown the report
TORCH008_MAX_DEPTH = 4


def _transitive_sync_label(mod: ModuleInfo, node: ast.Call) -> str | None:
    """The explicit sync spellings checked transitively.  ``.numpy()`` and
    numpy.asarray/array are deliberately NOT here: two calls below the seam
    the receiver type is unknowable, and on host tensors and lists they are
    the normal gather idiom (TORCH001 still flags them inside the hot
    function itself, where context is local)."""
    if resolve_call(mod, node) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize"
    if _method(node) == "synchronize":
        return "*.synchronize()"
    meth = _no_arg_method(node)
    if meth in ("item", "cpu"):
        return f"*.{meth}()"
    return None


@rule
class TransitiveHotPathSync(ProgramRule):
    """PIO-TORCH008: host sync in a helper *reachable* from a serving seam.

    TORCH001/TORCH007 are local — they see syncs written directly inside
    predict/batch_fn/dispatch_* bodies.  This rule walks the call graph
    from those seams (bounded depth) and re-runs the sync set over every
    reached helper, so a ``.item()`` two calls below ``predict`` no longer
    hides.
    """

    id = "PIO-TORCH008"
    severity = Severity.MEDIUM
    summary = (
        "host sync (.item()/.cpu()/synchronize) in a helper reachable from "
        "a hot-path function; the stall hides below the serving seam"
    )

    def check_program(self, program) -> Iterable[Finding]:
        roots = sorted(
            q
            for q, fi in program.functions.items()
            if _is_hot_function(fi.node) or _DISPATCH_FRAGMENT in fi.name
        )
        reach = program.reachable(roots, TORCH008_MAX_DEPTH)
        seen: set[tuple[str, int]] = set()
        for q in sorted(reach):
            chain = reach[q]
            if not chain:
                continue  # a seam itself: TORCH001/TORCH007 territory
            fi = program.functions[q]
            if _is_hot_function(fi.node) or _DISPATCH_FRAGMENT in fi.name:
                continue  # local rules already watch these by name
            mod = fi.mod
            for node in walk_skipping_defs(fi.node.body):
                if not isinstance(node, ast.Call):
                    continue
                label = _transitive_sync_label(mod, node)
                if label is None:
                    continue
                key = (mod.rel, node.lineno)
                if key in seen:
                    continue
                seen.add(key)
                root_fn, _, _ = chain[0]
                via = " -> ".join(fn for fn, _, _ in chain) + f" -> {q}"
                yield Finding(
                    rule=self.id,
                    severity=self.severity,
                    file=mod.rel,
                    line=node.lineno,
                    col=node.col_offset + 1,
                    message=(
                        f"{label} in helper {fi.name!r} is reachable from "
                        f"hot-path seam {root_fn!r} (via {via}, depth "
                        f"{len(chain)}): the device->host sync runs once "
                        "per query even though no hot-named function spells "
                        "it; batch the transfer at the seam's fence instead"
                    ),
                    source=mod.line_text(node.lineno),
                )


@rule
class CompileMutableDefault(Rule):
    """PIO-TORCH005: compiled function with a mutable default argument."""

    id = "PIO-TORCH005"
    severity = Severity.MEDIUM
    summary = (
        "mutable default argument on a compiled function; the compiler "
        "guards on its contents and recompiles when it is mutated"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            compiled, _ = compile_decorator_info(mod, fn)
            if not compiled:
                continue
            defaults = list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    yield self.finding(
                        mod,
                        d,
                        f"mutable default argument on compiled function "
                        f"{fn.name!r}: the compiler guards on its contents, "
                        "so any mutation recompiles (and it is shared across "
                        "calls); use a tuple or None-sentinel",
                    )
