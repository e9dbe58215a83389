"""DASE contract checks: the Scala compiler's job, done at pre-flight.

The reference's Engine[TD, EI, PD, Q, P, A] is type-checked by scalac
before `pio train` can run (controller/Engine.scala:82); the Python port
wires DataSource -> Preparator -> Algorithm -> Serving by name, so a wrong
arity or a params typo only explodes mid-training.  These checks load an
engine factory and statically verify every registered component *before
any device work starts*:

  - each stage class implements its required methods with a compatible
    positional arity (``read_training(self, ctx)``, ``prepare(self, ctx,
    td)``, ``train``/``predict``, ``serve``/``supplement``);
  - no stage class is still abstract;
  - a class registered for one stage isn't actually a different stage's
    base (Algorithm wired into the serving slot, etc.);
  - ``params_class`` is a dataclass, its ``params_aliases`` point at real
    fields, and the component constructor accepts a params argument.

Used standalone via ``pio check --engine NAME`` and as the `pio train` /
`pio deploy` pre-flight (skippable with ``--no-check``).  Unlike the AST
rules this module imports the engine code, so it lives behind lazy imports.
"""

from __future__ import annotations

import dataclasses
import inspect
from pathlib import Path
from typing import Any, Iterator

from predictionio_tpu_torch.analysis.findings import Finding, Severity

#: stage name -> [(method, n_positional_args_including_self, required)]
_STAGE_METHODS: dict[str, list[tuple[str, int, bool]]] = {
    "datasource": [("read_training", 2, True), ("read_eval", 2, False)],
    "preparator": [("prepare", 3, True)],
    "algorithm": [
        ("train", 3, True),
        ("predict", 3, True),
        ("batch_predict", 3, False),
    ],
    "serving": [("serve", 3, True), ("supplement", 2, False)],
}


def _finding(
    rule: str, cls_or_obj: Any, message: str, root: Path | None
) -> Finding:
    file, line = _locate(cls_or_obj)
    if root is not None and file:
        try:
            file = Path(file).resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            pass
    source = ""
    if file and line:
        try:
            source = (
                Path(file if Path(file).is_absolute() else root / file)
                .read_text()
                .splitlines()[line - 1]
                .strip()
            )
        except (OSError, IndexError, TypeError):
            source = ""
    return Finding(
        rule=rule,
        severity=Severity.HIGH,
        file=file or "<engine>",
        line=line or 1,
        col=1,
        message=message,
        source=source,
    )


def _locate(obj: Any) -> tuple[str, int]:
    try:
        file = inspect.getsourcefile(obj) or ""
        _, line = inspect.getsourcelines(obj)
        return file, line
    except (OSError, TypeError):
        return "", 0


def _positional_arity_error(fn: Any, n: int) -> str | None:
    """None if ``fn(*n args)`` can bind, else a description of the mismatch."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None  # uninspectable (C-level): give it the benefit of doubt
    min_pos = max_pos = 0
    has_var = False
    for p in sig.parameters.values():
        if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        ):
            max_pos += 1
            if p.default is inspect.Parameter.empty:
                min_pos += 1
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            has_var = True
        elif (
            p.kind == inspect.Parameter.KEYWORD_ONLY
            and p.default is inspect.Parameter.empty
        ):
            return f"has a required keyword-only parameter {p.name!r}"
    if min_pos > n:
        return (
            f"requires {min_pos} positional argument(s) but the framework "
            f"calls it with {n}"
        )
    if not has_var and max_pos < n:
        return (
            f"accepts at most {max_pos} positional argument(s) but the "
            f"framework calls it with {n}"
        )
    return None


def _stage_bases() -> dict[str, type]:
    from predictionio_tpu_torch.core.base import (
        Algorithm,
        DataSource,
        Preparator,
        Serving,
    )

    return {
        "datasource": DataSource,
        "preparator": Preparator,
        "algorithm": Algorithm,
        "serving": Serving,
    }


def check_component(
    stage: str, name: str, cls: type, root: Path | None = None
) -> Iterator[Finding]:
    """Contract findings for one registered component class."""
    label = f"{stage} component {name or cls.__name__!r}"
    bases = _stage_bases()

    # wired into the wrong slot? (an Algorithm registered as serving, etc.)
    for other_stage, base in bases.items():
        if other_stage == stage:
            continue
        if isinstance(cls, type) and issubclass(cls, base):
            yield _finding(
                "PIO-DASE001",
                cls,
                f"{label}: {cls.__name__} subclasses the "
                f"{base.__name__} base — it is wired into the wrong "
                f"DASE slot",
                root,
            )
            return

    abstract = getattr(cls, "__abstractmethods__", frozenset())
    if abstract:
        yield _finding(
            "PIO-DASE001",
            cls,
            f"{label}: {cls.__name__} is still abstract "
            f"(unimplemented: {sorted(abstract)})",
            root,
        )
    for method, n, required in _STAGE_METHODS[stage]:
        fn = getattr(cls, method, None)
        if fn is None or not callable(fn):
            if required:
                yield _finding(
                    "PIO-DASE001",
                    cls,
                    f"{label}: missing required method {method!r}",
                    root,
                )
            continue
        # only check methods the class (or a non-framework base) defines;
        # inherited framework defaults are correct by construction
        err = _positional_arity_error(fn, n)
        if err is not None:
            yield _finding(
                "PIO-DASE002",
                fn,
                f"{label}: {method}() {err} "
                f"(expected {_expected_sig(stage, method)})",
                root,
            )

    yield from _check_params(stage, name, cls, root)


def _expected_sig(stage: str, method: str) -> str:
    sigs = {
        ("datasource", "read_training"): "read_training(self, ctx)",
        ("datasource", "read_eval"): "read_eval(self, ctx)",
        ("preparator", "prepare"): "prepare(self, ctx, td)",
        ("algorithm", "train"): "train(self, ctx, pd)",
        ("algorithm", "predict"): "predict(self, model, query)",
        ("algorithm", "batch_predict"): "batch_predict(self, model, queries)",
        ("serving", "serve"): "serve(self, query, predictions)",
        ("serving", "supplement"): "supplement(self, query)",
    }
    return sigs.get((stage, method), method)


def _check_params(
    stage: str, name: str, cls: type, root: Path | None
) -> Iterator[Finding]:
    label = f"{stage} component {name or cls.__name__!r}"
    params_cls = getattr(cls, "params_class", None)
    if params_cls is None:
        return
    if not dataclasses.is_dataclass(params_cls):
        yield _finding(
            "PIO-DASE003",
            cls,
            f"{label}: params_class {params_cls!r} is not a dataclass — "
            "extract_params cannot build it from engine.json",
            root,
        )
        return
    fields = {f.name for f in dataclasses.fields(params_cls)}
    aliases = dict(getattr(params_cls, "params_aliases", {}) or {})
    for json_name, field_name in aliases.items():
        if field_name not in fields:
            yield _finding(
                "PIO-DASE003",
                params_cls,
                f"{label}: params_aliases maps {json_name!r} to "
                f"{field_name!r}, which is not a field of "
                f"{params_cls.__name__} (fields: {sorted(fields)})",
                root,
            )
    # the doer contract: Cls(params) must be constructible
    from predictionio_tpu_torch.utils.registry import _takes_argument

    if not _takes_argument(cls):
        yield _finding(
            "PIO-DASE003",
            cls,
            f"{label}: declares params_class "
            f"{params_cls.__name__} but its constructor takes no "
            "positional argument — the framework instantiates components "
            "as Cls(params)",
            root,
        )


def check_engine(
    engine: Any, factory_name: str = "", root: Path | None = None
) -> list[Finding]:
    """Contract findings for an instantiated Engine's class maps."""
    from predictionio_tpu_torch.core.engine import Engine

    if not isinstance(engine, Engine):
        return [
            _finding(
                "PIO-DASE001",
                type(engine),
                f"engine factory {factory_name!r} returned "
                f"{type(engine).__name__}, not an Engine",
                root,
            )
        ]
    stage_maps = {
        "datasource": engine.datasource_classes,
        "preparator": engine.preparator_classes,
        "algorithm": engine.algorithm_classes,
        "serving": engine.serving_classes,
    }
    findings: list[Finding] = []
    for stage, classes in stage_maps.items():
        if not classes:
            findings.append(
                _finding(
                    "PIO-DASE001",
                    type(engine),
                    f"engine {factory_name!r}: no {stage} class registered",
                    root,
                )
            )
            continue
        for name, cls in classes.items():
            findings.extend(check_component(stage, name, cls, root=root))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def check_engine_contract(
    factory_name: str, root: Path | None = None
) -> list[Finding]:
    """Resolve a factory by name/import path and check its engine.

    Factory resolution or construction failures become findings (the
    pre-flight must report them, not crash).
    """
    from predictionio_tpu_torch.core.engine import resolve_engine_factory

    try:
        factory = resolve_engine_factory(factory_name)
    except Exception as e:
        # KeyError for unknown names, but an import-path factory can raise
        # anything at module import — the pre-flight reports, never crashes
        return [
            Finding(
                rule="PIO-DASE001",
                severity=Severity.HIGH,
                file="<engine>",
                line=1,
                col=1,
                message=f"engine factory {factory_name!r} not resolvable: "
                f"{type(e).__name__}: {e}",
            )
        ]
    try:
        engine = factory()
    except Exception as e:
        return [
            _finding(
                "PIO-DASE001",
                factory,
                f"engine factory {factory_name!r} raised at construction: "
                f"{type(e).__name__}: {e}",
                root,
            )
        ]
    return check_engine(engine, factory_name, root=root)
