"""The port's public surface against the JAX package's, on the CPU.

- every name of every JAX ``__all__`` imports from the port's module of the
  same path, but the JAX-only names of :data:`JAX_ONLY`, each with its
  reason; and an AST diff of every JAX module's public names against the
  port module of the same path finds nothing else missing;
- the processes that never touch the card (the event server, the router,
  the dashboard, the CLI before a verb runs) import the port without
  torch: the package exports load lazily;
- each package ``__init__`` imports first in a fresh process, and every
  exported name resolves there (no import cycle);
- a ``pkg.mod:Factory`` naming an ``EngineFactory`` subclass resolves, in
  both packages, to a factory of an ``Engine``.
"""

from __future__ import annotations

import ast
import importlib
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from predictionio_tpu.core import engine as jax_engine
from predictionio_tpu_torch.core import engine as pt_engine

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "predictionio_tpu"
PORT_ROOT = ROOT / "predictionio_tpu_torch"

#: public names of the JAX package the port does not have, by dotted path
#: under the package, and why
JAX_ONLY = {
    "analysis.rules_jax": "the PIO-JAX rules; the port's analyzer runs "
    "PIO-TORCH rules (analysis.rules_torch) in their place",
    "analysis.rules.jit_decorator_info": "reads @jax.jit decorators, which "
    "only the PIO-JAX rules inspect",
    "obs.device.jit_cost_analysis": "XLA's compiled cost analysis; the port "
    "installs least-work costs of its own kernels",
    "obs.jit_cost_analysis": "the obs re-export of "
    "obs.device.jit_cost_analysis",
    "obs.tracing.install_jax_compile_listener": "a jax.monitoring listener; "
    "the port records nvcc builds (obs.tracing.observe_kernel_build)",
    "obs.install_jax_compile_listener": "the obs re-export of "
    "obs.tracing.install_jax_compile_listener",
    "obs.device.als_plan_roofline": "TPU sublane and VMEM plan arithmetic "
    "of the Pallas ALS plan; the port's roofline is least-work by design",
    "ops.ncf.make_epoch_fn": "a jitted lax.scan epoch; the port's epoch is "
    "ops.ncf.train_epoch",
    "parallel.mesh.named_sharding": "makes a jax.sharding.NamedSharding; "
    "the port's slots are torch devices",
    "parallel.mesh.shard_map_compat": "a shim over jax's shard_map versions",
}

#: the processes that never touch the card import these without torch
TORCH_FREE = [
    "predictionio_tpu_torch.obs",
    "predictionio_tpu_torch.obs.http",
    "predictionio_tpu_torch.server.event_server",
    "predictionio_tpu_torch.server.dashboard",
    "predictionio_tpu_torch.fleet.router",
    "predictionio_tpu_torch.data",
    "predictionio_tpu_torch.data.storage",
    "predictionio_tpu_torch.tools.cli",
    "predictionio_tpu_torch.core.metric",
    "predictionio_tpu_torch.core",
    "predictionio_tpu_torch.ops",
]

#: the package ``__init__``s that export the JAX package's names
PACKAGES = ["core", "obs", "data", "data.storage", "ops", "utils", "analysis"]
#: those of them whose exports load lazily: ``dir()`` is their ``__all__``
LAZY = {"core", "obs", "ops"}


def _module_path(root: Path, dotted: str) -> Path | None:
    base = root.joinpath(*dotted.split(".")) if dotted else root
    for p in (base / "__init__.py", base.with_suffix(".py")):
        if p.is_file():
            return p
    return None


def _dotted(root: Path, path: Path) -> str:
    rel = path.relative_to(root).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _literal_all(tree: ast.Module) -> list[str] | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            return list(ast.literal_eval(node.value))
    return None


def _targets(node) -> list[str]:
    out = []
    for t in getattr(node, "targets", [getattr(node, "target", None)]):
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        out += [e.id for e in elts if isinstance(e, ast.Name)]
    return out


def _defined(tree: ast.Module) -> set[str]:
    """Top-level names a module defines: def, class and assignments."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
    return out


def _bound(tree: ast.Module) -> set[str]:
    """Every top-level name a module binds, imports included, also inside a
    top-level ``if`` or ``try``, plus its ``__all__``."""
    out = set(_literal_all(tree) or ())
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out.update(_targets(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            for h in getattr(node, "handlers", []):
                todo += h.body
    return out


def _public(tree: ast.Module) -> set[str]:
    """A JAX module's public names: its ``__all__``, else what it defines
    at top level under a name without a leading underscore."""
    names = _literal_all(tree)
    if names is not None:
        return set(names)
    return {n for n in _defined(tree) if not n.startswith("_")}


def _jax_modules_with_all() -> list[str]:
    out = []
    for p in sorted(JAX_ROOT.rglob("*.py")):
        if _literal_all(ast.parse(p.read_text())) is not None:
            out.append(_dotted(JAX_ROOT, p))
    return out


@pytest.mark.parametrize("dotted", _jax_modules_with_all())
def test_every_jax_all_name_imports_from_the_port(dotted):
    """Each name of this JAX module's ``__all__`` is an attribute of the
    port's module of the same path, unless it is listed in ``JAX_ONLY``."""
    jax_path = _module_path(JAX_ROOT, dotted)
    names = _literal_all(ast.parse(jax_path.read_text()))
    prefix = f"{dotted}." if dotted else ""
    want = [n for n in names if f"{prefix}{n}" not in JAX_ONLY]
    mod = importlib.import_module(
        "predictionio_tpu_torch" + (f".{dotted}" if dotted else "")
    )
    missing = [n for n in want if not hasattr(mod, n)]
    assert not missing, f"{dotted}: {missing}"
    port_all = getattr(mod, "__all__", None)
    if port_all is not None:
        assert set(want) <= set(port_all), set(want) - set(port_all)


def test_ast_diff_finds_only_the_jax_only_names():
    """Every public name of every JAX module is bound in the port's module
    of the same path, except ``JAX_ONLY``; and every ``JAX_ONLY`` entry is
    really absent from the port (the list cannot go stale)."""
    missing = set()
    for p in sorted(JAX_ROOT.rglob("*.py")):
        dotted = _dotted(JAX_ROOT, p)
        port = _module_path(PORT_ROOT, dotted)
        if port is None:
            continue
        have = _bound(ast.parse(port.read_text()))
        prefix = f"{dotted}." if dotted else ""
        missing |= {
            prefix + n for n in _public(ast.parse(p.read_text())) - have
        }
    assert missing - set(JAX_ONLY) == set()
    for entry in JAX_ONLY:
        mod, _, name = entry.rpartition(".")
        port = _module_path(PORT_ROOT, mod)
        if _module_path(PORT_ROOT, entry) is not None:
            pytest.fail(f"{entry} exists in the port")
        assert port is None or name not in _bound(ast.parse(port.read_text())), entry


def _fresh(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("module", TORCH_FREE)
def test_import_leaves_torch_out(module):
    proc = _fresh(f"""
        import sys
        import {module}
        print("torch" in sys.modules)
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False", f"{module} imported torch"


def test_core_engine_brings_torch_in():
    proc = _fresh("""
        import sys
        import predictionio_tpu_torch.core as core
        before = "torch" in sys.modules
        engine = core.Engine
        print(before, "torch" in sys.modules, engine.__module__)
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [
        "False", "True", "predictionio_tpu_torch.core.engine"]


@pytest.mark.parametrize("package", PACKAGES)
def test_package_imports_first_without_a_cycle(package):
    """The package is the first module of the port a fresh process imports,
    and every name of its ``__all__`` (and ``import *``) resolves there."""
    name = f"predictionio_tpu_torch.{package}"
    proc = _fresh(f"""
        import json
        import {name} as pkg
        resolved = {{n: type(getattr(pkg, n)).__name__ for n in pkg.__all__}}
        ns = {{}}
        exec("from {name} import *", ns)
        print(json.dumps([sorted(resolved), sorted(set(ns) - {{"__builtins__"}}),
                          sorted(dir(pkg)), sorted(pkg.__all__)]))
    """)
    assert proc.returncode == 0, proc.stderr
    resolved, star, listed, exported = json.loads(proc.stdout)
    assert resolved == star == exported
    if package in LAZY:
        assert listed == exported
    else:
        assert set(exported) <= set(listed)


FACTORY_MODULE = """\
from {pkg}.core import Engine, EngineFactory, FirstServing, IdentityPreparator
from {pkg}.models.recommendation.engine import ALSAlgorithm, RatingsDataSource


class Factory(EngineFactory):
    @classmethod
    def apply(cls):
        return Engine({{"": RatingsDataSource}}, {{"": IdentityPreparator}},
                      {{"als": ALSAlgorithm}}, {{"": FirstServing}})
"""

VARIANT = {
    "datasource": {"params": {"appName": "demo"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "numIterations": 3, "lambda": 0.05, "seed": 7}}],
}


def _engine_summary(engine, params) -> dict:
    def names(classes):
        return {k: v.__name__ for k, v in classes.items()}

    return {
        "datasource": names(engine.datasource_classes),
        "preparator": names(engine.preparator_classes),
        "algorithms": names(engine.algorithm_classes),
        "serving": names(engine.serving_classes),
        "params": params.to_json_fields(),
    }


def test_engine_factory_subclass_resolves_to_an_engine(tmp_path, monkeypatch):
    for pkg, mod in (("predictionio_tpu", "jax_factory_mod"),
                     ("predictionio_tpu_torch", "pt_factory_mod")):
        (tmp_path / f"{mod}.py").write_text(FACTORY_MODULE.format(pkg=pkg))
    monkeypatch.syspath_prepend(str(tmp_path))
    summaries = []
    for eng, mod in ((jax_engine, "jax_factory_mod"),
                     (pt_engine, "pt_factory_mod")):
        factory = eng.resolve_engine_factory(f"{mod}:Factory")
        engine = factory()
        assert isinstance(engine, eng.Engine), type(engine)
        assert issubclass(sys.modules[mod].Factory, eng.EngineFactory)
        summaries.append(_engine_summary(engine, engine.params_from_json(VARIANT)))
    assert summaries[0] == summaries[1]
    with pytest.raises(NotImplementedError):
        pt_engine.EngineFactory.apply()
    # a plain factory function still resolves to itself
    assert pt_engine.resolve_engine_factory("recommendation")().__class__ is pt_engine.Engine
