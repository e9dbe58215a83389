"""The port's generic rule families against the JAX package's analyzer.

The CONC, LOCK, RES and OBS families are the same code in both packages,
with the lock wrappers named by each package's own ``obs.contention``.  So
on the same input they must give the same findings: rule, line, column,
severity and message, and the same pragma counts.  Two corpora:

1. every JAX fixture of those families, ``pragma_suppress.py`` and the
   ``lockpair/`` package, each fed to both analyzers (a fixture naming a
   module of the JAX package reaches the port with that name rewritten to
   the port's, on the same line);
2. the whole JAX package: the JAX analyzer on ``predictionio_tpu/``, the
   port's on a copy in which every ``predictionio_tpu`` module name reads
   ``predictionio_tpu_torch`` (which is how the port's analyzer sees its
   ``ContendedLock``s); the port's findings, mapped back, must equal the
   JAX analyzer's for every rule outside the JAX/TORCH families.  The two
   packages' ``--graph`` lock edges must agree on the same copy.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from predictionio_tpu.analysis import ALL_RULES as JAX_RULES
from predictionio_tpu.analysis import analyze_paths as jax_analyze_paths
from predictionio_tpu.analysis.analyzer import iter_python_files as jax_iter
from predictionio_tpu.analysis.callgraph import build_program as jax_build_program
from predictionio_tpu.analysis.rules import parse_module as jax_parse_module
from predictionio_tpu_torch.analysis import ALL_RULES, analyze_paths
from predictionio_tpu_torch.analysis.analyzer import iter_python_files
from predictionio_tpu_torch.analysis.callgraph import build_program
from predictionio_tpu_torch.analysis.rules import parse_module

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
JAX_PKG = REPO / "predictionio_tpu"

#: a module name of the JAX package, wherever it appears in source text
_JAX_NAME = re.compile(r"\bpredictionio_tpu\b")
_PORT_NAME = re.compile(r"\bpredictionio_tpu_torch\b")

GENERIC_FIXTURES = sorted(
    p.name
    for p in FIXTURES.glob("*.py")
    if p.name.startswith(("conc", "lock", "res", "obs", "pragma"))
)


def to_port(text: str) -> str:
    return _JAX_NAME.sub("predictionio_tpu_torch", text)


def to_jax(text: str) -> str:
    return _PORT_NAME.sub("predictionio_tpu", text)


def _full(report):
    return [
        (f.rule, f.file, f.line, f.col, str(f.severity), f.message, f.source)
        for f in report.findings
    ]


def _port_copy(src: Path, dst: Path) -> None:
    for f in src.rglob("*.py"):
        if "__pycache__" in f.parts:
            continue
        out = dst / f.relative_to(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(to_port(f.read_text()))


@pytest.fixture(autouse=True)
def _isolated_pio_home(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "pio-home"))


def test_generic_fixture_set_is_whole():
    assert len(GENERIC_FIXTURES) == 12
    assert {"conc001_async.py", "lock002_blocking.py", "obs005_server_dispatch.py",
            "res004_storage_full_read.py", "pragma_suppress.py"} <= set(GENERIC_FIXTURES)


@pytest.mark.parametrize("name", GENERIC_FIXTURES)
def test_fixture_findings_equal(name, tmp_path):
    jax = jax_analyze_paths([FIXTURES / name], root=FIXTURES)
    (tmp_path / name).write_text(to_port((FIXTURES / name).read_text()))
    port = analyze_paths([tmp_path / name], root=tmp_path)
    assert jax.findings, name  # each fixture trips its rule
    assert _full(port) == _full(jax)
    assert port.pragma_suppressed == jax.pragma_suppressed
    assert port.errors == jax.errors == []


def test_pragma_counts_equal():
    jax = jax_analyze_paths([FIXTURES / "pragma_suppress.py"], root=FIXTURES)
    port = analyze_paths([FIXTURES / "pragma_suppress.py"], root=FIXTURES)
    assert port.pragma_suppressed == jax.pragma_suppressed == 2
    assert [(f.rule, f.line) for f in port.findings] == [("PIO-CONC002", 20)]


def test_lockpair_findings_equal():
    jax = jax_analyze_paths([FIXTURES / "lockpair"], root=FIXTURES)
    port = analyze_paths([FIXTURES / "lockpair"], root=FIXTURES)
    assert _full(port) == _full(jax)
    assert [(f.rule, f.file, f.line) for f in port.findings] == [
        ("PIO-LOCK001", "lockpair/mod_a.py", 14)
    ]


def test_a_contended_lock_is_a_lock_to_the_port():
    """The lock wrappers are known by each package's own module name: the
    port's ContendedLock held across a blocking wait is a LOCK002 to the
    port's analyzer, as the JAX ContendedLock is to the JAX one."""
    src = (
        "from {pkg}.obs.contention import ContendedLock\n"
        "class Worker:\n"
        "    def __init__(self):\n"
        "        self._guard = ContendedLock('w')\n"
        "    def run(self, fut):\n"
        "        with self._guard:\n"
        "            return fut.result()\n"
    )
    from predictionio_tpu.analysis import analyze_source as jax_analyze_source
    from predictionio_tpu_torch.analysis import analyze_source

    jax = jax_analyze_source(src.format(pkg="predictionio_tpu"), "w.py")
    port = analyze_source(src.format(pkg="predictionio_tpu_torch"), "w.py")
    assert [(f.rule, f.line) for f in port] == [("PIO-LOCK002", 7)]
    assert [(f.rule, f.line, f.message) for f in port] == [
        (f.rule, f.line, f.message) for f in jax
    ]
    # each analyzer knows its own package's wrapper, not the other's (an
    # attribute not named like a lock is a lock only by its constructor)
    assert analyze_source(src.format(pkg="predictionio_tpu"), "w.py") == []
    assert jax_analyze_source(src.format(pkg="predictionio_tpu_torch"), "w.py") == []


# -- the whole JAX package as a corpus ----------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(JAX report on the JAX package, port report on its renamed copy,
    the copy's root)."""
    root = tmp_path_factory.mktemp("corpus")
    _port_copy(JAX_PKG, root / "predictionio_tpu_torch")
    jax = jax_analyze_paths([JAX_PKG], root=REPO, rules=_generic_rules(JAX_RULES))
    port = analyze_paths(
        [root / "predictionio_tpu_torch"], root=root, rules=_generic_rules(ALL_RULES)
    )
    return jax, port, root


def _generic_rules(registry):
    return [r for rid, r in sorted(registry.items())
            if not rid.startswith(("PIO-JAX", "PIO-TORCH"))]


def _col_back(f, root: Path) -> int:
    """The column the finding has in the JAX original: each renamed module
    name before it on its line is six characters longer in the copy."""
    line = (root / f.file).read_text().splitlines()[f.line - 1]
    before = [m for m in _PORT_NAME.finditer(line) if m.start() < f.col - 1]
    return f.col - 6 * len(before)


def test_corpus_parses_clean_and_scans_the_same_files(corpus):
    jax, port, _ = corpus
    assert jax.errors == port.errors == []
    assert port.files_scanned == jax.files_scanned > 50


def test_corpus_generic_findings_equal(corpus):
    jax, port, root = corpus
    want = [
        (f.rule, f.file, f.line, f.col, str(f.severity), f.message, f.source)
        for f in jax.findings
    ]
    got = [
        (f.rule, to_jax(f.file), f.line, _col_back(f, root), str(f.severity),
         to_jax(f.message), to_jax(f.source))
        for f in port.findings
    ]
    assert got == want
    assert {f.rule for f in jax.findings} >= {
        "PIO-CONC002", "PIO-CONC004"
    }


def test_corpus_runs_the_same_generic_rules(corpus):
    assert [r.id for r in _generic_rules(ALL_RULES)] == [
        r.id for r in _generic_rules(JAX_RULES)
    ]
    assert len(_generic_rules(ALL_RULES)) == 11


def test_corpus_pragma_counts_equal(corpus):
    jax, port, _ = corpus
    assert port.pragma_suppressed == jax.pragma_suppressed > 0


def test_corpus_lock_edges_equal(corpus):
    """`--graph`'s lock edges: the port's program on the copy and the JAX
    program on the original see the same acquisition graph, the
    ContendedLocks included."""
    _, _, root = corpus
    jax_mods = [
        jax_parse_module(p, p.resolve().relative_to(REPO).as_posix(), p.read_text())
        for p in jax_iter([JAX_PKG])
    ]
    port_mods = [
        parse_module(p, p.resolve().relative_to(root).as_posix(), p.read_text())
        for p in iter_python_files([root / "predictionio_tpu_torch"])
    ]
    jax_prog, port_prog = jax_build_program(jax_mods), build_program(port_mods)
    jax_edges = {(e.src, e.dst) for e in jax_prog.lock_edges()}
    port_edges = {
        (to_jax(e.src), to_jax(e.dst)) for e in port_prog.lock_edges()
    }
    assert jax_edges and port_edges == jax_edges
    # the ContendedLocks are locks to both, under their runtime names
    jax_witness = {n.key: n.witness for n in jax_prog.locks.values()}
    port_witness = {to_jax(n.key): n.witness for n in port_prog.locks.values()}
    assert port_witness == jax_witness
    assert sum(w is not None for w in port_witness.values()) >= 5


def test_corpus_copy_is_a_rename_only(corpus):
    _, _, root = corpus
    orig = sorted(p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py")
                  if "__pycache__" not in p.parts)
    copy = sorted(p.relative_to(root / "predictionio_tpu_torch")
                  for p in (root / "predictionio_tpu_torch").rglob("*.py"))
    assert orig == copy
    sample = JAX_PKG / "obs" / "contention.py"
    assert to_jax(to_port(sample.read_text())) == sample.read_text()
