"""`pio check` on the PyTorch port: the PIO-TORCH rule corpus against the
JAX package's PIO-JAX corpus, the CLI contract in both CLIs, the DASE
contract checker over the port's stage classes, and the train/deploy
pre-flight.

The PyTorch fixtures are the source strings below, each a line-for-line
twin of a ``tests/fixtures/analysis/jax00N_*.py`` fixture in PyTorch's
spellings; the line each finding lands on is stated in the fixture's own
comments.  ``(rule number, line, severity)`` on a twin must equal the JAX
analyzer's on its fixture.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import pytest

from predictionio_tpu.analysis import analyze_source as jax_analyze_source
from predictionio_tpu.tools.cli import main as jax_cli_main
from predictionio_tpu_torch.analysis import (
    ALL_RULES,
    DEFAULT_BASELINE_NAME,
    Baseline,
    Severity,
    analyze_paths,
    analyze_source,
    filter_severity,
)
from predictionio_tpu_torch.tools.cli import main as cli_main

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"

# -- the PyTorch twins of the PIO-JAX fixtures --------------------------------

TORCH001 = '''\
"""Fixture: PIO-TORCH001 — host syncs inside hot-path functions."""

import numpy as np

import torch


def predict(model, query):
    scores = model.fn(query)
    best = np.asarray(scores)  # line 10: TORCH001 (np.asarray in predict)
    return best[0]


def batch_predict(model, queries):
    out = model.fn(queries)
    return out.item()  # line 16: TORCH001 (.item in batch_predict)


def serve(query, predictions):
    return predictions.cpu()  # line 20: TORCH001 (.cpu in serve)


def prepare(ctx, td):
    return np.asarray(td)  # clean: not a hot-path function
'''

TORCH002 = '''\
"""Fixture: PIO-TORCH002 — CUDA work at module import time."""

import torch
from torch import Generator

_TABLE = torch.arange(1024, device="cuda")  # line 6: TORCH002 (module level)


class Holder:
    GEN = Generator(device="cuda")  # line 10: TORCH002 (class body at import)


def fine():
    return torch.zeros(3, device="cuda")  # clean: inside a function


if __name__ == "__main__":
    print(torch.ones(2).cuda())  # clean: main guard does not run at import
'''

TORCH003 = '''\
"""Fixture: PIO-TORCH003 — Python control flow on tensors in a compiled fn."""

from functools import partial

import torch
import torch.nn.functional as F


@torch.compile
def relu_bad(x):
    if x > 0:  # line 11: TORCH003 (Python if on a tensor argument)
        return x
    return F.relu(x)


@partial(torch.compile, dynamic=False)
def gated(x, flag: bool):
    if flag:  # clean: a Python scalar is a guarded constant
        return x * 2
    if x.shape[0] > 1:  # clean: shape is static under trace
        return x + 1
    if x is None:  # clean: identity check is concrete
        return x
    while x > 0:  # line 24: TORCH003 (Python while on a tensor argument)
        x = x - 1
    return x


def plain(x):
    if x > 0:  # clean: not compiled
        return x
    return -x
'''

TORCH004 = '''\
"""Fixture: PIO-TORCH004 — torch.compile constructed inside a loop."""

import torch


def per_step_compile(fns, xs):
    outs = []
    for f in fns:
        cf = torch.compile(f)  # line 9: TORCH004 (fresh cache per iteration)
        outs.append(cf(xs))
    return outs


def hoisted(f, xs):
    cf = torch.compile(f)  # clean: wrapped once
    out = []
    for x in xs:
        out.append(cf(x))
    return out


def loop_calls_factory(fns, xs):
    def make(f):
        return torch.compile(f)  # clean: built per call of make, not per iter

    out = []
    for f in fns:
        out.append(make(f)(xs))
    return out
'''

TORCH005 = '''\
"""Fixture: PIO-TORCH005 — mutable default argument on a compiled function."""

import torch


@torch.compile
def bad(x, opts=[]):  # line 7: TORCH005 (list default on a compiled fn)
    return x


def plain(x, opts=[]):  # clean: not compiled
    return x
'''

TORCH006 = '''\
"""PIO-TORCH006 fixture: per-wave device placement inside serving loops."""
import torch

from predictionio_tpu_torch.parallel.mesh import global_data_array


def batch_predict(model, queries):
    out = []
    for i, q in queries:
        table = torch.as_tensor(model.table, device="cuda")  # EVERY iteration
        out.append((i, table))
    return out


def _serve_wave(payloads):
    while payloads:
        chunk = global_data_array(None, payloads.pop())  # re-sharded per wave
    return chunk


def predict(model, query):
    # placement OUTSIDE a loop is the bind-time pattern: clean
    table = model.table.to("cuda")
    return table[query]


def helper(model, queries):
    # not a hot-path function name: loops here are not serving waves
    for q in queries:
        q.cuda()
'''

TORCH007 = '''\
"""PIO-TORCH007 fixture: host sync inside the dispatch (pre-fence) region."""
import torch


def dispatch_batch(model, queries):
    dev = model.kernel(queries)
    model.done.synchronize()  # blocks the worker before the fence
    torch.cuda.synchronize()  # same, module spelling
    n = dev[0].item()  # per-item device->host sync pre-fence
    host = dev.cpu()  # explicit transfer pre-fence

    def finalize():
        # the fence region: syncing HERE is the design — exempt
        model.done.synchronize()
        return dev.cpu(), n, host

    return finalize


def _dispatch_wave(wave):
    out = wave.cpu()  # the worker thread must stay non-blocking
    return out


def helper(model, queries):
    # not a dispatch-phase function: fence-side syncs are fine here
    x = model.kernel(queries)
    torch.cuda.synchronize()
    return x.cpu()
'''

TORCH008 = '''\
"""Fixture: PIO-TORCH008 — host sync hidden two calls below the seam."""


def predict(model, query):
    return _gather(model, query)


def _gather(model, query):
    return _pull(model.scores(query))


def _pull(x):
    return x.item()  # line 13: TORCH008 (predict -> _gather -> _pull)
'''

#: twin name -> (its source, the JAX fixture it mirrors)
TWINS = {
    "torch001_sync.py": (TORCH001, "jax001_sync.py"),
    "torch002_import.py": (TORCH002, "jax002_import.py"),
    "torch003_branch.py": (TORCH003, "jax003_branch.py"),
    "torch004_loop.py": (TORCH004, "jax004_loop.py"),
    "torch005_default.py": (TORCH005, "jax005_default.py"),
    "torch006_reshard.py": (TORCH006, "jax006_reshard.py"),
    "torch007_dispatch_sync.py": (TORCH007, "jax007_dispatch_sync.py"),
    "torch008_transitive.py": (TORCH008, "jax008_transitive.py"),
}


@pytest.fixture(autouse=True)
def _isolated_pio_home(tmp_path, monkeypatch):
    """Keep the check-cache out of the developer's real home."""
    monkeypatch.setenv("PIO_HOME", str(tmp_path / "pio-home"))


def twin_findings(name: str):
    return analyze_source(TWINS[name][0], name)


def numbered(findings):
    """(rule number, line, severity): PIO-JAX003 and PIO-TORCH003 alike."""
    return [(f.rule[-3:], f.line, str(f.severity)) for f in findings]


class TestTorchRuleCorpus:
    @pytest.mark.parametrize("name", sorted(TWINS))
    def test_twin_gives_the_jax_triples(self, name):
        src, jax_name = TWINS[name]
        jax = jax_analyze_source((FIXTURES / jax_name).read_text(), jax_name)
        got = twin_findings(name)
        assert numbered(got) == numbered(jax)
        assert got and all(f.rule.startswith("PIO-TORCH") for f in got)

    def test_torch001_hot_path_sync(self):
        assert [(f.rule, f.line) for f in twin_findings("torch001_sync.py")] == [
            ("PIO-TORCH001", 10), ("PIO-TORCH001", 16), ("PIO-TORCH001", 20),
        ]

    def test_torch007_exempts_the_finalize_closure(self):
        got = twin_findings("torch007_dispatch_sync.py")
        assert [f.line for f in got] == [7, 8, 9, 10, 21]
        assert "torch.cuda.synchronize" in got[1].message

    def test_torch008_names_the_seam_and_depth(self):
        (f,) = twin_findings("torch008_transitive.py")
        assert "seam 'torch008_transitive:predict'" in f.message
        assert "depth 2" in f.message and "_gather" in f.message

    def test_every_shipped_rule_has_fixture_coverage(self):
        seen = {f.rule for name in TWINS for f in twin_findings(name)}
        for name in (
            "conc001_async.py", "conc002_poll.py", "conc003_lock.py",
            "conc004_singleton.py", "res001_timeout.py", "res002_swallow.py",
            "res003_storage_write.py", "res004_storage_full_read.py",
            "obs005_server_dispatch.py", "lock001_inversion.py",
            "lock002_blocking.py",
        ):
            seen |= {
                f.rule
                for f in analyze_source((FIXTURES / name).read_text(), name)
            }
        assert seen == set(ALL_RULES)
        assert not any(r.startswith("PIO-JAX") for r in ALL_RULES)

    def test_jax_spellings_are_not_torch_findings(self):
        """The JAX fixtures' device calls are not PyTorch's: a JAX engine
        scanned by the port analyzer gives no PIO-TORCH finding for
        jax.device_get or jnp at import."""
        for name in ("jax002_import.py", "jax004_loop.py", "jax005_default.py"):
            src = (FIXTURES / name).read_text()
            assert analyze_source(src, name) == [], name


class TestTorchRuleExemptions:
    """The counterparts of the JAX corpus's exemption cases, plus the
    negative cases of the PyTorch spellings."""

    def test_torch002_skips_deferred_code_under_module_if_try(self):
        src = (
            "import torch\n"
            "try:\n"
            "    import fastpath\n"
            "except ImportError:\n"
            "    def fallback():\n"
            "        return torch.zeros(3, device='cuda')\n"  # deferred
            "L = lambda: torch.zeros(3, device='cuda')\n"  # deferred
            "def decorated(x=torch.zeros(2, device='cuda')):\n"  # at import
            "    return x\n"
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH002", 8)
        ]

    def test_torch002_main_guard_is_literal_eq_only(self):
        src = (
            "import torch\n"
            'if __name__ != "__main__":\n'
            "    T = torch.zeros(8).cuda()\n"  # runs on import: flagged
            'if "__main__" == __name__:\n'
            "    U = torch.zeros(8).cuda()\n"  # script-only: clean
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH002", 3)
        ]

    def test_torch002_main_guard_else_arm_runs_at_import(self):
        src = (
            "import torch\n"
            'if __name__ == "__main__":\n'
            "    print(torch.ones(2, device='cuda'))\n"  # script-only
            "else:\n"
            "    T = torch.zeros(1024).to('cuda:0')\n"  # line 5: on import
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH002", 5)
        ]

    def test_torch002_spellings(self):
        src = (
            "import torch\n"
            "torch.cuda.init()\n"  # 2: torch.cuda.* at import
            "D = torch.empty(4, device=torch.device('cuda', 1))\n"  # 3
            "G = torch.Generator(device='cuda:0')\n"  # 4
            "X = torch.ones(3).to(device=0)\n"  # 5: ordinal = a card
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH002", n) for n in (2, 3, 4, 5)
        ]

    def test_cpu_tensor_at_import_is_clean(self):
        src = (
            "import torch\n"
            "T = torch.zeros(8)\n"
            "C = torch.arange(4, device='cpu')\n"
            "G = torch.Generator(device='cpu')\n"
            "H = torch.ones(2).to(torch.float16)\n"
        )
        assert analyze_source(src) == []

    def test_cpu_outside_a_hot_function_is_clean(self):
        src = (
            "def prepare(ctx, td):\n"
            "    return td.cpu().numpy(), td.item(), td.tolist()\n"
            "def finalize_report(x):\n"
            "    x.synchronize()\n"
            "    return x.cpu()\n"
        )
        assert analyze_source(src) == []

    def test_finalize_closure_in_a_dispatch_function_is_clean(self):
        src = (
            "def dispatch_wave(model, q):\n"
            "    dev = model.kernel(q)\n"
            "    def finalize():\n"
            "        return dev.cpu().numpy(), dev[0].item()\n"
            "    return finalize\n"
        )
        assert analyze_source(src) == []

    def test_torch001_tolist_numpy_and_stream_synchronize(self):
        src = (
            "import torch\n"
            "def batch_predict(model, qs):\n"
            "    out = model(qs)\n"
            "    torch.cuda.current_stream().synchronize()\n"  # 4
            "    ids = out.tolist()\n"  # 5
            "    return out.numpy(), ids\n"  # 6
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH001", 4), ("PIO-TORCH001", 5), ("PIO-TORCH001", 6),
        ]

    def test_torch003_exemptions_are_subtree_scoped(self):
        src = (
            "import torch\n"
            "@torch.compile\n"
            "def g(x, *, y=None):\n"
            "    if y is not None:\n"  # clean: identity check alone
            "        x = x + y\n"
            "    if y is not None and x > 0:\n"  # line 6: x is a tensor
            "        return x\n"
            "    return x\n"
        )
        fs = analyze_source(src)
        assert [(f.rule, f.line) for f in fs] == [("PIO-TORCH003", 6)]
        assert "'x'" in fs[0].message
        src2 = (
            "import torch\n"
            "@torch.jit.script\n"
            "def f(x, mode):\n"
            "    if isinstance(mode, str) and x > 0:\n"  # x still a tensor
            "        return x\n"
            "    return x\n"
        )
        assert [(f.rule, f.line) for f in analyze_source(src2)] == [
            ("PIO-TORCH003", 4)
        ]

    def test_torch003_len_and_size_of_a_tensor_are_static(self):
        src = (
            "import torch\n"
            "@torch.compile(fullgraph=True)\n"
            "def f(x):\n"
            "    if len(x) > 3 or x.size(0) > 2 or x.dim() == 2:\n"
            "        return x\n"
            "    return x + 1\n"
        )
        assert analyze_source(src) == []

    def test_torch004_jit_script_in_a_loop(self):
        src = (
            "import torch\n"
            "def f(fns):\n"
            "    while fns:\n"
            "        g = torch.jit.script(fns.pop())\n"
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH004", 4)
        ]

    def test_torch006_dtype_cast_is_not_placement(self):
        src = (
            "import torch\n"
            "def batch_predict(model, qs):\n"
            "    for q in qs:\n"
            "        q.to(torch.float32)\n"  # a cast: clean
            "        q.to(model.device)\n"  # 5: placement
            "        torch.as_tensor(q, device=model.device)\n"  # 6
        )
        assert [(f.rule, f.line) for f in analyze_source(src)] == [
            ("PIO-TORCH006", 5), ("PIO-TORCH006", 6),
        ]

    def test_pragma_silences_a_torch_rule(self):
        lines = TORCH008.splitlines()
        lines[12] += "  # pio: ignore[PIO-TORCH008]"
        assert analyze_source("\n".join(lines) + "\n") == []


class TestSeverityFilter:
    def test_threshold(self):
        findings = twin_findings("torch001_sync.py") + analyze_source(
            (FIXTURES / "conc002_poll.py").read_text(), "conc002_poll.py"
        )
        assert len(filter_severity(findings, Severity.LOW)) == 4
        assert len(filter_severity(findings, Severity.MEDIUM)) == 4
        assert [f.rule for f in filter_severity(findings, Severity.HIGH)] == [
            "PIO-CONC002"
        ]


# -- the CLI contract, the same inputs through both CLIs ------------------------

BOTH = pytest.mark.parametrize(
    "main", [jax_cli_main, cli_main], ids=["jax", "torch"]
)


class TestCheckCLI:
    """Exit-code contract: 0 clean, 1 findings, 2 usage/parse error."""

    @BOTH
    def test_exit_0_clean_text_and_json(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        p = tmp_path / "clean.py"
        p.write_text("def f():\n    return 1\n")
        assert main(["check", str(p)]) == 0
        assert "0 finding(s)" in capsys.readouterr().out
        assert main(["check", str(p), "--format", "json"]) == 0
        data = json.loads(capsys.readouterr().out)
        assert data["findings"] == [] and data["summary"]["total"] == 0

    @BOTH
    def test_exit_1_findings_text_and_json(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        target = str(FIXTURES / "conc002_poll.py")
        assert main(["check", target]) == 1
        out = capsys.readouterr().out
        assert "PIO-CONC002" in out and ":7:" in out
        assert main(["check", target, "--format", "json"]) == 1
        data = json.loads(capsys.readouterr().out)
        assert [f["rule"] for f in data["findings"]] == ["PIO-CONC002"]
        assert data["findings"][0]["line"] == 7

    def test_json_keys_are_the_jax_verbs(self, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        target = str(FIXTURES / "conc003_lock.py")
        docs = []
        for main in (jax_cli_main, cli_main):
            assert main(["check", target, "--format", "json", "--no-cache"]) == 1
            docs.append(json.loads(capsys.readouterr().out))
        assert docs[0] == docs[1]

    @BOTH
    def test_exit_2_on_missing_path(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        assert main(["check", str(tmp_path / "nope")]) == 2
        assert "usage error" in capsys.readouterr().err

    @BOTH
    def test_exit_2_on_unparseable_file(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        bad = tmp_path / "bad.py"
        bad.write_text("def broken(:\n")
        assert main(["check", str(bad)]) == 2
        assert "SyntaxError" in capsys.readouterr().out
        assert main(["check", str(bad), "--format", "json"]) == 2
        assert json.loads(capsys.readouterr().out)["errors"]

    @BOTH
    def test_exit_2_on_bad_severity(self, main, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "c.py").write_text("x = 1\n")
        assert main(["check", str(tmp_path / "c.py"), "--severity", "nah"]) == 2

    @BOTH
    def test_exit_2_on_bad_baseline(self, main, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        bad = tmp_path / "b.json"
        bad.write_text("[]")
        argv = ["check", str(FIXTURES / "conc002_poll.py"), "--baseline", str(bad)]
        assert main(argv) == 2

    def test_severity_threshold_flag(self, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        target = tmp_path / "torch001_sync.py"  # mediums only
        target.write_text(TORCH001)
        assert cli_main(["check", str(target)]) == 1
        capsys.readouterr()
        assert cli_main(["check", str(target), "--severity", "high"]) == 0

    @BOTH
    def test_write_baseline_then_clean(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        target = str(FIXTURES / "conc003_lock.py")
        bl = str(tmp_path / "bl.json")
        assert main(["check", target, "--baseline", bl, "--write-baseline"]) == 1
        out = capsys.readouterr()
        assert "7 baseline entries" in out.out
        assert "still" in out.err and "conc003_lock.py" in out.err
        assert main(["check", target, "--baseline", bl]) == 0
        assert ", 7 suppressed" in capsys.readouterr().out

    @BOTH
    def test_write_baseline_exits_0_once_curated(
        self, main, tmp_path, capsys, monkeypatch
    ):
        monkeypatch.chdir(tmp_path)
        target = str(FIXTURES / "conc002_poll.py")
        bl = tmp_path / "bl.json"
        assert main(["check", target, "--baseline", str(bl), "--write-baseline"]) == 1
        capsys.readouterr()
        data = json.loads(bl.read_text())
        for e in data["entries"]:
            e["justification"] = "reviewed: fixture poll loop is the test"
        bl.write_text(json.dumps(data))
        assert main(["check", target, "--baseline", str(bl), "--write-baseline"]) == 0
        assert capsys.readouterr().err == ""

    @BOTH
    def test_write_baseline_refuses_on_parse_error(
        self, main, tmp_path, capsys, monkeypatch
    ):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "bad.py").write_text("def broken(:\n")
        (tmp_path / "ok.py").write_text("x = 1\n")
        assert main(["check", str(tmp_path), "--write-baseline"]) == 2
        assert "refusing" in capsys.readouterr().err
        assert not (tmp_path / DEFAULT_BASELINE_NAME).exists()

    def test_write_baseline_ignores_severity_filter(
        self, tmp_path, capsys, monkeypatch
    ):
        monkeypatch.chdir(tmp_path)
        target = tmp_path / "torch001_sync.py"  # medium findings only
        target.write_text(TORCH001)
        bl = str(tmp_path / "bl.json")
        argv = ["check", str(target), "--severity", "high", "--baseline", bl,
                "--write-baseline"]
        assert cli_main(argv) == 1
        assert "3 baseline entries" in capsys.readouterr().out
        assert cli_main(["check", str(target), "--baseline", bl]) == 0

    @BOTH
    def test_default_baseline_autodiscovery(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        target = str(FIXTURES / "conc002_poll.py")
        assert main(["check", target, "--write-baseline"]) == 1
        assert (tmp_path / ".pio-check-baseline.json").exists()
        capsys.readouterr()
        assert main(["check", target]) == 0

    def test_scan_root_under_skip_named_dir_still_scans(self, tmp_path):
        repo = tmp_path / "venv" / "repo"
        (repo / "node_modules").mkdir(parents=True)
        (repo / "src").mkdir()
        poll = "import time\ndef w(x):\n    while not x.done:\n        time.sleep(1)\n"
        (repo / "src" / "poll.py").write_text(poll)
        (repo / "node_modules" / "skipme.py").write_text(poll)
        report = analyze_paths([repo], root=repo)
        assert report.files_scanned == 1
        assert [f.rule for f in report.findings] == ["PIO-CONC002"]

    def test_help_documents_exit_codes(self, capsys):
        with pytest.raises(SystemExit) as e:
            cli_main(["check", "--help"])
        assert e.value.code == 0
        out = " ".join(capsys.readouterr().out.split())  # any wrap width
        assert "0 = clean" in out and "1 = findings" in out
        assert "2 = usage or parse error" in out and "PIO-TORCH" in out

    def test_unknown_flag_exits_2(self):
        with pytest.raises(SystemExit) as e:
            cli_main(["check", "--bogus"])
        assert e.value.code == 2

    def test_a_baseline_written_by_either_package_filters_the_other(
        self, tmp_path, capsys, monkeypatch
    ):
        """Version 1 in both: the JAX package's snapshot suppresses the
        port's findings on the same file, and the other way round."""
        monkeypatch.chdir(tmp_path)
        target = str(FIXTURES / "conc003_lock.py")
        for writer, reader in ((jax_cli_main, cli_main), (cli_main, jax_cli_main)):
            bl = tmp_path / f"bl-{id(writer)}.json"
            assert writer(["check", target, "--baseline", str(bl),
                           "--write-baseline"]) == 1
            capsys.readouterr()
            assert json.loads(bl.read_text())["version"] == 1
            assert reader(["check", target, "--baseline", str(bl)]) == 0
            assert ", 7 suppressed" in capsys.readouterr().out

    def test_shared_cache_never_changes_a_finding(
        self, tmp_path, capsys, monkeypatch
    ):
        """One $PIO_HOME/check-cache.json for both packages: each
        package's rule-set version evicts the other's entries, so neither
        is ever served the other's findings."""
        monkeypatch.chdir(tmp_path)
        (tmp_path / "eng.py").write_text(TORCH001)
        argv = ["check", "eng.py", "--format", "json", "--stats"]
        want = {}
        for name, main in (("jax", jax_cli_main), ("torch", cli_main)):
            assert main(argv[:-1] + ["--no-cache"]) == 1
            want[name] = json.loads(capsys.readouterr().out)["findings"]
        assert [f["rule"] for f in want["torch"]] == ["PIO-TORCH001"] * 3
        assert [f["rule"] for f in want["jax"]] == ["PIO-JAX001"] * 2
        for name, main in (("jax", jax_cli_main), ("torch", cli_main)) * 2:
            assert main(argv) == 1
            out = capsys.readouterr()
            assert json.loads(out.out)["findings"] == want[name], name
            assert "cache: 0 hit(s), 1 miss(es)" in out.err, name
        # warm for the same package twice in a row
        assert cli_main(argv) == 1
        assert "cache: 1 hit(s), 0 miss(es)" in capsys.readouterr().err


class TestSarifOutput:
    def test_sarif_has_the_golden_shape_with_the_ports_rule_table(
        self, capsys, monkeypatch
    ):
        monkeypatch.chdir(FIXTURES)
        rc = cli_main(["check", "conc002_poll.py", "--format", "sarif", "--no-cache"])
        assert rc == 1
        got = json.loads(capsys.readouterr().out)
        golden = json.loads((FIXTURES / "sarif_golden.json").read_text())
        rules = got["runs"][0]["tool"]["driver"].pop("rules")
        golden["runs"][0]["tool"]["driver"].pop("rules")
        (res,) = got["runs"][0]["results"]
        assert rules[res.pop("ruleIndex")]["id"] == "PIO-CONC002"
        golden["runs"][0]["results"][0].pop("ruleIndex")
        assert got == golden
        assert [r["id"] for r in rules] == sorted(ALL_RULES)
        assert all(r["shortDescription"]["text"] for r in rules)

    @BOTH
    def test_sarif_exit_contract(self, main, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        clean = tmp_path / "clean.py"
        clean.write_text("def f():\n    return 1\n")
        assert main(["check", str(clean), "--format", "sarif"]) == 0
        assert json.loads(capsys.readouterr().out)["runs"][0]["results"] == []
        bad = tmp_path / "bad.py"
        bad.write_text("def broken(:\n")
        assert main(["check", str(bad), "--format", "sarif"]) == 2
        inv = json.loads(capsys.readouterr().out)["runs"][0]["invocations"][0]
        assert inv["executionSuccessful"] is False
        assert "SyntaxError" in inv["toolExecutionNotifications"][0]["message"]["text"]


class TestGraphDump:
    def test_graph_dump_equals_the_jax_verbs(self, capsys, monkeypatch):
        monkeypatch.chdir(FIXTURES)
        docs = []
        for main in (jax_cli_main, cli_main):
            assert main(["check", "lock001_inversion.py", "--graph"]) == 0
            docs.append(json.loads(capsys.readouterr().out))
        assert docs[0] == docs[1]
        edges = {(e["src"], e["dst"]) for e in docs[1]["locks"]["edges"]}
        assert edges == {
            ("lock001_inversion:LOCK_A", "lock001_inversion:LOCK_B"),
            ("lock001_inversion:LOCK_B", "lock001_inversion:LOCK_A"),
        }

    def test_graph_dump_parse_error_exits_2(self, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "bad.py").write_text("def broken(:\n")
        assert cli_main(["check", str(tmp_path), "--graph"]) == 2
        assert "SyntaxError" in capsys.readouterr().err


# -- DASE contract checks on the port's stage classes ---------------------------


def _components():
    """A well-wired tiny engine's parts plus deliberately miswired ones,
    all on the port's base classes."""
    from predictionio_tpu_torch.core.base import (
        Algorithm,
        DataSource,
        Preparator,
        Serving,
    )

    class TinyDataSource(DataSource):
        def __init__(self, params=None):
            self.params = params

        def read_training(self, ctx):
            return [1, 2, 3]

    class TinyPreparator(Preparator):
        def __init__(self, params=None):
            self.params = params

        def prepare(self, ctx, td):
            return td

    class TinyAlgorithm(Algorithm):
        def __init__(self, params=None):
            self.params = params

        def train(self, ctx, pd):
            return list(pd)

        def predict(self, model, query):
            return query

    class TinyServing(Serving):
        def __init__(self, params=None):
            self.params = params

        def serve(self, query, predictions):
            return predictions[0]

    class BadArityDataSource(DataSource):
        def read_training(self):  # missing ctx
            return []

    class AbstractAlgorithm(Algorithm):  # predict never implemented
        def train(self, ctx, pd):
            return None

    @dataclass(frozen=True)
    class AliasTypoParams:
        rank: int = 8
        params_aliases = {"numFactors": "rankk"}  # typo: no such field

    class AliasTypoAlgorithm(TinyAlgorithm):
        params_class = AliasTypoParams

        def __init__(self, params=None):
            self.params = params or AliasTypoParams()

    class NotAServing(Preparator):  # wrong DASE slot
        def prepare(self, ctx, td):
            return td

    return {
        "ds": TinyDataSource, "prep": TinyPreparator, "algo": TinyAlgorithm,
        "serving": TinyServing, "bad_arity": BadArityDataSource,
        "abstract": AbstractAlgorithm, "alias_typo": AliasTypoAlgorithm,
        "not_a_serving": NotAServing,
    }


@pytest.fixture()
def register():
    """Register engine factories in the port's registry for one test."""
    from predictionio_tpu_torch.core.engine import engine_registry

    names = []

    def add(name, factory):
        engine_registry.register(name, factory)
        names.append(name)
        return name

    yield add
    for n in names:
        engine_registry._entries.pop(n, None)


def _engine(**slots):
    from predictionio_tpu_torch.core.engine import Engine

    c = _components()
    return lambda: Engine(
        c[slots.get("ds", "ds")], c[slots.get("prep", "prep")],
        c[slots.get("algo", "algo")], c[slots.get("serving", "serving")],
    )


class TestDaseContract:
    def test_bundled_engines_are_clean(self, capsys):
        from predictionio_tpu_torch.analysis.contract import check_engine_contract
        from predictionio_tpu_torch.core.engine import engine_registry

        import predictionio_tpu_torch.models  # noqa: F401

        names = engine_registry.names()
        assert "recommendation" in names and "ncf" in names
        for name in names:
            assert check_engine_contract(name) == [], name
        assert cli_main(["check", "--engine", "all"]) == 0
        assert "0 finding(s)" in capsys.readouterr().out

    def test_bad_arity_reported(self):
        from predictionio_tpu_torch.analysis.contract import check_component

        fs = list(check_component("datasource", "ds", _components()["bad_arity"]))
        (f,) = [f for f in fs if f.rule == "PIO-DASE002"]
        assert "read_training() accepts at most 1 positional argument(s) " \
            "but the framework calls it with 2" in f.message
        assert "(expected read_training(self, ctx))" in f.message

    def test_abstract_component_reported(self):
        from predictionio_tpu_torch.analysis.contract import check_component

        fs = list(check_component("algorithm", "a", _components()["abstract"]))
        assert any(
            f.rule == "PIO-DASE001"
            and "is still abstract (unimplemented: ['predict'])" in f.message
            for f in fs
        )

    def test_params_alias_typo_reported(self):
        from predictionio_tpu_torch.analysis.contract import check_component

        fs = list(check_component("algorithm", "a", _components()["alias_typo"]))
        assert any(
            f.rule == "PIO-DASE003"
            and "params_aliases maps 'numFactors' to 'rankk'" in f.message
            for f in fs
        )

    def test_wrong_slot_reported(self):
        from predictionio_tpu_torch.analysis.contract import check_component

        fs = list(check_component("serving", "s", _components()["not_a_serving"]))
        assert [f.rule for f in fs] == ["PIO-DASE001"]
        assert "subclasses the Preparator base — it is wired into the wrong " \
            "DASE slot" in fs[0].message

    def test_unresolvable_factory_reported(self):
        from predictionio_tpu.analysis.contract import (
            check_engine_contract as jax_check,
        )
        from predictionio_tpu_torch.analysis.contract import check_engine_contract

        fs = check_engine_contract("definitely_not_registered")
        assert [f.rule for f in fs] == ["PIO-DASE001"]
        assert fs[0].severity is Severity.HIGH
        assert "engine factory 'definitely_not_registered' not resolvable: " \
            "KeyError" in fs[0].message
        (jf,) = jax_check("definitely_not_registered")
        assert jf.message.split(": KeyError")[0] == fs[0].message.split(": KeyError")[0]

    def test_factory_module_crash_becomes_finding(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.analysis.contract import check_engine_contract

        (tmp_path / "crashy_torch_engine_mod.py").write_text(
            "raise RuntimeError('config missing')\n"
        )
        monkeypatch.syspath_prepend(str(tmp_path))
        fs = check_engine_contract("crashy_torch_engine_mod:factory")
        assert [f.rule for f in fs] == ["PIO-DASE001"]
        assert "not resolvable: RuntimeError: config missing" in fs[0].message

    def test_synthetic_engine_findings_never_baselined(self, tmp_path):
        from predictionio_tpu_torch.analysis.contract import check_engine_contract

        fs = check_engine_contract("no_such_engine_xyz")
        path = tmp_path / "baseline.json"
        assert Baseline.write(path, fs) == 0
        remaining, suppressed = Baseline.load(path).filter(fs)
        assert suppressed == 0 and len(remaining) == 1

    def test_check_engine_cli_verb(self, capsys, register):
        assert cli_main(["check", "--engine", "recommendation"]) == 0
        capsys.readouterr()
        assert cli_main(["check", "--engine", "no_such_engine"]) == 1
        assert "PIO-DASE001" in capsys.readouterr().out
        name = register("_torch_alias_typo", _engine(algo="alias_typo"))
        assert cli_main(["check", "--engine", "all", "--engine", name]) == 1
        out = capsys.readouterr().out
        assert "PIO-DASE003" in out and "'all'" not in out

    def test_plain_lint_imports_no_torch(self, tmp_path):
        """`pio check` over files is stdlib-ast only: a fresh interpreter
        that runs the analyzer has imported neither torch nor an engine."""
        import subprocess
        import sys

        (tmp_path / "f.py").write_text(TORCH001)
        code = (
            "import sys\n"
            "from predictionio_tpu_torch.analysis import analyze_paths\n"
            f"r = analyze_paths([{str(tmp_path / 'f.py')!r}])\n"
            "assert len(r.findings) == 3, r.findings\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'predictionio_tpu') or m.startswith("
            "('predictionio_tpu_torch.models', 'predictionio_tpu_torch.core'))]\n"
            "print(bad)\n"
        )
        repo = str(Path(__file__).resolve().parents[1])
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env={"PYTHONPATH": repo, "PATH": "/usr/bin:/bin"},
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"


class TestPreflight:
    """`train`/`deploy` abort on contract violations before any device is
    resolved; --no-check skips the gate."""

    @pytest.fixture()
    def no_card(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    @pytest.fixture()
    def port_storage(self, tmp_path, monkeypatch):
        from predictionio_tpu_torch.data.storage.config import (
            StorageConfig,
            StorageRuntime,
        )
        from predictionio_tpu_torch.tools import cli

        rt = StorageRuntime(
            StorageConfig.from_env({"PIO_HOME": str(tmp_path / "pio_home")})
        )
        monkeypatch.setattr(cli, "get_storage", lambda: rt)
        yield rt
        rt.close()

    def test_train_aborts_before_the_device(self, no_card, register, capsys):
        import torch

        name = register("_torch_alias_typo", _engine(algo="alias_typo"))
        assert cli_main(["train", "--engine", name]) == 1  # no --device
        err = capsys.readouterr().err
        assert "PIO-DASE003" in err and "--no-check" in err
        assert f"DASE pre-flight failed for engine {name!r}: 1 contract " \
            "violation(s)" in err
        assert not torch.cuda.is_initialized()

    def test_train_no_check_skips_preflight(
        self, register, port_storage, capsys
    ):
        name = register("_torch_alias_typo", _engine(algo="alias_typo"))
        argv = ["train", "--engine", name, "--no-check", "--device", "cpu"]
        assert cli_main(argv) == 0
        assert "Training completed" in capsys.readouterr().out

    def test_no_check_reaches_the_device_rule(self, no_card, register):
        from predictionio_tpu_torch.device import DeviceUnavailable

        name = register("_torch_alias_typo", _engine(algo="alias_typo"))
        with pytest.raises(DeviceUnavailable):
            cli_main(["train", "--engine", name, "--no-check"])

    def test_deploy_preflight_aborts(self, no_card, register, capsys):
        name = register("_torch_abstract", _engine(algo="abstract"))
        assert cli_main(["deploy", "--engine", name, "--port", "0"]) == 1
        err = capsys.readouterr().err
        assert "PIO-DASE001" in err and "still abstract" in err

    def test_preflight_lint_advisory_never_blocks(
        self, register, port_storage, capsys, monkeypatch
    ):
        monkeypatch.setenv("PIO_PREFLIGHT_LINT", "1")
        name = register("_torch_tiny", _engine())
        assert cli_main(["train", "--engine", name, "--device", "cpu"]) == 0
        out = capsys.readouterr()
        assert "Training completed" in out.out
        assert "pre-flight lint (advisory):" in out.err
        assert "file(s); run `pio check` for details [cache:" in out.err
