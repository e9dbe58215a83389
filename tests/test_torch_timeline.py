"""The port's cross-process trace assembly (``obs/timeline.py``) and its
``trace`` verb held to the JAX package's, on the CPU.

The cases of the JAX package's ``tests/test_disttrace.py`` for the
assembler run on both packages (``pkg`` is ``jax`` or ``port``): the clock
alignment, the cross-process tree with orphans and duplicates, the text,
dict and Chrome trace-event renders, fragment files and the collector that
tolerates dead sources, and the ``trace`` verb (text, JSON, Perfetto, an
unknown trace, ``--from`` a live server).  Then, exact across the
packages: the same fragment sets (the in-file sets and the recorded
``tests/fixtures/disttrace/fragments.json``) give the same ``to_dict()``,
text and Chrome trace, and a set the other package's server recorded
assembles the same way.  Every server binds port 0.
"""

from __future__ import annotations

import contextlib
import io
import json
import types
from pathlib import Path

import pytest
import torch

from predictionio_tpu.obs import disttrace as j_disttrace
from predictionio_tpu.obs import http as j_http
from predictionio_tpu.obs import logging as j_logging
from predictionio_tpu.obs import metrics as j_metrics
from predictionio_tpu.obs import timeline as j_timeline
from predictionio_tpu.obs import tracing as j_tracing
from predictionio_tpu.server import httpd as j_httpd
from predictionio_tpu.tools import cli as j_cli
from predictionio_tpu_torch.obs import disttrace as p_disttrace
from predictionio_tpu_torch.obs import http as p_http
from predictionio_tpu_torch.obs import logging as p_logging
from predictionio_tpu_torch.obs import metrics as p_metrics
from predictionio_tpu_torch.obs import timeline as p_timeline
from predictionio_tpu_torch.obs import tracing as p_tracing
from predictionio_tpu_torch.server import httpd as p_httpd
from predictionio_tpu_torch.tools import cli as p_cli

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "disttrace" / "fragments.json"

PKGS = {
    "jax": types.SimpleNamespace(
        timeline=j_timeline, disttrace=j_disttrace, http=j_http,
        logging=j_logging, metrics=j_metrics, tracing=j_tracing,
        httpd=j_httpd, cli=j_cli,
    ),
    "port": types.SimpleNamespace(
        timeline=p_timeline, disttrace=p_disttrace, http=p_http,
        logging=p_logging, metrics=p_metrics, tracing=p_tracing,
        httpd=p_httpd, cli=p_cli,
    ),
}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _isolate_trace_globals():
    for p in PKGS.values():
        p.disttrace.FRAGMENTS.clear()
        p.tracing.clear_traces()
    yield
    for p in PKGS.values():
        p.disttrace.FRAGMENTS.clear()
        p.tracing.clear_traces()


def _bodies():
    return [
        {
            "process": "front:1", "_offset_s": 0.0, "_source": "front",
            "spans": [
                {"trace_id": "t", "span_id": "r", "name": "http.front",
                 "start_ts": 100.0, "duration_s": 0.1, "request_id": "rid"},
                {"trace_id": "t", "span_id": "s", "parent_id": "r",
                 "name": "storage.remote", "start_ts": 100.01,
                 "duration_s": 0.05},
                {"trace_id": "t", "span_id": "d", "parent_id": "r",
                 "name": "wave.compute", "start_ts": 100.02,
                 "duration_s": 0.03, "track": "device:cuda:0",
                 "tags": {"stage": "compute"}},
                {"trace_id": "other", "span_id": "x", "name": "noise",
                 "start_ts": 1.0, "duration_s": 1.0},
            ],
        },
        {
            "process": "daemon:2", "_offset_s": 0.0, "_source": "daemon",
            "spans": [
                {"trace_id": "t", "span_id": "k", "parent_id": "s",
                 "name": "http.storage", "start_ts": 100.02,
                 "duration_s": 0.03},
            ],
        },
    ]


def _fragment_file(tmp_path) -> str:
    p = tmp_path / "frags.json"
    p.write_text(json.dumps(
        [{k: v for k, v in b.items() if not k.startswith("_")} for b in _bodies()]
    ))
    return str(p)


def _run_cli(pkg, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pkg.cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# clock alignment and assembly, on both packages


def test_midpoint_offset_applied_to_start_ts(pkg):
    tlm = pkg.timeline
    assert tlm.estimate_offset(105.0, 99.0, 101.0) == pytest.approx(5.0)
    tl = tlm.assemble([
        {"process": "a:1", "_offset_s": 0.0, "_source": "a", "spans": [
            {"trace_id": "t", "span_id": "r", "name": "root", "start_ts": 10.0,
             "duration_s": 1.0}]},
        {"process": "b:2", "_offset_s": 5.0, "_source": "b", "spans": [
            {"trace_id": "t", "span_id": "c", "parent_id": "r", "name": "child",
             "start_ts": 15.2, "duration_s": 0.5}]},
    ], "t")
    assert tl.nodes["c"].start_s - tl.t0 == pytest.approx(0.2)
    assert tl.offsets["b"] == 5.0


def test_cross_process_tree_orphans_and_duplicates(pkg):
    tlm = pkg.timeline
    tl = tlm.assemble(_bodies(), "t")
    assert tl.processes == ["front:1", "daemon:2"] and tl.span_count == 4
    (root,) = tl.roots
    storage = next(c for c in root.children if c.name == "storage.remote")
    assert [c.name for c in storage.children] == ["http.storage"]
    assert [n.name for n in tl.device_events()] == ["wave.compute"]
    (orphan,) = tlm.assemble(_bodies()[1:], "t").roots
    assert orphan.name == "http.storage" and orphan.orphan
    doubled = _bodies()
    doubled.append(dict(doubled[0]))
    assert tlm.assemble(doubled, "t").span_count == 4
    with pytest.raises(tlm.TraceAssemblyError):
        tlm.assemble(_bodies(), "unknown-trace")


def test_text_and_dict_renders(pkg):
    tl = pkg.timeline.assemble(_bodies(), "t")
    txt = tl.render_text()
    assert "trace t — 2 process(es), 4 span(s)" in txt
    assert "~wave.compute" in txt and "http.storage" in txt
    assert "orphaned" in pkg.timeline.assemble(_bodies()[1:], "t").render_text()
    d = tl.to_dict()
    assert d["trace_id"] == "t" and d["spans"][0]["start_s"] == 0.0
    assert d["span_count"] == 4


def test_chrome_trace_shape(pkg):
    ct = pkg.timeline.assemble(_bodies(), "t").to_chrome_trace()
    events = ct["traceEvents"]
    procs = {e["args"]["name"]: e["pid"] for e in events
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert set(procs) == {"front:1", "daemon:2"}
    threads = {(e["pid"], e["args"]["name"]) for e in events
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert (procs["front:1"], "device:cuda:0") in threads
    assert (procs["daemon:2"], "spans") in threads
    by_name = {e["name"]: e for e in events if e["ph"] == "X"}
    assert len(by_name) == 4
    assert by_name["wave.compute"]["cat"] == "device"
    assert by_name["http.front"]["ts"] == 0.0
    assert by_name["http.front"]["dur"] == pytest.approx(0.1 * 1e6)
    assert by_name["wave.compute"]["args"]["stage"] == "compute"


def test_fragment_files_and_a_dead_source(pkg, tmp_path):
    tlm = pkg.timeline
    body = _bodies()[0]
    p1 = tmp_path / "body.json"
    p1.write_text(json.dumps({k: v for k, v in body.items() if not k.startswith("_")}))
    (loaded,) = tlm.load_fragment_file(str(p1))
    assert loaded["_offset_s"] == 0.0 and loaded["_source"] == str(p1)
    assert len(tlm.load_fragment_file(_fragment_file(tmp_path))) == 2
    p3 = tmp_path / "bare.json"
    p3.write_text(json.dumps(body["spans"]))
    assert len(tlm.load_fragment_file(str(p3))[0]["spans"]) == 4
    p4 = tmp_path / "bad.json"
    p4.write_text('"nope"')
    with pytest.raises(tlm.TraceAssemblyError):
        tlm.load_fragment_file(str(p4))
    tl = tlm.collect_trace("t", urls=["http://127.0.0.1:2"],
                           files=[_fragment_file(tmp_path)], timeout=0.5)
    assert tl.span_count == 4 and len(tl.source_errors) == 1
    assert "127.0.0.1:2" in tl.source_errors[0]


def test_collect_trace_local_store(pkg):
    tokens = pkg.logging.set_request_context("rid1", "trace1")
    try:
        with pkg.tracing.trace("local.root", registry=pkg.metrics.MetricsRegistry()):
            pass
    finally:
        pkg.logging.reset_request_context(tokens)
    tl = pkg.timeline.collect_trace("trace1", include_local=True)
    assert [r.name for r in tl.roots] == ["local.root"]


# ---------------------------------------------------------------------------
# the trace verb, on both packages


def test_cli_trace_renders(pkg, tmp_path):
    frag = _fragment_file(tmp_path)
    rc, out, _ = _run_cli(pkg, ["trace", "t", "--file", frag])
    assert rc == 0 and "2 process(es)" in out and "http.storage" in out
    rc, out, _ = _run_cli(pkg, ["trace", "t", "--file", frag, "--json"])
    body = json.loads(out)
    assert rc == 0 and body["span_count"] == 4
    assert body["processes"] == ["front:1", "daemon:2"]
    target = tmp_path / "perfetto.json"
    rc, out, _ = _run_cli(pkg, ["trace", "t", "--file", frag, "--perfetto",
                                str(target)])
    assert rc == 0 and "perfetto" in out
    assert any(e["ph"] == "X" for e in json.loads(target.read_text())["traceEvents"])
    rc, _, err = _run_cli(pkg, ["trace", "nope", "--file", frag])
    assert rc == 1 and "failed" in err


def test_cli_trace_from_a_live_server(pkg):
    app = pkg.http.add_observability_routes(pkg.httpd.HTTPApp("clitest"))
    tokens = pkg.logging.set_request_context("rid1", "trace1")
    try:
        with pkg.tracing.trace("cli.root", registry=pkg.metrics.MetricsRegistry()):
            pass
    finally:
        pkg.logging.reset_request_context(tokens)
    server = pkg.httpd.AppServer(app, "127.0.0.1", 0).start_background()
    try:
        rc, out, _ = _run_cli(pkg, ["trace", "trace1", "--from",
                                    f"http://127.0.0.1:{server.port}", "--json"])
    finally:
        server.shutdown()
    body = json.loads(out)
    assert rc == 0 and body["spans"][0]["name"] == "cli.root"
    assert body["clock_offsets_s"]


# ---------------------------------------------------------------------------
# cross-package: the same fragments, the same timeline


def _renders(tlm, bodies, trace_id):
    tl = tlm.assemble(bodies, trace_id)
    return tl.to_dict(), tl.render_text(), tl.to_chrome_trace()


@pytest.mark.parametrize("case", ["full", "orphaned", "offset"])
def test_same_fragments_same_timeline(case):
    bodies = _bodies()
    if case == "orphaned":
        bodies = bodies[1:]
    elif case == "offset":
        bodies[1]["_offset_s"] = 0.0125
    got = {name: _renders(p.timeline, json.loads(json.dumps(bodies)), "t")
           for name, p in PKGS.items()}
    assert got["port"] == got["jax"]


def test_the_recorded_fixture_assembles_identically():
    data = json.loads(FIXTURE.read_text())
    bodies = data if isinstance(data, list) else [data]
    trace_ids = sorted({
        f.get("trace_id") for b in bodies for f in b.get("spans") or ()
        if f.get("trace_id")})
    assert trace_ids
    for tid in trace_ids:
        got = {name: _renders(p.timeline, p.timeline.load_fragment_file(str(FIXTURE)), tid)
               for name, p in PKGS.items()}
        assert got["port"] == got["jax"], tid
    outs = {name: _run_cli(p, ["trace", trace_ids[0], "--file", str(FIXTURE)])
            for name, p in PKGS.items()}
    assert outs["port"] == outs["jax"] and outs["port"][0] == 0


def test_a_fragment_set_recorded_by_either_server_assembles_the_same():
    """Each package's server records one traced span; fetched from both
    servers, the two sets assemble into one timeline through either
    package's assembler, the same apart from the live clock offsets."""
    servers, urls = [], []
    try:
        for name, p in PKGS.items():
            app = p.http.add_observability_routes(p.httpd.HTTPApp(f"rec-{name}"))
            tokens = p.logging.set_request_context(f"rid-{name}", "xtrace")
            try:
                with p.tracing.trace(f"{name}.root",
                                     registry=p.metrics.MetricsRegistry()):
                    pass
            finally:
                p.logging.reset_request_context(tokens)
            s = p.httpd.AppServer(app, "127.0.0.1", 0).start_background()
            servers.append(s)
            urls.append(f"http://127.0.0.1:{s.port}")
        bodies = [j_timeline.fetch_spans(u, "xtrace") for u in urls]
        for b in bodies:
            b["_offset_s"] = 0.0
    finally:
        for s in servers:
            s.shutdown()
    got = {name: _renders(p.timeline, json.loads(json.dumps(bodies)), "xtrace")
           for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    assert {s["name"] for s in got["port"][0]["spans"]} == {"jax.root", "port.root"}
