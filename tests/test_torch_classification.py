"""The port's classification template against the JAX package's, on the CPU.

- ``tests/test_templates.py::TestClassification``'s fixture (60 users with
  ``$set`` attr0-2 and ``plan``) trained by both packages: the same labels
  for every query, for ``naive`` and ``logreg``; the persistence round
  trip; the evaluation sweep.
- Blobs cross-loaded both ways: a JAX-trained instance deploys on the port
  (in a fresh subprocess that imports no JAX), and a port-trained one
  deploys on the JAX package, with equal answers.
- ``pio eval`` of ``models.classification.evaluation:evaluation`` on both
  CLIs: the same best params, accuracy within 1e-6.
- ``pio template list|get``: the same output and the same ``engine.json``
  as the JAX CLI; neither overwrites.
- Without a card the template's train, deploy and eval raise
  ``DeviceUnavailable`` unless asked for the CPU; the aio deploy answers
  over HTTP as the JAX template does.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core import workflow as jax_workflow
from predictionio_tpu.core.workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.eval.evaluator import MetricEvaluator as JaxMetricEvaluator
from predictionio_tpu.models import classification as jax_clsm
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.workflow import run_evaluation, run_train
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.eval.evaluator import MetricEvaluator
from predictionio_tpu_torch.models import classification as pt_clsm
from predictionio_tpu_torch.server.prediction_server import (
    create_prediction_server,
    deploy_engine,
)
from predictionio_tpu_torch.tools import cli as pt_cli
from predictionio_tpu_torch.tools import commands as pt_cmd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: a grid of queries around both class centres and between them
QUERIES = [
    (8.0, 1.0, 1.0), (1.0, 1.0, 8.0), (7.0, 1.0, 2.0), (4.0, 1.0, 4.0),
    (4.5, 1.0, 3.5), (3.0, 2.0, 5.0), (0.5, 0.5, 0.5), (6.0, 3.0, 6.5),
]


@pytest.fixture()
def homes(tmp_path, monkeypatch):
    """Both packages' storage over one PIO_HOME holding the ``cls`` app:
    ``tests/test_templates.py``'s classification fixture."""
    env = {"PIO_HOME": str(tmp_path / "pio_home")}
    monkeypatch.setenv("PIO_HOME", env["PIO_HOME"])
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    storage = StorageRuntime(StorageConfig.from_env(env))
    d = pt_cmd.app_new(storage, "cls")
    rng = np.random.default_rng(11)
    events = []
    for n in range(60):
        label = float(n % 2)
        center = np.array([8.0, 1.0, 1.0]) if label else np.array([1.0, 1.0, 8.0])
        attrs = np.clip(rng.normal(center, 0.5), 0.1, None)
        events.append(Event(
            event="$set", entity_type="user", entity_id=f"u{n}",
            properties=DataMap({"plan": label, "attr0": float(attrs[0]),
                                "attr1": float(attrs[1]),
                                "attr2": float(attrs[2])}),
        ))
    storage.l_events().insert_batch(events, d.app.id)
    yield {"jax": jax_storage, "port": storage, "home": env["PIO_HOME"]}
    storage.close()
    jax_storage.close()


def _variant(algo, params=None):
    return {
        "datasource": {"params": {"appName": "cls"}},
        "algorithms": [{"name": algo, "params": params or {}}],
    }


def _train_both(homes, algo, params=None):
    jeng = jax_clsm.classification_engine()
    jp = jeng.params_from_json(_variant(algo, params))
    _, _, jalgos, _ = jeng.instantiate(jp)
    jmodel = jeng.train(JaxEngineContext(storage=homes["jax"]), jp)[0]
    peng = pt_clsm.classification_engine()
    pp = peng.params_from_json(_variant(algo, params))
    _, _, palgos, _ = peng.instantiate(pp)
    pmodel = peng.train(EngineContext(storage=homes["port"], device="cpu"), pp)[0]
    return (jalgos[0], jmodel), (palgos[0], pmodel)


@pytest.mark.parametrize("algo", ["naive", "logreg"])
def test_answers_equal_the_jax_template(homes, algo):
    (ja, jm), (pa, pm) = _train_both(homes, algo)
    for q in QUERIES:
        want = ja.predict(jm, jax_clsm.Query(*q)).label
        assert pa.predict(pm, pt_clsm.Query(*q)).label == want, q
    got = pa.batch_predict(pm, [(i, pt_clsm.Query(*q)) for i, q in enumerate(QUERIES)])
    want = ja.batch_predict(jm, [(i, jax_clsm.Query(*q)) for i, q in enumerate(QUERIES)])
    assert [(i, p.label) for i, p in got] == [(i, p.label) for i, p in want]
    # the template's own separation checks
    assert pa.predict(pm, pt_clsm.Query(8.0, 1.0, 1.0)).label == 1.0
    assert pa.predict(pm, pt_clsm.Query(1.0, 1.0, 8.0)).label == 0.0
    if algo == "naive":
        np.testing.assert_allclose(pm.pi.numpy(), np.asarray(jm.pi), atol=1e-6)
        np.testing.assert_allclose(pm.theta.numpy(), np.asarray(jm.theta),
                                   atol=1e-6)
    else:
        jw = np.asarray(jm.w)
        assert np.abs(pm.w.numpy() - jw).max() <= 1e-4 * np.abs(jw).max()
    assert np.array_equal(pm.labels, np.asarray(jm.labels))


def test_persistence_roundtrip_keeps_the_jax_layout(homes):
    ctx = EngineContext(storage=homes["port"], device="cpu")
    jctx = JaxEngineContext(storage=homes["jax"])
    for name, keys in (("naive", ["labels", "pi", "theta"]),
                       ("logreg", ["b", "labels", "w"])):
        (ja, jm), (pa, pm) = _train_both(homes, name)
        blob = pa.make_persistent_model(ctx, pm)
        jblob = ja.make_persistent_model(jctx, jm)
        assert sorted(blob) == sorted(jblob) == keys
        for k in keys:
            assert type(blob[k]) is np.ndarray and blob[k].dtype == jblob[k].dtype
            assert blob[k].shape == jblob[k].shape
        loaded = pa.load_persistent_model(ctx, blob)
        for q in QUERIES:
            assert (pa.predict(pm, pt_clsm.Query(*q)).label
                    == pa.predict(loaded, pt_clsm.Query(*q)).label)


def test_evaluation_sweep_equals_the_jax_package(homes):
    plist = pt_clsm.engine_params_list(app_name="cls", eval_k=3, lams=(1.0, 100.0))
    result = run_evaluation(
        pt_clsm.classification_engine(), plist,
        MetricEvaluator(pt_clsm.Accuracy()),
        ctx=EngineContext(storage=homes["port"], mode="eval", device="cpu"),
        storage=homes["port"],
    )
    jresult = jax_run_evaluation(
        jax_clsm.classification_engine(),
        jax_clsm.engine_params_list(app_name="cls", eval_k=3, lams=(1.0, 100.0)),
        JaxMetricEvaluator(jax_clsm.Accuracy()),
        ctx=JaxEngineContext(storage=homes["jax"], mode="eval"),
        storage=homes["jax"],
    )
    assert len(result.records) == 2
    assert result.best.score > 0.8
    assert abs(result.best.score - jresult.best.score) <= 1e-6
    assert [r.score for r in result.records] == pytest.approx(
        [r.score for r in jresult.records], abs=1e-6)
    done = homes["port"].evaluation_instances().get_completed()
    assert len(done) == 2 and all("Accuracy" in d.evaluator_results for d in done)


PORT_DEPLOY = """
import json, sys, torch
torch.set_num_threads(2)
from predictionio_tpu_torch.server.prediction_server import deploy_engine
dep = deploy_engine("classification", engine_instance_id=%r, device="cpu")
print(json.dumps({
    "labels": [dep.predict(dep.extract_query(
        {"attr0": a, "attr1": b, "attr2": c}))[1].label for a, b, c in %r],
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu")),
}))
"""


def _subprocess(code: str, home: str) -> dict:
    env = {**os.environ, "PIO_HOME": home, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("algo", ["naive", "logreg"])
def test_jax_blob_deploys_on_the_port_without_jax(homes, algo):
    jeng = jax_clsm.classification_engine()
    inst = jax_run_train(
        jeng, jeng.params_from_json(_variant(algo)),
        ctx=JaxEngineContext(storage=homes["jax"]), storage=homes["jax"],
        engine_factory="classification",
    )
    out = _subprocess(PORT_DEPLOY % (inst.id, QUERIES), homes["home"])
    assert out["loaded"] == []
    jdep = jax_server.deploy_engine(
        "classification", storage=homes["jax"], engine_instance_id=inst.id)
    want = [jdep.predict(jdep.extract_query(
        {"attr0": a, "attr1": b, "attr2": c}))[1].label for a, b, c in QUERIES]
    assert out["labels"] == want


@pytest.mark.parametrize("algo", ["naive", "logreg"])
def test_port_blob_deploys_on_the_jax_package(homes, algo):
    peng = pt_clsm.classification_engine()
    inst = run_train(
        peng, peng.params_from_json(_variant(algo)),
        ctx=EngineContext(storage=homes["port"], device="cpu"),
        storage=homes["port"], engine_factory="classification",
    )
    jdep = jax_server.deploy_engine(
        "classification", storage=homes["jax"], engine_instance_id=inst.id)
    pdep = deploy_engine("classification", storage=homes["port"],
                         engine_instance_id=inst.id, device="cpu")
    for a, b, c in QUERIES:
        q = {"attr0": a, "attr1": b, "attr2": c}
        assert (jdep.predict(jdep.extract_query(q))[1].label
                == pdep.predict(pdep.extract_query(q))[1].label)


def _cli(main, argv) -> tuple[int, list[str]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_pio_eval_equals_the_jax_cli(homes, monkeypatch):
    monkeypatch.setattr(pt_cli, "get_storage", lambda: homes["port"])
    monkeypatch.setattr(jax_cli, "get_storage", lambda: homes["jax"])
    monkeypatch.setattr(jax_workflow, "get_storage", lambda: homes["jax"])
    params = ["--params", json.dumps({"app_name": "cls"})]
    rc_j, want = _cli(jax_cli.main, [
        "eval", "predictionio_tpu.models.classification.evaluation:evaluation",
    ] + params)
    path = "predictionio_tpu_torch.models.classification.evaluation:evaluation"
    rc_p, got = _cli(pt_cli.main, ["eval", path] + params + ["--device", "cpu"])
    assert rc_j == rc_p == 0
    assert got[0].startswith("[Accuracy] best score:")
    rows = {r.evaluation_class: json.loads(r.evaluator_results_json)
            for r in homes["port"].evaluation_instances().get_completed()}
    jbody = rows["predictionio_tpu.models.classification.evaluation:evaluation"]
    pbody = rows[path]
    assert pbody["bestIdx"] == jbody["bestIdx"]
    best = pbody["records"][pbody["bestIdx"]]["engineParams"]
    assert best == jbody["records"][jbody["bestIdx"]]["engineParams"]
    assert best["algorithms"][0]["naive"]["lam"] in (10.0, 100.0, 1000.0)
    # the printed lines too (accuracy is a count ratio of equal answers)
    assert got == want
    assert abs(pbody["bestScore"] - jbody["bestScore"]) <= 1e-6
    assert len(pbody["records"]) == len(jbody["records"]) == 3
    for pr, jr in zip(pbody["records"], jbody["records"]):
        assert pr["engineParams"] == jr["engineParams"]
        assert abs(pr["score"] - jr["score"]) <= 1e-6


def test_train_deploy_and_eval_need_a_card_unless_asked(homes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = pt_clsm.classification_engine()
    with pytest.raises(device_mod.DeviceUnavailable):
        run_train(engine, engine.params_from_json(_variant("naive")),
                  storage=homes["port"], engine_factory="classification")
    inst = run_train(
        engine, engine.params_from_json(_variant("naive")),
        ctx=EngineContext(storage=homes["port"], device="cpu"),
        storage=homes["port"], engine_factory="classification")
    with pytest.raises(device_mod.DeviceUnavailable):
        deploy_engine("classification", storage=homes["port"],
                      engine_instance_id=inst.id)
    with pytest.raises(device_mod.DeviceUnavailable):
        run_evaluation(engine, pt_clsm.engine_params_list("cls", eval_k=2),
                       MetricEvaluator(pt_clsm.Accuracy()),
                       storage=homes["port"])
    monkeypatch.setattr(pt_cli, "get_storage", lambda: homes["port"])
    variant = Path(homes["home"]) / "engine.json"
    variant.write_text(json.dumps(
        {"engineFactory": "classification", **_variant("naive")}))
    for argv in (["train", "--engine-json", str(variant)],
                 ["eval", "predictionio_tpu_torch.models.classification."
                  "evaluation:evaluation", "--params", '{"app_name": "cls"}'],
                 ["deploy", "--engine", "classification", "--port", "0"]):
        with pytest.raises(device_mod.DeviceUnavailable):
            pt_cli.main(argv)


def _post(port: int, body: dict):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_deploy_answers_over_http_as_the_jax_template(homes):
    engine = pt_clsm.classification_engine()
    run_train(engine, engine.params_from_json(_variant("naive")),
              ctx=EngineContext(storage=homes["port"], device="cpu"),
              storage=homes["port"], engine_factory="classification")
    jdep = jax_server.deploy_engine("classification", storage=homes["jax"])
    for kind in ("aio", "threaded"):
        server = create_prediction_server(
            "classification", host="127.0.0.1", port=0, storage=homes["port"],
            server_kind=kind, device="cpu").start_background()
        try:
            for a, b, c in QUERIES:
                q = {"attr0": a, "attr1": b, "attr2": c}
                status, body = _post(server.port, q)
                assert status == 200
                assert body == {"label": jdep.predict(jdep.extract_query(q))[1].label}
        finally:
            server.shutdown()


def _bundled_only(monkeypatch, registry, package):
    """The registry narrowed to the templates the package bundles (other
    tests of the process register engines of their own)."""
    import predictionio_tpu.models  # noqa: F401
    import predictionio_tpu_torch.models  # noqa: F401

    monkeypatch.setattr(registry, "_entries", {
        name: fn for name, fn in registry._entries.items()
        if fn.__module__.startswith(package + ".models.")
    })


def test_pio_template_list_and_get_equal_the_jax_cli(tmp_path, monkeypatch):
    from predictionio_tpu.core.engine import engine_registry as jax_registry
    from predictionio_tpu_torch.core.engine import engine_registry

    _bundled_only(monkeypatch, jax_registry, "predictionio_tpu")
    _bundled_only(monkeypatch, engine_registry, "predictionio_tpu_torch")
    rc_j, want = _cli(jax_cli.main, ["template", "list"])
    rc_p, got = _cli(pt_cli.main, ["template", "list"])
    assert rc_j == rc_p == 0 and got == want
    assert "classification" in json.loads("\n".join(got))["bundled"]
    monkeypatch.chdir(tmp_path)
    for name in sorted(pt_cli._TEMPLATE_VARIANTS):
        rc_j, want = _cli(jax_cli.main, ["template", "get", name, f"j/{name}"])
        rc_p, got = _cli(pt_cli.main, ["template", "get", name, f"p/{name}"])
        assert rc_j == rc_p == 0
        assert got == [f"Wrote p/{name}/engine.json"]
        assert (tmp_path / "p" / name / "engine.json").read_bytes() == (
            tmp_path / "j" / name / "engine.json").read_bytes()
    before = (tmp_path / "p" / "ncf" / "engine.json").read_bytes()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert pt_cli.main(["template", "get", "ncf", "p/ncf"]) == 1
    assert "refusing to overwrite" in err.getvalue()
    assert (tmp_path / "p" / "ncf" / "engine.json").read_bytes() == before
    with contextlib.redirect_stderr(io.StringIO()):
        assert pt_cli.main(["template", "get", "nope"]) == 1
