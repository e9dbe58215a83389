"""The port's self-cleaning data source, persistent models and entity map
against the JAX package's.

- ``tests/test_aux.py::TestSelfCleaning``'s four cases on both packages,
  and the two packages' cleaned streams (and cleaned stores) equal.
- A ``PersistentModel`` saved by either package's ``run_train`` deploys on
  the other with the same answers; the port's side runs in a fresh
  subprocess that must import no ``predictionio_tpu`` module.
- ``data/entity_map.py`` answers as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest
import torch

import predictionio_tpu.core.base as jax_base
import predictionio_tpu.core.self_cleaning as jax_sc
import predictionio_tpu.data.datamap as jax_datamap
import predictionio_tpu.data.entity_map as jax_entity_map
import predictionio_tpu.data.event as jax_event
import predictionio_tpu.tools.commands as jax_cmd
import predictionio_tpu_torch.core.base as pt_base
import predictionio_tpu_torch.core.self_cleaning as pt_sc
import predictionio_tpu_torch.data.datamap as pt_datamap
import predictionio_tpu_torch.data.entity_map as pt_entity_map
import predictionio_tpu_torch.data.event as pt_event
import predictionio_tpu_torch.tools.commands as pt_cmd
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

#: (self_cleaning, Event, DataMap, commands, StorageRuntime, StorageConfig,
#: context kwargs) of each package
PKGS = {
    "jax": (jax_sc, jax_event.Event, jax_datamap.DataMap, jax_cmd,
            JaxStorageRuntime, JaxStorageConfig, jax_base.EngineContext, {}),
    "torch": (pt_sc, pt_event.Event, pt_datamap.DataMap, pt_cmd,
              StorageRuntime, StorageConfig, pt_base.EngineContext,
              {"device": "cpu"}),
}

NOW = datetime.now(tz=timezone.utc)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _ev(pkg, event, eid, props=None, days_ago=0.0, event_id=None):
    _, Event, DataMap, *_ = pkg
    return Event(
        event=event, entity_type="user", entity_id=eid,
        properties=DataMap(props or {}),
        event_time=NOW - timedelta(days=days_ago), event_id=event_id,
    )


def _source(pkg, app_name, window):
    sc = pkg[0]

    class CleaningSource(sc.SelfCleaningDataSource):
        @property
        def event_window(self):
            return window

    src = CleaningSource()
    src.app_name = app_name
    return src


def test_ttl_filter(pkg):
    sc = pkg[0]
    src = _source(pkg, "x", sc.EventWindow(duration_seconds=7 * 86400))
    cleaned = src.cleaned_events([
        _ev(pkg, "view", "u1", days_ago=1),
        _ev(pkg, "view", "u1", days_ago=30),
        _ev(pkg, "$set", "u1", {"a": 1}, days_ago=30),
    ])
    assert len(cleaned) == 2
    assert {e.event for e in cleaned} == {"view", "$set"}


def test_compress_set_chain(pkg):
    sc = pkg[0]
    src = _source(pkg, "x", sc.EventWindow(compress_properties=True))
    cleaned = src.cleaned_events([
        _ev(pkg, "$set", "u1", {"a": 1, "b": 1}, days_ago=3),
        _ev(pkg, "$set", "u1", {"b": 2}, days_ago=2),
        _ev(pkg, "$unset", "u1", {"a": 1}, days_ago=1),
        _ev(pkg, "view", "u1"),
    ])
    sets = [e for e in cleaned if e.event == "$set"]
    assert len(sets) == 1
    assert sets[0].properties.fields == {"a": 1, "b": 2}
    assert len([e for e in cleaned if e.event == "$unset"]) == 1
    assert len([e for e in cleaned if e.event == "view"]) == 1


def test_dedup(pkg):
    sc = pkg[0]
    src = _source(pkg, "x", sc.EventWindow(remove_duplicates=True))
    e1 = _ev(pkg, "view", "u1", days_ago=1)
    assert len(src.cleaned_events([e1, dataclasses.replace(e1, event_id="other")])) == 1


def _clean_store(pkg, home):
    sc, _, _, cmd, Runtime, Config, Context, ctx_kw = pkg
    storage = Runtime(Config.from_env({"PIO_HOME": str(home)}))
    try:
        d = cmd.app_new(storage, "cleanapp")
        levents = storage.l_events()
        for i, e in enumerate([
            _ev(pkg, "$set", "u1", {"a": 1}, days_ago=30),
            _ev(pkg, "$set", "u1", {"b": 2}, days_ago=20),
            _ev(pkg, "view", "u1", days_ago=1),
            _ev(pkg, "view", "u1", days_ago=30),
            _ev(pkg, "$set", "u2", {"c": [1, 2]}, days_ago=10),
            _ev(pkg, "view", "u2", days_ago=2),
            _ev(pkg, "view", "u2", days_ago=2.5),
        ]):
            levents.insert(dataclasses.replace(e, event_id=f"e{i}"), d.app.id)
        src = _source(pkg, "cleanapp", sc.EventWindow(
            duration_seconds=7 * 86400, compress_properties=True,
            remove_duplicates=True))
        removed = src.clean_persisted_events(Context(storage=storage, **ctx_kw))
        remaining = sorted(
            (e.event_id, e.event, e.entity_id, e.properties.fields)
            for e in levents.find(d.app.id)
        )
        return removed, remaining
    finally:
        storage.close()


def test_clean_persisted_events(pkg, tmp_path):
    removed, remaining = _clean_store(pkg, tmp_path / "h")
    assert removed >= 2
    sets = {eid: props for _, ev, eid, props in remaining if ev == "$set"}
    assert sets == {"u1": {"a": 1, "b": 2}, "u2": {"c": [1, 2]}}
    assert [r[0] for r in remaining if r[1] == "view" and r[2] == "u1"] == ["e2"]


def test_cleaned_stores_equal_the_jax_package(tmp_path):
    assert _clean_store(PKGS["torch"], tmp_path / "p") == _clean_store(
        PKGS["jax"], tmp_path / "j")


def test_cleaned_streams_equal_the_jax_package():
    out = {}
    for name, pkg in PKGS.items():
        sc = pkg[0]
        src = _source(pkg, "x", sc.EventWindow(
            duration_seconds=5 * 86400, compress_properties=True,
            remove_duplicates=True))
        events = [
            _ev(pkg, "$set", "u1", {"a": 1, "b": 1}, 9, "s1"),
            _ev(pkg, "$set", "u1", {"b": 3}, 8, "s2"),
            _ev(pkg, "$set", "u2", {"z": "q"}, 1, "s3"),
            _ev(pkg, "view", "u1", None, 1, "v1"),
            _ev(pkg, "view", "u1", None, 1, "v2"),
            _ev(pkg, "buy", "u2", {"n": 2}, 6, "b1"),
        ]
        # an identical pair (same time and fields, other ids) for the dedup
        events.append(dataclasses.replace(events[3], event_id="v1b"))
        out[name] = [
            (e.event_id, e.event, e.entity_id, e.properties.fields, e.event_time)
            for e in src.cleaned_events(events)
        ]
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# PersistentModel across the packages
# ---------------------------------------------------------------------------

#: a user's engine with a self-persisting model, written against the
#: package named by PM_PKG (a model class belongs to the framework that
#: runs it)
PMSTUB = '''
import importlib
import os
from dataclasses import dataclass

PKG = os.environ["PM_PKG"]
base = importlib.import_module(PKG + ".core.base")
engine = importlib.import_module(PKG + ".core.engine")
pm = importlib.import_module(PKG + ".core.persistent_model")


class ScaleModel(pm.LocalFileSystemPersistentModel):
    def __init__(self, scale, table):
        self.scale = scale
        self.table = table


@dataclass(frozen=True)
class Params:
    scale: float = 2.0


class DS(base.DataSource):
    def __init__(self, params=None):
        pass

    def read_training(self, ctx):
        return {"rows": 3}


class Algo(base.Algorithm):
    params_class = Params

    def __init__(self, params=None):
        self.params = params or Params()

    def train(self, ctx, pd):
        return ScaleModel(self.params.scale, {"a": 1.5, "b": -2.0})

    def predict(self, model, query):
        return {"y": query["x"] * model.scale + model.table[query["k"]]}


def factory():
    return engine.Engine(DS, base.IdentityPreparator, {"pm": Algo},
                         base.FirstServing)
'''

PORT_SIDE = """
import json, sys
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import EngineParams
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.server.prediction_server import deploy_engine
import pmstub
out = {}
if %r == "train":
    eng = pmstub.factory()
    inst = run_train(eng, EngineParams(algorithms=(("pm", pmstub.Params(scale=3.0)),)),
                     ctx=EngineContext(device="cpu"), engine_factory="pmstub:factory")
    out["instance"] = inst.id
else:
    dep = deploy_engine("", engine_instance_id=%r, device="cpu")
    out["answers"] = [dep.predict(dep.extract_query({"x": x, "k": k}))[1]["y"]
                      for x, k in [(1.0, "a"), (2.5, "b"), (-4.0, "a")]]
    out["model"] = type(dep.models[0]).__module__
out["loaded"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu"))
print(json.dumps(out))
"""


@pytest.fixture()
def pm_home(tmp_path, monkeypatch):
    stub_dir = tmp_path / "stub"
    stub_dir.mkdir()
    (stub_dir / "pmstub.py").write_text(PMSTUB)
    home = tmp_path / "pio_home"
    monkeypatch.setenv("PIO_HOME", str(home))
    monkeypatch.setenv("PM_PKG", "predictionio_tpu")
    monkeypatch.syspath_prepend(str(stub_dir))
    sys.modules.pop("pmstub", None)
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    yield {"home": str(home), "stub": str(stub_dir), "jax": jax_storage}
    jax_storage.close()
    sys.modules.pop("pmstub", None)


def _port_side(pm_home, mode, instance_id=None) -> dict:
    env = {**os.environ, "PIO_HOME": pm_home["home"], "PM_PKG": "predictionio_tpu_torch",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", PORT_SIDE % (pm_home["stub"], mode, instance_id)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


QUERIES = [(1.0, "a"), (2.5, "b"), (-4.0, "a")]


def test_jax_saved_persistent_model_deploys_on_the_port(pm_home):
    from predictionio_tpu.core.engine import EngineParams
    from predictionio_tpu.core.persistence import load_models
    from predictionio_tpu.core.workflow import run_train as jax_run_train
    from predictionio_tpu.server.prediction_server import deploy_engine as jax_deploy

    import pmstub

    inst = jax_run_train(
        pmstub.factory(),
        EngineParams(algorithms=(("pm", pmstub.Params(scale=3.0)),)),
        ctx=jax_base.EngineContext(storage=pm_home["jax"]),
        storage=pm_home["jax"], engine_factory="pmstub:factory",
    )
    [stored] = load_models(pm_home["jax"].models(), inst.id)
    assert type(stored).__name__ == "PersistentModelManifest"
    assert stored.class_path == "pmstub:ScaleModel"
    assert (Path(pm_home["home"]) / "pmodels" / f"{inst.id}-ScaleModel.pkl").exists()
    out = _port_side(pm_home, "deploy", inst.id)
    assert out["loaded"] == [] and out["model"] == "pmstub"
    jdep = jax_deploy("", storage=pm_home["jax"], engine_instance_id=inst.id)
    assert out["answers"] == [
        jdep.predict(jdep.extract_query({"x": x, "k": k}))[1]["y"] for x, k in QUERIES
    ] == [3.0 * x + {"a": 1.5, "b": -2.0}[k] for x, k in QUERIES]


def test_port_saved_persistent_model_deploys_on_the_jax_package(pm_home):
    from predictionio_tpu.core.persistence import load_models
    from predictionio_tpu.server.prediction_server import deploy_engine as jax_deploy

    out = _port_side(pm_home, "train")
    assert out["loaded"] == []
    [stored] = load_models(pm_home["jax"].models(), out["instance"])
    assert type(stored).__module__ == "predictionio_tpu.core.persistent_model"
    assert stored.class_path == "pmstub:ScaleModel"
    jdep = jax_deploy("", storage=pm_home["jax"], engine_instance_id=out["instance"])
    assert [jdep.predict(jdep.extract_query({"x": x, "k": k}))[1]["y"]
            for x, k in QUERIES] == [3.0 * x + {"a": 1.5, "b": -2.0}[k]
                                     for x, k in QUERIES]
    # and the port deploys its own save
    back = _port_side(pm_home, "deploy", out["instance"])
    assert back["answers"] == [3.0 * x + {"a": 1.5, "b": -2.0}[k] for x, k in QUERIES]


def test_manifest_without_instance_id_is_refused():
    from predictionio_tpu_torch.core.engine import Engine, EngineParams
    from predictionio_tpu_torch.core.persistent_model import PersistentModelManifest

    class A(pt_base.Algorithm):
        def train(self, ctx, pd):
            return None

        def predict(self, model, query):
            return None

    eng = Engine(pt_base.IdentityPreparator, pt_base.IdentityPreparator, A,
                 pt_base.FirstServing)
    with pytest.raises(ValueError, match="instance id"):
        eng.prepare_deploy(
            pt_base.EngineContext(device="cpu"), EngineParams(algorithms=(("", None),)),
            [PersistentModelManifest("x:Y")],
        )


# ---------------------------------------------------------------------------
# entity_map
# ---------------------------------------------------------------------------


def test_entity_map_answers_as_the_jax_package():
    entities = {f"e{i:02d}": {"cat": i % 3, "name": f"n{i}"} for i in (7, 3, 11, 0, 5)}
    jm = jax_entity_map.EntityMap(entities)
    pm_ = pt_entity_map.EntityMap(entities)
    assert list(pm_) == list(jm) == sorted(entities)
    assert len(pm_) == len(jm) == 5
    for eid in entities:
        assert pm_.index_of(eid) == jm.index_of(eid)
        assert pm_[eid] == jm[eid] and eid in pm_
    for i in range(5):
        assert pm_.entity_id_of(i) == jm.entity_id_of(i)
        assert pm_.by_index(i) == jm.by_index(i)
    assert pm_.index_of("missing") is None and "missing" not in pm_
    assert pm_.get("missing", 1) == jm.get("missing", 1) == 1
    assert dict(pm_.items()) == dict(jm.items())
    assert list(pm_.vocab.to_state()) == list(jm.vocab.to_state())
