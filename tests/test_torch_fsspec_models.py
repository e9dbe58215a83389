"""The port's fsspec model store (``TYPE=hdfs``) and model blobs across
the packages, on the CPU.

- Every case of ``tests/test_model_store.py::TestFsspecModels`` on the
  port's ``FsspecModels`` (``file://`` and ``memory://``): round trip and
  delete, the overwrite's atomic rename, the sharded save, the registry's
  ``TYPE=hdfs``.
- A model saved by either package through ``FsspecModels`` or through
  ``RemoteModels`` (a storage daemon of either package) loads in the
  other: the JAX-trained factors answer the port's deploy exactly as the
  JAX deploy answers, and the port-trained factors load in the JAX
  package bit for bit.
- ``train --device cpu`` with MODELDATA on ``TYPE=hdfs``, then a deploy
  from it.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.core.base import EngineContext as JaxEngineContext
from predictionio_tpu.core.engine import resolve_engine_factory as jax_resolve
from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.core.workflow import run_train as jax_run_train
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.models import recommendation as jax_recommendation  # noqa: F401
from predictionio_tpu.models.recommendation import engine as jax_rec
from predictionio_tpu.server import prediction_server as jax_server
from predictionio_tpu.server.storage_server import StorageServer as JaxStorageServer
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import resolve_engine_factory
from predictionio_tpu_torch.core.persistence import load_models, save_models
from predictionio_tpu_torch.core.workflow import run_train
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.fsspec_models import FsspecModels
from predictionio_tpu_torch.models import recommendation  # noqa: F401
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.server.storage_server import StorageServer
from predictionio_tpu_torch.tools import commands as cmd

torch.set_num_threads(2)

N_USERS, N_ITEMS = 20, 12


class TestFsspecModels:
    def _store(self, tmp_path):
        return FsspecModels(f"file://{tmp_path}/models")

    def test_round_trip_and_delete(self, tmp_path):
        store = self._store(tmp_path)
        store.insert("i1", b"blob")
        assert store.get("i1") == b"blob"
        assert store.delete("i1") is True
        assert store.get("i1") is None
        assert store.delete("i1") is False

    def test_overwrite_is_atomic_rename(self, tmp_path):
        store = self._store(tmp_path)
        store.insert("i1", b"v1")
        store.insert("i1", b"v2")
        assert store.get("i1") == b"v2"
        leftovers = [p for p in (tmp_path / "models").iterdir() if ".tmp" in p.name]
        assert leftovers == []

    def test_sharded_save_round_trip(self, tmp_path):
        store = self._store(tmp_path)
        rng = np.random.default_rng(0)
        model = {"user_table": rng.standard_normal((6, 4)).astype(np.float32),
                 "names": np.array(["a", "b"])}
        save_models(store, "inst1", [model])
        [out] = load_models(store, "inst1")
        np.testing.assert_array_equal(out["user_table"], model["user_table"])
        assert store.delete_models("inst1")
        assert load_models(store, "inst1") is None

    def test_memory_scheme(self):
        store = FsspecModels("memory://pio-torch-test-models")
        store.insert("i1", b"x")
        assert store.get("i1") == b"x"
        assert store.delete("i1")

    def test_registry_resolves_type_hdfs(self, tmp_path):
        rt = StorageRuntime(StorageConfig.from_env({
            "PIO_HOME": str(tmp_path / "home"),
            "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "HDFS",
            "PIO_STORAGE_SOURCES_HDFS_TYPE": "hdfs",
            "PIO_STORAGE_SOURCES_HDFS_PATH": f"file://{tmp_path}/hmodels",
        }))
        try:
            store = rt.models()
            assert isinstance(store, FsspecModels)
            store.insert("a", b"1")
            assert store.get("a") == b"1"
        finally:
            rt.close()

    def test_same_object_names_as_the_jax_package(self, tmp_path):
        from predictionio_tpu.data.storage.fsspec_models import (
            FsspecModels as JaxFsspecModels,
        )

        mine = self._store(tmp_path)
        theirs = JaxFsspecModels(f"file://{tmp_path}/models")
        mine.insert_parts("inst/a", b"manifest", {"p0": b"\x00\x01"})
        assert theirs.get_manifest("inst/a") == b"manifest"
        assert theirs.get_part("inst/a", "p0") == b"\x00\x01"
        theirs.insert("j", b"from-jax")
        assert mine.get("j") == b"from-jax"
        assert sorted(p.name for p in (tmp_path / "models").iterdir()) == sorted(
            [mine._path("inst/a:manifest").rsplit("/", 1)[1],
             mine._path("inst/a:part:p0").rsplit("/", 1)[1],
             mine._path("j").rsplit("/", 1)[1]]
        )


# ---------------------------------------------------------------------------
# model blobs across the packages


def _events(path):
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        for j in range(240):
            f.write(json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": f"u{rng.integers(N_USERS)}",
                "targetEntityType": "item", "targetEntityId": f"i{rng.integers(N_ITEMS)}",
                "properties": {"rating": float(rng.integers(1, 6))},
            }) + "\n")
    return path


ENGINE_JSON = {
    "datasource": {"params": {"appName": "blobs"}},
    "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 4}}],
}


def _env(tmp_path, models: dict) -> dict:
    """Metadata and events in one sqlite both packages read; models where
    ``models`` says."""
    env = {
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
    }
    env.update({f"PIO_STORAGE_SOURCES_M_{k}": v for k, v in models.items()})
    return env


@pytest.fixture(params=["hdfs", "jax-daemon", "port-daemon"])
def model_store(request, tmp_path):
    """A model source both packages reach: a ``file://`` directory, or a
    storage daemon of either package (one client then talks to the other
    package's daemon)."""
    if request.param == "hdfs":
        yield {"TYPE": "hdfs", "PATH": f"file://{tmp_path}/models"}
        return
    cls = JaxStorageServer if request.param == "jax-daemon" else StorageServer
    daemon = cls(tmp_path / "root", host="127.0.0.1", port=0).start_background()
    try:
        yield {"TYPE": "remote", "URL": f"http://127.0.0.1:{daemon.port}",
               "TIMEOUT": "10"}
    finally:
        daemon.shutdown()


def test_a_jax_saved_model_serves_on_the_port(tmp_path, model_store):
    env = _env(tmp_path, model_store)
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    port_storage = StorageRuntime(StorageConfig.from_env(env))
    try:
        jax_cmd.app_new(jax_storage, "blobs")
        jax_cmd.import_events(jax_storage, "blobs", _events(tmp_path / "e.jsonl"))
        engine = jax_resolve("recommendation")()
        instance = jax_run_train(
            engine, engine.params_from_json(ENGINE_JSON),
            ctx=JaxEngineContext(storage=jax_storage),
            engine_factory="recommendation", storage=jax_storage,
        )
        jax_d = jax_server.deploy_engine(
            "recommendation", storage=jax_storage, engine_instance_id=instance.id
        )
        port_d = pt_server.deploy_engine(
            "recommendation", storage=port_storage,
            engine_instance_id=instance.id, device="cpu",
        )
        for u in range(N_USERS):
            want = jax_d.algorithms[0].predict(
                jax_d.models[0], jax_rec.Query(user=f"u{u}", num=5))
            got = port_d.algorithms[0].predict(
                port_d.models[0], pt_rec.Query(user=f"u{u}", num=5))
            assert [(s.item, s.score) for s in got.item_scores] == [
                (s.item, s.score) for s in want.item_scores
            ]
    finally:
        port_storage.close()
        jax_storage.close()


def test_a_port_saved_model_loads_in_the_jax_package(tmp_path, model_store):
    env = _env(tmp_path, model_store)
    port_storage = StorageRuntime(StorageConfig.from_env(env))
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    try:
        cmd.app_new(port_storage, "blobs")
        cmd.import_events(port_storage, "blobs", _events(tmp_path / "e.jsonl"))
        engine = resolve_engine_factory("recommendation")()
        instance = run_train(
            engine, engine.params_from_json(ENGINE_JSON),
            ctx=EngineContext(storage=port_storage, device="cpu"),
            engine_factory="recommendation", storage=port_storage,
        )
        [mine] = load_models(port_storage.models(), instance.id)
        [theirs] = jax_load_models(jax_storage.models(), instance.id)
        assert sorted(theirs) == sorted(mine)
        for key in ("user_factors", "item_factors", "user_vocab", "item_vocab"):
            np.testing.assert_array_equal(np.asarray(theirs[key]), mine[key])
        jax_d = jax_server.deploy_engine(
            "recommendation", storage=jax_storage, engine_instance_id=instance.id
        )
        assert jax_d.instance.id == instance.id
    finally:
        jax_storage.close()
        port_storage.close()


def test_train_and_deploy_with_models_on_hdfs(tmp_path):
    env = _env(tmp_path, {"TYPE": "hdfs", "PATH": f"file://{tmp_path}/hmodels"})
    storage = StorageRuntime(StorageConfig.from_env(env))
    try:
        cmd.app_new(storage, "blobs")
        cmd.import_events(storage, "blobs", _events(tmp_path / "e.jsonl"))
        engine = resolve_engine_factory("recommendation")()
        instance = run_train(
            engine, engine.params_from_json(ENGINE_JSON),
            ctx=EngineContext(storage=storage, device="cpu"),
            engine_factory="recommendation", storage=storage,
        )
        assert any((tmp_path / "hmodels").iterdir())
        deployed = pt_server.deploy_engine(
            "recommendation", storage=storage, device="cpu"
        )
        assert deployed.instance.id == instance.id
        _, served = deployed.predict(pt_rec.Query(user="u1", num=3))
        assert len(served.item_scores) == 3
    finally:
        storage.close()
