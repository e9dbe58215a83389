"""The port's S3 model store (``TYPE=s3``) on the CPU, with an injected
boto3-shaped client (only the default client imports ``boto3``).

- Every ``tests/test_model_store.py::TestS3Models`` case on the port's
  ``S3Models``: round trip, one object per part, the actionable ``boto3``
  message, ``BUCKET``; and the existence probe ladder (``head_object``, a
  ranged get, a plain get, 416 on a zero-byte object).
- One fake client shared by both packages: the same object keys, and the
  bytes either package writes are the bytes the other reads; a model saved
  by either package's ``save_models`` loads in the other.
- ``PIO_STORAGE_SOURCES_<NAME>_TYPE=s3`` resolves to the port's
  ``S3Models``, and a recommendation instance trained into it serves the
  same answers as one trained into sqlite.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.core.persistence import load_models as jax_load_models
from predictionio_tpu.core.persistence import save_models as jax_save_models
from predictionio_tpu.data.storage import s3_models as jax_s3
from predictionio_tpu_torch.core.persistence import load_models, save_models
from predictionio_tpu_torch.data.storage import s3_models
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.s3_models import S3Models

torch.set_num_threads(2)


class FakeS3Client:
    """dict-backed boto3-shaped client (put/get/delete_object)."""

    class exceptions:
        class NoSuchKey(Exception):
            pass

    def __init__(self):
        self.objects: dict[str, bytes] = {}

    def put_object(self, Bucket, Key, Body):
        self.objects[f"{Bucket}/{Key}"] = bytes(Body)

    def get_object(self, Bucket, Key, Range=None):
        k = f"{Bucket}/{Key}"
        if k not in self.objects:
            raise self.exceptions.NoSuchKey(k)
        body = self.objects[k]
        if Range:  # "bytes=a-b" — existence probes use bytes=0-0
            a, b = Range.removeprefix("bytes=").split("-")
            if int(a) >= len(body):
                err = Exception("InvalidRange")
                err.response = {"ResponseMetadata": {"HTTPStatusCode": 416}}
                raise err
            body = body[int(a) : int(b) + 1]
        return {"Body": body}

    def delete_object(self, Bucket, Key):
        self.objects.pop(f"{Bucket}/{Key}", None)


class HeadS3Client(FakeS3Client):
    """With ``head_object``, whose miss is a ClientError-shaped 404."""

    def __init__(self):
        super().__init__()
        self.gets = 0

    def head_object(self, Bucket, Key):
        if f"{Bucket}/{Key}" not in self.objects:
            err = Exception("Not Found")
            err.response = {"ResponseMetadata": {"HTTPStatusCode": 404}}
            raise err
        return {}

    def get_object(self, Bucket, Key, Range=None):
        self.gets += 1
        return super().get_object(Bucket, Key, Range)


class NoRangeS3Client(FakeS3Client):
    """An old client whose get_object takes no Range at all."""

    def get_object(self, Bucket, Key):
        return super().get_object(Bucket, Key)


def make_model(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "item_table": rng.standard_normal((40, 8)).astype(np.float32),
        "user_table": rng.standard_normal((30, 8)).astype(np.float32),
        "item_vocab": np.array([f"i{j}" for j in range(40)]),
    }


class TestS3Models:
    def test_round_trip(self):
        client = FakeS3Client()
        store = S3Models("models", prefix="pio/", client=client)
        store.insert("i1", b"blob")
        assert store.get("i1") == b"blob"
        assert "models/pio/pio_model_i1" in client.objects
        assert store.delete("i1") is True
        assert store.get("i1") is None
        assert store.delete("i1") is False

    def test_sharded_save_uses_one_object_per_part(self):
        client = FakeS3Client()
        store = S3Models("models", client=client)
        m = make_model()
        save_models(store, "inst1", [m], threshold=256)
        parts = [k for k in client.objects if ":part:" in k]
        assert len(parts) >= 2 and "models/pio_model_inst1:manifest" in client.objects
        [out] = load_models(store, "inst1")
        np.testing.assert_array_equal(out["item_table"], m["item_table"])
        assert store.delete_models("inst1")
        assert client.objects == {}

    def test_missing_boto3_is_actionable(self, monkeypatch):
        import builtins

        real_import = builtins.__import__

        def no_boto3(name, *a, **k):
            if name == "boto3":
                raise ImportError("No module named 'boto3'")
            return real_import(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_boto3)
        with pytest.raises(ImportError, match="requires boto3") as e:
            S3Models("bucket")  # no client injected
        with pytest.raises(ImportError) as j:
            jax_s3.S3Models("bucket")
        assert str(e.value) == str(j.value)

    def test_requires_bucket(self):
        with pytest.raises(ValueError, match="BUCKET"):
            S3Models("", client=FakeS3Client())

    def test_existence_probe_ladder(self):
        # head_object: answers without a get; a 404 is "absent"
        head = HeadS3Client()
        store = S3Models("b", client=head)
        store.insert("x", b"data")
        assert store.delete("x") is True and head.gets == 0
        assert store.delete("x") is False
        # a ranged get; a zero-byte object answers 416 and still exists
        ranged = S3Models("b", client=FakeS3Client())
        ranged.insert("empty", b"")
        assert ranged.delete("empty") is True
        assert ranged.delete("empty") is False
        # no Range at all: the plain get
        plain = S3Models("b", client=NoRangeS3Client())
        plain.insert("y", b"1")
        assert plain.delete("y") is True and plain.delete("y") is False

    def test_boto3_is_imported_only_by_the_default_client(self):
        import ast
        import inspect

        tree = ast.parse(inspect.getsource(s3_models))
        homes = []
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Import) and any(
                        a.name == "boto3" for a in sub.names
                    ):
                        homes.append(node.name)
        assert homes == ["_make_boto3_client"]
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not any("boto3" in ast.dump(n) for n in top)


class TestAcrossPackages:
    """One bucket, both packages."""

    def test_same_keys_and_bytes(self):
        client = FakeS3Client()
        mine = S3Models("models", prefix="pio/", client=client)
        theirs = jax_s3.S3Models("models", prefix="pio/", client=client)
        mine.insert_parts("inst/a", b"manifest", {"p0": b"\x00\x01", "p1": b"\x02"})
        assert theirs.get_manifest("inst/a") == b"manifest"
        assert theirs.get_part("inst/a", "p1") == b"\x02"
        theirs.insert("j", b"from-jax")
        assert mine.get("j") == b"from-jax"
        assert sorted(client.objects) == [
            "models/pio/pio_model_inst/a:manifest",
            "models/pio/pio_model_inst/a:part:p0",
            "models/pio/pio_model_inst/a:part:p1",
            "models/pio/pio_model_j",
        ]
        other = FakeS3Client()
        jax_s3.S3Models("models", prefix="pio/", client=other).insert_parts(
            "inst/a", b"manifest", {"p0": b"\x00\x01", "p1": b"\x02"}
        )
        jax_s3.S3Models("models", prefix="pio/", client=other).insert("j", b"from-jax")
        assert other.objects == client.objects
        assert theirs.delete_parts("inst/a") and mine.get_manifest("inst/a") is None

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_a_model_saved_by_either_package_loads_in_the_other(self, writer):
        client = FakeS3Client()
        mine = S3Models("models", client=client)
        theirs = jax_s3.S3Models("models", client=client)
        m = make_model(3)
        if writer == "jax":
            jax_save_models(theirs, "inst1", [m], threshold=256)
            [out] = load_models(mine, "inst1")
        else:
            save_models(mine, "inst1", [m], threshold=256)
            [out] = jax_load_models(theirs, "inst1")
        keys = sorted(client.objects)
        assert any(":part:" in k for k in keys)
        for name, arr in m.items():
            np.testing.assert_array_equal(np.asarray(out[name]), arr)
        # what the reader reads is byte for byte what the writer wrote
        for k in keys:
            obj = k.removeprefix("models/pio_model_")
            assert mine.get(obj) == theirs.get(obj) == client.objects[k]


# -- TYPE=s3 through the storage runtime -----------------------------------

N_USERS, N_ITEMS = 20, 12


def _events(path):
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        for _ in range(240):
            f.write(json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": f"u{rng.integers(N_USERS)}",
                "targetEntityType": "item",
                "targetEntityId": f"i{rng.integers(N_ITEMS)}",
                "properties": {"rating": float(rng.integers(1, 6))},
            }) + "\n")
    return path


ENGINE_JSON = {
    "datasource": {"params": {"appName": "s3app"}},
    "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 4}}],
}


@pytest.fixture()
def shared_bucket(monkeypatch):
    """Both packages' default S3 client is one in-memory fake."""
    client = FakeS3Client()
    monkeypatch.setattr(s3_models, "_make_boto3_client", lambda r, e: client)
    monkeypatch.setattr(jax_s3, "_make_boto3_client", lambda r, e: client)
    return client


def _env(tmp_path, s3: bool) -> dict:
    env = {
        "PIO_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.sqlite"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3" if s3 else "DB",
    }
    if s3:
        env.update({
            "PIO_STORAGE_SOURCES_S3_TYPE": "s3",
            "PIO_STORAGE_SOURCES_S3_BUCKET": "pio-models",
            "PIO_STORAGE_SOURCES_S3_PREFIX": "eng/",
            "PIO_STORAGE_SOURCES_S3_REGION": "us-east-1",
        })
    return env


def test_type_s3_resolves_to_the_ports_store(tmp_path, shared_bucket):
    rt = StorageRuntime(StorageConfig.from_env(_env(tmp_path, s3=True)))
    try:
        store = rt.models()
        assert isinstance(store, S3Models)
        assert (store.bucket, store.prefix) == ("pio-models", "eng/")
        store.insert("a", b"1")
        assert shared_bucket.objects == {"pio-models/eng/pio_model_a": b"1"}
    finally:
        rt.close()


def test_type_s3_without_a_bucket_names_it(tmp_path, shared_bucket):
    env = _env(tmp_path, s3=True)
    del env["PIO_STORAGE_SOURCES_S3_BUCKET"]
    rt = StorageRuntime(StorageConfig.from_env(env))
    try:
        with pytest.raises(ValueError, match="BUCKET"):
            rt.models()
    finally:
        rt.close()


def test_an_s3_trained_instance_serves_as_the_sqlite_one(tmp_path, shared_bucket):
    """Train the same seeded recommendation engine into sqlite and into
    S3 (one sqlite for metadata and events), then deploy each: the answers
    are equal, and the JAX package deploys the S3 instance too."""
    from predictionio_tpu.data.storage.config import StorageConfig as JaxConfig
    from predictionio_tpu.data.storage.config import StorageRuntime as JaxRuntime
    from predictionio_tpu.models.recommendation import engine as jax_rec
    from predictionio_tpu.server import prediction_server as jax_server
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.models.recommendation import engine as pt_rec
    from predictionio_tpu_torch.server import prediction_server as pt_server
    from predictionio_tpu_torch.tools import commands as cmd

    rts = {s3: StorageRuntime(StorageConfig.from_env(_env(tmp_path, s3)))
           for s3 in (False, True)}
    jax_rt = JaxRuntime(JaxConfig.from_env(_env(tmp_path, s3=True)))
    try:
        cmd.app_new(rts[False], "s3app")
        cmd.import_events(rts[False], "s3app", _events(tmp_path / "e.jsonl"))
        deployed = {}
        for s3, rt in rts.items():
            engine = resolve_engine_factory("recommendation")()
            inst = run_train(
                engine, engine.params_from_json(ENGINE_JSON),
                ctx=EngineContext(storage=rt, device="cpu", seed=7),
                engine_factory="recommendation", storage=rt,
            )
            deployed[s3] = (inst.id, pt_server.deploy_engine(
                "recommendation", storage=rt, engine_instance_id=inst.id,
                device="cpu",
            ))
        s3_id = deployed[True][0]
        assert any(k.startswith(f"pio-models/eng/pio_model_{s3_id}")
                   for k in shared_bucket.objects)
        jax_d = jax_server.deploy_engine(
            "recommendation", storage=jax_rt, engine_instance_id=s3_id
        )
        for u in range(N_USERS):
            q = pt_rec.Query(user=f"u{u}", num=5)
            a = [deployed[s3][1].algorithms[0].predict(deployed[s3][1].models[0], q)
                 for s3 in (False, True)]
            assert [(s.item, s.score) for s in a[1].item_scores] == [
                (s.item, s.score) for s in a[0].item_scores
            ]
            j = jax_d.algorithms[0].predict(
                jax_d.models[0], jax_rec.Query(user=f"u{u}", num=5)
            )
            assert [s.item for s in j.item_scores] == [s.item for s in a[1].item_scores]
            np.testing.assert_allclose(
                [s.score for s in j.item_scores],
                [s.score for s in a[1].item_scores], rtol=1e-5, atol=1e-6,
            )
    finally:
        jax_rt.close()
        for rt in rts.values():
            rt.close()
