"""The port's external-model engine: the seven cases of
``tests/test_external_engine.py`` on the port (with ``device="cpu"`` where
the port computes), and an external model registered through the JAX
package deployed on the port with the same answers.
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.models import external as jax_external
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.external import (
    ExternalAlgorithm,
    default_engine_params,
    external_engine,
    register_external_model,
)
from predictionio_tpu_torch.models.external.engine import (
    SELECT_COLUMNS_KEY,
    ExternalAlgorithmParams,
)
from predictionio_tpu_torch.server.prediction_server import (
    create_prediction_server,
    deploy_engine,
)

torch.set_num_threads(2)


class TinyClassifier:
    """Stands in for a pickled sklearn estimator: fit outside the
    framework, exposes predict/predict_proba over feature rows."""

    def __init__(self, w, b):
        self.w = np.asarray(w, np.float64)
        self.b = float(b)

    def _logit(self, x):
        return x @ self.w + self.b

    def predict(self, x):
        return (self._logit(np.asarray(x)) > 0).astype(np.int64)

    def predict_proba(self, x):
        p = 1.0 / (1.0 + np.exp(-self._logit(np.asarray(x))))
        return np.stack([1.0 - p, p], axis=1)


def _doubler(q):
    return {"doubled": q["v"] * 2}


@pytest.fixture()
def storage(tmp_path):
    rt = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "h")}))
    yield rt
    rt.close()


def _query(base, body):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def test_sklearn_style_predict_rowbuild():
    algo = ExternalAlgorithm(ExternalAlgorithmParams(feature_columns=("a", "b")))
    r = algo.predict(TinyClassifier([1.0, -1.0], 0.0), {"a": 3.0, "b": 1.0})
    assert r.to_json_dict()["prediction"] == 1
    assert len(r.to_json_dict()["probability"]) == 2


def test_callable_model_and_column_selection():
    algo = ExternalAlgorithm()
    model = lambda q: {"score": q["x"] * 2, "debug": "internal"}  # noqa: E731
    r = algo.predict(model, {"x": 4, SELECT_COLUMNS_KEY: ("score",)})
    assert r.to_json_dict() == {"score": 8}
    with pytest.raises(KeyError):
        algo.predict(model, {"x": 4, SELECT_COLUMNS_KEY: ("absent",)})


def test_scalar_result_normalizes_to_prediction():
    r = ExternalAlgorithm().predict(lambda q: 7.5, {"anything": 1})
    assert r.to_json_dict() == {"prediction": 7.5}


def test_train_is_unsupported():
    with pytest.raises(RuntimeError, match="register_external_model"):
        external_engine().train_full(
            EngineContext(storage=None, device="cpu"), default_engine_params()
        )


def test_register_deploy_query_e2e(storage):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 2))
    y = (X[:, 0] - X[:, 1] > 0).astype(np.int64)
    w = np.linalg.lstsq(X, y * 2.0 - 1.0, rcond=None)[0]
    clf = TinyClassifier(w, 0.0)
    assert (clf.predict(X) == y).mean() > 0.9
    instance = register_external_model(
        clf, feature_columns=("a", "b"), columns=("prediction", "probability"),
        storage=storage,
    )
    assert instance.status == "COMPLETED"
    assert instance.engine_factory == "external"
    server = create_prediction_server(
        "external", host="127.0.0.1", port=0, storage=storage, device="cpu"
    ).start_background()
    try:
        got = _query(f"http://127.0.0.1:{server.port}", {"a": 2.0, "b": -1.0})
        assert got["prediction"] == 1
        assert 0.5 < got["probability"][1] <= 1.0
        assert set(got) == {"prediction", "probability"}
    finally:
        server.shutdown()


def test_registered_model_reloads_from_store(storage, monkeypatch):
    register_external_model(_doubler, columns=("doubled",), storage=storage)
    deployed = deploy_engine("external", storage=storage, device="cpu")
    _, result = deployed.predict(deployed.extract_query({"v": 21}))
    assert result.to_json_dict() == {"doubled": 42}
    # the deploy is an entry point like any other: CUDA unless asked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.DeviceUnavailable):
        deploy_engine("external", storage=storage)


def test_external_engine_concurrent_waves_keep_row_alignment(storage):
    register_external_model(
        TinyClassifier([1.0, -1.0], 0.0), feature_columns=("a", "b"),
        columns=("prediction",), storage=storage,
    )
    server = create_prediction_server(
        "external", host="127.0.0.1", port=0, storage=storage,
        server_kind="aio", device="cpu",
    ).start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"

        def ask(n):
            a, b = (float(n), 0.0) if n % 2 else (0.0, float(n + 1))
            return n, _query(base, {"a": a, "b": b})["prediction"], n % 2

        for _ in range(5):
            with ThreadPoolExecutor(16) as pool:
                results = list(pool.map(ask, range(1, 49)))
            for n, got, want in results:
                assert got == want, (n, got, want)
            waves = server.app.microbatcher.wave_sizes
            if any(size > 1 for size in waves):
                break
        else:
            raise AssertionError(f"no burst coalesced a >1 wave: {waves}")
    finally:
        server.shutdown()


def test_jax_registered_model_deploys_on_the_port(tmp_path):
    """``register_external_model`` of the JAX package writes the instance
    and the blob; the port's deploy reads both and answers the same."""
    env = {"PIO_HOME": str(tmp_path / "shared")}
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env(env))
    storage = StorageRuntime(StorageConfig.from_env(env))
    try:
        clf = TinyClassifier([0.5, -2.0], 0.25)
        inst = jax_external.register_external_model(
            clf, feature_columns=("a", "b"),
            columns=("prediction", "probability"), storage=jax_storage,
        )
        deployed = deploy_engine("external", storage=storage, device="cpu")
        assert deployed.instance.id == inst.id
        jalgo = jax_external.ExternalAlgorithm(
            jax_external.engine.ExternalAlgorithmParams(feature_columns=("a", "b")))
        for a, b in [(1.0, 0.0), (0.0, 1.0), (3.0, 0.5), (-1.0, -1.0)]:
            _, got = deployed.predict(deployed.extract_query({"a": a, "b": b}))
            want = jalgo.predict(clf, {"a": a, "b": b, SELECT_COLUMNS_KEY: (
                "prediction", "probability")})
            assert got.to_json_dict() == want.to_json_dict()
    finally:
        storage.close()
        jax_storage.close()
