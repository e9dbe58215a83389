"""Prediction serving — the ``pio deploy`` server, one live binding.

Route parity with the JAX package (workflow/CreateServer.scala:458-706):

  GET  /              HTML status page ("Engine is deployed and running")
  POST /queries.json  extract query -> supplement -> predict per algorithm
                      -> serve -> JSON
  POST /stop          shut the server down (key-gated when an access key
                      is configured)

Models are materialized once at deploy onto the serving device
(``load_persistent_model``).  The micro-batcher, ``/reload``, canary,
tenancy and observability routes arrive with later slices.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from datetime import datetime, timezone
from typing import Any, Callable, NamedTuple

import torch

from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import Engine, resolve_engine_factory
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import (
    StorageRuntime,
    get_storage,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    error_response,
    json_response,
    key_matches,
)
from predictionio_tpu_torch.utils.params import extract_params

#: response header naming the generation that answered
INSTANCE_HEADER = "X-Pio-Engine-Instance"


class Binding(NamedTuple):
    """One engine instance's materialized serving state."""

    instance: EngineInstance
    params: Any
    algorithms: list
    models: list
    serving: Any


def _render_prediction(p: Any) -> Any:
    if hasattr(p, "to_json_dict"):
        return p.to_json_dict()
    if dataclasses.is_dataclass(p) and not isinstance(p, type):
        return dataclasses.asdict(p)
    return p


def _extract_query(algorithms, payload: dict) -> Any:
    """The first algorithm's declared ``query_class`` drives dataclass
    extraction; engines without one get the raw dict."""
    qcls = next(
        (a.query_class for a in algorithms if getattr(a, "query_class", None)),
        None,
    )
    if qcls is None:
        return payload
    return extract_params(qcls, payload)


def _instance_variant(instance: EngineInstance) -> dict[str, Any]:
    """The engine-variant JSON of an instance row (its frozen params)."""

    def one(raw: str) -> dict[str, Any]:
        d = json.loads(raw or "{}")
        if not d:
            return {}
        ((name, params),) = d.items()
        return {"name": name, "params": params}

    return {
        "datasource": one(instance.datasource_params),
        "preparator": one(instance.preparator_params),
        "algorithms": [
            {"name": name, "params": p}
            for entry in json.loads(instance.algorithms_params or "[]")
            for name, p in entry.items()
        ],
        "serving": one(instance.serving_params),
    }


class DeployedEngine:
    """Engine + materialized models for one engine instance."""

    def __init__(
        self,
        engine: Engine,
        instance: EngineInstance,
        storage: StorageRuntime,
        device: torch.device | str | None = None,
    ):
        self.engine = engine
        self.storage = storage
        self.ctx = EngineContext(storage=storage, mode="serving", device=device)
        (
            self.instance, self.params, self.algorithms, self.models,
            self.serving,
        ) = self.load_binding(instance)

    def load_binding(self, instance: EngineInstance) -> Binding:
        """Materialize one generation: parse its params, load its models
        onto the context's device, instantiate its components."""
        params = self.engine.params_from_json(_instance_variant(instance))
        persisted = load_models(self.storage.models(), instance.id)
        if persisted is None:
            raise RuntimeError(f"no model blob for engine instance {instance.id}")
        models = self.engine.prepare_deploy(self.ctx, params, persisted)
        _, _, algos, serving = self.engine.instantiate(params)
        return Binding(instance, params, algos, models, serving)

    def extract_query(self, query_payload: dict) -> Any:
        return _extract_query(self.algorithms, query_payload)

    def predict(self, query: Any) -> tuple[Any, Any]:
        """One query: supplement, predict per algorithm, serve."""
        query = self.serving.supplement(query)
        predictions = [
            a.predict(m, query) for a, m in zip(self.algorithms, self.models)
        ]
        return query, self.serving.serve(query, predictions)

    def predict_batch(self, queries: list[Any]) -> list[tuple[Any, Any]]:
        """A wave of queries in one vectorized ``batch_predict`` pass per
        algorithm."""
        supplemented = [self.serving.supplement(q) for q in queries]
        per_algo: list[list[Any]] = []
        for a, m in zip(self.algorithms, self.models):
            by_idx = dict(a.batch_predict(m, list(enumerate(supplemented))))
            per_algo.append([by_idx[i] for i in range(len(supplemented))])
        return [
            (q, self.serving.serve(q, [col[i] for col in per_algo]))
            for i, q in enumerate(supplemented)
        ]


def deploy_engine(
    engine_factory_name: str,
    storage: StorageRuntime | None = None,
    engine_instance_id: str | None = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    device: torch.device | str | None = None,
) -> DeployedEngine:
    """Resolve factory + engine instance (the given id, else the latest
    COMPLETED one) and materialize its models on ``device`` (default CUDA;
    raises without a card unless ``device="cpu"``)."""
    device = resolve_device(device)
    storage = storage or get_storage()
    instances = storage.engine_instances()
    if engine_instance_id is not None:
        instance = instances.get(engine_instance_id)
        if instance is None:
            raise RuntimeError(f"engine instance {engine_instance_id} not found")
    else:
        instance = instances.get_latest_completed(
            engine_id, engine_version, engine_variant
        )
        if instance is None:
            raise RuntimeError(
                f"no COMPLETED engine instance for engine {engine_id!r}; "
                "run train first"
            )
    factory = resolve_engine_factory(
        engine_factory_name or instance.engine_factory
    )
    return DeployedEngine(factory(), instance, storage, device=device)


def create_prediction_server_app(
    deployed: DeployedEngine,
    on_stop: Callable[[], None] | None = None,
    access_key: str | None = None,
) -> HTTPApp:
    app = HTTPApp("prediction")
    started_at = datetime.now(tz=timezone.utc)
    stats = {"request_count": 0, "avg_serving_sec": 0.0, "last_serving_sec": 0.0}
    stats_lock = threading.Lock()

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        inst = deployed.instance
        body = f"""<html><head><title>PredictionIO-TPU-Torch server</title></head>
<body>
<h1>Engine is deployed and running</h1>
<table>
<tr><td>Engine instance</td><td>{inst.id}</td></tr>
<tr><td>Engine</td><td>{inst.engine_factory or inst.engine_id}</td></tr>
<tr><td>Variant</td><td>{inst.engine_variant}</td></tr>
<tr><td>Device</td><td>{deployed.ctx.device}</td></tr>
<tr><td>Started</td><td>{started_at.isoformat()}</td></tr>
<tr><td>Requests</td><td>{stats['request_count']}</td></tr>
<tr><td>Average serving (s)</td><td>{stats['avg_serving_sec']:.6f}</td></tr>
<tr><td>Last serving (s)</td><td>{stats['last_serving_sec']:.6f}</td></tr>
</table>
</body></html>"""
        return Response(200, body)

    @app.route("POST", "/queries\\.json")
    def queries(req: Request) -> Response:
        # bad query JSON/shape -> 400; engine faults -> 500 (the reference's
        # MappingException / Throwable split, CreateServer.scala:607-630)
        t0 = time.perf_counter()
        try:
            payload = req.json()
            if not isinstance(payload, dict):
                raise ValueError("query must be a JSON object")
            query = deployed.extract_query(payload)
        except Exception as e:
            return error_response(400, f"invalid query: {e}")
        instance_id = deployed.instance.id
        _, prediction = deployed.predict(query)
        resp = json_response(200, _render_prediction(prediction))
        resp.headers[INSTANCE_HEADER] = instance_id
        dt = time.perf_counter() - t0
        with stats_lock:
            n = stats["request_count"]
            stats["avg_serving_sec"] = (stats["avg_serving_sec"] * n + dt) / (n + 1)
            stats["last_serving_sec"] = dt
            stats["request_count"] = n + 1
        return resp

    @app.route("POST", "/stop")
    def stop(req: Request) -> Response:
        if access_key is not None and not key_matches(req, access_key):
            return error_response(401, "Invalid accessKey.")
        if on_stop is not None:
            threading.Thread(target=on_stop, daemon=True).start()
        return json_response(200, {"message": "Shutting down."})

    return app


def create_prediction_server(
    engine_factory_name: str,
    host: str = "0.0.0.0",
    port: int = 8000,
    storage: StorageRuntime | None = None,
    engine_instance_id: str | None = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    access_key: str | None = None,
    device: torch.device | str | None = None,
) -> AppServer:
    """Deploy the engine and bind the threaded server (not started: call
    ``start_background()`` or ``serve_forever()``).  ``POST /stop`` shuts
    it down."""
    deployed = deploy_engine(
        engine_factory_name,
        storage=storage,
        engine_instance_id=engine_instance_id,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        device=device,
    )
    server_ref: list[AppServer] = []

    def on_stop():
        if server_ref:
            server_ref[0].shutdown()

    app = create_prediction_server_app(
        deployed, on_stop=on_stop, access_key=access_key
    )
    server = AppServer(app, host, port)
    server_ref.append(server)
    return server
