"""Batch prediction job: queries file in, predictions file out.

Mirrors workflow/BatchPredict.scala:145-234 as the JAX package does: load
the engine + models exactly as deploy does, read one JSON query per input
line, run supplement -> batch_predict per algorithm -> serve, and write one
JSON line ``{"query": ..., "prediction": ...}`` per input line.  A file of
``ALSAlgorithm.DEVICE_BATCH_MIN`` queries or more is one fused top-k wave
on the device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch

from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage
from predictionio_tpu_torch.server.prediction_server import (
    _extract_query,
    _render_prediction,
    deploy_engine,
)


def run_batch_predict(
    engine_factory_name: str,
    input_path: str | Path,
    output_path: str | Path,
    storage: StorageRuntime | None = None,
    engine_instance_id: str | None = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    device: torch.device | str | None = None,
) -> int:
    """Returns the number of predictions written.  ``device=None`` means
    CUDA (raises without a card unless ``device="cpu"``)."""
    deployed = deploy_engine(
        engine_factory_name,
        storage=storage or get_storage(),
        engine_instance_id=engine_instance_id,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        device=device,
    )
    algorithms, models, serving = (
        deployed.algorithms,
        deployed.models,
        deployed.serving,
    )

    queries: list[Any] = []
    with open(input_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            queries.append(
                serving.supplement(_extract_query(algorithms, json.loads(line)))
            )

    # vectorized union: batch_predict per algorithm, regroup per query index
    per_query: list[list[Any]] = [[] for _ in queries]
    indexed = list(enumerate(queries))
    for algo, model in zip(algorithms, models):
        for i, p in algo.batch_predict(model, indexed):
            per_query[i].append(p)

    n = 0
    with open(output_path, "w") as out:
        for (i, q), preds in zip(indexed, per_query):
            served = serving.serve(q, preds)
            out.write(
                json.dumps(
                    {
                        "query": _render_prediction(q),
                        "prediction": _render_prediction(served),
                    }
                )
                + "\n"
            )
            n += 1
    return n
