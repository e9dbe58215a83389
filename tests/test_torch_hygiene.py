"""Ground rules of the PyTorch + CUDA port (predictionio_tpu_torch).

1. The port stands alone: no module of it, nor ``chip_smoke.py`` or
   ``solo_latency.py``, imports ``jax`` or anything of the JAX package
   ``predictionio_tpu``.
2. Its entry points run on CUDA unless the caller asks for the CPU: without
   a card, ``deploy_engine``, ``create_prediction_server``,
   ``run_batch_predict``, the CLI and ``EngineContext`` raise unless given
   ``device="cpu"``; nothing quietly carries on on the CPU.
3. A CUDA tensor launches the hand-written kernel or raises: the wrapper
   takes the plain version only for CPU tensors, and a missing ``nvcc``
   is an error, not a fallback.
"""

from __future__ import annotations

import ast
import json
import tomllib
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

import predictionio_tpu_torch
from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.batch_predict import run_batch_predict
from predictionio_tpu_torch.core.engine import EngineParams
from predictionio_tpu_torch.core.persistence import save_models
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.models.recommendation import engine as pt_rec
from predictionio_tpu_torch.ops import _kernels
from predictionio_tpu_torch.ops import topk as pt_topk
from predictionio_tpu_torch.server.prediction_server import (
    create_prediction_server,
    deploy_engine,
)
from predictionio_tpu_torch.tools import cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(Path(predictionio_tpu_torch.__file__).parent.rglob("*.py"))


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "predictionio_tpu")


@pytest.mark.parametrize(
    "path",
    PORT_FILES + [REPO / "chip_smoke.py", REPO / "solo_latency.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_the_whole_package():
    rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for must in (
        "predictionio_tpu_torch/ops/topk.py",
        "predictionio_tpu_torch/server/prediction_server.py",
        "predictionio_tpu_torch/models/recommendation/engine.py",
        "predictionio_tpu_torch/ops/als.py",
        "predictionio_tpu_torch/ops/als_accum.py",
        "predictionio_tpu_torch/core/workflow.py",
        "predictionio_tpu_torch/server/aio.py",
        "predictionio_tpu_torch/server/microbatch.py",
        "predictionio_tpu_torch/resilience/deadline.py",
    ):
        assert must in rel
    assert _forbidden("jax.numpy") and _forbidden("predictionio_tpu.ops.topk")
    assert not _forbidden("predictionio_tpu_torch.ops.topk")


def test_kernel_source_ships_as_package_data():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert "csrc/*.cu" in cfg["tool"]["setuptools"]["package-data"][
        "predictionio_tpu_torch"
    ]
    for source in {src for src, _, _ in _kernels.KERNELS.values()}:
        assert (_kernels.CSRC / source).is_file()
    assert _kernels.KERNELS["als_fused_accum"][0] == "als_accum.cu"


@pytest.fixture()
def no_cuda(monkeypatch):
    """A host without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture()
def persisted(tmp_path):
    """A tiny COMPLETED recommendation instance in a temp PIO_HOME."""
    storage = StorageRuntime(
        StorageConfig.from_env({"PIO_HOME": str(tmp_path / "pio_home")})
    )
    rng = np.random.default_rng(0)
    blob = {
        "user_factors": rng.random((6, 3), np.float32),
        "item_factors": rng.random((9, 3), np.float32),
        "user_vocab": np.array([f"u{i}" for i in range(6)]),
        "item_vocab": np.array([f"i{i}" for i in range(9)]),
    }
    params = EngineParams(algorithms=(("als", pt_rec.ALSAlgorithmParams(rank=3)),))
    now = datetime.now(tz=timezone.utc)
    storage.engine_instances().insert(
        EngineInstance(
            id="tiny", status="COMPLETED", start_time=now, end_time=now,
            engine_id="default", engine_version="default",
            engine_variant="default", engine_factory="recommendation",
            **params.to_json_fields(),
        )
    )
    save_models(storage.models(), "tiny", [blob])
    yield storage
    storage.close()


def test_resolve_device(no_cuda):
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(device_mod.DeviceUnavailable, match="device='cpu'"):
            device_mod.resolve_device(dev)
    with pytest.raises(ValueError, match="unsupported device"):
        device_mod.resolve_device("meta")


def test_engine_context_needs_cuda_unless_cpu(no_cuda):
    with pytest.raises(device_mod.DeviceUnavailable):
        EngineContext()
    ctx = EngineContext(device="cpu", seed=5)
    assert ctx.device == torch.device("cpu")
    a = torch.rand(4, generator=ctx.generator(1))
    b = torch.rand(4, generator=ctx.generator(1))
    c = torch.rand(4, generator=ctx.generator(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_deploy_needs_cuda_unless_cpu(no_cuda, persisted):
    with pytest.raises(device_mod.DeviceUnavailable):
        deploy_engine("recommendation", storage=persisted)
    with pytest.raises(device_mod.DeviceUnavailable):
        create_prediction_server(
            "recommendation", host="127.0.0.1", port=0, storage=persisted
        )
    deployed = deploy_engine("recommendation", storage=persisted, device="cpu")
    assert deployed.models[0].item_factors.device.type == "cpu"


def test_batch_predict_needs_cuda_unless_cpu(no_cuda, persisted, tmp_path):
    qfile, out = tmp_path / "q.jsonl", tmp_path / "out.jsonl"
    qfile.write_text(json.dumps({"user": "u1", "num": 3}) + "\n")
    with pytest.raises(device_mod.DeviceUnavailable):
        run_batch_predict("recommendation", qfile, out, storage=persisted)
    assert not out.exists()
    assert run_batch_predict(
        "recommendation", qfile, out, storage=persisted, device="cpu"
    ) == 1


def test_cli_needs_cuda_unless_cpu(no_cuda, persisted, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "get_storage", lambda: persisted)
    qfile, out = tmp_path / "q.jsonl", tmp_path / "out.jsonl"
    qfile.write_text(json.dumps({"user": "u2", "num": 2}) + "\n")
    argv = ["batchpredict", "--engine", "recommendation",
            "--input", str(qfile), "--output", str(out)]
    assert cli.build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(device_mod.DeviceUnavailable):
        cli.main(argv)
    with pytest.raises(device_mod.DeviceUnavailable):
        cli.main(["deploy", "--engine", "recommendation", "--port", "0"])
    assert cli.main(argv + ["--device", "cpu"]) == 0
    line = json.loads(out.read_text())
    assert len(line["prediction"]["itemScores"]) == 2


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        _kernels.nvcc_path()


def test_cpu_tensors_never_build_the_kernel(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for CPU tensors")

    monkeypatch.setattr(_kernels, "load", refuse)
    before = dict(pt_topk.KERNEL_LAUNCHES)
    out = pt_topk.fused_topk_batch(torch.ones((3, 2)), torch.ones((7, 2)), 4)
    assert out.shape == (2, 3, 4)
    assert pt_topk.KERNEL_LAUNCHES == before


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        pt_topk.fused_topk_batch(
            torch.ones((3, 2)), torch.ones((7, 2), device="meta"), 4
        )
