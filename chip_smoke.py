"""Chip smoke test of the PyTorch + CUDA port (``predictionio_tpu_torch``).

Run from the root of a checkout on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the serving path from ``predictionio_tpu_torch/
csrc`` (nvcc, sm_90a, into the git-ignored ``build/kernels/``), holds each
kernel against its plain PyTorch version on the card, then drives the port's
main path at the ML-20M shape through the entry points a user calls:
``run_batch_predict`` over 4,096 queries (one fused top-k wave) and a
threaded prediction server answering solo ``POST /queries.json`` requests.
It prints one JSON line per phase (every correctness case, every timing and
the main path's record), the ``kernels`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed phase raises
and the script exits non-zero without the last line.  Without CUDA, or
without the package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
import uuid
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import torch

#: H100 SXM published peaks (dense): HBM bytes/s and fp32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

#: the ML-20M shape of the recommendation template (engine.py rank default)
ML20M_USERS, ML20M_ITEMS, RANK = 138_493, 26_744, 10
WAVE = 4096
SEED = 20
RTOL = 1e-5  # random-normal inputs: cuBLAS sums in another order


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def toolchain() -> dict:
    from predictionio_tpu_torch.ops import _kernels

    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    return {
        "phase": "toolchain",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "triton": triton_version,
        "nvcc": _kernels.nvcc_path(),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(),
    }


def time_ms(fn, launches: int = 10, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean device time of ``launches``
    back-to-back calls between two CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def make_inputs(kind: str, b: int, n: int, r: int, rng, dup_rows=()):
    if kind == "exact":
        # integers in [-8, 8] over 8: every product and partial sum is exact
        # in fp32, so scores agree bit for bit in any summation order
        q = rng.integers(-8, 9, (b, r)) / 8.0
        t = rng.integers(-8, 9, (n, r)) / 8.0
    elif kind == "normal":
        q = rng.standard_normal((b, r))
        t = rng.standard_normal((n, r))
    else:  # all-equal scores
        q = np.ones((b, r))
        t = np.zeros((n, r))
    t = t.astype(np.float32)
    for a, c in dup_rows:
        t[c] = t[a]
    dev = torch.device("cuda")
    return (
        torch.from_numpy(q.astype(np.float32)).to(dev),
        torch.from_numpy(t).to(dev),
    )


def check_case(case: dict, rng) -> dict:
    from predictionio_tpu_torch.ops.topk import fused_topk_batch, fused_topk_plain

    b, n, r, k = case["shape"]
    q, t = make_inputs(case["kind"], b, n, r, rng, case.get("dup_rows", ()))
    limit = case.get("limit", n)
    got = fused_topk_batch(q, t, k, limit=limit, name="chip_smoke")
    torch.cuda.synchronize()
    kk = min(k + 1, n)  # one more: the neighbour of the last position
    want = fused_topk_plain(q, t, kk, limit)
    got_v, got_i = got[0].cpu().numpy(), got[1].cpu().numpy()
    want_v, want_i = want[0, :, :k].cpu().numpy(), want[1, :, :k].cpu().numpy()
    ids_equal = bool(np.array_equal(got_i, want_i))
    finite = np.isfinite(want_v)
    if not np.array_equal(np.isfinite(got_v), finite):
        raise AssertionError(f"{case['name']}: -inf pattern differs")
    err = np.abs(got_v[finite] - want_v[finite])
    out = {
        "name": case["name"],
        "kind": case["kind"],
        "shape": case["shape"],
        "limit": limit,
        "ids_equal": ids_equal,
        "max_abs_err": float(err.max()) if err.size else 0.0,
    }
    if case["kind"] != "normal":
        # bit for bit, ties and the limit mask included
        same_bits = np.array_equal(
            got_v.view(np.uint32), want_v.view(np.uint32)
        )
        if not (ids_equal and same_bits):
            bad = np.argwhere(got_i != want_i)[:3].tolist()
            raise AssertionError(f"{case['name']}: not bitwise equal at {bad}")
    else:
        tol = RTOL * np.abs(want_v[finite]) + 1e-6
        if (err > tol).any():
            raise AssertionError(f"{case['name']}: values beyond rtol {RTOL}")
        # ids may differ only inside a near-tie of the plain version
        full_v = want[0].cpu().numpy()
        for row, j in np.argwhere(got_i != want_i):
            v = full_v[row, j]
            gap = min(
                abs(v - full_v[row, j - 1]) if j > 0 else np.inf,
                abs(v - full_v[row, j + 1]) if j + 1 < kk else np.inf,
            )
            if gap > RTOL * abs(v) + 1e-6:
                raise AssertionError(
                    f"{case['name']}: id differs at ({row}, {j}) without a tie"
                )
        out["near_tie_id_swaps"] = int((got_i != want_i).sum())
    return out


def time_case(b: int, n: int, r: int, k: int, rng) -> dict:
    from predictionio_tpu_torch.ops.topk import (
        fused_topk_batch,
        fused_topk_least_work,
        fused_topk_plain,
    )

    q, t = make_inputs("normal", b, n, r, rng)
    work = fused_topk_least_work(b, r, n, k)
    bytes_s = work["bytes"] / HBM_BYTES_PER_S
    ops_s = work["flops"] / FP32_FLOPS_PER_S
    return {
        "shape": [b, n, r, k],
        "kernel_ms": time_ms(lambda: fused_topk_batch(q, t, k, name="chip_smoke")),
        "plain_ms": time_ms(lambda: fused_topk_plain(q, t, k, n)),
        "library_ms": time_ms(lambda: torch.topk(q @ t.T, k)),
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def kernel_phase() -> tuple[list, list]:
    from predictionio_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "per_kernel_s": built,
            "ptxas": _kernels.build_log("fused_topk").strip().splitlines()[-12:],
        }
    )
    rng = np.random.default_rng(SEED)
    dup = [(0, 1024), (5, 1025), (10, 2999)]
    cases = [
        {"name": f"{kind} {b}x{n} r{r} k{k}", "kind": kind, "shape": [b, n, r, k]}
        for kind in ("exact", "normal")
        for b, n, r, k in (
            (512, ML20M_ITEMS, 10, 10),
            (WAVE, ML20M_ITEMS, 10, 10),
            (WAVE, ML20M_ITEMS, 32, 128),
        )
    ]
    cases += [
        {"name": f"{kind} dup rows", "kind": kind, "shape": [300, 3000, 8, 32],
         "dup_rows": dup}
        for kind in ("exact", "normal")
    ]
    cases += [
        {"name": "all equal", "kind": "equal", "shape": [512, ML20M_ITEMS, 10, 128]},
        {"name": "limit < N", "kind": "exact", "shape": [WAVE, ML20M_ITEMS, 10, 10],
         "limit": 20_000},
        {"name": "limit < k", "kind": "exact", "shape": [64, 3000, 8, 32],
         "limit": 20},
    ]
    results = [check_case(c, rng) for c in cases]
    emit({"phase": "kernel_vs_plain", "all_passed": True, "cases": results})
    timings = [
        time_case(b, n, r, k, rng)
        for b, n, r, k in (
            (512, ML20M_ITEMS, 10, 10),
            (WAVE, ML20M_ITEMS, 10, 10),
            (WAVE, ML20M_ITEMS, 32, 128),
        )
    ]
    emit({"phase": "kernel_timing", "timings": timings})
    return results, timings


def write_model(storage, home: Path) -> tuple[str, np.ndarray, np.ndarray]:
    """A seeded ALS model at the ML-20M shape, persisted as a COMPLETED
    engine instance through the port's storage and save_models (factors as
    ops/als.py initializes them: abs(normal) / sqrt(rank))."""
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithmParams,
        DataSourceParams,
    )

    rng = np.random.default_rng(SEED)
    U = (np.abs(rng.standard_normal((ML20M_USERS, RANK))) / np.sqrt(RANK)).astype(
        np.float32
    )
    V = (np.abs(rng.standard_normal((ML20M_ITEMS, RANK))) / np.sqrt(RANK)).astype(
        np.float32
    )
    blob = {
        "user_factors": U,
        "item_factors": V,
        "user_vocab": np.array([f"u{i}" for i in range(ML20M_USERS)]),
        "item_vocab": np.array([f"i{i}" for i in range(ML20M_ITEMS)]),
    }
    params = EngineParams(
        datasource=("", DataSourceParams(app_name="ml20m")),
        algorithms=(("als", ALSAlgorithmParams(rank=RANK)),),
        serving=("", None),
    )
    now = datetime.now(tz=timezone.utc)
    instance = EngineInstance(
        id=uuid.uuid4().hex, status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="default", engine_variant="default",
        engine_factory="recommendation", **params.to_json_fields(),
    )
    storage.engine_instances().insert(instance)
    save_models(storage.models(), instance.id, [blob])
    return instance.id, U, V


def host_answer(U, V, user: int, num: int) -> tuple[list, list]:
    from predictionio_tpu_torch.ops.topk import host_topk

    s, i = host_topk(V @ U[user], num)
    return [f"i{j}" for j in i], [float(x) for x in s]


def wave_breakdown(storage, qfile: Path) -> dict:
    """Where the time of one ``run_batch_predict`` wave goes: its stages
    timed on the host clock (each ends in a synchronize), and the
    ``batch_predict`` stage traced with ``torch.profiler`` for the device
    time of each kernel and the device's idle share of that stage."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.server.prediction_server import (
        _extract_query,
        _render_prediction,
        deploy_engine,
    )

    stages = {}
    t0 = time.perf_counter()
    deployed = deploy_engine("recommendation", storage=storage)
    torch.cuda.synchronize()
    stages["deploy_s"] = time.perf_counter() - t0
    algo, model, serving = (
        deployed.algorithms[0], deployed.models[0], deployed.serving
    )
    t0 = time.perf_counter()
    queries = [
        serving.supplement(_extract_query([algo], json.loads(line)))
        for line in qfile.read_text().splitlines()
    ]
    stages["parse_s"] = time.perf_counter() - t0
    indexed = list(enumerate(queries))
    algo.batch_predict(model, indexed)  # warm: the kernel is loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        preds = algo.batch_predict(model, indexed)
        torch.cuda.synchronize()
        stages["batch_predict_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = [
        json.dumps({"query": _render_prediction(q),
                    "prediction": _render_prediction(serving.serve(q, [p]))})
        for (_, q), (_, p) in zip(indexed, preds)
    ]
    stages["render_s"] = time.perf_counter() - t0
    assert len(lines) == len(queries)
    device_ms = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            device_ms[e.key] = device_ms.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(device_ms.values())
    stages["device_ms_by_kernel"] = device_ms
    stages["device_busy_ms"] = busy_ms
    stages["batch_predict_device_idle_share"] = (
        1.0 - busy_ms / (1e3 * stages["batch_predict_s"]) if device_ms else None
    )
    return stages


def main_path_phase() -> dict:
    from predictionio_tpu_torch.core.batch_predict import run_batch_predict
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
    )

    out: dict = {"phase": "main_path"}
    with tempfile.TemporaryDirectory() as tmp:
        home = Path(tmp) / "pio_home"
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
        t0 = time.perf_counter()
        instance_id, U, V = write_model(storage, home)
        out["write_model_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(SEED + 1)
        users = rng.integers(0, ML20M_USERS, WAVE)
        qfile, pfile = Path(tmp) / "queries.jsonl", Path(tmp) / "preds.jsonl"
        qfile.write_text(
            "".join(json.dumps({"user": f"u{u}", "num": 10}) + "\n" for u in users)
        )

        # -- the main path, with every launch count at 0 just before it --
        for name in topk.KERNEL_LAUNCHES:
            topk.KERNEL_LAUNCHES[name] = 0
        t0 = time.perf_counter()
        n = run_batch_predict("recommendation", qfile, pfile, storage=storage)
        torch.cuda.synchronize()
        out["batch_predict_s"] = time.perf_counter() - t0
        server = create_prediction_server(
            "recommendation", host="127.0.0.1", port=0, storage=storage
        ).start_background()
        solo_users = [int(u) for u in users[:8]]
        solo_ms = []
        try:
            base = f"http://127.0.0.1:{server.port}"
            page = urllib.request.urlopen(base + "/", timeout=30).read().decode()
            assert "Engine is deployed" in page
            for u in solo_users:
                req = urllib.request.Request(
                    base + "/queries.json",
                    data=json.dumps({"user": f"u{u}", "num": 10}).encode(),
                )
                t1 = time.perf_counter()
                got = json.loads(urllib.request.urlopen(req, timeout=30).read())
                solo_ms.append(1e3 * (time.perf_counter() - t1))
                items, scores = host_answer(U, V, u, 10)
                assert [s["item"] for s in got["itemScores"]] == items, u
                assert [s["score"] for s in got["itemScores"]] == scores, u
            stop = urllib.request.Request(base + "/stop", method="POST")
            urllib.request.urlopen(stop, timeout=30).read()
            server._thread.join(timeout=30)
            assert not server._thread.is_alive(), "server did not stop on /stop"
        finally:
            server.shutdown()
        launches = dict(topk.KERNEL_LAUNCHES)
        # -- end of the main path --

        assert n == WAVE, n
        assert launches["fused_topk"] > 0, launches
        lines = [json.loads(x) for x in pfile.read_text().splitlines()]
        for line in lines:
            s = [x["score"] for x in line["prediction"]["itemScores"]]
            assert len(s) == 10 and s == sorted(s, reverse=True), line
        checked = 0
        for row in np.random.default_rng(SEED + 2).choice(WAVE, 64, replace=False):
            got = lines[row]["prediction"]["itemScores"]
            items, scores = host_answer(U, V, int(users[row]), 10)
            np.testing.assert_allclose(
                [x["score"] for x in got], scores, rtol=RTOL, atol=1e-6
            )
            for j, (gi, wi) in enumerate(zip([x["item"] for x in got], items)):
                if gi != wi:  # only inside a near-tie of the host scores
                    nb = [scores[x] for x in (j - 1, j + 1) if 0 <= x < 10]
                    assert min(abs(scores[j] - x) for x in nb) <= RTOL * scores[j]
            checked += 1
        out["breakdown"] = wave_breakdown(storage, qfile)
        storage.close()
    out.update(
        {
            "instance": instance_id,
            "queries": n,
            "launches": launches,
            "rows_checked_vs_host": checked,
            "solo_queries": len(solo_users),
            "solo_ms": solo_ms,
            "last_kernel_shapes": topk.LAST_KERNEL_SHAPES.get("als.fused_topk"),
        }
    )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import predictionio_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(toolchain())
    cases, timings = kernel_phase()
    main_path = main_path_phase()
    emit(main_path)
    main_t = next(t for t in timings if t["shape"] == [WAVE, ML20M_ITEMS, 10, 10])
    normal = [c for c in cases if c["kind"] == "normal"]
    emit(
        {
            "kernels": [
                {
                    "name": "fused_topk",
                    "route": "cuda",
                    "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
                    "replaces": "predictionio_tpu/ops/topk.py:147",
                    "launches": main_path["launches"]["fused_topk"],
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "ids_equal": all(c["ids_equal"] for c in cases if c["kind"] != "normal"),
                    "near_tie_id_swaps": sum(c["near_tie_id_swaps"] for c in normal),
                    "ms": main_t["kernel_ms"],
                    "kernel_ms": main_t["kernel_ms"],
                    "plain_ms": main_t["plain_ms"],
                    "bound_ms": main_t["bound_ms"],
                    "bound_by": main_t["bound_by"],
                    "library_ms": main_t["library_ms"],
                    "shape": main_t["shape"],
                }
            ]
        }
    )
    print(nvidia_smi_line(), flush=True)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
