"""Chip smoke test of the PyTorch + CUDA port (``predictionio_tpu_torch``).

Run from the root of a checkout on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``predictionio_tpu_torch/csrc``
(nvcc, sm_90a, one process per source, into the git-ignored
``build/kernels/``), holds each kernel against its plain PyTorch version on
the card, then drives the port's main path through the entry points a user
calls:

- serving at the ML-20M shape: ``run_batch_predict`` over 4,096 queries
  (one fused top-k wave) and a threaded prediction server answering solo
  ``POST /queries.json`` requests;
- ``pio app new`` -> ``pio import`` -> ``pio train`` -> ``pio batchpredict``
  and solo queries on an event store at the ML-100K shape (the CLI verbs
  of ``predictionio_tpu_torch.tools.cli``), with the card's factors held
  against a CPU train from the same start;
- ``train_als`` on a stream at the ML-20M shape: 20 iterations fused, then
  3 forced chunked, each kernel held against its plain version there; then
  the OOM ladder (``auto`` under a cap of device memory between the two
  trains' peaks falls back from fused to chunked).

Every count of kernel launches is set to 0 just before each main-path
phase and read just after it.  It prints one JSON line per phase (every
correctness case, every timing and every main-path record), the ``kernels``
line, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.  Any failed phase raises and the script exits non-zero without
the last line.  Without CUDA, or without the package beside it, it exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import logging
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
ML20M_RATINGS = 20_000_263
#: the ML-100K shape, the one that goes through the event store and the
#: CLI (the ML-1M shape's 1,000,209 events take too long to import within
#: this script's time limit; PERF.md has that run)
ML100K_USERS, ML100K_ITEMS, ML100K_EVENTS = 943, 1_682, 100_000
ITERATIONS = 20  # the template's numIterations
WAVE = 4096
SEED = 20
RTOL = 1e-5  # random-normal inputs: cuBLAS sums in another order
#: ALS accumulators on random-normal inputs: |kernel - plain| within this
#: share of the entry's sum of absolute terms (the plain version adds with
#: atomics, in another order)
ALS_RTOL = 1e-4


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
            "per_source_s": built,
            "ptxas": {
                name: [
                    line for line in _kernels.build_log(name).splitlines()
                    if "registers" in line or "spill" in line
                ]
                for name in ("fused_topk", "als_fused_accum")
            },
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
        reset_launches()
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
        launches = read_launches()
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


# -- the ALS accumulators -----------------------------------------------------


def reset_launches() -> None:
    from predictionio_tpu_torch.ops import als_accum, topk

    for counts in (topk.KERNEL_LAUNCHES, als_accum.KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    from predictionio_tpu_torch.ops import als_accum, topk

    return {**topk.KERNEL_LAUNCHES, **als_accum.KERNEL_LAUNCHES}


def als_stream(kind: str, n: int, n_seg_pad: int, n_oth: int, k: int, rng,
               hot: int):
    """One direction's COO stream: segments below ``n_seg_pad - 128`` (the
    last block stays empty: an all-padding tile), ``hot`` rows on segment 3
    (a run over several tiles), factors and ratings exact (multiples of 1/8,
    half stars) or random normal."""
    seg = rng.integers(0, n_seg_pad - 128, n)
    seg[:hot] = 3
    oth = rng.integers(0, n_oth, n).astype(np.int32)
    if kind == "exact":
        factors = rng.integers(-8, 9, (n_oth, k)) / 8.0
        rating = rng.integers(1, 11, n) / 2.0
    else:
        factors = rng.standard_normal((n_oth, k))
        rating = rng.standard_normal(n)
    return seg, oth, rating.astype(np.float32), factors.astype(np.float32)


def hold(got, want, scale, exact: bool, what: str) -> float:
    """Bitwise on exact inputs, else within ALS_RTOL of the absolute sums;
    returns the largest difference."""
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    err = np.abs(got - want)
    if exact:
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            bad = np.argwhere(got.view(np.uint32) != want.view(np.uint32))
            raise AssertionError(f"{what}: not bitwise equal at {bad[:3].tolist()}")
    elif (err > ALS_RTOL * scale.cpu().numpy() + 1e-6).any():
        raise AssertionError(f"{what}: beyond {ALS_RTOL} of the absolute sums")
    return float(err.max())


def same_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{what}: a repeat run gave other bits")


def als_kernel_phase() -> list:
    """Both ALS kernels against their plain versions: ranks 6, 10, 17 and
    32, explicit and implicit, "highest" and "bf16", on a stream with an
    all-padding block and a segment over more than 3 tiles (the chunked
    one cut into 2-tile chunks, so blocks cross chunks); bitwise on exact
    inputs, within ALS_RTOL on random-normal ones, and a repeat run gives
    the same bits.  The streams are staged by ``ops.als._stage``, as
    ``train_als`` stages them."""
    from predictionio_tpu_torch.ops import als, als_accum

    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    n_seg_pad, n_oth, n, hot = 512, 300, 9000, 3500
    cases = []
    for kind in ("exact", "normal"):
        for k in (6, 10, 17, 32):
            seg, oth, rating, factors = als_stream(kind, n, n_seg_pad, n_oth, k, rng, hot)
            st = als._stage(seg, oth, rating, n_seg_pad, "fused", cuda)
            f = torch.from_numpy(factors).cuda()
            for implicit in (False, True):
                for precision in ("highest", "bf16"):
                    def run(fn, fac, rat):
                        wrv = als_accum.make_wrv(rat, st["val"], implicit, 1.5)
                        return fn(st["plan_args"], st["oth"], wrv, fac,
                                  st["plan"].n_blocks, precision)

                    got = run(als_accum.segment_stats_fused, f, st["rat"])
                    again = run(als_accum.segment_stats_fused, f, st["rat"])
                    want = run(als_accum.segment_stats_fused_plain, f, st["rat"])
                    scale = run(als_accum.segment_stats_fused_plain, f.abs(),
                                st["rat"].abs())
                    what = f"fused {kind} r{k} {'implicit' if implicit else 'explicit'} {precision}"
                    err = hold(got, want, scale, kind == "exact", what)
                    same_bits(got, again, what)
                    if got[-128:].any():
                        raise AssertionError(f"{what}: the empty block is not zero")
                    cases.append({"kernel": "als_fused_accum", "case": what,
                                  "max_abs_err": err})
        seg, oth, rating, factors = als_stream(kind, n, n_seg_pad, n_oth, RANK, rng, hot)
        st = als._stage(seg, oth, rating, n_seg_pad, "chunked", cuda,
                        tiles_per_chunk=2)
        f = torch.from_numpy(factors).cuda()
        for precision in ("highest", "bf16"):
            def chunked(fn, fac, rat):
                return fn(st["plan_args"], st["oth"], rat, st["val"], fac, True,
                          1.5, st["plan"].n_blocks, precision)

            got = chunked(als_accum.segment_stats_chunked, f, st["rat"])
            again = chunked(als_accum.segment_stats_chunked, f, st["rat"])
            want = chunked(als_accum.segment_stats_chunked_plain, f, st["rat"])
            scale = chunked(als_accum.segment_stats_chunked_plain, f.abs(),
                            st["rat"].abs())
            what = f"chunked {kind} r{RANK} implicit {precision}, {st['plan'].n_chunks} chunks"
            err = hold(got, want, scale, kind == "exact", what)
            same_bits(got, again, what)
            cases.append({"kernel": "als_segment_accum", "case": what,
                          "max_abs_err": err})
    emit({"phase": "als_kernel_vs_plain", "all_passed": True, "cases": cases})
    return cases


# -- training -----------------------------------------------------------------


def movielens_like(nnz: int, n_users: int, n_items: int, seed: int,
                   half_stars: bool):
    """Seeded ML-shaped ratings: Zipf item popularity (i+10)^-0.8, lognormal
    user activity, a planted rank-8 taste plus noise; half stars in
    [0.5, 5] (ML-20M) or whole stars in [1, 5] (ML-100K)."""
    rng = np.random.default_rng(seed)
    item_cdf = np.cumsum((np.arange(n_items) + 10.0) ** -0.8)
    user_cdf = np.cumsum(rng.lognormal(0.0, 1.0, n_users))
    u = np.searchsorted(user_cdf / user_cdf[-1], rng.random(nnz))
    i = np.searchsorted(item_cdf / item_cdf[-1], rng.random(nnz))
    u = np.minimum(u, n_users - 1).astype(np.int32)
    i = np.minimum(i, n_items - 1).astype(np.int32)
    uf = rng.standard_normal((n_users, 8)).astype(np.float32)
    vf = rng.standard_normal((n_items, 8)).astype(np.float32)
    raw = np.empty(nnz, np.float32)
    for lo in range(0, nnz, 1 << 22):
        sl = slice(lo, lo + (1 << 22))
        raw[sl] = 3.5 + 0.9 * (uf[u[sl]] * vf[i[sl]]).sum(1) / np.sqrt(8.0)
    raw += 0.4 * rng.standard_normal(nnz).astype(np.float32)
    if half_stars:
        r = np.clip(np.round(raw * 2.0) / 2.0, 0.5, 5.0)
    else:
        r = np.clip(np.round(raw), 1.0, 5.0)
    return u, i, r.astype(np.float32)


def rmse(U: torch.Tensor, V: torch.Tensor, u, i, r) -> float:
    """Training RMSE on the card, a slice of ratings at a time."""
    total = 0.0
    for lo in range(0, len(r), 1 << 22):
        uu = torch.from_numpy(u[lo:lo + (1 << 22)].astype(np.int64)).to(U.device)
        ii = torch.from_numpy(i[lo:lo + (1 << 22)].astype(np.int64)).to(U.device)
        rr = torch.from_numpy(r[lo:lo + (1 << 22)]).to(U.device)
        total += float(((U[uu] * V[ii]).sum(1) - rr).square().sum())
    return float(np.sqrt(total / len(r)))


class _Stages(logging.Handler):
    """Collects the DASE stage breakdown that ``run_train`` logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages: dict = {}

    def emit(self, record):
        if hasattr(record, "stages"):
            self.stages = dict(record.stages)


def check_wave_lines(lines, users, host, rows) -> int:
    """Scores of a wave's rows against the host answer (rtol), ids only
    inside a near-tie of the host scores."""
    for row in rows:
        got = lines[row]["prediction"]["itemScores"]
        items, scores = host(users[row])
        np.testing.assert_allclose(
            [x["score"] for x in got], scores, rtol=RTOL, atol=1e-6
        )
        for j, (gi, wi) in enumerate(zip([x["item"] for x in got], items)):
            if gi != wi:
                nb = [scores[x] for x in (j - 1, j + 1) if 0 <= x < len(scores)]
                assert min(abs(scores[j] - x) for x in nb) <= RTOL * abs(scores[j])
    return len(rows)


def train_cli_phase() -> dict:
    """The template's own flow through the port's CLI on an ML-100K-shaped
    event store: app new -> import -> train (rank 10, 20 iterations, CUDA)
    -> batchpredict (4,096 queries, one fused top-k wave) and 8 solo HTTP
    queries, all checked against the host answer of the trained factors;
    then the same train on the card and on the CPU from one start."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.topk import host_topk
    from predictionio_tpu_torch.server.prediction_server import create_prediction_server
    from predictionio_tpu_torch.tools import cli

    out: dict = {"phase": "train_cli",
                 "shape": [ML100K_USERS, ML100K_ITEMS, ML100K_EVENTS],
                 "rank": RANK, "iterations": ITERATIONS}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        storage = reset_storage(
            StorageConfig.from_env({"PIO_HOME": str(tmp / "pio_home")})
        )
        t0 = time.perf_counter()
        u, i, r = movielens_like(ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS,
                                 SEED + 10, half_stars=False)
        t_base = 874_724_710  # ML-100K's first rating time, epoch seconds
        with open(tmp / "ratings.jsonl", "w") as f:
            for j in range(ML100K_EVENTS):
                ts = datetime.fromtimestamp(t_base + j, tz=timezone.utc)
                f.write(
                    '{"event":"rate","entityType":"user","entityId":"u%d",'
                    '"targetEntityType":"item","targetEntityId":"i%d",'
                    '"properties":{"rating":%d},"eventTime":"%s"}\n'
                    % (u[j], i[j], r[j], ts.strftime("%Y-%m-%dT%H:%M:%S.000Z"))
                )
        out["generate_s"] = time.perf_counter() - t0
        (tmp / "engine.json").write_text(json.dumps({
            "id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"appName": "ml100k"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS, "lambda": 0.01,
                "seed": 3}}],
        }))
        stages = _Stages()
        wf_log = logging.getLogger("predictionio_tpu_torch.workflow")
        wf_log.setLevel(logging.INFO)
        wf_log.addHandler(stages)
        printed = io.StringIO()

        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["app", "new", "ml100k"]) == 0
            t0 = time.perf_counter()
            assert cli.main(["import", "--app", "ml100k", "--input",
                             str(tmp / "ratings.jsonl")]) == 0
            out["import_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            assert cli.main(["train", "--engine-json", str(tmp / "engine.json"),
                             "--device", "cuda"]) == 0
            out["train_cli_s"] = time.perf_counter() - t0
            train_launches = read_launches()
            staging_s = als.LAST_PLAN_INFO["stage_s"]
            known = sorted(
                {f"u{x}" for x in u}, key=lambda s: int(s[1:])
            )
            qusers = np.random.default_rng(SEED + 11).choice(known, WAVE)
            (tmp / "q.jsonl").write_text("".join(
                json.dumps({"user": str(x), "num": 10}) + "\n" for x in qusers
            ))
            t0 = time.perf_counter()
            assert cli.main(["batchpredict", "--engine", "recommendation",
                             "--input", str(tmp / "q.jsonl"),
                             "--output", str(tmp / "p.jsonl"),
                             "--device", "cuda"]) == 0
            torch.cuda.synchronize()
            out["batchpredict_s"] = time.perf_counter() - t0
        server = create_prediction_server(
            "recommendation", host="127.0.0.1", port=0, storage=storage
        ).start_background()
        solo = []
        try:
            base = f"http://127.0.0.1:{server.port}"
            for x in qusers[:8]:
                req = urllib.request.Request(
                    base + "/queries.json",
                    data=json.dumps({"user": str(x), "num": 10}).encode(),
                )
                t1 = time.perf_counter()
                solo.append((x, json.loads(urllib.request.urlopen(req, timeout=30).read())))
                out.setdefault("solo_ms", []).append(1e3 * (time.perf_counter() - t1))
        finally:
            server.shutdown()
        launches = read_launches()
        # -- end of the main path --

        wf_log.removeHandler(stages)
        instance_id = printed.getvalue().split("Engine instance: ")[1].split()[0]
        record = storage.engine_instances().get(instance_id)
        assert record.status == "COMPLETED", record.status
        (blob,) = load_models(storage.models(), instance_id)
        U, V = blob["user_factors"], blob["item_factors"]
        assert np.isfinite(U).all() and np.isfinite(V).all()
        uvocab = {k: n for n, k in enumerate(blob["user_vocab"])}
        ivocab = list(blob["item_vocab"])

        def host(user):
            s, idx = host_topk(V @ U[uvocab[str(user)]], 10)
            return [ivocab[j] for j in idx], [float(x) for x in s]

        for x, got in solo:
            items, scores = host(x)
            assert [g["item"] for g in got["itemScores"]] == items, x
            assert [g["score"] for g in got["itemScores"]] == scores, x
        lines = [json.loads(x) for x in (tmp / "p.jsonl").read_text().splitlines()]
        assert len(lines) == WAVE
        rows = np.random.default_rng(SEED + 12).choice(WAVE, 64, replace=False)
        out["rows_checked_vs_host"] = check_wave_lines(lines, qusers, host, rows)
        assert train_launches["als_fused_accum"] == 2 * ITERATIONS, train_launches
        assert launches["fused_topk"] > 0, launches

        # the same train on the card and on the CPU, from one start
        ctx = EngineContext(storage=storage, device="cuda")
        td = rec.RatingsDataSource(rec.DataSourceParams(app_name="ml100k")).read_training(ctx)
        pd = rec.RatingsPreparator().prepare(ctx, td)
        nu, ni = len(pd.user_vocab), len(pd.item_vocab)
        start = np.random.default_rng(SEED + 13)
        init = tuple(
            (np.abs(start.standard_normal((n, RANK))) / np.sqrt(RANK)).astype(np.float32)
            for n in (nu, ni)
        )
        p5 = als.ALSParams(rank=RANK, num_iterations=5)
        card = als.train_als(pd.user_idx, pd.item_idx, pd.ratings, nu, ni, p5,
                             device="cuda", init_factors=init)
        cpu = als.train_als(pd.user_idx, pd.item_idx, pd.ratings, nu, ni, p5,
                            device="cpu", init_factors=init)
        diff = max(
            float((card.user_factors.cpu() - cpu.user_factors).abs().max()),
            float((card.item_factors.cpu() - cpu.item_factors).abs().max()),
        )
        assert diff <= 2e-3, f"card vs CPU factors differ by {diff}"
        out["card_vs_cpu_max_abs_diff"] = diff
        out["rmse_train"] = rmse(
            torch.from_numpy(U).cuda(), torch.from_numpy(V).cuda(),
            pd.user_idx, pd.item_idx, pd.ratings,
        )
        storage.close()
    st = stages.stages
    out.update(
        instance=instance_id,
        ratings_read=int(len(td.ratings)),
        stage_s={
            "import": out["import_s"],
            "read": st["datasource.read"],
            "prepare": st["preparator.prepare"],
            "staging": staging_s,
            "train_iterations": st["algorithm.als"] - staging_s,
            "persist": st["persist.save_models"],
            "total": st["total"],
        },
        launches=launches,
        train_launches=train_launches,
    )
    return out


def profile_idle(fn) -> tuple[float, float, dict]:
    """(host seconds, device idle share, device ms by kernel) of ``fn``
    under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_ms: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            device_ms[e.key] = device_ms.get(e.key, 0.0) + us / 1e3
    busy = sum(device_ms.values())
    return wall, 1.0 - busy / (1e3 * wall) if device_ms else None, device_ms


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def fused_timing(staged: dict, other: torch.Tensor, p) -> dict:
    """Kernel 1 at the ML-20M half-step: checked against its plain version
    on the same inputs, then timed beside it and held against its bound.
    No single PyTorch call computes it, so library_ms is null."""
    from predictionio_tpu_torch.ops import als_accum

    plan = staged["plan"]
    args = (staged["plan_args"], staged["oth"], staged["wrv"], other, plan.n_blocks)
    got = als_accum.segment_stats_fused(*args, p.pallas_precision)
    want = als_accum.segment_stats_fused_plain(*args, p.pallas_precision)
    scale = als_accum.segment_stats_fused_plain(
        staged["plan_args"], staged["oth"], staged["wrv"].abs(), other.abs(),
        plan.n_blocks, p.pallas_precision,
    )
    err = hold(got, want, scale, False, "fused at the ML-20M shape")
    valid = int((staged["plan"].seg3 >= 0).sum())
    work = als_accum.als_accum_least_work(
        plan.padded_len, p.rank, plan.n_blocks * 128, other.shape[0], valid
    )
    bytes_s, ops_s = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / FP32_FLOPS_PER_S
    return {
        "shape": [plan.padded_len, p.rank, plan.n_blocks * 128, other.shape[0]],
        "valid_rows": valid,
        "max_abs_err": err,
        "ms": time_ms(lambda: als_accum.segment_stats_fused(*args, p.pallas_precision)),
        "plain_ms": time_ms(
            lambda: als_accum.segment_stats_fused_plain(*args, p.pallas_precision),
            launches=2, repeats=3,
        ),
        "library_ms": None,
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def chunk_timing(staged: dict, other: torch.Tensor, p) -> dict:
    """Kernel 2 on the first chunk of the ML-20M half-step: the chunk's
    rows built as ``segment_stats_chunked`` builds them; checked against
    its plain version, timed beside it and beside one ``index_add_`` call
    (padding rows into a spare output row)."""
    from predictionio_tpu_torch.ops import als_accum
    from predictionio_tpu_torch.ops.als import confidence_weights

    plan = staged["plan"]
    # the chunked streams are in host memory: upload the first chunk
    bm, seg3, oth, rat, val = (
        x[0].to(other.device)
        for x in (*staged["plan_args"], staged["oth"], staged["rat"], staged["val"])
    )
    width = als_accum.row_width(p.rank)
    n_seg = plan.n_blocks * 128
    w, rhs = confidence_weights(rat, val, False, 1.0)
    rows = als_accum._flat_rows(other[oth.long()], w, rhs, val, width)

    def fresh():
        return torch.zeros((n_seg, width), device=other.device)

    got = als_accum.segment_accum(fresh(), bm, seg3, rows, p.pallas_precision)
    want = als_accum.segment_accum_plain(fresh(), bm, seg3, rows, p.pallas_precision)
    scale = als_accum.segment_accum_plain(fresh(), bm, seg3, rows.abs(), p.pallas_precision)
    err = hold(got, want, scale, False, "chunk at the ML-20M shape")
    g = als_accum._global_seg(bm, seg3)
    g = torch.where(g >= 0, g, n_seg)
    spare = torch.zeros((n_seg + 1, width), device=other.device)
    acc = fresh()
    valid = int((plan.seg3[0] >= 0).sum())
    # the running output is read and written only for the touched blocks
    touched = int(np.unique(plan.block_map[0]).size) * 128
    work = als_accum.segment_accum_least_work(rows.shape[0], width, touched, valid)
    bytes_s, ops_s = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / FP32_FLOPS_PER_S
    return {
        "shape": [rows.shape[0], width, n_seg],
        "valid_rows": valid,
        "segments_touched": touched,
        "max_abs_err": err,
        "ms": time_ms(lambda: als_accum.segment_accum(acc, bm, seg3, rows)),
        "plain_ms": time_ms(
            lambda: als_accum.segment_accum_plain(acc, bm, seg3, rows),
            launches=2, repeats=3,
        ),
        "library_ms": time_ms(lambda: spare.index_add_(0, g, rows)),
        "bound_ms": 1e3 * max(bytes_s, ops_s),
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
    }


def half_step_ms(staged: dict, other: torch.Tensor, p, mode: str) -> dict:
    """Device time of a half-step's accumulate and solve (CUDA events), and
    the host time of one call of each with the card idle before it: a call
    whose host time is near its device time keeps the host waiting."""
    from predictionio_tpu_torch.ops import als

    acc = als.accumulate(staged, other, p, mode)
    out = {
        "accumulate_ms": time_ms(lambda: als.accumulate(staged, other, p, mode),
                                 launches=3, repeats=5),
        "solve_ms": time_ms(lambda: als.solve(acc, other, p), launches=3, repeats=5),
    }
    for name, fn in (("accumulate", lambda: als.accumulate(staged, other, p, mode)),
                     ("solve", lambda: als.solve(acc, other, p))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out[f"{name}_host_ms"] = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return out


def fresh_peak() -> tuple[int, int]:
    """Drop the staging cache and the allocator's free blocks, and start a
    new peak reading; returns the bytes still allocated and reserved."""
    from predictionio_tpu_torch.ops import als

    als._STAGE_CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def peak_since(base: tuple[int, int]) -> dict:
    """The peak of allocated bytes over ``base`` (what the run needed) and
    the peak growth of reserved bytes (what a memory cap limits: free space
    left inside partly used segments is reused before the cap is met)."""
    return {"allocated": torch.cuda.max_memory_allocated() - base[0],
            "reserved_growth": torch.cuda.max_memory_reserved() - base[1]}


def oom_ladder(u, i, r, p3, fused: dict, chunked: dict, want) -> dict:
    """The mode ladder on the card: with this process's reserved memory
    capped halfway between the chunked and the fused trains' growths,
    ``auto`` takes fused, runs out of device memory, warns and trains
    chunked, to the factors of the forced-chunked train."""
    import warnings

    from predictionio_tpu_torch.ops import als

    for key in ("allocated", "reserved_growth"):
        if not chunked[key] < 0.8 * fused[key]:
            raise AssertionError(
                f"the chunked rung peaks at {chunked} on the card and fused at "
                f"{fused}: chunked does not need less"
            )
    base = fresh_peak()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = base[1] + (fused["reserved_growth"] + chunked["reserved_growth"]) // 2
    pa = dataclasses.replace(p3, pallas_mode="auto")
    torch.cuda.set_per_process_memory_fraction(cap / total, 0)
    try:
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            st = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, pa, device="cuda")
            seconds = time.perf_counter() - t0
        launches = read_launches()
        # -- end --
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, 0)
    diff = max(
        float((st.user_factors - want.user_factors).abs().max()),
        float((st.item_factors - want.item_factors).abs().max()),
    )
    out = {"cap_bytes": cap, "base_allocated_bytes": base[0],
           "base_reserved_bytes": base[1], "peak": peak_since(base),
           "mode": als.LAST_PLAN_INFO["mode"], "seconds": seconds,
           "warnings": [str(w.message) for w in caught], "launches": launches,
           "max_abs_diff_vs_chunked": diff}
    assert any("retrying as chunked" in m for m in out["warnings"]), out
    assert out["mode"] == "chunked", out
    assert launches["als_segment_accum"] > 0, out
    assert diff <= 1e-5, out
    als._STAGE_CACHE.clear()
    return out


def train_ml20m_phase() -> tuple[dict, dict, dict]:
    """``train_als`` at the ML-20M shape: 20 iterations fused (cold, then
    warm under torch.profiler), then 3 forced chunked, each cold train's
    peak of device memory, then the OOM ladder between them; per half-step
    accumulate and solve times, staging, idle share, RMSE, and each
    kernel checked and timed at this shape."""
    from predictionio_tpu_torch.ops import als

    out: dict = {"phase": "train_ml20m",
                 "shape": [ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS],
                 "rank": RANK, "iterations": ITERATIONS}
    t0 = time.perf_counter()
    u, i, r = movielens_like(ML20M_RATINGS, ML20M_USERS, ML20M_ITEMS, SEED + 20,
                             half_stars=True)
    out["generate_s"] = time.perf_counter() - t0
    p = als.ALSParams(rank=RANK, num_iterations=ITERATIONS, pallas_mode="fused")
    nu_pad = (ML20M_USERS + 127) // 128 * 128
    ni_pad = (ML20M_ITEMS + 127) // 128 * 128
    U0, V0 = als._init_factors(p, nu_pad, ni_pad, ML20M_USERS, ML20M_ITEMS, "cuda")

    base = fresh_peak()
    # -- the main path, fused, with every launch count at 0 just before it --
    reset_launches()
    t0 = time.perf_counter()
    st = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p, device="cuda")
    out["cold_train_s"] = time.perf_counter() - t0
    out["fused_launches"] = read_launches()
    # -- end --
    out["fused_peak"] = peak_since(base)
    out["stage_s"] = als.LAST_PLAN_INFO["stage_s"]
    out["plan"] = {k: v for k, v in als.LAST_PLAN_INFO.items() if k != "stage_s"}
    assert out["fused_launches"]["als_fused_accum"] == 2 * ITERATIONS
    warm_s, idle, device_ms = profile_idle(
        lambda: als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p, device="cuda")
    )
    out["warm_train_s"] = warm_s
    out["per_iteration_s"] = warm_s / ITERATIONS
    out["device_idle_share"] = idle
    out["device_ms_by_kernel"] = dict(
        sorted(device_ms.items(), key=lambda kv: -kv[1])[:12]
    )
    out["rmse"] = {
        "init": rmse(U0, V0, u, i, r),
        "fused_20": rmse(st.user_factors, st.item_factors, u, i, r),
    }
    su, si = next(iter(als._STAGE_CACHE.values()))
    Up, Vp = pad_rows(st.user_factors, nu_pad), pad_rows(st.item_factors, ni_pad)
    out["half_step_user"] = half_step_ms(su, Vp, p, "fused")
    out["half_step_item"] = half_step_ms(si, Up, p, "fused")
    fused_t = fused_timing(su, Vp, p)
    del su, si

    # -- the main path, chunked, with every launch count at 0 just before it --
    p3 = dataclasses.replace(p, num_iterations=3, pallas_mode="chunked")
    base = fresh_peak()
    reset_launches()
    t0 = time.perf_counter()
    st3 = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p3, device="cuda")
    out["chunked_train_s"] = time.perf_counter() - t0
    out["chunked_launches"] = read_launches()
    # -- end --
    out["chunked_peak"] = peak_since(base)
    out["chunked_plan"] = {k: v for k, v in als.LAST_PLAN_INFO.items() if k != "stage_s"}
    chunks = als.LAST_PLAN_INFO["chunks_user"] + als.LAST_PLAN_INFO["chunks_item"]
    assert out["chunked_launches"]["als_segment_accum"] == 3 * chunks
    out["rmse"]["chunked_3"] = rmse(st3.user_factors, st3.item_factors, u, i, r)
    rm = out["rmse"]
    assert all(np.isfinite(list(rm.values())))
    assert rm["fused_20"] < rm["chunked_3"] < rm["init"], rm
    cu, ci = next(iter(als._STAGE_CACHE.values()))
    out["chunked_half_step_user"] = half_step_ms(cu, Vp, p3, "chunked")
    chunk_t = chunk_timing(cu, Vp, p3)
    del cu, ci
    out["oom_ladder"] = oom_ladder(u, i, r, p3, out["fused_peak"],
                                   out["chunked_peak"], st3)
    return out, fused_t, chunk_t


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
    als_cases = als_kernel_phase()
    main_path = main_path_phase()
    emit(main_path)
    cli_train = train_cli_phase()
    emit(cli_train)
    ml20m, fused_t, chunk_t = train_ml20m_phase()
    emit(ml20m)
    emit({"phase": "als_kernel_timing", "als_fused_accum": fused_t,
          "als_segment_accum": chunk_t})
    main_t = next(t for t in timings if t["shape"] == [WAVE, ML20M_ITEMS, 10, 10])
    normal = [c for c in cases if c["kind"] == "normal"]

    def als_row(name, replaces, launches, t, **extra):
        errs = [c["max_abs_err"] for c in als_cases if c["kernel"] == name]
        return {
            "name": name,
            "route": "cuda",
            "source": "predictionio_tpu_torch/csrc/als_accum.cu",
            "replaces": replaces,
            "launches": launches,
            **extra,
            "max_abs_err": max(errs + [t["max_abs_err"]]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": t["shape"],
        }

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
                },
                # launches: the ML-100K `pio train` through the CLI; times at
                # the ML-20M user half-step, rank 10; no single PyTorch call
                # computes the fused accumulation (library_ms null)
                als_row(
                    "als_fused_accum", "predictionio_tpu/ops/als_pallas.py:204",
                    cli_train["launches"]["als_fused_accum"], fused_t,
                    launches_ml20m=ml20m["fused_launches"]["als_fused_accum"],
                ),
                # launches: the ML-20M chunked train (3 iterations); times
                # on its first user chunk; library_ms: one index_add_
                als_row(
                    "als_segment_accum", "predictionio_tpu/ops/als_pallas.py:112",
                    ml20m["chunked_launches"]["als_segment_accum"], chunk_t,
                ),
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
