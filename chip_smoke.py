"""Chip smoke test of the PyTorch + CUDA port (``predictionio_tpu_torch``).

Run from the root of a checkout on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``predictionio_tpu_torch/csrc``
(nvcc, sm_90a, one process per source, into the git-ignored
``build/kernels/``), holds each kernel against its plain PyTorch version on
the card, then drives the port's main path through the entry points a user
calls:

- serving at the ML-20M shape: ``run_batch_predict`` over 4,096 queries
  (one fused top-k wave), and the default deploy (the asyncio front end and
  the micro-batcher) and the threaded server answering solo
  ``POST /queries.json`` requests; then
  a 4,096-query wave with num=200, past the fused menu, answered on the
  card by the full-row route;
- the serving front end at the ML-20M shape: 64 keep-alive clients
  sending 4,096 queries to the default deploy (``serve_concurrent``), a
  4,096-query burst through a micro-batcher of 1,024-query device waves
  with pipelined fences (``pipelined_waves``), and ``POST /reload`` to a
  second instance under traffic, with the old generation's device memory
  freed (``reload``); then the observability layer (``observability``):
  a deploy with an access key at the engine's device floor, a 64-client
  HTTP burst (host waves) and a burst queued past the floor (1,024-query
  device waves through kernel 3), every observability route scraped and
  held (roofline shares from the launcher's CUDA events, wave splits,
  transfer tallies, memory gauges, request ids, probes, a
  ``torch.profiler`` capture against the events), and solo queries on a
  warmed keep-alive connection to each front end (``solo_cost``), read
  with serve_concurrent as the serving paths' cost (``layer_cost``);
- ``pio app new`` -> ``pio import`` -> ``pio train`` -> ``pio batchpredict``
  and solo queries on an event store at the ML-100K shape (the CLI verbs
  of ``predictionio_tpu_torch.tools.cli``), with the card's factors held
  against a CPU train from the same start;
- ``train_als`` on a stream at the ML-20M shape: 20 iterations fused, then
  3 forced chunked, each kernel held against its plain version there (the
  chunk kernel timed at widths 128 and 1,152, and a chunked user
  half-step split by kind of device work); then the OOM
  ladder (``auto`` under a cap of device memory between the two trains'
  peaks falls back from fused to chunked);
- the ALS family: ``ECommAlgorithm.train`` (implicit ALS) on a view/buy
  stream at the ML-20M shape, kernel 1 held to its plain version on the
  implicit stream (``als_family_train``); that model through the default
  deploy, its business rules reading a live event store, solo queries on
  each route and 16 keep-alive clients, every answer held to a plain CPU
  answer, and a similarproduct model at the ML-20M item width
  (``als_family_serving``); ``app new`` -> ``import`` -> ``train`` ->
  deploy of an ecommerce and a similarproduct (``als`` + ``cooccurrence``)
  engine at the ML-100K shape, the card's factors held to a CPU train from
  one start (``als_family_cli``);
- event ingest (``event_ingest``): ``pio eventserver`` as a subprocess fed
  the ML-100K stream over REST by 8 client threads (batches of 50, then
  single events and both webhooks), ``pio export`` equal to what was sent,
  the ingest gate shedding 503s, ``pio train`` on the card over the
  ingested events held to a train of the same events by ``pio import``,
  ``pio batchpredict`` of every user in one fused top-k wave, and ``pio
  deploy --event-port`` of an ecommerce engine whose next answer leaves out
  an item just viewed through its event port; the event server's
  ``/metrics`` counting every accepted event, its ``/readyz``, and no CUDA
  context in it.  ``train_ml20m`` also reads ``als.pallas_step``'s share
  on ``/efficiency.json``'s yardstick beside kernel 1's CUDA-event time;
- ``pio eval`` (``eval``, on ``train_cli``'s ML-100K store): an evaluation
  module written into the phase's directory sweeps the recommendation
  template (ranks 8 and 10, regs 0.01 and 0.1, 5 folds; Precision@10 and
  PositiveCount) through the CLI, plainly and through ``FastEvalEngine``,
  with the same result and an EVALCOMPLETED instance each; kernel 1 trains
  every fold, kernel 3 answers every fold wave of 512+ known test users;
- the NCF template at the ML-20M shape (``ncf_train``): the defaults
  (bpr, MLP (64, 32, 16), 5 epochs) with each epoch's seconds and loss, the
  step time and idle share of a steady window, one step held to the CPU's;
  then the pretraining recipe (implicit ALS at rank 32 through kernel 1, 40
  launches, then one full_softmax epoch), kernel 1 held and timed on that
  stream; that first model through the default deploy (``ncf_serving``):
  solo queries per front end (the threaded server's host replica held to
  the numpy answer exactly), a 4,096-query burst in device waves of 32 and
  a 4,096-query ``run_batch_predict``, held to the host answer;
- the classification template (``classification``): ``ops/classifiers.py``
  at the UCI Covertype shape (581,012 x 54, 7 classes, a seeded generator)
  on the card, Naive Bayes and 200 logistic-regression steps each trained
  twice to the same bits and held to the CPU; then ``app new`` ->
  ``import`` of 100,000 users' ``$set`` events -> ``train`` -> the default
  deploy answering 1,000 queries from 8 clients, each held to a host numpy
  Naive Bayes over the persisted blob, and ``pio eval`` of the template's
  lambda sweep, plainly and through ``FastEvalEngine``, with the same JSON;
- the generation store (``generations``) on ``write_model``'s ML-20M
  models: a checksum-verified ``/reload`` under 16 clients (the retired
  generation's device memory freed) and a 1,024-query device wave through
  kernel 3 from the new generation; a corrupt candidate refused with 409
  while the old one serves; restarts binding the manifest's live
  generation, then walking back past a corrupt one; and a CLI deploy
  SIGKILLed while stalled at the ``lifecycle.swap`` fault seam, restarting
  on the committed generation with the same answers.

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
import http.client
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
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
    elif kind == "rising":
        # score of row j = q[:, 0] * j, exact and rising along the table:
        # every row beats the running k-th entry, every queue overflows
        q = np.zeros((b, r))
        q[:, 0] = rng.integers(1, 9, b) / 8.0
        t = np.zeros((n, r))
        t[:, 0] = np.arange(n)
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


def ptxas_by_kernel(name: str) -> dict:
    """``nvcc -Xptxas -v``'s registers and spills for each kernel (mangled
    name) of the source that holds kernel ``name``."""
    from predictionio_tpu_torch.ops import _kernels

    out, entry = {}, None
    for line in _kernels.build_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split("info    :")[-1].strip())
    return out


def kernel_phase() -> tuple[list, list]:
    from predictionio_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    emit(
        {
            "phase": "build",
            "seconds": time.perf_counter() - t0,
            "per_source_s": built,
            "ptxas": {name: ptxas_by_kernel(name)
                      for name in ("fused_topk", "als_fused_accum")},
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
        # a rank past 32 and k at the menu's top; k and r neither a multiple
        # of 32 nor of 4; scores that rise along the table (queue overflow)
        {"name": "exact r64 k128", "kind": "exact", "shape": [1024, ML20M_ITEMS, 64, 128]},
        {"name": "exact r33 k100", "kind": "exact", "shape": [512, ML20M_ITEMS, 33, 100]},
        {"name": "exact r130 k64", "kind": "exact", "shape": [256, ML20M_ITEMS, 130, 64]},
        {"name": "rising k128", "kind": "rising", "shape": [WAVE, ML20M_ITEMS, 10, 128]},
        {"name": "rising k1", "kind": "rising", "shape": [512, ML20M_ITEMS, 10, 1]},
        # one block of 32 queries: every queue is due after every tile
        {"name": "rising 32 k64", "kind": "rising", "shape": [32, ML20M_ITEMS, 10, 64]},
    ]
    results = [check_case(c, rng) for c in cases]
    emit({"phase": "kernel_vs_plain", "all_passed": True, "cases": results})
    # the main and wide shapes, two that split the wide one's time between
    # scoring (r=32, k=10) and selection (r=10, k=128), and the two smallest
    # device waves (512 and 1,024 queries: blocks of 8 and of 32 queries)
    timings = [
        time_case(b, n, r, k, rng)
        for b, n, r, k in (
            (512, ML20M_ITEMS, 10, 10),
            (1024, ML20M_ITEMS, 10, 10),
            (WAVE, ML20M_ITEMS, 10, 10),
            (WAVE, ML20M_ITEMS, 32, 128),
            (WAVE, ML20M_ITEMS, 32, 10),
            (WAVE, ML20M_ITEMS, 10, 128),
        )
    ]
    emit({"phase": "kernel_timing", "timings": timings})
    emit({"phase": "kernel_launch_shapes", "timings": launch_shape_sweep(rng)})
    emit({"phase": "kernel_breakdown", "shapes": kernel_breakdown(rng)})
    return results, timings


def kernel_breakdown(rng) -> list:
    """Where the fused top-k's time goes at the smallest device wave, the
    main shape and the wide one: device time per kernel (pass 1, pass 2)
    from ``torch.profiler`` over 20 launches, and the host time per call
    of ``fused_topk_batch`` (geometry, allocation, launch) without a sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.ops.topk import fused_topk_batch

    out = []
    for b, r, k in ((512, 10, 10), (WAVE, 10, 10), (WAVE, 32, 128)):
        q, t = make_inputs("normal", b, ML20M_ITEMS, r, rng)
        for _ in range(3):
            fused_topk_batch(q, t, k, name="chip_smoke")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fused_topk_batch(q, t, k, name="chip_smoke")
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fused_topk_batch(q, t, k, name="chip_smoke")
            torch.cuda.synchronize()
        device_us = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                device_us[e.key] = device_us.get(e.key, 0.0) + us / 20
        out.append({"shape": [b, ML20M_ITEMS, r, k], "host_us_per_call": host_us,
                    "device_us_per_call": device_us})
    return out


def launch_shape_sweep(rng) -> list:
    """Variants of the fused top-k's launch shape, timed beside the one
    ``fused_topk_batch`` picks (not on the main path): each wave size with
    blocks of 8 and of 32 queries, and N cut for 2, 4 or 8 pass-1 CTAs per
    SM.  ``topk.SMALL_WAVE``, ``topk.WIDE_K`` and ``topk.CTAS_PER_SM`` are
    read from it."""
    from predictionio_tpu_torch.ops import topk

    out = []
    for b, r, k in ((512, 10, 10), (1024, 10, 10), (1536, 10, 10),
                    (WAVE, 10, 10), (WAVE, 10, 64), (WAVE, 10, 128),
                    (WAVE, 32, 128)):
        q, t = make_inputs("normal", b, ML20M_ITEMS, r, rng)
        picked = topk.cuda_geometry(b, ML20M_ITEMS, r, k, q.device)
        sms = topk.card_limits(q.device).sm_count
        for qpc in topk.QUERY_BLOCKS:
            geo = topk.cuda_geometry(b, ML20M_ITEMS, r, k, q.device, qpc=qpc)
            for per_sm in (2, 4, 8):
                splits = min(geo["n_tiles"], max(1, per_sm * sms // geo["n_qblocks"]))
                tiles = -(-geo["n_tiles"] // splits)
                g = dict(geo, n_splits=-(-geo["n_tiles"] // tiles),
                         rows_per_split=tiles * topk.TILE_ROWS_CUDA)
                out.append({
                    "shape": [b, ML20M_ITEMS, r, k],
                    "queries_per_cta": qpc,
                    "ctas_per_sm_aimed": per_sm,
                    "n_splits": g["n_splits"],
                    "picked": (qpc, g["n_splits"])
                    == (picked["queries_per_cta"], picked["n_splits"]),
                    "ms": time_ms(lambda: topk.fused_topk_cuda(q, t, k, ML20M_ITEMS, g)),
                })
    return out


def write_model(storage, home: Path, exact: bool = False, seed: int = SEED
                ) -> tuple[str, np.ndarray, np.ndarray]:
    """A seeded ALS model at the ML-20M shape, persisted as a COMPLETED
    engine instance through the port's storage and save_models (factors as
    ops/als.py initializes them: abs(normal) / sqrt(rank); or, ``exact``,
    integers in [1, 8] over 8, whose scores are exact in fp32 and tie
    often)."""
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithmParams,
        DataSourceParams,
    )

    rng = np.random.default_rng(seed)
    U = (np.abs(rng.standard_normal((ML20M_USERS, RANK))) / np.sqrt(RANK)).astype(
        np.float32
    )
    V = (np.abs(rng.standard_normal((ML20M_ITEMS, RANK))) / np.sqrt(RANK)).astype(
        np.float32
    )
    if exact:
        U = (rng.integers(1, 9, U.shape) / 8.0).astype(np.float32)
        V = (rng.integers(1, 9, V.shape) / 8.0).astype(np.float32)
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
    """The host replica's answer for one user, as it computes a wave of one
    query (the micro-batched server's solo answer): a one-row product and
    the batched host top-k."""
    from predictionio_tpu_torch.ops.topk import host_topk_batch

    s, i = host_topk_batch(U[[user]] @ V.T, num)
    return [f"i{j}" for j in i[0]], [float(x) for x in s[0]]


def host_solo_answer(U, V, user: int, num: int) -> tuple[list, list]:
    """The host replica's answer for one user as ``ALSAlgorithm.predict``
    computes it (the threaded server's answer): ``V @ U[user]`` and the
    one-row host top-k."""
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
        solo_users = [int(u) for u in users[:8]]
        solo_ms: dict = {}
        # the default deploy answers a solo query as a micro-batched wave of
        # one; the threaded server through ``ALSAlgorithm.predict``
        for kind, answer in (("aio", host_answer), ("threaded", host_solo_answer)):
            server = create_prediction_server(
                "recommendation", host="127.0.0.1", port=0, storage=storage,
                server_kind=kind,
            ).start_background()
            solo_ms[kind] = []
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
                    solo_ms[kind].append(1e3 * (time.perf_counter() - t1))
                    items, scores = answer(U, V, u, 10)
                    assert [s["item"] for s in got["itemScores"]] == items, (kind, u)
                    assert [s["score"] for s in got["itemScores"]] == scores, (kind, u)
                stop = urllib.request.Request(base + "/stop", method="POST")
                urllib.request.urlopen(stop, timeout=30).read()
                server._thread.join(timeout=30)
                assert not server._thread.is_alive(), f"{kind} server did not stop"
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


OFF_MENU_NUM = 200  # past the fused menu's k <= 128


def off_menu_phase() -> dict:
    """A 4,096-query wave with num=200 through ``run_batch_predict`` on a
    CUDA model at the ML-20M shape: answered on the card by the full-row
    route (score row + stable sort, a slice of queries at a time), counted
    in ``FULL_ROW_FALLBACKS``, no kernel launched, and the fused kernel's
    plain version not called.  Exact factors, so 512 sampled rows must
    equal ``fused_topk_plain`` on the CPU, ids and scores bit for bit.
    Then the route alone on 512 random-normal queries: within rtol 1e-5 of
    the plain version on the CPU (TF32 products would miss by ~1e-3)."""
    from predictionio_tpu_torch.core.batch_predict import run_batch_predict
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )
    from predictionio_tpu_torch.ops import topk

    out: dict = {"phase": "off_menu_wave", "queries": WAVE, "num": OFF_MENU_NUM}
    with tempfile.TemporaryDirectory() as tmp:
        home = Path(tmp) / "pio_home"
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
        _, U, V = write_model(storage, home, exact=True)
        users = np.random.default_rng(SEED + 4).integers(0, ML20M_USERS, WAVE)
        qfile, pfile = Path(tmp) / "queries.jsonl", Path(tmp) / "preds.jsonl"
        qfile.write_text("".join(
            json.dumps({"user": f"u{u}", "num": OFF_MENU_NUM}) + "\n" for u in users
        ))
        before = topk.FULL_ROW_FALLBACKS.get("als.batch_topk", 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain = topk.fused_topk_plain
        topk.fused_topk_plain = None  # the route must not call it
        reset_launches()
        t0 = time.perf_counter()
        try:
            n = run_batch_predict("recommendation", qfile, pfile, storage=storage)
            torch.cuda.synchronize()
        finally:
            topk.fused_topk_plain = plain
        out["wall_s"] = time.perf_counter() - t0
        launches = read_launches()
        out["peak_bytes_over_base"] = torch.cuda.max_memory_allocated() - base
        per_slice = topk.full_row_slices(WAVE, ML20M_ITEMS)
        out["queries_per_slice"] = per_slice
        out["peak_bytes_per_score"] = out["peak_bytes_over_base"] / (
            per_slice * ML20M_ITEMS
        )
        out["full_row_fallbacks"] = (
            topk.FULL_ROW_FALLBACKS.get("als.batch_topk", 0) - before
        )
        storage.close()
        assert n == WAVE, n
        assert out["full_row_fallbacks"] == 1, out
        assert not any(launches.values()), launches
        lines = [json.loads(x) for x in pfile.read_text().splitlines()]
    rows = np.random.default_rng(SEED + 5).choice(WAVE, 512, replace=False)
    want = topk.fused_topk_plain(
        torch.from_numpy(U[users[rows]]), torch.from_numpy(V), OFF_MENU_NUM,
        ML20M_ITEMS,
    ).numpy()
    for j, row in enumerate(rows):
        got = lines[row]["prediction"]["itemScores"]
        assert [x["item"] for x in got] == [f"i{int(i)}" for i in want[1, j]], row
        assert [x["score"] for x in got] == [float(s) for s in want[0, j]], row
    out.update(rows_checked_vs_cpu_plain=len(rows), launches=launches)
    # the route alone on random-normal inputs
    rng = np.random.default_rng(SEED + 6)
    qn = rng.standard_normal((512, RANK)).astype(np.float32)
    want = topk.fused_topk_plain(
        torch.from_numpy(qn), torch.from_numpy(V), OFF_MENU_NUM + 1, ML20M_ITEMS
    ).numpy()
    got = topk.full_row_topk(
        torch.from_numpy(qn).cuda(), torch.from_numpy(V).cuda(), OFF_MENU_NUM,
        where="chip_smoke.normal",
    ).cpu().numpy()
    err = np.abs(got[0] - want[0, :, :OFF_MENU_NUM])
    if (err > RTOL * np.abs(want[0, :, :OFF_MENU_NUM]) + 1e-6).any():
        raise AssertionError(f"off-menu route on normal inputs: error {err.max()}")
    v = want[0]
    tie = np.abs(np.diff(v, axis=1)) <= RTOL * np.abs(v[:, 1:]) + 1e-6
    near = np.zeros(v.shape, bool)
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    swaps = got[1] != want[1, :, :OFF_MENU_NUM]
    if (swaps & ~near[:, :OFF_MENU_NUM]).any():
        raise AssertionError("off-menu route on normal inputs: an id differs without a tie")
    out.update(normal_max_abs_err=float(err.max()), normal_near_tie_id_swaps=int(swaps.sum()))
    return out


# -- the serving front end ----------------------------------------------------

#: concurrent clients and queries of the serve_concurrent phase, and the
#: burst of the pipelined_waves phase
CLIENTS = 64
FRONT_QUERIES = 4096
#: num of the pipelined burst: the top of the fused menu, so that a wave's
#: fence (its render) costs several times its dispatch and the worker runs
#: two waves ahead of the finalizer; at num=10 the two halves take about
#: the same host time and the finalizer keeps up (depth 1)
PIPELINED_NUM = 128


def hold_answers(answers, users, U, V, num: int, item_name=None) -> int:
    """Each answer (its ``itemScores``) against the host answer of its user:
    ``num`` entries, scores within RTOL, ids equal except inside a near-tie
    of the host scores (a wave's product sums in another order than a
    single row's).  ``item_name`` maps a row of V to its item (default
    ``i<row>``).  Returns the answers checked."""
    from predictionio_tpu_torch.ops.topk import host_topk_batch

    if item_name is None:
        item_name = "i{}".format

    users = np.asarray(users)
    for lo in range(0, len(users), 512):
        # one more than num: the neighbour of the last position
        s, idx = host_topk_batch(U[users[lo:lo + 512]] @ V.T, num + 1)
        for j, got in enumerate(answers[lo:lo + 512]):
            scores = s[j]
            assert len(got) == num, (lo + j, got)
            np.testing.assert_allclose(
                [x["score"] for x in got], scores[:num], rtol=RTOL, atol=1e-6
            )
            for c, gi in enumerate(x["item"] for x in got):
                if gi != item_name(int(idx[j, c])):
                    nb = [scores[x] for x in (c - 1, c + 1) if 0 <= x <= num]
                    assert min(abs(scores[c] - x) for x in nb) <= RTOL * abs(
                        scores[c]
                    ), (lo + j, c)
    return len(users)


def drive_clients(port: int, bodies: list, clients: int) -> tuple[list, float]:
    """``clients`` threads, each on one keep-alive ``http.client``
    connection, POST ``bodies`` to ``/queries.json`` until none is left.
    Returns (status, client seconds, ``X-Pio-Engine-Instance``, body) per
    body, in order, and the wall time."""
    import http.client
    import threading

    jobs = iter(enumerate(bodies))
    lock = threading.Lock()
    results: list = [None] * len(bodies)

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while True:
                with lock:
                    job = next(jobs, None)
                if job is None:
                    return
                i, body = job
                t1 = time.perf_counter()
                conn.request("POST", "/queries.json", body=body)
                resp = conn.getresponse()
                data = resp.read()
                results[i] = (resp.status, time.perf_counter() - t1,
                              resp.getheader("X-Pio-Engine-Instance"), data)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:  # one deadline for all of them
        t.join(timeout=max(0.0, t0 + 300 - time.perf_counter()))
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    missing = [i for i, r in enumerate(results) if r is None]
    assert not missing, f"{len(missing)} queries got no answer"
    return results, wall


def serve_concurrent_phase(storage, instance_id: str, U, V) -> dict:
    """The default deploy (aio front end, micro-batcher, max_batch 32,
    pipeline depth 2) under 64 keep-alive clients sending 4,096 queries:
    every answer is 200 and held to the host answer; the waves coalesce
    (some larger than 1) and, all under ``DEVICE_BATCH_MIN``, take the
    host replica: the fused top-k launches no time."""
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
    )

    users = np.random.default_rng(SEED + 30).integers(0, ML20M_USERS, FRONT_QUERIES)
    bodies = [json.dumps({"user": f"u{u}", "num": 10}).encode() for u in users]
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    server = create_prediction_server(
        "recommendation", host="127.0.0.1", port=0, storage=storage
    ).start_background()
    try:
        results, wall = drive_clients(server.port, bodies, CLIENTS)
        waves = server.app.microbatcher.wave_histogram()
    finally:
        server.shutdown()
    launches = read_launches()
    # -- end --
    statuses = sorted({r[0] for r in results})
    assert statuses == [200], statuses
    assert {r[2] for r in results} == {instance_id}
    checked = hold_answers(
        [json.loads(r[3])["itemScores"] for r in results], users, U, V, 10
    )
    assert launches["fused_topk"] == 0, launches
    assert sum(k * n for k, n in waves.items()) == FRONT_QUERIES, waves
    assert max(waves) > 1, waves
    lat_ms = np.asarray([1e3 * r[1] for r in results])
    return {
        "phase": "serve_concurrent",
        "queries": FRONT_QUERIES,
        "clients": CLIENTS,
        "max_batch": 32,
        "pipeline_depth": 2,
        "wall_s": wall,
        "queries_per_s": FRONT_QUERIES / wall,
        "client_p50_ms": float(np.percentile(lat_ms, 50)),
        "client_p99_ms": float(np.percentile(lat_ms, 99)),
        "client_max_ms": float(lat_ms.max()),
        "waves": sum(waves.values()),
        "mean_wave": FRONT_QUERIES / sum(waves.values()),
        "wave_histogram": {str(k): n for k, n in sorted(waves.items())},
        "answers_checked_vs_host": checked,
        "launches": launches,
        "nvidia_smi": nvidia_smi_line(),
    }


FENCE_REPS = 25


def fence_probe(deployed, users) -> dict:
    """Wave N's fence timed alone on the host clock, with wave N+1 already
    enqueued behind it on the same stream (4,096-query waves at num=10,
    one kernel 3 launch each; medians of FENCE_REPS pairs):

    - ``engine``: ``ALSAlgorithm._device_topk``'s fence, which waits for an
      event recorded after the result's copy into pinned memory;
    - ``pageable``: the fence the engine had before the front end, the
      wave's event and then a pageable ``.cpu()`` of the result, which
      queues on the stream behind wave N+1's kernel (``sync`` is its event
      wait alone).

    Both are checked to give the same bits.  These launches are not counted
    on any path."""
    algo, model = deployed.algorithms[0], deployed.models[0]
    U, V = model.user_factors, model.item_factors
    ua = np.asarray(users, np.int64)
    ub = ua[::-1].copy()
    ids_a, ids_b = (torch.from_numpy(x).to(U.device) for x in (ua, ub))
    engine, pageable, sync = [], [], []
    for _ in range(FENCE_REPS):
        fence_a = algo._device_topk(model, ua, 10)
        fence_b = algo._device_topk(model, ub, 10)
        t0 = time.perf_counter()
        got = fence_a()
        engine.append(time.perf_counter() - t0)
        fence_b()
        packed = algo._topk_on(U, V, ids_a, 10)
        done = torch.cuda.Event()
        done.record()
        packed_b = algo._topk_on(U, V, ids_b, 10)
        t0 = time.perf_counter()
        done.synchronize()
        t1 = time.perf_counter()
        old = packed.cpu().numpy()
        pageable.append(time.perf_counter() - t0)
        sync.append(t1 - t0)
        packed_b.cpu()
        assert np.array_equal(got[0].view(np.int32), old[0].view(np.int32))
        assert np.array_equal(got[1], old[1].astype(np.int64))
    return {
        "wave": len(ua),
        "reps": FENCE_REPS,
        "engine_fence_ms": 1e3 * float(np.median(engine)),
        "pageable_fence_ms": 1e3 * float(np.median(pageable)),
        "pageable_sync_ms": 1e3 * float(np.median(sync)),
        "engine_fence_ms_min_max": [1e3 * min(engine), 1e3 * max(engine)],
        "pageable_fence_ms_min_max": [1e3 * min(pageable), 1e3 * max(pageable)],
    }


def queued_burst(batcher, payloads: list, metas: list) -> list:
    """Submit every payload to ``batcher`` at once, all queued before its
    worker forms a wave (its condition is held while the burst enqueues),
    and return the results in order."""
    import asyncio

    from predictionio_tpu_torch.server.prediction_server import QueuedQuery

    async def burst():
        with batcher._cond:
            futs = [asyncio.ensure_future(batcher.submit(QueuedQuery(p), m))
                    for p, m in zip(payloads, metas)]
            await asyncio.sleep(0)  # every task runs its submit up to the await
            assert len(batcher._pending) == len(futs), len(batcher._pending)
        return await asyncio.gather(*futs)

    return asyncio.run(burst())


def pipelined_waves_phase(storage, instance_id: str, U, V) -> dict:
    """4,096 queries (num=128) submitted at once to the micro-batcher of an
    app with max_batch 1,024 and pipeline depth 2: four device waves, each
    one launch of the fused top-k, dispatched on the worker and fenced on
    the finalizer while the next dispatches (at least one wave enqueued at
    depth 2); every answer held to the host answer.  Then, outside the
    counted run, :func:`fence_probe`."""
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server_app,
        deploy_engine,
    )

    deployed = deploy_engine("recommendation", storage=storage)
    app = create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=1024, pipeline_depth=2,
        max_queue=FRONT_QUERIES, registry=MetricsRegistry(),
    )
    batcher = app.microbatcher
    users = np.random.default_rng(SEED + 31).integers(0, ML20M_USERS, FRONT_QUERIES)
    payloads = [{"user": f"u{u}", "num": PIPELINED_NUM} for u in users]
    metas: list[dict] = [{} for _ in payloads]

    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    t0 = time.perf_counter()
    try:
        results = queued_burst(batcher, payloads, metas)
    finally:
        wall = time.perf_counter() - t0
        batcher.close()
    launches = read_launches()
    # -- end --
    assert {(r[0], r[2]) for r in results} == {("ok", instance_id)}
    waves: dict = {}
    for m in metas:
        waves.setdefault(m["wave_seq"], m)
    device = [m for m in waves.values() if m["wave_size"] >= 512]
    assert len(device) >= 4, list(waves.values())
    assert launches["fused_topk"] == len(device), (launches, len(device))
    assert any(m.get("pipelined") and m.get("inflight_depth") == 2
               for m in device), list(waves.values())
    checked = hold_answers(
        [r[1]["itemScores"] for r in results], users, U, V, PIPELINED_NUM
    )
    probe = fence_probe(deployed, users)
    return {
        "phase": "pipelined_waves",
        "fence_probe": probe,
        "queries": FRONT_QUERIES,
        "num": PIPELINED_NUM,
        "max_batch": 1024,
        "pipeline_depth": 2,
        "wall_s": wall,
        "device_waves": len(device),
        "waves": [
            {key: m.get(key) for key in ("wave_seq", "wave_size", "pipelined",
                                         "inflight_depth", "dispatch_s",
                                         "finalize_s", "device_s")}
            for _, m in sorted(waves.items())
        ],
        "answers_checked_vs_host": checked,
        "launches": launches,
        "nvidia_smi": nvidia_smi_line(),
    }


def reload_phase(storage, home: Path, instance_id: str, U, V) -> dict:
    """``POST /reload`` to a second instance (other factors) while 16
    keep-alive clients query the default deploy: every answer matches the
    factors of the instance its ``X-Pio-Engine-Instance`` names, every
    query sent after the reload returned is answered by the new instance,
    and once the clients stop, the old generation's device memory is
    freed: the growth of ``torch.cuda.memory_allocated()`` over the swap
    stays below one model's factor bytes."""
    import gc
    import http.client
    import threading

    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
    )

    factor_bytes = (ML20M_USERS + ML20M_ITEMS) * RANK * 4
    users = np.random.default_rng(SEED + 41).integers(0, ML20M_USERS, 4096)
    server = create_prediction_server(
        "recommendation", host="127.0.0.1", port=0, storage=storage
    ).start_background()
    stop = threading.Event()
    lock = threading.Lock()
    records: list = []  # (sent, status, instance header, user, body)

    def client(k: int):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        n = 0
        try:
            while not stop.is_set():
                u = int(users[(k * 256 + n) % len(users)])
                n += 1
                sent = time.perf_counter()
                conn.request("POST", "/queries.json",
                             body=json.dumps({"user": f"u{u}", "num": 10}))
                resp = conn.getresponse()
                data = resp.read()
                with lock:
                    records.append((sent, resp.status,
                                    resp.getheader("X-Pio-Engine-Instance"), u, data))
        finally:
            conn.close()

    def wait_for(pred, what):
        t0 = time.perf_counter()
        while not pred():
            assert time.perf_counter() - t0 < 120, what
            time.sleep(0.01)

    out: dict = {"phase": "reload", "clients": 16, "factor_bytes": factor_bytes}
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(16)]
    try:
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        id_b, U2, V2 = write_model(storage, home, seed=SEED + 40)
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        for t in threads:
            t.start()
        wait_for(lambda: len(records) >= 256, "no traffic before the reload")
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/reload", method="POST"
        )
        reloaded = json.loads(urllib.request.urlopen(req, timeout=120).read())
        swapped = time.perf_counter()
        out["reload_s"] = swapped - t0
        wait_for(lambda: sum(r[0] > swapped for r in records) >= 256,
                 "no traffic after the reload")
        stop.set()
        t_stop = time.perf_counter()
        for t in threads:
            t.join(timeout=max(0.0, t_stop + 60 - time.perf_counter()))
        assert not any(t.is_alive() for t in threads), "a client hung"
        launches = read_launches()
        # -- end --
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    finally:
        stop.set()
        server.shutdown()
    assert reloaded["engineInstanceId"] == id_b, reloaded
    assert sorted({r[1] for r in records}) == [200], sorted({r[1] for r in records})
    by = {instance_id: [], id_b: []}
    for r in records:
        by[r[2]].append(r)
    late = [r for r in records if r[0] > swapped]
    assert {r[2] for r in late} == {id_b}, "the old generation answered after /reload"
    for iid, (u_f, v_f) in ((instance_id, (U, V)), (id_b, (U2, V2))):
        hold_answers([json.loads(r[4])["itemScores"] for r in by[iid]],
                     [r[3] for r in by[iid]], u_f, v_f, 10)
    assert after - before < factor_bytes, (before, after)
    out.update({
        "queries": len(records),
        "answered_by_old": len(by[instance_id]),
        "answered_by_new": len(by[id_b]),
        "sent_after_reload": len(late),
        "allocated_before_swap": before,
        "allocated_after_drain": after,
        "allocated_growth": after - before,
        "launches": launches,
        "nvidia_smi": nvidia_smi_line(),
    })
    return out


#: the observability phase: the deploy's access key and wave cap.  Its
#: device floor stays the engine's (DEVICE_BATCH_MIN, 512 known users):
#: 64 clients never queue that many, so their waves are host waves, and
#: the device waves come from a burst queued on the batcher past the floor
OBS_KEY, OBS_MAX_BATCH = "obs-smoke-key", 1024
OBS_PROFILE_S = 2.0
#: the CUDA-event time of the kernel per launch against the profiler's
#: device time per launch of the same waves: within this factor
OBS_EVENT_VS_PROFILER = 2.0
#: solo queries per front end timed for the layer's cost, after a warmup
SOLO_WARMUP, SOLO_REQUESTS = 100, 500

#: one sample line of a Prometheus text body, and one label of it
PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
PROM_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """``{(name, ((label, value), ...)): value}`` of a /metrics body."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = PROM_SAMPLE.match(line)
        assert m, line
        labels = tuple(sorted(PROM_LABEL.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def http_burst(port: int, bodies: list, conns: int) -> tuple[list, float]:
    """POST ``bodies`` to ``/queries.json`` over ``conns`` keep-alive
    connections from one asyncio client (each connection one query at a
    time, all opened before the first query: ``conns`` clients).  Returns (status, client
    seconds, X-Pio-Request-Id, body, completion perf_counter) per body, in
    order, and the wall time."""
    import asyncio

    jobs = list(enumerate(bodies))[::-1]
    results: list = [None] * len(bodies)

    async def one(reader, writer, go):
        await go.wait()
        try:
            while jobs:
                i, body = jobs.pop()
                t1 = time.perf_counter()
                writer.write(
                    b"POST /queries.json HTTP/1.1\r\nHost: smoke\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: %d\r\n\r\n" % len(body) + body
                )
                await writer.drain()
                head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
                lines = head.split("\r\n")
                headers = {k.strip().lower(): v.strip() for k, _, v in
                           (x.partition(":") for x in lines[1:] if x)}
                data = await reader.readexactly(int(headers["content-length"]))
                done = time.perf_counter()
                results[i] = (int(lines[0].split()[1]), done - t1,
                              headers.get("x-pio-request-id"), data, done)
        finally:
            writer.close()

    async def run():
        go = asyncio.Event()
        opened = []
        for lo in range(0, conns, 64):  # within the listen backlog
            opened += await asyncio.gather(*(
                asyncio.open_connection("127.0.0.1", port)
                for _ in range(min(64, conns - lo))))
        tasks = [asyncio.ensure_future(one(r, w, go)) for r, w in opened]
        go.set()
        await asyncio.gather(*tasks)

    t0 = time.perf_counter()
    asyncio.run(asyncio.wait_for(run(), timeout=300))
    wall = time.perf_counter() - t0
    missing = [i for i, r in enumerate(results) if r is None]
    assert not missing, f"{len(missing)} queries got no answer"
    return results, wall


def obs_get(port: int, path: str, key: str | None = OBS_KEY):
    """(status, body: JSON or text) of one GET, Bearer key when given."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers={"Authorization": f"Bearer {key}"}
                     if key else {})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw.decode()
    finally:
        conn.close()


def observability_phase(storage, instance_id: str, U, V) -> dict:
    """The observability layer on the seeded ML-20M model: the default
    deploy's micro-batcher with an access key, waves of up to 1,024 and the
    engine's device floor (512 known users).  A 4,096-query num=10 burst
    from 64 keep-alive clients (host waves: the clients never queue 512),
    then 4,096 queries queued on the batcher at once (four 1,024-query
    device waves, each one kernel 3 launch), then every observability route
    scraped and held:

    - the roofline share of ``als.fused_topk`` (the kernel's CUDA-event
      time, recorded by its launcher, over the least work) in (0, 1.05] at
      1,024 rows, every device wave's CUDA-event time at or above the
      kernel's bound at its batch;
    - every wave's five-way host split summing to its ``device_s`` within
      1 %, and over all waves the stage histograms to the device seconds;
    - the h2d/d2h tallies equal to the bytes the device waves moved (ids
      up, packed results down);
    - the memory gauges equal to ``torch.cuda.memory_allocated()`` /
      ``memory_reserved()`` at the scrape;
    - every answer's ``X-Pio-Request-Id`` in ``/logs.json``, the last 64
      answers' items exactly in ``/explain.json``, the slowest requests in
      ``/debug/flight.json`` with their wave meta;
    - ``/healthz`` 200 without the key, ``/readyz`` 200 with every check;
    - ``POST /debug/profile?seconds=2`` during a second queued burst: 202
      and a capture naming the fused top-k kernel with device time, whose
      device time per launch is within OBS_EVENT_VS_PROFILER of the
      launcher's CUDA-event time per launch of the same waves; or the
      profiler's error printed on its own line."""
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.ops.topk import fused_topk_least_work
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server_app,
        deploy_engine,
    )

    deployed = deploy_engine("recommendation", storage=storage,
                             engine_instance_id=instance_id)
    floor = deployed.algorithms[0].DEVICE_BATCH_MIN
    app = create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=OBS_MAX_BATCH,
        max_queue=FRONT_QUERIES, access_key=OBS_KEY,
    )
    batcher = app.microbatcher
    waves: list = []
    observe = batcher._observe_timeline

    def spy(timeline, device_s):
        """Each wave's split as the batcher computes it, read beside its
        device time, entry point and transfers."""
        split = observe(timeline, device_s)
        waves.append({"split": split, "device_s": device_s,
                      "kernel_s": timeline.kernel_s, "fn": timeline.fn,
                      "transfers": dict(timeline.transfers)})
        return split

    batcher._observe_timeline = spy
    rng = np.random.default_rng(SEED + 40)
    users = rng.integers(0, ML20M_USERS, FRONT_QUERIES)
    bodies = [json.dumps({"user": f"u{u}", "num": 10}).encode() for u in users]
    queued_users = rng.integers(0, ML20M_USERS, FRONT_QUERIES)
    payloads = [{"user": f"u{u}", "num": 10} for u in queued_users]
    out: dict = {"phase": "observability", "queries": FRONT_QUERIES,
                 "clients": CLIENTS, "queued_queries": FRONT_QUERIES,
                 "max_batch": OBS_MAX_BATCH, "device_floor": floor,
                 "nvidia_smi": nvidia_smi_line()}
    server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
    try:
        port = server.port
        transfers0 = device_obs.transfer_totals()
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        results, wall = http_burst(port, bodies, CLIENTS)
        http_waves = len(waves)
        t0 = time.perf_counter()
        queued = queued_burst(batcher, payloads, [{} for _ in payloads])
        queued_wall = time.perf_counter() - t0
        launches = read_launches()
        # -- end --
        transfers1 = device_obs.transfer_totals()
        first_bursts = list(waves)
        assert sorted({r[0] for r in results}) == [200]
        assert {(r[0], r[2]) for r in queued} == {("ok", instance_id)}
        checked = hold_answers([json.loads(r[3])["itemScores"] for r in results],
                               users, U, V, 10)
        checked += hold_answers([r[1]["itemScores"] for r in queued],
                                queued_users, U, V, 10)
        device = [w for w in first_bursts if w["fn"] == "als.fused_topk"]
        assert all(w["fn"] is None for w in first_bursts[:http_waves]), (
            "an HTTP wave of fewer than 512 queries reached the card")
        assert len(device) == FRONT_QUERIES // OBS_MAX_BATCH, len(device)
        assert launches["fused_topk"] == len(device), launches
        peaks = device_obs.device_peaks()
        lat_ms = np.asarray([1e3 * r[1] for r in results])
        out.update({
            "wall_s": wall, "queries_per_s": FRONT_QUERIES / wall,
            "client_p50_ms": float(np.percentile(lat_ms, 50)),
            "client_p99_ms": float(np.percentile(lat_ms, 99)),
            "queued_wall_s": queued_wall,
            "answers_checked_vs_host": checked, "launches": launches,
            "http_waves": http_waves, "device_waves": len(device),
            "mean_http_wave": FRONT_QUERIES / http_waves,
            "peak_row": peaks.source,
        })

        # each wave: its host split sums to device_s; a device wave's
        # CUDA-event time is at or above the kernel's least-work bound
        worst_split = 0.0
        below = []
        want_h2d = want_d2h = 0
        for w in first_bursts:
            err = abs(sum(w["split"].values()) - w["device_s"])
            worst_split = max(worst_split, err / w["device_s"])
            assert err <= 0.01 * w["device_s"], w
        for w in device:
            b = w["transfers"]["h2d"] // 8
            work = fused_topk_least_work(b, RANK, ML20M_ITEMS, 10)
            bound_s = max(work["bytes"] / (peaks.hbm_gbps * 1e9),
                          work["flops"] / (peaks.tflops * 1e12))
            if w["kernel_s"] < bound_s:
                below.append((b, w["kernel_s"], bound_s))
            want_h2d += 8 * b
            want_d2h += 2 * b * 10 * 4
            assert w["transfers"]["d2h"] == 2 * b * 10 * 4, w
        assert not below, below
        out["wave_split_worst_rel_err"] = worst_split
        out["device_wave_kernel_ms"] = [1e3 * w["kernel_s"] for w in device]
        out["device_wave_rows"] = [w["transfers"]["h2d"] // 8 for w in device]
        out["device_wave_bound_ms"] = 1e3 * bound_s
        got = {k: transfers1[k] - transfers0[k] for k in ("h2d", "d2h")}
        assert got == {"h2d": want_h2d, "d2h": want_d2h}, (got, want_h2d, want_d2h)
        out["transfer_bytes"] = got

        # the roofline: the gauges and /efficiency.json
        status, text = obs_get(port, "/metrics")
        assert status == 200
        prom = parse_prometheus(text)
        util = {res: prom[("pio_device_utilization_frac",
                           (("fn", "als.fused_topk"), ("resource", res)))]
                for res in ("hbm", "mxu")}
        assert all(0 < v <= 1.05 for v in util.values()), util
        status, eff = obs_get(port, "/efficiency.json")
        fn = eff["functions"]["als.fused_topk"]
        assert status == 200 and fn["source"] == "least_work"
        assert 0 < fn["utilization_hbm"] <= 1.05, fn
        out["fused_topk_share"] = {"last_wave": util, "cumulative": {
            "hbm": fn["utilization_hbm"], "mxu": fn["utilization_mxu"],
            "achieved_gbps": fn["achieved_gbps"], "calls": fn["calls"]}}
        out["efficiency_peaks"] = eff["peaks"]
        out["launch_shapes"] = eff["recompiles"]["functions"].get("als.fused_topk")
        for d in ("h2d", "d2h"):
            assert prom[("pio_device_transfer_bytes", (("direction", d),))] == (
                device_obs.transfer_totals()[d])
        # the stage histograms over every wave add up to the device seconds
        stage_sum = sum(v for (n, _), v in prom.items()
                        if n == "pio_microbatch_stage_seconds_sum")
        dev_sum = prom[("pio_microbatch_device_seconds_sum", ())]
        assert abs(stage_sum - dev_sum) <= 0.01 * dev_sum, (stage_sum, dev_sum)

        # the memory gauges against the allocator, at the scrape
        for _ in range(3):
            before = (torch.cuda.memory_allocated(0), torch.cuda.memory_reserved(0))
            _, text = obs_get(port, "/metrics")
            after = (torch.cuda.memory_allocated(0), torch.cuda.memory_reserved(0))
            if before == after:
                break
        prom = parse_prometheus(text)
        gauges = (prom[("pio_jax_device_memory_bytes", (("device", "0"),))],
                  prom[("pio_cuda_memory_reserved_bytes", (("device", "0"),))])
        assert before == after == tuple(int(g) for g in gauges), (before, after, gauges)
        out["memory_gauges"] = {"allocated": gauges[0], "reserved": gauges[1],
                                "peak": prom[("pio_cuda_memory_peak_bytes",
                                              (("device", "0"),))]}

        # request ids: every answer's in the wave lines of /logs.json
        status, logs = obs_get(port, "/logs.json?limit=1024")
        seen = {rid for rec in logs["logs"] for rid in rec.get("request_ids") or ()}
        ids = [r[2] for r in results]
        assert len(set(ids)) == len(ids) and None not in ids
        assert set(ids) <= seen, len(set(ids) - seen)
        one = obs_get(port, f"/logs.json?request_id={ids[0]}")[1]["logs"]
        assert one and ids[0] in one[0]["request_ids"]
        # the last answers' decision records hold exactly their items
        last = sorted(range(len(results)), key=lambda i: results[i][4])[-64:]
        for i in last:
            status, rec = obs_get(port, f"/explain.json?request_id={ids[i]}")
            assert status == 200, (status, ids[i])
            answered = json.loads(results[i][3])["itemScores"]
            assert rec["record"]["items"] == [
                {"item": x["item"], "score": x["score"]} for x in answered]
        out["explain_checked"] = len(last)
        status, flight = obs_get(port, "/debug/flight.json")
        assert status == 200 and flight["slowest"], flight
        for e in flight["slowest"]:
            assert {"device_breakdown", "wave_size", "device_s"} <= set(e), e
            split_err = abs(sum(e["device_breakdown"].values()) - e["device_s"])
            assert split_err <= 0.01 * e["device_s"], e
        out["flight"] = {"slowest": len(flight["slowest"]),
                         "slowest_s": flight["slowest"][0]["duration_s"]}

        # probes
        status, health = obs_get(port, "/healthz", key=None)
        assert status == 200 and health["status"] == "alive", health
        assert obs_get(port, "/readyz", key=None)[0] == 401
        status, ready = obs_get(port, "/readyz")
        assert status == 200 and ready["ready"] and all(ready["checks"].values()), ready
        out["readyz"] = ready["checks"]
        status, hot = obs_get(port, "/hotpath.json")
        assert status == 200
        out["hotpath_coverage_frac"] = hot["coverage_frac"]

        # the profiler during a second queued burst of device waves
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", f"/debug/profile?seconds={OBS_PROFILE_S}",
                     headers={"Authorization": f"Bearer {OBS_KEY}"})
        resp = conn.getresponse()
        started = (resp.status, json.loads(resp.read()))
        conn.close()
        profile: dict = {"status": started[0]}
        if started[0] == 202:
            reset_launches()
            mark = len(waves)
            second = queued_burst(batcher, payloads, [{} for _ in payloads])
            profiled = [w for w in waves[mark:] if w["fn"] == "als.fused_topk"]
            profile["launches_during"] = read_launches()["fused_topk"]
            assert {r[0] for r in second} == {"ok"}
            assert profile["launches_during"] == len(profiled) > 0, profile
            deadline = time.monotonic() + 120
            while True:
                status, st = obs_get(port, "/debug/profile")
                if not st["running"]:
                    break
                assert time.monotonic() < deadline, "the capture never finished"
                time.sleep(0.2)
            last_cap = st["last"]
            profile["error"] = last_cap["error"]
            if last_cap["error"] is None:
                ops = [o for o in last_cap["device_ops"] if "fused_topk" in o["name"]]
                assert ops and all(o["device_time_us"] > 0 for o in ops), last_cap
                profile["fused_topk_ops"] = ops
                profile["top_device_ops"] = last_cap["device_ops"][:5]
                # the launcher's events against the profiler, per launch:
                # each pass's mean over the launches the capture holds
                prof_ms = sum(o["device_time_us"] / o["count"] for o in ops) / 1e3
                event_ms = 1e3 * sum(w["kernel_s"] for w in profiled) / len(profiled)
                ratio = event_ms / prof_ms
                profile.update({"profiler_ms_per_launch": prof_ms,
                                "event_ms_per_launch": event_ms,
                                "event_over_profiler": ratio})
                assert 1 / OBS_EVENT_VS_PROFILER <= ratio <= OBS_EVENT_VS_PROFILER, profile
        else:
            assert started[0] == 501, started
            profile["error"] = started[1]["message"]
        if profile.get("error"):
            print(f"profiler_error: {profile['error']}", flush=True)
        out["profiler"] = profile
    finally:
        server.shutdown()
        batcher.close()
    return out


def solo_cost_phase(storage) -> dict:
    """What a solo query costs on each front end of the default deploy:
    SOLO_REQUESTS sequential num=10 queries on one keep-alive connection
    after SOLO_WARMUP (``solo_latency.run_kind``), the client's p50/p99 and
    ``/hotpath.json``'s host stages per request."""
    import solo_latency

    users = np.random.default_rng(SEED + 41).integers(
        0, ML20M_USERS, SOLO_WARMUP + SOLO_REQUESTS)
    return {kind: solo_latency.run_kind(kind, storage, users, "cuda", SOLO_WARMUP)
            for kind in ("aio", "threaded")}


def front_end_phases() -> list[dict]:
    """The serving front end at the ML-20M shape: serve_concurrent,
    pipelined_waves, reload, observability and solo_cost on one seeded
    model."""
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )

    with tempfile.TemporaryDirectory() as tmp:
        home = Path(tmp) / "pio_home"
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
        try:
            instance_id, U, V = write_model(storage, home)
            lines = [serve_concurrent_phase(storage, instance_id, U, V)]
            emit(lines[-1])
            lines.append(pipelined_waves_phase(storage, instance_id, U, V))
            emit(lines[-1])
            lines.append(reload_phase(storage, home, instance_id, U, V))
            emit(lines[-1])
            lines.append(observability_phase(storage, instance_id, U, V))
            emit(lines[-1])
            lines.append({"phase": "solo_cost", **solo_cost_phase(storage),
                          "nvidia_smi": nvidia_smi_line()})
            emit(lines[-1])
        finally:
            storage.close()
    return lines


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


def boundary_stream(kind: str, k: int, rng):
    """A stream whose runs end at every row of a tile: block 0 holds
    segment 3 over 3,500 rows (two tiles one run from first row to last);
    blocks 1-9 each open with a run of 1 + 115 (b - 1) rows and then 127
    one-row segments; block 10 is empty; block 11 random.  Returns the
    stream and its padded segment count."""
    seg = [np.full(3500, 3), rng.integers(0, 128, 300)]
    for b in range(1, 10):
        seg += [np.full(1 + 115 * (b - 1), 128 * b), 128 * b + np.arange(1, 128)]
    seg.append(rng.integers(11 * 128, 12 * 128, 600))
    seg = rng.permutation(np.concatenate(seg))
    n, n_oth = len(seg), 300
    oth = rng.integers(0, n_oth, n).astype(np.int32)
    if kind == "exact":
        factors = rng.integers(-8, 9, (n_oth, k)) / 8.0
        rating = rng.integers(1, 11, n) / 2.0
    else:
        factors = rng.standard_normal((n_oth, k))
        rating = rng.standard_normal(n)
    return seg, oth, rating.astype(np.float32), factors.astype(np.float32), 12 * 128


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
    """Both ALS kernels against their plain versions, "highest" and "bf16",
    on a stream with an all-padding block and a segment over more than 3
    tiles: the fused one at ranks 1, 2, 6, 8, 10, 11, 17 and 32, explicit and
    implicit; the chunked one at ranks 1, 10, 11, 17 and 32 (every width),
    in 2-tile chunks, and on a stream whose runs end at every row of a tile
    in 3-tile chunks (blocks cross chunks); and the fused one on a signed
    implicit stream (ratings +-1 and half stars mixed) at ranks 1, 10 and
    17.  Bitwise on exact inputs, within
    ALS_RTOL on random-normal ones, and a repeat run gives the same bits.
    The streams are staged by ``ops.als._stage``, as ``train_als`` stages
    them."""
    from predictionio_tpu_torch.ops import als, als_accum

    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    n_seg_pad, n_oth, n, hot = 512, 300, 9000, 3500
    cases = []
    for kind in ("exact", "normal"):
        for k in (1, 2, 6, 8, 10, 11, 17, 32):
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
        # kernel 2 at every width (128, 128, 256, 384, 1,152): the stream
        # above in 2-tile chunks, and one whose runs end at every row of a
        # tile (so at every boundary of its 4- and 8-row groups) in 3-tile
        # chunks; blocks cross chunks in both
        for k in (1, RANK, 11, 17, 32):
            for stream, tpc in (("hot", 2), ("boundary", 3)):
                if stream == "hot":
                    seg, oth, rating, factors = als_stream(
                        kind, n, n_seg_pad, n_oth, k, rng, hot)
                    pad = n_seg_pad
                else:
                    seg, oth, rating, factors, pad = boundary_stream(kind, k, rng)
                st = als._stage(seg, oth, rating, pad, "chunked", cuda,
                                tiles_per_chunk=tpc)
                f = torch.from_numpy(factors).cuda()
                for precision in ("highest", "bf16"):
                    def chunked(fn, fac, rat):
                        return fn(st["plan_args"], st["oth"], rat, st["val"], fac,
                                  True, 1.5, st["plan"].n_blocks, precision)

                    got = chunked(als_accum.segment_stats_chunked, f, st["rat"])
                    again = chunked(als_accum.segment_stats_chunked, f, st["rat"])
                    want = chunked(als_accum.segment_stats_chunked_plain, f, st["rat"])
                    scale = chunked(als_accum.segment_stats_chunked_plain, f.abs(),
                                    st["rat"].abs())
                    what = (f"chunked {kind} r{k} {stream} implicit {precision}, "
                            f"{st['plan'].n_chunks} chunks")
                    err = hold(got, want, scale, kind == "exact", what)
                    same_bits(got, again, what)
                    cases.append({"kernel": "als_segment_accum", "case": what,
                                  "max_abs_err": err})
        # kernel 1 on a signed implicit stream, as likealgo's +-1 and
        # ecommerce's rate events give it: ratings +-1 and half stars mixed
        for k in (1, RANK, 17):
            seg, oth, _, factors = als_stream(kind, n, n_seg_pad, n_oth, k, rng, hot)
            rating = np.where(rng.random(n) < 0.5, rng.choice([-1.0, 1.0], n),
                              rng.integers(1, 11, n) / 2.0).astype(np.float32)
            st = als._stage(seg, oth, rating, n_seg_pad, "fused", cuda)
            f = torch.from_numpy(factors).cuda()
            for precision in ("highest", "bf16"):
                def signed(fn, fac, rat):
                    wrv = als_accum.make_wrv(rat, st["val"], True, 1.0)
                    return fn(st["plan_args"], st["oth"], wrv, fac,
                              st["plan"].n_blocks, precision)

                got = signed(als_accum.segment_stats_fused, f, st["rat"])
                again = signed(als_accum.segment_stats_fused, f, st["rat"])
                want = signed(als_accum.segment_stats_fused_plain, f, st["rat"])
                scale = signed(als_accum.segment_stats_fused_plain, f.abs(),
                               st["rat"].abs())
                what = f"fused {kind} r{k} signed implicit {precision}"
                err = hold(got, want, scale, kind == "exact", what)
                same_bits(got, again, what)
                cases.append({"kernel": "als_fused_accum", "case": what,
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
    from predictionio_tpu_torch.ops.topk import host_topk_batch
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

        def host(user):  # a wave of one, as the micro-batched server answers
            s, idx = host_topk_batch(U[[uvocab[str(user)]]] @ V.T, 10)
            return [ivocab[j] for j in idx[0]], [float(x) for x in s[0]]

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
        # pio eval on the same store (its own main-path read)
        out["eval"] = eval_phase(tmp, storage)
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


def fused_hold(staged: dict, other: torch.Tensor, p, what: str) -> float:
    """Kernel 1 on a train's staged stream (``ops.als._STAGE_CACHE``, its
    weights made for the train's feedback kind) against its plain version,
    within ALS_RTOL of the absolute sums; returns the largest difference."""
    from predictionio_tpu_torch.ops import als_accum

    plan = staged["plan"]
    args = (staged["plan_args"], staged["oth"], staged["wrv"], other, plan.n_blocks)
    got = als_accum.segment_stats_fused(*args, p.pallas_precision)
    want = als_accum.segment_stats_fused_plain(*args, p.pallas_precision)
    scale = als_accum.segment_stats_fused_plain(
        staged["plan_args"], staged["oth"], staged["wrv"].abs(), other.abs(),
        plan.n_blocks, p.pallas_precision,
    )
    return hold(got, want, scale, False, what)


def fused_timing(staged: dict, other: torch.Tensor, p) -> dict:
    """Kernel 1 at the ML-20M half-step: checked against its plain version
    on the same inputs, then timed beside it and held against its bound.
    No single PyTorch call computes it, so library_ms is null."""
    from predictionio_tpu_torch.ops import als_accum

    plan = staged["plan"]
    args = (staged["plan_args"], staged["oth"], staged["wrv"], other, plan.n_blocks)
    err = fused_hold(staged, other, p, f"fused at the ML-20M shape, rank {p.rank}")
    valid = int((staged["plan"].seg3 >= 0).sum())
    work = als_accum.als_accum_least_work(
        plan.padded_len, p.rank, plan.n_blocks * 128, other.shape[0], valid
    )
    bytes_s, ops_s = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / FP32_FLOPS_PER_S
    # the same stream at rank 32 (random factors): a kernel bound by its
    # stream's bytes barely slows; one bound by its arithmetic slows ~9x
    wide = torch.from_numpy(
        np.random.default_rng(SEED + 6).standard_normal((other.shape[0], 32))
        .astype(np.float32)
    ).to(other.device)
    wide_args = (*args[:3], wide, plan.n_blocks)
    wide_work = als_accum.als_accum_least_work(
        plan.padded_len, 32, plan.n_blocks * 128, other.shape[0], valid
    )
    return {
        "shape": [plan.padded_len, p.rank, plan.n_blocks * 128, other.shape[0]],
        "valid_rows": valid,
        "max_abs_err": err,
        "rank32_ms": time_ms(
            lambda: als_accum.segment_stats_fused(*wide_args, p.pallas_precision),
            launches=3, repeats=5,
        ),
        "rank32_bound_ms": 1e3 * max(wide_work["bytes"] / HBM_BYTES_PER_S,
                                     wide_work["flops"] / FP32_FLOPS_PER_S),
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
    """Kernel 2 on the first chunk of the ML-20M user half-step at the rank
    of ``other``: ``chunk_tiles`` tiles of the chunked plan (1,024 at rank
    10, width 128; 113 at rank 32, width 1,152), the rows built as
    ``segment_stats_chunked`` builds them; checked against its plain
    version, timed beside it and beside one ``index_add_`` call (padding
    rows into a spare output row), and timed again last: the spread of one
    call."""
    from predictionio_tpu_torch.ops import als_accum
    from predictionio_tpu_torch.ops.als import confidence_weights

    plan = staged["plan"]
    width = als_accum.row_width(other.shape[1])
    tiles = min(als_accum.chunk_tiles(width), plan.tiles_per_chunk)
    # the chunked streams are in host memory: upload the chunk's tiles
    bm, seg3 = (x[0, :tiles].to(other.device) for x in staged["plan_args"])
    oth, rat, val = (
        x[0, :tiles * 1024].to(other.device)
        for x in (staged["oth"], staged["rat"], staged["val"])
    )
    n_seg = plan.n_blocks * 128
    w, rhs = confidence_weights(rat, val, False, 1.0)
    rows = als_accum._flat_rows(other[oth.long()], w, rhs, val, width)
    what = f"chunk at the ML-20M shape, width {width}"

    def fresh():
        return torch.zeros((n_seg, width), device=other.device)

    got = als_accum.segment_accum(fresh(), bm, seg3, rows, p.pallas_precision)
    want = als_accum.segment_accum_plain(fresh(), bm, seg3, rows, p.pallas_precision)
    scale = als_accum.segment_accum_plain(fresh(), bm, seg3, rows.abs(), p.pallas_precision)
    err = hold(got, want, scale, False, what)
    del want, scale
    g = als_accum._global_seg(bm, seg3)
    g = torch.where(g >= 0, g, n_seg)
    spare = torch.zeros((n_seg + 1, width), device=other.device)
    acc = fresh()
    valid = int((plan.seg3[0, :tiles] >= 0).sum())
    # the running output is read and written only for the touched blocks
    touched = int(np.unique(plan.block_map[0, :tiles]).size) * 128
    work = als_accum.segment_accum_least_work(rows.shape[0], width, touched, valid)
    bytes_s, ops_s = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / FP32_FLOPS_PER_S
    out = {
        "shape": [rows.shape[0], width, n_seg],
        "tiles": tiles,
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
    out["ms_again"] = time_ms(lambda: als_accum.segment_accum(acc, bm, seg3, rows))
    return out


def chunked_breakdown(staged: dict, other: torch.Tensor, p) -> dict:
    """Where one chunked ML-20M user half-step's time goes
    (``als.accumulate``, warm, under ``torch.profiler``): device time of the
    uploads from pinned memory, kernel 2's two passes, the zero fills and
    the rest (the torch row build: gather, weights, outer products), with
    the half-step's wall time and the device's idle share."""
    from predictionio_tpu_torch.ops import als

    als.accumulate(staged, other, p, "chunked")
    wall, idle, device_ms = profile_idle(
        lambda: als.accumulate(staged, other, p, "chunked")
    )
    groups = {"uploads": 0.0, "row_build": 0.0, "kernel2_pass1": 0.0,
              "kernel2_pass2": 0.0, "zero_fill": 0.0}
    for name, ms in device_ms.items():
        if "HtoD" in name:
            key = "uploads"
        elif "reduce_carries" in name:
            key = "kernel2_pass2"
        elif "accum_" in name:
            key = "kernel2_pass1"
        elif "Memset" in name or "FillFunctor" in name:
            key = "zero_fill"
        else:
            key = "row_build"
        groups[key] += ms
    return {
        "wall_ms": 1e3 * wall,
        "device_idle_share": idle,
        "device_ms": groups,
        "device_ms_by_name": dict(sorted(device_ms.items(), key=lambda kv: -kv[1])[:12]),
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


def pallas_step_share(before: dict, iterations: int) -> dict:
    """The live roofline of the train just run: ``als.pallas_step``'s
    least-work cost over its observed wall time per iteration, as
    ``/efficiency.json`` reads it (the cumulative totals' growth since
    ``before``), against the card's peak row: its share of the HBM rate
    and of the fp32 rate, each in (0, 1.05]."""
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.obs.metrics import REGISTRY

    after = device_obs.default_efficiency().snapshot()["functions"]["als.pallas_step"]
    calls = after["calls"] - before.get("calls", 0)
    secs = after["seconds_total"] - before.get("seconds_total", 0.0)
    nbytes = after["bytes_total"] - before.get("bytes_total", 0.0)
    flops = after["flops_total"] - before.get("flops_total", 0.0)
    peaks = device_obs.device_peaks()
    share = {"hbm": nbytes / secs / 1e9 / peaks.hbm_gbps,
             "fp32": flops / secs / 1e12 / peaks.tflops}
    gauge = REGISTRY.get("pio_device_utilization_frac").labels(
        "als.pallas_step", "hbm").value
    assert calls == 1 and after["source"] == "least_work", after
    assert all(0 < v <= 1.05 for v in share.values()), share
    assert abs(gauge - share["hbm"]) <= 1e-3 * share["hbm"], (gauge, share)
    return {"share": share, "per_iteration_s": secs,
            "iterations_s": secs * iterations, "bytes_per_iteration": nbytes,
            "flops_per_iteration": flops, "peak_row": peaks.source}


def train_ml20m_phase() -> tuple[dict, dict, dict, tuple]:
    """``train_als`` at the ML-20M shape: 20 iterations fused (cold, then
    warm under torch.profiler), then 3 forced chunked, each cold train's
    peak of device memory, then the OOM ladder between them; per half-step
    accumulate and solve times, staging, idle share, RMSE, and each
    kernel checked and timed at this shape.  Also returns the generated
    ratings, which the ALS family's train reuses."""
    from predictionio_tpu_torch.obs import device as device_obs
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
    eff0 = device_obs.default_efficiency().snapshot()["functions"].get(
        "als.pallas_step", {})
    # -- the main path, fused, with every launch count at 0 just before it --
    reset_launches()
    t0 = time.perf_counter()
    st = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p, device="cuda")
    out["cold_train_s"] = time.perf_counter() - t0
    out["fused_launches"] = read_launches()
    # -- end --
    out["pallas_step"] = pallas_step_share(eff0, ITERATIONS)
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
    # the train's roofline (wall time of the iterations) beside kernel 1's
    # CUDA-event time for the 40 half-steps' accumulations (user half-step
    # time x 40)
    out["pallas_step"]["kernel1_user_half_step_ms_x40"] = 40 * fused_t["ms"]
    print(f"pallas_step: share {out['pallas_step']['share']} at "
          f"{out['pallas_step']['iterations_s']:.4f} s for {ITERATIONS} iterations; "
          f"kernel 1 CUDA-event time x 40: "
          f"{out['pallas_step']['kernel1_user_half_step_ms_x40']:.3f} ms", flush=True)
    del su, si

    # -- the main path, chunked, with every launch count at 0 just before it --
    p3 = dataclasses.replace(p, num_iterations=3, pallas_mode="chunked")
    base = fresh_peak()
    eff0 = device_obs.default_efficiency().snapshot()["functions"]["als.pallas_step"]
    reset_launches()
    t0 = time.perf_counter()
    st3 = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p3, device="cuda")
    out["chunked_train_s"] = time.perf_counter() - t0
    out["chunked_launches"] = read_launches()
    # -- end --
    # the chunked rung on the roofline: kernel 2's least work per iteration
    out["pallas_step_chunked"] = pallas_step_share(eff0, 3)
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
    out["chunked_half_step_user_breakdown"] = chunked_breakdown(cu, Vp, p3)
    chunk_t = chunk_timing(cu, Vp, p3)
    # the same user chunk at rank 32 (random factors): width 1,152, 113 tiles
    wide = torch.from_numpy(
        np.random.default_rng(SEED + 7).standard_normal((ni_pad, 32))
        .astype(np.float32)
    ).cuda()
    chunk_t["wide"] = chunk_timing(cu, wide, p3)
    del cu, ci, wide
    out["oom_ladder"] = oom_ladder(u, i, r, p3, out["fused_peak"],
                                   out["chunked_peak"], st3)
    return out, fused_t, chunk_t, (u, i, r)


# -- the ALS family (similarproduct, recommendeduser, ecommerce) --------------

#: categories of the ALS family's catalogs: 1-3 of 40 per item
CATEGORIES = 40
#: the ecommerce event store at the ML-20M shape holds only what live reads
#: touch: the view/buy events of KNOWN_USERS users of the stream, the
#: RECENT_VIEWS latest views of COLD_USERS users outside the vocabulary,
#: NO_EVENT_USERS users with nothing, and an unavailableItems $set
KNOWN_USERS, COLD_USERS, NO_EVENT_USERS, RECENT_VIEWS = 256, 64, 32, 10
UNAVAILABLE_ITEMS = 100
FAMILY_CLIENTS, FAMILY_QUERIES = 16, 1024
#: the first event time of the generated streams (2015-01-01), epoch ms
T_BASE_MS = 1_420_070_400_000


def item_categories(n_items: int, rng) -> list[tuple[str, ...]]:
    """1-3 distinct categories of CATEGORIES per item."""
    picks = np.argsort(rng.random((n_items, CATEGORIES)), axis=1)[:, :3]
    counts = rng.integers(1, 4, n_items)
    return [tuple(f"c{c}" for c in row[:k]) for row, k in zip(picks, counts)]


def ecomm_stream(u, i, r, seed: int):
    """An ecommerce event stream from ``movielens_like`` ratings: every
    rating becomes a ``view``, those of 4.5 stars and more also a ``buy``;
    event times are distinct, in an order drawn from ``seed``.  Returns
    (user, item, is_buy, time_ms) columns."""
    buy = r >= 4.5
    ev_u = np.concatenate([u, u[buy]])
    ev_i = np.concatenate([i, i[buy]])
    is_buy = np.zeros(len(ev_u), bool)
    is_buy[len(u):] = True
    rng = np.random.default_rng(seed + 1)
    times = T_BASE_MS + rng.permutation(len(ev_u)).astype(np.int64) * 1000
    return ev_u, ev_i, is_buy, times


def persist_instance(storage, factory: str, engine_id: str, params, blob) -> str:
    """``blob`` saved as the model of a new COMPLETED engine instance."""
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance

    now = datetime.now(tz=timezone.utc)
    instance = EngineInstance(
        id=uuid.uuid4().hex, status="COMPLETED", start_time=now, end_time=now,
        engine_id=engine_id, engine_version="default", engine_variant="default",
        engine_factory=factory, **params.to_json_fields(),
    )
    storage.engine_instances().insert(instance)
    save_models(storage.models(), instance.id, [blob])
    return instance.id


def als_family_train_phase(storage, ratings) -> tuple[dict, dict]:
    """``ECommAlgorithm.train`` on the card at the ML-20M shape: implicit
    ALS (alpha 1, rank 10, 20 iterations) over a view/buy stream built in
    memory, under ``torch.profiler``; stage seconds, kernel 1's launches and
    the device's idle share; kernel 1 then held to its plain version on the
    implicit stream's first user half-step and timed there.  The model is
    persisted as an ``ecommerce`` engine instance.  ``ratings`` are
    ``train_ml20m``'s (the same generator and seed).  Returns the phase
    line and what the serving phase needs."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.models.ecommerce import engine as ec
    from predictionio_tpu_torch.ops import als

    out: dict = {"phase": "als_family_train", "factory": "ecommerce",
                 "shape": [ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS],
                 "rank": RANK, "iterations": ITERATIONS, "alpha": 1.0}
    t_phase = t0 = time.perf_counter()
    ev_u, ev_i, is_buy, times = ecomm_stream(*ratings, SEED + 30)
    rng = np.random.default_rng(SEED + 31)
    cats = item_categories(ML20M_ITEMS, rng)
    users = [f"u{n}" for n in range(ML20M_USERS)]
    user_names = np.array(users, dtype=object)
    item_names = np.array([f"i{n}" for n in range(ML20M_ITEMS)], dtype=object)
    events = np.full(len(ev_u), "view", dtype=object)
    events[is_buy] = "buy"
    td = ec.TrainingData(
        users=users,
        items={name: ec.Item(categories=c) for name, c in zip(item_names, cats)},
        int_users=user_names[ev_u], int_items=item_names[ev_i], int_events=events,
        int_ratings=np.ones(len(ev_u), np.float32), int_times=times,
    )
    out["generate_s"] = time.perf_counter() - t0
    out["events"] = {"view": int((~is_buy).sum()), "buy": int(is_buy.sum())}
    params = ec.ECommAlgorithmParams(app_name="ml20m", rank=RANK,
                                     num_iterations=ITERATIONS)
    algo = ec.ECommAlgorithm(params)
    ctx = EngineContext(storage=storage, device="cuda")
    base = fresh_peak()
    box: list = []
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    wall, idle, device_ms = profile_idle(lambda: box.append(algo.train(ctx, td)))
    launches = read_launches()
    # -- end --
    (model,) = box
    stages = dict(ec.LAST_TRAIN_STAGES)
    assert launches["als_fused_accum"] == 2 * ITERATIONS, launches
    assert als.LAST_PLAN_INFO["mode"] == "fused", als.LAST_PLAN_INFO
    uploads = sum(ms for k, ms in device_ms.items() if "HtoD" in k)
    busy = sum(device_ms.values()) - uploads
    out.update(
        train_s=wall, stage_s=stages, launches=launches,
        nnz=als.LAST_PLAN_INFO["nnz"],
        device_idle_share=idle,
        device_idle_share_iterations=1.0 - busy / (1e3 * stages["iterations"]),
        device_ms_by_kernel=dict(sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]),
        peak=peak_since(base),
    )
    U = model.user_factors.cpu().numpy()
    V = model.item_factors.cpu().numpy()
    assert np.isfinite(U).all() and np.isfinite(V).all()
    assert int(model.popular_counts.sum()) == out["events"]["buy"]
    # kernel 1 on the implicit stream's first user half-step
    su, _ = next(iter(als._STAGE_CACHE.values()))
    p = als.ALSParams(rank=RANK, implicit_prefs=True, alpha=1.0)
    ni_pad = (ML20M_ITEMS + 127) // 128 * 128
    kernel = fused_timing(su, pad_rows(model.item_factors, ni_pad), p)
    out["kernel1_implicit_user_half_step"] = kernel
    del su
    t0 = time.perf_counter()
    blob = algo.make_persistent_model(ctx, model)
    instance_id = persist_instance(
        storage, "ecommerce", "ecomm-ml20m",
        EngineParams(datasource=("", ec.DataSourceParams(app_name="ml20m")),
                     algorithms=(("ecomm", params),), serving=("", None)),
        blob)
    out["persist_s"] = time.perf_counter() - t0
    out["instance"] = instance_id
    out["phase_s"] = time.perf_counter() - t_phase
    served = {"instance": instance_id, "blob": blob, "cats": cats,
              "stream": (ev_u, ev_i, is_buy, times)}
    return out, served


class EcommPlain:
    """The plain CPU answer of an ecommerce query from the persisted host
    factors and the events the store holds: the template's business rules
    (seen items, unavailable items, lists, categories) as a numpy mask, then
    the known-user dot product, the cold user's summed cosine over its
    latest views, or popularity; a stable sort (value desc, id asc) and
    ``num + 1`` entries, the last one the neighbour a near tie is judged
    on."""

    def __init__(self, blob, seen, recent, unavailable):
        self.U, self.V = blob["user_factors"], blob["item_factors"]
        self.pop = np.asarray(blob["popular_counts"])
        self.uvocab = {k: n for n, k in enumerate(blob["user_vocab"])}
        self.inames = list(blob["item_vocab"])
        self.irow = {k: n for n, k in enumerate(self.inames)}
        self.by_cat: dict = {}
        for name, cs in blob["items"].items():
            for c in cs:
                self.by_cat.setdefault(c, np.zeros(len(self.inames), bool))[
                    self.irow[name]] = True
        self.seen, self.recent, self.unavailable = seen, recent, unavailable
        self.item_norm = np.maximum(np.linalg.norm(self.V, axis=1), 1e-9)

    def _rows(self, names):
        return [self.irow[x] for x in names if x in self.irow]

    def route(self, user: str) -> str:
        if user in self.uvocab:
            return "dot_topk"
        return "cosine_topk" if self.recent.get(user) else "popularity"

    def answer(self, q: dict):
        n = len(self.inames)
        exclude = np.zeros(n, bool)
        if q.get("whiteList") is not None:
            keep = np.zeros(n, bool)
            keep[self._rows(q["whiteList"])] = True
            exclude |= ~keep
        black = set(self.seen.get(q["user"], ())) | self.unavailable
        black |= set(q.get("blackList") or ())
        exclude[self._rows(black)] = True
        if q.get("categories"):
            anyc = np.zeros(n, bool)
            for c in q["categories"]:
                anyc |= self.by_cat.get(c, np.zeros(n, bool))
            exclude |= ~anyc
        route = self.route(q["user"])
        k = min(q.get("num", 10), n) + 1
        if route == "popularity":
            pop = np.where(exclude, -1, self.pop)
            order = np.argsort(-pop, kind="stable")[:k]
            keep = [j for j in order if pop[j] >= 0]
            return [self.inames[j] for j in keep], [float(pop[j]) for j in keep]
        if route == "dot_topk":
            s = self.V @ self.U[self.uvocab[q["user"]]]
        else:
            qf = self.V[self._rows(self.recent[q["user"]])]
            qn = qf / np.maximum(np.linalg.norm(qf, axis=1, keepdims=True), 1e-9)
            s = (self.V @ qn.T).sum(axis=1) / self.item_norm
        s = np.where(exclude, -np.inf, s).astype(np.float32)
        order = np.argsort(-s, kind="stable")[:k]
        keep = [j for j in order if np.isfinite(s[j])]
        return [self.inames[j] for j in keep], [float(s[j]) for j in keep]


def hold_scored(got: list, want: tuple[list, list], num: int, what) -> None:
    """An answer's ``itemScores`` against a plain answer of ``num + 1``
    entries: as many entries as the plain answer has up to ``num``, scores
    within RTOL, ids equal except inside a near tie of the plain scores
    (the (num+1)th included)."""
    ids, scores = want
    n = min(num, len(ids))
    assert len(got) == n, (what, len(got), n)
    np.testing.assert_allclose([x["score"] for x in got], scores[:n],
                               rtol=RTOL, atol=1e-6, err_msg=str(what))
    for c, x in enumerate(got):
        if x["item"] != ids[c]:
            nb = [scores[j] for j in (c - 1, c + 1) if 0 <= j < len(scores)]
            assert min(abs(scores[c] - v) for v in nb) <= RTOL * abs(scores[c]), (what, c)


def post_query(port: int, body: dict) -> tuple[int, dict, float]:
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        data = json.loads(resp.read())
        return resp.status, data, 1e3 * (time.perf_counter() - t0)


def family_queries(rng, users_by_route: dict, item_names, n: int) -> list:
    """``n`` ecommerce queries: half known users, a quarter cold users, a
    quarter users with no events; each with no option, categories, a white
    list or a black list."""
    out = []
    routes = rng.choice(["dot_topk", "dot_topk", "cosine_topk", "popularity"], n)
    for route in routes:
        q = {"user": str(rng.choice(users_by_route[route])),
             "num": int(rng.choice([4, 10, 20]))}
        opt = rng.integers(4)
        if opt == 1:
            q["categories"] = [f"c{c}" for c in rng.choice(CATEGORIES, 2, replace=False)]
        elif opt == 2:
            q["whiteList"] = [str(x) for x in rng.choice(item_names, 300, replace=False)]
        elif opt == 3:
            q["blackList"] = [str(x) for x in rng.choice(item_names, 20, replace=False)]
        out.append(q)
    return out


def ecomm_store_events(served, rng):
    """The events the serving phase writes, and the plain answer's view of
    them: (events, seen items per user, latest views per cold user,
    unavailable items, the users of each route)."""
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event

    ev_u, ev_i, is_buy, times = served["stream"]
    known = rng.choice(ML20M_USERS, KNOWN_USERS, replace=False)
    rows = np.flatnonzero(np.isin(ev_u, known))

    def at(ms):
        return datetime.fromtimestamp(int(ms) / 1000.0, tz=timezone.utc)

    events, seen = [], {}
    for j in rows:
        user, item = f"u{ev_u[j]}", f"i{ev_i[j]}"
        seen.setdefault(user, set()).add(item)
        events.append(Event(event="buy" if is_buy[j] else "view", entity_type="user",
                            entity_id=user, target_entity_type="item",
                            target_entity_id=item, event_time=at(times[j])))
    recent = {}
    t_after = int(times.max()) + 1000
    for c in range(COLD_USERS):
        user = f"cold{c}"
        items = [f"i{x}" for x in rng.integers(0, ML20M_ITEMS, RECENT_VIEWS + 3)]
        for n, item in enumerate(items):  # the last RECENT_VIEWS are the latest
            events.append(Event(event="view", entity_type="user", entity_id=user,
                                target_entity_type="item", target_entity_id=item,
                                event_time=at(t_after + 1000 * n)))
        seen[user] = set(items)
        recent[user] = items[::-1][:RECENT_VIEWS]
    unavailable = {f"i{x}" for x in rng.choice(ML20M_ITEMS, UNAVAILABLE_ITEMS, replace=False)}
    events.append(Event(event="$set", entity_type="constraint", entity_id="unavailableItems",
                        properties=DataMap({"items": sorted(unavailable)}),
                        event_time=at(t_after)))
    users_by_route = {
        "dot_topk": [f"u{x}" for x in known],
        "cosine_topk": list(recent),
        "popularity": [f"none{x}" for x in range(NO_EVENT_USERS)],
    }
    return events, seen, recent, unavailable, users_by_route


def als_family_serving_phase(storage, served) -> dict:
    """The ML-20M-shape ecommerce model through the default deploy (aio,
    micro-batched) on the card, its live reads on an event store that holds
    what they touch: solo queries on each route (known user ``dot_topk``,
    cold user ``cosine_topk``, no signal: popularity), with and without
    categories, a white list and a black list; then 16 keep-alive clients
    sending 1,024 mixed queries.  Every answer is held to the plain CPU
    answer.  Then a seeded similarproduct model at the ML-20M item width
    answers cosine queries with category filters, held the same way."""
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.parallel import device_cache
    from predictionio_tpu_torch.server.prediction_server import create_prediction_server
    from predictionio_tpu_torch.tools import commands as cmd

    out: dict = {"phase": "als_family_serving",
                 "shape": [ML20M_USERS, ML20M_ITEMS, RANK]}
    rng = np.random.default_rng(SEED + 32)
    t_phase = t0 = time.perf_counter()
    app = cmd.app_new(storage, "ml20m").app
    events, seen, recent, unavailable, by_route = ecomm_store_events(served, rng)
    storage.l_events().insert_batch(events, app.id)
    out["store_events"] = len(events)
    out["store_s"] = time.perf_counter() - t0
    plain = EcommPlain(served["blob"], seen, recent, unavailable)
    item_names = np.array([f"i{n}" for n in range(ML20M_ITEMS)])
    server = create_prediction_server(
        "ecommerce", host="127.0.0.1", port=0, storage=storage,
        engine_instance_id=served["instance"]).start_background()
    solo: dict = {}
    try:
        # solo queries: every route with every option, three times each
        for route, users in by_route.items():
            for opt in ({}, {"categories": ["c1", "c7"]},
                        {"whiteList": [str(x) for x in item_names[::89]]},
                        {"blackList": [str(x) for x in item_names[:20]]}):
                for user in users[:3]:
                    q = {"user": user, "num": 10, **opt}
                    status, body, ms = post_query(server.port, q)
                    assert status == 200 and plain.route(user) == route, (status, q)
                    hold_scored(body["itemScores"], plain.answer(q), 10, q)
                    solo.setdefault(route, []).append(ms)
        out["solo_ms"] = {r: v for r, v in solo.items()}
        out["solo_p50_ms"] = {r: statistics.median(v) for r, v in solo.items()}
        mixed = family_queries(rng, by_route, item_names, FAMILY_QUERIES)
        results, wall = drive_clients(
            server.port, [json.dumps(q).encode() for q in mixed], FAMILY_CLIENTS)
    finally:
        server.shutdown()
    codes = sorted({r[0] for r in results})
    assert codes == [200], codes
    for q, (_, _, _, data) in zip(mixed, results):
        hold_scored(json.loads(data)["itemScores"], plain.answer(q), q["num"], q)
    lat = np.asarray([1e3 * r[1] for r in results])
    routes = [plain.route(q["user"]) for q in mixed]
    out["clients"] = {
        "clients": FAMILY_CLIENTS, "queries": FAMILY_QUERIES, "wall_s": wall,
        "queries_per_s": FAMILY_QUERIES / wall,
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "max_ms": float(lat.max()), "non_200": 0,
        "by_route": {r: {"n": int(sum(x == r for x in routes)),
                         "p50_ms": float(np.percentile(lat[[x == r for x in routes]], 50))}
                     for r in by_route},
    }
    out["answers_held"] = len(mixed) + sum(len(v) for v in solo.values())
    out["factor_cache"] = device_cache.stats()

    # similarproduct at the ML-20M item width: seeded factors, as write_model
    srng = np.random.default_rng(SEED + 33)
    V = (np.abs(srng.standard_normal((ML20M_ITEMS, RANK))) / np.sqrt(RANK)).astype(np.float32)
    blob = {"item_factors": V, "item_vocab": item_names,
            "items": {str(k): c for k, c in zip(item_names, served["cats"])}}
    sim_id = persist_instance(
        storage, "similarproduct", "sim-ml20m",
        EngineParams(datasource=("", sp.DataSourceParams(app_name="ml20m")),
                     algorithms=(("als", sp.ALSAlgorithmParams(rank=RANK)),),
                     serving=("", None)), blob)
    by_cat = {f"c{c}": np.zeros(ML20M_ITEMS, bool) for c in range(CATEGORIES)}
    for n, cs in enumerate(served["cats"]):
        for c in cs:
            by_cat[c][n] = True
    inorm = np.maximum(np.linalg.norm(V, axis=1), 1e-9)

    def sim_plain(q):
        rows = sorted({int(x[1:]) for x in q["items"]})
        exclude = np.zeros(ML20M_ITEMS, bool)
        exclude[rows] = True
        if q.get("categories"):
            exclude |= ~np.logical_or.reduce([by_cat[c] for c in q["categories"]])
        if q.get("categoryBlackList"):
            exclude |= np.logical_or.reduce([by_cat[c] for c in q["categoryBlackList"]])
        exclude[[int(x[1:]) for x in q.get("blackList", [])]] = True
        qf = V[rows]
        qn = qf / np.maximum(np.linalg.norm(qf, axis=1, keepdims=True), 1e-9)
        s = np.where(exclude, -np.inf, (V @ qn.T).sum(axis=1) / inorm).astype(np.float32)
        order = np.argsort(-s, kind="stable")[: q["num"] + 1]
        keep = [j for j in order if np.isfinite(s[j]) and s[j] > 0]
        return [f"i{j}" for j in keep], [float(s[j]) for j in keep]

    server = create_prediction_server(
        "similarproduct", host="127.0.0.1", port=0, storage=storage,
        engine_instance_id=sim_id).start_background()
    sim_ms = []
    try:
        for n in range(24):
            q = {"items": [f"i{x}" for x in srng.integers(0, ML20M_ITEMS, 1 + n % 3)],
                 "num": int(srng.choice([5, 10, 50]))}
            if n % 4 == 1:
                q["categories"] = [f"c{c}" for c in srng.choice(CATEGORIES, 2, replace=False)]
            elif n % 4 == 2:
                q["categoryBlackList"] = [f"c{c}" for c in srng.choice(CATEGORIES, 5, replace=False)]
            elif n % 4 == 3:
                q["blackList"] = [f"i{x}" for x in srng.integers(0, ML20M_ITEMS, 30)]
            status, body, ms = post_query(server.port, q)
            assert status == 200, (status, q)
            hold_scored(body["itemScores"], sim_plain(q), q["num"], q)
            sim_ms.append(ms)
    finally:
        server.shutdown()
    out["similarproduct"] = {"instance": sim_id, "queries": len(sim_ms),
                             "p50_ms": statistics.median(sim_ms), "ms": sim_ms}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


@contextlib.contextmanager
def seeded_train_als(module, iterations: int):
    """``module.train_als`` started from factors drawn from one seed and run
    for ``iterations``: the same train on the card and on the CPU."""
    real = module.train_als

    def seeded(u, i, r, num_users, num_items, params, **kw):
        rng = np.random.default_rng(SEED + 42)
        init = tuple(
            (np.abs(rng.standard_normal((n, params.rank))) / np.sqrt(params.rank))
            .astype(np.float32) for n in (num_users, num_items)
        )
        return real(u, i, r, num_users=num_users, num_items=num_items,
                    params=dataclasses.replace(params, num_iterations=iterations),
                    init_factors=init, **kw)

    module.train_als = seeded
    try:
        yield
    finally:
        module.train_als = real


def iso_ms(ms) -> str:
    """Epoch milliseconds as the API's UTC time string."""
    return datetime.fromtimestamp(int(ms) / 1000.0, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.000Z")


def write_shop_events(path: Path) -> dict:
    """An ecommerce app's events at the ML-100K shape, as JSON lines: 943
    user and 1,682 item ``$set`` events (1-3 categories each), the
    ``view``/``buy`` stream of ``ecomm_stream`` and the unavailableItems
    constraint.  Returns the count of views and buys."""
    ev_u, ev_i, is_buy, times = ecomm_stream(*movielens_like(
        ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS, SEED + 40, half_stars=False),
        SEED + 40)
    cats = item_categories(ML100K_ITEMS, np.random.default_rng(SEED + 43))
    t_set = iso_ms(T_BASE_MS - 1000)
    with open(path, "w") as f:
        for n in range(ML100K_USERS):
            f.write('{"event":"$set","entityType":"user","entityId":"u%d",'
                    '"eventTime":"%s"}\n' % (n, t_set))
        for n, c in enumerate(cats):
            f.write('{"event":"$set","entityType":"item","entityId":"i%d",'
                    '"properties":{"categories":%s},"eventTime":"%s"}\n'
                    % (n, json.dumps(list(c)), t_set))
        for j in range(len(ev_u)):
            f.write('{"event":"%s","entityType":"user","entityId":"u%d",'
                    '"targetEntityType":"item","targetEntityId":"i%d",'
                    '"eventTime":"%s"}\n' % ("buy" if is_buy[j] else "view",
                                             ev_u[j], ev_i[j], iso_ms(times[j])))
        f.write('{"event":"$set","entityType":"constraint","entityId":'
                '"unavailableItems","properties":{"items":["i0","i3"]},'
                '"eventTime":"%s"}\n' % t_set)
    return {"view": int((~is_buy).sum()), "buy": int(is_buy.sum())}


def als_family_cli_phase() -> dict:
    """The CLI at the ML-100K shape: one app with 943 user and 1,682 item
    ``$set`` events (with categories), 100,000 ``view`` events, their
    ``buy`` subset and the unavailableItems constraint; ``app new`` ->
    ``import`` -> ``train`` (CUDA) of an ecommerce and a similarproduct
    (``als`` + ``cooccurrence``) engine.json, each deployed for a few solo
    queries held to a CPU deploy of the same instance; then each
    algorithm's train on the card and on the CPU from one start."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.models.ecommerce import engine as ec
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
        deploy_engine,
    )
    from predictionio_tpu_torch.tools import cli

    out: dict = {"phase": "als_family_cli",
                 "shape": [ML100K_USERS, ML100K_ITEMS, ML100K_EVENTS],
                 "rank": RANK, "iterations": ITERATIONS}
    engines = {
        "ecommerce": ("ecomm-cli", [{"name": "ecomm", "params": {
            "appName": "shop", "rank": RANK, "numIterations": ITERATIONS}}],
            [{"user": "u1", "num": 10}, {"user": "u5", "num": 10, "categories": ["c3"]},
             {"user": "nobody", "num": 5}]),
        "similarproduct": ("sim-cli", [
            {"name": "als", "params": {"rank": RANK, "numIterations": ITERATIONS}},
            {"name": "cooccurrence", "params": {"n": 20}}],
            [{"items": ["i1"], "num": 10}, {"items": ["i2", "i40"], "num": 10,
                                             "categories": ["c3", "c9"]}]),
    }
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(tmp / "pio_home")}))
        t_phase = t0 = time.perf_counter()
        out["events"] = write_shop_events(tmp / "events.jsonl")
        out["generate_s"] = time.perf_counter() - t0
        printed = io.StringIO()
        out["train_launches"], out["solo"] = {}, {}
        with contextlib.redirect_stdout(printed):
            assert cli.main(["app", "new", "shop"]) == 0
            t0 = time.perf_counter()
            assert cli.main(["import", "--app", "shop", "--input",
                             str(tmp / "events.jsonl")]) == 0
            out["import_s"] = time.perf_counter() - t0
        for factory, (engine_id, algos, queries) in engines.items():
            path = tmp / f"{engine_id}.json"
            path.write_text(json.dumps({
                "id": engine_id, "engineFactory": factory,
                "datasource": {"params": {"appName": "shop"}}, "algorithms": algos}))
            # -- the main path, with every launch count at 0 just before it --
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                assert cli.main(["train", "--engine-json", str(path),
                                 "--device", "cuda"]) == 0
            out.setdefault("train_cli_s", {})[factory] = time.perf_counter() - t0
            out["train_launches"][factory] = read_launches()
            instance = storage.engine_instances().get_latest_completed(
                engine_id, "default", "default")
            server = create_prediction_server(
                factory, host="127.0.0.1", port=0, storage=storage,
                engine_instance_id=instance.id).start_background()
            answers = []
            try:
                for q in queries:
                    status, body, ms = post_query(server.port, q)
                    assert status == 200, (status, q)
                    answers.append(body["itemScores"])
                    out["solo"].setdefault(factory, []).append(ms)
            finally:
                server.shutdown()
            # -- end --
            assert out["train_launches"][factory]["als_fused_accum"] == 2 * ITERATIONS
            cpu = deploy_engine(factory, storage=storage,
                                engine_instance_id=instance.id, device="cpu")
            for q, got in zip(queries, answers):
                # one algorithm: its top num + 1 holds the neighbour of the
                # last position; the summed serve of two is compared as sent
                extra = 1 if factory == "ecommerce" else 0
                _, want = cpu.predict(cpu.extract_query({**q, "num": q["num"] + extra}))
                ids = [s.item for s in want.item_scores]
                hold_scored(got, (ids, [s.score for s in want.item_scores]),
                            q["num"], (factory, q))
                assert got, (factory, q)
        # each algorithm's train, card and CPU from one start
        ctx_card = EngineContext(storage=storage, device="cuda")
        ctx_cpu = EngineContext(storage=storage, device="cpu")
        diffs = {}
        for name, mod, ds, algo in (
            ("ecommerce", ec, ec.ECommDataSource(ec.DataSourceParams(app_name="shop")),
             ec.ECommAlgorithm(ec.ECommAlgorithmParams(app_name="shop", rank=RANK))),
            ("similarproduct", sp,
             sp.SimilarProductDataSource(sp.DataSourceParams(app_name="shop")),
             sp.ALSAlgorithm(sp.ALSAlgorithmParams(rank=RANK))),
        ):
            td = ds.read_training(ctx_card)
            with seeded_train_als(mod, 5):
                card = algo.train(ctx_card, td)
                cpu = algo.train(ctx_cpu, td)
            diff = float((card.item_factors.cpu() - cpu.item_factors).abs().max())
            if name == "ecommerce":
                diff = max(diff, float(
                    (card.user_factors.cpu() - cpu.user_factors).abs().max()))
            assert diff <= 2e-3, f"{name}: card vs CPU factors differ by {diff}"
            diffs[name] = diff
        out["card_vs_cpu_max_abs_diff"] = diffs
        storage.close()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def als_family_phases(ratings) -> list[dict]:
    """The ALS family on the card: the ecommerce train at the ML-20M shape
    (on ``train_ml20m``'s ratings), its deploy (and a similarproduct one)
    under live reads and clients, and the CLI flow at the ML-100K shape."""
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )

    with tempfile.TemporaryDirectory() as tmp:
        home = Path(tmp) / "pio_home"
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
        try:
            train, served = als_family_train_phase(storage, ratings)
            emit(train)
            lines = [train, als_family_serving_phase(storage, served)]
            emit(lines[-1])
            del served
        finally:
            storage.close()
    lines.append(als_family_cli_phase())
    emit(lines[-1])
    return lines


#: the ingest clients: threads of this script, each with its own keep-alive
#: connection to the event server, a subprocess of its own
INGEST_CLIENTS, INGEST_BATCH, INGEST_SINGLES = 8, 50, 1_000
LIVE_USERS = 8  # the live loop's users, one view POSTed for each
#: the tied slice: the stream's first TIED_EVENTS, TIED_PER_SECOND of them
#: to one second, each second's events spread over 20 batches
TIED_EVENTS, TIED_PER_SECOND = 20_000, 1_000


def spawn_cli(home: Path, argv: list, lines: int, env: dict | None = None):
    """``python -m predictionio_tpu_torch.tools.cli argv`` on ``home`` (with
    ``env`` added to its environment), and the ``lines`` lines it prints
    once its servers are bound.  Its stderr goes to a file beside ``home``
    (``cli_stderr``) and its later stdout is drained, so no pipe fills and
    stalls it."""
    import os

    log = home.parent / f"{argv[0]}.stderr"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv],
            stdout=subprocess.PIPE, stderr=err, text=True,
            env=dict(os.environ, PIO_HOME=str(home), **(env or {})),
            cwd=Path(__file__).resolve().parent,
        )
    proc.stderr_log = log
    printed: list = []
    bound = threading.Event()

    def read():
        printed.extend(proc.stdout.readline() for _ in range(lines))
        bound.set()
        for _ in proc.stdout:
            pass

    threading.Thread(target=read, daemon=True).start()
    bound.wait(timeout=180)
    if len(printed) < lines or not all(printed):
        stop_cli(proc)
        raise RuntimeError(f"{argv[0]} did not start: {printed} {cli_stderr(proc)}")
    return proc, [x.strip() for x in printed]


def cli_stderr(proc) -> str:
    """The end of what a ``spawn_cli`` process wrote to its stderr."""
    return proc.stderr_log.read_text()[-4000:]


def stop_cli(proc) -> int:
    """Interrupt a CLI server (it shuts down as on Ctrl-C), kill it if it
    lingers; returns its exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


def bound_port(line: str) -> int:
    return int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])


def http_call(conn, method: str, path: str, body: bytes | None = None,
              headers: dict | None = None):
    """(status, headers, JSON body, ms) of one request on a keep-alive
    connection."""
    t0 = time.perf_counter()
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    return resp.status, dict(resp.getheaders()), data, 1e3 * (time.perf_counter() - t0)


def run_clients(port: int, requests: list, clients: int) -> tuple[list, float]:
    """``requests`` ((method, path, body, headers) each) spread over
    ``clients`` threads, each on one connection; (per request (status,
    item statuses, ms), wall seconds)."""
    results: list = [None] * len(requests)
    errors: list = []

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for n in range(c, len(requests), clients):
                status, _, data, ms = http_call(conn, *requests[n])
                items = [x["status"] for x in data] if isinstance(data, list) else []
                results[n] = (status, items, ms)
        except Exception as e:  # reported by the caller
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    assert not errors and all(r is not None for r in results), errors[:3]
    return results, wall


def ingest_stats(results: list, wall: float, events: int) -> dict:
    ms = np.asarray([r[2] for r in results])
    non_2xx = sum(not 200 <= r[0] < 300 for r in results) + sum(
        not 200 <= x < 300 for r in results for x in r[1])
    return {"events": events, "requests": len(results), "wall_s": wall,
            "events_per_s": events / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "non_2xx": int(non_2xx)}


def ingest_streams(u, i, r) -> tuple[list, list]:
    """The ML-100K ``rate`` stream as API JSON (one second apart, as
    train_cli's import file), and the INGEST_SINGLES single POSTs after it:
    half ``view`` events to /events.json, a quarter segment.com ``track``
    payloads and a quarter MailChimp ``subscribe`` forms, each event with
    a time of its own.  Singles are (path, body bytes, headers, event)."""
    from urllib.parse import urlencode

    from predictionio_tpu_torch.data.webhooks import (
        form_connectors,
        json_connectors,
        to_event,
    )

    t_base = 874_724_710  # ML-100K's first rating time, epoch seconds
    rates = [
        {"event": "rate", "entityType": "user", "entityId": f"u{u[j]}",
         "targetEntityType": "item", "targetEntityId": f"i{i[j]}",
         "properties": {"rating": int(r[j])}, "eventTime": iso_ms(1000 * (t_base + j))}
        for j in range(len(r))
    ]
    t_single = 1000 * (t_base + len(r))
    seg, chimp = json_connectors()["segmentio"], form_connectors()["mailchimp"]
    singles = []
    for n in range(INGEST_SINGLES):
        user = f"u{n % ML100K_USERS}"
        if n % 2 == 0:
            ev = {"event": "view", "entityType": "user", "entityId": user,
                  "targetEntityType": "item", "targetEntityId": f"i{n % ML100K_ITEMS}",
                  "properties": {}, "eventTime": iso_ms(t_single + 1000 * n)}
            singles.append(("/events.json", json.dumps(ev).encode(),
                            {"Content-Type": "application/json"}, ev))
        elif n % 4 == 1:
            payload = {"version": "2", "type": "track", "userId": user,
                       "event": "Opened App", "properties": {"n": n},
                       "timestamp": iso_ms(t_single + 1000 * n)}
            singles.append(("/webhooks/segmentio.json", json.dumps(payload).encode(),
                            {"Content-Type": "application/json"},
                            to_event(seg, payload).to_api_dict()))
        else:
            fired = datetime.fromtimestamp(t_single / 1000 + n, tz=timezone.utc)
            form = {"type": "subscribe", "fired_at": fired.strftime("%Y-%m-%d %H:%M:%S"),
                    "data[id]": user, "data[list_id]": "ml100k",
                    "data[email]": f"{user}@example.com", "data[merges][N]": str(n)}
            singles.append(("/webhooks/mailchimp.form", urlencode(form).encode(),
                            {"Content-Type": "application/x-www-form-urlencoded"},
                            to_event(chimp, form).to_api_dict()))
    return rates, singles


def tied_stream(rates: list) -> list:
    """The first TIED_EVENTS rate events, each taking the time of the first
    event of its group of TIED_PER_SECOND, as SDK clients with clocks of
    one second send them."""
    return [{**e, "eventTime": rates[j - j % TIED_PER_SECOND]["eventTime"]}
            for j, e in enumerate(rates[:TIED_EVENTS])]


def factor_diff(a: dict, b: dict, users: list, items: list) -> float:
    """Largest difference between two models' factor rows, matched by
    entity id."""
    diff = 0.0
    for side, keys in (("user", users), ("item", items)):
        rows = [{k: n for n, k in enumerate(m[f"{side}_vocab"])} for m in (a, b)]
        fa = a[f"{side}_factors"][[rows[0][k] for k in keys]]
        fb = b[f"{side}_factors"][[rows[1][k] for k in keys]]
        assert np.isfinite(fa).all() and np.isfinite(fb).all()
        diff = max(diff, float(np.abs(fa - fb).max()))
    return diff


def tied_trains(run, storage, tmp: Path, tied: list, engine: dict) -> dict:
    """App ``tied`` (the tied slice over REST, stored in the clients'
    order) against the same events by ``import`` into ``tied_file``, both
    trained on the card.  ``find`` orders by ``eventTime`` alone and the
    vocabularies follow first appearance, so the cold trains may start
    from rows drawn in other orders and are only reported.  Trained again
    from one start (the import-fed cold factors, mapped by entity id,
    ``run_train(warm_start_from=...)``), they are held within the port's
    train tolerance, 2e-3: only the order of each entity's sum differs."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train

    with open(tmp / "tied.jsonl", "w") as f:
        f.writelines(json.dumps(e) + "\n" for e in tied)
    run("app", "new", "tied_file")
    run("import", "--app", "tied_file", "--input", str(tmp / "tied.jsonl"))
    cold = {}
    for app in ("tied", "tied_file"):
        (tmp / f"{app}.json").write_text(json.dumps(
            {**engine, "id": app, "datasource": {"params": {"appName": app}}}))
        cold[app] = run("train", "--engine-json", str(tmp / f"{app}.json"),
                        "--device", "cuda").split("Engine instance: ")[1].split()[0]
    a, b = (load_factors(storage, cold[x]) for x in ("tied", "tied_file"))
    users, items = list(b["user_vocab"]), list(b["item_vocab"])
    assert sorted(a["user_vocab"]) == sorted(users)
    assert sorted(a["item_vocab"]) == sorted(items)
    out = {"cold_vocab_order_equal": list(a["user_vocab"]) == users
           and list(a["item_vocab"]) == items,
           "cold_max_abs_diff": factor_diff(a, b, users, items)}
    warm = {}
    for app in cold:
        eng = resolve_engine_factory("recommendation")()
        params = eng.params_from_json({**engine, "datasource": {"params": {"appName": app}}})
        instance = run_train(eng, params, ctx=EngineContext(storage=storage, device="cuda"),
                             engine_id=f"{app}-one-start", engine_factory="recommendation",
                             storage=storage, warm_start_from=cold["tied_file"])
        warm[app] = load_factors(storage, instance.id)
    diff = factor_diff(warm["tied"], warm["tied_file"], users, items)
    assert diff <= 2e-3, f"tied REST-fed and import-fed factors differ by {diff}"
    out["one_start_max_abs_diff"] = diff
    return out


def canonical(events) -> list[str]:
    """Events as sorted JSON, without ``eventId`` and ``creationTime``."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("eventId", "creationTime")}
        out.append(json.dumps(e, sort_keys=True))
    return sorted(out)


def shed_probe() -> dict:
    """The ingest gate driven past its bound: an event server with
    ``max_write_inflight=2`` over HTTP, its store holding every write until
    released; two writes wait inside, four more answer 503 with
    ``Retry-After``."""
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server.event_server import create_event_server_app
    from predictionio_tpu_torch.server.httpd import AppServer

    with tempfile.TemporaryDirectory() as tmp:
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": tmp}))
        app_id = storage.apps().insert(App(id=0, name="shed"))
        storage.access_keys().insert(AccessKey(key="SHED", appid=app_id))
        levents = storage.l_events()
        real, gate, entered = levents.insert, threading.Event(), threading.Semaphore(0)

        def held_insert(event, app_id, channel_id=None):
            entered.release()
            gate.wait(timeout=60)
            return real(event, app_id, channel_id)

        levents.insert = held_insert
        registry = MetricsRegistry()
        server = AppServer(create_event_server_app(
            storage, registry=registry, max_write_inflight=2), "127.0.0.1", 0)
        server.start_background()
        body = json.dumps({"event": "view", "entityType": "user", "entityId": "u1"}).encode()
        answers: list = []

        def post():
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            try:
                status, headers, _, _ = http_call(conn, "POST", "/events.json?accessKey=SHED",
                                                  body)
                answers.append((status, headers.get("Retry-After")))
            finally:
                conn.close()

        try:
            held = [threading.Thread(target=post, daemon=True) for _ in range(2)]
            for th in held:
                th.start()
            for _ in held:
                assert entered.acquire(timeout=60), "a write never reached the store"
            over = [threading.Thread(target=post, daemon=True) for _ in range(4)]
            for th in over:
                th.start()
            for th in over:
                th.join(timeout=60)
            shed = sorted(answers)
            gate.set()
            for th in held:
                th.join(timeout=60)
        finally:
            gate.set()
            server.shutdown()
            storage.close()
    assert shed == [(503, "1")] * 4, shed
    assert sorted(answers) == [(201, None)] * 2 + [(503, "1")] * 4, answers
    return {"answers": sorted(answers),
            "shed_total": registry.get("pio_shed_total").labels("eventstore").value}


def load_factors(storage, instance_id: str) -> dict:
    from predictionio_tpu_torch.core.persistence import load_models

    (blob,) = load_models(storage.models(), instance_id)
    return blob


def live_loop(home: Path, instance_id: str, key: str, users: list) -> dict:
    """``pio deploy --event-port`` of the ecommerce instance on the card: for
    each user, the top item of an ``unseenOnly`` answer is viewed through
    the event port, and the next answer must leave it out, undegraded."""
    proc, printed = spawn_cli(home, [
        "deploy", "--engine-instance-id", instance_id, "--ip", "127.0.0.1",
        "--port", "0", "--event-port", "0", "--device", "cuda"], 2)
    out: dict = {"printed": printed, "latency_ms": [], "answer_ms": []}
    try:
        event_port, port = bound_port(printed[0]), bound_port(printed[1])
        q = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        ev = http.client.HTTPConnection("127.0.0.1", event_port, timeout=60)
        for user in users:
            query = json.dumps({"user": user, "num": 10}).encode()
            status, headers, before, ms = http_call(q, "POST", "/queries.json", query)
            assert status == 200 and "X-Pio-Degraded" not in headers, (status, headers)
            out["answer_ms"].append(ms)
            top = before["itemScores"][0]["item"]
            t0 = time.perf_counter()
            status, _, _, _ = http_call(ev, "POST", f"/events.json?accessKey={key}",
                                        json.dumps({
                                            "event": "view", "entityType": "user",
                                            "entityId": user, "targetEntityType": "item",
                                            "targetEntityId": top}).encode())
            assert status == 201, status
            status, headers, after, _ = http_call(q, "POST", "/queries.json", query)
            out["latency_ms"].append(1e3 * (time.perf_counter() - t0))
            assert status == 200 and "X-Pio-Degraded" not in headers, (status, headers)
            items = [x["item"] for x in after["itemScores"]]
            assert top not in items, (user, top, items)
            assert items[:9] == [x["item"] for x in before["itemScores"][1:]], user
        q.close()
        ev.close()
    finally:
        out["deploy_exit"] = stop_cli(proc)
    assert out["deploy_exit"] == 0, cli_stderr(proc)
    return out


def compute_app_pids() -> list[int]:
    """PIDs holding a CUDA context, as nvidia-smi lists them."""
    text = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    return [int(x) for x in text.split() if x.strip().isdigit()]


def eventserver_obs(port: int, pid: int, accepted: int) -> dict:
    """The ``pio eventserver`` subprocess's scrape surface (no operator
    key): ``/metrics`` counts every accepted event in
    ``pio_events_ingested_total``, ``/readyz`` answers 200 with both stores
    up, the debug routes do not exist, and the scrapes made no CUDA
    context: the subprocess is not among nvidia-smi's compute apps, and
    their count is what it was before the scrapes."""
    apps_before = compute_app_pids()
    status, text = obs_get(port, "/metrics", key=None)
    assert status == 200
    prom = parse_prometheus(text)
    ingested = sum(v for (n, _), v in prom.items() if n == "pio_events_ingested_total")
    status, ready = obs_get(port, "/readyz", key=None)
    assert status == 200 and ready == {
        "ready": True, "checks": {"event_store": True, "metadata_store": True}}, ready
    assert obs_get(port, "/healthz", key=None)[0] == 200
    assert obs_get(port, "/debug/flight.json", key=None)[0] == 404
    assert obs_get(port, "/metrics.json", key=None)[0] == 200
    apps_after = compute_app_pids()
    assert ingested == accepted, (ingested, accepted)
    assert pid not in apps_after, (pid, apps_after)
    assert len(apps_after) == len(apps_before), (apps_before, apps_after)
    return {"ingested_total": ingested, "readyz": ready["checks"],
            "compute_apps": apps_after, "eventserver_pid": pid,
            "own_pid_listed": os.getpid() in apps_after}


def event_ingest_phase() -> dict:
    """The Lambda path through the port's entry points on a fresh home:
    ``app new`` and ``accesskey new``; ``eventserver --stats`` as a
    subprocess, fed the ML-100K ``rate`` stream by INGEST_CLIENTS threads in
    batches of 50, then INGEST_SINGLES single POSTs (events and both
    webhooks); ``export`` equal to what was sent, ``/stats.json`` counting
    it; the ingest gate shedding; ``train`` on the card over the ingested
    events (kernel 1) held to a train of the same events by ``import``;
    the tied slice (``tied_trains``), whose events share their seconds;
    ``batchpredict`` of every user (kernel 3) held to the host answer; and
    ``deploy --event-port`` of an ecommerce engine whose next answer
    reflects a view POSTed to its event port."""
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.ops.topk import host_topk_batch
    from predictionio_tpu_torch.tools import cli

    out: dict = {"phase": "event_ingest",
                 "shape": [ML100K_USERS, ML100K_ITEMS, ML100K_EVENTS],
                 "rank": RANK, "iterations": ITERATIONS, "clients": INGEST_CLIENTS,
                 "nvidia_smi": nvidia_smi_line()}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        home = tmp / "pio_home"
        storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(home)}))
        u, i, r = movielens_like(ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS,
                                 SEED + 10, half_stars=False)
        rates, singles = ingest_streams(u, i, r)
        printed = io.StringIO()

        def run(*argv) -> str:
            """One CLI verb in this process; its stdout."""
            mark = printed.tell()
            with contextlib.redirect_stdout(printed):
                assert cli.main(list(argv)) == 0, argv
            return printed.getvalue()[mark:]

        run("app", "new", "ingest")
        key = json.loads(run("accesskey", "new", "ingest"))["key"]
        tied_key = json.loads(run("app", "new", "tied"))["accessKeys"][0]["key"]
        proc, started = spawn_cli(home, ["eventserver", "--ip", "127.0.0.1", "--port", "0",
                                         "--stats"], 1)
        try:
            port = bound_port(started[0])
            path = f"/batch/events.json?accessKey={key}"
            batches = [("POST", path, json.dumps(rates[lo:lo + INGEST_BATCH]).encode(),
                        {"Content-Type": "application/json"})
                       for lo in range(0, len(rates), INGEST_BATCH)]
            res, wall = run_clients(port, batches, INGEST_CLIENTS)
            out["batches"] = ingest_stats(res, wall, len(rates))
            res, wall = run_clients(
                port, [("POST", f"{p}?accessKey={key}", b, h) for p, b, h, _ in singles],
                INGEST_CLIENTS)
            out["singles"] = ingest_stats(res, wall, len(singles))
            out["non_2xx"] = out["batches"]["non_2xx"] + out["singles"]["non_2xx"]
            assert out["non_2xx"] == 0, out
            # the store holds exactly what was sent
            t0 = time.perf_counter()
            run("export", "--app", "ingest", "--output", str(tmp / "export.jsonl"))
            out["export_s"] = time.perf_counter() - t0
            exported = [json.loads(x) for x in (tmp / "export.jsonl").read_text().splitlines()]
            sent = rates + [e for _, _, _, e in singles]
            assert len(exported) == len(sent), (len(exported), len(sent))
            assert canonical(exported) == canonical(sent), "export differs from the stream"
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            status, _, stats, _ = http_call(conn, "GET", f"/stats.json?accessKey={key}")
            conn.close()
            hour = stats["currentHour"]
            counted = sum(x["count"] for x in hour["basic"]) + sum(
                x["count"] for x in stats.get("previousHour", {}).get("basic", []))
            assert status == 200 and counted == len(sent), (status, counted)
            out["stats_counted"] = counted
            out["eventserver_obs"] = eventserver_obs(port, proc.pid, len(sent))
            out["shed"] = shed_probe()
            tied = tied_stream(rates)
            res, wall = run_clients(port, [
                ("POST", f"/batch/events.json?accessKey={tied_key}",
                 json.dumps(tied[lo:lo + INGEST_BATCH]).encode(),
                 {"Content-Type": "application/json"})
                for lo in range(0, len(tied), INGEST_BATCH)], INGEST_CLIENTS)
            out["tied"] = {**ingest_stats(res, wall, len(tied)),
                           "per_second": TIED_PER_SECOND}
            assert out["tied"]["non_2xx"] == 0, out["tied"]

            # pio train over the ingested events, the event server still up
            engine = {"engineFactory": "recommendation", "algorithms": [
                {"name": "als", "params": {"rank": RANK, "numIterations": ITERATIONS,
                                           "lambda": 0.01, "seed": 3}}]}
            for app in ("ingest", "imported"):
                (tmp / f"{app}.json").write_text(json.dumps(
                    {**engine, "id": app, "datasource": {"params": {"appName": app}}}))
            reset_launches()
            t0 = time.perf_counter()
            rest_id = run("train", "--engine-json", str(tmp / "ingest.json"),
                          "--device", "cuda").split("Engine instance: ")[1].split()[0]
            out["train_s"] = time.perf_counter() - t0
            out["train_launches"] = read_launches()
        finally:
            out["eventserver_exit"] = stop_cli(proc)
        assert out["eventserver_exit"] == 0, cli_stderr(proc)
        assert out["train_launches"]["als_fused_accum"] == 2 * ITERATIONS, out
        # the same events by pio import, trained from the same seeded start
        with open(tmp / "rates.jsonl", "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in rates)
        run("app", "new", "imported")
        t0 = time.perf_counter()
        run("import", "--app", "imported", "--input", str(tmp / "rates.jsonl"))
        out["import_s"] = time.perf_counter() - t0
        file_id = run("train", "--engine-json", str(tmp / "imported.json"),
                      "--device", "cuda").split("Engine instance: ")[1].split()[0]
        a, b = load_factors(storage, rest_id), load_factors(storage, file_id)
        assert list(a["user_vocab"]) == list(b["user_vocab"])
        assert list(a["item_vocab"]) == list(b["item_vocab"])
        U, V = a["user_factors"], a["item_factors"]
        assert np.isfinite(U).all() and np.isfinite(V).all()
        diff = max(float(np.abs(U - b["user_factors"]).max()),
                   float(np.abs(V - b["item_factors"]).max()))
        assert diff <= 1e-5, f"REST-fed and import-fed factors differ by {diff}"
        out["rest_vs_import_max_abs_diff"] = diff
        out["tied"].update(tied_trains(run, storage, tmp, tied, engine))

        # pio batchpredict of every user: one device wave
        users = list(a["user_vocab"])
        (tmp / "q.jsonl").write_text("".join(
            json.dumps({"user": x, "num": 10}) + "\n" for x in users))
        reset_launches()
        t0 = time.perf_counter()
        run("batchpredict", "--engine-instance-id", rest_id, "--input", str(tmp / "q.jsonl"),
            "--output", str(tmp / "p.jsonl"), "--device", "cuda")
        torch.cuda.synchronize()
        out["batchpredict_s"] = time.perf_counter() - t0
        out["batchpredict_launches"] = read_launches()
        assert out["batchpredict_launches"]["fused_topk"] == 1, out["batchpredict_launches"]
        uvocab = {k: n for n, k in enumerate(users)}
        ivocab = list(a["item_vocab"])

        def host(user):
            s, idx = host_topk_batch(U[[uvocab[str(user)]]] @ V.T, 11)
            return [ivocab[j] for j in idx[0]], [float(x) for x in s[0]]

        lines = [json.loads(x) for x in (tmp / "p.jsonl").read_text().splitlines()]
        assert len(lines) == len(users)
        for user, line in zip(users, lines):
            hold_scored(line["prediction"]["itemScores"], host(user), 10, user)
        out["rows_checked_vs_host"] = len(lines)

        # the live loop: an ecommerce engine served beside its event port
        shop = json.loads(run("app", "new", "shop"))
        write_shop_events(tmp / "shop.jsonl")
        run("import", "--app", "shop", "--input", str(tmp / "shop.jsonl"))
        (tmp / "shop.json").write_text(json.dumps({
            "id": "shop", "engineFactory": "ecommerce",
            "datasource": {"params": {"appName": "shop"}},
            "algorithms": [{"name": "ecomm", "params": {
                "appName": "shop", "rank": RANK, "numIterations": ITERATIONS}}]}))
        shop_id = run("train", "--engine-json", str(tmp / "shop.json"),
                      "--device", "cuda").split("Engine instance: ")[1].split()[0]
        storage.close()
        out["live"] = live_loop(home, shop_id, shop["accessKeys"][0]["key"],
                                [f"u{n}" for n in range(1, 1 + LIVE_USERS)])
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- the NCF template at the ML-20M shape, and pio eval at ML-100K ------------

#: the pretraining recipe (the JAX package's bench flagship at rank 32): the
#: pure-GMF tables from implicit ALS, then one epoch of low-rate
#: full_softmax with decoupled decay
NCF_PRETRAIN = dict(embed_dim=32, mlp_layers=(), loss="full_softmax",
                    learning_rate=1e-4, weight_decay=1e-4, num_epochs=1,
                    pretrain="als")
#: steps of the steady window profiled for the device's idle share
NCF_PROFILE_STEPS = 40
#: solo queries per front end, and the queued burst / batch job's queries
NCF_SOLO, NCF_BURST = 64, 4096
#: answers of the burst and of the batch job held to the numpy host answer
#: (each host answer runs the MLP tower over the whole catalog on the CPU)
NCF_HELD = 256
#: one step on the card against the CPU's: the loss within NCF_STEP_RTOL,
#: each gradient entry within NCF_GRAD_RTOL of its leaf's largest (sums of
#: 8,192 float32 terms in another order: about sqrt(8192) * 2^-24 = 5e-6 of
#: the terms' absolute sum, which exceeds the largest entry of a leaf whose
#: terms cancel, such as a bias under ReLU masks); then the
#: card's parameters after the step against the CPU's Adam replayed from
#: the same start with the card's gradient, within NCF_STEP_ATOL +
#: NCF_STEP_ATOL * |parameter| (a few float32 ulps: Adam's update is rounded
#: in another order).  Comparing the update to a CPU step from the CPU's own
#: gradient instead would hold the rounding of entries with |g| below Adam's
#: eps (1e-8), where the step is lr * g / eps: 1e5 times the gradient's
#: rounding.
NCF_STEP_RTOL, NCF_GRAD_RTOL, NCF_STEP_ATOL = 1e-5, 1e-4, 1e-6


def ml20m_prepared(ratings):
    """``train_ml20m``'s ratings as the ncf template's PreparedData (users
    ``u<n>``, items ``i<n>``, vocabulary order = index)."""
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.recommendation import engine as rec

    u, i, r = ratings
    return rec.PreparedData(
        user_vocab=BiMap.from_keys([f"u{n}" for n in range(ML20M_USERS)]),
        item_vocab=BiMap.from_keys([f"i{n}" for n in range(ML20M_ITEMS)]),
        user_idx=u, item_idx=i, ratings=r,
    )


def ncf_step_hold(params: dict, p, n_items: int, u, pos, rng) -> dict:
    """One ``train_step`` on the card against the same step on the CPU, from
    the same parameters, batch and negatives (see NCF_STEP_*)."""
    from predictionio_tpu_torch.ops import ncf

    def fresh(dev):
        leaves = ncf.tree_map(
            lambda x: x.detach().to(dev).clone().requires_grad_(True), params)
        return leaves, ncf.make_optimizer(leaves, p)

    b = len(u)
    batch = (torch.from_numpy(u.astype(np.int64)), torch.from_numpy(pos.astype(np.int64)),
             torch.from_numpy(rng.integers(0, n_items, (b, 1))), torch.ones(b),
             torch.zeros(b))
    runs = {}
    for dev in ("cpu", "cuda"):
        leaves, opt = fresh(dev)
        loss = ncf.train_step(leaves, opt, *(x.to(dev) for x in batch), p, n_items)
        runs[dev] = (float(loss), ncf.host_params(leaves),
                     ncf.tree_map(lambda x: x.grad.cpu().numpy(), leaves))
    (l_cpu, _, g_cpu), (l_gpu, p_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    assert abs(l_gpu - l_cpu) <= NCF_STEP_RTOL * abs(l_cpu), (l_gpu, l_cpu)
    # the card's update, replayed on the CPU from the card's gradient
    leaves, opt = fresh("cpu")
    for leaf, g in zip(ncf.tree_leaves(leaves), ncf.tree_leaves(g_gpu)):
        leaf.grad = torch.from_numpy(g)
    opt.step()
    replay = ncf.host_params(leaves)
    out = {"loss_cpu": l_cpu, "loss_card": l_gpu, "grad_max_rel_err": 0.0,
           "param_max_abs_err": 0.0, "entries": 0}
    for gc, gg, pr, pg in zip(*(ncf.tree_leaves(t) for t in (g_cpu, g_gpu, replay, p_gpu))):
        top = float(np.abs(gc).max()) or 1.0
        rel = float(np.abs(gg - gc).max()) / top
        assert rel <= NCF_GRAD_RTOL, (gc.shape, rel)
        diff = np.abs(pg - pr)
        assert (diff <= NCF_STEP_ATOL * (1.0 + np.abs(pr))).all(), (
            gc.shape, float(diff.max()))
        out["grad_max_rel_err"] = max(out["grad_max_rel_err"], rel)
        out["param_max_abs_err"] = max(out["param_max_abs_err"], float(diff.max()))
        out["entries"] += int(gc.size)
    return out


def ncf_train_phase(storage, ratings) -> tuple[dict, dict]:
    """The ncf template's ``NCFAlgorithm.train`` on the card at the ML-20M
    shape (positives: ratings >= 4.0): (a) the defaults (embed 32, MLP
    (64, 32, 16), bpr, one negative, batch 8,192, 5 epochs), each epoch's
    seconds and loss, the step time and the device's idle share over a
    steady window, one step held to the CPU's; (b) the pretraining recipe
    (NCF_PRETRAIN): implicit ALS at rank 32 through kernel 1 (40 launches),
    kernel 1 then held to its plain version on that stream and timed
    there.  (a)'s model is persisted for the serving phase."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.models.ncf import engine as ncf_engine
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.ops import als, ncf

    out: dict = {"phase": "ncf_train",
                 "shape": [ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS]}
    t_phase = time.perf_counter()
    pd = ml20m_prepared(ratings)
    positives = pd.ratings >= 4.0
    pos_u, pos_i = pd.user_idx[positives], pd.item_idx[positives]
    out["positives"] = int(positives.sum())
    ctx = EngineContext(storage=storage, device="cuda")

    # (a) the template's defaults
    params = ncf_engine.NCFAlgorithmParams()
    algo = ncf_engine.NCFAlgorithm(params)
    base = fresh_peak()
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    t0 = time.perf_counter()
    model = algo.train(ctx, pd)
    train_s = time.perf_counter() - t0
    launches = read_launches()
    # -- end --
    st = model.state
    p = st.config
    n_steps = -(-out["positives"] // p.batch_size)
    losses = st.epoch_losses
    assert len(losses) == p.num_epochs and np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    model.sanity_check()
    # a steady window of the same epoch loop under torch.profiler
    stream = ncf.stage_stream(pos_u, pos_i, p, torch.device("cuda"))
    window = dataclasses.replace(
        stream, n_steps=NCF_PROFILE_STEPS,
        **{k: getattr(stream, k)[: NCF_PROFILE_STEPS * stream.batch]
           for k in ("u", "i", "valid", "w")})
    leaves = ncf.tree_map(lambda x: x.clone().requires_grad_(True), st.params)
    opt = ncf.make_optimizer(leaves, p)
    gen = torch.Generator(device="cuda").manual_seed(p.seed)
    cdf = torch.from_numpy(ncf.negative_sampling_cdf(pos_i, ML20M_ITEMS, 0.0)).cuda()
    ncf.train_epoch(leaves, opt, window, p, ML20M_ITEMS, gen, cdf)  # warm
    wall, idle, device_ms = profile_idle(
        lambda: ncf.train_epoch(leaves, opt, window, p, ML20M_ITEMS, gen, cdf))
    rng = np.random.default_rng(SEED + 40)
    pick = rng.choice(len(pos_u), p.batch_size, replace=False)
    out["defaults"] = {
        "params": dataclasses.asdict(params),
        "train_s": train_s,
        "epoch_s": st.epoch_seconds,
        "epoch_loss": losses,
        "steps_per_epoch": n_steps,
        "step_ms": 1e3 * float(np.mean(st.epoch_seconds)) / n_steps,
        "window_step_ms": 1e3 * wall / NCF_PROFILE_STEPS,
        "window_device_idle_share": idle,
        "window_device_ms_by_kernel": dict(
            sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]),
        "peak": peak_since(base),
        "launches": launches,
        "step_vs_cpu": ncf_step_hold(st.params, p, ML20M_ITEMS, pos_u[pick],
                                     pos_i[pick], rng),
    }
    del leaves, opt, stream, window
    blob = algo.make_persistent_model(ctx, model)
    instance_id = persist_instance(
        storage, "ncf", "ncf-ml20m",
        EngineParams(datasource=("", rec.DataSourceParams(app_name="ml20m")),
                     algorithms=(("ncf", params),), serving=("", None)),
        blob)
    served = {"instance": instance_id, "host": blob["params"]}
    del model, st

    # (b) the pretraining recipe: kernel 1 at rank 32
    pre = ncf_engine.NCFAlgorithmParams(**NCF_PRETRAIN)
    base = fresh_peak()
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    t0 = time.perf_counter()
    model_b = ncf_engine.NCFAlgorithm(pre).train(ctx, pd)
    pre_s = time.perf_counter() - t0
    pre_launches = read_launches()
    # -- end --
    assert pre_launches["als_fused_accum"] == 2 * ITERATIONS, pre_launches
    assert als.LAST_PLAN_INFO["rank"] == 32 and als.LAST_PLAN_INFO["mode"] == "fused"
    model_b.sanity_check()
    assert np.isfinite(model_b.state.epoch_losses).all()
    su, _ = next(iter(als._STAGE_CACHE.values()))
    ni_pad = (ML20M_ITEMS + 127) // 128 * 128
    p32 = als.ALSParams(rank=32, implicit_prefs=True, alpha=pre.alpha)
    kernel = fused_timing(su, pad_rows(model_b.state.params["item_emb"], ni_pad), p32)
    out["pretrain"] = {
        "params": dataclasses.asdict(pre),
        "train_s": pre_s,
        "als_stage_s": als.LAST_PLAN_INFO["stage_s"],
        "als_plan": {k: v for k, v in als.LAST_PLAN_INFO.items() if k != "stage_s"},
        "epoch_s": model_b.state.epoch_seconds,
        "epoch_loss": model_b.state.epoch_losses,
        "peak": peak_since(base),
        "launches": pre_launches,
        "kernel1_rank32_implicit_user_half_step": kernel,
    }
    del su, model_b
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line()
    return out, served


def ncf_host_answer(hp: dict, uidx: int, num: int) -> tuple[list, list]:
    """The numpy host replica's num + 1 best (``_host_score_topk``)."""
    from predictionio_tpu_torch.models.ncf.engine import _host_score_topk

    s, idx = _host_score_topk(hp, uidx, ML20M_ITEMS, num + 1)
    return [f"i{j}" for j in idx], [float(x) for x in s]


def ncf_serving_phase(storage, served) -> dict:
    """(a)'s model through the default deploy on the card: solo queries on
    one keep-alive connection to the asyncio front end (device waves of one)
    and to the threaded server (the host replica, held to the numpy answer
    exactly); a 4,096-query burst queued on the micro-batcher (device waves
    of 32); one ``run_batch_predict`` of 4,096 queries (128 waves of 32).
    Waves are held to the host answer under the num+1 near-tie rule."""
    import http.client

    from predictionio_tpu_torch.core.batch_predict import run_batch_predict
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
        create_prediction_server_app,
        deploy_engine,
    )

    iid, hp = served["instance"], served["host"]
    rng = np.random.default_rng(SEED + 41)
    out: dict = {"phase": "ncf_serving", "instance": iid}
    t_phase = time.perf_counter()
    solo_users = rng.integers(0, ML20M_USERS, NCF_SOLO)
    burst_users = rng.integers(0, ML20M_USERS, NCF_BURST)

    def solo(port: int) -> tuple[list, list]:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        answers, ms = [], []
        try:
            for u in solo_users:
                t1 = time.perf_counter()
                conn.request("POST", "/queries.json",
                             body=json.dumps({"user": f"u{u}", "num": 10}))
                resp = conn.getresponse()
                body = resp.read()
                ms.append(1e3 * (time.perf_counter() - t1))
                assert resp.status == 200, body
                answers.append(json.loads(body)["itemScores"])
        finally:
            conn.close()
        return answers, ms

    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    results = {}
    for kind in ("aio", "threaded"):
        server = create_prediction_server(
            "ncf", host="127.0.0.1", port=0, storage=storage,
            engine_instance_id=iid, server_kind=kind, device="cuda",
        ).start_background()
        try:
            results[kind] = solo(server.port)
        finally:
            server.shutdown()
    deployed = deploy_engine("ncf", storage=storage, engine_instance_id=iid,
                             device="cuda")
    app = create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=32, max_queue=NCF_BURST,
        registry=MetricsRegistry(),
    )
    payloads = [{"user": f"u{u}", "num": 10} for u in burst_users]
    metas: list[dict] = [{} for _ in payloads]
    t0 = time.perf_counter()
    try:
        burst = queued_burst(app.microbatcher, payloads, metas)
    finally:
        burst_s = time.perf_counter() - t0
        app.microbatcher.close()
    with tempfile.TemporaryDirectory() as tmp:
        qfile, pfile = Path(tmp) / "q.jsonl", Path(tmp) / "p.jsonl"
        qfile.write_text("".join(json.dumps({"user": f"u{u}", "num": 10}) + "\n"
                                 for u in burst_users))
        t0 = time.perf_counter()
        assert run_batch_predict("ncf", qfile, pfile, storage=storage,
                                 engine_instance_id=iid, device="cuda") == NCF_BURST
        batch_s = time.perf_counter() - t0
        lines = [json.loads(x) for x in pfile.read_text().splitlines()]
    launches = read_launches()
    # -- end --
    swaps = {"aio": 0}
    for u, got in zip(solo_users, results["threaded"][0]):
        ids, scores = ncf_host_answer(hp, int(u), 10)
        # the host replica: the same numpy arithmetic, exactly
        assert [x["item"] for x in got] == ids[:10], u
        assert [x["score"] for x in got] == scores[:10], u
    for u, got in zip(solo_users, results["aio"][0]):
        want = ncf_host_answer(hp, int(u), 10)
        hold_scored(got, want, 10, ("aio solo", u))
        swaps["aio"] += sum(a["item"] != b for a, b in zip(got, want[0]))
    assert {(r[0], r[2]) for r in burst} == {("ok", iid)}
    held = rng.choice(NCF_BURST, NCF_HELD, replace=False)
    for j in held:
        want = ncf_host_answer(hp, int(burst_users[j]), 10)
        hold_scored(burst[j][1]["itemScores"], want, 10, ("burst", j))
        hold_scored(lines[j]["prediction"]["itemScores"], want, 10, ("batch", j))
    waves: dict = {}
    for m in metas:
        waves.setdefault(m["wave_seq"], m)
    assert all(m["wave_size"] <= 32 for m in waves.values())
    kernel_s = [m["wave_kernel_s"] for m in waves.values() if "wave_kernel_s" in m]
    assert len(kernel_s) == len(waves), "a wave without its CUDA-event time"
    eff = device_obs.default_efficiency().snapshot()["functions"]["ncf.batch_predict"]
    out.update(
        solo_p50_ms={k: statistics.median(v[1]) for k, v in results.items()},
        solo_p99_ms={k: float(np.percentile(v[1], 99)) for k, v in results.items()},
        solo_near_tie_id_swaps=swaps["aio"],
        burst_queries_per_s=NCF_BURST / burst_s,
        burst_s=burst_s,
        burst_waves=len(waves),
        wave_device_ms_p50=1e3 * statistics.median(kernel_s),
        wave_device_ms_max=1e3 * max(kernel_s),
        wave_host_s_p50=statistics.median(m["device_s"] for m in waves.values()),
        batch_predict_s=batch_s,
        batch_predict_queries_per_s=NCF_BURST / batch_s,
        answers_held={"threaded_exact": NCF_SOLO, "aio": NCF_SOLO,
                      "burst": NCF_HELD, "batch": NCF_HELD},
        efficiency=eff,
        launches=launches,
        phase_s=time.perf_counter() - t_phase,
        nvidia_smi=nvidia_smi_line(),
    )
    return out


def ncf_phases(ratings) -> tuple[dict, dict]:
    """The ncf template on the card: ``ncf_train`` then ``ncf_serving``."""
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )

    with tempfile.TemporaryDirectory() as tmp:
        storage = StorageRuntime(
            StorageConfig.from_env({"PIO_HOME": str(Path(tmp) / "pio_home")}))
        try:
            train, served = ncf_train_phase(storage, ratings)
            emit(train)
            serving = ncf_serving_phase(storage, served)
            emit(serving)
        finally:
            storage.close()
    return train, serving


#: the evaluation a user writes for ``pio eval``: the recommendation
#: template's sweep (ranks 8 and 10, regs 0.01 and 0.1, 10 iterations,
#: 5 folds) scored by Precision@10 and PositiveCount, plainly and through
#: FastEvalEngine
EVAL_MODULE = """\
from predictionio_tpu_torch.eval import FastEvalEngine
from predictionio_tpu_torch.eval.evaluation import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import (
    EvalParams, recommendation_engine)
from predictionio_tpu_torch.models.recommendation.evaluation import (
    PositiveCount, PrecisionAtK, engine_params_list)


def _evaluation(factory, app_name):
    return Evaluation(
        engine_factory=factory,
        engine_params_list=engine_params_list(
            app_name, ranks=(8, 10), regs=(0.01, 0.1),
            eval_params=EvalParams(k_fold=5)),
        metric=PrecisionAtK(10), other_metrics=(PositiveCount(),))


def evaluation(app_name):
    return _evaluation(recommendation_engine, app_name)


def fast_evaluation(app_name):
    return _evaluation(
        lambda: FastEvalEngine.from_engine(recommendation_engine()), app_name)
"""
EVAL_FOLDS, EVAL_PARAM_SETS, EVAL_ITERATIONS = 5, 4, 10


def eval_fold_hold(storage, fold) -> dict:
    """Kernels 1 and 3 at ``pio eval``'s own shapes, each held to its plain
    version, outside the counted sweeps: one fold's train at the sweep's
    rank 8 (reg 0.01) on the card and on the CPU from one start, factors
    within 2e-3 after 5 iterations (``train_cli``'s hold at rank 10);
    both of kernel 1's rank-8 half-steps on the card train's staged
    streams against ``segment_stats_fused_plain``; and the fold's query
    wave (512 or more known users) through kernel 3 in ``batch_predict``,
    each answer held to the host top-k under the num + 1 near-tie rule."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.ops import als

    td, _, qa = fold
    pd = rec.RatingsPreparator().prepare(
        EngineContext(storage=storage, device="cuda"), td)
    nu, ni = len(pd.user_vocab), len(pd.item_vocab)
    start = np.random.default_rng(SEED + 14)
    init = tuple(
        (np.abs(start.standard_normal((n, 8))) / np.sqrt(8)).astype(np.float32)
        for n in (nu, ni)
    )
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=8, reg=0.01,
                                                   num_iterations=5))
    p8 = algo._als_params()
    reset_launches()
    card = als.train_als(pd.user_idx, pd.item_idx, pd.ratings, nu, ni, p8,
                         device="cuda", init_factors=init)
    assert read_launches()["als_fused_accum"] == 2 * p8.num_iterations
    assert als.LAST_PLAN_INFO["rank"] == 8 and als.LAST_PLAN_INFO["mode"] == "fused"
    su, si = next(iter(als._STAGE_CACHE.values()))
    pad = (lambda n: (n + 127) // 128 * 128)
    half_step_err = {
        "user": fused_hold(su, pad_rows(card.item_factors, pad(ni)), p8,
                           "fused, pio eval fold, user half-step, rank 8"),
        "item": fused_hold(si, pad_rows(card.user_factors, pad(nu)), p8,
                           "fused, pio eval fold, item half-step, rank 8"),
    }
    del su, si
    cpu = als.train_als(pd.user_idx, pd.item_idx, pd.ratings, nu, ni, p8,
                        device="cpu", init_factors=init)
    diff = max(
        float((card.user_factors.cpu() - cpu.user_factors).abs().max()),
        float((card.item_factors.cpu() - cpu.item_factors).abs().max()),
    )
    assert diff <= 2e-3, f"fold train, card vs CPU factors differ by {diff}"
    # the fold's query wave on the card's factors
    model = rec.ALSModel(user_factors=card.user_factors,
                         item_factors=card.item_factors,
                         user_vocab=pd.user_vocab, item_vocab=pd.item_vocab)
    queries = [(j, q) for j, (q, _) in enumerate(qa)]
    reset_launches()
    answers = dict(algo.batch_predict(model, queries))
    assert read_launches()["fused_topk"] == 1, read_launches()
    known = [(j, pd.user_vocab.get(q.user)) for j, q in queries]
    assert all(answers[j].item_scores == () for j, u in known if u is None)
    known = [(j, u) for j, u in known if u is not None]
    assert len(known) >= 512, len(known)
    U, V = model.host_factors()
    num = qa[0][0].num
    held = hold_answers(
        [[{"item": x.item, "score": x.score} for x in answers[j].item_scores]
         for j, _ in known],
        [u for _, u in known], U, V, num, item_name=pd.item_vocab.inverse)
    return {"rank": 8, "card_vs_cpu_max_abs_diff": diff,
            "kernel1_half_step_max_abs_err": half_step_err,
            "kernel3_wave": [len(known), ni, 8, num],
            "kernel3_answers_held": held}


def eval_phase(tmp: Path, storage) -> dict:
    """``pio eval`` through the CLI on ``train_cli``'s ML-100K store: the
    user's evaluation module in the phase's directory, swept plainly and
    through FastEvalEngine on the card; both give the same result, each
    leaves an EVALCOMPLETED instance with the evaluator's JSON; kernel 1
    runs every fold's train (20 launches each) and kernel 3 every fold wave
    of 512 or more known test users; both kernels are then held to their
    plain versions on a fold of the sweep (``eval_fold_hold``)."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.tools import cli

    (tmp / "ml100k_eval.py").write_text(EVAL_MODULE)
    sys.path.insert(0, str(tmp))
    out: dict = {"phase": "eval", "shape": [ML100K_USERS, ML100K_ITEMS, ML100K_EVENTS],
                 "folds": EVAL_FOLDS, "param_sets": EVAL_PARAM_SETS}
    # the fold waves that reach kernel 3: 512 or more test users known to
    # the fold's train
    ds = rec.RatingsDataSource(rec.DataSourceParams(
        app_name="ml100k", eval_params=rec.EvalParams(k_fold=EVAL_FOLDS)))
    folds = ds.read_eval(EngineContext(storage=storage, device="cuda"))
    known = []
    for td, _, qa in folds:
        users = set(td.users)
        known.append(sum(q.user in users for q, _ in qa))
    out["known_test_users"] = known
    device_waves = EVAL_PARAM_SETS * sum(n >= 512 for n in known)
    try:
        sweeps = {}
        for name in ("evaluation", "fast_evaluation"):
            printed = io.StringIO()
            # -- the main path, with every launch count at 0 just before it --
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                assert cli.main(["eval", f"ml100k_eval:{name}", "--params",
                                 json.dumps({"app_name": "ml100k"})]) == 0
            wall = time.perf_counter() - t0
            launches = read_launches()
            # -- end --
            lines = printed.getvalue().splitlines()
            assert lines[0].startswith("[Precision@10] best score: "), lines
            assert lines[1].startswith("Best score: "), lines
            assert launches["als_fused_accum"] == (
                EVAL_PARAM_SETS * EVAL_FOLDS * 2 * EVAL_ITERATIONS), launches
            assert launches["fused_topk"] == device_waves, (launches, known)
            sweeps[name] = {"sweep_s": wall, "one_liner": lines[0],
                            "launches": launches}
    finally:
        sys.path.remove(str(tmp))
        sys.modules.pop("ml100k_eval", None)
    done = {i.evaluation_class.split(":")[1]: i
            for i in storage.evaluation_instances().get_completed()}
    assert sorted(done) == ["evaluation", "fast_evaluation"], sorted(done)
    results = {k: json.loads(v.evaluator_results_json) for k, v in done.items()}
    for name, r in results.items():
        assert len(r["records"]) == EVAL_PARAM_SETS and 0 < r["bestScore"] <= 1
        assert done[name].evaluator_results == sweeps[name]["one_liner"]
        sweeps[name]["scores"] = [x["score"] for x in r["records"]]
        sweeps[name]["positive_count"] = [x["otherScores"]["PositiveCount"]
                                          for x in r["records"]]
    # the same trains on the same folds: the same result, plain or fast
    assert results["evaluation"] == results["fast_evaluation"], results
    out.update(sweeps=sweeps, best_idx=results["evaluation"]["bestIdx"],
               best_score=results["evaluation"]["bestScore"],
               launches={k: sweeps["evaluation"]["launches"][k]
                         + sweeps["fast_evaluation"]["launches"][k]
                         for k in sweeps["evaluation"]["launches"]})
    # the kernels at the sweep's shapes, against their plain versions
    out["fold_hold"] = eval_fold_hold(
        storage, next(f for f, n in zip(folds, known) if n >= 512))
    out["nvidia_smi"] = nvidia_smi_line()
    return out


# -- the classification template and the generation store --------------------

#: the UCI Covertype shape (Blackard & Dean; its shape only, the data is a
#: seeded generator): rows, integer-valued features, classes
COVTYPE = (581_012, 54, 7)
LOGREG_ITERATIONS, LOGREG_LR = 200, 0.1
#: logistic regression's weights, card against CPU, of each tensor's largest
LOGREG_RTOL = 1e-4
#: rows whose card and CPU predictions are compared
CLS_PRED_ROWS = 4096
#: the classification template's CLI store: users with $set attr0-2/plan,
#: the queries sent to its deploy and the clients sending them
CLS_USERS, CLS_QUERIES, CLS_CLIENTS = 100_000, 1_000, 8
#: the template's planted rule: plan p draws attr0-2 from Poisson(rates[p])
CLS_RATES = ((6.0, 2.0, 1.0), (1.0, 5.0, 2.0), (2.0, 1.0, 5.0))
#: a near tie: the top two scores within this share of the top one
CLS_TIE_RTOL = 1e-5

CLS_FAST_MODULE = """\
from predictionio_tpu_torch.eval import FastEvalEngine
from predictionio_tpu_torch.eval.evaluation import Evaluation
from predictionio_tpu_torch.models.classification import (
    Accuracy, classification_engine, engine_params_list)


def fast_evaluation(app_name):
    return Evaluation(
        engine_factory=lambda: FastEvalEngine.from_engine(classification_engine()),
        engine_params_list=lambda: engine_params_list(app_name),
        metric=Accuracy())
"""


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def covtype_like(rows: int, features: int, classes: int, seed: int):
    """Binary features (as Covertype's 44 wilderness and soil columns) whose
    per-class probabilities plant the classes, as multinomial Naive Bayes
    needs: one base probability per feature, each class's within ~30% of
    it, so the classes overlap.  A class's feature sums stay below 2^24,
    so they are exact in fp32 whatever the order.  Unscaled counts are
    held too (``logreg_poisson_hold``)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, rows).astype(np.int32)
    base = rng.uniform(0.05, 0.4, features)
    p = np.clip(base * np.exp(0.3 * rng.standard_normal((classes, features))),
                0.01, 0.9)
    x = (rng.random((rows, features)) < p[y]).astype(np.float32)
    return x, y


#: the second generator: Poisson counts of rates 0.5-3 at the Covertype
#: shape, and the step counts at which its loss is read
POISSON_RATES = (0.5, 3.0)
LOSS_STEPS = (25, 50, 75, 100, 125, 150, 175, 200)


def poisson_like(rows: int, features: int, classes: int, seed: int):
    """Unscaled counts: each class's features Poisson of its own rates in
    ``POISSON_RATES``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, rows).astype(np.int32)
    rates = rng.uniform(*POISSON_RATES, (classes, features))
    return rng.poisson(rates[y]).astype(np.float32), y


def logreg_loss(x: torch.Tensor, y: torch.Tensor, w, b) -> float:
    """The unregularised training loss ``-mean(log_softmax(x@w + b)[y])``."""
    logp = torch.log_softmax(x @ w + b, dim=1)
    return float(-logp.gather(1, y[:, None]).mean())


def logreg_poisson_hold(device) -> dict:
    """Logistic regression on unscaled Poisson counts at the Covertype
    shape, where ``lr x`` the top eigenvalue of ``x.T x / n`` lies far past
    2: the loss of 25-200 steps at lr 0.1 must fall at every reading, and
    the card's weights after 200 steps are held to the CPU's within
    LOGREG_RTOL of each tensor's largest value."""
    from predictionio_tpu_torch.ops import classifiers as cls

    rows, features, classes = COVTYPE
    x, y = poisson_like(rows, features, classes, SEED + 94)
    x64 = torch.from_numpy(x).double()
    lam_max = float(torch.linalg.eigvalsh(x64.T @ x64 / rows)[-1])
    xd = torch.from_numpy(x).to(device)
    yd = torch.from_numpy(y).to(device=device, dtype=torch.int64)

    def train(xs, ys, dev, steps=LOGREG_ITERATIONS):
        return cls.train_logistic_regression(
            xs, ys, classes, learning_rate=LOGREG_LR, num_iterations=steps,
            device=dev)

    loss = [logreg_loss(xd, yd, *train(xd, yd, device, k)) for k in LOSS_STEPS]
    assert all(a > b for a, b in zip(loss, loss[1:])), loss
    w, b = (t.cpu() for t in train(xd, yd, device))
    w_c, b_c = train(x, y, "cpu")
    err = {"w_rel": float((w - w_c).abs().max() / w_c.abs().max()),
           "b_rel": float((b - b_c).abs().max() / b_c.abs().max())}
    assert max(err.values()) <= LOGREG_RTOL, err
    return {
        "generator": f"poisson rates {POISSON_RATES}",
        "lr_times_lambda_max": LOGREG_LR * lam_max,
        "loss_at_steps": dict(zip(LOSS_STEPS, loss)),
        "card_vs_cpu": err,
    }


def first_max_or_near_tie(got: np.ndarray, scores: np.ndarray) -> int:
    """Rows whose label ``got`` is not the first maximum of ``scores``
    (the reference's ``np.argmax``), outside a near tie of the top two;
    returns the count of near-tie rows (where either of the two passes)."""
    want = np.argmax(scores, 1)
    top2 = np.sort(scores, 1)[:, -2:]
    tie = np.abs(top2[:, 1] - top2[:, 0]) <= CLS_TIE_RTOL * np.abs(top2[:, 1])
    second = np.argsort(-scores, 1, kind="stable")[:, 1]
    bad = (got != want) & ~(tie & (got == second))
    assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5], want[bad][:5])
    return int(tie.sum())


def classification_ops(device="cuda") -> dict:
    """``ops/classifiers.py`` at the Covertype shape on ``device``: Naive
    Bayes and 200 steps of logistic regression (lr 0.1), each trained twice
    (the same bits), held to the same functions on the CPU (pi and theta
    within 1e-5; w and b within 1e-4 of each tensor's largest value; the
    labels of 4,096 rows equal outside near ties), timed, the logreg window
    profiled for the device's idle share."""
    from predictionio_tpu_torch.ops import classifiers as cls

    rows, features, classes = COVTYPE
    iterations = LOGREG_ITERATIONS
    out: dict = {"shape": list(COVTYPE), "logreg_iterations": iterations,
                 "logreg_lr": LOGREG_LR}
    t0 = time.perf_counter()
    x, y = covtype_like(rows, features, classes, SEED + 90)
    out["generate_s"] = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    xd = torch.from_numpy(x).to(device)
    yd = torch.from_numpy(y).to(device=device, dtype=torch.int64)

    def nb():
        return cls.train_naive_bayes(xd, yd, classes, device=device)

    def logreg():
        return cls.train_logistic_regression(
            xd, yd, classes, learning_rate=LOGREG_LR, num_iterations=iterations,
            device=device)

    nb()  # the first call sets up the BLAS handle
    _sync(device)
    nb_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pi, theta = nb()
        _sync(device)
        nb_ms.append(1e3 * (time.perf_counter() - t0))
    same_bits(pi, nb()[0], "naive bayes pi, two trains")
    same_bits(theta, nb()[1], "naive bayes theta, two trains")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    w, b = logreg()
    _sync(device)
    logreg_s = time.perf_counter() - t0
    if on_card:
        out["logreg_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        out["data_bytes"] = xd.numel() * 4 + yd.numel() * 8
    w2, b2 = logreg()
    same_bits(w, w2, "logreg w, two trains")
    same_bits(b, b2, "logreg b, two trains")
    if on_card:
        wall, idle, device_ms = profile_idle(logreg)
        out["logreg_profiled_s"] = wall
        out["logreg_idle_share"] = idle
        out["logreg_device_ms_top"] = dict(
            sorted(device_ms.items(), key=lambda kv: -kv[1])[:6])
    # the same functions on the CPU
    t0 = time.perf_counter()
    pi_c, theta_c = cls.train_naive_bayes(x, y, classes, device="cpu")
    w_c, b_c = cls.train_logistic_regression(
        x, y, classes, learning_rate=LOGREG_LR, num_iterations=iterations,
        device="cpu")
    out["cpu_reference_s"] = time.perf_counter() - t0
    err = {
        "pi": float((pi.cpu() - pi_c).abs().max()),
        "theta": float((theta.cpu() - theta_c).abs().max()),
        "w_rel": float((w.cpu() - w_c).abs().max() / w_c.abs().max()),
        "b_rel": float((b.cpu() - b_c).abs().max() / b_c.abs().max()),
    }
    assert err["pi"] <= 1e-5 and err["theta"] <= 1e-5, err
    assert err["w_rel"] <= LOGREG_RTOL and err["b_rel"] <= LOGREG_RTOL, err
    q = x[:CLS_PRED_ROWS]
    ties = {}
    for name, card_s, cpu_s in (
        ("naive", cls.naive_bayes_scores(pi, theta, xd[:CLS_PRED_ROWS]),
         cls.naive_bayes_scores(pi_c, theta_c, torch.from_numpy(q))),
        ("logreg", cls.logreg_scores(w, b, xd[:CLS_PRED_ROWS]),
         cls.logreg_scores(w_c, b_c, torch.from_numpy(q))),
    ):
        got = torch.argmax(card_s, 1).cpu().numpy()
        ties[name] = first_max_or_near_tie(got, cpu_s.numpy())
        out[f"{name}_train_accuracy_4096"] = float((got == y[:CLS_PRED_ROWS]).mean())
    out.update(
        naive_bayes_ms=nb_ms, naive_bayes_ms_min=min(nb_ms),
        logreg_s=logreg_s, logreg_ms_per_iteration=1e3 * logreg_s / iterations,
        card_vs_cpu=err, near_tie_rows=ties, same_bits_twice=True,
    )
    return out


def write_classification_events(path: Path, users: int, seed: int) -> np.ndarray:
    """``users`` ``$set`` events (attr0-2 and plan from the planted rule)
    as JSON lines; returns the plans."""
    rng = np.random.default_rng(seed)
    plan = rng.integers(0, len(CLS_RATES), users)
    attrs = rng.poisson(np.asarray(CLS_RATES)[plan])
    t_set = iso_ms(T_BASE_MS)
    with open(path, "w") as f:
        for n in range(users):
            f.write('{"event":"$set","entityType":"user","entityId":"u%d",'
                    '"properties":{"plan":%d,"attr0":%d,"attr1":%d,"attr2":%d},'
                    '"eventTime":"%s"}\n'
                    % (n, plan[n], attrs[n, 0], attrs[n, 1], attrs[n, 2], t_set))
    return plan


def classification_cli(device="cuda") -> dict:
    """The template through the port's CLI: app new -> import of ``users``
    $set events -> train (naive, lambda 1.0) on the card; the default aio
    deploy answering ``queries`` from 8 clients, each answer the label of a
    host numpy Naive Bayes over the persisted pi and theta; then ``pio
    eval`` of ``models.classification.evaluation:evaluation`` (5 folds,
    lambdas 10/100/1000), plainly and through FastEvalEngine, with the
    same JSON."""
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.server.prediction_server import create_prediction_server
    from predictionio_tpu_torch.tools import cli

    users, queries = CLS_USERS, CLS_QUERIES
    out: dict = {"users": users}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        storage = reset_storage(
            StorageConfig.from_env({"PIO_HOME": str(tmp / "pio_home")}))
        write_classification_events(tmp / "users.jsonl", users, SEED + 91)
        (tmp / "engine.json").write_text(json.dumps({
            "id": "default", "engineFactory": "classification",
            "datasource": {"params": {"appName": "cls"}},
            "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}]}))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["app", "new", "cls"]) == 0
            t0 = time.perf_counter()
            assert cli.main(["import", "--app", "cls", "--input",
                             str(tmp / "users.jsonl")]) == 0
            out["import_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            assert cli.main(["train", "--engine-json", str(tmp / "engine.json"),
                             "--device", device]) == 0
            out["train_cli_s"] = time.perf_counter() - t0
        instance_id = printed.getvalue().split("Engine instance: ")[1].split()[0]
        [blob] = load_models(storage.models(), instance_id)
        assert sorted(blob) == ["labels", "pi", "theta"], sorted(blob)
        assert blob["labels"].tolist() == [0.0, 1.0, 2.0]
        rng = np.random.default_rng(SEED + 92)
        q = rng.poisson(np.asarray(CLS_RATES)[rng.integers(0, 3, queries)]).astype(
            np.float32)
        bodies = [json.dumps({"attr0": float(a), "attr1": float(b2),
                              "attr2": float(c)}).encode() for a, b2, c in q]
        server = create_prediction_server(
            "classification", host="127.0.0.1", port=0, storage=storage,
            device=device).start_background()
        try:
            results, wall = drive_clients(server.port, bodies, CLS_CLIENTS)
            waves = server.app.microbatcher.wave_histogram()
        finally:
            server.shutdown()
        assert sorted({r[0] for r in results}) == [200], sorted({r[0] for r in results})
        got = np.asarray([json.loads(r[3])["label"] for r in results])
        host = blob["pi"][None, :] + q @ blob["theta"].T
        out["deploy"] = {
            "queries": queries, "clients": CLS_CLIENTS, "wall_s": wall,
            "queries_per_s": queries / wall,
            "p50_ms": 1e3 * float(np.percentile([r[1] for r in results], 50)),
            "p99_ms": 1e3 * float(np.percentile([r[1] for r in results], 99)),
            "waves": waves,
            "near_tie_answers": first_max_or_near_tie(got.astype(np.int64), host),
        }
        (tmp / "cls_fast_eval.py").write_text(CLS_FAST_MODULE)
        sys.path.insert(0, str(tmp))
        sweeps = {}
        try:
            for name, path in (
                ("evaluation",
                 "predictionio_tpu_torch.models.classification.evaluation:evaluation"),
                ("fast_evaluation", "cls_fast_eval:fast_evaluation"),
            ):
                printed = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    assert cli.main(["eval", path, "--params",
                                     json.dumps({"app_name": "cls"}),
                                     "--device", device]) == 0
                lines = printed.getvalue().splitlines()
                assert lines[0].startswith("[Accuracy] best score: "), lines
                sweeps[name] = {"sweep_s": time.perf_counter() - t0,
                                "one_liner": lines[0]}
        finally:
            sys.path.remove(str(tmp))
            sys.modules.pop("cls_fast_eval", None)
        done = {i.evaluation_class.split(":")[1]: i
                for i in storage.evaluation_instances().get_completed()}
        assert sorted(done) == ["evaluation", "fast_evaluation"], sorted(done)
        plain, fast = (done[k].evaluator_results_json
                       for k in ("evaluation", "fast_evaluation"))
        assert plain == fast, (plain, fast)
        assert sweeps["evaluation"]["one_liner"] == sweeps["fast_evaluation"]["one_liner"]
        r = json.loads(plain)
        assert len(r["records"]) == 3 and 0.5 < r["bestScore"] <= 1, r
        out["eval"] = {
            "folds": 5, "sweeps": sweeps, "best_idx": r["bestIdx"],
            "accuracy": [x["score"] for x in r["records"]],
            "lambdas": [x["engineParams"]["algorithms"][0]["naive"]["lam"]
                        for x in r["records"]],
            "json_identical": True,
        }
        out["logreg"] = template_logreg_hold(cli, storage, tmp, device)
        storage.close()
    return out


def template_logreg_hold(cli, storage, tmp: Path, device) -> dict:
    """The template's ``logreg`` at its own defaults on the imported $set
    data, trained through the CLI on ``device`` and on the CPU: ``w`` and
    ``b`` within LOGREG_RTOL of each tensor's largest value."""
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.models.classification.engine import (
        LogisticRegressionParams,
    )

    (tmp / "logreg.json").write_text(json.dumps({
        "id": "default", "engineFactory": "classification",
        "datasource": {"params": {"appName": "cls"}},
        "algorithms": [{"name": "logreg", "params": {}}]}))
    blobs, train_s = [], []
    for dev in (device, "cpu"):
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["train", "--engine-json", str(tmp / "logreg.json"),
                             "--device", dev]) == 0
        train_s.append(time.perf_counter() - t0)
        instance_id = printed.getvalue().split("Engine instance: ")[1].split()[0]
        [blob] = load_models(storage.models(), instance_id)
        blobs.append(blob)
    (card, host) = blobs
    err = {k: float(np.abs(card[k] - host[k]).max() / np.abs(host[k]).max())
           for k in ("w", "b")}
    assert max(err.values()) <= LOGREG_RTOL, err
    assert card["labels"].tolist() == host["labels"].tolist() == [0.0, 1.0, 2.0]
    p = LogisticRegressionParams()
    return {"learning_rate": p.learning_rate, "num_iterations": p.num_iterations,
            "train_cli_s": train_s[0], "cpu_train_cli_s": train_s[1],
            "card_vs_cpu": err}


def classification_phase(device="cuda") -> dict:
    """``classification``: the ops at the Covertype shape, then the template
    through the CLI, then logistic regression on Poisson counts held to
    the CPU.  No hand kernel is on this path (the JAX package computes
    these outside Pallas): the counts of all three stay 0."""
    t_phase = time.perf_counter()
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    out = {"phase": "classification", "ops": classification_ops(device),
           "template": classification_cli(device)}
    out["launches"] = read_launches()
    # -- end --
    assert not any(out["launches"].values()), out["launches"]
    out["logreg_poisson"] = logreg_poisson_hold(device)
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line() if device == "cuda" else None
    return out


#: the generations phase: clients during each swap, queries of the device
#: wave, solo queries compared across the SIGKILL restart, the stall at
#: the swap seam, and how long after the candidate is staged the kill comes
GEN_CLIENTS, GEN_WAVE, GEN_SOLO = 16, 1024, 8
GEN_STALL_S, GEN_KILL_AFTER_S = 120, 4.0


def flip_stored_byte(models_store, instance_id: str) -> str:
    """Flip one byte in the middle of an instance's first stored part (the
    manifest when it has none); returns the key."""
    from predictionio_tpu_torch.data.storage.base import _manifest_part_names

    raw = models_store.get(f"{instance_id}:manifest")
    parts = sorted(_manifest_part_names(raw)) if raw is not None else []
    key = f"{instance_id}:part:{parts[0]}" if parts else f"{instance_id}:manifest"
    blob = bytearray(models_store.get(key))
    blob[len(blob) // 2] ^= 0x01
    models_store.insert(key, bytes(blob))
    return key


def clients_around(port: int, users, clients: int, action):
    """``clients`` keep-alive clients query ``port`` while ``action()`` runs
    (after 128 answers, and until 128 more were sent after it returned).
    Returns (action's result, its seconds, records (sent, status, instance
    header, user, body), the time it returned)."""
    stop = threading.Event()
    lock = threading.Lock()
    records: list = []

    def client(k: int):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        n = 0
        try:
            while not stop.is_set():
                u = int(users[(k * 257 + n) % len(users)])
                n += 1
                sent = time.perf_counter()
                conn.request("POST", "/queries.json",
                             body=json.dumps({"user": f"u{u}", "num": 10}))
                resp = conn.getresponse()
                data = resp.read()
                with lock:
                    records.append((sent, resp.status,
                                    resp.getheader("X-Pio-Engine-Instance"), u, data))
        finally:
            conn.close()

    def wait_for(pred, what):
        t0 = time.perf_counter()
        while not pred():
            assert time.perf_counter() - t0 < 120, what
            time.sleep(0.01)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    try:
        for t in threads:
            t.start()
        wait_for(lambda: len(records) >= 128, "no traffic before the action")
        t0 = time.perf_counter()
        result = action()
        done = time.perf_counter()
        wait_for(lambda: sum(r[0] > done for r in records) >= 128,
                 "no traffic after the action")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return result, done - t0, list(records), done


def post_json(port: int, path: str, body: dict | None = None, timeout=120):
    """(status, JSON body) of one POST."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body or {}).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def generations_phase(device="cuda") -> dict:
    """``generations``: the deploy and ``/reload`` through the generation
    store on ``write_model``'s seeded ML-20M models.

    A and B written, A deployed (max_batch 1,024) and recorded live; under
    16 clients ``/reload`` verifies B's checksum, then flips (zero
    non-200), the retired A's device memory freed; a 1,024-query device
    wave (kernel 3) answers from B, held to B's host answers.  C, staged
    in the manifest with its checksum, then one stored byte flipped:
    ``/reload`` answers 409 and B serves on (zero non-200).  A restart
    binds the live B, not the latest COMPLETED C; B's byte flipped, a
    restart walks back to A and ``pio_lifecycle_corrupt_blobs_total``
    reads 1.  Then a CLI deploy stalled at the ``lifecycle.swap`` seam
    (``PIO_FAULT_PLAN``) is SIGKILLed mid-swap; its restart serves the
    committed generation with the same bytes as before.  Last, the gate's
    limit, measured and held to nothing: E's byte flipped before any
    record, then ``/reload`` (whose first record checksums the flipped
    bytes)."""
    import gc
    import signal

    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.lifecycle import GenerationStore, compute_checksums
    from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server_app,
        deploy_engine,
    )

    on_card = torch.device(device).type == "cuda"

    def allocated() -> int:
        if not on_card:
            return 0
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    factor_bytes = (ML20M_USERS + ML20M_ITEMS) * RANK * 4
    users = np.random.default_rng(SEED + 93).integers(0, ML20M_USERS, 4096)
    out: dict = {"phase": "generations", "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "clients": GEN_CLIENTS, "factor_bytes": factor_bytes}
    t_phase = time.perf_counter()
    corrupt = REGISTRY.counter("pio_lifecycle_corrupt_blobs_total",
                               "Model blobs refused by checksum verification")
    corrupt_before = corrupt.value
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    home = tmp / "pio_home"
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    server = None
    try:
        models = storage.models()
        store = GenerationStore(models)
        gens = {}
        for name, salt in (("A", 50), ("B", 51)):
            time.sleep(0.01)  # start times a millisecond apart at least
            gens[name] = write_model(storage, home, seed=SEED + salt)
        ids = {name: g[0] for name, g in gens.items()}
        name_of = {v: k for k, v in ids.items()}

        def serve(instance_id=None):
            deployed = deploy_engine("recommendation", storage=storage,
                                     engine_instance_id=instance_id, device=device)
            app = create_prediction_server_app(
                deployed, use_microbatch=True, max_batch=GEN_WAVE,
                max_queue=4 * GEN_WAVE, registry=MetricsRegistry())
            return deployed, app, AsyncAppServer(app, "127.0.0.1", 0).start_background()

        def held(records, expect: set):
            """Every record 200 and answered by a generation in ``expect``,
            each held to that generation's factors."""
            statuses = sorted({r[1] for r in records})
            assert statuses == [200], statuses
            by: dict = {}
            for r in records:
                by.setdefault(name_of[r[2]], []).append(r)
            assert set(by) <= expect, (sorted(by), expect)
            for name, rs in by.items():
                _, U, V = gens[name]
                hold_answers([json.loads(r[4])["itemScores"] for r in rs],
                             [r[3] for r in rs], U, V, 10)
            return {k: len(v) for k, v in by.items()}

        mem: dict = {"before_deploy": allocated()}
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        deployed, app, server = serve(ids["A"])
        assert deployed.instance.id == ids["A"]
        assert store.live().instance_id == ids["A"]
        mem["a_bound"] = allocated()
        verify_ms = {}
        t0 = time.perf_counter()
        store.verify(ids["A"])
        verify_ms["A"] = 1e3 * (time.perf_counter() - t0)

        # 1. a good reload under 16 clients
        (status, body), reload_s, records, done = clients_around(
            server.port, users, GEN_CLIENTS,
            lambda: post_json(server.port, "/reload"))
        assert status == 200 and body["engineInstanceId"] == ids["B"], body
        late = [r for r in records if r[0] > done]
        assert {r[2] for r in late} == {ids["B"]}, "A answered after the reload"
        out["good_reload"] = {"status": status, "reload_s": reload_s,
                              "answered_by": held(records, {"A", "B"}),
                              "sent_after": len(late)}
        assert store.live().instance_id == ids["B"]
        assert store.get(ids["A"]).status == "retired"
        mem["b_bound_a_drained"] = allocated()
        assert mem["b_bound_a_drained"] - mem["a_bound"] < factor_bytes, mem
        t0 = time.perf_counter()
        store.verify(ids["B"])
        verify_ms["B"] = 1e3 * (time.perf_counter() - t0)

        # 2. a device wave from B
        before = read_launches()["fused_topk"]
        wave_users = users[:GEN_WAVE]
        burst = queued_burst(
            app.microbatcher,
            [{"user": f"u{u}", "num": 10} for u in wave_users],
            [{} for _ in wave_users])
        assert all(r[0] == "ok" and r[2] == ids["B"] for r in burst), {
            (r[0], r[2]) for r in burst}
        _, Ub, Vb = gens["B"]
        hold_answers([r[1]["itemScores"] for r in burst], wave_users, Ub, Vb, 10)
        out["device_wave"] = {"queries": GEN_WAVE,
                              "fused_topk": read_launches()["fused_topk"] - before}
        assert not on_card or out["device_wave"]["fused_topk"] >= 1, out

        # 3. a corrupt candidate: staged with its checksum, then one byte
        time.sleep(0.01)
        gens["C"] = write_model(storage, home, seed=SEED + 52)
        ids["C"] = gens["C"][0]
        name_of[ids["C"]] = "C"
        store.record(ids["C"], status="staged")
        out["flipped"] = {"C": flip_stored_byte(models, ids["C"]).split(":", 1)[1]}
        t0 = time.perf_counter()
        try:
            store.verify(ids["C"])
            raise AssertionError("C's flipped byte passed verification")
        except Exception as e:
            assert type(e).__name__ == "CorruptModelError", e
        verify_ms["C"] = 1e3 * (time.perf_counter() - t0)
        (status, body), refused_s, records, _ = clients_around(
            server.port, users, GEN_CLIENTS,
            lambda: post_json(server.port, "/reload"))
        assert status == 409 and body["engineInstanceId"] == ids["B"], body
        assert "do not match" in body["message"], body
        out["refused_reload"] = {"status": status, "reload_s": refused_s,
                                 "message": body["message"][:160],
                                 "answered_by": held(records, {"B"})}
        assert deployed.instance.id == ids["B"]
        assert store.live().instance_id == ids["B"]
        assert store.get(ids["C"]).status == "staged"
        launches = read_launches()
        # -- end --

        # 4. restarts
        def restart():
            nonlocal deployed, app, server
            server.shutdown()
            deployed = app = server = None
            mem.setdefault("down", []).append(allocated())
            deployed, app, server = serve()
            status, body = post_json(server.port, "/queries.json",
                                     {"user": f"u{int(users[0])}", "num": 10})
            assert status == 200, body
            return deployed.instance.id

        bound = restart()
        assert bound == ids["B"], (name_of.get(bound), "should be B")
        latest = storage.engine_instances().get_latest_completed(
            "default", "default", "default")
        assert latest.id == ids["C"]
        out["flipped"]["B"] = flip_stored_byte(models, ids["B"]).split(":", 1)[1]
        bound_after = restart()
        assert bound_after == ids["A"], (name_of.get(bound_after), "should be A")
        assert store.get(ids["B"]).status == "rolled_back"
        assert store.live().instance_id == ids["A"]
        corrupt_blobs = corrupt.value - corrupt_before
        assert corrupt_blobs == 1, corrupt_blobs
        out["restarts"] = {"bound": ["B", "A"], "latest_completed": "C",
                           "corrupt_blobs_total": corrupt.value}
        server.shutdown()
        server = deployed = app = None
        mem["after_restarts"] = allocated()

        # 5. SIGKILL mid-swap
        time.sleep(0.01)
        gens["D"] = write_model(storage, home, seed=SEED + 53)
        ids["D"] = gens["D"][0]
        name_of[ids["D"]] = "D"
        plan = json.dumps([{"seam": "lifecycle.swap", "kind": "latency",
                            "latency_s": GEN_STALL_S, "match": "reload"}])
        argv = ["deploy", "--ip", "127.0.0.1", "--port", "0", "--device", device]
        proc, printed = spawn_cli(home, argv, 1, env={"PIO_FAULT_PLAN": plan})
        solo = [{"user": f"u{int(u)}", "num": 10} for u in users[-GEN_SOLO:]]
        try:
            port = bound_port(printed[0])
            baseline = [post_json(port, "/queries.json", q) for q in solo]
            assert all(s == 200 for s, _ in baseline), baseline
            reload_result: list = []
            t = threading.Thread(
                target=lambda: reload_result.append(
                    _swallow(lambda: post_json(port, "/reload", timeout=300))),
                daemon=True)
            t.start()
            t0 = time.perf_counter()
            while store.get(ids["D"]) is None:
                assert time.perf_counter() - t0 < 60, "the reload never staged D"
                assert proc.poll() is None, cli_stderr(proc)
                time.sleep(0.05)
            time.sleep(GEN_KILL_AFTER_S)  # verify, load and sanity-check D
            assert proc.poll() is None, cli_stderr(proc)
            assert store.live().instance_id == ids["A"]
            proc.send_signal(signal.SIGKILL)
            killed_rc = proc.wait(timeout=30)
            t.join(timeout=30)
            # the reload never answered: it died in the stall
            assert reload_result in ([], [None]), reload_result
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        assert store.live().instance_id == ids["A"], "the commit happened"
        assert store.get(ids["D"]).status == "staged"
        proc, printed = spawn_cli(home, argv, 1)
        try:
            port = bound_port(printed[0])
            lc = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/lifecycle.json", timeout=30).read())
            after = [post_json(port, "/queries.json", q) for q in solo]
        finally:
            stop_cli(proc)
        assert after == baseline, "the restart answered other bytes"
        assert lc["engineInstanceId"] == lc["manifest"]["live"] == ids["A"], lc
        out["sigkill_mid_swap"] = {
            "killed_returncode": killed_rc, "staged": "D",
            "restart_bound": "A", "solo_answers_equal": len(after),
        }

        # 6. the gate's limit: E's byte flipped BEFORE anything recorded it
        time.sleep(0.01)
        gens["E"] = write_model(storage, home, seed=SEED + 54)
        ids["E"] = gens["E"][0]
        name_of[ids["E"]] = "E"
        assert store.get(ids["E"]) is None
        out["flipped"]["E"] = flip_stored_byte(models, ids["E"]).split(":", 1)[1]
        deployed, app, server = serve()
        status, body = post_json(server.port, "/reload")
        gen_e = store.get(ids["E"])
        probe = users[:GEN_SOLO]
        answers = [post_json(server.port, "/queries.json",
                             {"user": f"u{int(u)}", "num": 10}) for u in probe]
        _, Ue, Ve = gens["E"]
        try:
            hold_answers([b["itemScores"] for _, b in answers], probe, Ue, Ve, 10)
            held_to_e = True
        except AssertionError:
            held_to_e = False
        out["never_recorded_flip"] = {
            "reload_status": status, "bound": name_of.get(deployed.instance.id),
            "manifest_status": gen_e.status if gen_e else None,
            "recorded_checksum_is_the_flipped_bytes": bool(
                gen_e and gen_e.checksum == compute_checksums(models, ids["E"])[0]),
            "answers_held_to_e": held_to_e,
        }
        server.shutdown()
        server = deployed = app = None
        out.update(
            verify_ms=verify_ms, device_memory=mem, launches=launches,
            manifest=[(name_of.get(g.instance_id, g.instance_id), g.status)
                      for g in store.generations()],
        )
    finally:
        if server is not None:
            server.shutdown()
        storage.close()
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line() if on_card else None
    return out


def _swallow(fn):
    """``fn()``, or None when it raised (a request to a process killed
    under it)."""
    try:
        return fn()
    except Exception:
        return None


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
    emit(off_menu_phase())
    front_end = front_end_phases()
    # what the serving paths cost with the observability layer in place:
    # solo queries on a warmed keep-alive connection, and serve_concurrent
    solo = front_end[4]
    emit({
        "phase": "layer_cost",
        "solo_requests": {kind: solo[kind]["requests"] for kind in ("aio", "threaded")},
        "solo_p50_ms": {kind: solo[kind]["p50_ms"] for kind in ("aio", "threaded")},
        "solo_p99_ms": {kind: solo[kind]["p99_ms"] for kind in ("aio", "threaded")},
        "serve_concurrent_queries_per_s": front_end[0]["queries_per_s"],
        "serve_concurrent_p99_ms": front_end[0]["client_p99_ms"],
        "nvidia_smi": nvidia_smi_line(),
    })
    cli_train = train_cli_phase()
    evaluation = cli_train.pop("eval")
    emit(cli_train)
    emit(evaluation)
    ml20m, fused_t, chunk_t, ratings = train_ml20m_phase()
    emit(ml20m)
    emit({"phase": "als_kernel_timing", "als_fused_accum": fused_t,
          "als_segment_accum": chunk_t})
    family_train, _, family_cli = als_family_phases(ratings)
    ncf_train, _ = ncf_phases(ratings)
    del ratings
    ingest = event_ingest_phase()
    emit(ingest)
    emit(classification_phase())
    generations = generations_phase()
    emit(generations)
    implicit_t = family_train["kernel1_implicit_user_half_step"]
    pretrain = ncf_train["pretrain"]
    rank32_t = pretrain["kernel1_rank32_implicit_user_half_step"]
    wide_c = chunk_t["wide"]
    main_t = next(t for t in timings if t["shape"] == [WAVE, ML20M_ITEMS, 10, 10])
    wide_t = next(t for t in timings if t["shape"] == [WAVE, ML20M_ITEMS, 32, 128])
    small_t = next(t for t in timings if t["shape"] == [512, ML20M_ITEMS, 10, 10])
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
                    # one per device wave of the pipelined front end
                    "launches_pipelined_waves": front_end[1]["launches"]["fused_topk"],
                    # pio batchpredict of every user over the REST-fed model
                    "launches_event_ingest": ingest["batchpredict_launches"]["fused_topk"],
                    # the observability phase's device waves (its queued burst)
                    "launches_observability": front_end[3]["launches"]["fused_topk"],
                    # pio eval's fold waves of 512+ known users, both sweeps
                    "launches_eval": evaluation["launches"]["fused_topk"],
                    # the device wave across the generation store's swaps
                    "launches_generations": generations["launches"]["fused_topk"],
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
                    "wide_shape": wide_t["shape"],
                    "wide_ms": wide_t["kernel_ms"],
                    "wide_plain_ms": wide_t["plain_ms"],
                    "wide_library_ms": wide_t["library_ms"],
                    "wide_bound_ms": wide_t["bound_ms"],
                    # the smallest device wave (512 queries)
                    "small_shape": small_t["shape"],
                    "small_ms": small_t["kernel_ms"],
                    "small_plain_ms": small_t["plain_ms"],
                    "small_library_ms": small_t["library_ms"],
                    "small_bound_ms": small_t["bound_ms"],
                },
                # launches: the ML-100K `pio train` through the CLI; times at
                # the ML-20M user half-step, rank 10; no single PyTorch call
                # computes the fused accumulation (library_ms null)
                als_row(
                    "als_fused_accum", "predictionio_tpu/ops/als_pallas.py:204",
                    cli_train["launches"]["als_fused_accum"], fused_t,
                    launches_ml20m=ml20m["fused_launches"]["als_fused_accum"],
                    # the ALS family's CLI trains (ecommerce, similarproduct)
                    # and the ecommerce train at the ML-20M shape, implicit
                    launches_als_family=sum(
                        x["als_fused_accum"]
                        for x in family_cli["train_launches"].values()
                    ),
                    launches_ecomm_ml20m=family_train["launches"]["als_fused_accum"],
                    # pio train over the events the event server took in
                    launches_event_ingest=ingest["train_launches"]["als_fused_accum"],
                    # the ncf template's ALS pretrain (implicit, rank 32)
                    launches_ncf_pretrain=pretrain["launches"]["als_fused_accum"],
                    # every fold train of both pio eval sweeps
                    launches_eval=evaluation["launches"]["als_fused_accum"],
                    # rank 32, implicit, on the pretrain's ML-20M user half-step
                    rank32_shape=rank32_t["shape"],
                    rank32_ms=rank32_t["ms"],
                    rank32_plain_ms=rank32_t["plain_ms"],
                    rank32_bound_ms=rank32_t["bound_ms"],
                    rank32_bound_by=rank32_t["bound_by"],
                    rank32_max_abs_err=rank32_t["max_abs_err"],
                    implicit_shape=implicit_t["shape"],
                    implicit_ms=implicit_t["ms"],
                    implicit_plain_ms=implicit_t["plain_ms"],
                    implicit_bound_ms=implicit_t["bound_ms"],
                    implicit_max_abs_err=implicit_t["max_abs_err"],
                ),
                # launches: the ML-20M chunked train (3 iterations); times
                # on its first user chunk at rank 10 (width 128) and, wide_*,
                # rank 32 (width 1,152); library_ms: one index_add_
                als_row(
                    "als_segment_accum", "predictionio_tpu/ops/als_pallas.py:112",
                    ml20m["chunked_launches"]["als_segment_accum"], chunk_t,
                    wide_shape=wide_c["shape"],
                    wide_ms=wide_c["ms"],
                    wide_plain_ms=wide_c["plain_ms"],
                    wide_library_ms=wide_c["library_ms"],
                    wide_bound_ms=wide_c["bound_ms"],
                    wide_max_abs_err=wide_c["max_abs_err"],
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
