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
- factor-sharded serving (``sharded_serving``): a seeded ML-20M model's
  recorded ``ShardPlan`` bound onto 4, then 3, slots of ``cuda:0`` (one
  physical card), waves of 4,096 and 512 through ``batch_predict`` with
  kernel 3 once per slot on the slot's own stream, equal to the unsharded
  kernel-3 wave across a tie planted on the slot boundary; a deploy of the
  4-slot model answering a queued burst of 1,024 HTTP queries with
  ``/shards.json``; the straggler board quiet on balanced waves and naming
  the slot the ``shard.settle`` seam defers; an NCF wave at the ML-20M
  table shape over 4 slots; kernel 3 timed at one slot's shape;
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
- ALS over a mesh (``mesh_train``, between ``train_ml20m``'s fused and
  chunked trains): ``train_als(mesh=)`` at the ML-20M shape on 4 data
  slots of ``cuda:0``, kernel 1 once per slot per half-step on the slot's
  stream, held to the one-slot train from one start, each slot's kernel-1
  stats held to the plain version, kernel 1 timed at one slot's shape and
  the iteration split into accumulation, cross-slot sum, solves and
  gathers; the chunked rung over the same mesh (kernel 2, held to its
  plain version per slot, the factors within 2e-3 of the fused mesh
  train's); two processes on ``cuda:0`` joined over
  ``torch.distributed`` (gloo: the ranks share the card) through
  ``balance_local_chunks``, ``global_data_array`` and
  ``train_als_global``, each rank reading half the users' ratings; and
  ``run_train`` of the recommendation engine on a 4-slot context;
- ``pio check`` (``check``, after ``train_ml20m``): in a process of its
  own, ``pio train`` of a miswired copy of the recommendation template
  exits 1 with the DASE pre-flight's message, no CUDA context made and no
  kernel launched; ``pio check predictionio_tpu_torch`` against the port's
  baseline exits 0 cold, then warm from the check cache, and ``pio check
  --engine all`` exits 0, CUDA still untouched; then ``pio train`` of the
  template at the ML-100K cut with ``PIO_PREFLIGHT_LINT=1`` (kernel 1, 40
  launches); then a user's engine module built from the port's exported
  names (``core.Engine``, ``EngineFactory``, ``IdentityPreparator``,
  ``FirstServing`` and the template's data source and ALS) trained by
  ``pio train --engine chip_custom_rec:Factory`` (40 launches, factors
  equal bit for bit to the template's) and answering ``pio batchpredict``
  of every known user in one kernel-3 wave, each answer held to the host
  top-k; and ``pio bench --compare`` on three synthetic BENCH lines and
  stdin (exits 0, 1, 2).  In this process, ``train_ml20m``'s instance persisted through
  ``S3Models`` (``TYPE=s3`` over an in-memory boto3-shaped client) and
  deployed from it: one 4,096-query wave through kernel 3 (1 launch), held
  to the host top-k and equal bit for bit to the sqlite-loaded deploy;
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
  (bpr, MLP (64, 32, 16); 2 epochs, cut from the default 5) with
  each epoch's seconds and loss, the
  step time and idle share of a steady window, one step held to the CPU's;
  then the pretraining recipe (implicit ALS at rank 32 through kernel 1, 40
  launches, then one full_softmax epoch), kernel 1 held and timed on that
  stream; that first model through the default deploy (``ncf_serving``):
  solo queries per front end (the threaded server's host replica held to
  the numpy answer exactly), a 4,096-query burst in device waves of 32 and
  a 4,096-query ``run_batch_predict``, held to the host answer;
- NCF over a mesh (``ncf_mesh_train``, after ``ncf_serving``, on its
  positives; 4 slots of ``cuda:0`` as ``{data: 2, model: 2}``): a bpr
  epoch of the defaults beside the one-slot train from the same tree and
  draws (the gate, the block copies bit for bit), the pretrain's
  ``train_als(mesh=)`` at rank 32 (kernel 1 once per data slot per
  half-step, each slot's stats held, timed at one slot's shape) and a
  full_softmax epoch, two processes on the card over gloo held to the
  one-process mesh train, and the template's ``run_train`` with an
  engine.json mesh;
- the classification template (``classification``): ``ops/classifiers.py``
  at the UCI Covertype shape (581,012 x 54, 7 classes, a seeded generator)
  on the card, Naive Bayes and 200 logistic-regression steps each trained
  twice to the same bits and held to the CPU; then ``app new`` ->
  ``import`` of 20,000 users' ``$set`` events -> ``train`` -> the default
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
  on the committed generation with the same answers;
- the operator's CLI and the serve tail (``operator``): ``version``,
  ``build``, ``status``, ``upgrade`` and ``run`` as CLI processes; an ML-20M
  model written under engine coordinates (``op``, ``2``, ``tls``) before
  an ML-100K ``train --engine-json`` under ``op100k`` (kernel 1); ``deploy
  --engine-json --feedback`` with an output plugin from ``PIO_PLUGINS``
  binding the ML-20M model, ``status --url``, ``metrics --url``, a second
  deploy stopping the first and ``undeploy``; a TLS deploy answering a
  1,024-query device wave (kernel 3) through the plugin and feedback,
  with feedback and without, and 32 keep-alive clients over HTTPS and then
  plain HTTP; ``batchpredict --engine-json`` of 4,096 users (kernel 3);
- the lifecycle, online quality, replay and tenants (``lifecycle``): a
  canary at half the traffic beside the live ML-20M model, 4,096 queries
  queued at once in two waves of two partitions (kernel 3 on each), every
  answer held to its side's factors; feedback joined per variant through
  the event server beside the deploy, the controller promoting the canary
  and rolling back a faulty one under 8 clients; ``replay-request`` of a
  solo answer (``MATCHED``) and after a flipped byte
  (``generation.bytes``), and kernel-3 answers replayed by tolerance; the
  controller's warm-start retrain of an ML-100K model on its thread beside
  8 clients (kernel 1), staged and promoted; two tenants on one deploy, a
  third refused by the stored-bytes budget, one wave partitioned by tenant
  (kernel 3 on each), and a tenant's quota shedding;
- the storage plane (``storage``): ``pio storageserver`` as a subprocess
  (parquet events), the first 15,000,000 of the ML-20M-shaped ratings
  written to it as bulk frames, ``pio eventstore status|compact --url``, ``pio train`` with every
  repository on the daemon (kernel 1), held to an in-memory train from one
  start per entity; the deploy bound through the daemon answering a
  queued wave (kernel 3), solo queries and ``pio batchpredict``; the
  daemon SIGKILLed under the deploy (a wave still answered, ``/readyz``
  not ready, the event server's 503 + ``Retry-After``) and restarted (the
  breaker closed, every acknowledged event read back); ``pio app
  compact``; a train with ``TYPE=hdfs`` models and a wave from it;
- the watch loop (``watch``): two tenants on one deploy over a storage
  daemon, 4 x 1,024 queued HTTP queries for one (kernel 3 on each wave)
  and 64 solo queries for the other, every answer billed: the cost
  ledger's device seconds held to the batcher's within 1e-6 of them;
  ``cost_skew`` firing for the noisy tenant; ``pio profile`` capturing
  kernel 3 on the card and ``pio trace`` joining the deploy, the daemon and
  an event server; the daemon SIGKILLed (``breaker_open`` firing, one
  incident bundle, ``pio status --url`` exiting 1, a wave still through
  kernel 3), the read-only verbs (``incident``, ``alerts``, ``costs``,
  ``top``, ``capacity``, ``explain``, ``profile --stacks``) at once, and
  the daemon restarted (the alert resolved, ``status --url`` exiting 0);
  then an ML-100K train over a throwaway PostgreSQL server where the host
  has one (kernel 1);
- the fleet (``fleet``): ``pio fleet deploy --replicas 2 --autoscale`` as
  a subprocess, two ``pio deploy`` replica daemons on the card behind the
  consistent-hash router (only the replicas hold CUDA contexts), 16
  clients' solo queries each answered by its home replica, one replica
  SIGKILLed under traffic (no 5xx, its breaker open, ejected), ``pio fleet
  scale 3`` respawning one, the fleet verbs and ``top``, ``capacity`` and
  ``status`` through the router, then ``undeploy`` of the router stopping
  every replica; two in-process replicas at ``max_batch`` 512 behind the
  router, 512 routed queries each in one device wave (kernel 3, one
  launch per replica); ``pio start-all`` / ``stop-all`` of the event
  server, the admin API and the dashboard (no CUDA context in them);
- the production day (``day``): ``replay.day.seed_demo_home`` trained on
  the card (kernel 1, 4 launches) and held to the CPU train from one
  start, a deploy of it answering its 12 users; then ``pio day --device
  cuda --replicas 2 --seed 7`` over an ML-20M home with ``ml20m-full-day``
  (the JAX package's full scripted day at the ML-20M population: a replica
  SIGKILLed, a storage stall, a canary flip over 46 s of open-loop
  traffic), judged by the verdict engine: every clause passed, 768 of 768
  answered, one ``breaker_open`` and one ``ingest_shed`` bundle.

To make room for ``day``: ``operator``, ``lifecycle`` and
``als_family_cli`` hold the first 20,000 of their ML-100K-shaped stream
(``CUT_ML100K_EVENTS``), ``event_ingest`` ingests 5,000 events (10,000
for ``day``, 5,000 for ``check``), ``fleet`` routes 512-query waves, and
``storage`` takes the first 15,000,000 of ``train_ml20m``'s ratings
(``STORE_RATINGS``, for ``custom_engine``) rather than generating them
again.  ``als_family_train`` trains on the views of the ML-20M stream's
first 5,000,000 ratings (``FAMILY_RATINGS``: 10,000,000 for ``day``,
7,500,000 for ``sharded_serving``, 5,000,000 for ``check``).  For ``mesh_train``, ``movielens_like`` looks its
draws up on threads (the same arrays).

``watch`` and ``check``'s pre-flight half run in a process of their own
(``phase_in_own_process``), the rest in this one.  Every count of kernel launches is set to 0 just before
each main-path phase and read just after it, in the process that drives
the phase.  It prints one JSON line per phase (every
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
import urllib.error
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
#: the ML-100K-shaped stores of ``operator``, ``lifecycle`` and
#: ``als_family_cli`` hold their stream's first CUT_ML100K_EVENTS events (cut
#: from all 100,000 to make room for the day phase: their imports and the
#: lifecycle retrain's read scale with it; the users, items and rates per
#: event keep the ML-100K shape, and ``train_cli``/``eval`` keep all 100,000)
CUT_ML100K_EVENTS = 20_000
ITERATIONS = 20  # the template's numIterations
WAVE = 4096
SEED = 20
RTOL = 1e-5  # random-normal inputs: cuBLAS sums in another order
#: ALS accumulators on random-normal inputs: |kernel - plain| within this
#: share of the entry's sum of absolute terms (the plain version adds with
#: atomics, in another order)
ALS_RTOL = 1e-4


#: the script's start on the host's clock: each phase line carries
#: ``script_s``, the seconds from here to its print
SCRIPT_T0 = time.perf_counter()


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - SCRIPT_T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def toolchain() -> dict:
    from predictionio_tpu_torch.data.storage import pq_driver
    from predictionio_tpu_torch.ops import _kernels

    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    def version(package: str) -> str:
        # the installed distribution's version, without importing it
        from importlib import metadata

        try:
            return metadata.version(package)
        except metadata.PackageNotFoundError:
            return "absent"

    return {
        "phase": "toolchain",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "triton": triton_version,
        # the storage phase's daemon runs parquet events with pyarrow
        "pyarrow": version("pyarrow"),
        "fsspec": version("fsspec"),
        "pandas": version("pandas"),
        "nvcc": _kernels.nvcc_path(),
        # the watch phase's Postgres train runs where a server can start
        "libpq": pq_driver.available(),
        "postgres_bin": (postgres_binaries() or {}).get("pg_ctl"),
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


def write_model(storage, home: Path, exact: bool = False, seed: int = SEED,
                coords: tuple[str, str, str] = ("default", "default", "default"),
                ) -> tuple[str, np.ndarray, np.ndarray]:
    """A seeded ALS model at the ML-20M shape, persisted as a COMPLETED
    engine instance through the port's storage and save_models under the
    engine ``coords`` (id, version, variant), with factors as ops/als.py
    initializes them: abs(normal) / sqrt(rank); or, ``exact``, integers in
    [1, 8] over 8, whose scores are exact in fp32 and tie often."""
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
    engine_id, engine_version, engine_variant = coords
    instance = EngineInstance(
        id=uuid.uuid4().hex, status="COMPLETED", start_time=now, end_time=now,
        engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant, engine_factory="recommendation",
        **params.to_json_fields(),
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


def drive_clients(port: int, bodies: list, clients: int, tls=None,
                  header: str = "X-Pio-Engine-Instance") -> tuple[list, float]:
    """``clients`` threads, each on one keep-alive ``http.client``
    connection (HTTPS with the client context ``tls``), POST ``bodies`` to
    ``/queries.json`` until none is left.  Returns (status, client seconds,
    the response's ``header``, body) per body, in order, and the wall
    time."""
    import http.client
    import threading

    jobs = iter(enumerate(bodies))
    lock = threading.Lock()
    results: list = [None] * len(bodies)

    def client():
        if tls is None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        else:
            conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=60,
                                               context=tls)
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
                              resp.getheader(header), data)
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
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    item_cdf = np.cumsum((np.arange(n_items) + 10.0) ** -0.8)
    user_cdf = np.cumsum(rng.lognormal(0.0, 1.0, n_users))
    draws = [(user_cdf / user_cdf[-1], rng.random(nnz), n_users),
             (item_cdf / item_cdf[-1], rng.random(nnz), n_items)]
    uf = rng.standard_normal((n_users, 8)).astype(np.float32)
    vf = rng.standard_normal((n_items, 8)).astype(np.float32)
    step = 1 << 22
    # the draws are taken in order above; the lookups, independent slice by
    # slice, run on threads (numpy releases the GIL in them): the same arrays
    u, i = (np.empty(nnz, np.int32) for _ in range(2))
    raw = np.empty(nnz, np.float32)

    def lookup(out, cdf, x, n, sl):
        out[sl] = np.minimum(np.searchsorted(cdf, x[sl]), n - 1)

    def taste(sl):
        raw[sl] = 3.5 + 0.9 * (uf[u[sl]] * vf[i[sl]]).sum(1) / np.sqrt(8.0)

    slices = [slice(lo, lo + step) for lo in range(0, nnz, step)]
    with ThreadPoolExecutor(8) as pool:
        for out, (cdf, x, n) in zip((u, i), draws):
            list(pool.map(lambda sl: lookup(out, cdf, x, n, sl), slices))
        list(pool.map(taste, slices))
    del draws
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


def write_ml100k(path: Path, events: int = ML100K_EVENTS):
    """``movielens_like`` at the ML-100K shape as rate events, one a second
    from ML-100K's first rating time, in JSON lines for ``pio import``: the
    stream's first ``events``; returns their (user, item, rating) columns."""
    u, i, r = movielens_like(ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS,
                             SEED + 10, half_stars=False)
    u, i, r = u[:events], i[:events], r[:events]
    t_base = 874_724_710  # ML-100K's first rating time, epoch seconds
    with open(path, "w") as f:
        for j in range(events):
            ts = datetime.fromtimestamp(t_base + j, tz=timezone.utc)
            f.write(
                '{"event":"rate","entityType":"user","entityId":"u%d",'
                '"targetEntityType":"item","targetEntityId":"i%d",'
                '"properties":{"rating":%d},"eventTime":"%s"}\n'
                % (u[j], i[j], r[j], ts.strftime("%Y-%m-%dT%H:%M:%S.000Z"))
            )
    return u, i, r


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
        u, i, r = write_ml100k(tmp / "ratings.jsonl")
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


def train_ml20m_phase() -> tuple[dict, dict, dict, tuple, dict, tuple]:
    """``train_als`` at the ML-20M shape: 20 iterations fused (cold, then
    warm under torch.profiler), then 3 forced chunked, each cold train's
    peak of device memory, then the OOM ladder between them; per half-step
    accumulate and solve times, staging, idle share, RMSE, and each
    kernel checked and timed at this shape.  Also returns the generated
    ratings, which the ALS family's train reuses, ``mesh_train``'s
    line (it runs between the fused and the chunked trains, so that its
    one-slot trains reuse the fused train's staged streams) and the fused
    train's factors on the host, which ``check`` persists through S3."""
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
    mesh_train = mesh_train_phase((u, i, r))

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
    factors = (st.user_factors.cpu().numpy(), st.item_factors.cpu().numpy())
    return out, fused_t, chunk_t, (u, i, r), mesh_train, factors


# -- ALS over a mesh: slots of one card, then two processes on it -------------

#: ``mesh_train``: 4 data slots of ``cuda:0``, 5 iterations at the ML-20M
#: shape, rank 10, explicit
MESH_SLOTS, MESH_ITERATIONS = 4, 5
#: (b) the chunked rung over the same mesh: the stream's first ratings
MESH_CHUNKED_RATINGS, MESH_CHUNKED_ITERATIONS = 1_000_000, 2
#: (c) two processes on cuda:0, each reading half the users' ratings
MESH_RANKS, MESH_RANK_ITERATIONS = 2, 3
#: (d) the recommendation engine's run_train at the ML-100K cut
MESH_ENGINE_ITERATIONS = 10
#: the gate of a mesh train against the one-slot train from one start: the
#: scores of MESH_GATE_USERS sampled users against every item within
#: rtol 5e-2 / atol 5e-3 (the JAX two-process test's,
#: tests/test_distributed.py:183), the top-10 ids in the same order for at
#: least MESH_TOP10_AGREE of them
MESH_GATE_USERS, MESH_TOP10_AGREE = 1024, 0.9
#: (b)'s factors, the chunked mesh train against the fused one, within this
#: of each other: the port's rule between a card train and a CPU train from
#: one start (kernels 1 and 2 sum a slot's rows in other orders, and ALS
#: carries the rounding on)
MESH_FACTOR_ATOL = 2e-3
MESH_WORKER_TIMEOUT_S = 300

MESH_WORKER = r"""
import json, os, sys, time
from pathlib import Path
import numpy as np
import torch
from predictionio_tpu_torch.ops import als, als_accum
from predictionio_tpu_torch.parallel import mesh as pm

rank = int(os.environ["PIO_PROCESS_ID"])
data = np.load(sys.argv[1])
u = data["u"]
keep = data["shard"][u] == rank
u, i, r = u[keep], data["i"][keep], data["r"][keep]
# the parent starts this process early and says when the card is free
deadline = time.monotonic() + 600
while not Path(sys.argv[8]).exists():
    assert time.monotonic() < deadline, "no go from the parent"
    time.sleep(0.05)
t0 = time.perf_counter()
pm.initialize_distributed(device=sys.argv[7])
assert pm.process_index() == rank
n_users, n_items, rank_k, iterations = (int(x) for x in sys.argv[3:7])
mesh = pm.default_mesh()
p = als.ALSParams(rank=rank_k, num_iterations=iterations)
(u, i, r), valid = pm.balance_local_chunks(
    [u, i, r], p.chunk_size * len(pm.local_devices()))
parts = [pm.global_data_array(mesh, a) for a in (u, i, r, valid)]
for name in als_accum.KERNEL_LAUNCHES:
    als_accum.KERNEL_LAUNCHES[name] = 0
pm.COLLECTIVE_STATS.clear()
t1 = time.perf_counter()
state = als.train_als_global(*parts, n_users, n_items, mesh, params=p)
train_s = time.perf_counter() - t1
if rank == 0:
    np.savez(sys.argv[2], U=state.user_factors, V=state.item_factors)
stats = pm.COLLECTIVE_STATS
print(json.dumps({
    "rank": rank, "rows": int(keep.sum()), "padded_rows": len(u),
    "mesh": mesh.shape, "labels": mesh.labels, "local_slots": mesh.local_slots,
    "backend": pm.collective_backend(),
    "launches": dict(als_accum.KERNEL_LAUNCHES),
    "train_s": train_s, "process_s": time.perf_counter() - t0,
    "stage_s": als.LAST_PLAN_INFO["stage_s"],
    "iteration_ms": 1e3 * als.LAST_PLAN_INFO["iterations_s"] / iterations,
    "phase_ms_per_iteration": {k: v / iterations for k, v in
                               als.LAST_PLAN_INFO["mesh_ms"].items()},
    "all_reduce_ms_per_half_step": 1e3 * stats["all_reduce"]["seconds"]
    / stats["all_reduce"]["calls"],
    "all_reduce_mb": stats["all_reduce"]["bytes"] / stats["all_reduce"]["calls"] / 1e6,
    "all_gather_ms_per_call": 1e3 * stats["all_gather"]["seconds"]
    / stats["all_gather"]["calls"],
    "collectives": stats,
}), flush=True)
"""


def top10(scores: torch.Tensor) -> np.ndarray:
    """Each row's 10 best columns by (score desc, column asc): a stable
    descending sort on the scores' device."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :10].cpu().numpy()


def mesh_gate(a, b, counts: tuple, what: str) -> dict:
    """A mesh train's factors ``a`` against the one-slot train's ``b``
    (ALSState each, on the card): MESH_GATE_USERS sampled users' scores
    against every item, their top-10 order, and the largest factor
    difference beside the rating count (``counts``: per user, per item)
    of the entity that sets it."""
    n_users, n_items = a.user_factors.shape[0], a.item_factors.shape[0]
    rng = np.random.default_rng(SEED + 80)
    users = torch.from_numpy(np.sort(rng.choice(
        n_users, min(MESH_GATE_USERS, n_users), replace=False))).to(
        a.user_factors.device)
    sa_d = a.user_factors[users] @ a.item_factors.T
    sb_d = b.user_factors[users] @ b.item_factors.T
    sa, sb = sa_d.cpu().numpy(), sb_d.cpu().numpy()
    np.testing.assert_allclose(sa, sb, rtol=5e-2, atol=5e-3, err_msg=what)
    agree = float((top10(sa_d) == top10(sb_d)).all(axis=1).mean())
    assert agree >= MESH_TOP10_AGREE, (what, agree)
    worst = {}
    for name, count in zip(("user", "item"), counts):
        d = (getattr(a, f"{name}_factors") - getattr(b, f"{name}_factors")).abs()
        per = d.max(dim=1).values.cpu().numpy()
        j = int(per.argmax())
        worst[name] = {"max_abs_diff": float(per[j]), "index": j,
                       "ratings": int(count[j])}
    return {"users": len(users), "top10_agree": agree,
            "max_abs_score_diff": float(np.abs(sa - sb).max()),
            "max_abs_factor_diff": worst}


def chunked_hold(staged: dict, other: torch.Tensor, p, what: str) -> float:
    """Kernel 2 over a chunked staged stream (every chunk, through
    ``als.accumulate``) against ``segment_stats_chunked_plain``, within
    ALS_RTOL of the absolute sums; returns the largest difference."""
    from predictionio_tpu_torch.ops import als, als_accum

    args = (staged["plan_args"], staged["oth"])
    n_blocks = staged["plan"].n_blocks
    got = als.accumulate(staged, other, p, "chunked")
    want = als_accum.segment_stats_chunked_plain(
        *args, staged["rat"], staged["val"], other, p.implicit_prefs, p.alpha,
        n_blocks, p.pallas_precision)
    scale = als_accum.segment_stats_chunked_plain(
        *args, staged["rat"].abs(), staged["val"], other.abs(), p.implicit_prefs,
        p.alpha, n_blocks, p.pallas_precision)
    return hold(got, want, scale, False, what)


def start_mesh_workers(tmp: Path, ratings, device: str) -> list:
    """(c)'s two worker processes, started once (a)'s trains are timed:
    each imports the port, reads the ``.npz`` written here once and keeps
    its half of the users' ratings (by ``entity_shard``) while the rest of
    (a), (b) and (d) run, then waits for ``go`` before it touches the
    device."""
    from predictionio_tpu_torch.data.storage.base import entity_shard

    u, i, r = ratings
    shard = np.array([entity_shard("user", f"u{x}", MESH_RANKS)
                      for x in range(ML20M_USERS)], np.int8)
    np.savez(tmp / "ratings.npz", u=u, i=i, r=r, shard=shard)
    port = free_ports(1)[0]
    procs = []
    for rank in range(MESH_RANKS):
        env = dict(os.environ, PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PIO_NUM_PROCESSES=str(MESH_RANKS), PIO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_WORKER, str(tmp / "ratings.npz"),
             str(tmp / "factors.npz"), str(ML20M_USERS), str(ML20M_ITEMS),
             str(RANK), str(MESH_RANK_ITERATIONS), device, str(tmp / "go")],
            env=env, cwd=Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def finish_mesh_workers(tmp: Path, procs: list, device: str):
    """Let (c)'s workers join the group and train; their lines, and rank
    0's factors as an ALSState on ``device``.  A worker that fails or runs
    past MESH_WORKER_TIMEOUT_S fails the phase."""
    from predictionio_tpu_torch.ops import als

    (tmp / "go").touch()
    try:
        results = [proc.communicate(timeout=MESH_WORKER_TIMEOUT_S) for proc in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a mesh_train worker ran past {MESH_WORKER_TIMEOUT_S} s")
    for rank, (proc, (stdout, stderr)) in enumerate(zip(procs, results)):
        if proc.returncode != 0:
            raise AssertionError(
                f"mesh_train worker {rank} exited {proc.returncode}:\n{stderr[-4000:]}")
    factors = np.load(tmp / "factors.npz")
    two = als.ALSState(torch.from_numpy(factors["U"]).to(device),
                       torch.from_numpy(factors["V"]).to(device))
    return [json.loads(stdout.splitlines()[-1]) for stdout, _ in results], two


def mesh_engine_train(device: str, slot: str) -> dict:
    """(d): ``run_train`` of the recommendation engine on the ML-100K cut,
    once on the context's one slot and once on MESH_SLOTS slots (counted),
    the second's ``mesh_conf`` recorded, held to the first by the gate."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import MeshConfig
    from predictionio_tpu_torch.tools import commands as cmd

    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp / "home")}))
        try:
            cmd.app_new(storage, "meshrec")
            small_u, small_i, _ = write_ml100k(tmp / "ratings.jsonl", CUT_ML100K_EVENTS)
            cmd.import_events(storage, "meshrec", tmp / "ratings.jsonl")
            engine = resolve_engine_factory("recommendation")()
            params = engine.params_from_json({
                "datasource": {"params": {"appName": "meshrec"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": RANK, "numIterations": MESH_ENGINE_ITERATIONS}}],
            })
            config = MeshConfig({"data": MESH_SLOTS})
            single = run_train(engine, params,
                               ctx=EngineContext(storage=storage, device=device),
                               engine_id="meshrec", engine_factory="recommendation",
                               storage=storage)
            # -- the main path, with every launch count at 0 just before it --
            reset_launches()
            meshed = run_train(
                engine, params,
                ctx=EngineContext(storage=storage, device=device, mesh_config=config,
                                  mesh_devices=[slot] * MESH_SLOTS),
                engine_id="meshrec", engine_factory="recommendation", storage=storage)
            launches = read_launches()
            # -- end --
            inst = storage.engine_instances().get(meshed.id)
            blobs = [load_factors(storage, x.id) for x in (single, meshed)]
        finally:
            storage.close()
    states = [als.ALSState(torch.as_tensor(b["user_factors"]).to(device),
                           torch.as_tensor(b["item_factors"]).to(device))
              for b in blobs]
    assert [list(b["user_vocab"]) for b in blobs[1:]] == [list(blobs[0]["user_vocab"])]
    # each vocabulary entry's rating count, in vocabulary order
    counts = tuple(
        np.bincount(raw, minlength=n)[[int(x[1:]) for x in blobs[0][vocab]]]
        for raw, n, vocab in ((small_u, ML100K_USERS, "user_vocab"),
                              (small_i, ML100K_ITEMS, "item_vocab")))
    out = {
        "events": CUT_ML100K_EVENTS, "iterations": MESH_ENGINE_ITERATIONS,
        "mesh_conf": inst.mesh_conf, "launches": launches,
        "gate": mesh_gate(states[1], states[0], counts,
                          "run_train on 4 slots against one"),
    }
    assert inst.mesh_conf == config.to_dict(), inst.mesh_conf
    assert not on_card or (
        launches["als_fused_accum"] == 2 * MESH_SLOTS * MESH_ENGINE_ITERATIONS), out
    return out


def mesh_train_phase(ratings=None, device="cuda") -> dict:
    """ALS over a mesh on the card (``train_als(mesh=)``,
    ``train_als_global``): (a) 4 data slots of ``cuda:0`` at the ML-20M
    shape, kernel 1 once per slot per half-step on the slot's stream (2 x 4
    x 5 launches), held to the one-slot train from the same start, each
    slot's stats at one half-step held to the plain version, kernel 1 timed
    at one slot's shape and the iteration split into the slots'
    accumulation, the cross-slot sum, the solves and the gathers; (b) the
    chunked rung over the same mesh on the stream's first 1,000,000
    ratings, kernel 2 once per slot per chunk, each slot's stats held to
    the plain version and the factors to the fused mesh train within
    MESH_FACTOR_ATOL and by (a)'s gate; (c) two processes on ``cuda:0`` joined over ``torch.distributed``
    (the backend rule picks gloo: both ranks share the card), each with
    half the users' ratings, through ``balance_local_chunks``,
    ``global_data_array`` and ``train_als_global``, rank 0's factors held
    to a one-process train (the workers start once (a)'s trains are timed
    and wait, so their start-up overlaps the rest of (a), (b) and (d);
    they touch the card only after (d): started before (a)'s trains, in
    my chip call 4, they slowed the one-slot iteration from 9.3-10.8 ms
    to 81.8); (d) ``run_train`` of the recommendation engine on the ML-100K
    cut with a 4-slot context (``mesh_engine_train``).  Every count of
    launches is set to 0 just before each mesh train and read just after
    it.  ``device="cpu"`` rehearses the phase with the plain versions at
    whatever shape the ML20M_* and ML100K_* constants give (launch counts
    and timings are the card's only)."""
    t_phase = time.perf_counter()
    if ratings is None:
        ratings = movielens_like(ML20M_RATINGS, ML20M_USERS, ML20M_ITEMS, SEED + 20,
                                 half_stars=True)
    u, i, r = ratings
    out: dict = {"phase": "mesh_train",
                 "shape": [ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS], "rank": RANK,
                 "slots": MESH_SLOTS, "iterations": MESH_ITERATIONS}
    part_s = out["part_s"] = {}
    workers_dir = tempfile.TemporaryDirectory()
    procs: list = []
    try:
        def start_workers() -> None:
            t0 = time.perf_counter()
            procs.extend(start_mesh_workers(Path(workers_dir.name), ratings, device))
            part_s["c_start"] = time.perf_counter() - t0

        out.update(mesh_on_slots(ratings, device, part_s, start_workers))
        t_part = time.perf_counter()
        out["engine"] = mesh_engine_train(device, out.pop("slot"))
        part_s["d"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        workers, two = finish_mesh_workers(Path(workers_dir.name), procs, device)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        workers_dir.cleanup()
    one3 = out.pop("one3")
    out["two_process"] = {
        "ranks": workers, "wall_s": max(w["process_s"] for w in workers),
        "gate": mesh_gate(two, one3, out.pop("counts"), "two processes against one"),
    }
    for w in workers:
        assert w["backend"] == "gloo" and w["mesh"] == {"data": MESH_RANKS}, w
        assert torch.device(device).type != "cuda" or (
            w["launches"]["als_fused_accum"] == 2 * MESH_RANK_ITERATIONS), w
    assert sum(w["rows"] for w in workers) == len(u)
    print(f"mesh_train (c): backend {workers[0]['backend']}, all_reduce "
          f"{[round(w['all_reduce_ms_per_half_step'], 3) for w in workers]} ms "
          "a half-step", flush=True)
    part_s["c"] = time.perf_counter() - t_part
    if torch.device(device).type == "cuda":
        out["nvidia_smi"] = nvidia_smi_line()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def mesh_on_slots(ratings, device: str, part_s: dict, after_timed) -> dict:
    """(a) and (b) of ``mesh_train`` on MESH_SLOTS slots of one device,
    calling ``after_timed()`` once (a)'s trains are timed; also returns
    (c)'s one-process reference (``one3``), the rating counts and the slot
    device for the phase to pass on."""
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    u, i, r = ratings
    out: dict = {}
    p = als.ALSParams(rank=RANK, num_iterations=MESH_ITERATIONS, pallas_mode="fused")
    U0, V0 = als._init_factors(p, ML20M_USERS, ML20M_ITEMS, ML20M_USERS,
                               ML20M_ITEMS, "cpu")
    init = (U0.numpy(), V0.numpy())
    on_card = torch.device(device).type == "cuda"
    slot = "cuda:0" if on_card else "cpu"
    mesh = make_mesh(MeshConfig({"data": MESH_SLOTS}), devices=[slot] * MESH_SLOTS)
    counts = (np.bincount(u, minlength=ML20M_USERS),
              np.bincount(i, minlength=ML20M_ITEMS))
    t_part = time.perf_counter()
    # -- (a) the one-slot train beside it, then 4 slots --
    eff0 = device_obs.default_efficiency().snapshot()["functions"].get(
        "als.pallas_step", {})
    one = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p, device=device,
                        init_factors=init)
    if on_card:
        out["one_slot_iteration_ms"] = 1e3 * pallas_step_share(
            eff0, MESH_ITERATIONS)["per_iteration_s"]
    p3 = dataclasses.replace(p, num_iterations=MESH_RANK_ITERATIONS)
    one3 = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p3, device=device)
    _sync(device)
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    t0 = time.perf_counter()
    got = als.train_als(u, i, r, ML20M_USERS, ML20M_ITEMS, p, mesh=mesh,
                        init_factors=init)
    _sync(device)
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    # -- end --
    after_timed()
    info = als.LAST_PLAN_INFO
    assert not on_card or (
        out["launches"]["als_fused_accum"] == 2 * MESH_SLOTS * MESH_ITERATIONS), out
    assert info["data_slots"] == MESH_SLOTS and info["mode"] == "fused", info
    out["stage_s"] = info["stage_s"]
    out["collective_backend"] = info["collective_backend"]
    out["iteration_ms"] = 1e3 * info["iterations_s"] / MESH_ITERATIONS
    out["phase_ms_per_iteration"] = {k: v / MESH_ITERATIONS
                                     for k, v in info["mesh_ms"].items()}
    out["sum_and_gather_share"] = (
        (info["mesh_ms"]["sum"] + info["mesh_ms"]["gather"])
        / (1e3 * info["iterations_s"]))
    out["gate"] = mesh_gate(got, one, counts, "4 slots against one")
    staged = next(iter(als._STAGE_CACHE.values()))
    ni_pad = (ML20M_ITEMS + 127) // 128 * 128
    Vp = pad_rows(got.item_factors, ni_pad)
    out["slot_max_abs_err"] = [
        fused_hold(staged[pos][0], Vp, p, f"slot {pos}'s user half-step")
        for pos in sorted(staged)
    ]
    if on_card:
        out["kernel1_one_slot"] = fused_timing(staged[0][0], Vp, p)
        print(f"mesh_train (a): {MESH_SLOTS} slots {out['iteration_ms']:.2f} ms an "
              f"iteration against {out['one_slot_iteration_ms']:.2f} ms on one; "
              f"kernel 1 at one slot's shape {out['kernel1_one_slot']['ms']:.4f} ms",
              flush=True)
    del staged, Vp, got, one
    als._STAGE_CACHE.clear()
    part_s["a"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # -- (b) the chunked rung over the same mesh --
    n_b = MESH_CHUNKED_RATINGS
    pb = dataclasses.replace(p, num_iterations=MESH_CHUNKED_ITERATIONS)
    fused_b = als.train_als(u[:n_b], i[:n_b], r[:n_b], ML20M_USERS, ML20M_ITEMS,
                            pb, mesh=mesh)
    # -- the main path, with every launch count at 0 just before it --
    reset_launches()
    chunked_b = als.train_als(u[:n_b], i[:n_b], r[:n_b], ML20M_USERS, ML20M_ITEMS,
                              dataclasses.replace(pb, pallas_mode="chunked"),
                              mesh=mesh)
    _sync(device)
    launches_b = read_launches()
    # -- end --
    out["chunked"] = {"ratings": n_b, "iterations": MESH_CHUNKED_ITERATIONS,
                      "launches": launches_b, "chunks_user": info["chunks_user"],
                      "chunks_item": info["chunks_item"]}
    assert info["mode"] == "chunked" and (not on_card or launches_b[
        "als_segment_accum"] == MESH_CHUNKED_ITERATIONS * (
            info["chunks_user"] + info["chunks_item"])), out
    assert launches_b["als_fused_accum"] == 0, out
    # kernel 2 sums each slot's rows in another order than kernel 1, and
    # ALS carries the rounding into the next half-step: the factors are
    # held to the fused mesh train within MESH_FACTOR_ATOL and by (a)'s
    # gate, and each slot's kernel-2 stats at one half-step to the plain
    # version
    counts_b = (np.bincount(u[:n_b], minlength=ML20M_USERS),
                np.bincount(i[:n_b], minlength=ML20M_ITEMS))
    gate_b = out["chunked"]["gate"] = mesh_gate(
        chunked_b, fused_b, counts_b, "chunked mesh train against fused")
    gap_b = max(w["max_abs_diff"] for w in gate_b["max_abs_factor_diff"].values())
    assert gap_b <= MESH_FACTOR_ATOL, ("chunked mesh factors against fused", gate_b)
    staged = next(iter(als._STAGE_CACHE.values()))
    Vp = pad_rows(chunked_b.item_factors, ni_pad)
    out["chunked"]["slot_max_abs_err"] = [
        chunked_hold(staged[pos][0], Vp, pb, f"slot {pos}'s chunked user half-step")
        for pos in sorted(staged)
    ]
    del fused_b, chunked_b, staged, Vp
    part_s["b"] = time.perf_counter() - t_part
    als._STAGE_CACHE.clear()
    out.update(one3=one3, counts=counts, slot=slot)
    return out



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


#: the ecommerce train's stream: the views (and buys) of the ML-20M stream's
#: first FAMILY_RATINGS ratings, over all ML-20M users and items (cut from
#: all 20,000,263 to 10,000,000 to make room for the day phase, to
#: 7,500,000 for sharded_serving, then to 5,000,000 for check: the train's
#: vocabulary and latest-pair passes over the events are host time)
FAMILY_RATINGS = 5_000_000


def als_family_train_phase(storage, ratings) -> tuple[dict, dict]:
    """``ECommAlgorithm.train`` on the card at the ML-20M shape: implicit
    ALS (alpha 1, rank 10, 20 iterations) over a view/buy stream built in
    memory from ``FAMILY_RATINGS`` ratings, under ``torch.profiler``; stage
    seconds, kernel 1's launches and
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
                 "shape": [ML20M_USERS, ML20M_ITEMS, FAMILY_RATINGS],
                 "reduced": {"ratings": [ML20M_RATINGS, FAMILY_RATINGS]},
                 "rank": RANK, "iterations": ITERATIONS, "alpha": 1.0}
    t_phase = t0 = time.perf_counter()
    ev_u, ev_i, is_buy, times = ecomm_stream(
        *(x[:FAMILY_RATINGS] for x in ratings), SEED + 30)
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


def write_shop_events(path: Path, events: int = ML100K_EVENTS) -> dict:
    """An ecommerce app's events at the ML-100K shape, as JSON lines: 943
    user and 1,682 item ``$set`` events (1-3 categories each), the
    ``view``/``buy`` stream of ``ecomm_stream`` over the stream's first
    ``events`` ratings and the unavailableItems constraint.  Returns the
    count of views and buys."""
    ev_u, ev_i, is_buy, times = ecomm_stream(*(x[:events] for x in movielens_like(
        ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS, SEED + 40, half_stars=False)),
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
    ``$set`` events (with categories), CUT_ML100K_EVENTS ``view`` events,
    their ``buy`` subset and the unavailableItems constraint; ``app new`` ->
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
                 "shape": [ML100K_USERS, ML100K_ITEMS, CUT_ML100K_EVENTS],
                 "reduced": {"events": [ML100K_EVENTS, CUT_ML100K_EVENTS]},
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
        out["events"] = write_shop_events(tmp / "events.jsonl", CUT_ML100K_EVENTS)
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
#: the ingested stream: the first INGEST_EVENTS of the ML-100K-shaped
#: stream (cut from all 100,000 to 20,000 to make room for the watch phase,
#: to 10,000 for the day phase, then to 5,000 for check; the users, items
#: and rates per event keep the ML-100K shape)
INGEST_EVENTS = 5_000
LIVE_USERS = 8  # the live loop's users, one view POSTed for each
#: the tied slice: the stream's first TIED_EVENTS, TIED_PER_SECOND of them
#: to one second, each second's events spread over 20 batches (cut from
#: 20,000 with the stream; taken from the whole stream, so INGEST_EVENTS'
#: later cuts leave it whole)
TIED_EVENTS, TIED_PER_SECOND = 6_000, 1_000


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
    tied = [{**e, "eventTime": rates[j - j % TIED_PER_SECOND]["eventTime"]}
            for j, e in enumerate(rates[:TIED_EVENTS])]
    assert len(tied) == TIED_EVENTS, (len(tied), TIED_EVENTS)
    return tied


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
    subprocess, fed the first INGEST_EVENTS of the ML-100K-shaped ``rate``
    stream by INGEST_CLIENTS threads in batches of 50, then INGEST_SINGLES single POSTs (events and both
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
                 "shape": [ML100K_USERS, ML100K_ITEMS, INGEST_EVENTS],
                 "reduced": {"events": [ML100K_EVENTS, INGEST_EVENTS],
                             "tied_events": [20_000, TIED_EVENTS]},
                 "rank": RANK, "iterations": ITERATIONS, "clients": INGEST_CLIENTS,
                 "nvidia_smi": nvidia_smi_line()}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        home = tmp / "pio_home"
        storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(home)}))
        u, i, r = movielens_like(ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS,
                                 SEED + 10, half_stars=False)
        rates, singles = ingest_streams(u[:INGEST_EVENTS], i[:INGEST_EVENTS],
                                        r[:INGEST_EVENTS])
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
            tied = tied_stream(ingest_streams(u[:TIED_EVENTS], i[:TIED_EVENTS],
                                              r[:TIED_EVENTS])[0])
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
#: epochs of the defaults' train: the default 5 cut to 2 to make room for
#: the fleet phase (each epoch runs the same ~960 steps; the loss must
#: still fall from the first to the last)
NCF_EPOCHS = 2
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
    (64, 32, 16), bpr, one negative, batch 8,192) for NCF_EPOCHS, each epoch's
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
    params = ncf_engine.NCFAlgorithmParams(num_epochs=NCF_EPOCHS)
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


# -- NCF over a mesh: slots of one card, then two processes on it -------------

#: ``ncf_mesh_train``'s mesh: 4 slots of cuda:0
NCF_MESH_AXES = {"data": 2, "model": 2}
#: (a) the defaults' bpr epoch, and (b)'s full_softmax epoch: the phase's
#: first positives
NCF_MESH_POSITIVES = 1_000_000
#: (b) the pretrain's ALS iterations over the mesh (every positive)
NCF_MESH_ALS_ITERATIONS = 2
#: (c) two processes on cuda:0, 2 slots each, on the first positives
NCF_MESH_RANKS, NCF_MESH_RANK_POSITIVES = 2, 200_000
NCF_MESH_WORKER_TIMEOUT_S = 300
#: the chunk of users scored at once by the gate (the tower's activations
#: are [chunk, items, 64] floats)
NCF_GATE_CHUNK = 32
#: an NCF train over the mesh against the one-slot (or one-process) train
#: after an epoch: at most this many times the largest score gap of the
#: reference train from a start one ulp away, and a top-10 agreement at
#: most NCF_BAND_TOP10 below that train's (``ncf_band_gate``).  The ALS
#: gate (rtol 5e-2 / atol 5e-3, top-10 >= 90%) cannot hold here: on an
#: H100 the one-slot train of (a) against itself from a 1-ulp start parted
#: by 0.112 with 66.9% of top-10 equal after one epoch
NCF_BAND_FACTOR, NCF_BAND_TOP10 = 2.0, 0.15

NCF_MESH_WORKER = r"""
import json, os, sys, time
from pathlib import Path
import numpy as np
import torch
from predictionio_tpu_torch.ops import ncf
from predictionio_tpu_torch.parallel import mesh as pm

rank = int(os.environ["PIO_PROCESS_ID"])
data = np.load(sys.argv[1])
u, i = data["u"], data["i"]
n_users, n_items = int(sys.argv[3]), int(sys.argv[4])
device, go = sys.argv[5], Path(sys.argv[6])
# the parent starts this process early: it joins the group and makes its
# CUDA context now, and runs nothing on the card until the parent says
# the card is free
t0 = time.perf_counter()
pm.initialize_distributed(device=device, local_devices=[device, device])
assert pm.process_index() == rank
# torch imports much of itself at the first optimizer step: take it now
w = torch.zeros(1, device=device, requires_grad=True)
w.grad = torch.zeros_like(w)
torch.optim.Adam([w]).step()
join_s = time.perf_counter() - t0
deadline = time.monotonic() + 600
while not go.exists():
    assert time.monotonic() < deadline, "no go from the parent"
    time.sleep(0.05)
t0 = time.perf_counter()
mesh = pm.make_mesh(pm.MeshConfig(json.loads(sys.argv[7])))
p = ncf.NCFParams(num_epochs=1)
pm.COLLECTIVE_STATS.clear()
t1 = time.perf_counter()
state = ncf.train_ncf(u, i, n_users, n_items, p, mesh=mesh)
train_s = time.perf_counter() - t1
if rank == 0:
    np.savez(sys.argv[2], *ncf.tree_leaves(ncf.host_params(state.params)))
stats = pm.COLLECTIVE_STATS
info = ncf.LAST_MESH_INFO
steps = info["steps_per_epoch"]
print(json.dumps({
    "rank": rank, "mesh": mesh.shape, "labels": mesh.labels,
    "local_slots": mesh.local_slots, "local_positions": info["local_positions"],
    "backend": pm.collective_backend(), "join_s": join_s, "train_s": train_s,
    "setup_s": info["setup_s"], "process_s": time.perf_counter() - t0,
    "epoch_s": state.epoch_seconds,
    "epoch_loss": state.epoch_losses, "steps": steps,
    "step_ms": 1e3 * state.epoch_seconds[0] / steps,
    "phase_ms_per_step": {k: v / steps for k, v in info["mesh_ms"].items()},
    "all_reduce_ms_per_call": 1e3 * stats["all_reduce"]["seconds"]
    / stats["all_reduce"]["calls"],
    "all_reduce_mb_per_call": stats["all_reduce"]["bytes"]
    / stats["all_reduce"]["calls"] / 1e6,
    "status_ms_per_call": 1e3 * stats["status"]["seconds"] / stats["status"]["calls"],
    "collectives": stats,
}), flush=True)
"""


def ncf_scores(params: dict, users: torch.Tensor, n_items: int) -> torch.Tensor:
    """``users``' scores against every real item ([len(users), n_items]),
    NCF_GATE_CHUNK users at a time through ``score_users_vs_items``."""
    from predictionio_tpu_torch.ops import ncf

    head = {k: v for k, v in params.items() if k in ("mlp", "out_w", "out_b")}
    bias = params.get("item_bias")
    bias = None if bias is None else bias[:n_items]
    return torch.cat([
        ncf.score_users_vs_items(head, params["user_emb"][chunk],
                                 params["item_emb"][:n_items], bias)
        for chunk in users.split(NCF_GATE_CHUNK)])


def ncf_compare(a: dict, b: dict, n_users: int, n_items: int) -> dict:
    """Tree ``a`` against tree ``b``: MESH_GATE_USERS sampled users' scores
    against every real item (the largest gap, the share of scores outside
    the ALS mesh gate's rtol 5e-2 / atol 5e-3, and the share of users
    whose top-10 order is equal), and the largest parameter gap per
    leaf."""
    from predictionio_tpu_torch.ops import ncf

    rng = np.random.default_rng(SEED + 81)
    users = torch.from_numpy(np.sort(rng.choice(
        n_users, min(MESH_GATE_USERS, n_users), replace=False))).to(
        a["user_emb"].device)
    with torch.no_grad():
        sa, sb = (ncf_scores(t, users, n_items) for t in (a, b))
        gap = (sa - sb.to(sa.device)).abs()
        outside = float((gap > 5e-3 + 5e-2 * sb.abs()).float().mean())
    return {
        "users": len(users),
        "top10_agree": float((top10(sa) == top10(sb)).all(axis=1).mean()),
        "max_abs_score_diff": float(gap.max()),
        "scores_outside_als_gate": outside,
        "max_abs_param_diff": {
            name: max(float((x.detach() - y.detach().to(x.device)).abs().max())
                      for x, y in zip(ncf.tree_leaves(a[name]), ncf.tree_leaves(b[name])))
            for name in a if ncf.tree_leaves(a[name])},
    }


def ncf_band_gate(got: dict, want: dict, nudged: dict, n_users: int,
                  n_items: int, what: str) -> dict:
    """``got`` held to ``want`` within the band that ``want``'s own train
    moves when its start moves by one ulp (``nudged``: the same train from
    every start value's next float up): the largest score gap at most
    NCF_BAND_FACTOR times the nudged train's, the top-10 agreement at
    least the nudged train's less NCF_BAND_TOP10.  Adam turns the rounding
    of gradients near zero into steps of up to the learning rate
    (``lr * g / (|g| + eps)``), so two trains whose sums differ only in
    order part within an epoch; the band measures how far, in this run."""
    g = ncf_compare(got, want, n_users, n_items)
    n = ncf_compare(nudged, want, n_users, n_items)
    assert g["max_abs_score_diff"] <= NCF_BAND_FACTOR * n["max_abs_score_diff"], (what, g, n)
    assert g["top10_agree"] >= n["top10_agree"] - NCF_BAND_TOP10, (what, g, n)
    return {"got": g, "one_ulp_start": n}


def nudge(tree: dict) -> dict:
    """Every value of ``tree`` moved to its next float up."""
    from predictionio_tpu_torch.ops import ncf

    return ncf.tree_map(
        lambda x: torch.nextafter(x, torch.full_like(x, float("inf"))), tree)


def ncf_mesh_step_hold(mesh, tree: dict, p, batch: tuple, n_items: int) -> dict:
    """One ``MeshNCF.step`` against one ``train_step`` on one slot from the
    same tree and batch: the loss within NCF_STEP_RTOL, the gradient the
    mesh applied within NCF_GRAD_RTOL of each leaf's largest one-slot
    entry, and the mesh's parameters after the step against the one-slot
    Adam replayed from the mesh's gradient within NCF_STEP_ATOL +
    NCF_STEP_ATOL * |parameter| (the rule of ``ncf_step_hold``); every
    slot copy equal bit for bit."""
    from predictionio_tpu_torch.ops import ncf

    dev = mesh.merge_device

    def fresh():
        leaves = ncf.tree_map(
            lambda x: x.to(dev, copy=True).requires_grad_(True), tree)
        return leaves, ncf.make_optimizer(leaves, p)

    one, opt = fresh()
    l_one = float(ncf.train_step(one, opt, *batch, p, n_items))
    st = ncf.MeshNCF(mesh, tree, p)
    l_mesh = float(st.step(*batch, n_items))
    assert abs(l_mesh - l_one) <= NCF_STEP_RTOL * abs(l_one), (l_mesh, l_one)
    g_mesh = st.gathered(grads=True)
    replay, ropt = fresh()
    for leaf, g in zip(ncf.tree_leaves(replay), ncf.tree_leaves(g_mesh)):
        leaf.grad = g.clone()
    ropt.step()
    out = {"loss_one_slot": l_one, "loss_mesh": l_mesh, "grad_max_rel_err": 0.0,
           "param_max_abs_err": 0.0, "copy_pairs_equal": copies_equal(st)}
    for go, gm, pr, pm in zip(*(ncf.tree_leaves(t) for t in (
            ncf.tree_map(lambda x: x.grad, one), g_mesh, replay, st.gathered()))):
        top = float(go.abs().max()) or 1.0
        rel = float((gm - go).abs().max()) / top
        assert rel <= NCF_GRAD_RTOL, (tuple(go.shape), rel)
        diff = (pm - pr.detach()).abs()
        assert bool((diff <= NCF_STEP_ATOL * (1.0 + pr.detach().abs())).all()), (
            tuple(go.shape), float(diff.max()))
        out["grad_max_rel_err"] = max(out["grad_max_rel_err"], rel)
        out["param_max_abs_err"] = max(out["param_max_abs_err"], float(diff.max()))
    return out


def copies_equal(st) -> int:
    """Asserts that every slot copy of a leaf, and of its Adam moments, is
    equal bit for bit; returns the number of copy pairs compared."""
    from predictionio_tpu_torch.ops import ncf

    pairs = 0
    slots = st.mesh.local_slots
    for a in slots:
        for b in slots:
            if a >= b or st.layout.m_of[a] != st.layout.m_of[b]:
                continue
            for x, y in zip(ncf.tree_leaves(st.trees[a]), ncf.tree_leaves(st.trees[b])):
                assert torch.equal(x, y), (a, b)
                for key in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(st.optimizers[a].state[x][key],
                                       st.optimizers[b].state[y][key]), (a, b, key)
                pairs += 1
    return pairs


def start_ncf_mesh_workers(tmp: Path, pos_u, pos_i, device: str) -> list:
    """(c)'s two workers, started once (a)'s trains are timed: each reads
    the first NCF_MESH_RANK_POSITIVES positives (every rank the identical
    full arrays), joins the group and makes its CUDA context, and waits
    for ``go`` before it runs anything on the card."""
    n = NCF_MESH_RANK_POSITIVES
    np.savez(tmp / "positives.npz", u=pos_u[:n], i=pos_i[:n])
    port = free_ports(1)[0]
    procs = []
    for rank in range(NCF_MESH_RANKS):
        env = dict(os.environ, PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PIO_NUM_PROCESSES=str(NCF_MESH_RANKS), PIO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", NCF_MESH_WORKER, str(tmp / "positives.npz"),
             str(tmp / "tree.npz"), str(ML20M_USERS), str(ML20M_ITEMS),
             "cuda:0" if torch.device(device).type == "cuda" else "cpu",
             str(tmp / "go"), json.dumps(NCF_MESH_AXES)],
            env=env, cwd=Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def ncf_mesh_engine_train(device: str, slot: str) -> dict:
    """(d): ``run_train`` of the ncf template (the pretrain recipe) on the
    ML-100K cut with an engine.json ``"mesh"`` of NCF_MESH_AXES over 4
    slots; its ``mesh_conf``, kernel 1's launches (2 data slots x 2
    half-steps x 20 iterations) and one answered query."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.parallel.mesh import MeshConfig
    from predictionio_tpu_torch.server.prediction_server import deploy_engine
    from predictionio_tpu_torch.tools import commands as cmd

    on_card = torch.device(device).type == "cuda"
    variant = {
        "id": "ncfmesh", "engineFactory": "ncf",
        "mesh": {"axes": dict(NCF_MESH_AXES)},
        "datasource": {"params": {"appName": "ncfmesh"}},
        "algorithms": [{"name": "ncf", "params": {
            "embedDim": NCF_PRETRAIN["embed_dim"], "mlpLayers": [],
            "loss": NCF_PRETRAIN["loss"], "learningRate": NCF_PRETRAIN["learning_rate"],
            "weightDecay": NCF_PRETRAIN["weight_decay"], "numEpochs": 1,
            "pretrain": "als"}}],
    }
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp / "home")}))
        try:
            cmd.app_new(storage, "ncfmesh")
            write_ml100k(tmp / "ratings.jsonl", CUT_ML100K_EVENTS)
            cmd.import_events(storage, "ncfmesh", tmp / "ratings.jsonl")
            engine = resolve_engine_factory("ncf")()
            ctx = EngineContext(storage=storage, device=device,
                                mesh_config=MeshConfig.from_dict(variant["mesh"]),
                                mesh_devices=[slot] * 4)
            # -- the main path, with every launch count at 0 just before it --
            reset_launches()
            t0 = time.perf_counter()
            inst = run_train(engine, engine.params_from_json(variant), ctx=ctx,
                             engine_id="ncfmesh", engine_factory="ncf", storage=storage)
            train_s = time.perf_counter() - t0
            launches = read_launches()
            # -- end --
            mesh_conf = storage.engine_instances().get(inst.id).mesh_conf
            dep = deploy_engine("ncf", storage=storage, engine_instance_id=inst.id,
                                device=device)
            _, answer = dep.predict(dep.extract_query({"user": "u1", "num": 10}))
            n_items = len(dep.models[0].item_vocab)
            table_rows = int(dep.models[0].state.params["item_emb"].shape[0])
        finally:
            storage.close()
    items = [x.item for x in answer.item_scores]
    assert len(items) == 10 and all(int(x[1:]) < ML100K_ITEMS for x in items), items
    assert mesh_conf == variant["mesh"], mesh_conf
    assert not on_card or launches["als_fused_accum"] == 2 * 2 * ITERATIONS, launches
    return {"events": CUT_ML100K_EVENTS, "train_s": train_s, "mesh_conf": mesh_conf,
            "launches": launches, "items": n_items, "item_table_rows": table_rows,
            "answer_u1": [[x.item, x.score] for x in answer.item_scores]}


def ncf_mesh_train_phase(ratings, device="cuda") -> dict:
    """NCF over a mesh on the card (``train_ncf(mesh=)``, ``MeshNCF``), on
    ``ncf_train``'s ML-20M positives and 4 slots of ``cuda:0`` as
    NCF_MESH_AXES: (a) one epoch of the template's defaults (embed 32, MLP
    (64, 32, 16), bpr, batch 8,192) over the first NCF_MESH_POSITIVES
    positives, the mesh beside the one-slot train from the same tree
    (drawn at the padded shape, 138,494 x 26,744) and the same draws, both
    step times; the first step held strictly (``ncf_mesh_step_hold``), the
    epoch within the one-slot train's own 1-ulp band (``ncf_band_gate``),
    the block copies bit for bit, the loss on the first batch falling;
    (b) the pretrain recipe over the mesh:
    ``train_als(mesh=)`` at rank 32, implicit, NCF_MESH_ALS_ITERATIONS
    iterations over every positive (kernel 1 once per data slot per
    half-step: 8), each data slot's stats held to the plain version and
    kernel 1 timed at one slot's shape, then one full_softmax epoch of
    ``train_ncf(mesh=)`` from those tables; (c) two processes on
    ``cuda:0`` over gloo, 2 slots each, on the first
    NCF_MESH_RANK_POSITIVES positives, rank 0's tree held to the
    one-process mesh train within that train's 1-ulp band; (d)
    ``run_train`` of the template
    with an engine.json mesh (``ncf_mesh_engine_train``).  ``device="cpu"``
    rehearses it with the plain versions at whatever shape the ML20M_*
    constants give."""
    from predictionio_tpu_torch.models.ncf import engine as ncf_engine
    from predictionio_tpu_torch.ops import als, ncf
    from predictionio_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    slot = "cuda:0" if on_card else "cpu"
    u, i, r = ratings
    positives = r >= 4.0
    pos_u, pos_i = u[positives], i[positives]
    out: dict = {"phase": "ncf_mesh_train", "mesh": dict(NCF_MESH_AXES),
                 "slots": 4, "positives": int(positives.sum())}
    part_s = out["part_s"] = {}
    mesh = make_mesh(MeshConfig(dict(NCF_MESH_AXES)), devices=[slot] * 4)
    m = NCF_MESH_AXES["model"]
    nu_pad, ni_pad = -(-ML20M_USERS // m) * m, -(-ML20M_ITEMS // m) * m
    workers_dir = tempfile.TemporaryDirectory()
    procs: list = []
    try:
        # -- (a) the defaults' epoch, one slot then the mesh --
        t_part = time.perf_counter()
        n_a = NCF_MESH_POSITIVES
        u_a, i_a = pos_u[:n_a], pos_i[:n_a]
        p = ncf.NCFParams(num_epochs=1)
        tree = ncf.init_ncf(torch.Generator().manual_seed(p.seed), nu_pad, ni_pad, p)
        stream = ncf.stage_stream(u_a, i_a, p, dev, multiple=NCF_MESH_AXES["data"])
        cdf = torch.from_numpy(ncf.negative_sampling_cdf(i_a, ML20M_ITEMS, p.neg_power)).to(dev)
        b = stream.batch
        first = (stream.u[:b], stream.i[:b],
                 torch.from_numpy(np.random.default_rng(SEED + 82).integers(
                     0, ML20M_ITEMS, (b, 1))).to(dev),
                 stream.valid[:b], stream.w[:b])
        step_hold = ncf_mesh_step_hold(mesh, tree, p, first, ML20M_ITEMS)

        def one_slot(start):
            leaves = ncf.tree_map(
                lambda x: x.to(dev, copy=True).requires_grad_(True), start)
            opt = ncf.make_optimizer(leaves, p)
            ncf.train_epoch(leaves, opt, stream, p, ML20M_ITEMS,
                            torch.Generator(device=dev).manual_seed(p.seed), cdf)
            return ncf.tree_map(lambda x: x.detach(), leaves)

        with torch.no_grad():
            loss0 = float(ncf.bpr_loss(ncf.tree_map(lambda x: x.to(dev), tree),
                                       *first[:4]))
        _sync(device)
        t0 = time.perf_counter()
        one = one_slot(tree)
        _sync(device)
        one_s = time.perf_counter() - t0
        nudged = one_slot(nudge(tree))
        st = ncf.MeshNCF(mesh, tree, p)
        del tree
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        t0 = time.perf_counter()
        epoch_loss = float(st.train_epoch(
            stream, ML20M_ITEMS, torch.Generator(device=dev).manual_seed(p.seed), cdf))
        _sync(device)
        mesh_s = time.perf_counter() - t0
        launches_a = read_launches()
        # -- end --
        t_workers = time.perf_counter()
        procs.extend(start_ncf_mesh_workers(Path(workers_dir.name), pos_u, pos_i, device))
        part_s["c_start"] = time.perf_counter() - t_workers
        meshed = st.gathered()
        with torch.no_grad():
            loss1 = float(ncf.bpr_loss(meshed, *first[:4]))
        assert loss1 < loss0, (loss0, loss1)
        steps = stream.n_steps
        out["a"] = {
            "positives": n_a, "steps": steps, "batch": stream.batch,
            "padded": [nu_pad, ni_pad], "epoch_loss": epoch_loss,
            "first_batch_loss": [loss0, loss1],
            "one_slot_step_ms": 1e3 * one_s / steps, "mesh_step_ms": 1e3 * mesh_s / steps,
            "mesh_phase_ms_per_step": {k: v / steps for k, v in st.clock.ms().items()},
            "launches": launches_a, "copy_pairs_equal": copies_equal(st),
            "first_step": step_hold,
            "gate": ncf_band_gate(meshed, one, nudged, ML20M_USERS, ML20M_ITEMS,
                                  "4 slots against one"),
        }
        if on_card:
            print(f"ncf_mesh_train (a): {steps} steps, mesh "
                  f"{out['a']['mesh_step_ms']:.2f} ms a step against "
                  f"{out['a']['one_slot_step_ms']:.2f} ms on one slot", flush=True)
        del st, one, nudged, meshed, stream
        part_s["a"] = time.perf_counter() - t_part

        # -- (b) the pretrain recipe over the mesh --
        t_part = time.perf_counter()
        pre = ncf_engine.NCFAlgorithmParams(**NCF_PRETRAIN)
        p32 = als.ALSParams(rank=pre.embed_dim, num_iterations=NCF_MESH_ALS_ITERATIONS,
                            reg=0.01, seed=pre.seed, implicit_prefs=True, alpha=pre.alpha)
        p_ft = dataclasses.replace(ncf_engine.NCFAlgorithm(pre)._ncf_params(),
                                   num_epochs=1)
        _sync(device)
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        t0 = time.perf_counter()
        als_state = als.train_als(pos_u, pos_i, np.ones(len(pos_u), np.float32),
                                  ML20M_USERS, ML20M_ITEMS, p32, mesh=mesh)
        _sync(device)
        als_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fine = ncf.train_ncf(u_a, i_a, ML20M_USERS, ML20M_ITEMS, p_ft, mesh=mesh,
                             initial_params={"user_emb": als_state.user_factors,
                                             "item_emb": als_state.item_factors})
        _sync(device)
        ft_s = time.perf_counter() - t0
        launches_b = read_launches()
        # -- end --
        info = dict(ncf.LAST_MESH_INFO)
        assert not on_card or launches_b["als_fused_accum"] == (
            2 * NCF_MESH_AXES["data"] * NCF_MESH_ALS_ITERATIONS), launches_b
        assert np.isfinite(fine.epoch_losses).all(), fine.epoch_losses
        staged = next(iter(als._STAGE_CACHE.values()))
        assert sorted(staged) == list(range(NCF_MESH_AXES["data"])), sorted(staged)
        Vp = pad_rows(als_state.item_factors, (ML20M_ITEMS + 127) // 128 * 128)
        out["b"] = {
            "als_iterations": NCF_MESH_ALS_ITERATIONS, "als_s": als_s,
            "als_stage_s": als.LAST_PLAN_INFO["stage_s"],
            "als_phase_ms_per_iteration": {
                k: v / NCF_MESH_ALS_ITERATIONS
                for k, v in als.LAST_PLAN_INFO["mesh_ms"].items()},
            "launches": launches_b,
            "slot_max_abs_err": [
                fused_hold(staged[pos][0], Vp, p32, f"data slot {pos}'s user half-step")
                for pos in sorted(staged)],
            "full_softmax_epoch_s": ft_s, "full_softmax_epoch_loss": fine.epoch_losses,
            "full_softmax_step_ms": 1e3 * fine.epoch_seconds[0] / info["steps_per_epoch"],
            "full_softmax_phase_ms_per_step": {
                k: v / info["steps_per_epoch"] for k, v in info["mesh_ms"].items()},
            "catalog_gather_mb_per_step": info["gather_bytes_per_step"] / 1e6,
            "route_mb_per_step": info["route_bytes_per_step"] / 1e6,
            "shards": info["shards"],
        }
        if on_card:
            out["b"]["kernel1_one_slot"] = fused_timing(staged[0][0], Vp, p32)
            print(f"ncf_mesh_train (b): kernel 1 at one data slot's shape "
                  f"{out['b']['kernel1_one_slot']['ms']:.4f} ms, "
                  f"{launches_b['als_fused_accum']} launches", flush=True)
        del staged, Vp, als_state, fine
        als._STAGE_CACHE.clear()
        part_s["b"] = time.perf_counter() - t_part

        # -- (d) run_train of the template over the mesh --
        t_part = time.perf_counter()
        out["d"] = ncf_mesh_engine_train(device, slot)
        part_s["d"] = time.perf_counter() - t_part
        print(f"ncf_mesh_train (d): mesh_conf {out['d']['mesh_conf']}, kernel 1 "
              f"{out['d']['launches']['als_fused_accum']} launches, u1 -> "
              f"{out['d']['answer_u1'][:3]}", flush=True)

        # -- (c) two processes, held to the one-process mesh train --
        t_part = time.perf_counter()
        n_c = NCF_MESH_RANK_POSITIVES
        p_c = ncf.NCFParams(num_epochs=1)
        ref = ncf.train_ncf(pos_u[:n_c], pos_i[:n_c], ML20M_USERS, ML20M_ITEMS,
                            p_c, mesh=mesh)
        # the same train from a start one ulp away, for the band
        st_c = ncf.MeshNCF(mesh, nudge(ncf.init_ncf(
            torch.Generator().manual_seed(p_c.seed), nu_pad, ni_pad, p_c)), p_c)
        st_c.train_epoch(
            ncf.stage_stream(pos_u[:n_c], pos_i[:n_c], p_c, dev,
                             multiple=NCF_MESH_AXES["data"]),
            ML20M_ITEMS, torch.Generator(device=dev).manual_seed(p_c.seed),
            torch.from_numpy(ncf.negative_sampling_cdf(
                pos_i[:n_c], ML20M_ITEMS, p_c.neg_power)).to(dev))
        nudged_c = st_c.gathered()
        del st_c
        tmp = Path(workers_dir.name)
        (tmp / "go").touch()
        try:
            results = [proc.communicate(timeout=NCF_MESH_WORKER_TIMEOUT_S)
                       for proc in procs]
        except subprocess.TimeoutExpired:
            raise AssertionError(
                f"an ncf_mesh_train worker ran past {NCF_MESH_WORKER_TIMEOUT_S} s")
        for rank, (proc, (_, stderr)) in enumerate(zip(procs, results)):
            if proc.returncode != 0:
                raise AssertionError(
                    f"ncf_mesh_train worker {rank} exited {proc.returncode}:\n"
                    f"{stderr[-4000:]}")
        workers = [json.loads(stdout.splitlines()[-1]) for stdout, _ in results]
        saved = np.load(tmp / "tree.npz")
        two = tree_from_leaves(ref.params, [torch.from_numpy(saved[f"arr_{j}"]).to(dev)
                                            for j in range(len(saved.files))])
        for w in workers:
            assert w["backend"] == "gloo" and w["mesh"] == NCF_MESH_AXES, w
            assert w["local_positions"] == [w["rank"]], w
        out["c"] = {"positives": n_c, "ranks": workers,
                    "wall_s": max(w["process_s"] for w in workers),
                    "one_process_epoch_loss": ref.epoch_losses,
                    "gate": ncf_band_gate(two, ref.params, nudged_c, ML20M_USERS,
                                          ML20M_ITEMS, "two processes against one")}
        print(f"ncf_mesh_train (c): backend {workers[0]['backend']}, all_reduce "
              f"{[round(w['all_reduce_ms_per_call'], 3) for w in workers]} ms a call "
              f"({workers[0]['all_reduce_mb_per_call']:.1f} MB), status "
              f"{[round(w['status_ms_per_call'], 3) for w in workers]} ms", flush=True)
        part_s["c"] = time.perf_counter() - t_part
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        workers_dir.cleanup()
    if on_card:
        out["nvidia_smi"] = nvidia_smi_line()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def tree_from_leaves(like: dict, leaves: list) -> dict:
    """The tree of ``like``'s structure holding ``leaves`` in
    ``ops.ncf.tree_leaves`` order (dict keys sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


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


def ncf_phases(ratings) -> tuple[dict, dict, dict]:
    """The ncf template on the card: ``ncf_train``, ``ncf_serving``, then
    ``ncf_mesh_train`` on the same positives."""
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
    mesh = ncf_mesh_train_phase(ratings)
    emit(mesh)
    return train, serving, mesh


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
#: logistic-regression steps of the card trains held to the CPU's
LOGREG_ITERATIONS, LOGREG_LR = 200, 0.1
#: logistic regression's weights, card against CPU, of each tensor's largest
LOGREG_RTOL = 1e-4
#: rows whose card and CPU predictions are compared
CLS_PRED_ROWS = 4096
#: the classification template's CLI store: users with $set attr0-2/plan,
#: the queries sent to its deploy and the clients sending them
#: the template's users (cut from 100,000 to make room for the watch phase)
CLS_USERS, CLS_QUERIES, CLS_CLIENTS = 20_000, 1_000, 8
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
    the card's weights after LOGREG_ITERATIONS steps are held to the CPU's within
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
    Bayes and LOGREG_ITERATIONS steps of logistic regression (lr 0.1), each trained twice
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


#: the operator phase: a 1,024-query device wave through the serve tail,
#: 32 keep-alive clients over HTTPS and then plain HTTP, 16 solo queries to
#: the CLI deploy, a 4,096-user batch job
OP_WAVE, OP_CLIENTS, OP_CLIENT_QUERIES, OP_SOLO = 1024, 32, 512, 16
OP_KEY, OP_WAVE_KEY = "OPK", "OPW"  # the access keys of two feedback apps
OP_PLUGIN_MODULE = '''\
from predictionio_tpu_torch.server.plugins import OUTPUT_BLOCKER, EngineServerPlugin


class Mark(EngineServerPlugin):
    """Marks each answer with the user it answers."""

    plugin_name = "mark"
    plugin_type = OUTPUT_BLOCKER

    def process(self, engine_instance_id, query, prediction):
        return {**prediction, "markUser": query["user"]}


mark = Mark()
'''


@contextlib.contextmanager
def scoped_env(**values):
    """``os.environ`` with ``values`` set, restored on exit."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli_once(home: Path, argvs: list, env: dict | None = None) -> list:
    """Each ``argv`` of ``argvs`` as its own ``python -m
    predictionio_tpu_torch.tools.cli`` process on ``home``, all started
    together; (exit code, stdout, stderr) of each, in order."""
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PIO_HOME=str(home), **(env or {})),
            cwd=Path(__file__).resolve().parent,
        )
        for argv in argvs
    ]
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate(timeout=30)
        out.append((proc.returncode, stdout, stderr))
    return out


def predict_events(storage, app_id: int) -> list:
    from predictionio_tpu_torch.data.storage.base import EventFilter

    return list(storage.l_events().find(
        app_id, None, EventFilter(event_names=("predict",))))


def held_feedback(events, bodies: list, users) -> int:
    """One ``predict`` event per answer, each holding its query's user and
    exactly the (plugin-marked) answer that query got."""
    got: dict = {}
    for e in events:
        assert e.entity_type == "pio_pr" and len(e.entity_id) == 64, e
        got.setdefault(e.properties.get("query")["user"], []).append(
            e.properties.get("prediction"))
    assert sum(map(len, got.values())) == len(bodies), (
        sum(map(len, got.values())), len(bodies))
    for u, body in zip(users, bodies):
        assert body["markUser"] == f"u{u}", body
        got[f"u{u}"].remove(body)  # raises when no event holds this answer
    return len(bodies)


def store_commit_probe(storage, app_id: int, n: int = 256) -> dict:
    """What the feedback tail's store costs here: ``n`` predict events
    inserted one commit each (as the tail writes them), then ``n`` in one
    ``insert_batch`` commit, into ``app_id``; and the mount the store's
    file lies on."""
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event

    def events():
        return [Event(event="predict", entity_type="pio_pr",
                      entity_id=uuid.uuid4().hex * 2,
                      properties=DataMap({"n": j})) for j in range(n)]

    levents = storage.l_events()
    one = events()
    t0 = time.perf_counter()
    for e in one:
        levents.insert(e, app_id)
    single_s = time.perf_counter() - t0
    batch = events()
    t0 = time.perf_counter()
    levents.insert_batch(batch, app_id)
    batch_s = time.perf_counter() - t0
    path = str(Path(storage.config.home).resolve())
    mounts = [line.split()[:3] for line in Path("/proc/mounts").read_text().splitlines()]
    mount = max((m for m in mounts if path.startswith(m[1])),
                key=lambda m: len(m[1]), default=None)
    return {"events": n, "single_commit_ms": 1e3 * single_s / n,
            "batch_ms_per_event": 1e3 * batch_s / n,
            "store_mount": mount and {"fs": mount[2], "at": mount[1]}}


def answers_plain_http(port: int) -> bool:
    """Whether a plain-HTTP query to ``port`` gets any HTTP answer."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", "/queries.json", body=b'{"user": "u0"}')
        conn.getresponse().read()
        return True
    except (OSError, http.client.HTTPException):
        return False
    finally:
        conn.close()


def client_stats(results: list, wall: float) -> dict:
    lat_ms = np.asarray([1e3 * r[1] for r in results])
    return {
        "queries": len(results),
        "non_200": sum(r[0] != 200 for r in results),
        "wall_s": wall,
        "queries_per_s": len(results) / wall,
        "client_p50_ms": float(np.percentile(lat_ms, 50)),
        "client_p99_ms": float(np.percentile(lat_ms, 99)),
    }


def operator_phase(device="cuda") -> dict:
    """``operator``: the operator's CLI and the serve tail.

    (a) ``version``, ``build`` of a good and a bad engine.json, ``status``
    (the storage checks, the card, backend ``cuda``), ``upgrade`` and ``run``
    of a script naming the card, each a CLI process.  (b) A seeded ML-20M
    model written under engine ``op``, version ``2``, variant ``tls``; then
    ``app new`` -> ``import`` -> ``train --engine-json`` of the ML-100K
    stream under ``op100k`` (kernel 1, 40 launches), so the latest
    COMPLETED instance is the wrong one and ``default`` names none.  (c)
    ``deploy --engine-json op.json --feedback --accesskey`` with an output
    plugin named by ``PIO_PLUGINS`` binds the ML-20M instance: 16 solo
    answers held, marked and fed back; ``status --url`` and ``metrics
    --url``; a second deploy on the port stops the first; ``undeploy``
    stops the second.  (d) The TLS deploy of that model (max_batch 1,024,
    feedback, the plugin): 1,024 users queued at once, one kernel 3 wave,
    every answer held, marked and fed back.  (e) ``batchpredict
    --engine-json op.json`` of 4,096 users, one kernel 3 launch, every line
    held.  The launch counts cover (a)-(e).  Then, outside them: the same
    wave with feedback off, and 32 keep-alive clients sending 512 queries
    over HTTPS, then plain HTTP, to deploys of the same model."""
    import socket
    import ssl

    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.server.plugins import PluginContext
    from predictionio_tpu_torch.server.prediction_server import (
        FeedbackConfig,
        create_prediction_server,
    )
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.tools import commands as cmd

    on_card = torch.device(device).type == "cuda"
    out: dict = {"phase": "operator", "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "reduced": {"ml100k_events": [ML100K_EVENTS, CUT_ML100K_EVENTS]}}
    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    home = tmp / "pio_home"
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(home)}))
    (tmp / "op_plugin.py").write_text(OP_PLUGIN_MODULE)
    plugin_env = {"PIO_PLUGINS": "op_plugin:mark",
                  "PYTHONPATH": os.pathsep.join(
                      filter(None, [str(tmp), os.environ.get("PYTHONPATH")]))}
    op_json = tmp / "op.json"
    op_json.write_text(json.dumps({
        "id": "op", "version": "2", "variant": "tls",
        "engineFactory": "recommendation",
        "datasource": {"params": {"appName": "ml20m"}},
        "algorithms": [{"name": "als", "params": {"rank": RANK}}],
    }))
    (tmp / "op100k.json").write_text(json.dumps({
        "id": "op100k", "engineFactory": "recommendation",
        "datasource": {"params": {"appName": "ml100k"}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": ITERATIONS, "lambda": 0.01, "seed": 3}}],
    }))
    (tmp / "bad.json").write_text(json.dumps({
        "engineFactory": "recommendation",
        "algorithms": [{"name": "als", "params": {"nope": 1}}],
    }))
    (tmp / "job.py").write_text(
        "import torch\nimport predictionio_tpu_torch\n"
        "print(torch.cuda.get_device_name() if torch.cuda.is_available() "
        "else 'cpu')\n")
    rng = np.random.default_rng(SEED + 110)
    wave_users = rng.choice(ML20M_USERS, OP_WAVE, replace=False)
    batch_users = rng.integers(0, ML20M_USERS, WAVE)
    solo_users = rng.integers(0, ML20M_USERS, OP_SOLO)
    client_users = rng.integers(0, ML20M_USERS, OP_CLIENT_QUERIES)
    servers: list = []
    procs: list = []
    try:
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        # (a) the basic verbs, one process each
        t0 = time.perf_counter()
        verbs = dict(zip(
            ("version", "build", "build_bad", "status", "upgrade", "run"),
            cli_once(home, [
                ["version"],
                ["build", "--engine-json", str(op_json)],
                ["build", "--engine-json", str(tmp / "bad.json")],
                ["status"],
                ["upgrade"],
                ["run", str(tmp / "job.py")],
            ])))
        out["verbs_s"] = time.perf_counter() - t0
        rc = {k: v[0] for k, v in verbs.items()}
        assert rc == {"version": 0, "build": 0, "build_bad": 1, "status": 0,
                      "upgrade": 0, "run": 0}, (rc, {k: v[2][-2000:] for k, v in verbs.items()})
        assert verbs["version"][1] == "0.1.0\n", verbs["version"]
        assert "OK" in verbs["build"][1] and "invalid" in verbs["build_bad"][2]
        status = json.loads(verbs["status"][1])
        card = torch.cuda.get_device_name(0) if on_card else None
        assert set(status["storage"].values()) == {True}, status
        if on_card:
            assert status["backend"] == "cuda", status
            assert any(card in d for d in status["devices"]), status
        assert verbs["upgrade"][1].startswith("predictionio_tpu_torch 0.1.0")
        assert not on_card or verbs["run"][1].strip() == card, verbs["run"]
        out["verbs"] = {"exit_codes": rc, "status": status,
                        "run_printed": verbs["run"][1].strip()}

        # (b) the ML-20M model under (op, 2, tls), then an ML-100K train
        # under op100k: the latest COMPLETED instance is the wrong one
        instance_id, U, V = write_model(storage, home, seed=SEED + 111,
                                        coords=("op", "2", "tls"))
        write_ml100k(tmp / "ratings.jsonl", CUT_ML100K_EVENTS)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["app", "new", "ml100k"]) == 0
            assert cli.main(["app", "new", "opfb", "--access-key", OP_KEY]) == 0
            assert cli.main(["app", "new", "opwave", "--access-key", OP_WAVE_KEY]) == 0
            t0 = time.perf_counter()
            assert cli.main(["import", "--app", "ml100k", "--input",
                             str(tmp / "ratings.jsonl")]) == 0
            out["import_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            assert cli.main(["train", "--engine-json", str(tmp / "op100k.json"),
                             "--device", device]) == 0
            out["train_s"] = time.perf_counter() - t0
        train_launches = read_launches()
        op100k = printed.getvalue().split("Engine instance: ")[1].split()[0]
        instances = storage.engine_instances()
        latest = max(instances.get_all(), key=lambda x: x.start_time)
        assert latest.id == op100k and latest.engine_id == "op100k", latest
        assert instances.get_latest_completed("default", "default", "default") is None
        assert [x.id for x in instances.get_completed("op", "2", "tls")] == [instance_id]
        fb_app = storage.apps().get_by_name("opfb").id
        wave_app = storage.apps().get_by_name("opwave").id

        # (c) the CLI deploy: by coordinates, feedback, the plugin
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        argv = ["deploy", "--engine-json", str(op_json), "--ip", "127.0.0.1",
                "--port", str(port), "--feedback", "--accesskey", OP_KEY,
                "--device", device]
        t0 = time.perf_counter()
        first, _ = spawn_cli(home, argv, 1, env=plugin_env)
        procs.append(first)
        out["cli_deploy_s"] = time.perf_counter() - t0
        solo = [post_json(port, "/queries.json", {"user": f"u{u}", "num": 10})
                for u in solo_users]
        assert all(st == 200 for st, _ in solo), solo[:2]
        bodies = [b for _, b in solo]
        hold_answers([b["itemScores"] for b in bodies], solo_users, U, V, 10)
        status_url = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/status.json"), timeout=30).read())
        assert status_url["engineInstanceId"] == instance_id, status_url
        fed = held_feedback(predict_events(storage, fb_app), bodies, solo_users)
        url = f"http://127.0.0.1:{port}"
        probes = dict(zip(("status_url", "metrics_url"), cli_once(home, [
            ["status", "--url", url, "--access-key", OP_KEY],
            ["metrics", "--url", url, "--access-key", OP_KEY],
        ])))
        assert probes["status_url"][0] == 0, probes["status_url"]
        assert json.loads(probes["status_url"][1])["healthz"]["status"] == "alive"
        pio_series = sorted({line.split("{")[0].split(" ")[0]
                             for line in probes["metrics_url"][1].splitlines()
                             if line.startswith("pio_")})
        assert probes["metrics_url"][0] == 0 and pio_series, probes["metrics_url"][2]
        # a second deploy on the port stops the first
        t0 = time.perf_counter()
        second, _ = spawn_cli(home, argv, 1, env=plugin_env)
        procs.append(second)
        out["redeploy_s"] = time.perf_counter() - t0
        first_rc = first.wait(timeout=60)
        again = post_json(port, "/queries.json", {"user": f"u{solo_users[0]}", "num": 10})
        assert first_rc == 0, cli_stderr(first)
        assert again == solo[0], (again, solo[0])
        (undeploy,) = cli_once(home, [["undeploy", "--port", str(port),
                                        "--accesskey", OP_KEY]])
        second_rc = second.wait(timeout=60)
        assert undeploy[0] == 0 and second_rc == 0, (undeploy, cli_stderr(second))
        with socket.socket() as s:
            assert s.connect_ex(("127.0.0.1", port)) != 0, "the port still answers"
        out["cli_deploy"] = {
            "bound": instance_id == status_url["engineInstanceId"],
            "latest_completed_was": "op100k", "solo_answers_held": len(bodies),
            "feedback_events": fed, "status_url_exit": probes["status_url"][0],
            "pio_series": len(pio_series), "stale_server_exit": first_rc,
            "undeploy_exit": undeploy[0], "second_server_exit": second_rc,
        }

        # (d) the TLS deploy: one device wave through feedback and the plugin
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048",
             "-keyout", str(tmp / "key.pem"), "-out", str(tmp / "cert.pem"),
             "-days", "1", "-nodes", "-subj", "/CN=localhost"],
            check=True, capture_output=True, timeout=60)
        tls_env = {"PIO_SSL_CERTFILE": str(tmp / "cert.pem"),
                   "PIO_SSL_KEYFILE": str(tmp / "key.pem")}
        sys.path.insert(0, str(tmp))
        with scoped_env(PIO_PLUGINS="op_plugin:mark"):
            plugins = PluginContext.from_env()
        assert plugins.descriptions() == {"outputblocker": {"mark": {"class": "Mark"}}}

        def serve(tls: bool, feedback_key: str | None):
            with scoped_env(**(tls_env if tls else {})):
                server = create_prediction_server(
                    "", host="127.0.0.1", port=0, storage=storage,
                    engine_id="op", engine_version="2", engine_variant="tls",
                    feedback=FeedbackConfig(enabled=feedback_key is not None,
                                            access_key=feedback_key),
                    plugins=plugins, max_batch=OP_WAVE, max_queue=4 * OP_WAVE,
                    device=device).start_background()
            servers.append(server)
            assert server.app.microbatcher is not None
            return server

        tls_fb = serve(True, OP_WAVE_KEY)
        payloads = [{"user": f"u{u}", "num": 10} for u in wave_users]
        before = read_launches()["fused_topk"]
        t0 = time.perf_counter()
        wave = queued_burst(tls_fb.app.microbatcher, payloads, [{} for _ in payloads])
        wave_fb_s = time.perf_counter() - t0
        wave_launches = read_launches()["fused_topk"] - before
        assert all(r[0] == "ok" and r[2] == instance_id for r in wave), {
            (r[0], r[2]) for r in wave}
        hold_answers([r[1]["itemScores"] for r in wave], wave_users, U, V, 10)
        wave_fed = held_feedback(predict_events(storage, wave_app),
                                 [r[1] for r in wave], wave_users)
        assert not on_card or wave_launches == 1, wave_launches

        # (e) the batch job by coordinates
        (tmp / "q.jsonl").write_text("".join(
            json.dumps({"user": f"u{u}", "num": 10}) + "\n" for u in batch_users))
        before = read_launches()["fused_topk"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            assert cli.main(["batchpredict", "--engine-json", str(op_json),
                             "--input", str(tmp / "q.jsonl"),
                             "--output", str(tmp / "p.jsonl"),
                             "--device", device]) == 0
        batch_s = time.perf_counter() - t0
        batch_launches = read_launches()["fused_topk"] - before
        lines = [json.loads(x) for x in (tmp / "p.jsonl").read_text().splitlines()]
        assert [x["query"]["user"] for x in lines] == [f"u{u}" for u in batch_users]
        batch_held = hold_answers([x["prediction"]["itemScores"] for x in lines],
                                  batch_users, U, V, 10)
        assert not on_card or batch_launches == 1, batch_launches
        launches = read_launches()
        # -- end --
        if on_card:
            assert train_launches == {"fused_topk": 0, "als_fused_accum": 2 * ITERATIONS,
                                      "als_segment_accum": 0}, train_launches
            assert launches == {"fused_topk": 2, "als_fused_accum": 2 * ITERATIONS,
                                "als_segment_accum": 0}, launches

        # outside the counts: the wave with feedback off, then the clients
        tls, plain = serve(True, None), serve(False, None)
        before = read_launches()["fused_topk"]
        t0 = time.perf_counter()
        wave_off = queued_burst(tls.app.microbatcher, payloads, [{} for _ in payloads])
        wave_off_s = time.perf_counter() - t0
        off_launches = read_launches()["fused_topk"] - before
        assert [r[1] for r in wave_off] == [r[1] for r in wave], "feedback changed answers"
        assert len(predict_events(storage, wave_app)) == OP_WAVE
        with contextlib.redirect_stdout(printed):
            assert cli.main(["app", "new", "opprobe"]) == 0
        store_probe = store_commit_probe(
            storage, storage.apps().get_by_name("opprobe").id)
        client_ctx = ssl.create_default_context()
        client_ctx.check_hostname = False
        client_ctx.verify_mode = ssl.CERT_NONE
        client_bodies = [json.dumps({"user": f"u{u}", "num": 10}).encode()
                         for u in client_users]
        clients = {}
        for name, server, ctx in (("https", tls, client_ctx), ("http", plain, None)):
            results, wall = drive_clients(server.port, client_bodies, OP_CLIENTS, tls=ctx)
            clients[name] = client_stats(results, wall)
            assert clients[name]["non_200"] == 0, clients[name]
            hold_answers([json.loads(r[3])["itemScores"] for r in results],
                         client_users, U, V, 10)
        assert not answers_plain_http(tls.port), "the TLS deploy answered plain HTTP"
        out.update(
            bound_instance=instance_id,
            train_launches=train_launches,
            tls_wave={
                "queries": OP_WAVE, "fused_topk": wave_launches,
                "feedback_on_s": wave_fb_s, "feedback_off_s": wave_off_s,
                "feedback_cost_s": wave_fb_s - wave_off_s,
                "feedback_events": wave_fed, "marked_answers": OP_WAVE,
                "feedback_off_fused_topk": off_launches,
                "store": store_probe,
            },
            batchpredict={"queries": WAVE, "fused_topk": batch_launches,
                          "seconds": batch_s, "lines_held": batch_held},
            clients={**clients, "clients": OP_CLIENTS,
                     "tls_qps_share": clients["https"]["queries_per_s"]
                     / clients["http"]["queries_per_s"]},
            launches=launches,
        )
    finally:
        for server in servers:
            server.shutdown()
        for proc in procs:
            stop_cli(proc)
        if str(tmp) in sys.path:
            sys.path.remove(str(tmp))
        storage.close()
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line() if on_card else None
    return out


#: the lifecycle phase: waves of 2,048 (two per 4,096-query burst), the
#: canary at half the traffic, 8 keep-alive clients, queries and feedback
#: for the promote, canary queries for the rollback, the tenant burst
LC_WAVE, LC_BURST, LC_FRACTION, LC_CLIENTS = 2048, 4096, 0.5, 8
LC_FEEDBACK, LC_CANARY_ERRORS, LC_SMALL_USERS, LC_QUOTA_QUERIES = 200, 80, 600, 200
LC_REPLAYED = 8


def burst_items(batcher, items: list, metas: list) -> list:
    """Every ``QueuedQuery`` of ``items`` submitted at once, all queued
    before the batcher's worker forms a wave; the results in order."""
    import asyncio

    async def burst():
        with batcher._cond:
            futs = [asyncio.ensure_future(batcher.submit(it, m))
                    for it, m in zip(items, metas)]
            await asyncio.sleep(0)
            assert len(batcher._pending) == len(futs), len(batcher._pending)
        return await asyncio.gather(*futs)

    return asyncio.run(burst())


def partitions_of(items: list) -> list:
    """Each distinct partition record the wave left on its queries."""
    seen: dict = {}
    for it in items:
        seen.setdefault(id(it.partition), it.partition)
    return [dict(p) for p in seen.values()]


def get_json(port: int, path: str, headers: dict | None = None):
    """(status, JSON body) of one GET."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


#: the clients of ``client_process``: keep-alive threads that query users
#: in turn until the stop file appears, then print one JSON line
CLIENT_PROCESS = """\
import http.client, json, os, sys, threading, time
port, clients, stop = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
users = json.loads(sys.argv[4])
lock = threading.Lock()
statuses, instances = {}, {}
def client(k):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    n = 0
    while not os.path.exists(stop):
        u = users[(k * 257 + n) % len(users)]
        n += 1
        conn.request("POST", "/queries.json", body=json.dumps({"user": u, "num": 10}))
        resp = conn.getresponse()
        resp.read()
        with lock:
            statuses[resp.status] = statuses.get(resp.status, 0) + 1
            iid = resp.getheader("X-Pio-Engine-Instance")
            instances[iid] = instances.get(iid, 0) + 1
    conn.close()
threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"statuses": statuses, "instances": instances}))
"""


@contextlib.contextmanager
def client_process(port: int, users: list, clients: int, tmp: Path):
    """``clients`` keep-alive clients in a process of their own (so they do
    not share the server's interpreter), querying ``users`` in turn while
    the block runs; the dict it yields gets their status and instance
    counts when the block ends."""
    stop = tmp / f"stop-{port}"
    proc = subprocess.Popen(
        [sys.executable, "-c", CLIENT_PROCESS, str(port), str(clients), str(stop),
         json.dumps(list(users))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result: dict = {}
    try:
        yield result
    finally:
        stop.touch()
        try:
            stdout, stderr = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate(timeout=30)
    assert proc.returncode == 0, stderr[-2000:]
    result.update(json.loads(stdout.strip().splitlines()[-1]))


def cuda_census(top: int = 8) -> list:
    """The largest live CUDA tensors the garbage collector can see: shape,
    dtype, bytes and the types of what refers to each."""
    import gc

    from predictionio_tpu_torch.ops import als

    cached = set()
    for staged in als._STAGE_CACHE.values():
        for s in staged:
            for v in s.values():
                for t in (v if isinstance(v, tuple) else (v,)):
                    if isinstance(t, torch.Tensor):
                        cached.add(id(t))
    import warnings

    rows = []
    with warnings.catch_warnings():
        # isinstance on some of torch's deprecated module objects warns
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor) and o.is_cuda]
    for obj in tensors:
        rows.append((obj.element_size() * obj.nelement(), tuple(obj.shape),
                     str(obj.dtype), id(obj) in cached))
    rows.sort(key=lambda r: -r[0])
    return [{"bytes": b, "shape": sh, "dtype": dt, "in_stage_cache": c}
            for b, sh, dt, c in rows[:top]] + [
        {"tensors": len(rows), "bytes": sum(r[0] for r in rows),
         "stage_cache_bytes": sum(r[0] for r in rows if r[3])}]


def lifecycle_phase(device="cuda") -> dict:
    """``lifecycle``: the canary, the lifecycle controller, online quality,
    replay and two tenants on one deploy, on ``write_model``'s seeded
    ML-20M models (rank 10) and an ML-100K store, all on the card.

    (a) Model A deployed (``max_batch`` 2,048), model B staged as the
    canary at 0.5: 4,096 queries queued at once, their users picked by the
    split so that each side holds 2,048, form two waves of two partitions,
    each partition one kernel-3 launch against its own generation; every
    answer held to the host answer of the factors its side names, and
    solo HTTP answers named by ``X-Pio-Variant``.  (b) Feedback POSTed to
    the event server beside the deploy (one quality monitor, as ``deploy
    --event-port`` shares it), echoing ``X-Pio-Request-Id``, joins per
    variant; the controller's tick promotes B under 8 clients (the
    manifest flips, the next answers are B's); C staged with a
    ``canary.predict`` fault answers 500 until the error guardrail rolls it
    back under 8 clients on the live side, whose answers stay B's.  (e)
    ``replay-request`` (a CLI process) of a solo answer: ``MATCHED``, exit
    0; after a flipped stored byte, ``generation.bytes``, exit 1; kernel-3
    answers of (a) replayed by the default tolerance and by 1e-5.  (c) The
    ML-100K model deployed with the controller on (``PIO_LIFECYCLE_*``
    staleness 2 s): its warm-start retrain runs on the controller's thread
    (kernel 1, 40 launches) while 8 clients query, is staged, promoted,
    and no answer is non-200.  (d) Tenants ``big`` (A) and ``small`` (the
    ML-100K model, a quota) on one deploy, a third (C) deployed and refused
    by the stored-bytes budget while ``big``'s clients query; one queued
    wave of both tenants, a kernel-3 launch per tenant partition, each
    answer held to its tenant's factors; the quota's sheds.  The launch
    counts cover (a) to (e); the ML-100K import and first train are set-up.
    """
    import gc
    import random

    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.lifecycle import (
        CanaryPolicy,
        LifecycleController,
        LifecyclePolicy,
        in_canary_fraction,
    )
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.obs.provenance import replay_request
    from predictionio_tpu_torch.obs.quality import QualityMonitor
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.event_server import create_event_server_app
    from predictionio_tpu_torch.server.httpd import AppServer
    from predictionio_tpu_torch.server.prediction_server import (
        QueuedQuery,
        create_multi_tenant_server_app,
        create_prediction_server,
        create_prediction_server_app,
        deploy_engine,
        deploy_tenant_engines,
    )
    from predictionio_tpu_torch.tenancy import Tenant, TenantAdmissionError, hbm_footprint
    from predictionio_tpu_torch.tools import commands as cmd

    on_card = torch.device(device).type == "cuda"

    def allocated() -> int:
        gc.collect()
        if not on_card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    factor_bytes = (ML20M_USERS + ML20M_ITEMS) * RANK * 4
    out: dict = {"phase": "lifecycle", "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "small_shape": [ML100K_USERS, ML100K_ITEMS, CUT_ML100K_EVENTS],
                 "reduced": {"ml100k_events": [ML100K_EVENTS, CUT_ML100K_EVENTS]},
                 "factor_bytes": factor_bytes, "wave": LC_WAVE,
                 "fraction": LC_FRACTION}
    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    home = tmp / "pio_home"
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(home)}))
    servers: list = []
    mem: dict = {"start": allocated()}
    try:
        # -- set-up: A, B and C at the ML-20M shape; the ML-100K store and
        # its first train (rank 10, 20 iterations) under engine "ml100k"
        t0 = time.perf_counter()
        gens = {}
        for name, salt in (("A", 60), ("B", 61), ("C", 62)):
            time.sleep(0.01)
            gens[name] = write_model(storage, home, seed=SEED + salt)
        ids = {name: g[0] for name, g in gens.items()}
        key = cmd.app_new(storage, "ml100k").keys[0].key
        small_u, _, _ = write_ml100k(tmp / "ratings.jsonl", CUT_ML100K_EVENTS)
        cmd.import_events(storage, "ml100k", tmp / "ratings.jsonl")
        engine = resolve_engine_factory("recommendation")()
        params = engine.params_from_json({
            "datasource": {"params": {"appName": "ml100k"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS, "lambda": 0.01,
                "seed": 3}}],
        })
        small0 = run_train(
            engine, params, ctx=EngineContext(storage=storage, device=device),
            engine_id="ml100k", engine_factory="recommendation", storage=storage)
        out["setup_s"] = time.perf_counter() - t0
        split = np.array([in_canary_fraction(f"u{u}", LC_FRACTION)
                          for u in range(ML20M_USERS)])
        live_users = np.flatnonzero(~split)
        canary_users = np.flatnonzero(split)
        rng = np.random.default_rng(SEED + 63)

        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        # (a) the canary on the card
        reg = MetricsRegistry()
        monitor = QualityMonitor(registry=reg)
        deployed = deploy_engine("recommendation", storage=storage,
                                 engine_instance_id=ids["A"], device=device)
        store = deployed.generation_store
        policy = LifecyclePolicy(canary=CanaryPolicy(
            fraction=LC_FRACTION, min_requests=50, min_joined=20))
        controller = LifecycleController(deployed, store, quality=monitor,
                                         policy=policy, registry=reg)
        app = create_prediction_server_app(
            deployed, use_microbatch=True, max_batch=LC_WAVE, max_queue=0,
            registry=reg, quality=monitor, lifecycle=controller,
            lifecycle_autostart=False)
        server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
        servers.append(server)
        events = AppServer(create_event_server_app(storage, registry=reg,
                                                   quality=monitor),
                           "127.0.0.1", 0).start_background()
        servers.append(events)
        mem["a_bound"] = allocated()

        def stage(name: str) -> None:
            """What the controller's retrain does with its result: record,
            verify, bind as the canary, open the canary's books."""
            inst = storage.engine_instances().get(ids[name])
            store.verify(store.record(inst.id, status="staged"))
            deployed.stage_canary(inst, LC_FRACTION)
            store.start_canary(inst.id)
            controller.tracker.start()

        stage("B")
        mem["a_live_b_canary"] = allocated()
        users = np.concatenate([rng.choice(live_users, LC_BURST // 2),
                                rng.choice(canary_users, LC_BURST // 2)])
        rng.shuffle(users)
        items = [QueuedQuery({"user": f"u{u}", "num": 10}) for u in users]
        before = read_launches()["fused_topk"]
        t0 = time.perf_counter()
        results = burst_items(app.microbatcher, items, [{} for _ in items])
        burst_s = time.perf_counter() - t0
        held = {}
        for side, name in (("default", "A"), ("canary", "B")):
            rows = [j for j, it in enumerate(items) if it.variant == side]
            assert {results[j][2] for j in rows} == {ids[name]}, side
            assert all(results[j][0] == "ok" for j in rows), side
            _, U, V = gens[name]
            held[side] = hold_answers([results[j][1]["itemScores"] for j in rows],
                                      users[rows], U, V, 10)
            assert all(split[u] == (side == "canary") for u in users[rows])
        parts = partitions_of(items)
        out["canary"] = {
            "queries": len(items), "burst_s": burst_s, "held": held,
            "fused_topk": read_launches()["fused_topk"] - before,
            "partitions": [{k: p[k] for k in ("variant", "size", "on_device",
                                              "split_s", "dispatch_s", "finalize_s")}
                           for p in parts],
        }
        assert len(parts) == 4 and all(p["on_device"] for p in parts), parts
        assert all(p["size"] >= 512 for p in parts), parts
        assert not on_card or out["canary"]["fused_topk"] == 4, out["canary"]
        variant_hdr = {}
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        try:
            for u in list(rng.choice(live_users, 16)) + list(rng.choice(canary_users, 16)):
                conn.request("POST", "/queries.json",
                             body=json.dumps({"user": f"u{u}", "num": 10}))
                resp = conn.getresponse()
                body = json.loads(resp.read())
                side = resp.getheader("X-Pio-Variant")
                assert resp.status == 200 and side == (
                    "canary" if split[u] else "default"), (u, side)
                _, U, V = gens["B" if split[u] else "A"]
                hold_answers([body["itemScores"]], [u], U, V, 10)
                variant_hdr[side] = variant_hdr.get(side, 0) + 1
        finally:
            conn.close()
        out["canary"]["http_variants"] = variant_hdr

        # (b) feedback joined per variant, the promote, then C's rollback
        fb_status: dict = {}
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        econn = http.client.HTTPConnection("127.0.0.1", events.port, timeout=60)
        try:
            for u in rng.choice(ML20M_USERS, LC_FEEDBACK):
                conn.request("POST", "/queries.json",
                             body=json.dumps({"user": f"u{u}", "num": 10}))
                resp = conn.getresponse()
                body = json.loads(resp.read())
                assert resp.status == 200
                rid = resp.getheader("X-Pio-Request-Id")
                econn.request(
                    "POST", f"/events.json?accessKey={key}",
                    body=json.dumps({
                        "event": "buy", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item",
                        "targetEntityId": body["itemScores"][0]["item"]}),
                    headers={"X-Pio-Request-Id": rid})
                eresp = econn.getresponse()
                eresp.read()
                fb_status[eresp.status] = fb_status.get(eresp.status, 0) + 1
        finally:
            conn.close()
            econn.close()
        quality_before = get_json(server.port, "/quality.json")[1]
        joined = {v: d["joined"] for v, d in quality_before["variants"].items()}
        assert fb_status == {201: LC_FEEDBACK}, fb_status
        assert min(joined.get("default", 0), joined.get("canary", 0)) >= 20, joined
        both = np.concatenate([live_users[:4096], canary_users[:4096]])
        t0 = time.perf_counter()
        verdict, promote_s, records, done = clients_around(
            server.port, both, LC_CLIENTS, controller.tick)
        assert verdict == "promote", (verdict, controller.last_event)
        statuses = sorted({r[1] for r in records})
        after = [r for r in records if r[0] > done]
        assert statuses == [200], statuses
        assert {r[2] for r in after} == {ids["B"]}, "A answered after the promote"
        _, Ub, Vb = gens["B"]
        hold_answers([json.loads(r[4])["itemScores"] for r in after],
                     [r[3] for r in after], Ub, Vb, 10)
        assert store.live().instance_id == ids["B"] == deployed.instance.id
        mem["b_promoted"] = allocated()
        lc_promoted = get_json(server.port, "/lifecycle.json")[1]
        out["promote"] = {
            "verdict": verdict, "tick_s": promote_s, "answers": len(records),
            "after": len(after), "non_200": sum(r[1] != 200 for r in records),
            "feedback_status": fb_status, "joined": joined,
            "reason": controller.last_event.get("reason"),
            "lifecycle": {k: lc_promoted.get(k) for k in
                          ("engineInstanceId", "canary_in_progress")},
        }
        stage("C")
        faults.install([{"seam": "canary.predict", "kind": "error",
                         "match": ids["C"]}])
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            canary_codes: dict = {}
            try:
                for u in rng.choice(canary_users, LC_CANARY_ERRORS):
                    conn.request("POST", "/queries.json",
                                 body=json.dumps({"user": f"u{u}", "num": 10}))
                    resp = conn.getresponse()
                    resp.read()
                    canary_codes[resp.status] = canary_codes.get(resp.status, 0) + 1
            finally:
                conn.close()
            assert canary_codes == {500: LC_CANARY_ERRORS}, canary_codes
            verdict, rollback_s, records, done = clients_around(
                server.port, live_users[:4096], LC_CLIENTS, controller.tick)
        finally:
            faults.clear()
        assert verdict == "rollback", (verdict, controller.last_event)
        assert sorted({r[1] for r in records}) == [200]
        assert {r[2] for r in records} == {ids["B"]}, "live answers changed"
        hold_answers([json.loads(r[4])["itemScores"] for r in records[:512]],
                     [r[3] for r in records[:512]], Ub, Vb, 10)
        assert store.get(ids["C"]).status == "rolled_back"
        assert deployed.canary_instance is None
        mem["c_rolled_back"] = allocated()
        out["rollback"] = {
            "verdict": verdict, "tick_s": rollback_s, "canary_status": canary_codes,
            "live_answers": len(records), "non_200": sum(r[1] != 200 for r in records),
            "reason": controller.last_event.get("reason"),
            "rollbacks_total": controller._m_rollbacks.labels("error_rate").value,
        }
        out["quality"] = get_json(server.port, "/quality.json")[1]["variants"]
        manifest = get_json(server.port, "/lifecycle.json")[1]["manifest"]
        name_of = {v: k for k, v in ids.items()}
        out["manifest"] = [(name_of.get(g["instance_id"], g["instance_id"]), g["status"])
                           for g in manifest["generations"]]

        # (e) replay: kernel-3 answers of (a) in this process, by the default
        # tolerance and by 1e-5; a solo answer through the CLI, then again
        # after a flipped byte
        kernel3: dict = {"exact_matched": 0, "tolerance_matched": 0, "replayed": 0,
                         "max_score_diff": 0.0}
        for j in range(0, len(items), len(items) // LC_REPLAYED):
            it = items[j]
            record = {**it.prov, "payload": it.payload, "request_id": f"burst-{j}",
                      "items": [{"item": x["item"], "score": x["score"]}
                                for x in results[j][1]["itemScores"]]}
            exact = replay_request(record, storage=storage, device=device)
            loose = replay_request(record, storage=storage, device=device,
                                   score_tolerance=1e-5)
            kernel3["replayed"] += 1
            kernel3["exact_matched"] += exact["matched"]
            kernel3["tolerance_matched"] += loose["matched"]
            for d in exact["divergences"]:
                assert d["field"].endswith(".score"), d
                kernel3["max_score_diff"] = max(
                    kernel3["max_score_diff"], abs(d["recorded"] - d["replayed"]))
            assert loose["matched"], loose["divergences"][:4]
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/queries.json",
            data=json.dumps({"user": f"u{int(live_users[7])}", "num": 10}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            rid = r.headers["X-Pio-Request-Id"]
        url = f"http://127.0.0.1:{server.port}"
        argv = ["replay-request", rid, "--url", url, "--device", device]
        t0 = time.perf_counter()
        ((rc_solo, so, se),) = cli_once(home, [argv])
        replay_s = time.perf_counter() - t0
        assert rc_solo == 0 and "MATCHED" in so, (rc_solo, so, se[-2000:])
        flipped = flip_stored_byte(storage.models(), ids["B"]).split(":", 1)[1]
        ((rc_flip, so, se),) = cli_once(home, [argv])
        assert rc_flip == 1 and "generation.bytes" in se, (rc_flip, so, se[-2000:])
        out["replay"] = {"solo_exit": rc_solo, "flipped_exit": rc_flip,
                         "flipped": flipped, "cli_s": replay_s, "kernel3": kernel3}
        for s in servers:
            s.shutdown()
        servers.clear()
        deployed = app = controller = server = events = None
        mem["ab_down"] = allocated()

        # (c) the warm-start retrain beside serving
        lc_env = {"PIO_LIFECYCLE_STALENESS_S": "2", "PIO_LIFECYCLE_INTERVAL_S": "0.5",
                  "PIO_LIFECYCLE_COOLDOWN_S": "3600", "PIO_CANARY_FRACTION": "0.5",
                  "PIO_CANARY_MIN_REQUESTS": "50", "PIO_CANARY_MIN_JOINED": "0",
                  "PIO_LIFECYCLE_RETRAIN_ON_DRIFT": "0"}
        before = read_launches()
        with scoped_env(**lc_env):
            server = create_prediction_server(
                "recommendation", host="127.0.0.1", port=0, storage=storage,
                engine_id="ml100k", device=device, enable_lifecycle=True)
        servers.append(server)
        server.start_background()
        controller = server.app.lifecycle
        small_users = np.unique(small_u)
        stages = _Stages()
        wf_log = logging.getLogger("predictionio_tpu_torch.workflow")
        wf_log.setLevel(logging.INFO)
        wf_log.addHandler(stages)
        t0 = time.perf_counter()
        seen: dict = {}

        def promoted():
            # each controller event's first sighting, 10 ms apart at most
            while True:
                last = controller.last_event or {}
                seen.setdefault(last.get("event"), time.perf_counter() - t0)
                if last.get("event") in ("promote", "rollback", "retrain_failed"):
                    return last
                assert time.perf_counter() - t0 < 240, last
                time.sleep(0.01)

        try:
            with client_process(server.port, [f"u{u}" for u in small_users],
                                LC_CLIENTS, tmp) as clients:
                last = promoted()
                retrain_s = time.perf_counter() - t0
                # the clients go on past the promote: answers from the new
                # generation after the flip
                time.sleep(1.0)
        finally:
            wf_log.removeHandler(stages)
        assert last["event"] == "promote", last
        launches = read_launches()
        small = storage.engine_instances().get(last["instance"])
        assert server.app.lifecycle.deployed.instance.id == small.id
        answers = sum(clients["statuses"].values())
        out["retrain"] = {
            "seconds_to_promote": retrain_s, "answers": answers,
            "non_200": answers - clients["statuses"].get("200", 0),
            "answered_by": {("new" if k == small.id else "old"): v
                            for k, v in clients["instances"].items()},
            "als_fused_accum": launches["als_fused_accum"] - before["als_fused_accum"],
            "fused_topk": launches["fused_topk"] - before["fused_topk"],
            "warm_start_from": small0.id, "promoted": small.id,
            "reason": last.get("reason"),
            # seconds from the deploy's start to each event's first sighting
            "events_s": {k: v for k, v in seen.items() if k},
            # the retrain's own stage split (run_train's logged breakdown)
            "retrain_stage_s": stages.stages,
            "answers_per_s": answers / (retrain_s + 1.0),
        }
        assert out["retrain"]["non_200"] == 0, out["retrain"]
        assert not on_card or out["retrain"]["als_fused_accum"] == 2 * ITERATIONS, out
        server.shutdown()
        servers.clear()
        server = controller = None
        mem["retrain_down"] = allocated()
        out["retrain"]["live_cuda_tensors"] = cuda_census() if on_card else None

        # (d) two tenants on one deploy, a third refused
        blob = load_factors(storage, small.id)
        Us, Vs = blob["user_factors"], blob["item_factors"]
        small_vocab = [str(x) for x in blob["user_vocab"]]
        small_items = [str(x) for x in blob["item_vocab"]]
        sizes = {n: hbm_footprint(storage.models(), i)
                 for n, i in (("big", ids["A"]), ("small", small.id),
                              ("third", ids["C"]))}
        budget = sizes["big"] + sizes["small"] + sizes["third"] // 2
        treg = MetricsRegistry()
        tenants = deploy_tenant_engines(
            [{"app": "big", "engine_factory": "recommendation",
              "engine_instance_id": ids["A"]},
             {"app": "small", "engine_factory": "recommendation",
              "engine_id": "ml100k", "engine_instance_id": small.id,
              "quota_rps": 50, "quota_burst": 50}],
            storage=storage, hbm_budget_bytes=budget, registry=treg, device=device)
        tapp = create_multi_tenant_server_app(
            tenants, use_microbatch=True, max_batch=LC_WAVE, max_queue=0,
            registry=treg)
        server = AsyncAppServer(tapp, "127.0.0.1", 0).start_background()
        servers.append(server)
        mem["tenants_bound"] = allocated()
        third = deploy_engine("recommendation", storage=storage,
                              engine_instance_id=ids["C"], device=device)
        mem["third_loaded"] = allocated()

        def refuse():
            try:
                tenants.admit(Tenant("third", third))
            except TenantAdmissionError as e:
                return e.to_dict()
            raise AssertionError("the third tenant was admitted")

        refusal, refuse_s, records, _ = clients_around(
            server.port, rng.choice(ML20M_USERS, 4096), LC_CLIENTS, refuse)
        third = None
        mem["third_refused"] = allocated()
        assert sorted({r[1] for r in records}) == [200]
        assert tenants.apps() == ["big", "small"]
        _, Ua, Va = gens["A"]
        hold_answers([json.loads(r[4])["itemScores"] for r in records[:512]],
                     [r[3] for r in records[:512]], Ua, Va, 10)
        assert mem["third_refused"] - mem["tenants_bound"] < factor_bytes // 4, mem
        big_users = rng.choice(ML20M_USERS, 1024)
        small_rows = rng.choice(len(small_vocab), LC_SMALL_USERS, replace=False)
        mixed = ([QueuedQuery({"user": f"u{u}", "num": 10}, tenants.get("big"))
                  for u in big_users]
                 + [QueuedQuery({"user": small_vocab[r], "num": 10}, tenants.get("small"))
                    for r in small_rows])
        order = list(range(len(mixed)))
        random.Random(SEED).shuffle(order)
        mixed = [mixed[j] for j in order]
        before = read_launches()["fused_topk"]
        t0 = time.perf_counter()
        mres = burst_items(tapp.microbatcher, mixed, [{} for _ in mixed])
        mixed_s = time.perf_counter() - t0
        assert all(r[0] == "ok" for r in mres)
        big_rows = [j for j, it in enumerate(mixed) if it.tenant.name == "big"]
        sm_rows = [j for j, it in enumerate(mixed) if it.tenant.name == "small"]
        hold_answers([mres[j][1]["itemScores"] for j in big_rows],
                     [int(mixed[j].payload["user"][1:]) for j in big_rows], Ua, Va, 10)
        row_of = {name: k for k, name in enumerate(small_vocab)}
        hold_answers([mres[j][1]["itemScores"] for j in sm_rows],
                     [row_of[mixed[j].payload["user"]] for j in sm_rows], Us, Vs, 10,
                     item_name=small_items.__getitem__)
        tparts = partitions_of(mixed)
        sheds = 0
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        try:
            for k in range(LC_QUOTA_QUERIES):
                conn.request("POST", "/queries.json",
                             body=json.dumps({"user": small_vocab[k % len(small_vocab)],
                                              "num": 10}),
                             headers={"X-Pio-App": "small"})
                resp = conn.getresponse()
                resp.read()
                if resp.status == 503:
                    assert resp.getheader("X-Pio-Shed-Reason") == "tenant_quota"
                    sheds += 1
                else:
                    assert resp.status == 200 and resp.getheader("X-Pio-App") == "small"
        finally:
            conn.close()
        tj = get_json(server.port, "/tenants.json")[1]
        out["tenants"] = {
            "budget_bytes": budget, "stored_bytes": sizes, "refusal": refusal,
            "refuse_s": refuse_s, "answers_around_refusal": len(records),
            "mixed_queries": len(mixed), "mixed_s": mixed_s,
            "fused_topk": read_launches()["fused_topk"] - before,
            "partitions": [{k: p[k] for k in ("app", "size", "on_device",
                                              "split_s", "dispatch_s", "finalize_s")}
                           for p in tparts],
            "quota_queries": LC_QUOTA_QUERIES, "quota_sheds": sheds,
            "quota_denied": [t["quota"]["denied"] for t in tj["tenants"]
                             if t["app"] == "small"][0],
            "device_memory": tj.get("device_memory"),
        }
        assert len(tparts) == 2 and all(p["on_device"] for p in tparts), tparts
        assert not on_card or out["tenants"]["fused_topk"] == 2, out["tenants"]
        assert sheds > 0 and out["tenants"]["quota_denied"] == sheds, out["tenants"]
        out["launches"] = read_launches()
        # -- end --
        server.shutdown()
        servers.clear()
        tenants = tapp = server = None
        mem["end"] = allocated()
        out["device_memory"] = mem
    finally:
        faults.clear()
        for s in servers:
            s.shutdown()
        storage.close()
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line() if on_card else None
    return out


# -- the storage plane ---------------------------------------------------------

#: the storage phase writes the first STORE_RATINGS of the ML-20M ratings
#: (cut from 20,000,263 to keep the script near 950 s) to the daemon in
#: frames of about a million rows, from this many writer threads
STORE_RATINGS = 15_000_000
STORE_FRAME_ROWS = 1 << 20
STORE_WRITERS = 2
#: the phase's expected seconds at the full ML-20M stream (stated before
#: its first run on the card; PERF.md has the prediction)
STORE_EXPECTED_S = 240
#: the remote source's knobs: a socket timeout sized to a 20M-row scan,
#: one retry, and a breaker that opens after 2 failures and half-opens 2 s
#: later
STORE_KNOBS = {"TIMEOUT": "900", "RETRIES": "2", "BREAKER_THRESHOLD": "2",
               "BREAKER_RESET_S": "2"}


def remote_env(url: str, models: dict | None = None) -> dict:
    """Every repository on the storage daemon at ``url`` (MODELDATA on
    ``models`` when given)."""
    env = {"PIO_STORAGE_SOURCES_R_TYPE": "remote",
           "PIO_STORAGE_SOURCES_R_URL": url,
           **{f"PIO_STORAGE_SOURCES_R_{k}": v for k, v in STORE_KNOBS.items()},
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "R",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "R",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "R"}
    if models:
        env.update({f"PIO_STORAGE_SOURCES_M_{k}": v for k, v in models.items()})
        env["PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE"] = "M"
    return env


def rating_frames(u, i, r, rows: int):
    """The ratings as ``rate`` event frames of ``rows`` rows: id-less bulk
    rows, columns built as vocabulary[codes] (one object per user, item and
    rating document), event times a millisecond apart."""
    from predictionio_tpu_torch.data.storage.base import EventFrame

    users = np.array([f"u{k}" for k in range(int(u.max()) + 1)], object)
    items = np.array([f"i{k}" for k in range(int(i.max()) + 1)], object)
    docs = np.array([json.dumps({"rating": k / 2}) for k in range(11)], object)
    const = {v: np.array([v], object) for v in ("rate", "user", "item")}
    for lo in range(0, len(u), rows):
        n = min(rows, len(u) - lo)
        zeros = np.zeros(n, np.int64)
        yield EventFrame(
            event=const["rate"][zeros],
            entity_type=const["user"][zeros],
            entity_id=users[u[lo:lo + n]],
            target_entity_type=const["item"][zeros],
            target_entity_id=items[i[lo:lo + n]],
            event_time_ms=T_BASE_MS + np.arange(lo, lo + n, dtype=np.int64),
            properties=docs[np.rint(r[lo:lo + n] * 2).astype(np.int64)],
        )


class _WireTally:
    """Bytes a ``RemoteClient`` sent and received, request by request."""

    def __init__(self, client):
        self.sent = self.received = self.calls = 0
        self._lock = threading.Lock()
        real = client.request

        def request(method, path, params=None, body=None, *a, **kw):
            status, raw = real(method, path, params, body, *a, **kw)
            with self._lock:
                self.sent += len(body or b"")
                self.received += len(raw)
                self.calls += 1
            return status, raw

        client.request = request


def vocab_init(captured: dict, init_u: np.ndarray, init_v: np.ndarray):
    """A ``train_als`` wrapper's start: the rows of the seeded tables that
    belong to the captured vocabularies' entities (``u<k>``, ``i<k>``), so
    a train over any read order starts each entity where the in-memory
    train starts it."""
    pd = captured["pd"]
    ku = np.fromiter((int(x[1:]) for x in pd.user_vocab.keys_array()), np.int64)
    ki = np.fromiter((int(x[1:]) for x in pd.item_vocab.keys_array()), np.int64)
    return init_u[ku], init_v[ki]


@contextlib.contextmanager
def entity_seeded_train(rec, init_u, init_v, captured: dict):
    """The recommendation engine's train started from ``vocab_init``, its
    prepared data and ALS params captured for the in-memory hold."""
    real_prepare = rec.RatingsPreparator.prepare
    real_train = rec.train_als

    def prepare(self, ctx, td):
        captured["pd"] = real_prepare(self, ctx, td)
        return captured["pd"]

    def train(u, i, r, num_users, num_items, params, **kw):
        kw.pop("init_factors", None)
        captured["params"] = params
        return real_train(u, i, r, num_users=num_users, num_items=num_items,
                          params=params,
                          init_factors=vocab_init(captured, init_u, init_v), **kw)

    rec.RatingsPreparator.prepare = prepare
    rec.train_als = train
    try:
        yield
    finally:
        rec.RatingsPreparator.prepare = real_prepare
        rec.train_als = real_train


def storage_phase(device="cuda", n_events: int = ML20M_RATINGS,
                  n_users: int = ML20M_USERS, n_items: int = ML20M_ITEMS,
                  ratings=None) -> dict:
    """``storage``: the main path with all three repositories on a remote
    storage daemon (``pio storageserver`` as a subprocess, parquet events).

    The ML-20M-shaped ratings (``main`` passes the first STORE_RATINGS of
    ``train_ml20m``'s) go to the daemon as id-less bulk frames of about a
    million rows (``RemotePEvents.write``, two writer threads); ``pio
    eventstore status --url`` shows the hot segments and ``compact --url``
    folds them.  ``pio train`` (rank 10, 20 iterations) reads them back
    through the daemon (40 kernel-1 launches), held to an in-memory
    ``train_als`` of the generated ratings from one start per entity within
    2e-3.  The deploy binds that model through the daemon: a 4,096-query
    queued wave (kernel 3) held to the host answer with num+1 scores, 8
    solo queries, and ``pio batchpredict`` (kernel 3).  Then the daemon is
    SIGKILLed while the deploy serves: a second queued wave answers from
    the bound model, ``/readyz`` turns not ready on ``storage_breakers``,
    ``/slo.json`` shows the breaker open, an event server on the daemon
    answers 503 + ``Retry-After``; restarted on the same root and port,
    the breaker closes, writes succeed and an ML-100K-shaped app reads
    back every event acknowledged before the kill and after the restart.
    ``pio app compact`` folds that app; a second ``pio train`` of it with
    MODELDATA on ``TYPE=hdfs`` over ``file://`` and a deploy from it answer
    one device wave (kernel 3).  ``ratings`` are ``train_ml20m``'s (the
    same generator and seed), generated here when not given."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.event_server import create_event_server_app
    from predictionio_tpu_torch.server.httpd import Request
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server_app,
        deploy_engine,
    )
    from predictionio_tpu_torch.tools import cli

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"phase": "storage", "backend": "parquet",
                 "shape": [n_users, n_items, n_events], "rank": RANK,
                 "iterations": ITERATIONS, "expected_s": STORE_EXPECTED_S,
                 "knobs": STORE_KNOBS}
    if n_events != ML20M_RATINGS:
        out["reduced"] = {"events": [ML20M_RATINGS, n_events]}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    root = tmp / "root"
    root.mkdir()
    daemon = server = storage = None
    stages = _Stages()
    wf_log = logging.getLogger("predictionio_tpu_torch.workflow")
    wf_log.setLevel(logging.INFO)
    wf_log.addHandler(stages)
    printed = io.StringIO()

    def start_daemon(port: int):
        proc, lines = spawn_cli(root, ["storageserver", "--ip", "127.0.0.1",
                                       "--port", str(port), "--root", str(root),
                                       "--events", "parquet", "--no-compact"], 1)
        return proc, bound_port(lines[0])

    try:
        t0 = time.perf_counter()
        if ratings is None:
            ratings = movielens_like(n_events, n_users, n_items, SEED + 20,
                                     half_stars=True)
        u, i, r = ratings
        assert len(r) == n_events, (len(r), n_events)
        out["generate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        daemon, port = start_daemon(0)
        out["daemon_start_s"] = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        env = {"PIO_HOME": str(tmp / "client_home"), **remote_env(url)}
        (tmp / "engine.json").write_text(json.dumps({
            "id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"appName": "ml20m"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS, "lambda": 0.01,
                "seed": 3}}],
        }))
        start = np.random.default_rng(SEED + 140)
        init_u, init_v = (
            (np.abs(start.standard_normal((n, RANK))) / np.sqrt(RANK)).astype(np.float32)
            for n in (n_users, n_items)
        )
        captured: dict = {}
        with scoped_env(**env):
            storage = reset_storage(StorageConfig.from_env())
            pe = storage.p_events()
            with contextlib.redirect_stdout(printed):
                assert cli.main(["app", "new", "ml20m"]) == 0
            app_id = storage.apps().get_by_name("ml20m").id
            tally = _WireTally(pe.client)

            # 1. the ratings to the daemon, frame by frame
            t0 = time.perf_counter()
            with ThreadPoolExecutor(STORE_WRITERS) as pool:
                for f in [pool.submit(pe.write, fr, app_id)
                          for fr in rating_frames(u, i, r, STORE_FRAME_ROWS)]:
                    f.result()
            wall = time.perf_counter() - t0
            out["write"] = {"rows": n_events, "s": wall, "rows_per_s": n_events / wall,
                            "frames": tally.calls, "wire_bytes": tally.sent,
                            "bytes_per_row": tally.sent / n_events,
                            "writers": STORE_WRITERS}

            # 2. the segment layout, and a fold through the daemon
            print(f"storage: wrote {n_events} rows in {wall:.1f} s", flush=True)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["eventstore", "status", "--url", url, "--json"])
            before = json.loads(buf.getvalue())
            # the status verb exits 1 while the backlog is over its budget
            assert rc == (1 if before["over_budget"] else 0), (rc, before["over_budget"])
            (app_st,) = [a for a in before["apps"] if a["app_id"] == app_id]
            assert app_st["segments_hot"] > 0 and app_st["rows_hint"] == n_events, app_st
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["eventstore", "compact", "--url", url, "--json",
                                 "--timeout", "900"]) == 0
            folded = json.loads(buf.getvalue())
            compact_s = time.perf_counter() - t0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["eventstore", "status", "--url", url, "--json"]) == 0
            after = json.loads(buf.getvalue())
            (app_after,) = [a for a in after["apps"] if a["app_id"] == app_id]
            assert folded["rows"] == n_events and app_after["segments_hot"] == 0, (
                folded, app_after)
            assert app_after["rows_hint"] == n_events, app_after
            print(f"storage: folded in {compact_s:.1f} s", flush=True)
            out["compaction"] = {
                "over_budget_before": before["over_budget"],
                "hot_segments_before": app_st["segments_hot"],
                "bytes_before": app_st["bytes"], "s": compact_s,
                "rows": folded["rows"],
                "compacted_segments": app_after["segments_compacted"],
                "bytes_after": app_after["bytes"],
            }

            # 3. pio train over the daemon, kernel 1 counted
            received0 = tally.received
            with entity_seeded_train(rec, init_u, init_v, captured):
                # -- the main path, with every launch count at 0 just before it --
                reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(printed):
                    assert cli.main(["train", "--engine-json", str(tmp / "engine.json"),
                                     "--device", device]) == 0
                out["train_cli_s"] = time.perf_counter() - t0
                train_launches = read_launches()
                # -- end --
            instance_id = printed.getvalue().split("Engine instance: ")[1].split()[0]
            print(f"storage: pio train {out['train_cli_s']:.1f} s", flush=True)
            st = stages.stages
            staging_s = als.LAST_PLAN_INFO["stage_s"]
            out["train"] = {
                "instance": instance_id,
                "read_s": st["datasource.read"],
                "prepare_s": st["preparator.prepare"],
                "staging_s": staging_s,
                "iterations_s": st["algorithm.als"] - staging_s,
                "persist_s": st["persist.save_models"],
                "total_s": st["total"],
                "launches": train_launches,
            }
            out["scan_bytes"] = tally.received - received0
            assert not on_card or train_launches["als_fused_accum"] == 2 * ITERATIONS, (
                train_launches)
            (blob,) = load_models(storage.models(), instance_id)
            U, V = blob["user_factors"], blob["item_factors"]
            assert np.isfinite(U).all() and np.isfinite(V).all()
            ukeys = np.fromiter((int(x[1:]) for x in blob["user_vocab"]), np.int64)
            ikeys = np.fromiter((int(x[1:]) for x in blob["item_vocab"]), np.int64)
            t0 = time.perf_counter()
            mem = als.train_als(u, i, r, n_users, n_items, captured["params"],
                                device=device, init_factors=(init_u, init_v))
            out["in_memory_train_s"] = time.perf_counter() - t0
            gaps = {}
            for side, got, keys, want, ids in (
                    ("user", U, ukeys, mem.user_factors, u),
                    ("item", V, ikeys, mem.item_factors, i)):
                per = np.abs(want.cpu().numpy()[keys] - got).max(axis=1)
                top = int(per.argmax())
                counts = np.bincount(np.asarray(ids), minlength=int(keys.max()) + 1)
                # the entity that sets the gap and how many ratings it has:
                # the gap is a maximum over entities, set by the fewest-rated
                gaps[side] = {"max": float(per[top]), "entity": int(keys[top]),
                              "ratings": int(counts[keys[top]]),
                              "p999": float(np.quantile(per, 0.999)),
                              "median_ratings": float(np.median(counts[keys]))}
            diff = max(g["max"] for g in gaps.values())
            out["train"]["vs_in_memory_gap"] = gaps
            assert diff <= 2e-3, f"factors over the daemon differ by {diff}: {gaps}"
            out["train"]["vs_in_memory_max_abs_diff"] = diff
            out["train"]["users"], out["train"]["items"] = len(ukeys), len(ikeys)
            del mem

            # 4. the deploy through the daemon: a queued wave, solo queries
            reset_launches()
            t0 = time.perf_counter()
            deployed = deploy_engine("recommendation", storage=storage, device=device)
            out["deploy_bind_s"] = time.perf_counter() - t0
            assert deployed.instance.id == instance_id
            app = create_prediction_server_app(
                deployed, use_microbatch=True, max_batch=WAVE, max_queue=4 * WAVE,
                registry=MetricsRegistry())
            server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
            wave_rows = np.random.default_rng(SEED + 141).integers(0, len(ukeys), WAVE)
            wave_users = [f"u{ukeys[x]}" for x in wave_rows]
            item_name = lambda j: f"i{ikeys[j]}"  # noqa: E731

            def device_wave(label: str) -> dict:
                before = read_launches()["fused_topk"]
                t1 = time.perf_counter()
                burst = queued_burst(app.microbatcher,
                                     [{"user": x, "num": 10} for x in wave_users],
                                     [{} for _ in wave_users])
                wave_s = time.perf_counter() - t1
                assert all(b[0] == "ok" for b in burst), {b[0] for b in burst}
                held = hold_answers([b[1]["itemScores"] for b in burst], wave_rows,
                                    U, V, 10, item_name=item_name)
                launched = read_launches()["fused_topk"] - before
                assert not on_card or launched == 1, (label, launched)
                return {"queries": WAVE, "held": held, "s": wave_s,
                        "fused_topk": launched}

            out["wave"] = device_wave("bound")
            solo = []
            for x in wave_rows[:8]:
                status, body, ms = post_query(server.port, {"user": f"u{ukeys[x]}",
                                                            "num": 10})
                assert status == 200
                solo.append(ms)
                hold_answers([body["itemScores"]], [x], U, V, 10, item_name=item_name)
            out["solo_ms"] = solo
            (tmp / "q.jsonl").write_text("".join(
                json.dumps({"user": x, "num": 10}) + "\n" for x in wave_users))
            before = read_launches()["fused_topk"]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                assert cli.main(["batchpredict", "--engine", "recommendation",
                                 "--input", str(tmp / "q.jsonl"),
                                 "--output", str(tmp / "p.jsonl"),
                                 "--device", device]) == 0
            lines = [json.loads(x) for x in (tmp / "p.jsonl").read_text().splitlines()]
            assert len(lines) == WAVE
            hold_answers([x["prediction"]["itemScores"] for x in lines], wave_rows,
                         U, V, 10, item_name=item_name)
            out["batchpredict"] = {"s": time.perf_counter() - t0, "queries": WAVE,
                                   "fused_topk": read_launches()["fused_topk"] - before}
            assert not on_card or out["batchpredict"]["fused_topk"] >= 1, out

            # 5. an ML-100K-shaped app, then the daemon's death and revival
            with contextlib.redirect_stdout(printed):
                assert cli.main(["app", "new", "life"]) == 0
            life = storage.apps().get_by_name("life")
            key = storage.access_keys().get_by_appid(life.id)[0].key
            lu, li, lr = movielens_like(ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS,
                                        SEED + 142, half_stars=True)
            for fr in rating_frames(lu, li, lr, ML100K_EVENTS):
                pe.write(fr, life.id)
            acked = ML100K_EVENTS
            es_app = create_event_server_app(storage, registry=MetricsRegistry())
            rest = json.dumps({"event": "rate", "entityType": "user", "entityId": "u1",
                               "targetEntityType": "item", "targetEntityId": "i1",
                               "properties": {"rating": 4.0}}).encode()

            def ingest():
                return es_app.handle(Request("POST", "/events.json",
                                             {"accessKey": key}, {}, rest))

            assert ingest().status == 201
            acked += 1
            breaker = storage.breakers()[0]
            daemon.send_signal(signal.SIGKILL)
            daemon.wait(timeout=30)
            t_kill = time.perf_counter()
            shed = ingest()
            assert shed.status == 503 and int(shed.headers["Retry-After"]) >= 1, (
                shed.status, shed.body)
            statuses = [shed.status]
            while breaker.state != "open":  # the threshold's failures
                statuses.append(ingest().status)
                assert len(statuses) < 10, statuses
            assert set(statuses) == {503}, statuses
            open_s = time.perf_counter() - t_kill
            ready_status, ready = get_json(server.port, "/readyz")
            assert ready_status == 503 and ready["checks"]["storage_breakers"] is False, ready
            _, slo = get_json(server.port, "/slo.json")
            assert slo["breakers"][f"storage:127.0.0.1:{port}"]["state"] == "open", slo
            dead_wave = device_wave("daemon down")
            t0 = time.perf_counter()
            daemon, port2 = start_daemon(port)
            assert port2 == port
            restart_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            while True:  # the breaker half-opens after BREAKER_RESET_S
                resp = ingest()
                if resp.status == 201:
                    break
                assert resp.status == 503 and time.perf_counter() - t0 < 60, resp.status
                time.sleep(0.1)
            close_s = time.perf_counter() - t0
            acked += 1
            assert breaker.state == "closed", breaker.state
            for _ in range(49):
                assert ingest().status == 201
                acked += 1
            assert get_json(server.port, "/readyz")[0] == 200
            read_back = len(pe.find(life.id))
            assert read_back == acked, (read_back, acked)
            rows_hint = pe.status(app_id)["rows_hint"]
            assert rows_hint == n_events, rows_hint
            out["daemon_death"] = {
                "sheds": statuses, "retry_after_s": int(shed.headers["Retry-After"]),
                "breaker_open_s": open_s, "readyz": ready_status,
                "wave_while_down": dead_wave, "restart_s": restart_s,
                "breaker_close_s": close_s, "acked": acked, "read_back": read_back,
                "ml20m_rows_after": rows_hint,
            }

            # 6. pio app compact, then a train with models on TYPE=hdfs
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["app", "compact", "life"]) == 0
            assert buf.getvalue().strip() == f"Compacted app life: {acked} live events.", (
                buf.getvalue())
            server.shutdown()
            server = None
            deployed = app = None
        hdfs = {"TYPE": "hdfs", "PATH": f"file://{tmp}/hdfs_models"}
        (tmp / "life.json").write_text(json.dumps({
            "id": "life", "engineFactory": "recommendation",
            "datasource": {"params": {"appName": "life"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS, "lambda": 0.01}}],
        }))
        with scoped_env(**{"PIO_HOME": str(tmp / "client_home"),
                           **remote_env(url, models=hdfs)}):
            storage.close()
            storage = reset_storage(StorageConfig.from_env())
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                assert cli.main(["train", "--engine-json", str(tmp / "life.json"),
                                 "--device", device]) == 0
            hdfs_train_s = time.perf_counter() - t0
            hdfs_launches = read_launches()
            assert not on_card or hdfs_launches["als_fused_accum"] == 2 * ITERATIONS
            life_id = printed.getvalue().split("Engine instance: ")[-1].split()[0]
            assert any((tmp / "hdfs_models").iterdir())
            (blob,) = load_models(storage.models(), life_id)
            Ul, Vl = blob["user_factors"], blob["item_factors"]
            lkeys = [str(x) for x in blob["item_vocab"]]
            deployed = deploy_engine("recommendation", storage=storage,
                                     engine_instance_id=life_id, device=device)
            app = create_prediction_server_app(
                deployed, use_microbatch=True, max_batch=WAVE, max_queue=4 * WAVE,
                registry=MetricsRegistry())
            rows = np.arange(len(blob["user_vocab"]))
            before = read_launches()["fused_topk"]
            burst = queued_burst(app.microbatcher,
                                 [{"user": str(blob["user_vocab"][x]), "num": 10}
                                  for x in rows], [{} for _ in rows])
            assert all(b[0] == "ok" for b in burst)
            hold_answers([b[1]["itemScores"] for b in burst], rows, Ul, Vl, 10,
                         item_name=lambda j: lkeys[j])
            hdfs_wave = read_launches()["fused_topk"] - before
            assert not on_card or hdfs_wave == 1, hdfs_wave
            out["hdfs_models"] = {"train_s": hdfs_train_s, "launches": hdfs_launches,
                                  "wave_queries": len(rows), "wave_fused_topk": hdfs_wave}
    finally:
        wf_log.removeHandler(stages)
        if server is not None:
            server.shutdown()
        if storage is not None:
            storage.close()
        if daemon is not None:
            stop_cli(daemon)
        reset_storage(StorageConfig.from_env({"PIO_HOME": str(tmp / "idle_home")}))
        tmp_dir.cleanup()
    out["launches"] = {
        "als_segment_accum": out["train"]["launches"]["als_segment_accum"]
        + out["hdfs_models"]["launches"]["als_segment_accum"],
        "als_fused_accum": out["train"]["launches"]["als_fused_accum"]
        + out["hdfs_models"]["launches"]["als_fused_accum"],
        "fused_topk": out["wave"]["fused_topk"] + out["batchpredict"]["fused_topk"]
        + out["daemon_death"]["wave_while_down"]["fused_topk"]
        + out["hdfs_models"]["wave_fused_topk"],
    }
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line() if on_card else "not measured"
    return out


# -- the watch loop: costs, alerts, incidents, traces, the obs verbs ----------

#: the watch phase's expected seconds (PERF.md §4), tenant one's queued
#: bursts of known users (each one device wave: kernel 3), tenant two's
#: solo queries, the evaluator's tick, and the latency objective of the
#: deploy's SLO tracker: a burst queues 1,024 queries at once by design,
#: so the 0.5 s default would page slo_burn for the burst itself
WATCH_EXPECTED_S = (45, 75)
WATCH_BURSTS, WATCH_WAVE, WATCH_SOLO = 4, 1024, 64
WATCH_TICK_S, WATCH_SLO_LATENCY_S = 1.0, 60.0
#: the profile verb's capture window (seconds)
WATCH_PROFILE_S = 2.0
#: the deploy's storage client: a breaker that stays open through the
#: daemon's outage (its reset outlasts kill -> firing -> status -> a wave
#: -> restart), so breaker_open fires once and records one bundle, and a
#: half-open probe after the restart closes it
WATCH_STORE_KNOBS = {"TIMEOUT": "60", "RETRIES": "1", "BREAKER_THRESHOLD": "2",
                     "BREAKER_RESET_S": "12"}


def device_lead_us(trace_path: str) -> float | None:
    """How far ahead of the host's stamp of a launch its device work is
    stamped in a capture's chrome trace: the largest over correlated
    pairs, in us (negative when every device op starts after its launch)."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    leads = [launches[e["args"]["correlation"]] - e["ts"] for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and e.get("args", {}).get("correlation") in launches]
    return max(leads) if leads else None


def raise_open_files(want: int) -> dict:
    """The soft limit of open files raised toward ``want`` (within the hard
    limit): a burst holds one connection per query, both ends in this
    process."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    target = want if hard == resource.RLIM_INFINITY else min(want, hard)
    if soft != resource.RLIM_INFINITY and soft < target:
        resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
    return {"soft": resource.getrlimit(resource.RLIMIT_NOFILE)[0], "hard": hard}


def held_http_burst(batcher, port: int, users, tenant: str,
                    second_headers: dict | None = None, before_release=None) -> list:
    """``len(users)`` queries for ``tenant`` (None: no tenant named) over
    HTTP, one connection each, queued behind a held wave of one query, so
    the next wave takes them all (kernel 3 at 512 known users or more).  The first, sent alone before
    the rest, leads the wave: the wave's finalize (its feedback writes)
    runs under that query's request context.  The second carries
    ``second_headers``, so a trace it names holds its own spans and its
    wave's stages, not the wave's 1,024 feedback writes.  ``before_release``
    runs once every query is queued, just before the held wave lets go.
    Returns (status, X-Pio-Request-Id, body) per query, in order."""
    import asyncio

    real = batcher.batch_fn
    gate, held = threading.Event(), threading.Event()

    def gated(items):
        if not held.is_set():
            held.set()
            gate.wait(120)
        return real(items)

    async def one(user, headers):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps({"user": f"u{user}", "num": 10}).encode()
        head = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        app = f"X-Pio-App: {tenant}\r\n" if tenant else ""
        writer.write((f"POST /queries.json HTTP/1.1\r\nHost: smoke\r\n"
                      f"{app}{head}Content-Length: "
                      f"{len(body)}\r\nConnection: close\r\n\r\n").encode() + body)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, data = raw.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (x.partition(":") for x in lines[1:] if x)}
        return int(lines[0].split()[1]), hdrs.get("x-pio-request-id"), data

    async def burst():
        first = asyncio.ensure_future(one(users[0], {}))
        for _ in range(600):
            if len(batcher._pending) >= 1:
                break
            await asyncio.sleep(0.01)
        rest = [asyncio.ensure_future(one(u, (second_headers or {}) if k == 0 else {}))
                for k, u in enumerate(users[1:])]
        for _ in range(1200):
            if len(batcher._pending) >= len(users):
                break
            await asyncio.sleep(0.05)
        assert len(batcher._pending) == len(users), len(batcher._pending)
        if before_release is not None:
            before_release()
        gate.set()
        return await asyncio.gather(first, *rest)

    batcher.batch_fn = gated
    try:
        hold = threading.Thread(target=post_tenant, args=(port, "u0", tenant))
        hold.start()
        assert held.wait(60), "the holding wave never started"
        results = asyncio.run(asyncio.wait_for(burst(), timeout=300))
        hold.join(120)
    finally:
        gate.set()
        batcher.batch_fn = real
    return results


def post_tenant(port: int, user: str, tenant: str | None) -> int:
    """The status of one query for ``tenant`` (None: no tenant named) on a
    connection of its own."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        return http_call(conn, "POST", "/queries.json",
                         json.dumps({"user": user, "num": 10}).encode(),
                         {"X-Pio-App": tenant} if tenant else {})[0]
    finally:
        conn.close()


def alert_events(port: int) -> list:
    """The deploy's recent alert transitions, oldest first."""
    status, snap = obs_get(port, "/alerts.json")
    assert status == 200, snap
    return list(reversed(snap["recent"]))


def wait_for_transition(port: int, rule: str, event: str, timeout: float,
                        since: float = 0.0) -> dict:
    """The first ``event`` transition of ``rule`` at or after ``since``
    (wall time), polled from ``/alerts.json``."""
    deadline = time.monotonic() + timeout
    while True:
        for e in alert_events(port):
            if e["rule"] == rule and e["event"] == event and e["at"] >= since - 1e-3:
                return e
        assert time.monotonic() < deadline, (
            f"no {event} of {rule} in {timeout} s", alert_events(port)[-6:])
        time.sleep(0.1)


def postgres_binaries() -> dict | None:
    """``initdb`` and ``pg_ctl`` on PATH or under /usr/lib/postgresql, or
    None."""
    import glob
    import shutil

    for d in [None, *sorted(glob.glob("/usr/lib/postgresql/*/bin"), reverse=True)]:
        initdb = shutil.which("initdb", path=d)
        pg_ctl = shutil.which("pg_ctl", path=d)
        if initdb and pg_ctl:
            return {"initdb": initdb, "pg_ctl": pg_ctl}
    return None


def postgres_train(tmp: Path, device) -> dict:
    """With a PostgreSQL server on this host: a throwaway server, the
    ML-100K app's metadata, events and models on it, ``run_train`` (40
    kernel-1 launches) and the server-side shard split held to
    ``entity_shard``.  Without one: ``{"server": None}``."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import base, postgres_backend, pq_driver
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.tools import commands

    bins = postgres_binaries()
    if bins is None or not pq_driver.available():
        return {"server": None}
    data, sock = tmp / "pgdata", tmp / "pgsock"
    sock.mkdir()
    subprocess.run([bins["initdb"], "-D", str(data), "-U", "pio", "--auth=trust"],
                   check=True, capture_output=True, timeout=120)
    subprocess.run([bins["pg_ctl"], "-D", str(data), "-o",
                    f"-c listen_addresses='' -k {sock}", "-w", "start"],
                   check=True, capture_output=True, timeout=120)
    out: dict = {"server": bins["pg_ctl"]}
    storage = None
    try:
        url = f"postgresql://pio@/postgres?host={sock}"
        storage = StorageRuntime(StorageConfig.from_env({
            "PIO_HOME": str(tmp / "pg_home"),
            "PIO_STORAGE_SOURCES_PG_TYPE": "postgres",
            "PIO_STORAGE_SOURCES_PG_URL": url,
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "PG"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}}))
        app = commands.app_new(storage, "pg100k").app
        u, i, r = movielens_like(ML100K_EVENTS, ML100K_USERS, ML100K_ITEMS,
                                 SEED + 40, half_stars=False)
        t0 = time.perf_counter()
        storage.l_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=f"u{a}",
                  target_entity_type="item", target_entity_id=f"i{b}",
                  properties=DataMap({"rating": float(c)}))
            for a, b, c in zip(u.tolist(), i.tolist(), r.tolist())], app.id)
        out["write_s"] = time.perf_counter() - t0
        pe = storage.p_events()
        assert isinstance(pe, postgres_backend.PGPEvents)
        t0 = time.perf_counter()
        n = 0
        for k, frame in pe.iter_shards(app.id, n_shards=4):
            got = base.frame_shard_of(frame.entity_type, frame.entity_id, 4)
            assert (got == k).all(), k
            n += len(frame.event)
        assert n == ML100K_EVENTS, n
        out["shards_s"] = time.perf_counter() - t0
        engine = resolve_engine_factory("recommendation")()
        params = engine.params_from_json({
            "datasource": {"params": {"appName": "pg100k"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS}}]})
        before = read_launches()["als_fused_accum"]
        t0 = time.perf_counter()
        inst = run_train(engine, params, ctx=EngineContext(storage=storage, device=device),
                         engine_factory="recommendation", storage=storage)
        out["train_s"] = time.perf_counter() - t0
        out["train_launches"] = read_launches()["als_fused_accum"] - before
        assert inst is not None and inst.status == "COMPLETED"
        assert torch.device(device).type != "cuda" or out["train_launches"] == 2 * ITERATIONS
    finally:
        if storage is not None:
            storage.close()
        subprocess.run([bins["pg_ctl"], "-D", str(data), "-m", "immediate", "stop"],
                       capture_output=True, timeout=120)
    return out


def watch_phase(device="cuda") -> dict:
    """``watch``: the watch loop over a two-tenant deploy on the card.

    A ``storageserver`` process (sqlite events: feedback writes one event
    an answer) holds every repository;
    two seeded models at the ML-20M shape are written to it and deployed
    as tenants ``one`` and ``two`` (``deploy_tenant_engines`` + the
    multi-tenant app: waves of up to 1,024, feedback on, an access key)
    with the watch loop on (the default rule pack, a tick of 1 s, bundles
    into ``PIO_INCIDENT_DIR``); a ``pio eventserver`` process on the same
    daemon.  ``one`` gets 4 x 1,024 queued known-user queries over HTTP,
    each burst one device wave through kernel 3 (every answer held to the
    host answer), ``two`` 64 solo queries: ``/costs.json`` bills both, and
    the ledger's device seconds over all apps equal the batcher's
    ``pio_microbatch_device_seconds`` within 1e-6 of it.  ``cost_skew``
    fires for ``one`` within ``for_s`` and two ticks of its pending.  The
    fourth burst leads with a query sent with ``X-Pio-Trace-Id`` while
    ``pio profile --url --seconds 2`` captures (a CUDA capture naming
    kernel 3); an event POSTed to the event server under the same trace;
    ``pio trace`` over the deploy, the daemon and the event server joins
    them, the wave's stages on the ``device:cuda:0`` lane.  The daemon is
    SIGKILLed: the next answers' feedback writes open the breaker,
    ``breaker_open`` fires within one tick, one bundle is written for it,
    ``pio status --url`` exits 1, and a wave still answers through kernel
    3; the read-only verbs run together (``incident list|show|export
    --perfetto``, ``alerts``, ``costs``, ``top --json``, ``capacity``,
    ``explain`` of a kernel-3 answer, ``profile --stacks``).  Restarted on
    its port, the breaker closes, ``breaker_open`` resolves and ``status
    --url`` exits 0.  Last, Postgres: with ``initdb`` and ``pg_ctl`` on the
    host, an ML-100K train over a throwaway server (kernel 1); without
    them ``{"server": null}``."""
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.obs.profiler import PROFILER
    from predictionio_tpu_torch.resilience.breaker import breaker_states
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.prediction_server import (
        FeedbackConfig,
        create_multi_tenant_server_app,
        deploy_tenant_engines,
    )
    from predictionio_tpu_torch.tools import commands

    import signal

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"phase": "watch", "expected_s": WATCH_EXPECTED_S,
                 "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "bursts": [WATCH_BURSTS, WATCH_WAVE], "solo": WATCH_SOLO,
                 "tick_s": WATCH_TICK_S, "slo_latency_s": WATCH_SLO_LATENCY_S,
                 "open_files": raise_open_files(4 * WATCH_WAVE + 1024),
                 "nvidia_smi": nvidia_smi_line()}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    root, incident_dir = tmp / "root", tmp / "incidents"
    root.mkdir()
    daemon = es_proc = server = storage = None
    reset_launches()

    def start_daemon(port: int):
        # sqlite events: every answer's feedback is one insert, and the
        # parquet log writes a segment per insert (the storage phase drives
        # the parquet log at the ML-20M shape)
        proc, lines = spawn_cli(root, ["storageserver", "--ip", "127.0.0.1",
                                       "--port", str(port), "--root", str(root),
                                       "--events", "sqlite"], 1)
        return proc, bound_port(lines[0])

    def status_url() -> tuple[int, str]:
        # --no-quality: the bursts' scores drift from the quality monitor's
        # reference window by construction (seeded random users); the
        # alert fold and the probes decide the exit code here
        ((rc, _, err),) = cli_once(tmp / "cli_home", [
            ["status", "--url", deploy_url, "--access-key", OBS_KEY,
             "--no-quality"]])
        return rc, err

    try:
        t0 = time.perf_counter()
        daemon, dport = start_daemon(0)
        daemon_url = f"http://127.0.0.1:{dport}"
        env = {**remote_env(daemon_url),
               **{f"PIO_STORAGE_SOURCES_R_{k}": v for k, v in WATCH_STORE_KNOBS.items()}}
        storage = StorageRuntime(StorageConfig.from_env(
            {"PIO_HOME": str(tmp / "home"), **env}))
        es_proc, es_lines = spawn_cli(tmp / "es_home", [
            "eventserver", "--ip", "127.0.0.1", "--port", "0"], 1, env=env)
        es_url = f"http://127.0.0.1:{bound_port(es_lines[0])}"
        one_app = commands.app_new(storage, "one")
        ids, factors = {}, {}
        for name, seed, coords in (("one", SEED + 30, ("default",) * 3),
                                   ("two", SEED + 31, ("two", "default", "default"))):
            ids[name], U, V = write_model(storage, tmp, seed=seed, coords=coords)
            factors[name] = (U, V)
        reg = MetricsRegistry()
        with scoped_env(PIO_INCIDENT_DIR=str(incident_dir),
                        PIO_ALERT_INTERVAL_S=str(WATCH_TICK_S)):
            tenants = deploy_tenant_engines([
                {"app": "one", "engine_factory": "recommendation",
                 "engine_instance_id": ids["one"]},
                {"app": "two", "engine_factory": "recommendation", "engine_id": "two",
                 "engine_instance_id": ids["two"]},
            ], storage=storage, registry=reg, device=device)
            app = create_multi_tenant_server_app(
                tenants, use_microbatch=True, max_batch=WATCH_WAVE, max_queue=0,
                registry=reg, access_key=OBS_KEY,
                feedback=FeedbackConfig(enabled=True, app_id=one_app.app.id))
        app.slo.latency_threshold_s = WATCH_SLO_LATENCY_S
        assert app.alerts is not None and app.alerts.interval_s == WATCH_TICK_S
        assert app.incidents.directory == str(incident_dir)
        server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
        deploy_url = f"http://127.0.0.1:{server.port}"
        out["setup_s"] = time.perf_counter() - t0

        # (a) the billed solo queries and bursts; the ledger conserves.  The
        # solo queries go first, so cost_skew's hold runs beside the bursts
        rng = np.random.default_rng(SEED + 32)
        U1, V1 = factors["one"]
        U2, V2 = factors["two"]
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        solo_ms = []
        try:
            for user in rng.choice(ML20M_USERS, WATCH_SOLO, replace=False):
                status, headers, body, ms = http_call(
                    conn, "POST", "/queries.json",
                    json.dumps({"user": f"u{user}", "num": 10}).encode(),
                    {"X-Pio-App": "two"})
                assert status == 200 and headers["X-Pio-App"] == "two", status
                want = host_answer(U2, V2, int(user), 10)
                hold_scored(body["itemScores"], want, 10, user)
                solo_ms.append(ms)
        finally:
            conn.close()
        out["solo_p50_ms"] = statistics.median(solo_ms)
        burst_s, kernel3 = [], []
        tid = uuid.uuid4().hex
        profiling: list = []

        def start_profile() -> None:
            """``pio profile --url`` armed with the wave queued, so its
            capture holds the wave's kernel."""
            proc = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.tools.cli",
                 "profile", "--url", deploy_url, "--access-key", OBS_KEY,
                 "--seconds", str(WATCH_PROFILE_S)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PIO_HOME=str(tmp / "cli_home"),
                         PYTHONUNBUFFERED="1"),
                cwd=Path(__file__).resolve().parent)
            profiling.append(proc)
            # the verb prints its first line once the server answered 202,
            # which it does once the profiler has started on the capture's
            # thread (the status reads running from the request on)
            first = proc.stdout.readline()
            assert first.startswith("torch profiler capturing"), (
                first, proc.communicate())
            assert PROFILER.status()["running"]

        def burst(traced: bool, profiled: bool) -> list:
            """One held burst of tenant one's known users (one kernel-3
            wave), its answers held to the host answer."""
            users = rng.choice(ML20M_USERS, WATCH_WAVE, replace=False)
            before = read_launches()["fused_topk"]
            t0 = time.perf_counter()
            res = held_http_burst(
                app.microbatcher, server.port, users, "one",
                {"X-Pio-Trace-Id": tid} if traced else None,
                start_profile if profiled else None)
            burst_s.append(time.perf_counter() - t0)
            kernel3.append(read_launches()["fused_topk"] - before)
            assert [r[0] for r in res] == [200] * WATCH_WAVE, [r[0] for r in res][:8]
            hold_answers([json.loads(r[2])["itemScores"] for r in res[:256]],
                         users[:256], U1, V1, 10)
            return res

        def wave_t0(rid: str) -> float:
            """The dispatch wall time of the wave that answered ``rid``
            (its provenance record's wave id: dispatch wall-ms in hex)."""
            record = obs_get(server.port, f"/explain.json?request_id={rid}")[1]["record"]
            return int(record["wave"]["id"].split("-")[0], 16) / 1e3

        for _ in range(WATCH_BURSTS - 1):
            burst(False, False)
        # the last burst: traced, and captured by the profile verb once
        res = burst(True, True)
        proc = profiling[-1]
        prof_out, prof_err = proc.communicate(timeout=120)
        last = {}
        if proc.returncode == 0:
            last = json.loads(prof_out[prof_out.index("{"):])["last"]
        capture = {
            "rc": proc.returncode, "cuda": last.get("cuda"),
            "error": last.get("error") or (prof_err.strip().splitlines() or [""])[-1],
            "window": [last.get("started"), last.get("finished")],
            "wave_t0": wave_t0(res[1][1]),
            "fused_topk_ops": [o for o in last.get("device_ops") or ()
                               if "fused_topk" in o["name"]],
            "device_lead_us": device_lead_us(last["trace"]) if last.get("trace") else None}
        out["bursts_s"] = burst_s
        out["burst_launches"] = kernel3
        assert not on_card or kernel3 == [1] * len(burst_s), kernel3
        costs = obs_get(server.port, "/costs.json")[1]
        billed = {}
        for row in costs["totals"]:
            agg = billed.setdefault(row["app"], {"requests": 0.0, "device_s": 0.0})
            agg["requests"] += row["requests"]
            agg["device_s"] += row["device_s"]
        fam = reg.get("pio_microbatch_device_seconds")
        device_s = sum(child.sum for _, child in fam.series())
        ledger_s = sum(a["device_s"] for a in billed.values())
        out["costs"] = {"billed": billed, "batcher_device_s": device_s,
                        "ledger_device_s": ledger_s,
                        "rel_diff": abs(ledger_s - device_s) / device_s}
        assert billed["one"]["requests"] == len(burst_s) * (WATCH_WAVE + 1), billed
        assert billed["two"]["requests"] == WATCH_SOLO, billed
        assert out["costs"]["rel_diff"] <= 1e-6, out["costs"]

        # (b) the profile verb's capture, the trace across three processes
        out["profile"] = capture
        assert capture["rc"] == 0, capture
        assert not on_card or (capture["cuda"] and not capture["error"]
                               and capture["fused_topk_ops"]), capture
        conn = http.client.HTTPConnection(es_url.split("//")[1], timeout=60)
        try:
            status, _, body, _ = http_call(
                conn, "POST", f"/events.json?accessKey={one_app.keys[0].key}",
                json.dumps({"event": "view", "entityType": "user", "entityId": "u7",
                            "targetEntityType": "item", "targetEntityId": "i7"}).encode(),
                {"Content-Type": "application/json", "X-Pio-Trace-Id": tid})
        finally:
            conn.close()
        assert status == 201, body
        ((rc, trace_out, trace_err),) = cli_once(tmp / "cli_home", [
            ["trace", tid, "--from", f"{deploy_url},{daemon_url},{es_url}",
             "--json", "--access-key", OBS_KEY]])
        assert rc == 0, trace_err[-2000:]
        tl = json.loads(trace_out)

        def nodes(spans):
            for n in spans:
                yield n
                yield from nodes(n.get("children", ()))

        lanes: dict = {}
        for n in nodes(tl["spans"]):
            lanes.setdefault(n.get("track", "spans"), []).append(n["name"])
        out["trace"] = {"processes": tl["processes"], "span_count": tl["span_count"],
                        "lanes": {k: sorted(set(v)) for k, v in lanes.items()},
                        "source_errors": tl["source_errors"]}
        assert len(tl["processes"]) >= 2, out["trace"]
        device_lane = f"device:{device}:0" if on_card else "device:cpu:0"
        assert lanes.get(device_lane), out["trace"]

        # (c) cost_skew fires for one within for_s and two ticks
        pending = wait_for_transition(server.port, "cost_skew", "pending", 30)
        firing = wait_for_transition(server.port, "cost_skew", "firing", 30)
        skew_rule = next(r for r in app.alerts.rules if r.name == "cost_skew")
        out["cost_skew"] = {"key": firing["key"], "value": firing["value"],
                            "pending_to_firing_s": firing["at"] - pending["at"],
                            "for_s": skew_rule.for_s}
        assert firing["key"] == "app=one", firing
        assert out["cost_skew"]["pending_to_firing_s"] <= (
            skew_rule.for_s + 2 * WATCH_TICK_S + 0.5), out["cost_skew"]
        rc, err = status_url()
        out["status_before_kill"] = rc
        assert rc == 0, err[-2000:]

        # (d) the daemon dies: breaker_open, one bundle, status exits 1
        daemon.send_signal(signal.SIGKILL)
        daemon.wait(timeout=30)
        t_kill = time.time()
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        try:
            opened_at = None
            for k in range(32):
                status, _, _, _ = http_call(
                    conn, "POST", "/queries.json",
                    json.dumps({"user": f"u{k}", "num": 10}).encode(),
                    {"X-Pio-App": "two"})
                assert status == 200, status
                if any(s.get("state") == "open" for s in breaker_states().values()):
                    opened_at = time.time()
                    break
        finally:
            conn.close()
        assert opened_at is not None, breaker_states()
        fired = wait_for_transition(server.port, "breaker_open", "firing", 10,
                                    since=opened_at)
        out["breaker_open"] = {"key": fired["key"],
                               "kill_to_open_s": opened_at - t_kill,
                               "open_to_firing_s": fired["at"] - opened_at}
        assert fired["severity"] == "critical", fired
        assert out["breaker_open"]["open_to_firing_s"] <= WATCH_TICK_S + 0.5, out
        # the bundle is written on the firing tick, after the transition
        deadline = time.monotonic() + 10
        while not any(r["rule"] == "breaker_open" for r in app.incidents.list()):
            assert time.monotonic() < deadline, app.incidents.list()
            time.sleep(0.05)
        # a bundle per firing, but one a rule a minute (the recorder's
        # rate limit): a rule that fired again meanwhile (a drift detector
        # at the burst's edge) counts the rest as suppressed.  Another rule
        # may fire while this reads: read until the books balance
        suppressed_fam = reg.get("pio_incidents_suppressed_total")
        deadline = time.monotonic() + 10
        while True:
            firings: dict = {}
            for e in alert_events(server.port):
                if e["event"] == "firing":
                    firings[e["rule"]] = firings.get(e["rule"], 0) + 1
            bundles = app.incidents.list()
            by_rule: dict = {}
            for row in bundles:
                by_rule[row["rule"]] = by_rule.get(row["rule"], 0) + 1
            suppressed = {lv[0]: int(c.value) for lv, c in suppressed_fam.series()
                          if c.value} if suppressed_fam is not None else {}
            balanced = set(by_rule) == set(firings) and all(
                by_rule[r] == 1 and suppressed.get(r, 0) == n - 1
                for r, n in firings.items())
            if balanced or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        out["bundles"] = by_rule
        out["firings"] = firings
        out["bundles_suppressed"] = suppressed
        assert by_rule.get("breaker_open") == 1 and firings["breaker_open"] == 1
        assert balanced, (by_rule, firings, suppressed)
        rc, err = status_url()
        out["status_daemon_dead"] = rc
        assert rc == 1 and "breaker_open" in err, err[-2000:]
        users = rng.choice(ML20M_USERS, WATCH_WAVE, replace=False)
        before = read_launches()["fused_topk"]
        res = held_http_burst(app.microbatcher, server.port, users, "one")
        out["wave_daemon_dead_launches"] = read_launches()["fused_topk"] - before
        assert [r[0] for r in res] == [200] * WATCH_WAVE
        assert not on_card or out["wave_daemon_dead_launches"] == 1, out
        hold_answers([json.loads(r[2])["itemScores"] for r in res[:256]],
                     users[:256], U1, V1, 10)
        t_restart = time.time()
        t0 = time.perf_counter()
        daemon, _ = start_daemon(dport)
        out["restart_s"] = time.perf_counter() - t0
        out["outage_s"] = t_restart - t_kill + out["restart_s"]

        # (e) the read-only verbs, all at once
        bundle = next(r for r in bundles if r["rule"] == "breaker_open")
        # a kernel-3 answer still in the provenance ring (1,024 records)
        explained = res[-1][1]
        verbs = [
            ["incident", "list", "--url", deploy_url],
            ["incident", "show", bundle["id"], "--url", deploy_url],
            ["incident", "export", bundle["id"], "--url", deploy_url, "--perfetto", "-"],
            ["alerts", "--url", deploy_url],
            ["costs", "--url", deploy_url],
            ["top", "--url", deploy_url, "--json", "--once"],
            ["capacity", "--url", deploy_url],
            ["explain", explained, "--url", deploy_url, "--json", "--no-trace"],
            ["profile", "--url", deploy_url, "--stacks", "--seconds", "1"],
        ]
        t0 = time.perf_counter()
        got = cli_once(tmp / "cli_home", [v + ["--access-key", OBS_KEY] for v in verbs])
        out["verbs_s"] = time.perf_counter() - t0
        rcs = {" ".join(v[:2]): rc for v, (rc, _, _) in zip(verbs, got)}
        out["verbs_rc"] = rcs
        for v, (rc, stdout, stderr) in zip(verbs, got):
            # alerts exits 1 while anything fires
            assert rc == (1 if v[0] == "alerts" else 0), (v, stderr[-2000:])
        assert bundle["id"] in got[0][1]
        assert "rule:      breaker_open" in got[1][1]
        chrome = json.loads(got[2][1])
        out["bundle_chrome_events"] = len(chrome["traceEvents"])
        assert any(e["ph"] == "X" for e in chrome["traceEvents"])
        assert "breaker_open" in got[3][1] and "one" in got[4][1]
        assert set(json.loads(got[5][1])) == {"costs", "alerts"}
        assert "max sustainable" in got[6][1]
        record = json.loads(got[7][1])["record"]
        out["explained"] = {"engine_path": record.get("engine_path"),
                            "wave": record.get("wave")}
        assert record["engine_path"] == "als.device_topk", record
        assert '"samples"' in got[8][1]

        # (f) restarted: the breaker half-opens, a feedback write closes it,
        # the alert resolves, status exits 0
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        try:
            deadline = time.monotonic() + 60
            while any(s.get("state") != "closed" for s in breaker_states().values()):
                assert time.monotonic() < deadline, breaker_states()
                status, _, _, _ = http_call(
                    conn, "POST", "/queries.json",
                    json.dumps({"user": "u1", "num": 10}).encode(), {"X-Pio-App": "two"})
                assert status == 200
                time.sleep(0.2)
            closed_at = time.time()
        finally:
            conn.close()
        # resolved after the restart (at the half-open probe or the close),
        # and no firing since
        resolved = wait_for_transition(server.port, "breaker_open", "resolved", 10,
                                       since=t_restart)
        out["breaker_open"]["restart_to_resolved_s"] = resolved["at"] - t_restart
        out["breaker_open"]["firings"] = sum(
            1 for e in alert_events(server.port)
            if e["rule"] == "breaker_open" and e["event"] == "firing")
        assert out["breaker_open"]["firings"] == 1, out["breaker_open"]
        assert not app.alerts.firing() or all(
            a["rule"] != "breaker_open" for a in app.alerts.firing()), app.alerts.firing()
        rc, err = status_url()
        out["status_restarted"] = rc
        assert rc == 0, err[-2000:]
        out["postgres"] = postgres_train(tmp, device)
        out["launches"] = read_launches()
    finally:
        if server is not None:
            server.shutdown()
        if storage is not None:
            storage.close()
        for proc in (es_proc, daemon):
            if proc is not None:
                stop_cli(proc)
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- the fleet: router, membership, autoscaler, the daemons -------------------

#: the phase's expected seconds on the card (the replicas' boots lead)
FLEET_EXPECTED_S = (45, 80)
#: (a) the replicas `fleet deploy` starts, its clients, their solo queries,
#: the seconds of traffic around the SIGKILL, the autoscaler's tick
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_SOLO = 2, 16, 512
FLEET_KILL_TRAFFIC_S, FLEET_TICK_S = (0.5, 2.0), 0.5
#: clients across the SIGKILL: the router's RetryBudget (the JAX package's:
#: 10 tokens, 0.1 back per answered call) retries at most ~10 forwards that
#: fail at once, and each client holds one forward in flight; 16 clients
#: left 2 of 1,431 queries a 503 in a CPU run (budget exhausted), so the
#: kill runs under 4, as the JAX package's chaos scenario does
FLEET_KILL_CLIENTS = 4
#: (b) each in-process replica's device wave (its max_batch): the engine's
#: device floor, so one wave a replica still launches kernel 3 (cut from
#: 1,024 to make room for the day phase: the routed burst is host time)
FLEET_WAVE = 512


def cuda_contexts(named: dict, before: list) -> dict:
    """Which of the ``named`` pids hold a CUDA context, per nvidia-smi's
    compute apps, and how many contexts appeared since ``before``.  Where
    nvidia-smi lists pids of another namespace (this process not among
    them), only the count can be read: ``holding`` is None."""
    apps = compute_app_pids()
    visible = os.getpid() in apps
    return {"pids_visible": visible, "new_contexts": len(apps) - len(before),
            "holding": {k: pid in apps for k, pid in named.items()} if visible else None}


def fleet_homes(urls: list, want: int) -> dict:
    """``want`` distinct known users (ML-20M rows) per replica URL whose
    home the fleet's rendezvous order puts there, in row order."""
    from predictionio_tpu_torch.fleet.membership import FleetState
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry

    fleet = FleetState(urls, registry=MetricsRegistry())
    homes: dict = {u.rstrip("/"): [] for u in urls}
    for row in range(ML20M_USERS):
        picked = homes[fleet.route_order(f"u{row}")[0].url]
        if len(picked) < want:
            picked.append(row)
        if all(len(v) == want for v in homes.values()):
            return homes
    raise AssertionError("too few users for every replica")


def held_router_burst(batcher, port: int, hold_user: int, users) -> list:
    """``len(users)`` known-user queries through the router on ``port``,
    one connection each, queued at the replica whose ``batcher`` is given
    behind a held wave of one query (``hold_user``, itself routed there:
    the host route), so the replica's next wave takes them all: one device
    wave, one launch of kernel 3.  The connections open one after another
    (the threaded router listens with a short backlog).  Returns (status,
    lower-cased headers, body) per query, in order."""
    import asyncio

    real = batcher.batch_fn
    gate, held = threading.Event(), threading.Event()

    def gated(items):
        if not held.is_set():
            held.set()
            gate.wait(120)
        return real(items)

    async def answer(reader, writer):
        raw = await reader.read()
        writer.close()
        head, _, data = raw.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        hdrs = {k.strip().lower(): v.strip() for k, _, v in
                (x.partition(":") for x in lines[1:] if x)}
        return int(lines[0].split()[1]), hdrs, json.loads(data)

    async def burst():
        tasks = []
        for u in users:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            body = json.dumps({"user": f"u{u}", "num": 10}).encode()
            writer.write((f"POST /queries.json HTTP/1.1\r\nHost: smoke\r\n"
                          f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                          ).encode() + body)
            await writer.drain()
            tasks.append(asyncio.ensure_future(answer(reader, writer)))
        for _ in range(1200):
            if len(batcher._pending) >= len(users):
                break
            await asyncio.sleep(0.05)
        assert len(batcher._pending) == len(users), len(batcher._pending)
        gate.set()
        return await asyncio.gather(*tasks)

    batcher.batch_fn = gated
    try:
        hold = threading.Thread(target=post_tenant, args=(port, f"u{hold_user}", None))
        hold.start()
        assert held.wait(60), "the holding wave never started"
        results = asyncio.run(asyncio.wait_for(burst(), timeout=300))
        hold.join(120)
    finally:
        gate.set()
        batcher.batch_fn = real
    return results


def fleet_phase(device="cuda") -> dict:
    """``fleet``: the horizontal serving tier and the operator's daemons.

    (a) ``pio fleet deploy --replicas 2 --autoscale`` as a subprocess of the
    port's CLI on ``write_model``'s ML-20M model: two ``pio deploy`` replica
    daemons on ``device`` (each its own CUDA context) behind the router,
    which holds none (nvidia-smi's compute apps against the pidfiles).  16
    clients send 512 solo known-user queries through the router: every
    answer 200 from its ``route_order`` home (``X-Pio-Replica``), held to
    the host answer.  One replica is SIGKILLed under 16 clients: no 5xx
    (retries answered by the other), its breaker open and the replica
    ejected, ``pio fleet status --url`` naming it with exit 0.  ``pio fleet
    scale 3 --url`` respawns a routable replica; ``pio fleet watch``,
    ``pio top --url <router> --once`` (federated), ``pio capacity --url``
    and ``pio status --url`` (exit 1: the dead replica's ``breaker_open``,
    critical) run together; ``pio undeploy --port <router>`` stops the
    router and every replica, their pidfiles gone.  Each replica's
    spawn-to-ready seconds are printed.

    (b) Kernel 3 behind the router, through the phase's own
    ``ReplicaSpawner`` (the public seam a k8s or Ray spawner implements):
    two replicas in this process, each ``create_prediction_server(...,
    max_batch=FLEET_WAVE)`` on the card.  512 distinct known users homed
    on A by the fleet's ``route_order``, then 512 homed on B, go as queued
    HTTP queries through the port's router: exactly one kernel-3 launch
    per replica, every answer ``als.device_topk`` from its home, held to
    the host answer (near ties aside); each wave's kernel ms from its CUDA
    events.

    (c) ``pio start-all`` then ``pio stop-all`` on a throwaway
    ``PIO_HOME``: the event server, ``adminserver`` and ``dashboard``
    answer 200, the dashboard lists an evaluation, none holds a CUDA
    context, and every pidfile is gone afterwards."""
    from predictionio_tpu_torch.data.storage.base import EvaluationInstance
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.fleet.autoscaler import ReplicaSpawner
    from predictionio_tpu_torch.fleet.membership import (
        REPLICA_HEADER,
        FleetState,
        replica_id_of,
    )
    from predictionio_tpu_torch.fleet.router import create_router_app
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.obs.metrics import MetricsRegistry
    from predictionio_tpu_torch.server.httpd import AppServer
    from predictionio_tpu_torch.server.prediction_server import create_prediction_server
    from predictionio_tpu_torch.tools import daemon as pio_daemon

    import signal

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"phase": "fleet", "expected_s": FLEET_EXPECTED_S,
                 "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "replicas": FLEET_REPLICAS, "clients": FLEET_CLIENTS,
                 "solo": FLEET_SOLO, "wave": FLEET_WAVE,
                 "open_files": raise_open_files(4 * FLEET_WAVE + 1024),
                 "nvidia_smi": nvidia_smi_line() if on_card else None}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    home, stack_home = tmp / "home", tmp / "stack_home"
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
    instance_id, U, V = write_model(storage, tmp, seed=SEED + 40)
    router_proc = router_b = None
    stack_started = False
    spawner = None
    reset_launches()
    try:
        # (a) `pio fleet deploy` and its replica daemons
        apps_before = compute_app_pids() if on_card else []
        t0 = time.perf_counter()
        router_proc, lines = spawn_cli(home, [
            "fleet", "deploy", "--engine", "recommendation",
            "--replicas", str(FLEET_REPLICAS), "--autoscale",
            "--min-replicas", str(FLEET_REPLICAS), "--max-replicas", "3",
            "--device", device, "--ip", "127.0.0.1", "--port", "0"],
            FLEET_REPLICAS + 1, env={"PIO_FLEET_TICK_S": str(FLEET_TICK_S)})
        out["deploy_s"] = time.perf_counter() - t0
        urls = [line.split()[4] for line in lines[:FLEET_REPLICAS]]
        out["spawn_to_ready_s"] = {
            replica_id_of(u): float(line.rsplit("(", 1)[1].split()[0])
            for u, line in zip(urls, lines)}
        router_port = bound_port(lines[-1])
        router = f"http://127.0.0.1:{router_port}"
        pids = {replica_id_of(u): pio_daemon.read_pidfile(
            home / "pids" / f"replica-{u.rsplit(':', 1)[1]}.pid") for u in urls}
        assert all(pio_daemon.pid_alive(p) for p in pids.values()), pids
        if on_card:
            ctx = cuda_contexts({**pids, "router": router_proc.pid}, apps_before)
            out["cuda_contexts"] = ctx
            assert ctx["new_contexts"] == FLEET_REPLICAS, ctx
            if ctx["holding"] is not None:
                assert not ctx["holding"].pop("router"), ctx
                assert all(ctx["holding"].values()), ctx

        rng = np.random.default_rng(SEED + 41)
        users = rng.choice(ML20M_USERS, FLEET_SOLO, replace=False)
        bodies = [json.dumps({"user": f"u{u}", "num": 10}).encode() for u in users]
        results, wall = drive_clients(router_port, bodies, FLEET_CLIENTS,
                                      header=REPLICA_HEADER)
        local = FleetState(urls, registry=MetricsRegistry())
        homes = [local.route_order(f"u{u}")[0].replica_id for u in users]
        out["solo"] = {
            "statuses": sorted({r[0] for r in results}),
            "queries_per_s": FLEET_SOLO / wall,
            "p50_ms": 1e3 * float(np.percentile([r[1] for r in results], 50)),
            "p99_ms": 1e3 * float(np.percentile([r[1] for r in results], 99)),
            "per_replica": {rid: homes.count(rid) for rid in pids},
            "answers_checked_vs_host": hold_answers(
                [json.loads(r[3])["itemScores"] for r in results], users, U, V, 10),
        }
        assert out["solo"]["statuses"] == [200], out["solo"]
        assert [r[2] for r in results] == homes, "an entity left its home"
        assert all(out["solo"]["per_replica"].values()), out["solo"]

        # SIGKILL one replica under 16 clients
        victim = replica_id_of(urls[0])
        kill: list = []
        stop = threading.Event()

        def hammer(seed: int) -> None:
            r = np.random.default_rng(seed)
            conn = http.client.HTTPConnection("127.0.0.1", router_port, timeout=60)
            try:
                while not stop.is_set():
                    body = json.dumps({"user": f"u{int(r.integers(ML20M_USERS))}",
                                       "num": 10}).encode()
                    try:
                        status, hdrs, _, ms = http_call(
                            conn, "POST", "/queries.json", body, {"X-Pio-Deadline": "15"})
                        kill.append((status, hdrs.get(REPLICA_HEADER), ms))
                    except Exception as e:
                        kill.append((-1, repr(e), 0.0))
                        conn.close()
                        conn = http.client.HTTPConnection("127.0.0.1", router_port,
                                                          timeout=60)
            finally:
                conn.close()

        threads = [threading.Thread(target=hammer, args=(SEED + 50 + c,), daemon=True)
                   for c in range(FLEET_KILL_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(FLEET_KILL_TRAFFIC_S[0])
        os.kill(pids[victim], signal.SIGKILL)
        t_kill = time.perf_counter()
        time.sleep(FLEET_KILL_TRAFFIC_S[1])
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a client hung"
        statuses = [k[0] for k in kill]
        prom = parse_prometheus(obs_get(router_port, "/metrics?local=1", key=None)[1])
        out["kill"] = {
            "victim": victim,
            "clients": FLEET_KILL_CLIENTS,
            "requests": len(kill),
            "non_200": sum(s != 200 for s in statuses),
            "5xx": sum(s >= 500 for s in statuses),
            "transport_errors": sum(s == -1 for s in statuses),
            "answered_by": {rid: sum(k[1] == rid for k in kill) for rid in pids},
            "p99_ms": float(np.percentile([k[2] for k in kill], 99)),
            "retry_elsewhere": {
                dict(k[1])["reason"]: v for k, v in prom.items()
                if k[0] == "pio_router_retry_elsewhere_total"},
        }
        assert out["kill"]["non_200"] == 0, (out["kill"], [k for k in kill if k[0] != 200][:5])
        deadline = time.monotonic() + 30
        while True:
            body = obs_get(router_port, "/fleet.json", key=None)[1]
            row = next(r for r in body["replicas"] if r["replica"] == victim)
            if not row["healthy"]:
                break
            assert time.monotonic() < deadline, row
            time.sleep(0.1)
        out["kill"]["kill_to_ejected_s"] = time.perf_counter() - t_kill
        prom = parse_prometheus(obs_get(router_port, "/metrics?local=1", key=None)[1])
        out["kill"]["breaker_state"] = prom[
            ("pio_breaker_state", (("endpoint", f"replica:{victim}"),))]
        assert out["kill"]["breaker_state"] == 2.0, out["kill"]  # open
        assert out["kill"]["retry_elsewhere"].get("transport_error", 0) >= 1, out["kill"]
        ((rc, text, err),) = cli_once(tmp / "cli_home", [["fleet", "status", "--url", router]])
        out["fleet_status_after_kill"] = rc
        assert rc == 0 and "1 healthy" in text and "EJECTED" in text, (text, err[-2000:])

        # `fleet scale 3`: the autoscaler respawns a routable replica
        t0 = time.perf_counter()
        ((rc, text, err),) = cli_once(tmp / "cli_home", [["fleet", "scale", "3", "--url", router]])
        assert rc == 0 and "fleet target: 3 (pinned)" in text, (text, err[-2000:])
        deadline = time.monotonic() + 180
        while True:
            body = obs_get(router_port, "/fleet.json", key=None)[1]
            if body["total"] == 3 and body["routable"] == 2:
                break
            assert time.monotonic() < deadline, body
            time.sleep(0.2)
        out["scale"] = {"to_routable_s": time.perf_counter() - t0,
                        "total": body["total"], "routable": body["routable"],
                        "last_event": body["autoscaler"]["last_event"]["event"]}
        assert out["scale"]["last_event"] == "scale_up", body["autoscaler"]
        new = [r["url"] for r in body["replicas"] if r["url"] not in urls]
        assert len(new) == 1, body
        new_pid = pio_daemon.read_pidfile(
            home / "pids" / f"replica-{new[0].rsplit(':', 1)[1]}.pid")
        assert pio_daemon.pid_alive(new_pid)
        if on_card:
            ctx = cuda_contexts({"respawned": new_pid, "router": router_proc.pid},
                                apps_before)
            out["cuda_contexts_after_scale"] = ctx
            # the victim's context died with it; the respawn holds one
            assert ctx["new_contexts"] == FLEET_REPLICAS, ctx
            if ctx["holding"] is not None:
                assert ctx["holding"] == {"respawned": True, "router": False}, ctx
        status, _, body, _ = http_call(
            http.client.HTTPConnection("127.0.0.1", router_port, timeout=60),
            "POST", "/queries.json",
            json.dumps({"user": f"u{users[0]}", "num": 10}).encode())
        assert status == 200

        def critical_firing() -> bool:
            return any(a.get("state") == "firing" and a.get("severity") == "critical"
                       for a in obs_get(router_port, "/alerts.json", key=None)[1]["alerts"])

        critical = [critical_firing()]
        verbs = [["fleet", "watch", "--url", router, "--watch", "0.2", "--watch-count", "2"],
                 ["top", "--url", router, "--once"],
                 ["capacity", "--url", router],
                 ["status", "--url", router, "--no-quality"]]
        got = cli_once(tmp / "cli_home", verbs)
        critical.append(critical_firing())
        out["verbs"] = {v[0] if v[0] != "fleet" else "fleet watch": rc
                        for v, (rc, _, _) in zip(verbs, got)}
        out["verbs"]["critical_alert_firing"] = critical
        for v, (rc, text, err) in zip(verbs[:3], got):
            assert rc == 0, (v, text[-2000:], err[-2000:])
        # status --url: 0 with a healthy replica, unless a critical alert
        # fires (read before and after it, where the two agree)
        if critical[0] == critical[1]:
            assert got[3][0] == int(critical[0]), (got[3][1][-2000:], got[3][2][-2000:])
        assert got[0][1].count("3 replicas, 2 healthy, 2 routable") == 2, got[0][1]
        assert got[1][1].startswith("fleet: 2 replica(s)"), got[1][1]
        assert "fleet:" in got[2][1] and "3 replicas" in got[2][1], got[2][1]
        assert f"WARNING: replica {victim} ejected" in got[3][2], got[3][2]
        assert json.loads(got[3][1])["fleet"] == {"total": 3, "healthy": 2, "routable": 2}

        # stop: POST /stop to the router (`pio undeploy`), every replica too
        live = [p for p in (pio_daemon.read_pidfile(f)
                            for f in (home / "pids").glob("replica-*.pid")) if p]
        ((rc, text, err),) = cli_once(tmp / "cli_home", [
            ["undeploy", "--ip", "127.0.0.1", "--port", str(router_port)]])
        assert rc == 0, err[-2000:]
        assert router_proc.wait(timeout=60) == 0, cli_stderr(router_proc)
        out["stopped"] = {
            "router_exit": router_proc.returncode,
            "pidfiles_left": sorted(p.name for p in (home / "pids").glob("*.pid")),
            "replicas_alive": sum(pio_daemon.pid_alive(p) for p in live),
        }
        assert not out["stopped"]["pidfiles_left"], out["stopped"]
        assert out["stopped"]["replicas_alive"] == 0, out["stopped"]
        router_proc = None

        # (b) kernel 3 behind the router: the phase's own spawner
        class CardSpawner(ReplicaSpawner):
            """Replicas in this process: the port's prediction server at
            max_batch FLEET_WAVE on the card, each its own DeployedEngine behind
            its own HTTP server."""

            def __init__(self):
                self.live: dict = {}

            def spawn(self) -> str:
                server = create_prediction_server(
                    "recommendation", host="127.0.0.1", port=0, storage=storage,
                    engine_instance_id=instance_id, max_batch=FLEET_WAVE,
                    max_queue=0, device=device).start_background()
                url = f"http://127.0.0.1:{server.port}"
                self.live[url] = server
                return url

            def drain(self, url: str) -> None:
                # the generation refcounts and the batcher, as /status.json
                # reports them, then the server goes
                deadline = time.monotonic() + 60
                while True:
                    body = obs_get(int(url.rsplit(":", 1)[1]), "/status.json",
                                   key=None)[1]
                    if not body["inflightGenerations"] and not body["batcherBusy"]:
                        break
                    assert time.monotonic() < deadline, body
                    time.sleep(0.05)
                self.live.pop(url).shutdown()

            def stop_all(self) -> None:
                for url in list(self.live):
                    self.drain(url)

        t0 = time.perf_counter()
        spawner = CardSpawner()
        card_urls = [spawner.spawn() for _ in range(2)]
        fleet_b = FleetState(card_urls, registry=MetricsRegistry())
        fleet_b.probe_once()
        assert len(fleet_b.routable()) == 2
        router_b = AppServer(create_router_app(fleet_b, registry=MetricsRegistry(),
                                               forward_timeout_s=300.0),
                             "127.0.0.1", 0).start_background()
        out["card_replicas_s"] = time.perf_counter() - t0
        homes_b = fleet_homes(card_urls, FLEET_WAVE + 1)
        waves = []
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        for url in card_urls:
            server = spawner.live[url]
            rid = replica_id_of(url)
            hold_user, *wave_users = homes_b[url]
            eff0 = device_obs.default_efficiency().snapshot()["functions"].get(
                "als.fused_topk", {})
            before = read_launches()["fused_topk"]
            t0 = time.perf_counter()
            answers = held_router_burst(server.app.microbatcher, router_b.port,
                                        hold_user, wave_users)
            wall = time.perf_counter() - t0
            eff1 = device_obs.default_efficiency().snapshot()["functions"]["als.fused_topk"]
            assert {a[0] for a in answers} == {200}, {a[0] for a in answers}
            assert {a[1].get(REPLICA_HEADER.lower()) for a in answers} == {rid}
            paths = {server.app.provenance.get(a[1]["x-pio-request-id"])["engine_path"]
                     for a in answers}
            assert paths == {"als.device_topk"}, paths
            checked = hold_answers([a[2]["itemScores"] for a in answers],
                                   wave_users, U, V, 10)
            waves.append({
                "replica": rid, "queries": len(answers), "wall_s": wall,
                "launches": read_launches()["fused_topk"] - before,
                "kernel_ms": 1e3 * (eff1["seconds_total"] - eff0.get("seconds_total", 0.0)),
                "answers_checked_vs_host": checked, "engine_paths": sorted(paths),
            })
            # one launch per replica on the card (a CPU tensor takes the
            # plain version, which counts none)
            assert waves[-1]["launches"] == int(on_card), waves[-1]
        out["launches"] = read_launches()
        # -- end --
        out["card_waves"] = waves
        assert out["launches"]["fused_topk"] == 2 * int(on_card), out["launches"]
        router_b.shutdown()
        router_b = None
        spawner.stop_all()
        spawner = None

        # (c) `pio start-all`, then `pio stop-all`
        stack_store = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(stack_home)}))
        now = datetime.now(tz=timezone.utc)
        stack_store.evaluation_instances().insert(EvaluationInstance(
            id="fleet-eval", status="EVALCOMPLETED", start_time=now, end_time=now,
            evaluation_class="smoke.FleetEval", evaluator_results="best: 0.5",
            evaluator_results_html="<p>0.5</p>", evaluator_results_json='{"best": 0.5}'))
        stack_store.close()
        apps_before = compute_app_pids() if on_card else []
        ports = free_ports(3)
        t0 = time.perf_counter()
        stack_started = True
        ((rc, text, err),) = cli_once(stack_home, [[
            "start-all", "--ip", "127.0.0.1", "--event-port", str(ports[0]),
            "--admin-port", str(ports[1]), "--dashboard-port", str(ports[2])]])
        assert rc == 0, err[-2000:]
        stack_pids = {p.stem: pio_daemon.read_pidfile(p)
                      for p in (stack_home / "pids").glob("*.pid")}
        assert set(stack_pids) == {"eventserver", "adminserver", "dashboard"}, stack_pids
        pages = {name: wait_http(port, "/") for name, port in
                 zip(("eventserver", "adminserver", "dashboard"), ports)}
        out["stack"] = {"start_s": time.perf_counter() - t0,
                        "statuses": {k: v[0] for k, v in pages.items()}}
        assert set(out["stack"]["statuses"].values()) == {200}, out["stack"]
        assert json.loads(pages["adminserver"][1]) == {"status": "alive"}
        assert "fleet-eval" in pages["dashboard"][1] and "smoke.FleetEval" in pages[
            "dashboard"][1]
        if on_card:
            ctx = cuda_contexts(stack_pids, apps_before)
            out["stack"]["cuda_contexts"] = ctx
            assert ctx["new_contexts"] == 0, ctx
            assert ctx["holding"] is None or not any(ctx["holding"].values()), ctx
        ((rc, text, err),) = cli_once(stack_home, [["stop-all"]])
        stack_started = False
        assert rc == 0, err[-2000:]
        out["stack"]["stop_all"] = text.strip().splitlines()
        out["stack"]["pidfiles_left"] = sorted(
            p.name for p in (stack_home / "pids").glob("*.pid"))
        assert not out["stack"]["pidfiles_left"], out["stack"]
        assert not any(pio_daemon.pid_alive(p) for p in stack_pids.values())
        assert read_launches() == out["launches"], "a launch outside the counted run"
    finally:
        if router_b is not None:
            router_b.shutdown()
        if spawner is not None:
            spawner.stop_all()
        if router_proc is not None:
            stop_cli(router_proc)
        if stack_started:
            cli_once(stack_home, [["stop-all"]])
        for pidfile in (home / "pids").glob("*.pid"):
            pio_daemon.stop_pidfile(pidfile, timeout=5.0)
        storage.close()
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# -- the production day: the fixture on the card, then the scripted full day --

#: the phase's expected seconds on the card: (a) 3-8 s (the fixture's
#: train on the card and on the CPU, a deploy of it, 12 queries); (b) the
#: day's 46 s of phases, 8-10 s of parallel replica boots, the flip, 2.5 s
#: of tail, the CLI's start and the ML-20M model written: 60-85 s in all
DAY_EXPECTED_S = (60, 85)
#: the JAX package's FULL_DAY (its tests/test_production_day.py) with only
#: the population widened to ML-20M: the shift's offset is half of it, as 6
#: is half of 12; the rates, bounds, actions and read fractions unchanged
ML20M_FULL_DAY = {
    "name": "ml20m-full-day",
    "num_entities": ML20M_USERS,
    "num_items": ML20M_ITEMS,
    "max_inflight": 48,
    "ingest_max_inflight": 4,
    "phases": [
        {"name": "warm", "duration_s": 6, "qps": 8, "read_frac": 1.0,
         "p99_ms": 5000},
        {"name": "peak", "duration_s": 32, "qps": 20, "read_frac": 0.6,
         "p99_ms": 5000},
        {"name": "shift", "duration_s": 8, "qps": 10, "read_frac": 1.0,
         "p99_ms": 5000, "entity_offset": ML20M_USERS // 2},
    ],
    "actions": [
        {"at_s": 8, "kind": "kill_replica"},
        {"at_s": 12, "kind": "storage_stall", "seconds": 18, "latency_s": 12},
        {"at_s": 40, "kind": "canary_flip"},
    ],
    "slo": {"autoscaler_tolerance": 2},
}
DAY_SEED, DAY_REPLICAS = 7, 2
#: what the day must show: requests scheduled (48 + 640 + 80), the clauses,
#: one bundle per injected fault
DAY_REQUESTS = 768
DAY_CLAUSES = ("phase_p99_bounded", "exactly_once", "flip_coherence",
               "autoscaler_converged", "fault_reconciliation")
DAY_BUNDLES = {"breaker_open": 1, "ingest_shed": 1}
#: the fixture (replay/day.seed_demo_home): 12 users, 2 ALS iterations
DAY_DEMO_USERS, DAY_DEMO_ITERATIONS = 12, 2


def day_fixture(tmp: Path, device: str) -> dict:
    """(a) ``seed_demo_home`` on ``device``: kernel 1's launches (two
    iterations of two half-steps), the train held to the same train on the
    CPU from one start within ALS_RTOL of the factors' scale, and each of
    the 12 users answered 200 by a deploy of it, held to the host answer."""
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.replay.day import seed_demo_home
    from predictionio_tpu_torch.server.prediction_server import create_prediction_server

    t0 = time.perf_counter()
    homes = {"card": tmp / "demo", "cpu": tmp / "demo_cpu"}
    # one start per entity (u<k>, m<k>) at the fixture's rank 4: the two
    # homes store the same events, which may read back in another order
    rng = np.random.default_rng(SEED + 42)
    init_u, init_v = ((np.abs(rng.standard_normal((n, 4))) / 2.0).astype(np.float32)
                      for n in (DAY_DEMO_USERS, 10))
    with entity_seeded_train(rec, init_u, init_v, {}):
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        instance = seed_demo_home(homes["card"], device=device)
        launches = read_launches()
        # -- end --
    with entity_seeded_train(rec, init_u, init_v, {}):
        cpu_instance = seed_demo_home(homes["cpu"], device="cpu")
    out: dict = {"train_s": time.perf_counter() - t0, "launches": launches}
    want = 2 * DAY_DEMO_ITERATIONS if device == "cuda" else 0
    assert launches["als_fused_accum"] == want, launches
    runtimes = {k: StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(h)}))
                for k, h in homes.items()}
    try:
        card = load_factors(runtimes["card"], instance)
        cpu = load_factors(runtimes["cpu"], cpu_instance)
        users, items = sorted(card["user_vocab"]), sorted(card["item_vocab"])
        assert (users, items) == (sorted(cpu["user_vocab"]), sorted(cpu["item_vocab"]))
        assert len(users) == DAY_DEMO_USERS, users
        diff = factor_diff(card, cpu, users, items)
        scale = max(float(np.abs(cpu["user_factors"]).max()),
                    float(np.abs(cpu["item_factors"]).max()))
        out.update(card_vs_cpu_max_abs_diff=diff, factor_scale=scale,
                   tolerance=ALS_RTOL * scale)
        assert diff <= ALS_RTOL * scale, f"fixture: card vs CPU factors differ by {diff}"
        server = create_prediction_server(
            "recommendation", host="127.0.0.1", port=0, storage=runtimes["card"],
            engine_instance_id=instance, device=device).start_background()
        try:
            got = [post_query(server.port, {"user": u, "num": 4}) for u in users]
        finally:
            server.shutdown()
        assert [g[0] for g in got] == [200] * len(users), [g[0] for g in got]
        rows = {u: n for n, u in enumerate(card["user_vocab"])}
        names = list(card["item_vocab"])
        out["answers_checked_vs_host"] = hold_answers(
            [g[1]["itemScores"] for g in got], [rows[u] for u in users],
            card["user_factors"], card["item_factors"], 4,
            item_name=lambda j: names[j])
        out["statuses"] = sorted({g[0] for g in got})
    finally:
        for r in runtimes.values():
            r.close()
    out["fixture_s"] = time.perf_counter() - t0
    return out


def day_phase(device="cuda") -> dict:
    """``day``: the production day on the card.

    (a) The fixture (``day_fixture``): ``replay.day.seed_demo_home(...,
    device=device)``, kernel 1's 4 launches, held to the CPU train from one
    start, and a deploy of it answering all 12 users.

    (b) ``pio day --device <device> --replicas 2 --seed 7`` as a subprocess
    of the port's CLI over ``write_model``'s ML-20M home (an app row for the
    day's writes) with ``ML20M_FULL_DAY``: two ``deploy`` replica daemons on
    the card behind the router, a replica SIGKILLed at 8 s, a storage
    stall on the event store's write seam from 12 s for 18 s, a canary
    flip at 40 s, over 46 s of open-loop traffic.  Exit 0 with all five
    clauses passed, 768 of 768 answered, exactly one ``breaker_open`` and
    one ``ingest_shed`` bundle; 2 new CUDA contexts (the replicas: the day's
    own process holds none) while it runs.  Printed: each phase's client
    and telemetry p50/p99, sheds, retries and device seconds, each
    replica's spawn-to-ready seconds, the schedule digest, each phase's
    wall seconds against its stated seconds, SIGKILL to ejection and the
    flip's seconds.  The day's reads are solo queries, answered by the
    replicas' host replica (below the device floor of 512): the day itself
    launches no kernel."""
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.replay.scenario import Scenario
    from predictionio_tpu_torch.replay.workload import schedule_digest

    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"phase": "day", "expected_s": DAY_EXPECTED_S,
                 "scenario": ML20M_FULL_DAY["name"], "seed": DAY_SEED,
                 "replicas": DAY_REPLICAS,
                 "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "nvidia_smi": nvidia_smi_line() if on_card else None}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    try:
        out["fixture"] = day_fixture(tmp, device)

        # (b) the scripted full day at the ML-20M width
        home = tmp / "home"
        storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(home)}))
        instance_id, _, _ = write_model(storage, tmp, seed=SEED + 70)
        storage.apps().insert(App(id=0, name="ml20m"))
        storage.close()
        scenario_path, report_path = tmp / "scenario.json", tmp / "report.json"
        scenario_path.write_text(json.dumps(ML20M_FULL_DAY))
        schedules = Scenario.from_dict(ML20M_FULL_DAY).build_schedules(DAY_SEED)
        digest = schedule_digest(schedules)
        apps_before = compute_app_pids() if on_card else []
        peak_contexts = [0]
        running = threading.Event()
        running.set()

        def census() -> None:
            while running.is_set():
                peak_contexts[0] = max(peak_contexts[0],
                                       len(compute_app_pids()) - len(apps_before))
                time.sleep(1.0)

        sampler = threading.Thread(target=census, daemon=True)
        if on_card:
            sampler.start()
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "day",
                 "--scenario", f"@{scenario_path}", "--replicas", str(DAY_REPLICAS),
                 "--seed", str(DAY_SEED), "--report", str(report_path),
                 "--incident-dir", str(tmp / "incidents"), "--device", device],
                capture_output=True, text=True, timeout=420,
                env=dict(os.environ, PIO_HOME=str(home)),
                cwd=Path(__file__).resolve().parent,
            )
        finally:
            running.clear()
        out["day_s"] = time.perf_counter() - t0
        if proc.returncode != 0 or not report_path.exists():
            raise AssertionError(
                f"pio day exited {proc.returncode}: {proc.stdout[-4000:]} "
                f"{proc.stderr[-4000:]}")
        report = json.loads(report_path.read_text())
        verdict = report["verdict"]
        clauses = {c["clause"]: c["passed"] for c in verdict["clauses"]}
        recon = next(c for c in verdict["clauses"]
                     if c["clause"] == "fault_reconciliation")
        bundles = {r: len(p) for r, p in recon["evidence"]["bundles"].items()}
        kill = next(a for a in report["actions_run"] if a["kind"] == "kill_replica")
        flip = next(a for a in report["actions_run"] if a["kind"] == "canary_flip")
        ejected = [json.loads(x) for x in proc.stderr.splitlines()
                   if x.startswith("{") and " ejected" in x]
        phases = []
        for row, sched, wall in zip(verdict["phases"], schedules,
                                    report["phase_wall_s"]):
            phases.append({
                "name": row["name"], "scheduled": row["scheduled"],
                "answered": row["answered"], "errors": row["errors"],
                "client_p50_ms": row["p50_ms"], "client_p99_ms": row["p99_ms"],
                "telemetry_p50_ms": row["telemetry_p50_ms"],
                "telemetry_p99_ms": row["telemetry_p99_ms"],
                "p99_bound_ms": row["p99_bound_ms"], "shed": row["shed"],
                "retry_elsewhere_rate": row["retry_elsewhere_rate"],
                "device_s": row["device_s"],
                "wall_s": wall, "expected_s": sched.duration_s})
        out.update(
            exit_code=proc.returncode, clauses=clauses, passed=verdict["pass"],
            requests=verdict["requests"], bundles=bundles, phases=phases,
            schedule_digest=report["schedule_digest"],
            spawn_to_ready_s=report["replica_ready_s"],
            kill_to_ejected_s=(ejected[0]["ts"] - kill["started_wall"]
                               if ejected else None),
            flip_s=flip["done_s"] - flip["started_s"],
            stall_shed=sum(r["shed"] for r in verdict["phases"]),
            actions_run=report["actions_run"],
            new_cuda_contexts=peak_contexts[0] if on_card else None,
        )
        out["day_stdout_tail"] = proc.stdout.splitlines()[-12:]
        assert report["schedule_digest"] == digest, (report["schedule_digest"], digest)
        assert verdict["pass"] is True, out
        assert clauses == {c: True for c in DAY_CLAUSES}, clauses
        assert verdict["requests"] == {"scheduled": DAY_REQUESTS,
                                       "answered": DAY_REQUESTS}, verdict["requests"]
        assert bundles == DAY_BUNDLES, bundles
        assert out["stall_shed"] > 0, phases
        if on_card:
            assert peak_contexts[0] == DAY_REPLICAS, peak_contexts
    finally:
        tmp_dir.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: ``sharded_serving``: the slot counts the ML-20M model binds onto (all on
#: the one card), the waves of known users through ``batch_predict`` on each
#: binding, and the planted tie straddling the 4-slot boundary (6,686 rows a
#: slot: item 6,685 is slot 0's last row, 6,686 slot 1's first), both rows
#: 1.2 times each column's largest entry, so that the answer of every user
#: with positive factors starts with them
SHARD_SLOTS = (4, 3)
SHARD_WAVES = (4096, 512)
SHARD_NUM = 10
SHARD_TIE = (6685, 6686)
#: users u0 .. u7 have their factor rows negated and open every wave and
#: the burst: each of their scores is negative, so on the 3-slot binding
#: (8,915 rows a slot, one row of zero padding past the catalog) a local
#: top-k that ignored ``limit`` would rank the padding row first
SHARD_NEGATED = 8
#: the HTTP burst through the 4-slot deploy (one wave at max_batch)
SHARD_BURST = 1024
#: balanced waves, then waves with the settle seam deferring one slot
SHARD_BALANCED_WAVES = 3
SHARD_STRAGGLER, SHARD_STRAGGLER_S, SHARD_STRAGGLER_WAVES = "cuda:2", 0.05, 3
SHARD_WAVE = 512
#: the NCF table shape of NCF_PRETRAIN (pure GMF, embed 32) and one wave
SHARD_NCF_WAVE = 32


def sharded_serving_phase() -> dict:
    """Factor-sharded serving on the card (``parallel/placement.py``): a
    seeded ML-20M model (138,493 x 26,744, rank 10) with a recorded
    ``ShardPlan``, both factor tables split over slots on ``cuda:0``, each
    slot's top-k through kernel 3 on its own CUDA stream.

    - Waves of 4,096 and 512 known users, num 10, through
      ``ALSAlgorithm.batch_predict`` on the plan bound onto ``[cuda:0] *
      4`` (6,686 rows a slot), then rebound onto ``[cuda:0] * 3``: kernel 3
      launched once per slot per wave, ``LAST_KERNEL_SHAPES`` per slot
      (``rows_local`` below 26,744, fused), every answer held to the host
      top-k of ``U @ V.T`` (``hold_answers``: scores within RTOL, ids equal
      outside near ties), the ids that differ from the unsharded kernel-3
      wave's counted, every answer of a user with positive factors opening
      with the planted tie in id order; the per-slot settle seconds and both
      waves' CUDA-event device time.
    - An in-process deploy binding the plan onto 4 slots
      (``deploy_engine(mesh_devices=...)``), its micro-batcher at
      ``max_batch`` 1,024: a queued burst of 1,024 HTTP queries, every one
      200 and held to the host top-k, the wave meta carrying
      ``wave_shards`` and ``wave_shard_seconds``, ``/shards.json`` naming 4
      slots with bytes and ``/efficiency.json`` its ``shards``.
    - The straggler board: balanced waves (their skews printed; a flag is
      printed, not failed: a finding), then the ``shard.settle`` seam
      deferring ``cuda:2`` by 0.05 s for 3 waves: ``cuda:2`` flagged, its
      ``pio_shard_straggler_total`` 1.
    - NCF at ``NCF_PRETRAIN``'s table shape from seeded parameters, bound
      onto 4 slots: one wave of 32 held to the host top-k of its pure-GMF
      scores (``user_emb @ item_emb.T + item_bias + out_b``).

    Kernel 3 alone at one slot's shape (4,096, 6,686, 10, 10) is timed
    beside its plain version, its bound and ``torch.topk(q @ t.T)``, after
    the counted run."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )
    from predictionio_tpu_torch.models.ncf import engine as ncf_engine
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.obs import device as device_obs
    from predictionio_tpu_torch.obs.metrics import REGISTRY
    from predictionio_tpu_torch.ops import ncf as ncf_ops
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.parallel import placement
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server_app,
        deploy_engine,
    )

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 70)
    U = (np.abs(rng.standard_normal((ML20M_USERS, RANK))) / np.sqrt(RANK)).astype(np.float32)
    V = (np.abs(rng.standard_normal((ML20M_ITEMS, RANK))) / np.sqrt(RANK)).astype(np.float32)
    V[list(SHARD_TIE)] = 1.2 * V.max(axis=0)
    U[:SHARD_NEGATED] *= -1
    algo = rec.ALSAlgorithm(rec.ALSAlgorithmParams(rank=RANK, shard_serving=True))
    blob = algo.make_persistent_model(None, rec.ALSModel.from_jax_params({
        "user_factors": U, "item_factors": V,
        "user_vocab": np.array([f"u{i}" for i in range(ML20M_USERS)]),
        "item_vocab": np.array([f"i{i}" for i in range(ML20M_ITEMS)]),
    }, "cpu"))
    plan = placement.ShardPlan.from_dict(blob["shard_plan"])
    plain = algo.load_persistent_model(EngineContext(device="cuda"), blob)
    assert plain.shards is None  # one card, default slots: unsharded
    model = algo.load_persistent_model(
        EngineContext(device="cuda", mesh_devices=[card] * SHARD_SLOTS[0]), blob)
    assert model.shards.mesh.shape == {"model": SHARD_SLOTS[0]}
    negated = np.arange(SHARD_NEGATED)

    def draw(n):
        return np.concatenate([negated, rng.integers(SHARD_NEGATED, ML20M_USERS,
                                                     n - SHARD_NEGATED)])

    wave_users = {n: draw(n) for n in SHARD_WAVES}
    tie = [f"i{SHARD_TIE[0]}", f"i{SHARD_TIE[1]}"]

    def queries(users, num=SHARD_NUM):
        return [(j, rec.Query(user=f"u{u}", num=num)) for j, u in enumerate(users)]

    def scores(answers):
        return [[{"item": x.item, "score": x.score} for x in a.item_scores]
                for _, a in answers]

    def items(answers):
        return np.array([[x.item for x in a.item_scores] for _, a in answers])

    # the unsharded kernel-3 waves (outside the counted run)
    want = {n: items(algo.batch_predict(plain, queries(u))) for n, u in wave_users.items()}
    # the plan rebound onto 3 slots, and one wave of each size on each
    # binding before the counted run (its first waves pay for the slots'
    # new streams and the sorts' first allocations)
    bindings = {SHARD_SLOTS[0]: model.shards, SHARD_SLOTS[1]: placement.bind_shards(
        plan, {"user_factors": U, "item_factors": V}, devices=[card] * SHARD_SLOTS[1])}
    for slots in SHARD_SLOTS:
        model.shards = bindings[slots]
        for users in wave_users.values():
            algo.batch_predict(model, queries(users))
    ms_plain = {}
    for n, users in wave_users.items():
        with device_obs.wave_timeline() as tl:
            algo.batch_predict(plain, queries(users))
        ms_plain[n] = 1e3 * tl.kernel_s

    # the deploy of the same blob onto 4 slots
    tmp = tempfile.TemporaryDirectory()
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": tmp.name + "/pio_home"}))
    instance_id = persist_instance(
        storage, "recommendation", "sharded",
        EngineParams(datasource=("", rec.DataSourceParams(app_name="ml20m")),
                     algorithms=(("als", rec.ALSAlgorithmParams(
                         rank=RANK, shard_serving=True)),),
                     serving=("", None)),
        blob)
    deployed = deploy_engine("recommendation", storage=storage,
                             engine_instance_id=instance_id, device=card,
                             mesh_devices=[card] * SHARD_SLOTS[0])
    binding = deployed.live_binding()
    dep_algo, dep_model = binding.algorithms[0], binding.models[0]
    assert dep_model.shards.n_shards == SHARD_SLOTS[0]
    app = create_prediction_server_app(
        deployed, use_microbatch=True, max_batch=SHARD_BURST,
        max_queue=2 * SHARD_BURST)
    batcher = app.microbatcher
    metas: list = []
    real_submit = batcher.submit

    async def submit(item, meta=None):
        if meta is not None:
            metas.append(meta)
        return await real_submit(item, meta)

    batcher.submit = submit
    server = AsyncAppServer(app, "127.0.0.1", 0).start_background()
    burst_users = [int(u) for u in draw(SHARD_BURST)]
    straggler_fam = REGISTRY.get("pio_shard_straggler_total")
    out: dict = {"phase": "sharded_serving", "shape": [ML20M_USERS, ML20M_ITEMS, RANK],
                 "physical_devices": len(model.shards.mesh.physical_devices),
                 "tie": list(SHARD_TIE)}
    try:
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        waves = []
        for slots in SHARD_SLOTS:
            model.shards = bindings[slots]
            labels = [f"cuda:{i}" for i in range(slots)]
            for n, users in wave_users.items():
                before = topk.KERNEL_LAUNCHES["fused_topk"]
                with device_obs.wave_timeline() as tl:
                    t0 = time.perf_counter()
                    answers = algo.batch_predict(model, queries(users))
                    host_s = time.perf_counter() - t0
                launched = topk.KERNEL_LAUNCHES["fused_topk"] - before
                shapes = dict(placement.LAST_KERNEL_SHAPES["als.sharded_topk"])
                assert launched == slots, (slots, n, launched)
                assert shapes["fused"] == 1 and shapes["n_shards"] == slots, shapes
                assert shapes["rows_local"] < ML20M_ITEMS, shapes
                assert sorted(tl.shard_seconds) == labels, tl.shard_seconds
                assert sorted(tl.shards) == labels, tl.shards
                hold_answers(scores(answers), users, U, V, SHARD_NUM)
                assert all([x.item for x in a.item_scores[:2]] == tie
                           for _, a in answers[SHARD_NEGATED:]), "the tie across the boundary"
                waves.append({
                    "slots": slots, "queries": n, "launches": launched,
                    "shapes": shapes,
                    "near_tie_id_swaps_vs_unsharded": int((items(answers) != want[n]).sum()),
                    "settle_s": tl.shard_seconds,
                    "shard_bytes": {k: v["bytes"] for k, v in tl.shards.items()},
                    "sharded_wave_device_ms": 1e3 * tl.kernel_s,
                    "unsharded_wave_device_ms": ms_plain[n],
                    "batch_predict_s": host_s,
                })
        waves_launched = topk.KERNEL_LAUNCHES["fused_topk"]

        # the HTTP burst through the 4-slot deploy
        t0 = time.perf_counter()
        results = held_http_burst(batcher, server.port, burst_users, None)
        out["burst_s"] = time.perf_counter() - t0
        http_launched = topk.KERNEL_LAUNCHES["fused_topk"] - waves_launched

        # the straggler board: balanced waves, then one slot deferred
        device_obs.STRAGGLERS.clear()
        wave_q = queries(wave_users[SHARD_WAVE])
        balanced = []
        for _ in range(SHARD_BALANCED_WAVES):
            dep_algo.batch_predict(dep_model, wave_q)
            board = device_obs.STRAGGLERS.snapshot()["functions"]["als.sharded_topk"]
            balanced.append({"skew": board["last_skew"],
                             "slowest": board["last_max_device"],
                             "straggler": board["straggler"]})
        faults.install([{"seam": "shard.settle", "kind": "latency",
                         "latency_s": SHARD_STRAGGLER_S, "match": SHARD_STRAGGLER}])
        injected = []
        try:
            for _ in range(SHARD_STRAGGLER_WAVES):
                dep_algo.batch_predict(dep_model, wave_q)
                board = device_obs.STRAGGLERS.snapshot()["functions"]["als.sharded_topk"]
                injected.append({"skew": board["last_skew"],
                                 "slowest": board["last_max_device"],
                                 "straggler": board["straggler"]})
        finally:
            faults.clear()

        # NCF: seeded parameters at NCF_PRETRAIN's table shape
        ncf_algo = ncf_engine.NCFAlgorithm(ncf_engine.NCFAlgorithmParams(
            embed_dim=NCF_PRETRAIN["embed_dim"], mlp_layers=(), shard_serving=True))
        scale = 1.0 / np.sqrt(NCF_PRETRAIN["embed_dim"])
        ncf_blob = {
            "params": {
                "user_emb": (rng.standard_normal((ML20M_USERS, NCF_PRETRAIN["embed_dim"]))
                             * scale).astype(np.float32),
                "item_emb": (rng.standard_normal((ML20M_ITEMS, NCF_PRETRAIN["embed_dim"]))
                             * scale).astype(np.float32),
                "mlp": [],
                "out_b": np.zeros(1, np.float32),
                "item_bias": (0.1 * rng.standard_normal(ML20M_ITEMS)).astype(np.float32),
            },
            "n_users": ML20M_USERS, "n_items": ML20M_ITEMS,
            "config": dataclasses.asdict(ncf_ops.NCFParams(
                embed_dim=NCF_PRETRAIN["embed_dim"], mlp_layers=())),
            "user_vocab": blob["user_vocab"], "item_vocab": blob["item_vocab"],
        }
        ncf_plain = ncf_algo.load_persistent_model(EngineContext(device="cuda"), ncf_blob)
        ncf_blob["shard_plan"] = ncf_algo.serving_shard_plan(ncf_plain).to_dict()
        ncf_sharded = ncf_algo.load_persistent_model(
            EngineContext(device="cuda", mesh_devices=[card] * SHARD_SLOTS[0]), ncf_blob)
        ncf_users = wave_users[SHARD_WAVE][:SHARD_NCF_WAVE]
        ncf_got = ncf_algo.batch_predict(ncf_sharded, queries(ncf_users))
        ncf_shapes = dict(placement.LAST_KERNEL_SHAPES["ncf.sharded_topk"])
        launches = read_launches()
        # -- end --
        # pure GMF is a product of tables with one more column: ones on the
        # user side, item_bias + out_b on the item side
        p = ncf_blob["params"]
        ncf_U = np.hstack([p["user_emb"], np.ones((ML20M_USERS, 1), np.float32)])
        ncf_V = np.hstack([p["item_emb"], (p["item_bias"] + p["out_b"][0])[:, None]])
        ncf_want = items(ncf_algo.batch_predict(ncf_plain, queries(ncf_users)))
        out["ncf"] = {"table": [ML20M_USERS, ML20M_ITEMS, NCF_PRETRAIN["embed_dim"]],
                      "queries": len(ncf_users), "shapes": ncf_shapes,
                      "answers_checked_vs_host": hold_answers(
                          scores(ncf_got), ncf_users, ncf_U, ncf_V, SHARD_NUM),
                      "near_tie_id_swaps_vs_unsharded": int((items(ncf_got) != ncf_want).sum())}
        assert ncf_shapes["n_shards"] == SHARD_SLOTS[0] and ncf_shapes["fused"] == 0

        statuses = [r[0] for r in results]
        non200 = sum(1 for x in statuses if x != 200)
        assert non200 == 0, statuses
        burst_checked = hold_answers([json.loads(r[2])["itemScores"] for r in results],
                                     burst_users, U, V, SHARD_NUM)
        by_wave: dict = {}
        for m in metas:
            by_wave.setdefault(m.get("wave_seq"), m)
        burst_wave = max(by_wave.values(), key=lambda m: m.get("wave_size", 0))
        st, shards_body = obs_get(server.port, "/shards.json", None)
        est, eff_body = obs_get(server.port, "/efficiency.json", None)
    finally:
        batcher.close()
        server.shutdown()
        storage.close()
        tmp.cleanup()
    slot_labels = [f"cuda:{i}" for i in range(SHARD_SLOTS[0])]
    assert burst_wave["wave_size"] == SHARD_BURST, burst_wave
    assert sorted(burst_wave["wave_shards"]) == slot_labels, burst_wave
    assert sorted(burst_wave["wave_shard_seconds"]) == slot_labels, burst_wave
    fn_shards = shards_body["shards"]["functions"]["als.sharded_topk"]
    assert st == 200 and sorted(fn_shards) == slot_labels, shards_body
    assert all(e["bytes"] > 0 for e in fn_shards.values()), fn_shards
    assert est == 200 and set(slot_labels) <= set(eff_body["shards"]["devices"]), eff_body
    assert injected[-1]["straggler"] == SHARD_STRAGGLER, injected
    flagged = straggler_fam.labels("als.sharded_topk", SHARD_STRAGGLER).value
    assert flagged == 1, flagged
    # one launch per slot of every sharded wave of the counted run: the
    # waves above, the burst's (its held first query's wave too), the
    # balanced and the deferred ones; NCF's slots score with torch ops
    http_waves = {m["wave_seq"] for m in metas if m.get("wave_fn") == "als.sharded_topk"}
    assert http_launched == SHARD_SLOTS[0] * len(http_waves), (http_launched, http_waves)
    want_launches = waves_launched + http_launched + (
        SHARD_BALANCED_WAVES + SHARD_STRAGGLER_WAVES) * SHARD_SLOTS[0]
    assert launches["fused_topk"] == want_launches, (launches, want_launches)

    # kernel 3 alone at one slot's shape, and the sharded wave's device
    # compute (the 4-slot binding's cached top-k, built by the waves above)
    # beside the unsharded kernel's at the 4,096-query wave
    rows_local = -(-ML20M_ITEMS // SHARD_SLOTS[0])
    shard_t = time_case(WAVE, rows_local, RANK, SHARD_NUM, rng)
    bound = bindings[SHARD_SLOTS[0]]
    q_rows = torch.from_numpy(U[wave_users[WAVE]]).to(card)
    k_pad = 16
    fn = bound.kernel((WAVE, k_pad), None)
    items_dev = bound.arrays["item_factors"]
    V_dev = plain.item_factors
    out.update({
        "waves": waves,
        "burst": {"queries": SHARD_BURST, "non_200": non200, "wall_s": out.pop("burst_s"),
                  "answers_checked_vs_host": burst_checked, "waves": len(http_waves),
                  "launches": http_launched,
                  "wave": {k: burst_wave.get(k) for k in (
                      "wave_size", "wave_fn", "wave_shards", "wave_shard_seconds",
                      "wave_kernel_s", "device_s")}},
        "shards_json": fn_shards,
        "efficiency_shards_devices": eff_body["shards"]["devices"],
        "stragglers": {"threshold": device_obs.STRAGGLERS.skew_threshold,
                       "patience": device_obs.STRAGGLERS.patience,
                       "balanced": balanced,
                       "balanced_flagged": any(w["straggler"] for w in balanced),
                       "injected": injected,
                       "straggler_total": flagged},
        "launches": launches,
        "launches_sharded": launches["fused_topk"],
        "shard_kernel": shard_t,
        "sharded_compute_ms": time_ms(lambda: fn(items_dev, q_rows).packed),
        "unsharded_kernel_ms": time_ms(
            lambda: topk.fused_topk_batch(q_rows, V_dev, k_pad, name="chip_smoke")),
        "compute_shape": [WAVE, ML20M_ITEMS, RANK, k_pad],
    })
    out["phase_s"] = time.perf_counter() - t_phase
    out["nvidia_smi"] = nvidia_smi_line()
    return out


# -- pio check and the S3 model store ------------------------------------------

#: the recommendation template with one miswiring, as a user's engine
#: module would carry it: its ALS params alias ``numIterations`` to a field
#: that does not exist
MISWIRED_MODULE = """\
import dataclasses

from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.models.recommendation import engine as rec


@dataclasses.dataclass(frozen=True)
class TypoParams(rec.ALSAlgorithmParams):
    params_aliases = {**rec.ALSAlgorithmParams.params_aliases,
                      "numIterations": "num_iteration"}


class TypoALS(rec.ALSAlgorithm):
    params_class = TypoParams


def factory():
    e = rec.recommendation_engine()
    return Engine(e.datasource_classes, e.preparator_classes, {"als": TypoALS},
                  e.serving_classes)
"""
CHECK_BASELINE = "predictionio_tpu_torch/.pio-check-baseline.json"

#: a user's engine module built from the port's exported names: the
#: recommendation template's data source (indexing its ratings at read, so
#: the identity preparator passes them on) and ALS, with the core's first
#: serving, behind an ``EngineFactory`` that ``pio train --engine
#: chip_custom_rec:Factory`` resolves to its ``apply``
CUSTOM_ENGINE_MODULE = """\
from predictionio_tpu_torch.core import (
    Engine,
    EngineFactory,
    FirstServing,
    IdentityPreparator,
)
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithm,
    RatingsDataSource,
    RatingsPreparator,
)


class IndexedRatings(RatingsDataSource):
    def read_training(self, ctx):
        return RatingsPreparator().prepare(ctx, super().read_training(ctx))


class Factory(EngineFactory):
    @classmethod
    def apply(cls):
        return Engine({"": IndexedRatings}, {"": IdentityPreparator},
                      {"als": ALSAlgorithm}, {"": FirstServing})
"""

#: synthetic BENCH lines for ``pio bench --compare``: the previous run, one
#: within the 10 % tolerance, one past it, and one at an older schema
BENCH_PREVIOUS = {"metric": "chip_smoke", "value": 100.0,
                  "serving_p50_ms": 2.0, "map_at_10": 0.2}
BENCH_CURRENT = {
    "within": {"value": 104.0, "serving_p50_ms": 1.9, "map_at_10": 0.21},
    "regressed": {"value": 125.0, "serving_p50_ms": 2.0, "map_at_10": 0.2},
}


def check_cli(cli, argv: list) -> tuple[int, str, str, float]:
    """(exit code, stdout, stderr, seconds) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def check_phase() -> dict:
    """``pio check`` and the DASE pre-flight, in a process of its own: a
    ``pio train`` of a miswired copy of the recommendation template exits 1
    with the DASE message before any device is resolved (no CUDA context,
    no launch); the port's self-gate (``pio check predictionio_tpu_torch``
    against its baseline) exits 0 cold, then warm from the check cache;
    ``pio check --engine all`` exits 0; and CUDA is still untouched.  Then
    ``pio train`` of the well-wired template at the ML-100K cut with
    ``PIO_PREFLIGHT_LINT=1``: the pre-flight's time and kernel 1's 40
    launches."""
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
    from predictionio_tpu_torch.tools import cli

    out: dict = {"phase": "check", "shape": [ML100K_USERS, ML100K_ITEMS,
                                             CUT_ML100K_EVENTS],
                 "reduced": {"ml100k_events": [ML100K_EVENTS, CUT_ML100K_EVENTS]},
                 "nvidia_smi": nvidia_smi_line()}
    assert not torch.cuda.is_initialized()
    repo = Path(__file__).resolve().parent
    os.environ.pop("PIO_PREFLIGHT_LINT", None)  # the miswired train: no lint
    with tempfile.TemporaryDirectory() as tmp, scoped_env(
        PIO_HOME=str(Path(tmp) / "pio_home")
    ):
        tmp = Path(tmp)
        storage = reset_storage(
            StorageConfig.from_env({"PIO_HOME": str(tmp / "pio_home")})
        )
        (tmp / "chip_miswired_rec.py").write_text(MISWIRED_MODULE)
        sys.path.insert(0, str(tmp))
        try:
            # -- the miswired train, with every launch count at 0 before it --
            reset_launches()
            rc, _, err, secs = check_cli(
                cli, ["train", "--engine", "chip_miswired_rec:factory"])
            launches = read_launches()
            # -- end --
        finally:
            sys.path.remove(str(tmp))
        assert rc == 1, (rc, err)
        assert "PIO-DASE003" in err and "'num_iteration'" in err, err
        assert "DASE pre-flight failed for engine 'chip_miswired_rec:factory'" in err
        assert not torch.cuda.is_initialized(), "the pre-flight touched CUDA"
        assert not any(launches.values()), launches
        out["miswired_train"] = {"exit": rc, "s": secs, "launches": launches,
                                 "message": err.strip().splitlines()[-1]}

        gate = ["check", "predictionio_tpu_torch", "--baseline", CHECK_BASELINE,
                "--format", "json", "--stats"]
        cwd = os.getcwd()
        os.chdir(repo)
        try:
            runs = [check_cli(cli, gate) for _ in range(2)]
            rc_all, all_out, _, all_s = check_cli(cli, ["check", "--engine", "all"])
        finally:
            os.chdir(cwd)
        for (rc, text, err, _), what in zip(runs, ("cold", "warm")):
            assert rc == 0, (what, rc, text[-2000:])
        cold, warm = (json.loads(r[1])["summary"] for r in runs)
        n = cold["files_scanned"]
        assert cold == warm and cold["total"] == 0 and cold["errors"] == 0, cold
        assert f"cache: 0 hit(s), {n} miss(es)" in runs[0][2], runs[0][2]
        assert f"cache: {n} hit(s), 0 miss(es)" in runs[1][2], runs[1][2]
        assert rc_all == 0 and "0 finding(s)" in all_out, all_out[-2000:]
        assert not torch.cuda.is_initialized(), "pio check touched CUDA"
        out["self_gate"] = {
            "files_scanned": n, "baseline_suppressed": cold["baseline_suppressed"],
            "pragma_suppressed": cold["pragma_suppressed"],
            "cold_s": runs[0][3], "warm_s": runs[1][3],
            "cache_cold": runs[0][2].strip(), "cache_warm": runs[1][2].strip(),
            "engine_all_s": all_s,
        }
        print(f"pio check predictionio_tpu_torch: {n} files, cold "
              f"{runs[0][3]:.3f} s, warm {runs[1][3]:.3f} s ({nvidia_smi_line()})",
              flush=True)

        # the well-wired template at the ML-100K cut, the advisory lint on
        write_ml100k(tmp / "ratings.jsonl", CUT_ML100K_EVENTS)
        (tmp / "engine.json").write_text(json.dumps({
            "id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"appName": "ml100k"}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS, "lambda": 0.01,
                "seed": 3}}],
        }))
        timed: list = []
        real = cli._dase_preflight

        def preflight(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                timed.append(time.perf_counter() - t0)

        assert check_cli(cli, ["app", "new", "ml100k"])[0] == 0
        assert check_cli(cli, ["import", "--app", "ml100k", "--input",
                               str(tmp / "ratings.jsonl")])[0] == 0
        cli._dase_preflight = preflight
        os.environ["PIO_PREFLIGHT_LINT"] = "1"
        try:
            # -- the main path, with every launch count at 0 just before it --
            reset_launches()
            rc, text, err, secs = check_cli(
                cli, ["train", "--engine-json", str(tmp / "engine.json")])
            launches = read_launches()
            # -- end of the main path --
        finally:
            cli._dase_preflight = real
            os.environ.pop("PIO_PREFLIGHT_LINT", None)
        assert rc == 0, (rc, err[-2000:])
        assert "pre-flight lint (advisory):" in err, err[-2000:]
        assert launches["als_fused_accum"] == 2 * ITERATIONS, launches
        instance_id = text.split("Engine instance: ")[1].split()[0]
        (blob,) = load_models(storage.models(), instance_id)
        assert np.isfinite(blob["user_factors"]).all()
        assert np.isfinite(blob["item_factors"]).all()
        out["train"] = {"s": secs, "preflight_ms": 1e3 * timed[0],
                        "advisory": [x for x in err.splitlines()
                                     if x.startswith("pre-flight lint")][0],
                        "launches": launches, "instance": instance_id}
        print(f"train pre-flight (DASE + cached advisory lint): "
              f"{1e3 * timed[0]:.3f} ms; kernel 1 launches "
              f"{launches['als_fused_accum']} ({nvidia_smi_line()})", flush=True)
        out["custom_engine"] = custom_engine_hold(cli, tmp, storage, blob)
        out["custom_engine"]["bench_compare"] = bench_compare_hold(cli, tmp)
        storage.close()
    return out


def custom_engine_hold(cli, tmp: Path, storage, blob: dict) -> dict:
    """``CUSTOM_ENGINE_MODULE`` through the CLI on ``check``'s ML-100K app:
    ``pio train --engine chip_custom_rec:Factory`` with the template
    train's engine params, its factors equal bit for bit to ``blob`` (the
    template's), then ``pio batchpredict`` of every known user through that
    instance, every answer held to the host top-k.  Kernel 1 runs
    2 x ITERATIONS times and kernel 3 once, over a wave of at least
    ``DEVICE_BATCH_MIN`` users."""
    from predictionio_tpu_torch.core.persistence import load_models
    from predictionio_tpu_torch.models.recommendation.engine import ALSAlgorithm
    from predictionio_tpu_torch.ops.topk import host_topk_batch

    factory = "chip_custom_rec:Factory"
    (tmp / "chip_custom_rec.py").write_text(CUSTOM_ENGINE_MODULE)
    variant = json.loads((tmp / "engine.json").read_text())
    (tmp / "custom.json").write_text(json.dumps(
        {**variant, "id": "custom", "engineFactory": factory}))
    users = sorted(blob["user_vocab"], key=lambda s: int(s[1:]))
    (tmp / "custom_q.jsonl").write_text("".join(
        json.dumps({"user": str(x), "num": 10}) + "\n" for x in users))
    out: dict = {"factory": factory, "wave": len(users)}
    assert len(users) >= ALSAlgorithm.DEVICE_BATCH_MIN, len(users)
    sys.path.insert(0, str(tmp))
    try:
        # -- the main path, with every launch count at 0 just before it --
        reset_launches()
        rc, text, err, out["train_s"] = check_cli(
            cli, ["train", "--engine", factory, "--engine-json",
                  str(tmp / "custom.json")])
        train_launches = read_launches()
        assert rc == 0, (rc, err[-2000:])
        instance_id = text.split("Engine instance: ")[1].split()[0]
        reset_launches()
        rc, _, err, out["batchpredict_s"] = check_cli(
            cli, ["batchpredict", "--engine", factory, "--engine-instance-id",
                  instance_id, "--input", str(tmp / "custom_q.jsonl"),
                  "--output", str(tmp / "custom_p.jsonl")])
        wave_launches = read_launches()
        # -- end of the main path --
        assert rc == 0, (rc, err[-2000:])
    finally:
        sys.path.remove(str(tmp))
    record = storage.engine_instances().get(instance_id)
    assert record.engine_factory == factory, record.engine_factory
    (custom,) = load_models(storage.models(), instance_id)
    for key in ("user_factors", "item_factors", "user_vocab", "item_vocab"):
        assert np.array_equal(custom[key], blob[key]), f"{key} differs"
    U, V = custom["user_factors"], custom["item_factors"]
    uvocab = {k: n for n, k in enumerate(custom["user_vocab"])}
    ivocab = list(custom["item_vocab"])

    def host(user):  # a wave of one, as the micro-batched server answers
        s, idx = host_topk_batch(U[[uvocab[str(user)]]] @ V.T, 10)
        return [ivocab[j] for j in idx[0]], [float(x) for x in s[0]]

    lines = [json.loads(x) for x in
             (tmp / "custom_p.jsonl").read_text().splitlines()]
    assert len(lines) == len(users), (len(lines), len(users))
    out["rows_checked_vs_host"] = check_wave_lines(
        lines, users, host, range(len(users)))
    out["train_launches"] = train_launches
    out["wave_launches"] = wave_launches
    out["instance"] = instance_id
    out["factors_bit_equal"] = True
    assert train_launches["als_fused_accum"] == 2 * ITERATIONS, train_launches
    assert wave_launches["fused_topk"] == 1, wave_launches
    print(f"custom engine {factory}: train {out['train_s']:.3f} s, kernel 1 "
          f"launches {train_launches['als_fused_accum']}; batchpredict of "
          f"{len(users)} users {out['batchpredict_s']:.3f} s, kernel 3 "
          f"launches {wave_launches['fused_topk']} ({nvidia_smi_line()})",
          flush=True)
    return out


def bench_compare_hold(cli, tmp: Path) -> dict:
    """``pio bench --compare`` over ``BENCH_PREVIOUS`` and each current
    line of ``BENCH_CURRENT``, one read from stdin, and an old schema:
    exits 0 within tolerance, 1 past it, 2 on the old schema."""
    from predictionio_tpu_torch.obs.device import BENCH_SCHEMA_VERSION

    def line(d: dict, version: int = BENCH_SCHEMA_VERSION) -> str:
        return json.dumps({**BENCH_PREVIOUS, **d, "schema_version": version})

    prev = tmp / "bench_prev.json"
    prev.write_text(line({}) + "\n")
    files = {name: tmp / f"bench_{name}.json" for name in BENCH_CURRENT}
    for name, path in files.items():
        # a captured run: stray text first, the last JSON object line wins
        path.write_text("bench: done\n" + line(BENCH_CURRENT[name]) + "\n")
    old = tmp / "bench_old.json"
    old.write_text(line(BENCH_CURRENT["within"], BENCH_SCHEMA_VERSION - 1) + "\n")
    exits = {name: check_cli(cli, ["bench", "--compare", str(prev), str(path)])[0]
             for name, path in files.items()}
    exits["old_schema"] = check_cli(cli, ["bench", "--compare", str(prev), str(old)])[0]
    stdin = sys.stdin
    sys.stdin = io.StringIO(line(BENCH_CURRENT["regressed"]))
    try:
        rc, text, _, _ = check_cli(cli, ["bench", "--compare", str(prev)])
    finally:
        sys.stdin = stdin
    exits["regressed_stdin"] = rc
    assert exits == {"within": 0, "regressed": 1, "old_schema": 2,
                     "regressed_stdin": 1}, exits
    assert json.loads(text)["regressions"][0]["metric"] == "value", text
    return exits


class MemoryS3:
    """An in-memory object store with boto3's S3 client shape
    (put/get/delete_object and ``exceptions.NoSuchKey``), injected as the
    S3 model store's client: the card's host has no network."""

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
        if Range:
            a, b = Range.removeprefix("bytes=").split("-")
            body = body[int(a):int(b) + 1]
        return {"Body": body}

    def delete_object(self, Bucket, Key):
        self.objects.pop(f"{Bucket}/{Key}", None)


def s3_serving_phase(U: np.ndarray, V: np.ndarray) -> dict:
    """The ML-20M instance ``train_ml20m`` trained, persisted through the
    port's ``S3Models`` (``TYPE=s3`` over ``MemoryS3``) and through sqlite
    under one engine instance; deployed from S3, one WAVE-query wave of
    known users through kernel 3 (one launch), held to the host top-k, and
    equal bit for bit to the same instance deployed from sqlite."""
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage import s3_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance
    from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.server.prediction_server import deploy_engine

    out: dict = {"phase": "check_s3", "shape": [WAVE, ML20M_ITEMS, RANK, 10],
                 "nvidia_smi": nvidia_smi_line()}
    client = MemoryS3()
    real_client = s3_models._make_boto3_client
    s3_models._make_boto3_client = lambda region, endpoint: client
    with tempfile.TemporaryDirectory() as tmp:
        env = {
            "PIO_HOME": str(Path(tmp) / "pio_home"),
            "PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_DB_PATH": str(Path(tmp) / "pio.sqlite"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
        }
        s3_env = {**env, "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S3",
                  "PIO_STORAGE_SOURCES_S3_TYPE": "s3",
                  "PIO_STORAGE_SOURCES_S3_BUCKET": "pio-models",
                  "PIO_STORAGE_SOURCES_S3_PREFIX": "ml20m/"}
        sql = StorageRuntime(StorageConfig.from_env(env))
        s3 = StorageRuntime(StorageConfig.from_env(s3_env))
        try:
            assert isinstance(s3.models(), s3_models.S3Models)
            blob = {
                "user_factors": U, "item_factors": V,
                "user_vocab": np.array([f"u{i}" for i in range(len(U))]),
                "item_vocab": np.array([f"i{i}" for i in range(len(V))]),
            }
            params = EngineParams(
                datasource=("", rec.DataSourceParams(app_name="ml20m")),
                algorithms=(("als", rec.ALSAlgorithmParams(rank=RANK)),),
                serving=("", None),
            )
            now = datetime.now(tz=timezone.utc)
            instance = EngineInstance(
                id=uuid.uuid4().hex, status="COMPLETED", start_time=now,
                end_time=now, engine_id="default", engine_version="default",
                engine_variant="default", engine_factory="recommendation",
                **params.to_json_fields(),
            )
            sql.engine_instances().insert(instance)
            t0 = time.perf_counter()
            save_models(s3.models(), instance.id, [blob])
            out["s3_save_s"] = time.perf_counter() - t0
            save_models(sql.models(), instance.id, [blob])
            out["objects"] = len(client.objects)
            out["bytes"] = sum(len(b) for b in client.objects.values())
            out["keys"] = sorted(k.split("/", 1)[1] for k in client.objects)[:4]
            print(f"S3Models: {out['objects']} objects, {out['bytes']} bytes, "
                  f"saved in {out['s3_save_s']:.3f} s ({nvidia_smi_line()})",
                  flush=True)
            users = np.random.default_rng(SEED + 30).integers(0, len(U), WAVE)
            queries = [(j, rec.Query(user=f"u{u}", num=10))
                       for j, u in enumerate(users)]

            # -- the main path, with every launch count at 0 just before it --
            reset_launches()
            t0 = time.perf_counter()
            from_s3 = deploy_engine("recommendation", storage=s3,
                                    engine_instance_id=instance.id)
            torch.cuda.synchronize()
            out["s3_deploy_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = from_s3.algorithms[0].batch_predict(from_s3.models[0], queries)
            torch.cuda.synchronize()
            out["wave_s"] = time.perf_counter() - t0
            launches = read_launches()
            # -- end of the main path --
            assert launches["fused_topk"] == 1, launches
            out["launches"] = launches
            from_sql = deploy_engine("recommendation", storage=sql,
                                     engine_instance_id=instance.id)
            for name in ("user_factors", "item_factors"):
                a = getattr(from_s3.models[0], name)
                b = getattr(from_sql.models[0], name)
                assert a.is_cuda and torch.equal(
                    a.view(torch.int32), b.view(torch.int32)), name
            want = from_sql.algorithms[0].batch_predict(from_sql.models[0], queries)
            assert [j for j, _ in got] == [j for j, _ in want] == list(range(WAVE))
            for (_, a), (_, b) in zip(got, want):
                assert [(x.item, x.score) for x in a.item_scores] == [
                    (x.item, x.score) for x in b.item_scores]
            out["bit_equal_to_sqlite"] = WAVE

            def host(user):
                return host_answer(U, V, int(user[1:]), 10)

            lines = [{"prediction": {"itemScores": [
                {"item": x.item, "score": x.score} for x in r.item_scores]}}
                for _, r in got]
            rows = np.random.default_rng(SEED + 31).choice(WAVE, 64, replace=False)
            out["rows_checked_vs_host"] = check_wave_lines(
                lines, [f"u{u}" for u in users], host, rows)
        finally:
            s3_models._make_boto3_client = real_client
            s3.close()
            sql.close()
    return out


def phase_in_own_process(name: str) -> dict:
    """``name``'s line from a fresh ``python3`` process of this script (the
    kernels already built load from the build directory).  Its stdout and
    stderr pass through; it fails when the phase fails.  ``watch`` runs
    so: on the card's hosts a ``torch.profiler`` CUDA capture in this
    process, ten minutes and ten captures into the script, recorded no
    device event at all in three of four runs (the unchanged parent's
    too), while the same phase in a process of its own captured its
    kernel."""
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke as c, torch; torch.backends.cuda.matmul.allow_tf32 = False; "
         f"torch.backends.cudnn.allow_tf32 = False; c.emit(c.{name}())"],
        capture_output=True, text=True, timeout=900,
        cwd=Path(__file__).resolve().parent,
    )
    sys.stderr.write(proc.stderr)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode != 0 or not lines:
        sys.stdout.write(proc.stdout)
        raise AssertionError(f"{name} exited {proc.returncode} in its own process")
    return lines[-1]


def free_ports(n: int) -> list[int]:
    """``n`` ports free on the loopback now (bound together, then closed)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_http(port: int, path: str, timeout: float = 120) -> tuple[int, str]:
    """(status, body) of the first GET of ``path`` that answers."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()
        except OSError:
            assert time.monotonic() < deadline, f"port {port} never answered {path}"
            time.sleep(0.2)


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
    sharded = sharded_serving_phase()
    emit(sharded)
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
    ml20m, fused_t, chunk_t, ratings, mesh_train, factors = train_ml20m_phase()
    emit(ml20m)
    emit(mesh_train)
    # pio check and the DASE pre-flight in a process of its own (no CUDA
    # there before its train), then the trained ML-20M instance from S3
    t0 = time.perf_counter()
    check = phase_in_own_process("check_phase")
    check["own_process_s"] = time.perf_counter() - t0
    check["s3"] = s3_serving_phase(*factors)
    del factors
    check["phase_s"] = time.perf_counter() - t0
    emit(check)
    emit({"phase": "als_kernel_timing", "als_fused_accum": fused_t,
          "als_segment_accum": chunk_t})
    family_train, _, family_cli = als_family_phases(ratings)
    ncf_train, _, ncf_mesh = ncf_phases(ratings)
    ingest = event_ingest_phase()
    emit(ingest)
    emit(classification_phase())
    generations = generations_phase()
    emit(generations)
    operator = operator_phase()
    emit(operator)
    lifecycle = lifecycle_phase()
    emit(lifecycle)
    # the storage daemon takes the first STORE_RATINGS of train_ml20m's
    # ratings (the same generator and seed) rather than generating them again
    storage = storage_phase(n_events=STORE_RATINGS,
                            ratings=tuple(x[:STORE_RATINGS] for x in ratings))
    del ratings
    emit(storage)
    watch = phase_in_own_process("watch_phase")
    emit(watch)
    fleet = fleet_phase()
    emit(fleet)
    day = day_phase()
    emit(day)
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
                    # the TLS deploy's feedback wave and pio batchpredict by
                    # engine coordinates
                    "launches_operator": operator["launches"]["fused_topk"],
                    # both canary waves' two partitions each, and the two
                    # tenants' partitions of one wave
                    "launches_lifecycle": lifecycle["launches"]["fused_topk"],
                    # the waves of the deploy bound through the storage
                    # daemon (before and after its SIGKILL), its pio
                    # batchpredict, and the TYPE=hdfs model's wave
                    "launches_storage": storage["launches"]["fused_topk"],
                    # the watch loop's billed waves: four queued bursts of
                    # one tenant and the wave after the daemon's SIGKILL
                    "launches_watch": watch["launches"]["fused_topk"],
                    # one device wave of FLEET_WAVE routed queries per replica
                    # behind the fleet's router
                    "launches_fleet": fleet["launches"]["fused_topk"],
                    # the ML-20M instance deployed from S3Models: one wave
                    "launches_check": check["s3"]["launches"]["fused_topk"],
                    # pio batchpredict of every known user through a user's
                    # EngineFactory module (check): one wave
                    "launches_custom_engine": check["custom_engine"]["wave_launches"]["fused_topk"],
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
                    # sharded_serving: one launch per slot per wave (4 and 3
                    # slots on cuda:0), timed at one slot's shape
                    "launches_sharded": sharded["launches_sharded"],
                    "shard_shape": sharded["shard_kernel"]["shape"],
                    "shard_ms": sharded["shard_kernel"]["kernel_ms"],
                    "shard_plain_ms": sharded["shard_kernel"]["plain_ms"],
                    "shard_bound_ms": sharded["shard_kernel"]["bound_ms"],
                    "shard_library_ms": sharded["shard_kernel"]["library_ms"],
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
                    # pio train --engine-json under named coordinates
                    launches_operator=operator["launches"]["als_fused_accum"],
                    # the lifecycle controller's warm-start retrain
                    launches_lifecycle=lifecycle["launches"]["als_fused_accum"],
                    # pio train of the ML-20M ratings through the storage
                    # daemon, and of the ML-100K app with TYPE=hdfs models
                    launches_storage=storage["launches"]["als_fused_accum"],
                    # the ML-100K train over a throwaway PostgreSQL server,
                    # where the host has one
                    **({"launches_watch": watch["launches"]["als_fused_accum"]}
                       if watch["postgres"]["server"] else {}),
                    # the production day's fixture (seed_demo_home) on the card
                    launches_day=day["fixture"]["launches"]["als_fused_accum"],
                    # pio train at the ML-100K cut behind the DASE pre-flight
                    # and the advisory lint (check, in its own process)
                    launches_check=check["train"]["launches"]["als_fused_accum"],
                    # pio train of a user's EngineFactory module (check)
                    launches_custom_engine=check["custom_engine"]["train_launches"]["als_fused_accum"],
                    # mesh_train: 4 data slots of cuda:0 (2 x 4 x 5), each
                    # rank of the two-process train, the 4-slot run_train;
                    # timed at one slot's shape (mesh_*)
                    launches_mesh_train=mesh_train["launches"]["als_fused_accum"],
                    launches_mesh_two_process=[
                        w["launches"]["als_fused_accum"]
                        for w in mesh_train["two_process"]["ranks"]],
                    launches_mesh_engine=mesh_train["engine"]["launches"]["als_fused_accum"],
                    mesh_shape=mesh_train["kernel1_one_slot"]["shape"],
                    mesh_ms=mesh_train["kernel1_one_slot"]["ms"],
                    mesh_plain_ms=mesh_train["kernel1_one_slot"]["plain_ms"],
                    mesh_bound_ms=mesh_train["kernel1_one_slot"]["bound_ms"],
                    mesh_bound_by=mesh_train["kernel1_one_slot"]["bound_by"],
                    mesh_max_abs_err=max(mesh_train["slot_max_abs_err"]),
                    # ncf_mesh_train: the NCF pretrain over {data: 2, model:
                    # 2} slots of cuda:0 (2 data slots x 2 x 2 iterations)
                    # and the ncf template's 4-slot run_train (2 x 2 x 20);
                    # timed at one data slot's share of the rank-32
                    # implicit stream (ncf_mesh_*)
                    launches_ncf_mesh=ncf_mesh["b"]["launches"]["als_fused_accum"],
                    launches_ncf_mesh_engine=ncf_mesh["d"]["launches"]["als_fused_accum"],
                    ncf_mesh_shape=ncf_mesh["b"]["kernel1_one_slot"]["shape"],
                    ncf_mesh_ms=ncf_mesh["b"]["kernel1_one_slot"]["ms"],
                    ncf_mesh_plain_ms=ncf_mesh["b"]["kernel1_one_slot"]["plain_ms"],
                    ncf_mesh_bound_ms=ncf_mesh["b"]["kernel1_one_slot"]["bound_ms"],
                    ncf_mesh_bound_by=ncf_mesh["b"]["kernel1_one_slot"]["bound_by"],
                    ncf_mesh_library_ms=None,
                    ncf_mesh_max_abs_err=max(ncf_mesh["b"]["slot_max_abs_err"]),
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
                    launches_operator=operator["launches"]["als_segment_accum"],
                    launches_lifecycle=lifecycle["launches"]["als_segment_accum"],
                    launches_storage=storage["launches"]["als_segment_accum"],
                    # mesh_train's chunked rung over 4 slots
                    launches_mesh_train=mesh_train["chunked"]["launches"]["als_segment_accum"],
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
