"""Solo-query latency of a deploy's two front ends, on a warmed server.

Deploys a seeded ALS model (random factors at the ML-20M shape, rank 10,
unless ``--users``/``--items`` say otherwise) under the asyncio front end
(micro-batched: a solo query is a wave of one) and under the threaded one,
and sends ``--warmup`` and then ``--requests`` sequential num=10 queries to
each over one keep-alive connection.  Prints one JSON line per front end:
the client-side p50/p90/p99/mean/max in ms and the request count; with
``--burst N``, then N queries from ``--clients`` keep-alive clients in
the server's process to the asyncio deploy (queries/s, p50/p99).  Where
the deploy serves ``/hotpath.json`` (the solo path's host stages), the
stage table of the timed requests is read beside the times; with
``--stacks DIR``, the host stack sampler (``/debug/stacks.json``) runs over
a second pass of the same queries and its heaviest folded stacks are
written to ``DIR/solo_stacks_<label>_<kind>.txt``.

    python3 solo_latency.py [--tree DIR] [--label NAME] [--device cuda|cpu]
                            [--requests N] [--warmup N] [--stacks DIR]
                            [--burst N] [--clients N]

``--tree`` names the checkout whose ``predictionio_tpu_torch`` is imported
(default: this script's own), so two trees are compared by one script,
one process each, in one run on one card.
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

SEED = 0


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def write_model(storage, n_users: int, n_items: int, rank: int) -> str:
    """A seeded COMPLETED recommendation instance (factors as ops/als.py
    initializes them: abs(normal) / sqrt(rank))."""
    from predictionio_tpu_torch.core.engine import EngineParams
    from predictionio_tpu_torch.core.persistence import save_models
    from predictionio_tpu_torch.data.storage.base import EngineInstance
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithmParams,
        DataSourceParams,
    )

    rng = np.random.default_rng(SEED)
    blob = {
        "user_factors": (np.abs(rng.standard_normal((n_users, rank)))
                         / np.sqrt(rank)).astype(np.float32),
        "item_factors": (np.abs(rng.standard_normal((n_items, rank)))
                         / np.sqrt(rank)).astype(np.float32),
        "user_vocab": np.array([f"u{i}" for i in range(n_users)]),
        "item_vocab": np.array([f"i{i}" for i in range(n_items)]),
    }
    params = EngineParams(
        datasource=("", DataSourceParams(app_name="solo")),
        algorithms=(("als", ALSAlgorithmParams(rank=rank)),),
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
    return instance.id


def get_json(conn, path: str):
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    return resp.status, (json.loads(raw) if resp.status == 200 else raw)


def timed_queries(conn, users) -> list[float]:
    """Seconds per query, client side, one at a time on ``conn``."""
    out = []
    for u in users:
        body = json.dumps({"user": f"u{u}", "num": 10}).encode()
        t0 = time.perf_counter()
        conn.request("POST", "/queries.json", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        out.append(time.perf_counter() - t0)
        assert resp.status == 200, (resp.status, raw[:200])
        assert len(json.loads(raw)["itemScores"]) == 10
    return out


def concurrent_burst(port: int, users, clients: int) -> dict:
    """``clients`` threads, each on one keep-alive connection, send one
    num=10 query per user until none is left: queries/s and the client
    p50/p99 (serve_concurrent's shape, clients in the server's process)."""
    jobs = iter(users)
    lock = threading.Lock()
    lat: list[float] = []
    failed: list[int] = []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while True:
                with lock:
                    u = next(jobs, None)
                if u is None:
                    return
                body = json.dumps({"user": f"u{u}", "num": 10}).encode()
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json", body=body)
                resp = conn.getresponse()
                resp.read()
                with lock:
                    lat.append(time.perf_counter() - t0)
                    if resp.status != 200:
                        failed.append(resp.status)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, t0 + 300 - time.perf_counter()))
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    assert not failed and len(lat) == len(users), (failed[:5], len(lat))
    ms = np.asarray(lat) * 1e3
    return {"queries": len(lat), "clients": clients,
            "queries_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def run_kind(
    kind: str, storage, users, device: str = "cuda", warmup: int = 100,
    stacks_path: Path | None = None, burst=None, clients: int = 64,
) -> dict:
    """One front end (``"aio"`` or ``"threaded"``) of the default deploy of
    ``storage``'s newest recommendation instance: ``warmup`` queries, then
    the rest of ``users`` timed one by one on one keep-alive connection.
    With ``stacks_path``, a second timed pass runs under the host stack
    sampler and its folded stacks, heaviest first, land there.  With
    ``burst`` (users), :func:`concurrent_burst` follows from ``clients``
    clients."""
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
    )

    server = create_prediction_server(
        "recommendation", host="127.0.0.1", port=0, storage=storage,
        server_kind=kind, device=device,
    ).start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        timed_queries(conn, users[:warmup])
        has_hotpath = get_json(conn, "/hotpath.json")[0] == 200
        hot0 = get_json(conn, "/hotpath.json")[1] if has_hotpath else None
        lat = timed_queries(conn, users[warmup:])
        ms = np.asarray(lat) * 1e3
        row = {
            "kind": kind, "device": device,
            "requests": len(lat), "warmup": warmup,
            "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean()),
            "max_ms": float(ms.max()),
            "stdev_ms": float(statistics.pstdev(ms)),
        }
        if has_hotpath:
            row["hotpath"] = hotpath_delta(
                hot0, get_json(conn, "/hotpath.json")[1])
        if stacks_path is not None:
            # the first GET arms the process sampler; reset drops the warmup
            if get_json(conn, "/debug/stacks.json?reset=1")[0] == 200:
                timed_queries(conn, users[warmup:])
                folded = get_json(conn, "/debug/stacks.json")[1]["collapsed"]
                lines = sorted(
                    (x for x in folded.splitlines() if x.strip()),
                    key=lambda x: -int(x.rsplit(" ", 1)[1]),
                )
                stacks_path.write_text("\n".join(lines) + "\n")
                row["stacks_file"] = str(stacks_path)
                row["stack_samples"] = sum(
                    int(x.rsplit(" ", 1)[1]) for x in lines)
        conn.close()
        if burst is not None:
            row["concurrent"] = concurrent_burst(server.port, burst, clients)
    finally:
        server.shutdown()
    return row


def hotpath_delta(before: dict, after: dict) -> dict:
    """Mean microseconds per request of each solo-path host stage between
    two ``/hotpath.json`` reads (the stage counts and totals subtract)."""
    n = after["requests"] - before["requests"]
    out = {"requests": n}
    for stage, st in after["stages"].items():
        was = before["stages"].get(stage, {"seconds_total": 0.0})
        out[stage + "_us"] = round(
            1e6 * (st["seconds_total"] - was["seconds_total"]) / max(n, 1), 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--users", type=int, default=138_493)
    ap.add_argument("--items", type=int, default=26_744)
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--kinds", default="aio,threaded")
    ap.add_argument("--stacks", metavar="DIR", default=None)
    ap.add_argument("--burst", type=int, default=0,
                    help="then this many queries from --clients clients "
                    "(aio only)")
    ap.add_argument("--clients", type=int, default=64)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("solo_latency: CUDA is not available", file=sys.stderr)
        return 2
    from predictionio_tpu_torch.data.storage.config import (
        StorageConfig,
        StorageRuntime,
    )

    out_dir = Path(args.stacks) if args.stacks else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    users = np.random.default_rng(SEED + 1).integers(
        0, args.users, args.warmup + args.requests)
    with tempfile.TemporaryDirectory() as tmp:
        storage = StorageRuntime(StorageConfig.from_env(
            {"PIO_HOME": str(Path(tmp) / "pio_home")}))
        try:
            write_model(storage, args.users, args.items, args.rank)
            for kind in args.kinds.split(","):
                stacks = (out_dir / f"solo_stacks_{args.label}_{kind}.txt"
                          if out_dir is not None else None)
                burst = (np.random.default_rng(SEED + 2).integers(
                    0, args.users, args.burst)
                    if args.burst and kind == "aio" else None)
                row = run_kind(kind, storage, users, args.device, args.warmup,
                               stacks, burst, args.clients)
                row["label"], row["tree"] = args.label, args.tree
                row["card"] = card_line() if args.device != "cpu" else "cpu"
                print(json.dumps(row), flush=True)
        finally:
            storage.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
