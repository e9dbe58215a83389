"""Prediction serving — the ``pio deploy`` server.

Route parity with the JAX package (workflow/CreateServer.scala:458-706):

  GET  /              HTML status page ("Engine is deployed and running")
  GET  /status.json   engine instance, in-flight generations, batcher state
  POST /queries.json  extract query -> supplement -> predict per algorithm
                      -> serve -> JSON
  POST /reload        hot-swap to the latest COMPLETED engine instance
                      through the generation manifest's checksum gate,
                      draining the old one (key-gated; 409 on refusal)
  GET  /lifecycle.json  the generation manifest (key-gated)
  POST /stop          shut the server down (key-gated when an access key
                      is configured)

``create_prediction_server`` serves under the asyncio front end with query
micro-batching by default (``server_kind="aio"``), as the JAX package's
deploy does: concurrent ``/queries.json`` requests coalesce into waves of
at most ``max_batch``; waves of ``DEVICE_BATCH_MIN`` known users or more
dispatch on the card and are fenced on the batcher's finalizer thread
while the next wave dispatches.  The queue bound, the in-flight cap and
per-request deadlines answer 503 + Retry-After and 504.  ``"threaded"``
keeps the thread-per-connection server answering each query solo.

Models are materialized at deploy (and at each ``/reload``) onto the
serving device (``load_persistent_model``); a swap drops the retired
generation's factor caches (``parallel.device_cache``).  An answer that an
engine gave in degraded mode (``resilience.degrade.mark_degraded``: a live
event-store read failed) is stamped ``X-Pio-Degraded`` with the reasons,
collected per request on the threaded route and per wave in the
micro-batcher.

The observability routes are the JAX package's (``obs.http``:
``/metrics``, ``/healthz``, ``/readyz`` with the model, batcher and
event-store checks, ``/efficiency.json``, ``/explain.json``,
``/debug/flight.json``, ``/debug/profile`` ...), gated by the deploy's
access key except ``/healthz``.  Every answered query leaves a provenance
record (binding, engine path, wave, items and scores), its wave meta in
the flight recorder, and, on the solo paths, its host stages in
``/hotpath.json``.

Every bind goes through the generation manifest (``lifecycle.generations``,
the JAX package's layout and key): ``deploy_engine`` binds the manifest's
live generation, checksum-verified, walking back to the last good one when
its bytes are corrupt, and records what it bound as live; ``/reload``
verifies the candidate's checksum, loads and sanity-checks it, passes the
``lifecycle.swap`` fault seam, commits the manifest and only then flips.
Canary and tenant partitioning of waves come with a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from datetime import datetime, timezone
from typing import Any, Callable, NamedTuple

import torch

from predictionio_tpu_torch.core.base import EngineContext, run_sanity_check
from predictionio_tpu_torch.core.engine import Engine, resolve_engine_factory
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import (
    StorageRuntime,
    get_storage,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.lifecycle.generations import (
    CorruptModelError,
    GenerationStore,
)
from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs import provenance
from predictionio_tpu_torch.obs.disttrace import note_wave_events
from predictionio_tpu_torch.obs.flight import annotate
from predictionio_tpu_torch.obs.hotpath import (
    WAVE_STAGE_MAP,
    HotPathTracker,
    StageClock,
)
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.tracing import trace
from predictionio_tpu_torch.parallel import device_cache
from predictionio_tpu_torch.resilience import LoadShed, faults
from predictionio_tpu_torch.resilience.admission import AdmissionController
from predictionio_tpu_torch.resilience.deadline import DeadlineExceeded
from predictionio_tpu_torch.resilience.degrade import degraded_scope
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    error_response,
    json_response,
    key_matches,
    shed_response,
)
from predictionio_tpu_torch.utils.params import extract_params

log = logging.getLogger("predictionio_tpu_torch.serving")

#: response header naming the generation that answered
INSTANCE_HEADER = "X-Pio-Engine-Instance"
#: response header listing the degraded-mode reasons of a 200 answer
DEGRADED_HEADER = "X-Pio-Degraded"


class Binding(NamedTuple):
    """One generation's immutable serving snapshot.  Every request and
    every wave captures exactly one Binding, so a concurrent swap can never
    hand it a torn mix of old algorithms and new models."""

    instance: EngineInstance
    params: Any
    algorithms: list
    models: list
    serving: Any


class QueuedQuery:
    """One ``/queries.json`` payload in the micro-batcher.  A wave that
    dispatches it to the device sets ``on_device``: if that wave fails,
    its bisection and the batcher's solo retry re-dispatch the query on
    the device, never on the host replica, so a failing card answers 500
    and not a host answer.  A wave that answers it sets ``degraded`` to the
    degraded-mode reasons of that wave, and ``prov`` to the provenance the
    wave collected for it (binding identity and the engine's notes; deep
    fields under ``_deep``)."""

    __slots__ = ("payload", "on_device", "degraded", "prov")

    def __init__(self, payload: dict):
        self.payload = payload
        self.on_device = False
        self.degraded: tuple[str, ...] = ()
        self.prov: dict[str, Any] = {}


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
    """Engine + materialized models for one engine instance, hot-swappable.

    The live generation's ``instance/params/algorithms/models/serving``
    attributes are replaced together under one lock; readers snapshot a
    whole :class:`Binding` once per request or wave, so in-flight work
    finishes on the generation it started on.  A per-generation in-flight
    count (one slot from a wave's dispatch to its fence) gives
    ``wait_drained``, the step after a swap that retires the old
    generation: once its last slot is released nothing holds its device
    factors.
    """

    def __init__(
        self,
        engine: Engine,
        instance: EngineInstance,
        storage: StorageRuntime,
        generation_store: GenerationStore,
        device: torch.device | str | None = None,
    ):
        self.engine = engine
        self.storage = storage
        self.ctx = EngineContext(storage=storage, mode="serving", device=device)
        #: the manifest every swap is verified against and commits through
        self.generation_store = generation_store
        self._lock = threading.RLock()
        self._drain_cond = threading.Condition()
        self._inflight: dict[str, int] = {}
        self._install_live(self.load_binding(instance))

    # -- binding construction ------------------------------------------------

    def load_binding(self, instance: EngineInstance) -> Binding:
        """Materialize one generation WITHOUT flipping anything: parse its
        params, load its models onto the context's device, instantiate its
        components (the slow half of a swap, done outside the lock)."""
        params = self.engine.params_from_json(_instance_variant(instance))
        persisted = load_models(self.storage.models(), instance.id)
        if persisted is None:
            raise RuntimeError(f"no model blob for engine instance {instance.id}")
        models = self.engine.prepare_deploy(
            self.ctx, params, persisted, instance_id=instance.id
        )
        _, _, algos, serving = self.engine.instantiate(params)
        return Binding(instance, params, algos, models, serving)

    def _install_live(self, binding: Binding) -> None:
        old_models = getattr(self, "models", None)
        with self._lock:
            (
                self.instance, self.params, self.algorithms, self.models,
                self.serving,
            ) = binding
        # the retired generation's factor caches die with it: a repeat
        # entity's next request gathers from the NEW generation's factors
        if old_models is not None and old_models is not binding.models:
            device_cache.invalidate_model_caches(old_models, "swap")

    def live_binding(self) -> Binding:
        with self._lock:
            return Binding(
                self.instance, self.params, self.algorithms, self.models,
                self.serving,
            )

    # -- in-flight tracking (the drain half of a swap) -----------------------

    def acquire_slot(self, binding: Binding) -> None:
        """Take one in-flight ref on the binding's generation.  Split from
        :meth:`serving_slot` because a pipelined wave acquires on the
        dispatch thread and releases on the finalizer thread: the refcount
        must span the whole dispatch -> fence window, or a swap could
        retire a generation whose wave is still unfenced."""
        iid = binding.instance.id
        with self._drain_cond:
            self._inflight[iid] = self._inflight.get(iid, 0) + 1

    def release_slot(self, binding: Binding) -> None:
        iid = binding.instance.id
        with self._drain_cond:
            n = self._inflight.get(iid, 1) - 1
            if n <= 0:
                self._inflight.pop(iid, None)
            else:
                self._inflight[iid] = n
            self._drain_cond.notify_all()

    @contextlib.contextmanager
    def serving_slot(self, binding: Binding):
        self.acquire_slot(binding)
        try:
            yield
        finally:
            self.release_slot(binding)

    def inflight_snapshot(self) -> dict[str, int]:
        """Per-generation in-flight counts: zero everywhere means no
        request would be dropped by stopping or swapping."""
        with self._drain_cond:
            return {k: v for k, v in self._inflight.items() if v > 0}

    def wait_drained(self, instance_id: str, timeout: float = 5.0) -> bool:
        """Block until no in-flight request references the generation."""
        with self._drain_cond:
            return self._drain_cond.wait_for(
                lambda: self._inflight.get(instance_id, 0) == 0, timeout
            )

    # -- swaps ---------------------------------------------------------------

    def verify_and_swap(self, instance: EngineInstance) -> None:
        """The gated /reload path: checksum-verify the candidate's stored
        bytes, load and sanity-check it, THEN commit the manifest, THEN
        flip, then drain the old generation.  Any failure before the
        commit leaves the old generation serving untouched.  Raises on
        refusal (``CorruptModelError`` for a checksum mismatch)."""
        store = self.generation_store
        gen = store.get(instance.id)
        if gen is None:
            gen = store.record(instance.id, status="staged")
        store.verify(gen)
        binding = self.load_binding(instance)
        for m in binding.models:
            run_sanity_check(m)
        if faults.ACTIVE is not None:
            # the crash-mid-swap seam: a chaos plan stalls or kills here,
            # BETWEEN verification and the manifest commit; a restart
            # comes back on the still-committed generation
            faults.ACTIVE.check("lifecycle.swap", f"reload {instance.id}")
        old = self.instance
        store.promote(instance.id, note="reload")
        self._install_live(binding)
        if old.id != instance.id:
            # an idempotent reload of the bound instance must not stall
            # behind its own steady traffic
            self.wait_drained(old.id, timeout=5.0)

    def reload_latest(self) -> EngineInstance:
        """Verify and swap to the latest COMPLETED instance of the bound
        engine (MasterActor ReloadServer), through the same gate as every
        swap."""
        latest = self.storage.engine_instances().get_latest_completed(
            self.instance.engine_id,
            self.instance.engine_version,
            self.instance.engine_variant,
        )
        if latest is None:
            raise RuntimeError("no COMPLETED engine instance to reload")
        self.verify_and_swap(latest)
        return latest

    # -- serving -------------------------------------------------------------

    def extract_query(self, query_payload: dict) -> Any:
        with self._lock:
            algorithms = self.algorithms
        return _extract_query(algorithms, query_payload)

    def predict(self, query: Any) -> tuple[Any, Any]:
        return self.predict_bound(self.live_binding(), query)

    def predict_bound(self, binding: Binding, query: Any) -> tuple[Any, Any]:
        """One query: supplement, predict per algorithm, serve."""
        query = binding.serving.supplement(query)
        predictions = [
            a.predict(m, query) for a, m in zip(binding.algorithms, binding.models)
        ]
        return query, binding.serving.serve(query, predictions)

    def predict_batch(self, queries: list[Any]) -> list[tuple[Any, Any]]:
        return self.predict_batch_bound(self.live_binding(), queries)

    def predict_batch_bound(
        self, binding: Binding, queries: list[Any]
    ) -> list[tuple[Any, Any]]:
        """A wave of queries in one vectorized ``batch_predict`` pass per
        algorithm — the MicroBatcher's synchronous target."""
        serving = binding.serving
        supplemented = [serving.supplement(q) for q in queries]
        per_algo: list[list[Any]] = []
        for a, m in zip(binding.algorithms, binding.models):
            by_idx = dict(a.batch_predict(m, list(enumerate(supplemented))))
            per_algo.append([by_idx[i] for i in range(len(supplemented))])
        return [
            (q, serving.serve(q, [col[i] for col in per_algo]))
            for i, q in enumerate(supplemented)
        ]

    def dispatch_batch_bound(
        self, binding: Binding, queries: list[Any], force: bool = False
    ) -> Callable[[], list[tuple[Any, Any]]] | None:
        """The ASYNC half of :meth:`predict_batch_bound`: supplement and
        each algorithm's ``dispatch_batch`` (gather, upload, the kernel
        launch and the result's copy, NO blocking), returning a finalize
        that fences, reads back and serves.  None — the caller computes
        synchronously — when an algorithm lacks ``dispatch_batch`` or
        declines the wave (below ``DEVICE_BATCH_MIN``).  ``force`` asks
        each algorithm to dispatch on its device at any size (the retries
        of a failed device wave)."""
        dispatches = [
            getattr(a, "dispatch_batch", None) for a in binding.algorithms
        ]
        if any(d is None for d in dispatches):
            return None
        serving = binding.serving
        supplemented = [serving.supplement(q) for q in queries]
        finalizers: list[Callable[[], list[tuple[int, Any]]]] = []
        for dispatch, m in zip(dispatches, binding.models):
            fin = dispatch(m, list(enumerate(supplemented)), force=force)
            if fin is None:
                return None
            finalizers.append(fin)

        def finalize() -> list[tuple[Any, Any]]:
            per_algo: list[list[Any]] = []
            for fin in finalizers:
                by_idx = dict(fin())
                per_algo.append([by_idx[i] for i in range(len(supplemented))])
            return [
                (q, serving.serve(q, [col[i] for col in per_algo]))
                for i, q in enumerate(supplemented)
            ]

        return finalize


def deploy_engine(
    engine_factory_name: str,
    storage: StorageRuntime | None = None,
    engine_instance_id: str | None = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    device: torch.device | str | None = None,
) -> DeployedEngine:
    """Resolve factory + engine instance and materialize its models on
    ``device`` (default CUDA; raises without a card unless
    ``device="cpu"``).

    The instance is, in this order (CreateServer.scala:193, the JAX
    package's ``deploy_engine``): the given id; else the generation
    manifest's live generation, checksum-verified, with a walk back to the
    newest previously-live generation when the head's bytes are corrupt;
    else the latest COMPLETED instance, unless the gate just refused it.
    Binding the manifest's live generation, not merely the latest
    COMPLETED one, is what makes a kill mid-swap safe: a restart comes back
    on whichever whole generation the manifest's atomic commit last
    published.  What it binds is recorded as live."""
    device = resolve_device(device)
    storage = storage or get_storage()
    instances = storage.engine_instances()
    gen_store = GenerationStore(
        storage.models(), engine_id, engine_version, engine_variant
    )
    instance = None
    refused: set[str] = set()
    if engine_instance_id is not None:
        instance = instances.get(engine_instance_id)
        if instance is None:
            raise RuntimeError(f"engine instance {engine_instance_id} not found")
    elif gen_store.exists():
        instance = _bind_from_manifest(gen_store, instances, refused)
    if instance is None:
        instance = instances.get_latest_completed(
            engine_id, engine_version, engine_variant
        )
        if instance is None:
            raise RuntimeError(
                f"no COMPLETED engine instance for engine {engine_id!r}; "
                "run train first"
            )
        if instance.id in refused:
            # every manifest generation failed its checksum and the latest
            # COMPLETED instance is one of them: recording it live would
            # bless the corruption the gate just caught
            raise RuntimeError(
                f"every generation of engine {engine_id!r} failed checksum "
                f"verification (latest COMPLETED {instance.id} included); "
                "re-train or restore the model store before deploying"
            )
    # record what is bound as the live generation (creates the manifest on
    # the first deploy); bookkeeping only, the bind-time checks above are
    # the strict part
    try:
        live = gen_store.live()
        if live is None or live.instance_id != instance.id:
            gen_store.record(instance.id, status="live")
    except Exception as e:
        log.warning("could not record live generation in manifest: %s", e)
    factory = resolve_engine_factory(
        engine_factory_name or instance.engine_factory
    )
    return DeployedEngine(
        factory(), instance, storage, gen_store, device=device
    )


def _bind_from_manifest(
    gen_store: GenerationStore, instances, refused: set[str] | None = None
) -> EngineInstance | None:
    """The startup bind: the manifest's live generation, checksum-verified;
    corrupt bytes fall back to the most recent previously-live generation
    instead of crashing (or serving garbage).  Refused instance ids are
    collected so the caller's latest-COMPLETED fallback never re-blesses
    a generation the gate just rejected."""
    for gen in gen_store.bind_candidates():
        inst = instances.get(gen.instance_id)
        if inst is None:
            continue
        try:
            gen_store.verify(gen)
        except CorruptModelError as e:
            if refused is not None:
                refused.add(gen.instance_id)
            REGISTRY.counter(
                "pio_lifecycle_corrupt_blobs_total",
                "Model blobs refused by checksum verification",
            ).inc()
            log.error(
                "generation %s refused at bind (%s); falling back to "
                "last-good", gen.instance_id, e,
            )
            gen_store.mark_corrupt(gen.instance_id, str(e))
            continue
        return inst
    return None


def create_prediction_server_app(
    deployed: DeployedEngine,
    on_stop: Callable[[], None] | None = None,
    access_key: str | None = None,
    use_microbatch: bool = False,
    #: the JAX package's default wave cap
    max_batch: int = 32,
    registry: MetricsRegistry | None = None,
    #: queued queries past which /queries.json sheds 503 + Retry-After
    #: (PIO_MAX_QUEUE); None = the MicroBatcher's default bound (1024),
    #: 0 or negative = unbounded
    max_queue: int | None = None,
    #: in-flight request cap enforced at admission (PIO_MAX_INFLIGHT);
    #: None disables the cap
    max_inflight: int | None = None,
    #: default per-request time budget in seconds, overridable per request
    #: by the X-Pio-Deadline header (PIO_DEFAULT_DEADLINE_S)
    default_deadline_s: float | None = None,
    #: dispatched-but-unfenced waves the MicroBatcher may run ahead of the
    #: fence (PIO_PIPELINE_DEPTH, default 2); 0 finalizes inline
    pipeline_depth: int | None = None,
    #: how long the MicroBatcher's close() waits for in-flight waves
    drain_timeout_s: float = 5.0,
) -> HTTPApp:
    app = HTTPApp("predictionserver")
    if max_queue is None and os.environ.get("PIO_MAX_QUEUE"):
        max_queue = int(os.environ["PIO_MAX_QUEUE"])
    if max_inflight is None and os.environ.get("PIO_MAX_INFLIGHT"):
        max_inflight = int(os.environ["PIO_MAX_INFLIGHT"])
    if default_deadline_s is None and os.environ.get("PIO_DEFAULT_DEADLINE_S"):
        default_deadline_s = float(os.environ["PIO_DEFAULT_DEADLINE_S"])
    if pipeline_depth is None:
        pipeline_depth = int(os.environ.get("PIO_PIPELINE_DEPTH", "2"))
    registry = registry or REGISTRY
    #: the front ends read these: deadline admission + binding, and the
    #: in-flight shed gate
    app.default_deadline_s = default_deadline_s
    if max_inflight is not None:
        app.admission = AdmissionController(max_inflight, registry=registry)
    started_at = datetime.now(tz=timezone.utc)
    stats = {"request_count": 0, "avg_serving_sec": 0.0, "last_serving_sec": 0.0}
    stats_lock = threading.Lock()
    m_latency = registry.histogram(
        "pio_request_latency_seconds",
        "Serving request latency by route and status",
        labelnames=("route", "status"),
    )

    def _observe(status: int, t0: float) -> float:
        dt = time.perf_counter() - t0
        m_latency.labels("/queries.json", str(status)).observe(dt)
        return dt

    def _bump_stats(t0: float) -> None:
        dt = _observe(200, t0)
        with stats_lock:
            n = stats["request_count"]
            stats["avg_serving_sec"] = (stats["avg_serving_sec"] * n + dt) / (n + 1)
            stats["last_serving_sec"] = dt
            stats["request_count"] = n + 1

    def _stamped(resp: Response, instance_id: str) -> Response:
        resp.headers[INSTANCE_HEADER] = instance_id
        return resp

    def _answer(value: Any, instance_id: str, degraded) -> Response:
        """A 200 answer, stamped with its generation and, when the engine
        fell back to a degraded answer (metrics carry
        ``pio_degraded_total``), the reasons."""
        resp = _stamped(json_response(200, value), instance_id)
        if degraded:
            resp.headers[DEGRADED_HEADER] = ",".join(degraded)
        return resp

    # solo-path host-stage attribution (obs/hotpath.py): every fully served
    # request decomposes into named host stages at /hotpath.json
    hotpath = HotPathTracker(registry)

    def _note_wave_provenance(item, payload, meta, instance_id) -> None:
        """The decision record of one micro-batched answer: the wave's
        binding identity and engine notes, the payload, the wave's
        coordinates and cache split, the wave mates (deep) and any
        degraded-mode reasons."""
        prov = dict(item.prov)
        deep = prov.pop("_deep", None)
        provenance.note(**prov)
        if deep:
            provenance.note_deep(**deep)
        provenance.note(payload=payload)
        wave_info = {
            key[len("wave_"):]: meta[key]
            for key in ("wave_id", "wave_size", "wave_seq")
            if meta.get(key) is not None
        }
        if wave_info:
            provenance.note(wave=wave_info)
        if meta.get("cache_hits") or meta.get("cache_misses"):
            provenance.note(
                cache={
                    "hits": meta.get("cache_hits", 0),
                    "misses": meta.get("cache_misses", 0),
                    "generation": instance_id,
                }
            )
        if meta.get("wave_request_ids"):
            provenance.note_deep(wave_request_ids=meta["wave_request_ids"])
        if item.degraded:
            provenance.note(degraded=list(item.degraded))

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

    @app.route("GET", "/status\\.json")
    def status(req: Request) -> Response:
        batcher = getattr(app, "microbatcher", None)
        return json_response(
            200,
            {
                "status": "alive",
                "engineInstanceId": deployed.instance.id,
                "startTime": started_at.isoformat(),
                # the drain surface: safe to stop when no generation holds
                # an in-flight request and the micro-batch queue is idle
                "inflightGenerations": deployed.inflight_snapshot(),
                "batcherBusy": bool(batcher is not None and batcher.busy),
                **stats,
            },
        )

    # bad query JSON/shape -> 400; engine faults -> logged 500 (the
    # reference's MappingException / Throwable split,
    # CreateServer.scala:607-630)
    if use_microbatch:
        from predictionio_tpu_torch.server.microbatch import (
            MicroBatcher,
            PendingWave,
        )

        def _predict_bisect(binding, parsed, idxs, out, on_device, depth=0):
            """Batched predict with bisection fault isolation: a failing
            wave splits in half and each half retries batched, so P poison
            queries cost O(P log B) extra waves instead of B solo predicts.
            The whole recursion runs against ONE captured binding.  The
            halves of a device wave (``on_device``) re-dispatch on the
            device at any size and fence inline: a card that keeps failing
            fails every query of the wave."""
            queries = [parsed[i][1] for i in idxs]
            try:
                if on_device:
                    results = deployed.dispatch_batch_bound(
                        binding, queries, force=True
                    )()
                else:
                    results = deployed.predict_batch_bound(binding, queries)
            except DeadlineExceeded:
                # the wave's (tightest member's) budget ran out: not a
                # poison query; the MicroBatcher's solo-retry pass re-runs
                # each item under its own deadline
                raise
            except Exception as e:
                if len(idxs) == 1:
                    out[idxs[0]] = ("err", e)
                    return
                if depth == 0:
                    log.exception("wave predict failed; bisecting to isolate")
                mid = len(idxs) // 2
                for half in (idxs[:mid], idxs[mid:]):
                    _predict_bisect(
                        binding, parsed, half, out, on_device, depth + 1
                    )
                return
            for i, (q, pred) in zip(idxs, results):
                out[i] = ("pred", (q, pred))

        def _serve_wave(items):
            """One wave of :class:`QueuedQuery`, split at the fence.

            The DISPATCH half runs here on the worker thread: extract, then
            ``dispatch_batch_bound`` against the live binding captured once
            for the wave (gather, upload, kernel launch, the result's copy
            into pinned memory; nothing blocks), holding one serving slot.
            The FINALIZE half — fence, serve, render — rides the returned
            :class:`PendingWave` onto the finalizer thread, which releases
            the slot.  A wave the engine computes on the host (below
            ``DEVICE_BATCH_MIN``) runs inline here instead: the busy worker
            is what lets queue pressure coalesce the next wave.

            A device wave marks its queries ``on_device``.  When its
            dispatch or fence fails, its bisection re-dispatches on the
            device, and so does the batcher's solo retry of any of its
            queries: no failed device work is answered from the host
            replica.  A dispatch that raised counts as a device wave, since
            the card may be what failed.  Each result is ("ok", rendered,
            instance id) | ("bad", error, id) -> 400 | ("err", error, id)
            -> 500.  The degraded-mode reasons that either half collected
            (one scope each, as the JAX package's waves do) go on every
            query the wave answered (``QueuedQuery.degraded``)."""
            binding = deployed.live_binding()
            on_device = any(it.on_device for it in items)
            out: list[tuple] = []
            fin = None
            # the decision record's identity half, once per wave; the
            # engine's notes collect in a wave-scoped provenance collector
            # per half (the request scopes are invisible on the batcher's
            # threads) and reach each query through ``QueuedQuery.prov``
            base_prov = provenance.binding_fields(deployed, binding)
            wave_notes: dict[str, Any] = {}

            def _merge_notes(wtoken) -> None:
                collected = provenance.end_wave(wtoken)
                deep = collected.pop("_deep", None)
                wave_notes.update(collected)
                if deep:
                    wave_notes.setdefault("_deep", {}).update(deep)

            with degraded_scope() as degraded:
                for it in items:
                    try:
                        out.append(("q", deployed.extract_query(it.payload)))
                    except Exception as e:
                        out.append(("bad", e))
                parsed = list(out)
                ok_idx = [i for i, (tag, _) in enumerate(parsed) if tag == "q"]
                if ok_idx:
                    deployed.acquire_slot(binding)
                    wtoken = provenance.begin_wave()
                    try:
                        fin = deployed.dispatch_batch_bound(
                            binding, [parsed[i][1] for i in ok_idx],
                            force=on_device,
                        )
                    except Exception:
                        # dispatch failed before the fence: the finalize
                        # half re-runs the wave with bisection on the
                        # device, which names the real poison
                        log.exception(
                            "device wave dispatch failed; bisecting on the "
                            "device"
                        )
                        on_device = True
                    else:
                        on_device = fin is not None
                    finally:
                        _merge_notes(wtoken)
            degraded_pre = tuple(degraded)
            if on_device:
                for i in ok_idx:
                    items[i].on_device = True

            def _finalize():
                with degraded_scope() as degraded:
                    wtoken = provenance.begin_wave()
                    try:
                        if fin is not None:
                            try:
                                results = fin()
                            except DeadlineExceeded:
                                raise
                            except Exception:
                                log.exception(
                                    "device wave finalize failed; bisecting "
                                    "on the device"
                                )
                                _predict_bisect(binding, parsed, ok_idx, out, True)
                            else:
                                for i, (q, pred) in zip(ok_idx, results):
                                    out[i] = ("pred", (q, pred))
                        elif ok_idx:
                            _predict_bisect(
                                binding, parsed, ok_idx, out, on_device
                            )
                    finally:
                        _merge_notes(wtoken)
                        if ok_idx:
                            deployed.release_slot(binding)
                deg = degraded_pre + tuple(
                    d for d in degraded if d not in degraded_pre
                )
                iid = binding.instance.id
                done = []
                for it, (tag, value) in zip(items, out):
                    it.prov = {**base_prov, **wave_notes}
                    if tag == "pred":
                        try:
                            tag, value = "ok", _render_prediction(value[1])
                        except Exception as e:  # only this item fails
                            tag, value = "err", e
                    if tag == "ok":
                        it.degraded = deg
                    done.append((tag, value, iid))
                return done

            if fin is None:
                return _finalize()
            return PendingWave(_finalize)

        batcher = MicroBatcher(
            _serve_wave,
            max_batch=max_batch,
            drain_timeout_s=drain_timeout_s,
            registry=registry,
            max_inflight_waves=pipeline_depth,
            # None -> the batcher's default bound; 0/negative -> unbounded
            **(
                {"max_queue": max_queue if max_queue > 0 else None}
                if max_queue is not None
                else {}
            ),
        )
        app.microbatcher = batcher  # exposed for tests and status

        @app.route("POST", "/queries\\.json")
        async def queries(req: Request) -> Response:
            t0 = time.perf_counter()
            clock = StageClock()
            try:
                payload = req.json()
                if not isinstance(payload, dict):
                    raise ValueError("query must be a JSON object")
            except Exception as e:
                _observe(400, t0)
                return error_response(400, f"invalid query: {e}")
            clock.lap("parse")
            item = QueuedQuery(payload)
            # the worker fills meta with this query's queue-wait/device
            # split + wave mates; annotate() hands it to the flight recorder
            meta: dict[str, Any] = {}
            try:
                with trace("serve.microbatch", record=False) as mb_span:
                    clock.lap("route")
                    status, value, instance_id = await batcher.submit(
                        item, meta
                    )
                    # decompose the await window: queued wait + the wave's
                    # host-stage split, leftover = loop wakeup + future
                    # resolution (the "block until ready" tail)
                    parts = {"queue_wait": meta.get("queue_wait_s") or 0.0}
                    for key, seconds in (
                        meta.get("device_breakdown") or {}
                    ).items():
                        stage = WAVE_STAGE_MAP.get(key, key)
                        parts[stage] = parts.get(stage, 0.0) + seconds
                    clock.split(parts, remainder="block_until_ready")
                    # the wave's stages become device-track fragments of
                    # THIS request's trace, under the serve span
                    note_wave_events(meta, parent=mb_span)
            except LoadShed as e:
                # bounded queue: an honest 503 + Retry-After
                _observe(503, t0)
                return shed_response(str(e), e.retry_after_s)
            except DeadlineExceeded as e:
                _observe(504, t0)
                return error_response(504, f"deadline exceeded: {e}")
            except Exception as e:
                log.exception("query serving failed")
                _observe(500, t0)
                return error_response(500, f"{type(e).__name__}: {e}")
            finally:
                if meta:
                    annotate(**meta)
            _note_wave_provenance(item, payload, meta, instance_id)
            annotate(
                instance_id=instance_id,
                variant=item.prov.get("variant", "default"),
            )
            if status == "bad":
                _observe(400, t0)
                return _stamped(
                    error_response(400, f"invalid query: {value}"), instance_id
                )
            if status == "err":
                log.error("query serving failed: %s", value)
                _observe(500, t0)
                return _stamped(
                    error_response(500, f"{type(value).__name__}: {value}"),
                    instance_id,
                )
            _bump_stats(t0)
            # the decision record keeps what was returned: item ids with
            # raw scores
            provenance.note_answer(value)
            resp = _answer(value, instance_id, item.degraded)
            # encode NOW (memoized: the front end reuses it) so the JSON
            # serialization lands in the serialize stage
            resp.encoded()
            clock.lap("serialize")
            hotpath.observe_clock(clock)
            return resp

    else:

        @app.route("POST", "/queries\\.json")
        def queries(req: Request) -> Response:
            t0 = time.perf_counter()
            clock = StageClock()
            binding = deployed.live_binding()
            iid = binding.instance.id
            try:
                payload = req.json()
                if not isinstance(payload, dict):
                    raise ValueError("query must be a JSON object")
                query = deployed.extract_query(payload)
            except Exception as e:
                _observe(400, t0)
                return _stamped(error_response(400, f"invalid query: {e}"), iid)
            clock.lap("parse")
            # the decision record's identity half: payload + generation
            fields = provenance.binding_fields(deployed, binding)
            provenance.note(payload=payload, **fields)
            annotate(instance_id=iid, variant=fields["variant"])
            clock.lap("route")
            try:
                with deployed.serving_slot(binding), degraded_scope() as degraded:
                    # the wave timeline collects the engine's stage marks so
                    # the predict window splits into named stages; the
                    # unattributed interior is "dispatch"
                    with device_obs.wave_timeline() as timeline:
                        _, prediction = deployed.predict_bound(binding, query)
                    provenance.note(
                        cache={
                            "hits": timeline.cache_hits,
                            "misses": timeline.cache_misses,
                            "generation": iid,
                        }
                    )
            except DeadlineExceeded as e:
                _observe(504, t0)
                return _stamped(error_response(504, f"deadline exceeded: {e}"), iid)
            except Exception as e:
                log.exception("query serving failed")
                _observe(500, t0)
                return _stamped(
                    error_response(500, f"{type(e).__name__}: {e}"), iid
                )
            clock.split(
                {WAVE_STAGE_MAP.get(k, k): v for k, v in timeline.stages.items()},
                remainder="dispatch",
            )
            if degraded:
                provenance.note(degraded=list(degraded))
            rendered = _render_prediction(prediction)
            provenance.note_answer(rendered)
            resp = _answer(rendered, iid, degraded)
            _bump_stats(t0)
            resp.encoded()
            clock.lap("serialize")
            hotpath.observe_clock(clock)
            return resp

    def _authorized(req: Request) -> bool:
        return access_key is None or key_matches(req, access_key)

    @app.route("POST", "/reload")
    def reload(req: Request) -> Response:
        """Hot-swap to the latest COMPLETED instance, gated behind the
        generation manifest: the candidate's checksum and its
        ``sanity_check()`` pass BEFORE the flip; a refusal answers 409 with
        the reason while the old generation keeps serving."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        try:
            inst = deployed.reload_latest()
        except Exception as e:
            log.error("reload refused: %s", e)
            return json_response(
                409,
                {
                    "message": f"reload refused: {e}",
                    "engineInstanceId": deployed.instance.id,
                },
            )
        return json_response(
            200, {"message": "Reloaded", "engineInstanceId": inst.id}
        )

    @app.route("GET", "/lifecycle\\.json")
    def lifecycle_json(req: Request) -> Response:
        """The generation manifest, gated like the other debug routes.
        The canary and the lifecycle controller are not ported yet."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        return json_response(
            200,
            {
                "engineInstanceId": deployed.instance.id,
                "variant": deployed.instance.engine_variant or "default",
                "manifest": deployed.generation_store.snapshot(),
                "controller": {"enabled": False},
                "canary_in_progress": False,
            },
        )

    @app.route("POST", "/stop")
    def stop(req: Request) -> Response:
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        if on_stop is not None:
            threading.Thread(target=on_stop, daemon=True).start()
        return json_response(200, {"message": "Shutting down."})

    # /readyz: a load balancer should only route here when the model is
    # bound, the micro-batcher accepts work, and the event store answers
    def _model_loaded() -> bool:
        return getattr(deployed, "models", None) is not None

    def _batcher_ready() -> bool:
        batcher = getattr(app, "microbatcher", None)
        return batcher is None or not batcher.draining

    def _event_store_ready() -> bool:
        storage = getattr(deployed, "storage", None)
        if storage is None:
            return True
        return storage.l_events() is not None

    # /debug/profile traces the card when the model lives there
    app.profile_cuda = deployed.ctx.device.type == "cuda"
    add_observability_routes(
        app,
        registry,
        access_key=access_key,
        readiness={
            "model_loaded": _model_loaded,
            "microbatcher": _batcher_ready,
            "event_store": _event_store_ready,
        },
        hotpath=hotpath,
    )
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
    server_kind: str = "aio",
    max_queue: int | None = None,
    max_inflight: int | None = None,
    default_deadline_s: float | None = None,
    device: torch.device | str | None = None,
):
    """Deploy the engine and bind the deploy server (not started: call
    ``start_background()`` or ``serve_forever()``).

    ``server_kind="aio"`` (default) serves under the asyncio front end with
    query micro-batching — concurrent /queries.json requests coalesce into
    one vectorized predict per wave.  ``"threaded"`` keeps the
    thread-per-connection server (no batching).  ``POST /stop`` shuts it
    down."""
    deployed = deploy_engine(
        engine_factory_name,
        storage=storage,
        engine_instance_id=engine_instance_id,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        device=device,
    )
    server_ref: list[Any] = []

    def on_stop():
        if server_ref:
            server_ref[0].shutdown()

    app = create_prediction_server_app(
        deployed,
        on_stop=on_stop,
        access_key=access_key,
        use_microbatch=server_kind == "aio",
        max_queue=max_queue,
        max_inflight=max_inflight,
        default_deadline_s=default_deadline_s,
    )
    if server_kind == "aio":
        from predictionio_tpu_torch.server.aio import AsyncAppServer

        server = AsyncAppServer(app, host, port)
    else:
        server = AppServer(app, host, port)
    server_ref.append(server)
    return server
