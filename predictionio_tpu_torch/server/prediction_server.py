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
  GET  /plugins.json  the output plugins (key-gated), and
       /plugins/<type>/<name>/...  a plugin's own REST handler
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

A deployed engine holds up to two generations: the live one and a canary
(``stage_canary``), which answers the entities that hash into its fraction
(``lifecycle.canary.in_canary_fraction`` over the payload's entity id).
The lifecycle controller (``lifecycle.controller``, ``enable_lifecycle`` or
``PIO_LIFECYCLE``) retrains warm on drift or staleness, stages the result
as the canary, and promotes or rolls it back.  One deploy may serve several
engines as tenants (``tenancy``, :func:`deploy_tenant_engines`): each
request resolves its tenant (``X-Pio-App``, ``?app=`` or its access key)
at the front ends' admission gate.  A micro-batched wave splits first by
tenant, then by each tenant's live/canary split, each tenant's bindings
captured once per wave; every partition takes its own serving slot and
runs its own dispatch, fence and release, so the device-wave rules hold
per partition: one of ``DEVICE_BATCH_MIN`` known users or more dispatches
kernel 3 and keeps its retries on the card, a smaller one is answered by
the host replica.  A poison query or a corrupt generation fails only its
own partition.  Every answer names its generation, variant and tenant
(``X-Pio-Engine-Instance``, ``X-Pio-Variant``, ``X-Pio-App``) and is
logged, with that variant, to the online quality monitor
(``obs.quality``), whose feedback join the event server feeds.

Each answer, solo or in a wave, passes the output plugins
(``server.plugins``, ``PIO_PLUGINS``) and then, with ``FeedbackConfig``
enabled, is written back as a ``predict`` event of entity type ``pio_pr``
(CreateServer.scala:527-589); the decision record keeps the answer the
plugins returned.  A failed feedback write is logged and fails no query.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import secrets
import threading
import time
from datetime import datetime, timezone
from typing import Any, Callable, NamedTuple

import torch

from predictionio_tpu_torch.core.base import EngineContext, run_sanity_check
from predictionio_tpu_torch.core.engine import Engine, resolve_engine_factory
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.data.storage.config import (
    StorageRuntime,
    get_storage,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.lifecycle.canary import (
    CANARY_VARIANT,
    in_canary_fraction,
)
from predictionio_tpu_torch.lifecycle.generations import (
    CorruptModelError,
    GenerationStore,
)
from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs import provenance
from predictionio_tpu_torch.obs.alerts import AlertEvaluator, WebhookSink
from predictionio_tpu_torch.obs.costs import (
    CostLedger,
    default_ledger,
    request_cost,
)
from predictionio_tpu_torch.obs.disttrace import note_wave_events
from predictionio_tpu_torch.obs.flight import annotate
from predictionio_tpu_torch.obs.hotpath import (
    WAVE_STAGE_MAP,
    HotPathTracker,
    StageClock,
)
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.obs.incident import IncidentRecorder
from predictionio_tpu_torch.obs.logging import get_request_id
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.obs.quality import (
    DEFAULT_ENTITY_FIELDS,
    QualityMonitor,
    default_quality,
)
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
from predictionio_tpu_torch.server.plugins import PluginContext
from predictionio_tpu_torch.tenancy import (
    APP_HEADER,
    Tenant,
    TenantRegistry,
    TokenBucket,
)
from predictionio_tpu_torch.utils.params import extract_params

log = logging.getLogger("predictionio_tpu_torch.serving")

#: response header naming the generation that answered
INSTANCE_HEADER = "X-Pio-Engine-Instance"
#: response header naming the variant that answered: the engine variant
#: for the live generation, ``canary`` for the canary
VARIANT_HEADER = "X-Pio-Variant"
#: response header listing the degraded-mode reasons of a 200 answer
DEGRADED_HEADER = "X-Pio-Degraded"


class Binding(NamedTuple):
    """One generation's immutable serving snapshot.  Every request and
    every wave partition captures exactly one Binding, so a concurrent swap
    can never hand it a torn mix of old algorithms and new models."""

    instance: EngineInstance
    params: Any
    algorithms: list
    models: list
    serving: Any
    role: str = "live"  # "live" | "canary"


@dataclasses.dataclass
class FeedbackConfig:
    """Loop predictions back into the event store (CreateServer.scala:527-589).

    The reference POSTs to the event server over HTTP with an access key;
    here, as in the JAX package, each answer is written through the storage
    layer directly, keyed by app id (resolved from the access key when
    given)."""

    enabled: bool = False
    app_id: int | None = None
    access_key: str | None = None
    channel_id: int | None = None


class QueuedQuery:
    """One ``/queries.json`` payload in the micro-batcher, for ``tenant``
    (None: the deploy's default tenant).  A wave partition that dispatches
    it to the device sets ``on_device``: if that partition fails, its
    bisection and the batcher's solo retry re-dispatch the query on the
    device, never on the host replica, so a failing card answers 500 and
    not a host answer.  A wave that answers it sets ``degraded`` to the
    degraded-mode reasons of that wave, ``prov`` to the provenance the
    wave collected for it (binding identity and the engine's notes; deep
    fields under ``_deep``), ``variant`` to the variant label that
    answered, and ``partition`` to its partition's record (tenant,
    variant, size, whether it went to the device, its dispatch and
    finalize seconds, and the wave's split seconds)."""

    __slots__ = (
        "payload", "tenant", "on_device", "degraded", "prov", "variant",
        "partition",
    )

    def __init__(self, payload: dict, tenant: Tenant | None = None):
        self.payload = payload
        self.tenant = tenant
        self.on_device = False
        self.degraded: tuple[str, ...] = ()
        self.prov: dict[str, Any] = {}
        self.variant: str | None = None
        self.partition: dict[str, Any] = {}


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

    Holds up to TWO bound generations: the **live** one (the
    ``instance/params/algorithms/models/serving`` attributes) and an
    optional **canary**.  Every flip (swap, promote, rollback) replaces
    whole attribute sets under one lock; readers snapshot a whole
    :class:`Binding` once per request or wave partition, so in-flight work
    finishes on the generation it started on.  A per-generation in-flight
    count (one slot from a partition's dispatch to its fence) gives
    ``wait_drained``, the step after a flip that retires the loser: once
    its last slot is released nothing holds its device factors.
    """

    #: query payload fields probed (in order) for the entity id that the
    #: canary split and the quality join key on
    entity_fields: tuple[str, ...] = DEFAULT_ENTITY_FIELDS

    def __init__(
        self,
        engine: Engine,
        instance: EngineInstance,
        storage: StorageRuntime,
        generation_store: GenerationStore,
        device: torch.device | str | None = None,
        mesh_devices: list | None = None,
    ):
        self.engine = engine
        self.storage = storage
        self.ctx = EngineContext(storage=storage, mode="serving", device=device,
                                 mesh_devices=mesh_devices)
        #: the manifest every swap is verified against and commits through
        self.generation_store = generation_store
        self._lock = threading.RLock()
        self._drain_cond = threading.Condition()
        self._inflight: dict[str, int] = {}
        self._canary_binding: Binding | None = None
        self._canary_fraction = 0.0
        self._install_live(self.load_binding(instance))

    # -- binding construction ------------------------------------------------

    def load_binding(self, instance: EngineInstance, role: str = "live") -> Binding:
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
        return Binding(instance, params, algos, models, serving, role)

    def _install_live(self, binding: Binding) -> None:
        old_models = getattr(self, "models", None)
        with self._lock:
            (
                self.instance, self.params, self.algorithms, self.models,
                self.serving,
            ) = binding[:5]
        # the retired generation's factor caches die with it: a repeat
        # entity's next request gathers from the NEW generation's factors
        if old_models is not None and old_models is not binding.models:
            device_cache.invalidate_model_caches(old_models, "swap")

    # -- snapshots -----------------------------------------------------------

    def live_binding(self) -> Binding:
        with self._lock:
            return Binding(
                self.instance, self.params, self.algorithms, self.models,
                self.serving, "live",
            )

    def canary_binding(self) -> Binding | None:
        with self._lock:
            return self._canary_binding

    def canary_split(self) -> tuple[Binding | None, float]:
        with self._lock:
            return self._canary_binding, self._canary_fraction

    @property
    def canary_instance(self) -> EngineInstance | None:
        b = self._canary_binding
        return b.instance if b is not None else None

    @property
    def variant_label(self) -> str:
        return getattr(self.instance, "engine_variant", None) or "default"

    def binding_label(self, binding: Binding) -> str:
        return (
            CANARY_VARIANT if binding.role == "canary" else self.variant_label
        )

    def binding_for_entity(self, entity: str | None) -> Binding:
        """Route one query: the canary when one is staged AND the entity
        hashes into its fraction (the same side for the same entity), else
        live."""
        with self._lock:
            canary = self._canary_binding
            fraction = self._canary_fraction
        if canary is not None and in_canary_fraction(entity, fraction):
            return canary
        return self.live_binding()

    def payload_entity(self, payload: Any) -> str | None:
        """The joinable entity id of a query payload (the fields the
        quality joiner keys on)."""
        if isinstance(payload, dict):
            for f in self.entity_fields:
                v = payload.get(f)
                if v is not None:
                    return str(v)
        return None

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

    # -- lifecycle transitions ----------------------------------------------

    def stage_canary(self, instance: EngineInstance, fraction: float) -> None:
        """Bind a staged generation as the canary: loaded onto the device
        outside the lock, flipped under it.  A canary it replaces loses its
        factor caches (``canary_flip``)."""
        binding = self.load_binding(instance, role="canary")
        with self._lock:
            replaced = self._canary_binding
            self._canary_binding = binding
            self._canary_fraction = fraction
        if replaced is not None:
            device_cache.invalidate_model_caches(replaced.models, "canary_flip")

    def promote_canary(self) -> EngineInstance:
        """The in-memory flip: the canary becomes live in one lock region.
        A request admitted before the flip finishes on the binding it
        captured; one admitted after sees only the new one."""
        with self._lock:
            binding = self._canary_binding
            if binding is None:
                raise RuntimeError("no canary generation to promote")
            old = self.instance
            self._install_live(binding._replace(role="live"))
            self._canary_binding = None
            self._canary_fraction = 0.0
        log.info("promoted generation %s (was %s)", binding.instance.id, old.id)
        return binding.instance

    def clear_canary(self) -> None:
        """Drop the canary (a rollback): its factor caches die with it
        (``canary_flip``); live traffic never notices."""
        with self._lock:
            dropped = self._canary_binding
            self._canary_binding = None
            self._canary_fraction = 0.0
        if dropped is not None:
            device_cache.invalidate_model_caches(dropped.models, "canary_flip")

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

    @staticmethod
    def _canary_seam(binding: Binding) -> None:
        """The ``canary.predict`` fault seam: every answer a canary
        binding computes passes it (solo, host wave, device dispatch)."""
        if binding.role == "canary" and faults.ACTIVE is not None:
            faults.ACTIVE.check("canary.predict", binding.instance.id)

    def predict_bound(self, binding: Binding, query: Any) -> tuple[Any, Any]:
        """One query: supplement, predict per algorithm, serve."""
        self._canary_seam(binding)
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
        self._canary_seam(binding)
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
        self._canary_seam(binding)
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
    mesh_devices: list | None = None,
) -> DeployedEngine:
    """Resolve factory + engine instance and materialize its models on
    ``device`` (default CUDA; raises without a card unless
    ``device="cpu"``).  ``mesh_devices`` are the slots a sharded model's
    recorded plan binds onto (default: the visible devices of ``device``'s
    type, see ``EngineContext``).

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
        factory(), instance, storage, gen_store, device=device,
        mesh_devices=mesh_devices
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
    feedback: FeedbackConfig | None = None,
    on_stop: Callable[[], None] | None = None,
    access_key: str | None = None,
    #: output blockers and sniffers; None = ``PluginContext.from_env()``
    #: (``PIO_PLUGINS``)
    plugins: PluginContext | None = None,
    use_microbatch: bool = False,
    #: the JAX package's default wave cap
    max_batch: int = 32,
    registry: MetricsRegistry | None = None,
    #: the online quality monitor answers are logged to; None = the process
    #: default on the default registry (so an embedded event server's
    #: feedback joins this server's predictions), else a monitor of its own
    quality: QualityMonitor | None = None,
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
    #: the closed-loop lifecycle controller: None = PIO_LIFECYCLE, True /
    #: False = explicit; a built LifecycleController may be passed (tests)
    enable_lifecycle: bool | None = None,
    lifecycle: Any = None,
    lifecycle_policy: Any = None,
    #: start the controller's thread (tests drive tick() directly)
    lifecycle_autostart: bool = True,
    #: the resident tenants this deploy serves; None wraps ``deployed`` in
    #: one default tenant.  Each request resolves its tenant (X-Pio-App,
    #: ?app=, its access key) at the front ends' admission gate
    tenants: TenantRegistry | None = None,
    #: the watch loop (alert rules + incident bundles): None = PIO_ALERTS
    #: (default on); built instances may be passed (tests)
    enable_alerts: bool | None = None,
    alerts: AlertEvaluator | None = None,
    incidents: IncidentRecorder | None = None,
    #: start the evaluator's thread when a server starts serving (tests
    #: drive tick() directly)
    alerts_autostart: bool = True,
    #: the per-app cost ledger: None = the process default on the default
    #: registry (an embedded event server bills into the same one), else
    #: a ledger of its own
    costs: CostLedger | None = None,
) -> HTTPApp:
    from predictionio_tpu_torch.lifecycle.controller import (
        LifecycleController,
        LifecyclePolicy,
    )

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
    feedback = feedback or FeedbackConfig()
    plugins = plugins or PluginContext.from_env()
    #: the front ends read these: deadline admission + binding, and the
    #: in-flight shed gate
    app.default_deadline_s = default_deadline_s
    if max_inflight is not None:
        app.admission = AdmissionController(max_inflight, registry=registry)
    started_at = datetime.now(tz=timezone.utc)
    stats = {"request_count": 0, "avg_serving_sec": 0.0, "last_serving_sec": 0.0}
    stats_lock = threading.Lock()
    if quality is None:
        quality = (
            default_quality()
            if registry is REGISTRY
            else QualityMonitor(registry=registry)
        )
    # the per-app cost ledger: bills key on (app, route, variant); the app
    # a deploy serves is its engine (PIO_COST_APP names it otherwise)
    if costs is None:
        costs = (
            default_ledger()
            if registry is REGISTRY
            else CostLedger(registry=registry)
        )
    app.costs = costs

    # -- tenants: a single-engine deploy is one default tenant, so both
    # front ends run the same gate (quota, in-flight cap) whether a deploy
    # hosts one engine or several; the implicit tenant declares 0 bytes
    # (nothing to bin-pack: it is already resident)
    default_app = os.environ.get("PIO_COST_APP") or str(
        getattr(deployed.instance, "engine_factory", None)
        or getattr(deployed.instance, "engine_id", None)
        or "engine"
    )
    if tenants is None:
        tenants = TenantRegistry(registry=registry)
    if tenants.default is None:
        tenants.admit(Tenant(
            default_app, deployed, quality=quality, cost_name=default_app,
            hbm_bytes=0,
        ))
    default_tenant = tenants.default
    app.tenants = tenants

    def _req_tenant(req: Request) -> Tenant:
        # the admission gate stamps req.tenant; resolving here covers
        # callers that drive a handler directly
        t = getattr(req, "tenant", None)
        if t is None:
            t = tenants.resolve(req) or default_tenant
        return t

    # -- the lifecycle controller: manifest + canary + retrain loop
    if enable_lifecycle is None and lifecycle is None:
        enable_lifecycle = os.environ.get("PIO_LIFECYCLE", "").lower() in (
            "1", "on", "true", "yes",
        )
    if lifecycle is None and enable_lifecycle:
        lifecycle = LifecycleController(
            deployed,
            deployed.generation_store,
            quality=quality,
            policy=lifecycle_policy or LifecyclePolicy.from_env(),
            registry=registry,
        )
    app.lifecycle = lifecycle
    canary_tracker = lifecycle.tracker if lifecycle is not None else None
    if lifecycle is not None and lifecycle_autostart:
        lifecycle.start()

    def _observe_variant(variant: str, status: int, t0: float) -> None:
        """Feed the canary guardrails (error rate and latency per side)."""
        if canary_tracker is not None:
            canary_tracker.observe(
                variant == CANARY_VARIANT, status, time.perf_counter() - t0
            )

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

    def _stamped(resp: Response, instance_id: str, variant: str,
                 tenant: Tenant) -> Response:
        resp.headers[INSTANCE_HEADER] = instance_id
        resp.headers[VARIANT_HEADER] = variant
        resp.headers[APP_HEADER] = tenant.name
        return resp

    def _answer(value: Any, instance_id: str, variant: str, tenant: Tenant,
                degraded) -> Response:
        """A 200 answer, stamped with its generation, variant and tenant
        and, when the engine fell back to a degraded answer (metrics carry
        ``pio_degraded_total``), the reasons."""
        resp = _stamped(json_response(200, value), instance_id, variant, tenant)
        if degraded:
            resp.headers[DEGRADED_HEADER] = ",".join(degraded)
        return resp

    # solo-path host-stage attribution (obs/hotpath.py): every fully served
    # request decomposes into named host stages at /hotpath.json
    hotpath = HotPathTracker(registry)

    if feedback.enabled and feedback.app_id is None:
        if not feedback.access_key:
            raise RuntimeError(
                "feedback requires an app_id or access_key to route events"
            )
        k = deployed.storage.access_keys().get(feedback.access_key)
        if k is None:
            raise RuntimeError("feedback access key is invalid")
        feedback.app_id = k.appid

    def _feedback_event(
        instance_id: str, query: Any, rendered_prediction: Any
    ) -> None:
        ev = Event(
            event="predict",
            entity_type="pio_pr",
            entity_id=secrets.token_hex(32),
            properties=DataMap(
                {
                    "engineInstanceId": instance_id,
                    "query": _render_prediction(query),
                    "prediction": rendered_prediction,
                }
            ),
        )
        deployed.storage.l_events().insert(
            ev, feedback.app_id, feedback.channel_id
        )

    def _postprocess(instance_id: str, payload: dict, query: Any,
                     prediction: Any) -> Any:
        """Render, the output plugins, then feedback: the feedback event
        and the decision record both see the answer after the plugins.  A
        plugin that raises fails this query; a failed feedback write is
        logged and never does."""
        rendered = plugins.process_output(
            instance_id, payload, _render_prediction(prediction)
        )
        if feedback.enabled:
            try:
                _feedback_event(instance_id, query, rendered)
            except Exception as e:
                log.error("feedback event failed: %s", e)
        return rendered

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
                "apps": tenants.apps(),
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

        def _predict_bisect(dep, binding, parsed, idxs, out, on_device,
                            depth=0):
            """Batched predict with bisection fault isolation: a failing
            partition splits in half and each half retries batched, so P
            poison queries cost O(P log B) extra waves instead of B solo
            predicts.  The whole recursion runs against ONE captured
            binding.  The halves of a device partition (``on_device``)
            re-dispatch on the device at any size and fence inline: a card
            that keeps failing fails every query of the partition."""
            queries = [parsed[i][1] for i in idxs]
            try:
                if on_device:
                    results = dep.dispatch_batch_bound(
                        binding, queries, force=True
                    )()
                else:
                    results = dep.predict_batch_bound(binding, queries)
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
                        dep, binding, parsed, half, out, on_device, depth + 1
                    )
                return
            for i, (q, pred) in zip(idxs, results):
                out[i] = ("pred", (q, pred))

        def _serve_wave(items):
            """One wave of :class:`QueuedQuery`, partitioned, each
            partition split at the fence.

            The split: the wave partitions first by tenant, then by that
            tenant's live/canary split (the entity hash of each payload),
            with each tenant's live and canary bindings captured once for
            the wave.  Then, per partition, the DISPATCH half runs here on
            the worker thread: extract, then ``dispatch_batch_bound``
            against the partition's binding (gather, upload, kernel launch,
            the result's copy into pinned memory; nothing blocks), holding
            one serving slot of that generation.  The FINALIZE half (fence,
            serve, render) of every partition rides one :class:`PendingWave`
            onto the finalizer thread, which releases each slot.  A wave
            whose partitions all compute on the host (each below
            ``DEVICE_BATCH_MIN``) runs inline here instead: the busy worker
            is what lets queue pressure coalesce the next wave.

            A device partition marks its queries ``on_device``.  When its
            dispatch or fence fails, its bisection re-dispatches on the
            device, and so does the batcher's solo retry of any of its
            queries: no failed device work is answered from the host
            replica.  A dispatch that raised counts as a device partition,
            since the card may be what failed.  A failure stays inside its
            partition.  Each result is ("ok", rendered, instance id) |
            ("bad", error, id) -> 400 | ("err", error, id) -> 500; the
            query's ``variant`` and ``partition`` name its route.  The
            degraded-mode reasons that either half collected go on every
            query the wave answered (``QueuedQuery.degraded``)."""
            t_split = time.perf_counter()
            wave_tenants: list[Tenant] = []
            for it in items:
                t = it.tenant or default_tenant
                if not any(t is wt for wt in wave_tenants):
                    wave_tenants.append(t)
            splits = {}
            for t in wave_tenants:
                canary_b, fraction = t.deployed.canary_split()
                splits[id(t)] = (t.deployed.live_binding(), canary_b, fraction)
            bindings = []
            for it in items:
                t = it.tenant or default_tenant
                live_b, canary_b, fraction = splits[id(t)]
                b = live_b
                if canary_b is not None and in_canary_fraction(
                    t.deployed.payload_entity(it.payload), fraction
                ):
                    b = canary_b
                bindings.append(b)
            # partitions in the order of their first query: (tenant,
            # binding, indices into the wave)
            partitions: list[list] = []
            for t in wave_tenants:
                live_b, canary_b, _ = splits[id(t)]
                for b in (live_b, canary_b):
                    idx = [i for i, bi in enumerate(bindings) if bi is b]
                    if idx:
                        partitions.append([t, b, idx])
            split_s = time.perf_counter() - t_split
            # the decision record's identity half, once per binding; the
            # engine's notes collect in a wave-scoped provenance collector
            # per partition (the request scopes are invisible on the
            # batcher's threads) and reach each query through its ``prov``
            base_prov = {
                id(b): dict(provenance.binding_fields(t.deployed, b), app=t.name)
                for t, b, _ in partitions
            }
            part_notes: dict[int, dict[str, Any]] = {}

            def _merge_notes(b, wtoken) -> None:
                collected = provenance.end_wave(wtoken)
                deep = collected.pop("_deep", None)
                notes = part_notes.setdefault(id(b), {})
                notes.update(collected)
                if deep:
                    notes.setdefault("_deep", {}).update(deep)

            out: list[tuple] = []
            # per partition: its ok indices, its finalize (or None), whether
            # it is a device partition, and its record
            work: list[tuple] = []
            with degraded_scope() as degraded:
                for it in items:
                    dep = (it.tenant or default_tenant).deployed
                    try:
                        out.append(("q", dep.extract_query(it.payload)))
                    except Exception as e:
                        out.append(("bad", e))
                parsed = list(out)
                for t, b, idx in partitions:
                    dep = t.deployed
                    on_device = any(items[i].on_device for i in idx)
                    ok_idx = [i for i in idx if parsed[i][0] == "q"]
                    record = {
                        "app": t.name, "variant": dep.binding_label(b),
                        "instance_id": b.instance.id, "size": len(idx),
                        "split_s": split_s,
                    }
                    fin = None
                    if ok_idx:
                        dep.acquire_slot(b)
                        t_disp = time.perf_counter()
                        wtoken = provenance.begin_wave()
                        try:
                            fin = dep.dispatch_batch_bound(
                                b, [parsed[i][1] for i in ok_idx],
                                force=on_device,
                            )
                        except Exception:
                            # dispatch failed before the fence: the finalize
                            # half re-runs the partition with bisection on
                            # the device, which names the real poison
                            log.exception(
                                "device partition dispatch failed; "
                                "bisecting on the device"
                            )
                            on_device = True
                        else:
                            on_device = fin is not None
                        finally:
                            _merge_notes(b, wtoken)
                            record["dispatch_s"] = time.perf_counter() - t_disp
                    record["on_device"] = on_device
                    if on_device:
                        for i in ok_idx:
                            items[i].on_device = True
                    work.append((t, b, idx, ok_idx, fin, on_device, record))
            degraded_pre = tuple(degraded)

            def _finalize():
                remaining = list(work)
                try:
                    with degraded_scope() as degraded:
                        while remaining:
                            t, b, _, ok_idx, fin, on_device, record = remaining[0]
                            dep = t.deployed
                            t_fin = time.perf_counter()
                            wtoken = provenance.begin_wave()
                            try:
                                if fin is not None:
                                    try:
                                        results = fin()
                                    except DeadlineExceeded:
                                        raise
                                    except Exception:
                                        log.exception(
                                            "device partition finalize "
                                            "failed; bisecting on the device"
                                        )
                                        _predict_bisect(
                                            dep, b, parsed, ok_idx, out, True
                                        )
                                    else:
                                        for i, (q, pred) in zip(ok_idx, results):
                                            out[i] = ("pred", (q, pred))
                                elif ok_idx:
                                    _predict_bisect(
                                        dep, b, parsed, ok_idx, out, on_device
                                    )
                            finally:
                                _merge_notes(b, wtoken)
                                if ok_idx:
                                    dep.release_slot(b)
                                record["finalize_s"] = (
                                    time.perf_counter() - t_fin
                                )
                                remaining.pop(0)
                except BaseException:
                    for t, b, _, ok_idx, _, _, _ in remaining:
                        if ok_idx:
                            t.deployed.release_slot(b)
                    raise
                deg = degraded_pre + tuple(
                    d for d in degraded if d not in degraded_pre
                )
                done: list = [None] * len(items)
                for t, b, idx, _, _, _, record in work:
                    iid = b.instance.id
                    variant = t.deployed.binding_label(b)
                    prov = {**base_prov[id(b)], **part_notes.get(id(b), {})}
                    for i in idx:
                        it = items[i]
                        tag, value = out[i]
                        it.prov = dict(prov)
                        it.variant = variant
                        it.partition = record
                        if tag == "pred":
                            try:
                                tag, value = "ok", _postprocess(
                                    iid, it.payload, *value
                                )
                            except Exception as e:  # only this item fails
                                tag, value = "err", e
                        if tag == "ok":
                            it.degraded = deg
                        done[i] = (tag, value, iid)
                return done

            if all(w[4] is None for w in work):
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
            tenant = _req_tenant(req)
            item = QueuedQuery(payload, tenant)
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
                costs.note_shed(
                    tenant.cost_name, "/queries.json",
                    tenant.deployed.variant_label,
                )
                return shed_response(str(e), e.retry_after_s)
            except DeadlineExceeded as e:
                # the budget ran out while queued (or mid-wave): the queue
                # seconds it held were real, so they still bill
                _observe(504, t0)
                costs.bill_meta(
                    tenant.cost_name, "/queries.json",
                    tenant.deployed.variant_label, meta, queue_only=True,
                )
                return error_response(504, f"deadline exceeded: {e}")
            except Exception as e:
                log.exception("query serving failed")
                _observe(500, t0)
                return error_response(500, f"{type(e).__name__}: {e}")
            finally:
                if meta:
                    annotate(**meta)
            variant = item.variant or tenant.deployed.variant_label
            # the member's share of its wave, billed to the tenant and the
            # variant of the partition that answered it, for every answered
            # status (400/500 included: the wave computed for it), so the
            # ledger's device seconds sum to the batcher's
            costs.bill_meta(tenant.cost_name, "/queries.json", variant, meta)
            _note_wave_provenance(item, payload, meta, instance_id)
            annotate(instance_id=instance_id, variant=variant)
            if status == "bad":
                _observe(400, t0)
                _observe_variant(variant, 400, t0)
                return _stamped(
                    error_response(400, f"invalid query: {value}"),
                    instance_id, variant, tenant,
                )
            if status == "err":
                log.error("query serving failed: %s", value)
                _observe(500, t0)
                _observe_variant(variant, 500, t0)
                return _stamped(
                    error_response(500, f"{type(value).__name__}: {value}"),
                    instance_id, variant, tenant,
                )
            _bump_stats(t0)
            _observe_variant(variant, 200, t0)
            (tenant.quality or quality).observe_prediction(
                get_request_id(), payload, value, variant=variant,
                wave_size=meta.get("wave_size"), wave_seq=meta.get("wave_seq"),
            )
            # the decision record keeps what was returned: item ids with
            # raw scores
            provenance.note_answer(value)
            resp = _answer(value, instance_id, variant, tenant, item.degraded)
            # encode NOW (memoized: the front end reuses it) so the JSON
            # serialization lands in the serialize stage
            resp.encoded()
            clock.lap("serialize")
            hotpath.observe_clock(clock)
            return resp

    else:

        @app.route("POST", "/queries\\.json")
        def queries(req: Request) -> Response:
            # the whole solo path runs on this thread, so one bound
            # RequestCost catches its storage reads directly; the predict
            # window's device time bills on exit
            tenant = _req_tenant(req)
            with request_cost(
                tenant.cost_name, "/queries.json",
                tenant.deployed.variant_label, ledger=costs,
            ) as cost_rec:
                return _solo_query(req, tenant, cost_rec)

        def _solo_query(req: Request, tenant: Tenant, cost_rec) -> Response:
            t0 = time.perf_counter()
            clock = StageClock()
            dep = tenant.deployed
            try:
                payload = req.json()
                if not isinstance(payload, dict):
                    raise ValueError("query must be a JSON object")
                query = dep.extract_query(payload)
            except Exception as e:
                _observe(400, t0)
                return _stamped(
                    error_response(400, f"invalid query: {e}"),
                    dep.instance.id, dep.variant_label, tenant,
                )
            clock.lap("parse")
            binding = dep.binding_for_entity(dep.payload_entity(payload))
            iid = binding.instance.id
            variant = dep.binding_label(binding)
            cost_rec.variant = variant
            # the decision record's identity half: payload + generation
            provenance.note(
                payload=payload, app=tenant.name,
                **provenance.binding_fields(dep, binding),
            )
            annotate(instance_id=iid, variant=variant)
            clock.lap("route")
            try:
                with dep.serving_slot(binding), degraded_scope() as degraded:
                    # the wave timeline collects the engine's stage marks so
                    # the predict window splits into named stages; the
                    # unattributed interior is "dispatch"
                    timeline = None
                    t_pred = time.perf_counter()
                    try:
                        with device_obs.wave_timeline() as timeline:
                            query, prediction = dep.predict_bound(
                                binding, query
                            )
                    finally:
                        # solo device_s is the predict window, the bracket
                        # the batcher draws around a wave (billed on error
                        # paths too: the compute happened)
                        cost_rec.add(device_s=time.perf_counter() - t_pred)
                        if timeline is not None:
                            cost_rec.add(
                                flops=timeline.flops,
                                hbm_bytes=timeline.bytes,
                                storage_bytes=timeline.storage_bytes,
                                cache_hits=timeline.cache_hits,
                                cache_misses=timeline.cache_misses,
                            )
                    provenance.note(
                        cache={
                            "hits": timeline.cache_hits,
                            "misses": timeline.cache_misses,
                            "generation": iid,
                        }
                    )
            except DeadlineExceeded as e:
                _observe(504, t0)
                return _stamped(
                    error_response(504, f"deadline exceeded: {e}"),
                    iid, variant, tenant,
                )
            except Exception as e:
                log.exception("query serving failed")
                _observe(500, t0)
                _observe_variant(variant, 500, t0)
                return _stamped(
                    error_response(500, f"{type(e).__name__}: {e}"),
                    iid, variant, tenant,
                )
            clock.split(
                {WAVE_STAGE_MAP.get(k, k): v for k, v in timeline.stages.items()},
                remainder="dispatch",
            )
            if degraded:
                provenance.note(degraded=list(degraded))
            try:
                rendered = _postprocess(iid, payload, query, prediction)
            except Exception as e:
                log.exception("query rendering failed")
                _observe(500, t0)
                _observe_variant(variant, 500, t0)
                return _stamped(
                    error_response(500, f"{type(e).__name__}: {e}"),
                    iid, variant, tenant,
                )
            provenance.note_answer(rendered)
            resp = _answer(rendered, iid, variant, tenant, degraded)
            _bump_stats(t0)
            _observe_variant(variant, 200, t0)
            (tenant.quality or quality).observe_prediction(
                get_request_id(), payload, rendered, variant=variant
            )
            resp.encoded()
            clock.lap("serialize")
            hotpath.observe_clock(clock)
            return resp

    def _authorized(req: Request) -> bool:
        return access_key is None or key_matches(req, access_key)

    @app.route("POST", "/reload")
    def reload(req: Request) -> Response:
        """Hot-swap the request's tenant to its latest COMPLETED instance,
        gated behind the generation manifest: the candidate's checksum and
        its ``sanity_check()`` pass BEFORE the flip; a refusal answers 409
        with the reason while the old generation keeps serving."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        t = _req_tenant(req)
        try:
            inst = t.deployed.reload_latest()
        except Exception as e:
            log.error("reload refused (app=%s): %s", t.name, e)
            return json_response(
                409,
                {
                    "message": f"reload refused: {e}",
                    "app": t.name,
                    "engineInstanceId": t.deployed.instance.id,
                },
            )
        return json_response(
            200,
            {"message": "Reloaded", "app": t.name, "engineInstanceId": inst.id},
        )

    @app.route("GET", "/lifecycle\\.json")
    def lifecycle_json(req: Request) -> Response:
        """The generation manifest and the canary and controller state,
        gated like the other debug routes."""
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        body: dict[str, Any] = {
            "engineInstanceId": deployed.instance.id,
            "variant": deployed.variant_label,
            "manifest": deployed.generation_store.snapshot(),
            "controller": (
                app.lifecycle.snapshot()
                if app.lifecycle is not None
                else {"enabled": False}
            ),
        }
        canary_b, fraction = deployed.canary_split()
        body["canary_in_progress"] = canary_b is not None
        if canary_b is not None:
            body["canary_instance"] = canary_b.instance.id
            body["canary_fraction"] = fraction
        return json_response(200, body)

    # -- plugins (CreateServer.scala:656-702) --------------------------------
    @app.route("GET", "/plugins\\.json")
    def list_plugins(req: Request) -> Response:
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        return json_response(200, {"plugins": plugins.descriptions()})

    @app.route(
        "GET", "/plugins/(?P<ptype>[^/]+)/(?P<pname>[^/]+)(?P<rest>/.*)?"
    )
    def plugin_rest(req: Request) -> Response:
        if not _authorized(req):
            return error_response(401, "Invalid accessKey.")
        return plugins.rest_response(
            req.params["ptype"], req.params["pname"],
            req.params.get("rest") or "/", req.query,
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

    def _storage_breakers_ok() -> bool:
        # an open breaker to any of this runtime's storage daemons flips
        # /readyz: serving may continue (device waves answer from the bound
        # model), but operators and load balancers see the outage; a
        # half-open breaker reads as recovering and does not flip it
        storage = getattr(deployed, "storage", None)
        if storage is None or not hasattr(storage, "breakers"):
            return True
        return all(br.state != "open" for br in storage.breakers())

    # -- the watch loop: alert rules engine + incident recorder --------------
    # the evaluator ticks the default pack (plus PIO_ALERT_RULES) against
    # this process's registry, SLO, breakers, drift, capacity and cost
    # ledger on the host (it never touches a CUDA stream); a firing
    # transition snapshots a forensic bundle before the rings rotate
    if enable_alerts is None and alerts is None:
        enable_alerts = os.environ.get("PIO_ALERTS", "1").lower() not in (
            "0", "off", "false", "no",
        )
    if alerts is None and enable_alerts:
        if incidents is None:
            incidents = IncidentRecorder(registry=registry, app=app)
        sinks = []
        webhook = os.environ.get("PIO_ALERT_WEBHOOK")
        if webhook:
            sinks.append(WebhookSink(webhook, registry=registry))
        alerts = AlertEvaluator(
            registry=registry,
            app=app,
            interval_s=float(os.environ.get("PIO_ALERT_INTERVAL_S", "5")),
            sinks=sinks,
            incidents=incidents,
        )
    elif alerts is not None and incidents is not None:
        alerts.incidents = incidents
    if alerts is not None:
        alerts.app = app
    if incidents is not None:
        incidents.app = app

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
            "storage_breakers": _storage_breakers_ok,
        },
        hotpath=hotpath,
        quality=quality,
        tenants=tenants,
        alerts=alerts,
        incidents=incidents,
        costs=costs,
    )
    # the evaluator starts when a server starts serving (AppServer and
    # AsyncAppServer honour this flag), not here: a process that builds
    # many apps (tests, tooling) must not keep one idle watcher per app
    app.alerts_autostart = alerts is not None and alerts_autostart
    return app


def undeploy_stale(host: str, port: int, access_key: str | None = None) -> bool:
    """POST /stop to whatever serves on (host, port) before binding: the
    MasterActor's undeploy-then-bind (CreateServer.scala:281-306).  Plain
    HTTP, as in the JAX package: a stale server on TLS is not reached."""
    import urllib.request

    probe_host = "127.0.0.1" if host in ("0.0.0.0", "") else host
    url = f"http://{probe_host}:{port}/stop"
    if access_key:
        url += f"?accessKey={access_key}"
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=3
        ):
            pass
        time.sleep(0.5)  # give the old server a beat to release the port
        return True
    except Exception:
        return False


def create_prediction_server(
    engine_factory_name: str,
    host: str = "0.0.0.0",
    port: int = 8000,
    storage: StorageRuntime | None = None,
    engine_instance_id: str | None = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    feedback: FeedbackConfig | None = None,
    access_key: str | None = None,
    plugins: PluginContext | None = None,
    server_kind: str = "aio",
    max_batch: int = 32,
    max_queue: int | None = None,
    max_inflight: int | None = None,
    default_deadline_s: float | None = None,
    device: torch.device | str | None = None,
    enable_lifecycle: bool | None = None,
):
    """Deploy the engine and bind the deploy server (not started: call
    ``start_background()`` or ``serve_forever()``).

    A non-zero ``port`` first stops a stale server there
    (:func:`undeploy_stale`); port 0 binds a free port and probes nothing.
    ``server_kind="aio"`` (default) serves under the asyncio front end with
    query micro-batching — concurrent /queries.json requests coalesce into
    one vectorized predict per wave of at most ``max_batch``.
    ``"threaded"`` keeps the thread-per-connection server (no batching).
    Both serve TLS when ``PIO_SSL_CERTFILE`` names a certificate.
    ``enable_lifecycle`` runs the lifecycle controller (None:
    ``PIO_LIFECYCLE``).  ``POST /stop`` shuts it down."""
    if port and undeploy_stale(host, port, access_key):
        log.info("undeployed stale server on port %d", port)
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
        feedback=feedback,
        on_stop=on_stop,
        access_key=access_key,
        plugins=plugins,
        use_microbatch=server_kind == "aio",
        max_batch=max_batch,
        max_queue=max_queue,
        max_inflight=max_inflight,
        default_deadline_s=default_deadline_s,
        enable_lifecycle=enable_lifecycle,
    )
    if server_kind == "aio":
        from predictionio_tpu_torch.server.aio import AsyncAppServer

        server = AsyncAppServer(app, host, port)
    else:
        server = AppServer(app, host, port)
    server_ref.append(server)
    return server


def deploy_tenant_engines(
    specs: list[dict],
    storage: StorageRuntime | None = None,
    hbm_budget_bytes: int | None = None,
    registry: MetricsRegistry | None = None,
    device: torch.device | str | None = None,
) -> TenantRegistry:
    """Deploy several engines into one :class:`TenantRegistry`, each on
    ``device`` (default CUDA; raises without a card unless
    ``device="cpu"``): the multi-tenant deploy's boot path (``deploy --app
    name=... --app name=...``).

    Each spec is ``{"app": name, "engine_factory": ..., "engine_id": ...,
    "engine_version": ..., "engine_variant": ..., "engine_instance_id": ...,
    "quota_rps": ..., "quota_burst": ..., "max_inflight": ...,
    "default_deadline_s": ..., "access_key": ...}`` (only ``app`` and
    ``engine_factory`` required).  Admission bin-packs each generation's
    stored bytes against ``hbm_budget_bytes``.  As in the JAX package a
    tenant is deployed before it is admitted: one that does not fit raises
    :class:`~predictionio_tpu_torch.tenancy.TenantAdmissionError` naming
    the shortfall, its engine is dropped with the raise (its device
    factors go once nothing references them), and the residents admitted
    before it are untouched."""
    tenants = TenantRegistry(
        hbm_budget_bytes=hbm_budget_bytes, registry=registry
    )
    for spec in specs:
        dep = deploy_engine(
            spec.get("engine_factory") or spec.get("engine_factory_name") or "",
            storage=storage,
            engine_instance_id=spec.get("engine_instance_id"),
            engine_id=spec.get("engine_id", "default"),
            engine_version=spec.get("engine_version", "default"),
            engine_variant=spec.get("engine_variant", "default"),
            device=device,
        )
        quota = None
        if spec.get("quota_rps"):
            quota = TokenBucket(
                float(spec["quota_rps"]), spec.get("quota_burst")
            )
        tenants.admit(
            Tenant(
                spec["app"],
                dep,
                quota=quota,
                max_inflight=spec.get("max_inflight"),
                default_deadline_s=spec.get("default_deadline_s"),
                access_key=spec.get("access_key"),
            )
        )
    return tenants


def create_multi_tenant_server_app(
    tenants: TenantRegistry, **kwargs: Any
) -> HTTPApp:
    """A prediction-server app over an already-populated
    :class:`TenantRegistry`: the registry's default tenant anchors the
    single-engine surfaces (``/``, ``/status.json``'s engineInstanceId,
    ``/lifecycle.json``); every other surface resolves its tenant per
    request."""
    default = tenants.default
    if default is None:
        raise ValueError("tenant registry has no resident tenants")
    return create_prediction_server_app(
        default.deployed, tenants=tenants, **kwargs
    )
