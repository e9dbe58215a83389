"""The train and evaluation workflows (workflow/CoreWorkflow.scala
runTrain:45, runEvaluation:101).

The JAX package's ``run_train``: run the engine's train pipeline, persist
the models into the MODELDATA store (with the serving ShardPlan, if an
algorithm declares one, as the ``:shardplan`` sidecar), and record an
EngineInstance row whose status goes INIT -> COMPLETED, or FAILED when a
stage raises.  The seconds
of each DASE stage and of the persist step, on the host clock, are logged
as one JSON breakdown (the record's ``stages`` attribute).

The JAX package's ``run_evaluation``: sweep the engine-params list with a
``MetricEvaluator`` and record an EvaluationInstance row whose status goes
EVALUATING -> EVALCOMPLETED (with the evaluator's one-liner, HTML and
JSON), or FAILED; the registered cleanup hooks run either way.
``run_fake`` records any function's run the same way.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
import uuid
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Callable, Sequence

from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.persistence import load_models, save_models
from predictionio_tpu_torch.core.persistent_model import (
    PersistentModel,
    PersistentModelManifest,
)
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EvaluationInstance,
)
from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage

# the serving-layout sidecar's key suffix and reader: defined in
# lifecycle.generations, importable from here as in the JAX package
from predictionio_tpu_torch.lifecycle.generations import (  # noqa: F401
    SHARD_PLAN_SUFFIX,
    read_shard_plan,
)

log = logging.getLogger("predictionio_tpu_torch.workflow")


@dataclass
class WorkflowParams:
    """Workflow flags (workflow/WorkflowParams.scala:32)."""

    batch: str = ""
    verbose: int = 2
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


def _now() -> datetime:
    return datetime.now(tz=timezone.utc)


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    ctx: EngineContext | None = None,
    workflow_params: WorkflowParams | None = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
    engine_factory: str = "",
    storage: StorageRuntime | None = None,
    warm_start_from: str | None = None,
) -> EngineInstance | None:
    """Train, persist models, and record the engine instance.

    Returns the COMPLETED EngineInstance (the deploy handle), or None when
    stopped early by stop_after_read/stop_after_prepare (no instance row is
    kept).  On failure the row is left in status FAILED and the exception
    re-raised.  ``ctx=None`` builds a context on CUDA (which raises without
    a card).

    ``warm_start_from`` names a previous engine instance whose persisted
    models seed this run (``ctx.warm_start``); a missing or unreadable
    previous model degrades to a cold start (logged), never a failed
    retrain."""
    storage = storage or (ctx.storage if ctx is not None else None) or get_storage()
    ctx = ctx or EngineContext(storage=storage)
    if warm_start_from is not None and ctx.warm_start is None:
        try:
            ctx.warm_start = load_models(storage.models(), warm_start_from)
        except Exception as e:
            log.warning(
                "warm start from instance %s failed (%s); training cold",
                warm_start_from, e,
            )
        if ctx.warm_start is None:
            log.warning(
                "no persisted models for warm-start instance %s; training "
                "cold", warm_start_from,
            )
    wp = workflow_params or WorkflowParams()
    instances = storage.engine_instances()
    instance = EngineInstance(
        id=uuid.uuid4().hex,
        status="INIT",
        start_time=_now(),
        end_time=_now(),
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory,
        batch=wp.batch,
        mesh_conf=ctx.mesh_config.to_dict(),
        **engine_params.to_json_fields(),
    )
    instances.insert(instance)
    stages: dict[str, float] = {}
    t_run = time.perf_counter()
    try:
        algos, models = engine.train_full(
            ctx,
            engine_params,
            skip_sanity_check=wp.skip_sanity_check,
            stop_after_read=wp.stop_after_read,
            stop_after_prepare=wp.stop_after_prepare,
            stages=stages,
        )
        if wp.stop_after_read or wp.stop_after_prepare:
            log.info("training stopped early by workflow params")
            instances.delete(instance.id)
            return None
        t0 = time.perf_counter()
        persistable = engine.make_persistent_models(
            ctx, engine_params, models, algos=algos
        )
        # PersistentModel flavors save themselves; only a manifest is
        # stored (Engine.makeSerializableModels:284 +
        # PersistentModelManifest)
        stored = []
        for a, m in zip(algos, persistable):
            if isinstance(m, PersistentModel) and m.save(
                instance.id, getattr(a, "params", None)
            ):
                stored.append(PersistentModelManifest(type(m).class_path()))
            else:
                stored.append(m)
        save_models(storage.models(), instance.id, stored)
        # the serving ShardPlan (if any algorithm declares one), as a tiny
        # sidecar blob: GenerationStore.record embeds it in the manifest
        # without unpickling the model, and deploy re-binds it
        _record_shard_plan(storage, instance.id, algos, models)
        stages["persist.save_models"] = time.perf_counter() - t0
        done = instance.completed()
        instances.update(done)
    except Exception:
        instances.update(
            dataclasses.replace(instance, status="FAILED", end_time=_now())
        )
        log.error("training FAILED: engine instance %s", instance.id)
        raise
    stages["total"] = time.perf_counter() - t_run
    log.info("training finished: engine instance %s", instance.id)
    log.info(
        "DASE stage breakdown: %s",
        json.dumps(stages, sort_keys=True),
        extra={"engine_instance": instance.id, "stages": stages},
    )
    return done


def _record_shard_plan(storage, instance_id: str, algos, models) -> None:
    """Persist the first algorithm-declared ShardPlan for this instance
    under ``<id>:shardplan`` (``lifecycle.generations.SHARD_PLAN_SUFFIX``),
    the JAX package's bytes.  Best-effort bookkeeping: a failure here must
    never fail the train."""
    try:
        plan = next(
            (
                p
                for a, m in zip(algos, models)
                for p in [getattr(a, "serving_shard_plan", lambda _m: None)(m)]
                if p is not None
            ),
            None,
        )
        if plan is None:
            return
        storage.models().insert(
            f"{instance_id}{SHARD_PLAN_SUFFIX}",
            json.dumps(plan.to_dict(), sort_keys=True).encode("utf-8"),
        )
    except Exception as e:  # pragma: no cover - defensive
        log.warning("could not record shard plan for %s: %s", instance_id, e)


def run_evaluation(
    engine: Engine,
    engine_params_list: Sequence[EngineParams],
    evaluator: Any,
    ctx: EngineContext | None = None,
    evaluation_class: str = "",
    engine_params_generator_class: str = "",
    batch: str = "",
    storage: StorageRuntime | None = None,
):
    """Sweep engine-params, score each, pick the best (the MetricEvaluator
    role); returns the ``EvaluationResult``.  ``ctx=None`` builds an eval
    context on CUDA (which raises without a card)."""
    from predictionio_tpu_torch.core.cleanup import run as run_cleanups
    from predictionio_tpu_torch.eval.evaluator import MetricEvaluator
    from predictionio_tpu_torch.obs.tracing import trace

    storage = storage or (ctx.storage if ctx is not None else None) or get_storage()
    ctx = ctx or EngineContext(storage=storage, mode="eval")
    instances = storage.evaluation_instances()
    instance = EvaluationInstance(
        id=uuid.uuid4().hex,
        status="EVALUATING",
        start_time=_now(),
        end_time=_now(),
        evaluation_class=evaluation_class,
        engine_params_generator_class=engine_params_generator_class,
        batch=batch,
    )
    instances.insert(instance)
    try:
        if not isinstance(evaluator, MetricEvaluator):
            evaluator = MetricEvaluator(evaluator)
        with trace("workflow.run_evaluation"):
            result = evaluator.evaluate(ctx, engine, engine_params_list)
        instances.update(
            dataclasses.replace(
                instance,
                status="EVALCOMPLETED",
                end_time=_now(),
                evaluator_results=result.one_liner(),
                evaluator_results_html=result.to_html(),
                evaluator_results_json=result.to_json(),
            )
        )
        return result
    except Exception:
        instances.update(
            dataclasses.replace(instance, status="FAILED", end_time=_now())
        )
        raise
    finally:
        run_cleanups()


def run_fake(
    fn: Callable[[EngineContext], Any],
    ctx: EngineContext | None = None,
    storage: StorageRuntime | None = None,
    label: str = "FakeWorkflow",
) -> Any:
    """Run an arbitrary function through the workflow plumbing
    (workflow/FakeWorkflow.scala:33-108): an EvaluationInstance records the
    run (EVALCOMPLETED or FAILED), the cleanups fire, and the function's
    return value comes back.  ``ctx=None`` builds an eval context on CUDA
    (which raises without a card)."""
    from predictionio_tpu_torch.core.cleanup import run as run_cleanups

    storage = storage or (ctx.storage if ctx is not None else None) or get_storage()
    ctx = ctx or EngineContext(storage=storage, mode="eval")
    instances = storage.evaluation_instances()
    instance = EvaluationInstance(
        id=uuid.uuid4().hex,
        status="EVALUATING",
        start_time=_now(),
        end_time=_now(),
        evaluation_class=label,
    )
    instances.insert(instance)
    try:
        result = fn(ctx)
        instances.update(
            dataclasses.replace(
                instance,
                status="EVALCOMPLETED",
                end_time=_now(),
                evaluator_results=f"{label} completed",
            )
        )
        return result
    except Exception:
        instances.update(
            dataclasses.replace(instance, status="FAILED", end_time=_now())
        )
        raise
    finally:
        run_cleanups()
