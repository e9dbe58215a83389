"""Engine: binds named DASE component classes, trains, evaluates, loads
for deploy.

Mirrors controller/Engine.scala:82 (class maps + params), the train
pipeline (Engine.train:623: read -> sanity -> prepare -> sanity -> train per
algorithm -> sanity), the eval pipeline (Engine.eval:728: per eval set
prepare and train, batch predict per algorithm, union by query index,
serve) and prepareDeploy:198, as the JAX package's ``core/engine.py`` does.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence, Type

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EngineContext,
    Preparator,
    Serving,
    run_sanity_check,
)
from predictionio_tpu_torch.utils.params import extract_params, params_to_dict
from predictionio_tpu_torch.utils.registry import (
    Registry,
    doer,
    resolve_import_path,
)

#: Engine factories registered by name (the EngineFactory registry).
engine_registry: Registry[Callable[[], "Engine"]] = Registry("engine factory")


def serve_eval_fold(algos, models, serving, qa_pairs):
    """One eval fold's predict-union-serve (Engine.eval:771-816).

    Batch-predicts every algorithm over the supplemented queries, groups
    predictions per query preserving algorithm order, and serves each.
    Shared by Engine.eval and FastEvalEngine."""
    indexed_queries = [
        (i, serving.supplement(q)) for i, (q, _) in enumerate(qa_pairs)
    ]
    per_query: dict[int, list[Any]] = {i: [] for i, _ in indexed_queries}
    for algo, model in zip(algos, models):
        for i, p in algo.batch_predict(model, indexed_queries):
            per_query[i].append(p)
    return [
        (q, serving.serve(indexed_queries[i][1], per_query[i]), actual)
        for i, (q, actual) in enumerate(qa_pairs)
    ]


@dataclass(frozen=True)
class EngineParams:
    """Named component selection + params (controller/EngineParams.scala:35)."""

    datasource: tuple[str, Any] = ("", None)
    preparator: tuple[str, Any] = ("", None)
    algorithms: tuple[tuple[str, Any], ...] = ()
    serving: tuple[str, Any] = ("", None)

    def to_json_fields(self) -> dict[str, str]:
        """Freeze params as JSON strings for the EngineInstance record."""
        return {
            "datasource_params": json.dumps(
                {self.datasource[0]: params_to_dict(self.datasource[1])}
            ),
            "preparator_params": json.dumps(
                {self.preparator[0]: params_to_dict(self.preparator[1])}
            ),
            "algorithms_params": json.dumps(
                [{name: params_to_dict(p)} for name, p in self.algorithms]
            ),
            "serving_params": json.dumps(
                {self.serving[0]: params_to_dict(self.serving[1])}
            ),
        }


class Engine:
    """Named class maps for the four DASE stages."""

    def __init__(
        self,
        datasource_classes: Mapping[str, Type[DataSource]] | Type[DataSource],
        preparator_classes: Mapping[str, Type[Preparator]] | Type[Preparator],
        algorithm_classes: Mapping[str, Type[Algorithm]] | Type[Algorithm],
        serving_classes: Mapping[str, Type[Serving]] | Type[Serving],
    ):
        as_map = lambda x, default: (  # noqa: E731
            dict(x) if isinstance(x, Mapping) else {default: x}
        )
        self.datasource_classes = as_map(datasource_classes, "")
        self.preparator_classes = as_map(preparator_classes, "")
        self.algorithm_classes = as_map(algorithm_classes, "")
        self.serving_classes = as_map(serving_classes, "")

    def _component_params(
        self, classes: Mapping[str, type], name: str, payload: Any
    ) -> Any:
        if name not in classes:
            raise KeyError(
                f"component {name!r} not registered; have {sorted(classes)}"
            )
        params_cls = getattr(classes[name], "params_class", None)
        if params_cls is None:
            return payload
        return extract_params(params_cls, payload)

    def params_from_json(self, variant: Mapping[str, Any]) -> EngineParams:
        """Parse an engine-variant JSON object (the reference's engine.json
        shape) into EngineParams; see the JAX package's docstring."""

        def one(stage: str, classes: Mapping[str, type]) -> tuple[str, Any]:
            entry = variant.get(stage) or {}
            if isinstance(entry, Mapping) and ("name" in entry or "params" in entry):
                name = entry.get("name", "")
                payload = entry.get("params", {})
            else:  # bare params object for single-class stages
                name = ""
                payload = entry
            if name not in classes and len(classes) == 1:
                name = next(iter(classes))
            return name, self._component_params(classes, name, payload)

        algos = []
        for e in variant.get("algorithms") or [{}]:
            name = e.get("name", "")
            if name not in self.algorithm_classes and len(self.algorithm_classes) == 1:
                name = next(iter(self.algorithm_classes))
            algos.append(
                (
                    name,
                    self._component_params(
                        self.algorithm_classes, name, e.get("params", {})
                    ),
                )
            )
        return EngineParams(
            datasource=one("datasource", self.datasource_classes),
            preparator=one("preparator", self.preparator_classes),
            algorithms=tuple(algos),
            serving=one("serving", self.serving_classes),
        )

    def instantiate(self, params: EngineParams):
        ds = doer(self.datasource_classes[params.datasource[0]], params.datasource[1])
        prep = doer(
            self.preparator_classes[params.preparator[0]], params.preparator[1]
        )
        algos = [
            doer(self.algorithm_classes[name], p) for name, p in params.algorithms
        ]
        serving = doer(self.serving_classes[params.serving[0]], params.serving[1])
        return ds, prep, algos, serving

    def train_full(
        self,
        ctx: EngineContext,
        params: EngineParams,
        skip_sanity_check: bool = False,
        stop_after_read: bool = False,
        stop_after_prepare: bool = False,
        stages: dict[str, float] | None = None,
    ) -> tuple[list[Algorithm], list[Any]]:
        """Run the train pipeline; returns (algorithm instances, models).

        The instances that trained are returned so that train-time state
        reaches make_persistent_model.  Models are empty when stopped early
        by the flags.  ``stages``, when given, receives the seconds of each
        DASE stage (``datasource.read``, ``preparator.prepare``,
        ``algorithm.<name>``) on the host clock."""
        stages = {} if stages is None else stages
        ds, prep, algos, _ = self.instantiate(params)
        t0 = time.perf_counter()
        td = ds.read_training(ctx)
        stages["datasource.read"] = time.perf_counter() - t0
        if not skip_sanity_check:
            run_sanity_check(td)
        if stop_after_read:
            return algos, []
        t0 = time.perf_counter()
        pd = prep.prepare(ctx, td)
        stages["preparator.prepare"] = time.perf_counter() - t0
        if not skip_sanity_check:
            run_sanity_check(pd)
        if stop_after_prepare:
            return algos, []
        models = []
        for (name, _), algo in zip(params.algorithms, algos):
            t0 = time.perf_counter()
            model = algo.train(ctx, pd)
            stages[f"algorithm.{name or type(algo).__name__}"] = (
                time.perf_counter() - t0
            )
            if not skip_sanity_check:
                run_sanity_check(model)
            models.append(model)
        return algos, models

    def train(
        self,
        ctx: EngineContext,
        params: EngineParams,
        skip_sanity_check: bool = False,
        stop_after_read: bool = False,
        stop_after_prepare: bool = False,
    ) -> list[Any]:
        return self.train_full(
            ctx,
            params,
            skip_sanity_check=skip_sanity_check,
            stop_after_read=stop_after_read,
            stop_after_prepare=stop_after_prepare,
        )[1]

    def make_persistent_models(
        self,
        ctx: EngineContext,
        params: EngineParams,
        models: Sequence[Any],
        algos: Sequence[Algorithm] | None = None,
    ) -> list[Any]:
        if algos is None:
            _, _, algos, _ = self.instantiate(params)
        return [a.make_persistent_model(ctx, m) for a, m in zip(algos, models)]

    def prepare_deploy(
        self,
        ctx: EngineContext,
        params: EngineParams,
        persisted: Sequence[Any],
        instance_id: str | None = None,
    ) -> list[Any]:
        """Re-materialize models for serving (Engine.prepareDeploy:198).

        A stored PersistentModelManifest resolves through its named loader
        class (prepareDeploy:241-250) before the algorithm's own hook runs.
        """
        from predictionio_tpu_torch.core.persistent_model import (
            PersistentModelManifest,
            load_from_manifest,
        )

        _, _, algos, _ = self.instantiate(params)
        out = []
        for a, m in zip(algos, persisted):
            if isinstance(m, PersistentModelManifest):
                if instance_id is None:
                    raise ValueError(
                        "persistent-model manifest requires the engine "
                        "instance id to load"
                    )
                m = load_from_manifest(m, instance_id, getattr(a, "params", None))
            out.append(a.load_persistent_model(ctx, m))
        return out

    def eval(
        self, ctx: EngineContext, params: EngineParams
    ) -> list[tuple[Any, list[tuple[Any, Any, Any]]]]:
        """Evaluate one EngineParams: per fold, train then batch-predict all
        algorithms, group per query, and serve.  Returns
        [(eval_info, [(query, served_prediction, actual)])]."""
        from predictionio_tpu_torch.obs.tracing import trace

        ds, prep, algos, serving = self.instantiate(params)
        with trace("eval.datasource.read_eval"):
            eval_sets = ds.read_eval(ctx)
        results = []
        for td, eval_info, qa_pairs in eval_sets:
            with trace("eval.fold"):
                pd = prep.prepare(ctx, td)
                models = [a.train(ctx, pd) for a in algos]
                results.append(
                    (eval_info, serve_eval_fold(algos, models, serving, qa_pairs))
                )
        return results


def engine_factory(name: str):
    """Decorator registering a zero-arg engine factory under ``name``."""

    def deco(fn: Callable[[], Engine]):
        engine_registry.register(name, fn)
        return fn

    return deco


def resolve_engine_factory(name: str) -> Callable[[], Engine]:
    """Look up a factory by registered name or ``pkg.mod:attr`` import path.

    The bundled templates (``predictionio_tpu_torch.models``) register on
    import, so they are imported first."""
    import predictionio_tpu_torch.models  # noqa: F401

    if name in engine_registry:
        return engine_registry.get(name)
    obj = resolve_import_path(name)
    if obj is None:
        raise KeyError(
            f"engine factory {name!r} not found (registered: "
            f"{engine_registry.names()}; import paths 'pkg.mod:attr' also work)"
        )
    return obj
