"""Engine: binds named DASE component classes; deploy-time model loading.

Mirrors controller/Engine.scala:82 (class maps + params) and
prepareDeploy:198, as the JAX package's ``core/engine.py`` does.  The train
and eval pipelines arrive with the training slice.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence, Type

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EngineContext,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.utils.params import extract_params, params_to_dict
from predictionio_tpu_torch.utils.registry import (
    Registry,
    doer,
    resolve_import_path,
)

#: Engine factories registered by name (the EngineFactory registry).
engine_registry: Registry[Callable[[], "Engine"]] = Registry("engine factory")


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

    def prepare_deploy(
        self,
        ctx: EngineContext,
        params: EngineParams,
        persisted: Sequence[Any],
    ) -> list[Any]:
        """Re-materialize models for serving (Engine.prepareDeploy:198)."""
        _, _, algos, _ = self.instantiate(params)
        return [
            a.load_persistent_model(ctx, m) for a, m in zip(algos, persisted)
        ]


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
