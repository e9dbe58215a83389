"""FastEvalEngine: per-prefix memoization for hyperparameter sweeps.

The JAX package's ``eval/fast_eval.py`` (controller/FastEvalEngine.scala:
46-345): when evaluating an engine-params list, many variants share a
prefix of the pipeline (same datasource -> same eval sets; same
+preparator -> same prepared data; same +algorithm params -> same trained
models).  Caching on the serialized params prefix makes an N-variant sweep
cost ~1 datasource read + P prepares + A trains instead of N of each.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import OrderedDict
from typing import Any

from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.utils.params import params_to_dict
from predictionio_tpu_torch.utils.registry import doer


def _key(*parts: Any) -> str:
    return json.dumps(parts, sort_keys=True, default=str)


class SpillingModelCache:
    """Bounded trained-model cache: at most ``max_live`` entries stay in
    memory; older entries spill to disk through ``core.persistence`` and
    reload on a hit.

    Entries are materialized factor/embedding tables, so an unbounded dict
    would exhaust host (or device) memory on a large sweep at the ML-20M
    shape.  A spill pickles each tensor as numpy beside its device
    (``serialize_spill``), so a reloaded model is on the device it was
    trained on, and the spill frees that device's memory.
    """

    def __init__(self, max_live: int | None = None):
        if max_live is None:
            max_live = int(os.environ.get("PIO_FAST_EVAL_MAX_LIVE", "2"))
        self.max_live = max(max_live, 1)
        self._live: OrderedDict[str, list] = OrderedDict()
        self._spilled: dict[str, str] = {}  # key -> file path
        self._dir: tempfile.TemporaryDirectory | None = None
        self.reload_count = 0

    def __contains__(self, key: str) -> bool:
        return key in self._live or key in self._spilled

    def __len__(self) -> int:
        return len(self._live) + len(self._spilled)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def get(self, key: str) -> list:
        if key in self._live:
            self._live.move_to_end(key)
            return self._live[key]
        from predictionio_tpu_torch.core.persistence import deserialize_spill

        path = self._spilled.pop(key)
        with open(path, "rb") as f:
            models = deserialize_spill(f.read())
        os.unlink(path)  # a later re-spill rewrites it; never orphan blobs
        self.reload_count += 1
        self.put(key, models)
        return models

    def put(self, key: str, models: list) -> None:
        self._live[key] = models
        self._live.move_to_end(key)
        while len(self._live) > self.max_live:
            self._spill(*self._live.popitem(last=False))

    def _spill(self, key: str, models: list) -> None:
        import hashlib

        from predictionio_tpu_torch.core.persistence import serialize_spill

        if self._dir is None:
            self._dir = tempfile.TemporaryDirectory(prefix="pio_fasteval_")
        # deterministic per-key name: a spill->reload->re-spill cycle
        # overwrites the same file instead of accumulating orphans
        digest = hashlib.sha1(key.encode()).hexdigest()[:20]
        path = os.path.join(self._dir.name, f"spill_{digest}.pkl")
        with open(path, "wb") as f:
            f.write(serialize_spill(models))
        self._spilled[key] = path


class FastEvalEngine(Engine):
    """Engine whose eval() memoizes datasource/preparator/algorithm prefixes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._ds_cache: dict[str, Any] = {}
        self._prep_cache: dict[str, Any] = {}
        # trained models: bounded LRU that spills evictions to disk so a
        # large sweep runs in bounded RSS (see SpillingModelCache)
        self._train_cache = SpillingModelCache()
        # hit counters exposed for tests (FastEvalEngineTest counts cache use)
        self.counts = {"datasource": 0, "preparator": 0, "train": 0}

    @classmethod
    def from_engine(cls, engine: Engine) -> "FastEvalEngine":
        return cls(
            engine.datasource_classes,
            engine.preparator_classes,
            engine.algorithm_classes,
            engine.serving_classes,
        )

    def _eval_sets(self, ctx: EngineContext, params: EngineParams):
        k = _key(params.datasource[0], params_to_dict(params.datasource[1]))
        if k not in self._ds_cache:
            self.counts["datasource"] += 1
            ds = doer(
                self.datasource_classes[params.datasource[0]], params.datasource[1]
            )
            self._ds_cache[k] = ds.read_eval(ctx)
        return k, self._ds_cache[k]

    def _prepared(self, ctx: EngineContext, params: EngineParams):
        ds_key, eval_sets = self._eval_sets(ctx, params)
        k = _key(ds_key, params.preparator[0], params_to_dict(params.preparator[1]))
        if k not in self._prep_cache:
            self.counts["preparator"] += 1
            prep = doer(
                self.preparator_classes[params.preparator[0]], params.preparator[1]
            )
            self._prep_cache[k] = [
                prep.prepare(ctx, td) for td, _, _ in eval_sets
            ]
        return k, eval_sets, self._prep_cache[k]

    def _models(self, ctx: EngineContext, params: EngineParams):
        prep_key, eval_sets, pds = self._prepared(ctx, params)
        per_algo_models = []
        for name, algo_params in params.algorithms:
            k = _key(prep_key, name, params_to_dict(algo_params))
            if k not in self._train_cache:
                self.counts["train"] += 1
                algo = doer(self.algorithm_classes[name], algo_params)
                self._train_cache.put(k, [algo.train(ctx, pd) for pd in pds])
            per_algo_models.append(self._train_cache.get(k))
        return eval_sets, per_algo_models

    def eval(self, ctx: EngineContext, params: EngineParams):
        from predictionio_tpu_torch.core.engine import serve_eval_fold

        eval_sets, per_algo_models = self._models(ctx, params)
        algos = [
            doer(self.algorithm_classes[name], p) for name, p in params.algorithms
        ]
        serving = doer(
            self.serving_classes[params.serving[0]], params.serving[1]
        )
        results = []
        for fold, (td, eval_info, qa_pairs) in enumerate(eval_sets):
            fold_models = [ms[fold] for ms in per_algo_models]
            results.append(
                (eval_info, serve_eval_fold(algos, fold_models, serving, qa_pairs))
            )
        return results
