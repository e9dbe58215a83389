"""Recommendation engine template, serving half: explicit-feedback ALS.

The port of the JAX package's ``models/recommendation/engine.py`` for a
persisted model: the same Query/PredictedResult/params classes, the same
persisted blob (numpy factors + BiMap states, ``make_persistent_model``), so
a model written by either package deploys on the other.

- Solo queries (``predict``, every HTTP ``/queries.json``) are answered from
  the host numpy replica: the same numpy matvec and ``host_topk`` as the
  JAX package, so the answers are identical.
- Waves of ``DEVICE_BATCH_MIN`` queries or more (``batch_predict``,
  ``dispatch_batch``; ``pio batchpredict``) gather the user rows on the
  model's device and run ``fused_topk_batch``: the hand-written CUDA kernel
  on a card, its plain version on the CPU.  A wave whose ``num`` is past
  the fused menu (k > 128) takes ``full_row_topk``: the plain version on
  the CPU, ``FusedTopKUnsupported`` on a card, where it is not ported yet.

Training (``train``) arrives with the training slice and raises here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EngineContext,
    FirstServing,
    Preparator,
)
from predictionio_tpu_torch.core.engine import Engine, engine_factory
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops.topk import (
    full_row_topk,
    fused_supported,
    fused_topk_batch,
    host_topk,
    host_topk_batch,
)

_TRAINING_SLICE = (
    "ALS training (ops/als.py, the two segment-accumulator kernels and "
    "pio train) is ported in the next slice"
)

# ---------------------------------------------------------------------------
# Data types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Query:
    user: str
    num: int = 10


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    item_scores: tuple[ItemScore, ...] = ()

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "itemScores": [
                {"item": s.item, "score": s.score} for s in self.item_scores
            ]
        }


# ---------------------------------------------------------------------------
# DataSource / Preparator: their params parse a persisted engine instance;
# reading events is the training slice's work
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EvalParams:
    """k-fold eval config (reference DataSourceEvalParams, DataSource.scala:35)."""

    k_fold: int = 5
    query_num: int = 10
    rating_threshold: float = 4.0


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = "default"
    channel_name: str | None = None
    eval_params: EvalParams | None = None
    buy_rating: float = 4.0  # implicit rating assigned to `buy` events

    params_aliases = {
        "appName": "app_name",
        "channelName": "channel_name",
        "evalParams": "eval_params",
    }


class RatingsDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams | None = None):
        self.params = params or DataSourceParams()

    def read_training(self, ctx: EngineContext):
        raise NotImplementedError(_TRAINING_SLICE)


class RatingsPreparator(Preparator):
    def __init__(self, params: Any = None):
        pass

    def prepare(self, ctx: EngineContext, td):
        raise NotImplementedError(_TRAINING_SLICE)


# ---------------------------------------------------------------------------
# ALS algorithm
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ALSAlgorithmParams:
    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    seed: int = 3
    chunk_size: int = 1 << 19
    #: factor-sharded serving over a device mesh; a single device ignores
    #: the recorded plan, as the JAX package does on one device
    shard_serving: bool = False

    # reference engine.json spellings (customize-serving/engine.json:14-21)
    params_aliases = {
        "lambda": "reg",
        "numIterations": "num_iterations",
        "shardServing": "shard_serving",
    }


@dataclass(eq=False)
class ALSModel:
    """Factors on the serving device (torch tensors) + vocabularies, and a
    host numpy replica of the factors for the solo-query path."""

    user_factors: torch.Tensor  # [num_users, rank]
    item_factors: torch.Tensor  # [num_items, rank]
    user_vocab: BiMap
    item_vocab: BiMap

    @classmethod
    def from_jax_params(
        cls, persisted: dict, device: torch.device | str
    ) -> "ALSModel":
        """The port's model from the JAX package's persisted ALS dict
        (numpy factors + vocab states, ``make_persistent_model``): factors
        on ``device``, the numpy arrays kept as the host replica."""
        Uh = np.ascontiguousarray(persisted["user_factors"], np.float32)
        Vh = np.ascontiguousarray(persisted["item_factors"], np.float32)
        model = cls(
            user_factors=torch.tensor(Uh, device=device),
            item_factors=torch.tensor(Vh, device=device),
            user_vocab=BiMap.from_state(persisted["user_vocab"]),
            item_vocab=BiMap.from_state(persisted["item_vocab"]),
        )
        model._host_cache = (Uh, Vh)
        return model

    def host_factors(self) -> tuple[np.ndarray, np.ndarray]:
        """Host numpy replica of (U, V) for solo-query serving (cached;
        excluded from pickled state)."""
        cache = getattr(self, "_host_cache", None)
        if cache is None:
            cache = (
                self.user_factors.cpu().numpy(),
                self.item_factors.cpu().numpy(),
            )
            self._host_cache = cache
        return cache

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_host_cache", None)
        return d


class ALSAlgorithm(Algorithm):
    """Explicit-feedback ALS (reference ALSAlgorithm.scala:97 predict via
    recommendProducts top-N)."""

    flavor = "P2L"
    params_class = ALSAlgorithmParams
    query_class = Query

    #: waves below this go through the host replica (latency-bound micro-
    #: batches); at/above it the fused device top-k runs
    DEVICE_BATCH_MIN = 512

    def __init__(self, params: ALSAlgorithmParams | None = None):
        self.params = params or ALSAlgorithmParams()

    def train(self, ctx: EngineContext, pd) -> ALSModel:
        raise NotImplementedError(_TRAINING_SLICE)

    def _warm_start_init(self, ctx: EngineContext, pd):
        raise NotImplementedError(_TRAINING_SLICE)

    def _sharded_topk(self, model: ALSModel, uidx: np.ndarray, k: int):
        raise NotImplementedError(
            "factor-sharded serving (parallel/placement.py) is ported with "
            "the multi-device slice; one device serves unsharded"
        )

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        """Solo-query path: host numpy replica (P2L local-model serving)."""
        uidx = model.user_vocab.get(query.user)
        if uidx is None:
            return PredictedResult()  # unknown user (reference returns empty)
        Uh, Vh = model.host_factors()
        k = min(query.num, len(model.item_vocab))
        scores, idx = host_topk(Vh @ Uh[uidx], k)
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=model.item_vocab.inverse(int(i)), score=float(s))
                for i, s in zip(idx, scores)
            )
        )

    def _split_known(self, model: ALSModel, queries):
        known = [(i, model.user_vocab.get(q.user)) for i, q in queries]
        rows = [
            (i, u, q)
            for (i, q), (_, u) in zip(queries, known)
            if u is not None
        ]
        missing = [
            (i, PredictedResult())
            for (i, q), (_, u) in zip(queries, known)
            if u is None
        ]
        return rows, missing

    def _render_rows(self, model: ALSModel, rows, top_s, top_i):
        out = []
        for row, (i, _, q) in enumerate(rows):
            n = min(q.num, len(model.item_vocab))
            out.append(
                (
                    i,
                    PredictedResult(
                        item_scores=tuple(
                            ItemScore(
                                item=model.item_vocab.inverse(int(ii)),
                                score=float(ss),
                            )
                            for ii, ss in zip(top_i[row, :n], top_s[row, :n])
                        )
                    ),
                )
            )
        return out

    def _host_topk_rows(self, model: ALSModel, rows, k: int):
        """Host-replica wave: one [B, rank] x [rank, n] numpy matmul +
        batched top-k (the JAX package's arithmetic, so the same answers)."""
        Uh, Vh = model.host_factors()
        qrows = np.stack([Uh[u] for _, u, _ in rows])
        return host_topk_batch(qrows @ Vh.T, k)

    def _device_topk(self, model: ALSModel, uidx: np.ndarray, k: int):
        """Gather the user rows on the model's device and launch the fused
        top-k WITHOUT blocking; returns the fence that waits for the wave,
        copies it to the host, and hands over (top_s, top_i) — the
        ``PendingWave`` contract of the JAX package's MicroBatcher.  A ``k``
        off the fused menu takes the full-row top-k (same tie rule),
        which raises on a CUDA model."""
        U, V = model.user_factors, model.item_factors
        uidx_dev = torch.from_numpy(uidx.astype(np.int64)).to(U.device)
        q = U.index_select(0, uidx_dev)
        if fused_supported(len(uidx), k, V.shape[0]):
            packed = fused_topk_batch(q, V, k, name="als.fused_topk")
        else:
            packed = full_row_topk(q, V, k, where="als.batch_topk")
        done = None
        if packed.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(packed.device))

        def fence():
            if done is not None:
                done.synchronize()
            arr = packed.cpu().numpy()
            return arr[0], arr[1].astype(np.int64)

        return fence

    @staticmethod
    def _uidx(rows) -> np.ndarray:
        return np.asarray([u for _, u, _ in rows], np.int32)

    def batch_predict(self, model: ALSModel, queries):
        """Vectorized path: the fused device top-k at or above
        DEVICE_BATCH_MIN known users, the host replica below it."""
        rows, out = self._split_known(model, queries)
        if rows:
            k = max(min(q.num, len(model.item_vocab)) for _, _, q in rows)
            if len(rows) >= self.DEVICE_BATCH_MIN:
                top_s, top_i = self._device_topk(model, self._uidx(rows), k)()
            else:
                top_s, top_i = self._host_topk_rows(model, rows, k)
            out.extend(self._render_rows(model, rows, top_s, top_i))
        return out

    def dispatch_batch(self, model: ALSModel, indexed_queries):
        """The async half of ``batch_predict`` for device waves: gather and
        dispatch now, return a finalize that fences, reads back and renders.
        Declines (None) below DEVICE_BATCH_MIN known users."""
        iq = list(indexed_queries)
        if len(iq) < self.DEVICE_BATCH_MIN:
            return None
        rows, missing = self._split_known(model, iq)
        if len(rows) < self.DEVICE_BATCH_MIN:
            return None  # mostly-unknown wave fell under the device floor
        k = max(min(q.num, len(model.item_vocab)) for _, _, q in rows)
        fence = self._device_topk(model, self._uidx(rows), k)

        def finalize():
            top_s, top_i = fence()
            return missing + self._render_rows(model, rows, top_s, top_i)

        return finalize

    # -- persistence ---------------------------------------------------------
    def make_persistent_model(self, ctx: EngineContext, model: ALSModel):
        Uh, Vh = model.host_factors()
        return {
            "user_factors": Uh,
            "item_factors": Vh,
            "user_vocab": model.user_vocab.to_state(),
            "item_vocab": model.item_vocab.to_state(),
        }

    def load_persistent_model(self, ctx: EngineContext, data) -> ALSModel:
        # a recorded "shard_plan" is ignored: one device serves unsharded
        return ALSModel.from_jax_params(data, ctx.device)


class RecommendationServing(FirstServing):
    pass


@engine_factory("recommendation")
def recommendation_engine() -> Engine:
    return Engine(
        {"": RatingsDataSource, "ratings": RatingsDataSource},
        {"": RatingsPreparator, "ratings": RatingsPreparator},
        {"als": ALSAlgorithm},
        {"": RecommendationServing, "first": RecommendationServing},
    )
