"""Recommendation engine template: explicit-feedback ALS.

The port of the JAX package's ``models/recommendation/engine.py``: the same
Query/PredictedResult/params classes, the same persisted blob (numpy
factors + BiMap states, ``make_persistent_model``), so a model written by
either package deploys on the other.

- Training: ``RatingsDataSource`` reads ``rate``/``buy`` events through the
  event store (``buy`` = implicit rating ``buy_rating``),
  ``RatingsPreparator`` builds the BiMap vocabularies and COO arrays, and
  ``ALSAlgorithm.train`` runs ``ops.als.train_als`` on the context's device
  (the hand-written accumulator kernels on a card).  ``read_eval`` splits
  the same events into k folds for ``pio eval``.

- Solo queries (``predict``) and waves below ``DEVICE_BATCH_MIN`` known
  users (the micro-batched HTTP ``/queries.json`` at its default
  ``max_batch``) are answered from the host numpy replica: the same numpy
  arithmetic and ``host_topk`` as the JAX package, so the answers are
  identical.
- Waves of ``DEVICE_BATCH_MIN`` queries or more (``batch_predict``,
  ``dispatch_batch``; ``pio batchpredict``) gather the user rows on the
  model's device and run ``fused_topk_batch``: the hand-written CUDA kernel
  on a card, its plain version on the CPU.  A wave whose ``num`` is past
  the fused menu (k > 128) takes ``full_row_topk`` on the same device: a
  full score row and a stable sort, on the card as on the CPU, the JAX
  package's ``_device_score_topk`` route.
- Factor-sharded serving (``shardServing``): the model records a
  ``ShardPlan`` (both factor tables row-sharded over ``model``), and a
  context with more than one slot (``EngineContext.mesh_devices``) binds
  it at load.  Every wave of a bound model then runs
  ``_sharded_topk``: the user rows gathered from their owning slots, each
  slot's top-k over only its item rows (the fused kernel per slot, each
  slot on its own CUDA stream on a card), and the k-winner merge
  (``parallel.placement``), under the settle clock and the straggler
  board.  ``dispatch_batch`` declines such waves, so the micro-batcher
  runs them synchronously.  Solo queries stay on the host replica.

Observability, as the JAX package places it: host stage marks on the wave
timeline (``host_gather`` the vocabulary lookups, ``h2d`` the enqueue of
the ids' upload, ``compute`` the wait in the fence, ``d2h`` the read of
the pinned result), the bytes that actually cross (the ids up, the packed
result down; nothing on the CPU, where no copy happens), the launch shape
per wave (``default_recompiles().note_signature``), the engine path of each
route in the answer's provenance, and the wave's device time: the fused
kernel's CUDA-event time, recorded by its launcher around its two passes
and read after the wave's own fence, which feeds ``/efficiency.json``
(``als.fused_topk``; ``als.batch_topk`` off the menu, its library calls
bracketed from Python) against the least work of the same top-k.
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
    SanityCheckError,
)
from predictionio_tpu_torch.core.device_wave import dispatch_wave
from predictionio_tpu_torch.core.engine import Engine, engine_factory
from predictionio_tpu_torch.core.warmstart import align_warm_factors, find_warm_start
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs import provenance
from predictionio_tpu_torch.ops.als import ALSParams, train_als
from predictionio_tpu_torch.ops.topk import (
    full_row_topk,
    fused_supported,
    fused_topk_batch,
    fused_topk_least_work,
    host_topk,
    host_topk_batch,
    note_full_row_fallback,
    query_block,
)
from predictionio_tpu_torch.parallel.mesh import meter_shards
from predictionio_tpu_torch.parallel.placement import (
    ShardPlan,
    bind_shards,
    build_sharded_topk,
    gather_rows,
    run_observed_wave,
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


@dataclass
class TrainingData:
    """Raw (user, item, rating) triples as columnar arrays."""

    users: np.ndarray  # object[str]
    items: np.ndarray  # object[str]
    ratings: np.ndarray  # float32

    def sanity_check(self):
        if len(self.ratings) == 0:
            raise SanityCheckError(
                "TrainingData has no ratings — check appName/eventNames"
            )


@dataclass
class PreparedData:
    """Vocab-mapped COO ratings ready for device staging."""

    user_vocab: BiMap
    item_vocab: BiMap
    user_idx: np.ndarray  # int32
    item_idx: np.ndarray  # int32
    ratings: np.ndarray  # float32


# ---------------------------------------------------------------------------
# DataSource / Preparator
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

    def _read(self, ctx: EngineContext) -> TrainingData:
        frame = ctx.p_event_store.find(
            self.params.app_name,
            channel_name=self.params.channel_name,
            entity_type="user",
            target_entity_type="item",
            event_names=["rate", "buy"],
        )
        ratings = frame.property_column("rating", default=np.nan)
        # buy events carry no rating property -> fixed implicit rating
        is_buy = frame.event == "buy"
        ratings = np.where(is_buy, self.params.buy_rating, ratings)
        keep = ~np.isnan(ratings)
        return TrainingData(
            users=frame.entity_id[keep],
            items=frame.target_entity_id[keep],
            ratings=ratings[keep].astype(np.float32),
        )

    def read_training(self, ctx: EngineContext) -> TrainingData:
        return self._read(ctx)

    def read_eval(self, ctx: EngineContext):
        """k folds by row position (``arange(n) % k_fold``, the reference's
        zipWithUniqueId % kFold): fold f trains on the other rows and
        queries each test user with ratings at or above the threshold, in
        sorted user order, against that user's set of relevant items."""
        ep = self.params.eval_params
        if ep is None:
            raise ValueError(
                "DataSourceParams.eval_params must be set for evaluation"
            )
        td = self._read(ctx)
        fold_of = np.arange(len(td.ratings)) % ep.k_fold
        out = []
        for f in range(ep.k_fold):
            train_mask = fold_of != f
            test_mask = ~train_mask
            train = TrainingData(
                users=td.users[train_mask],
                items=td.items[train_mask],
                ratings=td.ratings[train_mask],
            )
            relevant: dict[str, set] = {}
            for u, i, r in zip(td.users[test_mask], td.items[test_mask],
                               td.ratings[test_mask]):
                if r >= ep.rating_threshold:
                    relevant.setdefault(u, set()).add(i)
            qa = [
                (Query(user=u, num=ep.query_num), frozenset(items))
                for u, items in sorted(relevant.items())
            ]
            out.append((train, {"fold": f}, qa))
        return out


class RatingsPreparator(Preparator):
    def __init__(self, params: Any = None):
        pass

    def prepare(self, ctx: EngineContext, td: TrainingData) -> PreparedData:
        user_vocab = BiMap.from_keys(td.users)
        item_vocab = BiMap.from_keys(td.items)
        return PreparedData(
            user_vocab=user_vocab,
            item_vocab=item_vocab,
            user_idx=user_vocab.to_index_array(td.users).astype(np.int32),
            item_idx=item_vocab.to_index_array(td.items).astype(np.int32),
            ratings=td.ratings,
        )


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
    #: record a factor-sharded serving plan (both factor tables
    #: row-sharded); a context with one slot ignores it, as the JAX
    #: package does on one device
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
    #: factor-sharded serving state (parallel.placement.BoundShards) when a
    #: ShardPlan was re-bound at load; None = single-device serving
    shards: Any = None

    def sanity_check(self):
        if not torch.isfinite(self.user_factors).all():
            raise SanityCheckError("ALS user factors contain non-finite values")

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
        d["shards"] = None  # device placement never rides in a pickle
        return d


class ALSAlgorithm(Algorithm):
    """Explicit-feedback ALS (reference ALSAlgorithm.scala:52 train, :97
    predict via recommendProducts top-N)."""

    flavor = "P2L"
    params_class = ALSAlgorithmParams
    query_class = Query

    #: waves below this go through the host replica (latency-bound micro-
    #: batches); at/above it the fused device top-k runs
    DEVICE_BATCH_MIN = 512

    def __init__(self, params: ALSAlgorithmParams | None = None):
        self.params = params or ALSAlgorithmParams()

    def _als_params(self) -> ALSParams:
        p = self.params
        return ALSParams(
            rank=p.rank,
            num_iterations=p.num_iterations,
            reg=p.reg,
            seed=p.seed,
            chunk_size=p.chunk_size,
            implicit_prefs=False,
        )

    def train(self, ctx: EngineContext, pd: PreparedData) -> ALSModel:
        """Factors on ``ctx.device``: the accumulator kernels on a card."""
        state = train_als(
            pd.user_idx,
            pd.item_idx,
            pd.ratings,
            num_users=len(pd.user_vocab),
            num_items=len(pd.item_vocab),
            params=self._als_params(),
            device=ctx.device,
            init_factors=self._warm_start_init(ctx, pd),
            mesh=ctx.mesh,
        )
        return ALSModel(
            user_factors=state.user_factors,
            item_factors=state.item_factors,
            user_vocab=pd.user_vocab,
            item_vocab=pd.item_vocab,
        )

    def _warm_start_init(
        self, ctx: EngineContext, pd: PreparedData
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Previous-generation factors mapped through the old -> new vocab:
        entities present in both generations keep their trained rows, new
        ones get the standard random init (numpy, seeded with the params'
        seed, as the JAX package draws it).  Anything unusable (another
        rank, a foreign persisted shape) degrades to a cold start."""
        prev = find_warm_start(
            ctx, ("user_factors", "item_factors", "user_vocab", "item_vocab")
        )
        if prev is None:
            return None
        rank = self.params.rank
        Uw = np.asarray(prev["user_factors"], np.float32)
        Vw = np.asarray(prev["item_factors"], np.float32)
        if Uw.ndim != 2 or Uw.shape[1] != rank or Vw.shape[1] != rank:
            return None
        rng = np.random.default_rng(self.params.seed)
        U0 = align_warm_factors(
            Uw, BiMap.from_state(prev["user_vocab"]), pd.user_vocab, rng
        )
        V0 = align_warm_factors(
            Vw, BiMap.from_state(prev["item_vocab"]), pd.item_vocab, rng
        )
        return U0, V0

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        """Solo-query path: host numpy replica (P2L local-model serving)."""
        provenance.note(engine_path="als.host_replica")
        with device_obs.wave_stage("host_gather"):
            uidx = model.user_vocab.get(query.user)
        if uidx is None:
            # unknown user (reference returns empty)
            provenance.note(unknown_entity=query.user)
            return PredictedResult()
        Uh, Vh = model.host_factors()
        k = min(query.num, len(model.item_vocab))
        scores, idx = host_topk(Vh @ Uh[uidx], k)
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=model.item_vocab.inverse(int(i)), score=float(s))
                for i, s in zip(idx, scores)
            )
        )

    # -- sharded serving (parallel.placement) --------------------------------

    def serving_shard_plan(self, model: ALSModel):
        """The declarative layout serving re-binds at load: both factor
        tables row-sharded over the ``model`` axis (recorded in the
        persisted model and the generation manifest)."""
        if not self.params.shard_serving:
            return None
        return ShardPlan.model_parallel(
            ["user_factors", "item_factors"],
            rows={
                "user_factors": len(model.user_vocab),
                "item_factors": len(model.item_vocab),
            },
        )

    def _sharded_topk(self, model: ALSModel, uidx: np.ndarray, k: int):
        """One wave through the factor-sharded top-k: the user rows
        gathered from their owning slots, each slot's top-k over its own
        item rows, the k-winner merge.  Shapes are padded to a power-of-two
        menu (b >= 8, k >= 16), as the JAX package pads them.  Each slot's
        local top-k is the fused kernel when the shape is on its menu (no
        slot holds its [B, rows_local] score block); off it, the masked
        score block and a stable sort, counted as a full-row fallback."""
        bound = model.shards
        n_items = len(model.item_vocab)
        with device_obs.wave_stage("host_gather"):
            b = max(1 << (len(uidx) - 1).bit_length(), 8)
            k_pad = min(max(1 << (k - 1).bit_length(), 16), n_items)
            padded = np.zeros(b, np.int32)
            padded[: len(uidx)] = uidx
        items = bound.arrays["item_factors"]
        sig = (b, k_pad, n_items, bound.n_shards) + tuple(items.shape)
        rows_local = int(items.shape[0]) // max(bound.n_shards, 1)
        use_fused = fused_supported(b, min(k_pad, rows_local), rows_local)
        if not use_fused:
            note_full_row_fallback(b, k_pad, n_items, "als.sharded_topk")

        def _fused_local(item_local, q, kc, limit):
            packed = fused_topk_batch(
                q, item_local, kc, limit=limit, name="als.sharded_topk.fused",
            )
            return packed[0], packed[1]

        kernel = bound.kernel(
            (b, k_pad),
            lambda: build_sharded_topk(
                bound.mesh,
                lambda item_local, q: q @ item_local.T,
                n_items=n_items,
                k=k_pad,
                name="als.sharded_topk",
                local_topk_fn=_fused_local if use_fused else None,
            ),
        )

        def compute(uidx_dev):
            q_rows = gather_rows(
                bound.mesh, bound.arrays["user_factors"], uidx_dev
            )
            return kernel(items, q_rows)

        packed = run_observed_wave(
            "als.sharded_topk",
            device=bound.mesh.merge_device,
            sig=sig,
            # the least work of the wave's top-k over the placed table
            cost=fused_topk_least_work(
                b, int(items.shape[1]), int(items.shape[0]), k_pad
            ),
            host_input=padded,
            compute=compute,
            shard_arrays={
                n: bound.arrays[n] for n in ("user_factors", "item_factors")
            },
        )
        return packed[0], packed[1].astype(np.int64)

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
        with device_obs.wave_stage("host_gather"):
            qrows = np.stack([Uh[u] for _, u, _ in rows])
        return host_topk_batch(qrows @ Vh.T, k)

    def _device_topk(self, model: ALSModel, uidx: np.ndarray, k: int):
        """Gather the user rows on the model's device and launch the fused
        top-k WITHOUT blocking; returns the fence that waits for the wave
        and hands over (top_s, top_i) — the ``PendingWave`` contract of the
        JAX package's MicroBatcher (``core.device_wave.dispatch_wave``: one
        event per wave, the kernel's own time from its launcher's timing
        events).  A ``k`` off the fused menu takes the full-row top-k (same
        tie rule) on the model's device, as the JAX package takes
        ``_device_score_topk``: the same fence, no host replica."""
        U, V = model.user_factors, model.item_factors
        n_items, rank = int(V.shape[0]), int(V.shape[1])
        fn = (
            "als.fused_topk" if fused_supported(len(uidx), k, n_items)
            else "als.batch_topk"
        )
        shapes = tuple(U.shape) + tuple(V.shape)
        # the wave's work, which the cost is keyed on: its rows count
        sig = (len(uidx), k) + shapes
        # the launch shape: what picks the built variant (k, the fused
        # kernel's query block) and the factor shapes, never the row count,
        # which micro-batching changes every wave with no new build
        block = query_block(len(uidx), k) if fn == "als.fused_topk" else 0
        device_obs.default_recompiles().note_signature(fn, (k, block) + shapes)
        # the least work of the top-k of q·tᵀ (both routes compute it)
        cost = fused_topk_least_work(len(uidx), rank, n_items, k)
        device_obs.default_efficiency().record_cost(
            fn, cost["flops"], cost["bytes"], signature=sig,
            source="least_work",
        )
        fence = dispatch_wave(
            uidx, U.device,
            lambda ids, timing: self._topk_on(U, V, ids, k, timing),
            lambda kernel_s: self._observe_wave(fn, sig, cost, kernel_s, U),
        )
        return lambda: self._unpack(fence())

    @staticmethod
    def _observe_wave(fn, sig, cost, kernel_s: float, U: torch.Tensor) -> None:
        """One wave's device time onto the roofline and the wave timeline
        (the flight and provenance meta read it from there)."""
        device_obs.note_wave_device(device_obs.device_label(U))
        device_obs.note_wave_cost(fn, cost)
        device_obs.note_wave_kernel(kernel_s)
        device_obs.default_efficiency().observe(fn, kernel_s, signature=sig)

    @staticmethod
    def _topk_on(U: torch.Tensor, V: torch.Tensor, ids: torch.Tensor, k: int,
                 timing: tuple | None = None):
        """The packed top-k of the ``ids`` rows of U against V on their
        device.  ``timing``, a pair of timing events, brackets the fused
        kernel from inside its launcher; off the menu, the full-row route's
        library calls, recorded around them from here."""
        q = U.index_select(0, ids)
        if fused_supported(len(ids), k, V.shape[0]):
            return fused_topk_batch(q, V, k, name="als.fused_topk", timing=timing)
        if timing is not None:
            timing[0].record()
        out = full_row_topk(q, V, k, where="als.batch_topk")
        if timing is not None:
            timing[1].record()
        return out

    @staticmethod
    def _unpack(arr: np.ndarray):
        return arr[0], arr[1].astype(np.int64)

    @staticmethod
    def _uidx(rows) -> np.ndarray:
        return np.asarray([u for _, u, _ in rows], np.int32)

    def batch_predict(self, model: ALSModel, queries):
        """Vectorized path: every wave of a sharded model through the
        sharded top-k; else the fused device top-k at or above
        DEVICE_BATCH_MIN known users, the host replica below it."""
        rows, out = self._split_known(model, queries)
        if rows:
            k = max(min(q.num, len(model.item_vocab)) for _, _, q in rows)
            if model.shards is not None:
                provenance.note(engine_path="als.sharded_topk")
                top_s, top_i = self._sharded_topk(model, self._uidx(rows), k)
            elif len(rows) >= self.DEVICE_BATCH_MIN:
                provenance.note(engine_path="als.device_topk")
                top_s, top_i = self._device_topk(model, self._uidx(rows), k)()
            else:
                provenance.note(engine_path="als.host_replica")
                top_s, top_i = self._host_topk_rows(model, rows, k)
            out.extend(self._render_rows(model, rows, top_s, top_i))
        return out

    def dispatch_batch(self, model: ALSModel, indexed_queries, force: bool = False):
        """The async half of ``batch_predict`` for device waves: gather and
        dispatch now, return a finalize that fences, reads back and renders.
        Declines (None) every wave of a sharded model (the settle clock is
        synchronous: the batcher then runs ``batch_predict``, which stays
        sharded) and, unless ``force``, below DEVICE_BATCH_MIN known users:
        the bisected halves and solo retries of a failed device wave
        dispatch on the model's device at any size, never on the host
        replica."""
        iq = list(indexed_queries)
        if model.shards is not None:
            return None
        if len(iq) < self.DEVICE_BATCH_MIN and not force:
            return None
        with device_obs.wave_stage("host_gather"):
            rows, missing = self._split_known(model, iq)
            uidx = self._uidx(rows)
        if len(rows) < self.DEVICE_BATCH_MIN and not force:
            return None  # mostly-unknown wave fell under the device floor
        if not rows:
            return lambda: missing
        k = max(min(q.num, len(model.item_vocab)) for _, _, q in rows)
        provenance.note(engine_path="als.device_topk")
        fence = self._device_topk(model, uidx, k)

        def finalize():
            top_s, top_i = fence()
            return missing + self._render_rows(model, rows, top_s, top_i)

        return finalize

    # -- persistence ---------------------------------------------------------
    def make_persistent_model(self, ctx: EngineContext, model: ALSModel):
        Uh, Vh = model.host_factors()
        out = {
            "user_factors": Uh,
            "item_factors": Vh,
            "user_vocab": model.user_vocab.to_state(),
            "item_vocab": model.item_vocab.to_state(),
        }
        plan = self.serving_shard_plan(model)
        if plan is not None:
            # the model carries its own layout: deploy re-binds this plan
            # onto whatever slots the serving host has
            out["shard_plan"] = plan.to_dict()
        return out

    def load_persistent_model(self, ctx: EngineContext, data) -> ALSModel:
        """The model on ``ctx.device``; a recorded plan binds onto
        ``ctx.mesh_devices`` when there is more than one slot (the factors
        then stay on the host for the solo path), and is ignored on one
        slot, as the JAX package ignores it on one device."""
        plan = ShardPlan.from_dict(data.get("shard_plan"))
        slots = ctx.mesh_devices if ctx is not None else None
        if plan is None or not slots or len(slots) < 2:
            return ALSModel.from_jax_params(data, ctx.device)
        model = ALSModel.from_jax_params(data, "cpu")
        Uh, Vh = model.host_factors()
        model.shards = bind_shards(
            plan, {"user_factors": Uh, "item_factors": Vh}, devices=slots
        )
        meter_shards("als.serving_factors", model.shards.arrays)
        return model


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
