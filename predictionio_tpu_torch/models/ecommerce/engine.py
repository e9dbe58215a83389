"""E-commerce recommendation engine template.

The port of the JAX package's ``models/ecommerce/engine.py``: the same
Query/PredictedResult/params classes and the same persisted blob, so a
model written by either package deploys on the other.

Parity with examples/scala-parallel-ecommercerecommendation
(train-with-rate-event; ECommAlgorithm.scala, 649 LoC): implicit ALS
(``ops.als.train_als`` on the context's device: the hand-written
accumulator kernel on a card) with business rules evaluated at serving
time —

  - known user: dot-product scores over candidate items
    (predictKnownUser), one masked matmul + top-k on the factors' device;
  - cold user: cosine similarity to recently-viewed item features
    (predictSimilar) read LIVE from the event store;
  - no signal at all: popularity (buy-count) fallback (predictDefault);
  - blacklists (genBlackList): seen items (live LEventStore read of the
    user's seenEvents), the ``constraint/unavailableItems`` ``$set`` entity
    (latest event wins), and the query's own blackList;
  - category / whiteList candidate filtering (isCandidateItem).

The live reads go to the storage of the context that trained or loaded the
model (``ECommModel.storage``): a deploy's ``Binding`` instantiates its own
algorithm objects, so the model, not the algorithm, carries it.  Each
answer's provenance records the filter sizes, the event-history watermark
it read and the engine path it took; the user-row gather is a
``host_gather`` mark on the wave timeline, and a factor-cache hit is noted
there, as the JAX package does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    EngineContext,
    Preparator,
    SanityCheckError,
    Serving,
)
from predictionio_tpu_torch.core.engine import Engine, engine_factory
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.storage.config import StorageRuntime
from predictionio_tpu_torch.data.store import LEventStore
from predictionio_tpu_torch.models.filters import exclude_mask
from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs import provenance
from predictionio_tpu_torch.models.similarproduct.engine import (
    Item,
    ItemScore,
    PredictedResult,
    category_index,
    items_from_state,
    items_to_state,
    mask_on_device,
    read_entity_items,
    rows_on_device,
)
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.ops.als import ALSParams, train_als
from predictionio_tpu_torch.ops.similarity import cosine_topk, dot_topk
from predictionio_tpu_torch.parallel import device_cache
from predictionio_tpu_torch.resilience.degrade import mark_degraded


#: host seconds of the most recent ``ECommAlgorithm.train``, by stage:
#: ``vocab`` (BiMaps and index arrays), ``train_mask``,
#: ``latest_rating_per_pair``, ``staging`` and ``iterations`` (the two parts
#: of ``train_als``) and ``popularity``
LAST_TRAIN_STAGES: dict[str, float] = {}


@dataclass(frozen=True)
class Query:
    user: str
    num: int = 10
    categories: tuple[str, ...] | None = None
    white_list: tuple[str, ...] | None = None
    black_list: tuple[str, ...] | None = None

    params_aliases = {"whiteList": "white_list", "blackList": "black_list"}


@dataclass
class TrainingData:
    users: list[str]
    items: dict[str, Item]
    # interaction columns (entity/target/event/rating/time)
    int_users: np.ndarray = field(default_factory=lambda: np.empty(0, object))
    int_items: np.ndarray = field(default_factory=lambda: np.empty(0, object))
    int_events: np.ndarray = field(default_factory=lambda: np.empty(0, object))
    int_ratings: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    int_times: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))

    def sanity_check(self):
        if not self.items:
            raise SanityCheckError("no $set item events found")
        if len(self.int_items) == 0:
            raise SanityCheckError("no interaction events found")


PreparedData = TrainingData


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = "default"
    channel_name: str | None = None
    #: interaction events read for training ("view" + "buy" + optional "rate")
    event_names: tuple[str, ...] = ("view", "buy")

    params_aliases = {
        "appName": "app_name",
        "channelName": "channel_name",
        "eventNames": "event_names",
    }


class ECommDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams | None = None):
        self.params = params or DataSourceParams()

    def read_training(self, ctx: EngineContext) -> TrainingData:
        store = ctx.p_event_store
        p = self.params
        users = sorted(
            store.aggregate_properties(p.app_name, "user", channel_name=p.channel_name)
        )
        items = read_entity_items(store, p.app_name, "item", p.channel_name)
        frame = store.find(
            p.app_name,
            channel_name=p.channel_name,
            entity_type="user",
            target_entity_type="item",
            event_names=list(p.event_names),
        )
        ratings = np.ones(len(frame), np.float32)
        r = frame.property_column("rating")
        has_r = ~np.isnan(r)
        ratings[has_r] = r[has_r]
        return TrainingData(
            users=users,
            items=items,
            int_users=frame.entity_id,
            int_items=frame.target_entity_id,
            int_events=frame.event,
            int_ratings=ratings,
            int_times=frame.event_time_ms,
        )


class ECommPreparator(Preparator):
    def __init__(self, params: Any = None):
        pass

    def prepare(self, ctx: EngineContext, td: TrainingData) -> PreparedData:
        return td


def latest_rating_per_pair(u, i, ratings, times, n_items: int):
    """genMLlibRating semantics: latest rating wins per (user, item)
    (ECommAlgorithm.scala train-with-rate-event genMLlibRating).

    Vectorized group-reduce: lexsort by (pair-key, time) — both sorts
    stable — then keep each key group's LAST row, which is exactly the
    entry a sequential "overwrite in time order" loop would retain (time
    ties resolve to the later event, as dict insertion did).  No per-event
    Python work, so 20M-event streams reduce in seconds.
    """
    if len(u) == 0:
        return (
            np.empty(0, np.int32),
            np.empty(0, np.int32),
            np.empty(0, np.float32),
        )
    key = u.astype(np.int64) * n_items + i
    order = np.lexsort((times, key))
    ks = key[order]
    last = np.flatnonzero(np.r_[ks[1:] != ks[:-1], True])
    ku = ks[last]
    return (
        (ku // n_items).astype(np.int32),
        (ku % n_items).astype(np.int32),
        np.asarray(ratings)[order][last].astype(np.float32),
    )


@dataclass(frozen=True)
class ECommAlgorithmParams:
    app_name: str = "default"
    unseen_only: bool = True
    seen_events: tuple[str, ...] = ("buy", "view")
    similar_events: tuple[str, ...] = ("view",)
    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    seed: int = 3
    #: events used to build the training matrix; "rate" keeps its rating
    train_events: tuple[str, ...] = ("view", "buy")

    params_aliases = {
        "appName": "app_name",
        "unseenOnly": "unseen_only",
        "seenEvents": "seen_events",
        "similarEvents": "similar_events",
        "numIterations": "num_iterations",
        "lambda": "reg",
        "trainEvents": "train_events",
    }


@dataclass(eq=False)
class ECommModel:
    user_factors: torch.Tensor  # [n_users, rank] on the serving device
    item_factors: torch.Tensor  # [n_items, rank] on the serving device
    popular_counts: np.ndarray  # [n_items] buy counts
    user_vocab: BiMap
    item_vocab: BiMap
    items: dict[str, Item]
    #: where ``predict`` reads the live events (not persisted): the storage
    #: of the context that trained or loaded the model
    storage: StorageRuntime | None = field(default=None, repr=False)

    def sanity_check(self):
        if not torch.isfinite(self.item_factors).all():
            raise SanityCheckError("item factors are not finite")

    @classmethod
    def from_jax_params(
        cls,
        persisted: dict,
        device: torch.device | str,
        storage: StorageRuntime | None = None,
    ) -> "ECommModel":
        """The port's model from the JAX package's persisted dict
        (``make_persistent_model``): the factors on ``device``, live reads
        from ``storage``."""

        def on_device(name: str) -> torch.Tensor:
            return torch.tensor(
                np.ascontiguousarray(persisted[name], np.float32), device=device
            )

        return cls(
            user_factors=on_device("user_factors"),
            item_factors=on_device("item_factors"),
            popular_counts=np.asarray(persisted["popular_counts"]),
            user_vocab=BiMap.from_state(persisted["user_vocab"]),
            item_vocab=BiMap.from_state(persisted["item_vocab"]),
            items=items_from_state(persisted["items"]),
            storage=storage,
        )


class ECommAlgorithm(Algorithm):
    flavor = "P2L"
    params_class = ECommAlgorithmParams
    query_class = Query

    def __init__(self, params: ECommAlgorithmParams | None = None):
        self.params = params or ECommAlgorithmParams()

    # -- train ---------------------------------------------------------------
    def train(self, ctx: EngineContext, pd: PreparedData) -> ECommModel:
        """Factors on ``ctx.device``; each stage's host seconds go to
        :data:`LAST_TRAIN_STAGES`."""
        p = self.params
        stages: dict[str, float] = {}
        t0 = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t0
            t1 = time.perf_counter()
            stages[name] = t1 - t0
            t0 = t1

        user_vocab = BiMap.from_keys(pd.users)
        item_vocab = BiMap.from_keys(sorted(pd.items))
        u = user_vocab.to_index_array(pd.int_users, missing=-1)
        i = item_vocab.to_index_array(pd.int_items, missing=-1)
        lap("vocab")
        train_mask = (
            (u >= 0) & (i >= 0) & np.isin(pd.int_events, list(p.train_events))
        )
        if not train_mask.any():
            raise SanityCheckError("no valid training interactions")
        lap("train_mask")
        lu, li, lr = latest_rating_per_pair(
            u[train_mask],
            i[train_mask],
            pd.int_ratings[train_mask],
            pd.int_times[train_mask],
            len(item_vocab),
        )
        lap("latest_rating_per_pair")
        als.LAST_PLAN_INFO.pop("stage_s", None)
        state = train_als(
            lu,
            li,
            lr,
            num_users=len(user_vocab),
            num_items=len(item_vocab),
            params=ALSParams(
                rank=p.rank,
                num_iterations=p.num_iterations,
                reg=p.reg,
                implicit_prefs=True,
                seed=p.seed,
            ),
            device=ctx.device,
        )
        lap("iterations")
        # staging is skipped when the streams are already staged
        stages["staging"] = als.LAST_PLAN_INFO.get("stage_s", 0.0)
        stages["iterations"] -= stages["staging"]
        # trainDefault: buy-count popularity fallback scores
        pop = np.zeros(len(item_vocab), np.int64)
        buy_mask = (i >= 0) & (pd.int_events == "buy")
        np.add.at(pop, i[buy_mask], 1)
        lap("popularity")
        LAST_TRAIN_STAGES.clear()
        LAST_TRAIN_STAGES.update(stages)
        return ECommModel(
            user_factors=state.user_factors,
            item_factors=state.item_factors,
            popular_counts=pop,
            user_vocab=user_vocab,
            item_vocab=item_vocab,
            items=dict(pd.items),
            storage=ctx.storage_runtime,
        )

    # -- business rules ------------------------------------------------------
    def _gen_black_list(self, store: LEventStore, query: Query) -> set[str]:
        """Seen events + unavailableItems constraint + query blackList
        (ECommAlgorithm.genBlackList).

        The live event-store reads here are the hot path's dependency on
        storage: when the store fails, the query still answers from the
        model alone, marked degraded, never errored (the reference
        template's timeout-to-empty-list semantics, made visible)."""
        seen: set[str] = set()
        watermark = None
        if self.params.unseen_only:
            try:
                for e in store.find_by_entity(
                    self.params.app_name,
                    entity_type="user",
                    entity_id=query.user,
                    event_names=list(self.params.seen_events),
                    target_entity_type="item",
                ):
                    if e.target_entity_id is not None:
                        seen.add(e.target_entity_id)
                    if watermark is None or e.event_time > watermark:
                        watermark = e.event_time
            except Exception:
                mark_degraded("seen_filter")
                seen = set()  # timeout semantics: empty seen list
        unavailable: set[str] = set()
        try:
            latest = store.find_by_entity(
                self.params.app_name,
                entity_type="constraint",
                entity_id="unavailableItems",
                event_names=["$set"],
                limit=1,
                latest=True,
            )
            for e in latest:
                unavailable = set(e.properties.get_or_else("items", []))
        except Exception:
            mark_degraded("unavailable_items")
            unavailable = set()
        provenance.note(
            filters={
                "seen": len(seen),
                "unavailable": len(unavailable),
                "black_list": len(query.black_list or ()),
            }
        )
        if watermark is not None:
            # newest event-history timestamp the answer depended on: the
            # freshness watermark a replay cannot honor once later events
            # land
            provenance.note(event_watermark=watermark.isoformat())
        provenance.note_deep(
            seen_items=provenance.clip(seen),
            unavailable_items=provenance.clip(unavailable),
        )
        return seen | unavailable | set(query.black_list or ())

    def _recent_items(self, store: LEventStore, query: Query) -> list[str]:
        """Latest 10 similar-events targets for the user (getRecentItems).
        Store unreachable -> no recent signal: the cold-user path falls
        through to popularity, marked degraded."""
        try:
            events = list(
                store.find_by_entity(
                    self.params.app_name,
                    entity_type="user",
                    entity_id=query.user,
                    event_names=list(self.params.similar_events),
                    target_entity_type="item",
                    limit=10,
                    latest=True,
                )
            )
            recent = [e.target_entity_id for e in events if e.target_entity_id]
            provenance.note(filters_recent=len(recent))
            if events:
                # latest=True: the first event is the newest consulted
                provenance.note(
                    event_watermark=events[0].event_time.isoformat()
                )
            provenance.note_deep(recent_items=provenance.clip(recent))
            return recent
        except Exception:
            mark_degraded("recent_items")
            return []

    def _exclude_mask(
        self, model: ECommModel, query: Query, black: set[str]
    ) -> np.ndarray:
        return exclude_mask(
            model.item_vocab,
            category_index=category_index(model),
            white_list=query.white_list,
            black_list=black,
            categories=query.categories,
        )

    def _user_row(self, model: ECommModel, user: str) -> torch.Tensor | None:
        """The user's factor row, gathered on the factors' device and cached
        per model: a repeat user skips the gather (the row never leaves
        device memory between requests).  The cache dies with the model
        object, so a generation swap can never serve a stale row
        (parallel/device_cache.py)."""
        cache = device_cache.model_cache(model)
        row = cache.get(user)
        if row is not None:
            device_obs.note_cache_hit()
            return row
        uidx = model.user_vocab.get(user)
        if uidx is None:
            return None
        with device_obs.wave_stage("host_gather"):
            row = model.user_factors[uidx]
        cache.put(user, row)
        return row

    # -- predict -------------------------------------------------------------
    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        # NOTE: serving-time event-store reads put a storage round trip
        # inside the query path, exactly like the reference template
        store = LEventStore(model.storage)
        black = self._gen_black_list(store, query)
        exclude = self._exclude_mask(model, query, black)
        k = min(query.num, len(model.item_vocab))
        F = model.item_factors
        qrow = self._user_row(model, query.user)
        if qrow is not None:
            provenance.note(engine_path="ecomm.dot_topk")
            scores, idx = dot_topk(qrow, F, mask_on_device(exclude, F), k)
            return self._to_result(model, scores, idx)
        recent = [
            i
            for x in self._recent_items(store, query)
            if (i := model.item_vocab.get(x)) is not None
        ]
        if recent:
            provenance.note(engine_path="ecomm.cosine_topk")
            scores, idx = cosine_topk(
                rows_on_device(F, recent), F, mask_on_device(exclude, F), k
            )
            return self._to_result(model, scores, idx)
        # popularity fallback
        provenance.note(engine_path="ecomm.popularity")
        pop = np.where(exclude, -1, model.popular_counts)
        order = np.argsort(-pop, kind="stable")[:k]
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=model.item_vocab.inverse(int(j)), score=float(pop[j]))
                for j in order
                if pop[j] >= 0
            )
        )

    def _to_result(self, model: ECommModel, scores, idx) -> PredictedResult:
        out = []
        # the k scores and ids come back to the host, nothing else
        for s, j in zip(scores.cpu().numpy(), idx.cpu().numpy()):
            if not np.isfinite(s):
                continue
            out.append(
                ItemScore(item=model.item_vocab.inverse(int(j)), score=float(s))
            )
        return PredictedResult(item_scores=tuple(out))

    # -- persistence ---------------------------------------------------------
    def make_persistent_model(self, ctx, model: ECommModel):
        return {
            "user_factors": model.user_factors.cpu().numpy(),
            "item_factors": model.item_factors.cpu().numpy(),
            "popular_counts": model.popular_counts,
            "user_vocab": model.user_vocab.to_state(),
            "item_vocab": model.item_vocab.to_state(),
            "items": items_to_state(model.items),
        }

    def load_persistent_model(self, ctx, data) -> ECommModel:
        return ECommModel.from_jax_params(data, ctx.device, ctx.storage_runtime)


class ECommServing(Serving):
    def __init__(self, params: Any = None):
        pass

    def serve(self, query, predictions):
        return predictions[0]


@engine_factory("ecommerce")
def ecommerce_engine() -> Engine:
    return Engine(
        ECommDataSource,
        ECommPreparator,
        {"ecomm": ECommAlgorithm},
        ECommServing,
    )
