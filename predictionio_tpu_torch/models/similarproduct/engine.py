"""Similar-product engine template.

The port of the JAX package's ``models/similarproduct/engine.py``: the same
Query/PredictedResult/params classes and the same persisted blobs, so a
model written by either package deploys on the other.

Parity with examples/scala-parallel-similarproduct (train-with-rate-event +
multi-events-multi-algos variants): ``$set`` user/item entities (items carry
``categories``), user->item ``view``/``rate`` events; three algorithms —

  - ``als``          implicit-feedback ALS item factors (``ops.als.train_als``
                     on the context's device: the hand-written accumulator
                     kernel on a card); item-to-item scoring by summed
                     cosine of query-item vectors against every item
                     (ALSAlgorithm.scala predict), one matmul + top-k on the
                     factors' device (``ops.similarity.cosine_topk``).
  - ``cooccurrence`` top-N co-view counts per item
                     (CooccurrenceAlgorithm.scala:42-100).
  - ``likealgo``     like/dislike events as +1/-1 weighted implicit ALS
                     (LikeAlgorithm.scala).

Query {items, num, categories?, categoryBlackList?, whiteList?, blackList?}
filters candidates the way isCandidateItem does: category intersection,
white/black lists, and query items excluded.
"""

from __future__ import annotations

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
from predictionio_tpu_torch.models.filters import CategoryIndex, exclude_mask
from predictionio_tpu_torch.ops.als import ALSParams, train_als
from predictionio_tpu_torch.ops.similarity import cosine_topk


@dataclass(frozen=True)
class Query:
    items: tuple[str, ...]
    num: int = 10
    categories: tuple[str, ...] | None = None
    category_black_list: tuple[str, ...] | None = None
    white_list: tuple[str, ...] | None = None
    black_list: tuple[str, ...] | None = None

    params_aliases = {
        "categoryBlackList": "category_black_list",
        "whiteList": "white_list",
        "blackList": "black_list",
    }


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
class Item:
    categories: tuple[str, ...] = ()


@dataclass
class TrainingData:
    users: list[str]
    items: dict[str, Item]
    # (user, item, weight, time) interaction columns; weight<0 = dislike,
    # rate events carry their rating as the weight
    view_users: np.ndarray = field(default_factory=lambda: np.empty(0, object))
    view_items: np.ndarray = field(default_factory=lambda: np.empty(0, object))
    view_weights: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    view_times: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))

    def sanity_check(self):
        if not self.items:
            raise SanityCheckError("no $set item events found")
        if len(self.view_items) == 0:
            raise SanityCheckError("no view/rate events found")


PreparedData = TrainingData  # identity preparation (reference Preparator.scala)


@dataclass(frozen=True)
class DataSourceParams:
    app_name: str = "default"
    channel_name: str | None = None
    #: events treated as interactions; "like"/"dislike" get signed weights
    event_names: tuple[str, ...] = ("view",)
    #: entity type of the interaction TARGET: "item" for the product
    #: variants, "user" for the recommended-user variant (users viewing
    #: users, recommended-user/DataSource.scala)
    target_entity_type: str = "item"

    params_aliases = {
        "appName": "app_name",
        "channelName": "channel_name",
        "eventNames": "event_names",
        "targetEntityType": "target_entity_type",
    }


def read_entity_items(store, app_name: str, entity_type: str, channel_name):
    """``$set`` entities of ``entity_type`` -> :class:`Item` with their
    ``categories`` (the aggregated properties' ``get_or_else``)."""
    return {
        item_id: Item(categories=tuple(props.get_or_else("categories", [])))
        for item_id, props in store.aggregate_properties(
            app_name, entity_type, channel_name=channel_name
        ).items()
    }


class SimilarProductDataSource(DataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams | None = None):
        self.params = params or DataSourceParams()

    def read_training(self, ctx: EngineContext) -> TrainingData:
        store = ctx.p_event_store
        p = self.params
        users = sorted(
            store.aggregate_properties(p.app_name, "user", channel_name=p.channel_name)
        )
        items = read_entity_items(
            store, p.app_name, p.target_entity_type, p.channel_name
        )
        frame = store.find(
            p.app_name,
            channel_name=p.channel_name,
            entity_type="user",
            target_entity_type=p.target_entity_type,
            event_names=list(p.event_names),
        )
        weights = np.where(frame.event == "dislike", -1.0, 1.0).astype(np.float32)
        # rate events carry their rating as the weight (train-with-rate-event);
        # property_column is columnar over lazy rows — no per-event loop
        r = frame.property_column("rating")
        has_r = ~np.isnan(r)
        weights[has_r] = r[has_r]
        return TrainingData(
            users=users,
            items=items,
            view_users=frame.entity_id,
            view_items=frame.target_entity_id,
            view_weights=weights,
            view_times=frame.event_time_ms,
        )


class SimilarProductPreparator(Preparator):
    def __init__(self, params: Any = None):
        pass

    def prepare(self, ctx: EngineContext, td: TrainingData) -> PreparedData:
        return td


# ---------------------------------------------------------------------------
# ALS (implicit feedback)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ALSAlgorithmParams:
    rank: int = 10
    num_iterations: int = 20
    reg: float = 0.01
    alpha: float = 1.0
    seed: int = 3

    params_aliases = {"numIterations": "num_iterations", "lambda": "reg"}


def items_from_state(items: dict) -> dict[str, Item]:
    return {k: Item(categories=tuple(v)) for k, v in items.items()}


def items_to_state(items: dict[str, Item]) -> dict:
    return {k: v.categories for k, v in items.items()}


@dataclass(eq=False)
class SimilarProductModel:
    item_factors: torch.Tensor  # [n_items, rank] on the serving device
    item_vocab: BiMap
    items: dict[str, Item]

    def sanity_check(self):
        if not torch.isfinite(self.item_factors).all():
            raise SanityCheckError("item factors are not finite")

    @classmethod
    def from_jax_params(
        cls, persisted: dict, device: torch.device | str
    ) -> "SimilarProductModel":
        """The port's model from the JAX package's persisted dict
        (``make_persistent_model``): the factors on ``device``."""
        return cls(
            item_factors=torch.tensor(
                np.ascontiguousarray(persisted["item_factors"], np.float32),
                device=device,
            ),
            item_vocab=BiMap.from_state(persisted["item_vocab"]),
            items=items_from_state(persisted["items"]),
        )


def category_index(model: Any) -> CategoryIndex:
    """The model's CategoryIndex, built at its first query and cached on it
    so repeated queries skip rebuilding it."""
    index = getattr(model, "_category_index", None)
    if index is None:
        index = model._category_index = CategoryIndex(
            model.item_vocab, {k: v.categories for k, v in model.items.items()}
        )
    return index


def _candidate_mask(model: Any, query: Query, query_idx: set[int]) -> np.ndarray:
    """isCandidateItem as a vectorized exclude-mask over item indices."""
    return exclude_mask(
        model.item_vocab,
        category_index=category_index(model),
        query_idx=query_idx,
        white_list=query.white_list,
        black_list=query.black_list or (),
        categories=query.categories,
        category_black_list=query.category_black_list,
    )


def rows_on_device(factors: torch.Tensor, rows) -> torch.Tensor:
    """``factors[rows]`` gathered where the factors live: no whole-table
    copy to the host."""
    return factors[torch.as_tensor(rows, dtype=torch.int64, device=factors.device)]


def mask_on_device(exclude: np.ndarray, factors: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(exclude).to(factors.device)


def _topk_to_result(
    model: SimilarProductModel, scores, idx, positive_only: bool = True
) -> PredictedResult:
    out = []
    # the k scores and ids come back to the host, nothing else
    for s, i in zip(scores.cpu().numpy(), idx.cpu().numpy()):
        if not np.isfinite(s) or (positive_only and s <= 0):
            continue
        out.append(ItemScore(item=model.item_vocab.inverse(int(i)), score=float(s)))
    return PredictedResult(item_scores=tuple(out))


class ALSAlgorithm(Algorithm):
    """Implicit ALS on interaction counts; cosine item-to-item serving."""

    flavor = "P2L"
    params_class = ALSAlgorithmParams
    query_class = Query

    def __init__(self, params: ALSAlgorithmParams | None = None):
        self.params = params or ALSAlgorithmParams()

    #: events used to build the interaction matrix; LikeAlgorithm narrows it
    def _interactions(self, pd: PreparedData):
        return pd.view_users, pd.view_items, np.abs(pd.view_weights)

    def train(self, ctx: EngineContext, pd: PreparedData) -> SimilarProductModel:
        """Item factors on ``ctx.device``: the accumulator kernel on a card."""
        users, items_col, weights = self._interactions(pd)
        user_vocab = BiMap.from_keys(pd.users)
        item_vocab = BiMap.from_keys(sorted(pd.items))
        u_idx = user_vocab.to_index_array(users, missing=-1)
        i_idx = item_vocab.to_index_array(items_col, missing=-1)
        keep = (u_idx >= 0) & (i_idx >= 0)
        if not keep.any():
            raise SanityCheckError(
                "no valid interactions after vocab mapping — check that "
                "$set user/item events cover the interaction events"
            )
        p = self.params
        state = train_als(
            u_idx[keep].astype(np.int32),
            i_idx[keep].astype(np.int32),
            weights[keep],
            num_users=len(user_vocab),
            num_items=len(item_vocab),
            params=ALSParams(
                rank=p.rank,
                num_iterations=p.num_iterations,
                reg=p.reg,
                implicit_prefs=True,
                alpha=p.alpha,
                seed=p.seed,
            ),
            device=ctx.device,
            mesh=ctx.mesh if ctx.mesh.devices.size > 1 else None,
        )
        return SimilarProductModel(
            item_factors=state.item_factors,
            item_vocab=item_vocab,
            items=dict(pd.items),
        )

    def predict(self, model: SimilarProductModel, query: Query) -> PredictedResult:
        query_idx = {
            i for x in query.items if (i := model.item_vocab.get(x)) is not None
        }
        if not query_idx:
            return PredictedResult()
        F = model.item_factors
        exclude = _candidate_mask(model, query, query_idx)
        k = min(query.num, len(model.item_vocab))
        scores, idx = cosine_topk(
            rows_on_device(F, sorted(query_idx)), F, mask_on_device(exclude, F), k
        )
        return _topk_to_result(model, scores, idx)

    def make_persistent_model(self, ctx, model: SimilarProductModel):
        return {
            "item_factors": model.item_factors.cpu().numpy(),
            "item_vocab": model.item_vocab.to_state(),
            "items": items_to_state(model.items),
        }

    def load_persistent_model(self, ctx, data) -> SimilarProductModel:
        return SimilarProductModel.from_jax_params(data, ctx.device)


class LikeAlgorithm(ALSAlgorithm):
    """like/dislike events as signed implicit feedback (LikeAlgorithm.scala):
    the LATEST event per (user, item) wins and trains with rating +1 (like)
    or -1 (dislike) — the implicit ALS kernel maps negative ratings to
    preference 0 at confidence 1+alpha, MLlib trainImplicit semantics."""

    def _interactions(self, pd: PreparedData):
        if len(pd.view_users) == 0:
            return pd.view_users, pd.view_items, pd.view_weights
        # Vectorized latest-per-(user,item): encode both entities to int
        # codes, lexsort by (pair-key, time) — both stable — and keep each
        # group's LAST row (later events win time ties).
        _, ucode = np.unique(pd.view_users, return_inverse=True)
        uniq_items, icode = np.unique(pd.view_items, return_inverse=True)
        key = ucode.astype(np.int64) * len(uniq_items) + icode
        order = np.lexsort((np.asarray(pd.view_times), key))
        ks = key[order]
        sel = order[np.flatnonzero(np.r_[ks[1:] != ks[:-1], True])]
        weights = np.where(
            np.asarray(pd.view_weights)[sel] > 0, 1.0, -1.0
        ).astype(np.float32)
        return (
            np.asarray(pd.view_users)[sel],
            np.asarray(pd.view_items)[sel],
            weights,
        )


# ---------------------------------------------------------------------------
# Co-occurrence
# ---------------------------------------------------------------------------


def _sparse_cooccurrence(pairs: np.ndarray, n_items: int):
    """Symmetric co-view COO (src, dst, count) via vectorized per-user pair
    expansion — the reference's self-join semantics
    (CooccurrenceAlgorithm.scala:84-88) with no per-event Python loop.

    ``pairs`` is the deduped [(user, item)] array lexicographically sorted
    (np.unique output), so items ascend within each user segment and every
    generated (left, right) pair already has left < right.  Total work is
    O(sum deg^2) like the reference's self-join; pair generation is chunked
    (~32M pairs at a time) so peak memory stays bounded on heavy users.
    """
    u = pairs[:, 0].astype(np.int64)
    it = pairs[:, 1].astype(np.int64)
    n = len(u)
    empty = (np.empty(0, np.int64),) * 3
    if n == 0:
        return empty
    seg_starts = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
    deg = np.diff(np.r_[seg_starts, n])
    pos = np.arange(n) - np.repeat(seg_starts, deg)
    rep = np.repeat(deg, deg) - 1 - pos  # rights paired with each left row
    cum = np.cumsum(rep)
    key_parts: list[np.ndarray] = []
    cnt_parts: list[np.ndarray] = []
    budget = 1 << 25
    start = 0
    while start < n:
        base = cum[start - 1] if start else 0
        end = max(int(np.searchsorted(cum, base + budget, "right")), start + 1)
        # splitting inside a user segment is safe: each LEFT row's pair set
        # (its rights) is generated wholly within the chunk that owns it
        r = rep[start:end]
        tot = int(r.sum())
        if tot:
            grp = np.cumsum(r) - r
            within = np.arange(tot) - np.repeat(grp, r)
            right_rows = np.repeat(np.arange(start, end) + 1, r) + within
            k = np.repeat(it[start:end], r) * n_items + it[right_rows]
            uk, uc = np.unique(k, return_counts=True)
            key_parts.append(uk)
            cnt_parts.append(uc.astype(np.int64))
        start = end
    if not key_parts:
        return empty
    allk = np.concatenate(key_parts)
    uk, inv = np.unique(allk, return_inverse=True)
    cc = np.zeros(len(uk), np.int64)
    np.add.at(cc, inv, np.concatenate(cnt_parts))
    i1, i2 = uk // n_items, uk % n_items
    return (
        np.concatenate([i1, i2]),
        np.concatenate([i2, i1]),
        np.concatenate([cc, cc]),
    )


@dataclass(frozen=True)
class CooccurrenceAlgorithmParams:
    n: int = 20  # top co-occurrences kept per item


@dataclass
class CooccurrenceModel:
    top_cooccurrences: dict[int, list[tuple[int, int]]]  # item -> [(item, count)]
    item_vocab: BiMap
    items: dict[str, Item]

    @classmethod
    def from_jax_params(
        cls, persisted: dict, device: torch.device | str | None = None
    ) -> "CooccurrenceModel":
        """The port's model from the JAX package's persisted dict; a host
        model (its counts are Python lists), so ``device`` is not read."""
        return cls(
            top_cooccurrences={
                int(k): [(int(j), int(c)) for j, c in v]
                for k, v in persisted["top"].items()
            },
            item_vocab=BiMap.from_state(persisted["item_vocab"]),
            items=items_from_state(persisted["items"]),
        )


class CooccurrenceAlgorithm(Algorithm):
    """Top-N co-view pairs per item (CooccurrenceAlgorithm.scala:66-100).

    The self-join + reduceByKey becomes one matmul on the context's device:
    with B the [users x items] binary view matrix, co-occurrence counts are
    B^T B (sums of 0/1 products, exact in fp32 up to 2^24, so TF32 cannot
    change them either).  Past ``_DENSE_CELL_LIMIT`` cells the counts come
    from the sparse host expansion instead.
    """

    flavor = "P2L"
    params_class = CooccurrenceAlgorithmParams
    query_class = Query

    def __init__(self, params: CooccurrenceAlgorithmParams | None = None):
        self.params = params or CooccurrenceAlgorithmParams()

    #: above this many matrix cells, fall back to the sparse host path
    _DENSE_CELL_LIMIT = 1 << 24

    def train(self, ctx: EngineContext, pd: PreparedData) -> CooccurrenceModel:
        item_vocab = BiMap.from_keys(sorted(pd.items))
        user_vocab = BiMap.from_keys(sorted(set(pd.view_users)))
        u = user_vocab.to_index_array(pd.view_users, missing=-1)
        i = item_vocab.to_index_array(pd.view_items, missing=-1)
        keep = (u >= 0) & (i >= 0)
        u, i = u[keep], i[keep]
        # distinct (user, item): multiple views count once
        pairs = np.unique(np.stack([u, i], axis=1), axis=0)
        n_users, n_items = len(user_vocab), len(item_vocab)
        if n_users * n_items <= self._DENSE_CELL_LIMIT:
            # small catalogs: B^T B in one matmul on the device
            b = torch.zeros((n_users, n_items), dtype=torch.float32, device=ctx.device)
            rows = torch.from_numpy(pairs.astype(np.int64)).to(ctx.device)
            b[rows[:, 0], rows[:, 1]] = 1.0
            counts = (b.T @ b).cpu().numpy()
            np.fill_diagonal(counts, 0)
            src, dst = np.nonzero(counts)
            cnt = counts[src, dst].astype(np.int64)
        else:
            src, dst, cnt = _sparse_cooccurrence(pairs, n_items)
        # top-N per source item, fully vectorized: one lexsort orders every
        # (src asc, count desc, dst asc) triple; each item's slice prefix is
        # its top-N (dst ascending on ties)
        top: dict[int, list[tuple[int, int]]] = {}
        n_keep = self.params.n
        if len(src):
            order = np.lexsort((dst, -cnt, src))
            s2, d2, c2 = src[order], dst[order], cnt[order]
            starts = np.flatnonzero(np.r_[True, s2[1:] != s2[:-1]])
            ends = np.r_[starts[1:], len(s2)]
            for st, en in zip(starts, np.minimum(ends, starts + n_keep)):
                top[int(s2[st])] = [
                    (int(j), int(c)) for j, c in zip(d2[st:en], c2[st:en])
                ]
        return CooccurrenceModel(
            top_cooccurrences=top, item_vocab=item_vocab, items=dict(pd.items)
        )

    def predict(self, model: CooccurrenceModel, query: Query) -> PredictedResult:
        query_idx = {
            i for x in query.items if (i := model.item_vocab.get(x)) is not None
        }
        counts: dict[int, int] = {}
        for qi in query_idx:
            for j, c in model.top_cooccurrences.get(qi, []):
                counts[j] = counts.get(j, 0) + c
        exclude = _candidate_mask(model, query, query_idx)
        scored = [(j, c) for j, c in counts.items() if not exclude[j]]
        scored.sort(key=lambda t: -t[1])
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=model.item_vocab.inverse(j), score=float(c))
                for j, c in scored[: query.num]
            )
        )

    def make_persistent_model(self, ctx, model: CooccurrenceModel):
        return {
            "top": {int(k): v for k, v in model.top_cooccurrences.items()},
            "item_vocab": model.item_vocab.to_state(),
            "items": items_to_state(model.items),
        }

    def load_persistent_model(self, ctx, data) -> CooccurrenceModel:
        return CooccurrenceModel.from_jax_params(data)


class SimilarProductServing(Serving):
    def __init__(self, params: Any = None):
        pass

    def serve(self, query: Query, predictions) -> PredictedResult:
        """Standard serving keeps the first algorithm's result; the
        multi-algo variant aggregates by item summing scores
        (multi-events-multi-algos Serving.scala)."""
        if len(predictions) == 1:
            return predictions[0]
        combined: dict[str, float] = {}
        for p in predictions:
            for s in p.item_scores:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        ranked = sorted(combined.items(), key=lambda t: -t[1])[: query.num]
        return PredictedResult(
            item_scores=tuple(ItemScore(item=i, score=s) for i, s in ranked)
        )


@engine_factory("similarproduct")
def similarproduct_engine() -> Engine:
    return Engine(
        SimilarProductDataSource,
        SimilarProductPreparator,
        {
            "als": ALSAlgorithm,
            "cooccurrence": CooccurrenceAlgorithm,
            "likealgo": LikeAlgorithm,
        },
        SimilarProductServing,
    )


# ---------------------------------------------------------------------------
# Recommended-user variant: similar USERS for a set of users
# (examples/scala-parallel-similarproduct/recommended-user).  The reference
# reads user-views-USER events and keeps the ALS target-side ("product")
# factors, which are then viewed-user features — with the datasource's
# targetEntityType="user", the standard ALSAlgorithm pipeline already
# computes exactly that; only the query surface differs ({users} in,
# similar users out).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UserQuery:
    users: tuple[str, ...]
    num: int = 10
    white_list: tuple[str, ...] | None = None
    black_list: tuple[str, ...] | None = None

    params_aliases = {"whiteList": "white_list", "blackList": "black_list"}


class RecommendedUserAlgorithm(ALSAlgorithm):
    """ALSAlgorithm with the user-query surface: the trained "item" table
    holds viewed-user features (targetEntityType="user"), so similarity,
    exclusion, white/black lists, persistence, and the positive-score
    filter are all inherited."""

    query_class = UserQuery

    def predict(
        self, model: SimilarProductModel, query: UserQuery
    ) -> PredictedResult:
        return super().predict(
            model,
            Query(
                items=tuple(query.users),
                num=query.num,
                white_list=query.white_list,
                black_list=query.black_list,
            ),
        )


@engine_factory("recommendeduser")
def recommendeduser_engine() -> Engine:
    return Engine(
        SimilarProductDataSource,
        SimilarProductPreparator,
        {"als": RecommendedUserAlgorithm},
        SimilarProductServing,
    )
