"""Deep recommendation template: NCF / two-tower.

The port of the JAX package's ``models/ncf/engine.py``: the recommendation
template's event schema and query/result shapes (``{user, num}`` ->
``{itemScores}``), trained as the two-tower model of ``ops/ncf.py`` on the
context's device, and the same persisted blob, so a model written by either
package deploys on the other.

- Training: ``NCFAlgorithm.train`` keeps the ratings at or above
  ``positive_threshold`` and runs ``ops.ncf.train_ncf``.  With
  ``pretrain="als"`` the pure-GMF tables start from implicit ALS at rank
  ``embed_dim`` (``ops.als.train_als``: the hand-written accumulator kernel
  on a card); a previous generation's tables (``run_train(
  warm_start_from=...)``) take precedence over both.
- Solo queries (``predict``) are answered from the host numpy replica
  (``_host_score_topk``, the JAX package's code), repeat users from the
  model's factor cache.
- Waves (``batch_predict``, and ``dispatch_batch`` for the micro-batcher's
  pipelined waves of at most ``MAX_WAVE`` queries) run on the model's
  device: the users' rows through ``score_users_vs_items`` and a stable
  (value descending, id ascending) sort, padded to a power-of-two menu
  (b >= 32, k >= 16), one fence per wave.  A failed wave is retried on the
  device, never answered from the host replica.

The persisted ``config`` is a plain dict of ``NCFParams`` fields, which the
JAX package stores without reading; a JAX-written blob's ``NCFParams``
loads as the port's (``core.persistence`` maps the JAX package's classes
onto the port's).  A recorded ``shard_plan`` (``shard_serving=True``) is
the JAX package's plan dict (``ShardPlan.model_parallel``: both embedding
tables and the item bias row-sharded, the MLP head replicated).  A context
with more than one slot (``EngineContext.mesh_devices``) binds it at load,
and every wave then scores each slot's item rows alone and merges the k
winners (``_sharded_packed_topk``, ``parallel.placement``; plain torch per
slot, as the JAX package has no Pallas there); one slot ignores it.

Observability, as the ALS engine places it: host stage marks on the wave
timeline, the bytes that cross, the launch shape per wave
(``ncf.batch_predict``, keyed on the padded b, k and the table shapes), the
engine path of each route in the answer's provenance (``ncf.host_replica``,
``ncf.device_wave``), and the wave's device time from CUDA events against
the least work of the wave on ``/efficiency.json``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.core.base import Algorithm, EngineContext, SanityCheckError
from predictionio_tpu_torch.core.device_wave import dispatch_wave
from predictionio_tpu_torch.core.engine import Engine, engine_factory
from predictionio_tpu_torch.core.warmstart import align_warm_factors, find_warm_start
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.models.recommendation.engine import (
    ItemScore,
    PredictedResult,
    PreparedData,
    Query,
    RatingsDataSource,
    RatingsPreparator,
    RecommendationServing,
)
from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs import provenance
from predictionio_tpu_torch.ops.ncf import (
    NCFParams,
    NCFState,
    host_params,
    ncf_wave_least_work,
    score_users_vs_items,
    train_ncf,
    tree_map,
)
from predictionio_tpu_torch.parallel import device_cache
from predictionio_tpu_torch.parallel.mesh import meter_shards
from predictionio_tpu_torch.parallel.placement import (
    ShardPlan,
    bind_shards,
    build_sharded_topk,
    gather_rows,
    run_observed_wave,
)


@dataclass(frozen=True)
class NCFAlgorithmParams:
    embed_dim: int = 32
    mlp_layers: tuple[int, ...] = (64, 32, 16)
    learning_rate: float = 1e-3
    num_epochs: int = 5
    batch_size: int = 8192
    positive_threshold: float = 4.0  # ratings >= this are positives
    negatives_per_positive: int = 1  # K sampled negatives per step
    neg_power: float = 0.0  # see ops.ncf.NCFParams.neg_power
    #: "bpr" | "softmax" | "full_softmax" | "wals" (whole-catalog losses
    #: need mlp_layers=())
    loss: str = "bpr"
    item_bias: bool = True  # learned per-item score offset
    weight_decay: float = 0.0  # AdamW decoupled decay (0 = plain Adam)
    #: iALS confidence weight (loss="wals" and the "als" pretrainer)
    alpha: float = 2.0
    #: record a factor-sharded serving plan in the persisted model; a
    #: context with one slot ignores it, as the JAX package does on one
    #: device
    shard_serving: bool = False
    #: "" (random init) or "als": pretrain the GMF tables with implicit
    #: ALS (rank = embed_dim) before SGD fine-tuning; needs mlp_layers=()
    pretrain: str = ""
    seed: int = 3

    params_aliases = {
        "embedDim": "embed_dim",
        "mlpLayers": "mlp_layers",
        "learningRate": "learning_rate",
        "numEpochs": "num_epochs",
        "batchSize": "batch_size",
        "positiveThreshold": "positive_threshold",
        "negativesPerPositive": "negatives_per_positive",
        "negPower": "neg_power",
        "itemBias": "item_bias",
        "weightDecay": "weight_decay",
        "shardServing": "shard_serving",
    }

    def __post_init__(self):
        if self.pretrain not in ("", "als"):
            raise ValueError(f"unknown pretrain {self.pretrain!r}")
        if self.pretrain == "als" and self.mlp_layers:
            raise ValueError(
                "pretrain='als' initializes the pure-GMF tables: set "
                "mlpLayers to []"
            )


def _packable_n_items(model: "NCFModel") -> int:
    """The packed [scores | indices] f32 transfer holds item ids exactly
    only below 2^24; refuse a larger catalog loudly."""
    n_items = len(model.item_vocab)
    if n_items >= 1 << 24:
        raise ValueError(
            f"{n_items} items exceeds the f32-exact id range of the packed "
            "top-k transfer (2^24)"
        )
    return n_items


def _host_score_topk(hp: dict, uidx: int, n_items: int, k: int, ue=None):
    """numpy replica of ops.ncf.score_all_items + top-k for ONE user (the
    JAX package's, as it is).  ``ue`` (the user's embedding row) may arrive
    pre-gathered from the factor cache."""
    if "out_w" not in hp:  # pure GMF (mlp_layers=())
        if ue is None:
            ue = hp["user_emb"][uidx]
        score = hp["item_emb"] @ ue + hp["out_b"][0]
    else:
        d = hp["user_emb"].shape[1] // 2
        n_full = hp["item_emb"].shape[0]
        if ue is None:
            ue = hp["user_emb"][uidx]
        gmf = ue[None, :d] * hp["item_emb"][:, :d]
        h = np.concatenate(
            [np.broadcast_to(ue[d:], (n_full, d)), hp["item_emb"][:, d:]],
            axis=-1,
        )
        for layer in hp["mlp"]:
            h = np.maximum(h @ layer["w"] + layer["b"], 0.0)
        score = (
            np.concatenate([gmf, h], axis=-1) @ hp["out_w"] + hp["out_b"]
        )[:, 0]
    bias = hp.get("item_bias")
    if bias is not None:
        score = score + bias
    score = score[:n_items]  # drop table padding rows
    k = min(k, n_items)
    top = np.argpartition(-score, k - 1)[:k]
    top = top[np.argsort(-score[top], kind="stable")]
    return score[top], top


def score_topk_batch(params: dict, users: torch.Tensor, n_items: int, k: int,
                     timing: tuple | None = None) -> torch.Tensor:
    """A wave on the tables' device: ``users`` [B] -> the packed [2, B, k]
    float32 (scores, item ids) of each user's k best real items under
    (value descending, id ascending).  ``timing``, a pair of CUDA events,
    brackets the device work."""
    if timing is not None:
        timing[0].record()
    scores = score_users_vs_items(
        params, params["user_emb"][users], params["item_emb"],
        params.get("item_bias"),
    )[:, :n_items]  # table padding rows never win
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    packed = torch.stack([vals[:, :k], idx[:, :k].to(torch.float32)])
    if timing is not None:
        timing[1].record()
    return packed


@dataclass(eq=False)
class NCFModel:
    state: NCFState
    user_vocab: BiMap
    item_vocab: BiMap
    #: factor-sharded serving state (parallel.placement.BoundShards) when a
    #: ShardPlan was re-bound at load; None = single-device serving
    shards: Any = None

    def sanity_check(self):
        if not torch.isfinite(self.state.params["user_emb"]).all():
            raise SanityCheckError("NCF embeddings are not finite")

    @property
    def host_params(self) -> dict:
        """Host (numpy) replica of the parameter tree for the solo-query
        path, built once per model (excluded from pickled state)."""
        hp = getattr(self, "_host_params", None)
        if hp is None:
            hp = host_params(self.state.params)
            self._host_params = hp
        return hp

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_host_params", None)
        d["shards"] = None  # device placement never rides in a pickle
        return d


def _wave_shape(iq, n_items: int) -> tuple[int, int]:
    """The padded (b, k) of a wave: powers of two with b >= 32 and
    k >= 16, so a novel ``num`` or wave size adds no launch shape."""
    want_k = min(max(q.num for _, q in iq), n_items)
    k = min(max(1 << (want_k - 1).bit_length(), 16), n_items)
    b = max(1 << (len(iq) - 1).bit_length(), 32)
    return b, k


class NCFAlgorithm(Algorithm):
    flavor = "P"
    params_class = NCFAlgorithmParams
    query_class = Query

    #: device wave width: bulk callers (batchpredict jobs, evaluation
    #: folds) are chunked to it, so the tower's activations stay
    #: [32, n_items, hidden] whatever the input size
    MAX_WAVE = 32

    def __init__(self, params: NCFAlgorithmParams | None = None):
        self.params = params or NCFAlgorithmParams()

    def _ncf_params(self) -> NCFParams:
        p = self.params
        return NCFParams(
            embed_dim=p.embed_dim,
            mlp_layers=tuple(p.mlp_layers),
            learning_rate=p.learning_rate,
            num_epochs=p.num_epochs,
            batch_size=p.batch_size,
            negatives_per_positive=p.negatives_per_positive,
            neg_power=p.neg_power,
            loss=p.loss,
            item_bias=p.item_bias,
            weight_decay=p.weight_decay,
            alpha=p.alpha,
            seed=p.seed,
        )

    def train(self, ctx: EngineContext, pd: PreparedData) -> NCFModel:
        p = self.params
        positives = pd.ratings >= p.positive_threshold
        if not positives.any():
            raise SanityCheckError(
                f"no positive interactions (rating >= {p.positive_threshold})"
            )
        # a previous generation's tables take precedence over re-running
        # the ALS pretrainer
        initial = self._warm_start_initial(ctx, pd)
        if initial is None and p.pretrain == "als":
            from predictionio_tpu_torch.ops.als import ALSParams, train_als

            als = train_als(
                pd.user_idx[positives],
                pd.item_idx[positives],
                np.ones(int(positives.sum()), np.float32),
                len(pd.user_vocab),
                len(pd.item_vocab),
                params=ALSParams(
                    rank=p.embed_dim, num_iterations=20, reg=0.01,
                    seed=p.seed, implicit_prefs=True, alpha=p.alpha,
                ),
                device=ctx.device,
            )
            initial = {"user_emb": als.user_factors, "item_emb": als.item_factors}
        state = train_ncf(
            pd.user_idx[positives],
            pd.item_idx[positives],
            n_users=len(pd.user_vocab),
            n_items=len(pd.item_vocab),
            params=self._ncf_params(),
            initial_params=initial,
            device=ctx.device,
        )
        return NCFModel(
            state=state, user_vocab=pd.user_vocab, item_vocab=pd.item_vocab
        )

    def _warm_start_initial(self, ctx: EngineContext, pd: PreparedData):
        """Previous-generation GMF (or packed) tables mapped through the
        old -> new vocab; None when absent or when the width no longer
        fits (a cold start is always safe)."""
        prev = find_warm_start(ctx, ("params", "user_vocab", "item_vocab"))
        if prev is None or not isinstance(prev.get("params"), dict):
            return None
        params = prev["params"]
        user_emb = params.get("user_emb")
        item_emb = params.get("item_emb")
        if user_emb is None or item_emb is None:
            return None
        d = self.params.embed_dim
        user_emb = np.asarray(user_emb)
        item_emb = np.asarray(item_emb)
        if user_emb.ndim != 2 or user_emb.shape[1] < d or item_emb.shape[1] < d:
            return None
        rng = np.random.default_rng(self.params.seed)
        return {
            # the GMF half packs first ([:, :d]), so slicing recovers it
            # from either a pure-GMF or a packed table
            "user_emb": align_warm_factors(
                user_emb[:, :d], BiMap.from_state(prev["user_vocab"]),
                pd.user_vocab, rng,
            ),
            "item_emb": align_warm_factors(
                item_emb[:, :d], BiMap.from_state(prev["item_vocab"]),
                pd.item_vocab, rng,
            ),
        }

    def predict(self, model: NCFModel, query: Query) -> PredictedResult:
        """Solo query from the host replica; repeat users take their row
        from the model's factor cache."""
        provenance.note(engine_path="ncf.host_replica")
        cache = device_cache.model_cache(model)
        hit = cache.get(query.user)
        if hit is None:
            with device_obs.wave_stage("host_gather"):
                uidx = model.user_vocab.get(query.user)
                if uidx is None:
                    provenance.note(unknown_entity=query.user)
                    return PredictedResult()
                uidx = int(uidx)
                ue = model.host_params["user_emb"][uidx].copy()
            cache.put(query.user, (uidx, ue))
        else:
            uidx, ue = hit
            device_obs.note_cache_hit()
        n_items = len(model.item_vocab)
        k = min(query.num, n_items)
        scores, items = _host_score_topk(
            model.host_params, uidx, n_items, k, ue=ue
        )
        return PredictedResult(
            item_scores=tuple(
                ItemScore(item=model.item_vocab.inverse(int(i)), score=float(s))
                for s, i in zip(scores, items)
                if np.isfinite(s)
            )
        )

    def batch_predict(self, model: NCFModel, indexed_queries):
        """Device waves of at most ``MAX_WAVE`` queries, one after another
        (queries with other ``num`` or unknown users are rendered per row
        after the shared top-k)."""
        iq = list(indexed_queries)
        out = []
        for c0 in range(0, len(iq), self.MAX_WAVE):
            chunk = iq[c0 : c0 + self.MAX_WAVE]
            if model.shards is not None:
                out.extend(self._sharded_wave(model, chunk))
            else:
                out.extend(self._dispatch_wave(model, chunk)())
        return out

    def _render_wave(self, model: NCFModel, iq, uidx, top_s, top_i):
        out = []
        for row, (i, q) in enumerate(iq):
            if uidx[row] < 0:
                out.append((i, PredictedResult()))
                continue
            out.append(
                (
                    i,
                    PredictedResult(
                        item_scores=tuple(
                            ItemScore(
                                item=model.item_vocab.inverse(int(ii)),
                                score=float(ss),
                            )
                            for ss, ii in zip(top_s[row][: q.num], top_i[row][: q.num])
                            if np.isfinite(ss)
                        )
                    ),
                )
            )
        return out

    def dispatch_batch(self, model: NCFModel, indexed_queries, force: bool = False):
        """The micro-batcher pipeline's async half: vocabulary gather, the
        power-of-two padding, the ids' upload and the wave's launch now,
        without blocking; the returned finalize fences on the wave's own
        event, reads the packed winners back and renders.  Declines (None)
        a wave past ``MAX_WAVE`` unless ``force`` (a failed device wave's
        retry), which runs it as ``batch_predict``'s chunks on the device.
        Declines every wave of a sharded model (the settle clock is
        synchronous: the batcher then runs ``batch_predict``)."""
        iq = list(indexed_queries)
        if model.shards is not None:
            return None
        if not iq:
            return lambda: []
        if len(iq) > self.MAX_WAVE:
            if not force:
                return None
            return lambda: self.batch_predict(model, iq)
        return self._dispatch_wave(model, iq)

    def _dispatch_wave(self, model: NCFModel, iq):
        provenance.note(engine_path="ncf.device_wave")
        n_items = _packable_n_items(model)
        params = model.state.params
        with device_obs.wave_stage("host_gather"):
            uidx = np.array(
                [model.user_vocab.get(q.user, -1) for _, q in iq], np.int64
            )
            b, k = _wave_shape(iq, n_items)
            padded = np.zeros(b, np.int64)
            padded[: len(iq)] = np.maximum(uidx, 0)
        table = params["user_emb"]
        shapes = (n_items,) + tuple(table.shape)
        # the launch shape (what a new shape costs): the padded b and k
        device_obs.default_recompiles().note_signature(
            "ncf.batch_predict", (b, k) + shapes)
        # the wave's work, which the cost is keyed on: its rows, not the
        # padding the menu adds
        sig = (len(iq), k) + shapes
        mlp = [tuple(layer["w"].shape) for layer in params["mlp"]]
        cost = ncf_wave_least_work(
            len(iq), n_items, int(table.shape[1]), mlp, k, "item_bias" in params
        )
        eff = device_obs.default_efficiency()
        eff.record_cost("ncf.batch_predict", cost["flops"], cost["bytes"],
                        signature=sig, source="least_work")

        def observe(kernel_s: float) -> None:
            device_obs.note_wave_device(device_obs.device_label(table))
            device_obs.note_wave_cost("ncf.batch_predict", cost)
            device_obs.note_wave_kernel(kernel_s)
            eff.observe("ncf.batch_predict", kernel_s, signature=sig)

        fence = dispatch_wave(
            padded, table.device,
            lambda ids, timing: score_topk_batch(params, ids, n_items, k, timing),
            observe,
        )

        def finalize():
            packed = fence()
            return self._render_wave(model, iq, uidx, packed[0],
                                     packed[1].astype(np.int64))

        return finalize

    # -- sharded serving (parallel.placement) --------------------------------

    def serving_shard_plan(self, model: NCFModel) -> ShardPlan | None:
        """Embedding tables (and the per-item bias) row-sharded over the
        ``model`` axis; the MLP head replicates.  Recorded in the persisted
        model and the generation manifest; a load onto several slots
        re-binds it."""
        if not self.params.shard_serving:
            return None
        sharded = ["user_emb", "item_emb"]
        ndims = {}
        if model.state.params.get("item_bias") is not None:
            sharded.append("item_bias")
            ndims["item_bias"] = 1
        return ShardPlan.model_parallel(
            sharded,
            rows={
                "user_emb": len(model.user_vocab),
                "item_emb": len(model.item_vocab),
                "item_bias": len(model.item_vocab),
            },
            ndims=ndims,
        )

    def _sharded_packed_topk(self, model: NCFModel, padded, n_items, k, b):
        """The sharded wave: the user rows gathered from their owning
        slots, then each slot's tower over ONLY the item rows it owns and
        the k-winner merge (no slot builds a [B, n_items] score row; the
        per-shard shapes are in ``placement.LAST_KERNEL_SHAPES
        ['ncf.sharded_topk']``)."""
        bound = model.shards
        sig = (b, k, n_items, bound.n_shards) + tuple(
            bound.arrays["user_emb"].shape
        )
        has_bias = bound.arrays.get("item_bias") is not None
        head = {
            n: bound.arrays[n]
            for n in ("mlp", "out_w", "out_b")
            if n in bound.arrays
        }

        def build():
            if has_bias:
                local = lambda item_emb, item_bias, h, q: (  # noqa: E731
                    score_users_vs_items(h, q, item_emb, item_bias)
                )
            else:
                local = lambda item_emb, h, q: (  # noqa: E731
                    score_users_vs_items(h, q, item_emb, None)
                )
            return build_sharded_topk(
                bound.mesh, local, n_items=n_items, k=k,
                name="ncf.sharded_topk",
            )

        kernel = bound.kernel((b, k), build)
        args = (bound.arrays["item_emb"],) + (
            (bound.arrays["item_bias"],) if has_bias else ()
        )

        def compute(users_dev):
            q_rows = gather_rows(
                bound.mesh, bound.arrays["user_emb"], users_dev
            )
            return kernel(*args, head, q_rows)

        hp = model.host_params
        cost = ncf_wave_least_work(
            b, n_items, int(bound.arrays["user_emb"].shape[1]),
            [tuple(layer["w"].shape) for layer in hp["mlp"]], k, has_bias,
        )
        return run_observed_wave(
            "ncf.sharded_topk",
            device=bound.mesh.merge_device,
            sig=sig,
            cost=cost,
            host_input=padded,
            compute=compute,
            shard_arrays={
                n: bound.arrays[n] for n in bound.plan.specs
                if bound.arrays.get(n) is not None
            },
        )

    def _sharded_wave(self, model: NCFModel, iq):
        """One wave of at most ``MAX_WAVE`` queries through the sharded
        top-k, padded to the same power-of-two menu as the device wave."""
        provenance.note(engine_path="ncf.sharded_topk")
        n_items = _packable_n_items(model)
        with device_obs.wave_stage("host_gather"):
            uidx = np.array(
                [model.user_vocab.get(q.user, -1) for _, q in iq], np.int32
            )
            b, k = _wave_shape(iq, n_items)
            padded = np.zeros(b, np.int32)
            padded[: len(iq)] = np.maximum(uidx, 0)
        packed = self._sharded_packed_topk(model, padded, n_items, k, b)
        return self._render_wave(model, iq, uidx, packed[0],
                                 packed[1].astype(np.int64))

    def make_persistent_model(self, ctx: EngineContext, model: NCFModel):
        out = {
            "params": model.host_params,
            "n_users": model.state.n_users,
            "n_items": model.state.n_items,
            "config": dataclasses.asdict(model.state.config),
            "user_vocab": model.user_vocab.to_state(),
            "item_vocab": model.item_vocab.to_state(),
        }
        plan = self.serving_shard_plan(model)
        if plan is not None:
            out["shard_plan"] = plan.to_dict()
        return out

    def load_persistent_model(self, ctx: EngineContext, data) -> NCFModel:
        params = data["params"]
        if "user_gmf" in params:
            # migrate pre-packed checkpoints (four [n, d] tables) into the
            # packed [n, 2d] layout so older saved models keep deploying
            params = {
                "user_emb": np.concatenate(
                    [params["user_gmf"], params["user_mlp"]], axis=1
                ),
                "item_emb": np.concatenate(
                    [params["item_gmf"], params["item_mlp"]], axis=1
                ),
                "mlp": params["mlp"],
                "out_w": params["out_w"],
                "out_b": params["out_b"],
            }
        config = data["config"]
        if isinstance(config, dict):
            config = NCFParams(**{**config,
                                  "mlp_layers": tuple(config["mlp_layers"])})
        host = tree_map(lambda x: np.ascontiguousarray(x, np.float32), params)
        plan = ShardPlan.from_dict(data.get("shard_plan"))
        slots = ctx.mesh_devices
        # a recorded plan binds onto several slots (the tables shard, the
        # MLP head replicates; ``state.params`` then stays on the host for
        # the solo path and sanity checks); one slot ignores it
        sharded = plan is not None and len(slots) > 1
        model = NCFModel(
            state=NCFState(
                params=tree_map(
                    lambda x: torch.tensor(
                        x, device="cpu" if sharded else ctx.device),
                    host,
                ),
                n_users=data["n_users"],
                n_items=data["n_items"],
                config=config,
            ),
            user_vocab=BiMap.from_state(data["user_vocab"]),
            item_vocab=BiMap.from_state(data["item_vocab"]),
        )
        model._host_params = host
        if sharded:
            model.shards = bind_shards(plan, host, devices=slots)
            meter_shards(
                "ncf.serving_tables",
                {n: model.shards.arrays[n] for n in plan.specs
                 if model.shards.arrays.get(n) is not None},
            )
        return model


@engine_factory("ncf")
def ncf_engine() -> Engine:
    return Engine(
        RatingsDataSource,
        RatingsPreparator,
        {"ncf": NCFAlgorithm},
        RecommendationServing,
    )
