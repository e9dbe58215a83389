"""``pio batchpredict`` of a user base through the NCF engine: the program's
``NCFAlgorithm.batch_predict`` on an ``NCFModel`` bound in set-up, the call
``core/batch_predict.run_batch_predict`` makes, over files of queries.

The weights are the benchmark's, drawn on the device from the seed.  The
queries are every user once in a seeded order, each asking for the
traffic's ``num`` items, cut into files of ``queries_per_file``; the
window answers one file a call, round after round.  Every seed gives the
same sizes: only the order of the users differs.

From each file a seeded sample of positions is kept as answered, over the
whole window; the check scores those users against every item with the
plain reference in float64 and holds the answers to it.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from portbench import compare, data, weights
from portbench.reference import ncf as ref_ncf


def _model(cfg: dict, tree: dict):
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models.ncf.engine import (
        NCFAlgorithm, NCFAlgorithmParams, NCFModel)
    from predictionio_tpu_torch.ops.ncf import NCFState

    algo = NCFAlgorithm(NCFAlgorithmParams(
        embed_dim=cfg["embed_dim"], mlp_layers=tuple(cfg["mlp_layers"]),
        learning_rate=cfg["learning_rate"], batch_size=cfg["batch_size"],
        positive_threshold=cfg["positive_threshold"],
        negatives_per_positive=cfg["negatives_per_positive"],
        loss=cfg["loss"], item_bias=cfg["item_bias"], seed=cfg["seed"]))
    state = NCFState(params=tree, n_users=cfg["users"], n_items=cfg["items"],
                     config=algo._ncf_params())
    model = NCFModel(
        state=state,
        user_vocab=BiMap.from_keys(str(u) for u in range(cfg["users"])),
        item_vocab=BiMap.from_keys(str(i) for i in range(cfg["items"])))
    return algo, model


def setup(cell, seed: int, device) -> dict:
    from predictionio_tpu_torch.models.recommendation.engine import Query

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    g = data.generator(seed, dev)
    tree = weights.make_tree(g, cfg["users"], cfg["items"], cfg["embed_dim"],
                             cfg["mlp_layers"], served=True)
    order = torch.randperm(cfg["users"], generator=g, device=dev).tolist()
    per = tr["queries_per_file"]
    # a file is its users' ids; its queries are read when its job runs
    files = [[str(u) for u in order[lo:lo + per]]
             for lo in range(0, len(order), per)]
    rng = np.random.default_rng(seed % (1 << 63))
    sample = [np.sort(rng.choice(len(f), min(tr["sampled_per_file"], len(f)),
                                 replace=False)) for f in files]
    algo, model = _model(cfg, tree)
    state = {"cfg": cfg, "traffic": tr, "device": dev, "tree": tree,
             "algo": algo, "model": model, "files": files, "sample": sample,
             "query": Query}
    # every launch shape the window uses: one wave of the engine's width
    algo.batch_predict(model, queries(state, 0)[:algo.MAX_WAVE])
    return state


def queries(state: dict, f: int) -> list:
    """File ``f``'s indexed queries, as a batch job reads them."""
    query, num = state["query"], state["traffic"]["num"]
    return [(j, query(user=u, num=num)) for j, u in enumerate(state["files"][f])]


def window(state: dict, seconds: float, traced: bool) -> dict:
    from predictionio_tpu_torch.obs import device as device_obs

    algo, model, files = state["algo"], state["model"], state["files"]
    sample, kept = state["sample"], []
    answered = waves = calls = 0
    t0 = time.perf_counter()
    with device_obs.wave_timeline() if traced else nullcontext() as tl:
        while True:
            f = calls % len(files)
            answers = algo.batch_predict(model, queries(state, f))
            kept.extend((files[f][j], answers[j][1]) for j in sample[f])
            answered += len(files[f])
            waves += -(-len(files[f]) // algo.MAX_WAVE)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
    if state["device"].type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    state["kept"] = kept
    cfg = state["cfg"]
    stats = {
        "window_s": window_s, "attempted": answered, "failed": 0,
        "queries": answered, "waves": waves, "wave_queries": algo.MAX_WAVE,
        "items": cfg["items"], "table_width": 2 * cfg["embed_dim"],
        "mlp": weights.mlp_dims(cfg), "item_bias": cfg["item_bias"],
        "k": state["traffic"]["num"],
    }
    if tl is not None:
        stats["wave_device_s"] = tl.kernel_s
    return stats


def _answers(kept: list, k: int, dev):
    """(users, items, scores) of the kept answers as tensors; an answer
    short of ``k`` items reads as repeats of its first, which the check
    fails."""
    users, items, scores = [], [], []
    for user, result in kept:
        pairs = [(int(s.item), s.score) for s in result.item_scores][:k]
        pairs += [pairs[0] if pairs else (0, 0.0)] * (k - len(pairs))
        users.append(int(user))
        items.append([p[0] for p in pairs])
        scores.append([p[1] for p in pairs])
    t = lambda x, dt: torch.tensor(x, dtype=dt, device=dev)  # noqa: E731
    return t(users, torch.int64), t(items, torch.int64), t(scores, torch.float64)


def _reference_scores(state: dict, users, dtype=torch.float64, tf32=False):
    dev = state["device"]
    params = {n: x.detach().to(dev, dtype)
              for n, x in weights.named_leaves(state["tree"]).items()}
    with torch.no_grad(), ref_ncf.matmul_precision(tf32):
        return ref_ncf.score_users(params, users)


def check(state: dict) -> list[dict]:
    for key in ("algo", "model"):
        state.pop(key)
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    users, items, scores = _answers(state["kept"], state["traffic"]["num"],
                                    state["device"])
    gaps = compare.topk_gaps(users, items, scores,
                             _reference_scores(state, users))
    limits = state["cfg"]["limits"]["ncf_batch"]
    return [{"name": n, "value": v, "limit": limits[n]} for n, v in gaps.items()]


def controls(state: dict) -> dict:
    """Readings of the program's answers to one file, of the reference in
    TF32 (the control) answering the same users, and of a planted fault
    (the program's answers with each first item swapped for the reference's
    (k+1)-th best), all against the float64 reference."""
    algo, model, files = state["algo"], state["model"], state["files"]
    k = state["traffic"]["num"]
    answers = algo.batch_predict(model, queries(state, 0))
    kept = [(u, a[1]) for u, a in zip(files[0], answers)]
    users, items, scores = _answers(kept, k, state["device"])
    ref = _reference_scores(state, users)
    low = _reference_scores(state, users, torch.float32, tf32=True)
    low_s, low_i = torch.sort(low, dim=1, descending=True, stable=True)
    altered = items.clone()
    altered[:, 0] = torch.sort(ref, dim=1, descending=True).indices[:, k]
    return {
        "program": compare.topk_gaps(users, items, scores, ref),
        "control_tf32": compare.topk_gaps(users, low_i[:, :k], low_s[:, :k], ref),
        "fault_altered": compare.topk_gaps(users, altered, scores, ref),
    }
