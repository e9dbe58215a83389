"""ALS training, as a ``pio eval`` sweep retrains one fold: the program's
``ops.als.train_als`` called again and again on the ratings that set-up
staged, with the configuration's parameters.

Set-up draws the ratings on the device from the seed, copies them to the
host as the program takes them, and makes one whole train (the staging,
kernel 1's build, every shape).  The window counts iterations.  The check
holds the last train's factors against the plain ALS-WR reference, run in
float64 from the same start over the same ratings.
"""

from __future__ import annotations

import time

import torch

from portbench import compare, data
from portbench.reference import als as ref_als


def _params(cfg: dict, precision: str = "hilo"):
    from predictionio_tpu_torch.ops.als import ALSParams

    return ALSParams(
        rank=cfg["rank"], num_iterations=cfg["numIterations"],
        reg=cfg["lambda"], implicit_prefs=cfg["implicitPrefs"],
        seed=cfg["seed"], pallas_mode=cfg["mode"], pallas_precision=precision,
    )


def _train(state: dict, precision: str = "hilo"):
    from predictionio_tpu_torch.ops.als import train_als

    cfg = state["cfg"]
    return train_als(*state["host"], cfg["users"], cfg["items"],
                     params=_params(cfg, precision), device=state["device"])


def setup(cell, seed: int, device) -> dict:
    cfg = cell.config
    dev = torch.device(device)
    ratings = data.movielens_like(cfg["ratings"], cfg["users"], cfg["items"],
                                  seed, dev, cfg["data_seed"])
    state = {"cfg": cfg, "device": dev, "ratings": ratings,
             "host": tuple(x.cpu().numpy() for x in ratings)}
    state["out"] = _train(state)
    return state


def window(state: dict, seconds: float, traced: bool) -> dict:
    from predictionio_tpu_torch.ops import als_accum

    cfg = state["cfg"]
    launches = als_accum.KERNEL_LAUNCHES["als_fused_accum"]
    t0 = time.perf_counter()
    calls = 0
    while True:
        state["out"] = _train(state)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if state["device"].type == "cuda":
        torch.cuda.synchronize()
    return {
        "window_s": time.perf_counter() - t0, "attempted": calls, "failed": 0,
        "iterations": calls * cfg["numIterations"],
        "kernel_launches": als_accum.KERNEL_LAUNCHES["als_fused_accum"] - launches,
        "nnz": cfg["ratings"], "users": cfg["users"], "items": cfg["items"],
        "rank": cfg["rank"],
    }


def _reference(state: dict, ratings=None, dtype=torch.float64):
    cfg = state["cfg"]
    u, i, r = ratings or state["ratings"]
    return ref_als.train(u, i, r, cfg["users"], cfg["items"], cfg["rank"],
                         cfg["numIterations"], cfg["lambda"], cfg["seed"],
                         dtype)


def _factors(out) -> tuple:
    return (out.user_factors, out.item_factors)


def check(state: dict) -> list[dict]:
    got = _factors(state.pop("out"))
    del state["host"]
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    gaps = compare.factor_gaps(got, _reference(state))
    limits = state["cfg"]["limits"]["als_train"]
    return [{"name": n, "value": v, "limit": limits[n]} for n, v in gaps.items()]


def controls(state: dict) -> dict:
    """Readings of the program, its bf16 accumulation (the control), and
    two planted faults, all against the float64 reference: the start
    returned unchanged, and every other rating left out."""
    ref = _reference(state)
    cfg = state["cfg"]
    start = tuple(x.to(state["device"]) for x in ref_als.init_factors(
        cfg["users"], cfg["items"], cfg["rank"], cfg["seed"]))
    half = tuple(x[::2] for x in state["ratings"])
    return {
        "program": compare.factor_gaps(_factors(state["out"]), ref),
        "control_bf16": compare.factor_gaps(_factors(_train(state, "bf16")), ref),
        "fault_unchanged": compare.factor_gaps(start, ref),
        "fault_half_batch": compare.factor_gaps(_reference(state, half), ref),
    }
