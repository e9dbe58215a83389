"""NCF training at a public batch: the program's ``ops.ncf.train_epoch``
(the function ``train_ncf`` runs once an epoch) again and again, on the
positive stream the program's ``stage_stream`` put on the device in
set-up, with the program's ``make_optimizer``.  The weights are the
benchmark's, drawn on the device from the seed; each epoch's permutation
and its negatives (uniform over the catalog, the configuration's count per
positive) are drawn by the benchmark on the device and handed to the call.

Set-up runs the first three steps through that same call and object, one
step a call, on the first rows of a drawn permutation (rows that all
differ), and keeps what the check compares: each step's loss, the norm of
the first gradient as Adam got it (its first moment over ``1 - beta1``)
and the norm of each leaf's change after the three.  The window then goes
on from step 4.  The check runs the plain reference from the same start
over the same rows in float64.
"""

from __future__ import annotations

import time

import torch

from portbench import compare, data, weights
from portbench.reference import ncf as ref_ncf

#: steps run and compared in set-up
CHECK_STEPS = 3
BETA1 = 0.9


def _ncf_params(cfg: dict):
    from predictionio_tpu_torch.ops.ncf import NCFParams

    return NCFParams(
        embed_dim=cfg["embed_dim"], mlp_layers=tuple(cfg["mlp_layers"]),
        learning_rate=cfg["learning_rate"], batch_size=cfg["batch_size"],
        negatives_per_positive=cfg["negatives_per_positive"],
        loss=cfg["loss"], item_bias=cfg["item_bias"], seed=cfg["seed"],
    )


def positives(cfg: dict, seed: int, dev) -> tuple:
    """The positive (user, item) pairs of the seed's ratings, on ``dev``."""
    u, i, r = data.movielens_like(cfg["ratings"], cfg["users"], cfg["items"],
                                  seed, dev, cfg["data_seed"])
    keep = r >= cfg["positive_threshold"]
    return u[keep], i[keep]


def _draws(state: dict, steps: int):
    """A permutation of the padded stream and ``steps`` steps' negatives."""
    st, g = state["stream"], state["g"]
    perm = torch.randperm(st.u.shape[0], generator=g, device=st.u.device)
    neg = torch.randint(0, state["cfg"]["items"],
                        (steps, st.batch, state["p"].negatives_per_positive),
                        generator=g, device=st.u.device)
    return perm, neg


def setup(cell, seed: int, device) -> dict:
    from predictionio_tpu_torch.ops import ncf

    cfg = cell.config
    dev = torch.device(device)
    pu, pi = positives(cfg, seed, dev)
    p = _ncf_params(cfg)
    stream = ncf.stage_stream(pu.cpu().numpy(), pi.cpu().numpy(), p, dev)
    tree = weights.make_tree(data.generator(seed, dev), cfg["users"],
                             cfg["items"], cfg["embed_dim"], cfg["mlp_layers"],
                             served=False)
    leaves = weights.named_leaves(tree)
    start = {n: x.detach().cpu().clone() for n, x in leaves.items()}
    for x in leaves.values():
        x.requires_grad_(True)
    opt = ncf.make_optimizer(tree, p)
    state = {"cfg": cfg, "p": p, "device": dev, "stream": stream,
             "positives": (pu, pi), "tree": tree, "opt": opt,
             "start": start, "g": data.generator(seed + 1, dev)}
    perm, neg = _draws(state, CHECK_STEPS)
    rows = perm[:CHECK_STEPS * stream.batch].view(CHECK_STEPS, stream.batch)
    ident = torch.arange(stream.batch, device=dev)
    losses = []
    for s in range(CHECK_STEPS):
        sub = ncf.Stream(stream.u[rows[s]], stream.i[rows[s]],
                         stream.valid[rows[s]], stream.w[rows[s]], 1,
                         stream.batch)
        losses.append(ncf.train_epoch(tree, opt, sub, p, cfg["items"],
                                      perm=ident, negatives=lambda _, s=s: neg[s]))
        if s == 0:
            first = compare.leaf_norms({
                n: opt.state[x]["exp_avg"] / (1 - BETA1)
                for n, x in leaves.items()})
    change = {n: float(torch.linalg.vector_norm(
        x.detach().double() - start[n].to(dev).double()))
        for n, x in leaves.items()}
    state["got"] = {"losses": [float(x) for x in losses], "first_grad": first,
                    "change": change}
    state["check_rows"] = (rows.cpu(), neg.cpu())
    return state


def window(state: dict, seconds: float, traced: bool) -> dict:
    from predictionio_tpu_torch.ops import ncf

    st, p, cfg = state["stream"], state["p"], state["cfg"]
    t0 = time.perf_counter()
    epochs = 0
    while True:
        perm, neg = _draws(state, st.n_steps)
        ncf.train_epoch(state["tree"], state["opt"], st, p, cfg["items"],
                        perm=perm, negatives=neg.__getitem__)
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if state["device"].type == "cuda":
        torch.cuda.synchronize()
    return {
        "window_s": time.perf_counter() - t0,
        "attempted": epochs * st.n_steps, "failed": 0,
        "steps": epochs * st.n_steps, "epochs": epochs,
        "positives": epochs * len(state["positives"][0]),
        "batch": st.batch, "negatives_per_positive": p.negatives_per_positive,
        "table_width": 2 * cfg["embed_dim"],
        "mlp": weights.mlp_dims(cfg), "item_bias": cfg["item_bias"],
    }


def batches(state: dict, dtype=torch.float64, half: bool = False) -> list:
    """The check's steps as the reference takes them: each row of the
    padded positive stream worked out again from the positives (rows past
    them are padding, valid 0)."""
    dev = state["device"]
    pu, pi = (x.to(torch.int64) for x in state["positives"])
    rows, neg = (x.to(dev) for x in state["check_rows"])
    out = []
    for s in range(rows.shape[0]):
        r = rows[s]
        real = r < len(pu)
        idx = torch.where(real, r, 0)
        valid = real.to(dtype)
        if half:
            valid = valid * (torch.arange(len(r), device=dev) % 2 == 0)
        out.append((torch.where(real, pu[idx], 0), torch.where(real, pi[idx], 0),
                    neg[s], valid))
    return out


def reference_readings(state: dict, dtype=torch.float64, tf32: bool = False,
                       half: bool = False) -> dict:
    """The reference's losses, first gradient's leaf norms and the leaf
    norms of the change after the check's steps, in ``dtype``."""
    dev = state["device"]
    start = {n: x.to(dev, dtype) for n, x in state["start"].items()}
    with ref_ncf.matmul_precision(tf32):
        losses, first, after = ref_ncf.adam_steps(
            start, batches(state, dtype, half), state["cfg"]["learning_rate"])
    return {"losses": losses, "first_grad": compare.leaf_norms(first),
            "change": compare.leaf_norms(
                {n: after[n] - start[n] for n in start})}


def readings(got: dict, ref: dict) -> dict:
    """``loss_gap``: the widest step's loss gap over the reference's loss;
    ``grad_gap`` and ``change_gap``: the worst leaf's gap of norms (see
    ``compare.norm_gaps``).  The change leaves out a leaf whose reference
    gradient is under a thousandth of the median leaf's: round-off alone
    moves it under Adam."""
    fg = ref["first_grad"]
    med = sorted(fg.values())[len(fg) // 2]
    moved = {n for n, v in fg.items() if v >= 1e-3 * med}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": compare.norm_gaps(got["first_grad"], fg),
        "change_gap": compare.norm_gaps(got["change"], ref["change"], moved),
    }


def leaf_gaps(got: dict, ref: dict) -> dict:
    """Each leaf's gap of the first gradient's norm and of the change's
    norm, as ``readings`` takes their worst."""
    out = {}
    for key in ("first_grad", "change"):
        r = ref[key]
        med = sorted(r.values())[len(r) // 2]
        out[key] = {n: abs(got[key][n] - r[n]) / max(r[n], med, 1e-300)
                    for n in r}
    return out


def _free(state: dict) -> None:
    for key in ("tree", "opt", "stream"):
        state.pop(key, None)
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()


def check(state: dict) -> list[dict]:
    _free(state)
    gaps = readings(state["got"], reference_readings(state))
    limits = state["cfg"]["limits"]["ncf_train"]
    return [{"name": n, "value": v, "limit": limits[n]} for n, v in gaps.items()]


def controls(state: dict) -> dict:
    """Readings of the program, the reference in TF32 (the control), and
    a planted fault (half of each batch left out, the mean over the rest),
    all against the float64 reference; a state left unchanged reads 1 on
    ``change_gap`` by its definition."""
    _free(state)
    ref = reference_readings(state)
    low = reference_readings(state, torch.float32, tf32=True)
    return {
        "program": readings(state["got"], ref),
        "program_leaves": leaf_gaps(state["got"], ref),
        "control_tf32": readings(low, ref),
        "control_tf32_leaves": leaf_gaps(low, ref),
        "fault_half_batch": readings(reference_readings(state, half=True), ref),
        "fault_unchanged": readings(
            {**state["got"], "change": {n: 0.0 for n in ref["change"]}}, ref),
    }
