"""Neural Collaborative Filtering (two-tower GMF + MLP) on one device.

The port of the JAX package's ``ops/ncf.py``: the same parameter tree, the
same forward, the same four losses and the same Adam/AdamW epoch, in eager
PyTorch on the tables' device (a card, or the CPU when asked).

- Parameters are a dict of tensors in the JAX package's layout: GMF and MLP
  embeddings PACKED in one ``[n, 2d]`` table per entity (columns ``[0:d]``
  the GMF half, ``[d:2d]`` the MLP half), the MLP as a list of ``{"w",
  "b"}``, ``out_w``/``out_b``, and an optional ``item_bias``.  With
  ``mlp_layers=()`` the head is pure GMF (``[n, d]`` tables and no
  ``out_w``), whose whole-catalog score is one matmul.
  :func:`params_from_jax` and :func:`host_params` carry a tree across.
- Losses: ``bpr`` and ``softmax`` over K negatives drawn in the step by
  inverse CDF; on the pure-GMF head, the whole-catalog ``full_softmax`` and
  ``wals`` (the implicit-ALS objective trained by SGD).
- Training: the positive stream is staged on the device once; each epoch
  permutes it and runs its steps (forward, loss, autograd, Adam or AdamW
  with optax's hyperparameters and dense moments for every table row).
  The permutation and every step's negatives come from one
  ``torch.Generator`` on the tables' device, seeded from ``p.seed``.  No
  step reads a value back to the host: an epoch's loss stays on the
  device until the train ends.

Nothing here is computed in Pallas in the JAX package, so nothing here is a
hand-written kernel: the tower, the losses, Adam and the wave's top-k are
torch ops.  The mesh paths (``param_shardings``, row-sharded tables) belong
to the multi-device slice.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.device import resolve_device

LOSSES = ("bpr", "softmax", "full_softmax", "wals")


@dataclass(frozen=True)
class NCFParams:
    embed_dim: int = 32
    mlp_layers: tuple[int, ...] = (64, 32, 16)
    learning_rate: float = 1e-3
    num_epochs: int = 5
    batch_size: int = 8192
    #: negatives per positive per step (BPR: independent pairwise terms;
    #: softmax: one (1+K)-way classification)
    negatives_per_positive: int = 1
    #: negative-sampling exponent over item train frequency: 0.0 uniform,
    #: 0.75 popularity-smoothed
    neg_power: float = 0.0
    #: "bpr" | "softmax" | "full_softmax" | "wals"; the whole-catalog
    #: losses need the pure-GMF head (mlp_layers=())
    loss: str = "bpr"
    #: learned per-item score offset
    item_bias: bool = True
    #: decoupled (AdamW) weight decay; 0 keeps plain Adam
    weight_decay: float = 0.0
    #: confidence weight on observed interactions for loss="wals"
    alpha: float = 2.0
    seed: int = 3

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(
                f"unknown loss {self.loss!r}; expected one of {LOSSES}"
            )


@dataclass
class NCFState:
    params: dict  # tensors on the training device, no autograd history
    n_users: int
    n_items: int
    config: NCFParams
    #: each epoch's mean step loss, read back once when the train ended
    epoch_losses: list[float] = field(default_factory=list)
    #: each epoch's seconds: on a card between CUDA events recorded at the
    #: epochs' ends (the device's timeline, idle gaps included), on the
    #: CPU on the host clock
    epoch_seconds: list[float] = field(default_factory=list)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_jax(tree: dict, device: torch.device | str | None = None) -> dict:
    """The JAX package's parameter tree (numpy leaves) as the port's
    float32 tensors on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return tree_map(
        lambda x: torch.tensor(np.asarray(x, np.float32), device=dev), tree
    )


def host_params(params: dict) -> dict:
    """The port's parameter tree as numpy, in the JAX package's layout."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)


def init_ncf(
    generator: torch.Generator, n_users: int, n_items: int, p: NCFParams
) -> dict:
    """A fresh parameter tree on the generator's device, drawn in the JAX
    package's scales: tables ``N(0, 1/d)``, ``out_w`` ``N(0, 0.01)``, He
    init for the MLP, zero biases."""
    dev = generator.device
    d = p.embed_dim
    scale = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    if not p.mlp_layers:
        # pure GMF: the whole embedding is the interaction vector;
        # discriminated downstream by the ABSENCE of "out_w"
        params = {
            "user_emb": normal(n_users, d) * scale,
            "item_emb": normal(n_items, d) * scale,
            "mlp": [],
            "out_b": zeros(1),
        }
    else:
        params = {
            "user_emb": normal(n_users, 2 * d) * scale,
            "item_emb": normal(n_items, 2 * d) * scale,
            "mlp": [],
            "out_w": normal(d + p.mlp_layers[-1], 1) * 0.1,
            "out_b": zeros(1),
        }
        in_dim = 2 * d
        for width in p.mlp_layers:
            params["mlp"].append(
                {"w": normal(in_dim, width) * math.sqrt(2.0 / in_dim),
                 "b": zeros(width)}
            )
            in_dim = width
    if p.item_bias:
        params["item_bias"] = zeros(n_items)
    return params


def _tower(head: dict, gmf: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    for layer in head["mlp"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    fused = torch.cat([gmf, h], dim=-1)
    return (fused @ head["out_w"] + head["out_b"])[..., 0]


def ncf_forward(params: dict, user_idx: torch.Tensor,
                item_idx: torch.Tensor) -> torch.Tensor:
    """Interaction scores for (user, item) pairs: [batch]."""
    ue = params["user_emb"][user_idx]
    ie = params["item_emb"][item_idx]
    if "out_w" not in params:  # pure GMF (mlp_layers=())
        score = (ue * ie).sum(-1) + params["out_b"][0]
    else:
        d = params["user_emb"].shape[1] // 2
        gmf = ue[:, :d] * ie[:, :d]
        h = torch.cat([ue[:, d:], ie[:, d:]], dim=-1)
        score = _tower(params, gmf, h)
    bias = params.get("item_bias")  # absent on pre-bias checkpoints
    if bias is not None:
        score = score + bias[item_idx]
    return score


def score_all_items(params: dict, user_idx: int) -> torch.Tensor:
    """One user against every item: [n_items] (a wave of one through
    :func:`score_users_vs_items`)."""
    return score_users_vs_items(
        params, params["user_emb"][user_idx][None], params["item_emb"],
        params.get("item_bias"),
    )[0]


def score_users_vs_items(
    head: dict, ue: torch.Tensor, item_emb: torch.Tensor, item_bias=None
) -> torch.Tensor:
    """``[B, 2d|d]`` user rows against an item-table block: ``[B, rows]``
    (the wave path and :func:`score_all_items` score with it).  ``head``
    carries ``mlp``/``out_w``/``out_b``; pure GMF is discriminated by the
    absence of ``out_w``."""
    if "out_w" not in head:  # pure GMF
        scores = ue @ item_emb.T + head["out_b"][0]
    else:
        d = ue.shape[-1] // 2
        b, rows = ue.shape[0], item_emb.shape[0]
        gmf = ue[:, None, :d] * item_emb[None, :, :d]  # [B, rows, d]
        h = torch.cat(
            [ue[:, None, d:].expand(b, rows, d),
             item_emb[None, :, d:].expand(b, rows, d)],
            dim=-1,
        )
        scores = _tower(head, gmf, h)
    if item_bias is not None:
        scores = scores + item_bias[None, :]
    return scores


def _mean_valid(losses: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    # the count clamps on the device: no host read inside a step
    return (losses * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _pos_neg(params, user_idx, pos_idx, neg_idx):
    b, k = neg_idx.shape
    pos = ncf_forward(params, user_idx, pos_idx)  # [b]
    neg = ncf_forward(
        params, user_idx.repeat_interleave(k), neg_idx.reshape(-1)
    ).reshape(b, k)
    return pos, neg


def bpr_loss(params: dict, user_idx, pos_idx, neg_idx, valid) -> torch.Tensor:
    """Bayesian Personalized Ranking over K negatives: mean over pairs of
    -log sigmoid(s_pos - s_neg).  ``neg_idx`` is [b, K]."""
    pos, neg = _pos_neg(params, user_idx, pos_idx, neg_idx)
    return _mean_valid(-F.logsigmoid(pos[:, None] - neg).mean(dim=1), valid)


def sampled_softmax_loss(params: dict, user_idx, pos_idx, neg_idx, valid):
    """(1+K)-way sampled softmax: the positive against all K sampled
    negatives jointly.  ``neg_idx`` is [b, K]."""
    pos, neg = _pos_neg(params, user_idx, pos_idx, neg_idx)
    logits = torch.cat([pos[:, None], neg], dim=1)  # [b, 1+K]
    return _mean_valid(-torch.log_softmax(logits, dim=1)[:, 0], valid)


def _catalog_logits(params: dict, user_idx) -> torch.Tensor:
    logits = params["user_emb"][user_idx] @ params["item_emb"].T
    bias = params.get("item_bias")
    if bias is not None:
        logits = logits + bias[None, :]
    return logits


def full_softmax_loss(params: dict, user_idx, pos_idx, valid,
                      n_items: int | None = None):
    """Exact softmax cross-entropy over the WHOLE catalog per positive; the
    logits are one [b, d] @ [d, n_items] matmul.  Needs the pure-GMF head;
    table rows at or past ``n_items`` take no part."""
    if "out_w" in params:
        raise ValueError(
            "full_softmax needs the pure-GMF head: set mlp_layers=()"
        )
    logits = _catalog_logits(params, user_idx)
    if n_items is not None and n_items < logits.shape[1]:
        keep = torch.arange(logits.shape[1], device=logits.device) < n_items
        logits = torch.where(keep[None, :], logits, float("-inf"))
    logp = torch.log_softmax(logits, dim=1)
    picked = torch.gather(logp, 1, pos_idx[:, None].long())[:, 0]
    return _mean_valid(-picked, valid)


def wals_loss(params: dict, user_idx, pos_idx, valid, inv_count,
              alpha: float, n_items: int):
    """The implicit-ALS objective as a stream loss:

        L = sum_u [ sum_{i in P_u} ((1+a)(1 - s_ui)^2 - s_ui^2)
                    + sum_{j in catalog} s_uj^2 ]  (+ L2 via AdamW decay)

    each (u, i) row carries its user's whole-catalog term scaled by
    ``inv_count = 1/|P_u|``.  Needs the pure-GMF head."""
    if "out_w" in params:
        raise ValueError("wals needs the pure-GMF head: set mlp_layers=()")
    s = _catalog_logits(params, user_idx)
    mask = (torch.arange(s.shape[1], device=s.device) < n_items).to(s.dtype)
    s = s * mask[None, :]
    s_pos = torch.gather(s, 1, pos_idx[:, None].long())[:, 0]
    per_row = (
        (1.0 + alpha) * (1.0 - s_pos) ** 2
        - s_pos**2
        + inv_count * (s * s).sum(dim=1)
    )
    return _mean_valid(per_row, valid)


_SAMPLED_LOSSES = {"bpr": bpr_loss, "softmax": sampled_softmax_loss}


def make_optimizer(params: dict, p: NCFParams) -> torch.optim.Optimizer:
    """optax's ``adam(lr)``, or ``adamw(lr, weight_decay)`` when
    ``weight_decay > 0`` (every leaf decayed, biases included): b1 0.9, b2
    0.999, eps 1e-8, dense moments over every table row.  Every leaf holds
    a zero gradient from the start, so a leaf the loss does not reach (the
    pure-GMF head's ``out_b`` under the whole-catalog losses) still steps
    and decays, as optax updates every leaf."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.grad = torch.zeros_like(leaf)
    if p.weight_decay > 0.0:
        return torch.optim.AdamW(
            leaves, lr=p.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=p.weight_decay,
        )
    return torch.optim.Adam(
        leaves, lr=p.learning_rate, betas=(0.9, 0.999), eps=1e-8
    )


def train_step(
    params: dict,
    optimizer: torch.optim.Optimizer,
    u: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor | None,
    valid: torch.Tensor,
    w: torch.Tensor,
    p: NCFParams,
    n_items: int,
) -> torch.Tensor:
    """One optimization step on one batch: the loss of ``p.loss`` (``neg``
    [b, K] for the sampled losses, ``w`` the wals ``1/|P_u|`` weights),
    its gradient by autograd, one optimizer update of every leaf.  Returns
    the step's loss before the update, a detached 0-d tensor on the
    device."""
    if p.loss == "wals":
        loss = wals_loss(params, u, pos, valid, w, p.alpha, n_items)
    elif p.loss == "full_softmax":
        loss = full_softmax_loss(params, u, pos, valid, n_items)
    else:
        loss = _SAMPLED_LOSSES[p.loss](params, u, pos, neg, valid)
    optimizer.zero_grad(set_to_none=False)
    loss.backward()
    optimizer.step()
    return loss.detach()


def sample_negatives(neg_cdf: torch.Tensor, batch: int, k: int, n_items: int,
                     generator: torch.Generator) -> torch.Tensor:
    """K negatives per row by inverse CDF: a left-sided search of uniform
    draws, clamped to the last real item (the float32 CDF's last entry can
    fall below 1.0)."""
    draws = torch.rand(
        (batch, k), generator=generator, device=neg_cdf.device
    )
    return torch.searchsorted(neg_cdf, draws).clamp_(max=n_items - 1)


@dataclass
class Stream:
    """The positive stream staged on the device, padded to whole steps."""

    u: torch.Tensor      # int64 [n_steps * batch]
    i: torch.Tensor      # int64
    valid: torch.Tensor  # float32, 0 on padding
    w: torch.Tensor      # float32, the wals 1/|P_u| weights (else 0)
    n_steps: int
    batch: int


def stage_stream(user_idx: np.ndarray, item_idx: np.ndarray, p: NCFParams,
                 device: torch.device) -> Stream:
    """Pad the positives to ``n_steps * batch`` rows (``valid`` masks the
    padding) and upload them once."""
    n_pos = len(user_idx)
    bs = min(p.batch_size, max(n_pos, 1))
    n_steps = max((n_pos + bs - 1) // bs, 1)
    total = n_steps * bs
    u_all = np.zeros(total, np.int64)
    i_all = np.zeros(total, np.int64)
    valid_all = np.zeros(total, np.float32)
    w_all = np.zeros(total, np.float32)
    u_all[:n_pos] = user_idx
    i_all[:n_pos] = item_idx
    valid_all[:n_pos] = 1.0
    if p.loss == "wals" and n_pos:
        # each stream row carries its user's whole-catalog term scaled by
        # 1/|P_u| so it enters the objective exactly once per epoch
        ucount = np.bincount(np.asarray(user_idx, np.int64))
        w_all[:n_pos] = 1.0 / ucount[np.asarray(user_idx, np.int64)]
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return Stream(put(u_all), put(i_all), put(valid_all), put(w_all),
                  n_steps, bs)


def train_epoch(
    params: dict,
    optimizer: torch.optim.Optimizer,
    stream: Stream,
    p: NCFParams,
    n_items: int,
    generator: torch.Generator | None = None,
    neg_cdf: torch.Tensor | None = None,
    perm: torch.Tensor | None = None,
    negatives: Callable[[int], torch.Tensor] | None = None,
) -> torch.Tensor:
    """One epoch: the stream in permuted order, ``stream.n_steps`` steps.
    The permutation and each step's negatives are drawn from
    ``generator`` (over ``neg_cdf``) unless given: ``perm`` a permutation
    of the padded stream, ``negatives(step)`` the step's [batch, K] ids.
    Returns the mean step loss, a 0-d tensor on the device."""
    if perm is None:
        perm = torch.randperm(
            stream.u.shape[0], generator=generator, device=stream.u.device
        )
    us, ps, vs, ws = (
        x[perm].view(stream.n_steps, stream.batch)
        for x in (stream.u, stream.i, stream.valid, stream.w)
    )
    k_neg = max(p.negatives_per_positive, 1)
    total = torch.zeros((), device=stream.u.device)
    for s in range(stream.n_steps):
        neg = None
        if p.loss in _SAMPLED_LOSSES:
            neg = (
                negatives(s) if negatives is not None
                else sample_negatives(neg_cdf, stream.batch, k_neg, n_items,
                                      generator)
            )
        total = total + train_step(
            params, optimizer, us[s], ps[s], neg, vs[s], ws[s], p, n_items
        )
    return total / stream.n_steps


def _overlay(net: dict, initial_params: dict) -> dict:
    """Provided leaves over the fresh init; a shorter table fills the
    leading rows.  An unknown leaf or a shape that does not fit raises:
    a silently dropped leaf would train from random init."""
    unknown = set(initial_params) - set(net)
    if unknown:
        raise ValueError(
            f"initial_params keys {sorted(unknown)} not in the model "
            f"(have {sorted(net)})"
        )

    def overlay(name, fresh):
        given = initial_params.get(name)
        if given is None:
            return fresh
        if not isinstance(given, torch.Tensor):
            given = torch.from_numpy(np.asarray(given))
        given = given.detach().to(device=fresh.device, dtype=fresh.dtype)
        if given.shape == fresh.shape:
            return given.clone()
        if (given.ndim == 2 and given.shape[1] == fresh.shape[1]) or given.ndim == 1:
            out = fresh.clone()
            out[: given.shape[0]] = given
            return out
        raise ValueError(
            f"initial_params[{name!r}] shape {tuple(given.shape)} does not "
            f"fit table shape {tuple(fresh.shape)}"
        )

    return {k: overlay(k, v) if k != "mlp" else v for k, v in net.items()}


def train_ncf(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_users: int,
    n_items: int,
    params: NCFParams | None = None,
    initial_params: dict | None = None,
    device: torch.device | str | None = None,
) -> NCFState:
    """Train from positive (user, item) interactions on ``device``
    (``None`` means CUDA, and raises without a card unless
    ``device="cpu"``).

    The init is drawn on the host from a generator seeded with ``p.seed``
    (so a CPU and a CUDA train start from the same tables), then overlaid
    with ``initial_params`` (numpy arrays or tensors; the pretrain-GMF
    recipe).  The epochs draw from a generator on ``device``, seeded with
    ``p.seed``.  The train ends with one read of the epochs' losses, which
    also waits for the card."""
    p = params or NCFParams()
    dev = resolve_device(device)
    g_init = torch.Generator(device="cpu")
    g_init.manual_seed(p.seed)
    net = tree_map(lambda x: x.to(dev), init_ncf(g_init, n_users, n_items, p))
    if initial_params is not None:
        net = _overlay(net, initial_params)
    for leaf in tree_leaves(net):
        leaf.requires_grad_(True)
    optimizer = make_optimizer(net, p)
    stream = stage_stream(user_idx, item_idx, p, dev)
    neg_cdf = torch.from_numpy(
        negative_sampling_cdf(item_idx, n_items, p.neg_power)
    ).to(dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(p.seed)
    marks = [_mark(dev)]
    losses = []
    for _ in range(p.num_epochs):
        losses.append(
            train_epoch(net, optimizer, stream, p, n_items, generator, neg_cdf)
        )
        marks.append(_mark(dev))
    epoch_losses = torch.stack(losses).tolist() if losses else []
    return NCFState(
        params=tree_map(lambda x: x.detach(), net),
        n_users=n_users,
        n_items=n_items,
        config=p,
        epoch_losses=epoch_losses,
        epoch_seconds=[_elapsed_s(a, b) for a, b in zip(marks, marks[1:])],
    )


def _mark(device: torch.device):
    """A point on the device's timeline: a recorded CUDA event (no wait),
    or the host clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_s(a, b) -> float:
    """Seconds between two marks (events that have completed)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def negative_sampling_cdf(
    item_idx: np.ndarray, n_items: int, neg_power: float
) -> np.ndarray:
    """Inverse-CDF table for in-step negative sampling: uniform over
    [0, n_items) when ``neg_power == 0``, else P(i) ∝ count(i)^neg_power
    (zero-count items never drawn)."""
    if neg_power > 0:
        counts = np.bincount(
            np.asarray(item_idx, np.int64), minlength=n_items
        ).astype(np.float64)[:n_items]
        w = counts**neg_power
        if w.sum() <= 0:
            w = np.ones(n_items)
    else:
        w = np.ones(n_items)
    return (np.cumsum(w) / w.sum()).astype(np.float32)


def ncf_wave_least_work(
    batch: int, n_items: int, table_width: int, mlp: Sequence[tuple[int, int]],
    k: int, item_bias: bool,
) -> dict[str, float]:
    """The least work of one scored wave (``batch`` users against the
    catalog, then the top ``k``): each input read once (the user rows, the
    item table, the head's weights, the bias), the packed [2, batch, k]
    result written once, and the tower's flops for every (user, item)
    pair.  ``mlp`` lists each layer's (in, out); empty for pure GMF, whose
    pair costs one dot of ``table_width``."""
    pairs = float(batch) * n_items
    if not mlp:
        pair_flops = 2.0 * table_width + 1.0
        weights = 1
    else:
        d = table_width // 2
        pair_flops = float(d)  # the GMF product
        weights = 1
        for fan_in, fan_out in mlp:
            pair_flops += 2.0 * fan_in * fan_out + 2.0 * fan_out
            weights += fan_in * fan_out + fan_out
        last = mlp[-1][1]
        pair_flops += 2.0 * (d + last) + 1.0
        weights += d + last
    if item_bias:
        pair_flops += 1.0
    return {
        "flops": pairs * pair_flops,
        "bytes": 4.0 * (
            batch * table_width + n_items * table_width + weights
            + (n_items if item_bias else 0) + 2 * batch * k
        ),
    }
