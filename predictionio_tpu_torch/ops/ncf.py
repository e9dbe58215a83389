"""Neural Collaborative Filtering (two-tower GMF + MLP), on one device or
over a mesh.

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

- Over a mesh (``train_ncf(mesh=)``, JAX ``param_shardings`` and the
  GSPMD epoch): the tables are padded to a multiple of the ``model`` axis
  and row-split over it, their Adam moments with them, every other leaf
  replicated (:func:`param_shardings`, :class:`MeshNCF`); each batch is
  split over ``data``.  Each data position's slot gathers the rows its
  share reads (the whole-catalog losses: every item block), computes its
  loss terms over the whole batch's valid count and their gradients on
  the slot's stream; the gradients are summed in slot order (across ranks
  by one ``all_reduce`` a step) and every copy of a leaf takes the same
  update.  The draws are the one-slot train's, from one generator on the
  merge device.

Nothing here is computed in Pallas in the JAX package, so nothing here is a
hand-written kernel: the tower, the losses, Adam, the gradient routing and
the wave's top-k are torch ops.  Sharded serving is the engine's
(``parallel/placement.py``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs.tracing import device_span

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


def _mean_valid(losses: torch.Tensor, valid: torch.Tensor,
                count: torch.Tensor | None = None) -> torch.Tensor:
    # the count clamps on the device: no host read inside a step.  A mesh
    # passes the whole batch's count, so each data position's partial sum
    # is its share of the global mean
    if count is None:
        count = torch.clamp(valid.sum(), min=1.0)
    return (losses * valid).sum() / count


def _pos_neg(params, user_idx, pos_idx, neg_idx):
    b, k = neg_idx.shape
    pos = ncf_forward(params, user_idx, pos_idx)  # [b]
    neg = ncf_forward(
        params, user_idx.repeat_interleave(k), neg_idx.reshape(-1)
    ).reshape(b, k)
    return pos, neg


def bpr_loss(params: dict, user_idx, pos_idx, neg_idx, valid,
             count=None) -> torch.Tensor:
    """Bayesian Personalized Ranking over K negatives: mean over pairs of
    -log sigmoid(s_pos - s_neg).  ``neg_idx`` is [b, K].  ``count``, when
    given, is the mean's denominator (every loss here takes it: a mesh's
    global valid count); by default ``valid``'s sum, at least 1."""
    pos, neg = _pos_neg(params, user_idx, pos_idx, neg_idx)
    return _mean_valid(-F.logsigmoid(pos[:, None] - neg).mean(dim=1), valid,
                       count)


def sampled_softmax_loss(params: dict, user_idx, pos_idx, neg_idx, valid,
                         count=None):
    """(1+K)-way sampled softmax: the positive against all K sampled
    negatives jointly.  ``neg_idx`` is [b, K]."""
    pos, neg = _pos_neg(params, user_idx, pos_idx, neg_idx)
    logits = torch.cat([pos[:, None], neg], dim=1)  # [b, 1+K]
    return _mean_valid(-torch.log_softmax(logits, dim=1)[:, 0], valid, count)


def _catalog_logits(params: dict, user_idx) -> torch.Tensor:
    logits = params["user_emb"][user_idx] @ params["item_emb"].T
    bias = params.get("item_bias")
    if bias is not None:
        logits = logits + bias[None, :]
    return logits


def full_softmax_loss(params: dict, user_idx, pos_idx, valid,
                      n_items: int | None = None, count=None):
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
    return _mean_valid(-picked, valid, count)


def wals_loss(params: dict, user_idx, pos_idx, valid, inv_count,
              alpha: float, n_items: int, count=None):
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
    return _mean_valid(per_row, valid, count)


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
    device.  Under a capture (``obs.tracing``) the three phases are device
    spans: ``ncf.step.forward``, ``ncf.step.backward`` (the gradients'
    zeroing and autograd) and ``ncf.step.optimizer``."""
    with device_span("ncf.step.forward", u.device):
        if p.loss == "wals":
            loss = wals_loss(params, u, pos, valid, w, p.alpha, n_items)
        elif p.loss == "full_softmax":
            loss = full_softmax_loss(params, u, pos, valid, n_items)
        else:
            loss = _SAMPLED_LOSSES[p.loss](params, u, pos, neg, valid)
    with device_span("ncf.step.backward", u.device):
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
    with device_span("ncf.step.optimizer", u.device):
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
                 device: torch.device, multiple: int = 1) -> Stream:
    """Pad the positives to ``n_steps * batch`` rows (``valid`` masks the
    padding) and upload them once.  ``multiple`` rounds the batch up to a
    multiple of it (a mesh's ``data`` axis size, as the JAX package
    rounds it)."""
    n_pos = len(user_idx)
    bs = min(p.batch_size, max(n_pos, 1))
    bs = -(-bs // multiple) * multiple
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


def epoch_batches(
    stream: Stream,
    p: NCFParams,
    n_items: int,
    generator: torch.Generator | None = None,
    neg_cdf: torch.Tensor | None = None,
    perm: torch.Tensor | None = None,
    negatives: Callable[[int], torch.Tensor] | None = None,
) -> Iterator[tuple]:
    """One epoch's batches ``(u, pos, neg, valid, w)``: the stream in
    permuted order, ``stream.n_steps`` of them.  The permutation and each
    step's negatives (``None`` for the whole-catalog losses) are drawn from
    ``generator`` (over ``neg_cdf``) unless given: ``perm`` a permutation
    of the padded stream, ``negatives(step)`` the step's [batch, K] ids.
    One-slot and mesh epochs draw through here, so both take the same
    draws from one seed."""
    if perm is None:
        perm = torch.randperm(
            stream.u.shape[0], generator=generator, device=stream.u.device
        )
    us, ps, vs, ws = (
        x[perm].view(stream.n_steps, stream.batch)
        for x in (stream.u, stream.i, stream.valid, stream.w)
    )
    k_neg = max(p.negatives_per_positive, 1)
    for s in range(stream.n_steps):
        neg = None
        if p.loss in _SAMPLED_LOSSES:
            neg = (
                negatives(s) if negatives is not None
                else sample_negatives(neg_cdf, stream.batch, k_neg, n_items,
                                      generator)
            )
        yield us[s], ps[s], neg, vs[s], ws[s]


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
    """One epoch over :func:`epoch_batches` (which see for the draws).
    Returns the mean step loss, a 0-d tensor on the device."""
    total = torch.zeros((), device=stream.u.device)
    for u, pos, neg, valid, w in epoch_batches(
            stream, p, n_items, generator, neg_cdf, perm, negatives):
        total = total + train_step(
            params, optimizer, u, pos, neg, valid, w, p, n_items
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
    mesh=None,
) -> NCFState:
    """Train from positive (user, item) interactions on ``device``
    (``None`` means CUDA, and raises without a card unless
    ``device="cpu"``).

    ``mesh`` (a ``parallel.mesh.Mesh`` of ``data`` and ``model`` axes) of
    more than one slot trains over its slots, which then name the devices
    (``device`` is not read): the tables are padded to a multiple of the
    ``model`` axis and drawn at that shape, split over ``model`` with
    their Adam moments (:class:`MeshNCF`), and each batch, rounded up to a
    multiple of the ``data`` axis, split over ``data``.  In a
    multi-process mesh every rank passes the identical full arrays (the
    JAX package's contract) and computes only its own data positions.  The
    state then holds the whole tree, padded rows kept, on the merge device.
    A mesh of one slot, or None, trains on ``device``.

    The init is drawn on the host from a generator seeded with ``p.seed``
    (so a CPU and a CUDA train start from the same tables), then overlaid
    with ``initial_params`` (numpy arrays or tensors; the pretrain-GMF
    recipe).  The epochs draw from a generator on ``device``, seeded with
    ``p.seed``.  The train ends with one read of the epochs' losses, which
    also waits for the card."""
    p = params or NCFParams()
    if mesh is not None and mesh.devices.size > 1:
        return _train_mesh(user_idx, item_idx, n_users, n_items, p,
                           initial_params, mesh)
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


# -- over a mesh -------------------------------------------------------------

#: the leaves a mesh's ``model`` axis splits by rows
TABLES = ("user_emb", "item_emb")

#: diagnostics of the most recent mesh train: the layout, the bytes one
#: step gathers and routes, and each phase's milliseconds
LAST_MESH_INFO: dict = {}


@dataclass(frozen=True)
class Placement:
    """One leaf's place on a mesh: ``blocks`` row blocks of ``rows`` rows,
    block ``m`` held whole by every slot at position ``m`` of the ``model``
    axis (the JAX package's ``PSpec("model", None)``).  One block is the
    whole leaf on every slot (``PSpec()``)."""

    blocks: int = 1
    rows: int = 0

    def block(self, m: int) -> slice:
        return slice(m * self.rows, (m + 1) * self.rows)


def param_shardings(mesh, params: dict) -> dict:
    """Where each leaf of ``params`` lives on ``mesh``, as the JAX package
    places it: the two embedding tables row-split over ``model`` when the
    mesh has that axis, every other leaf (the item bias, the MLP,
    ``out_w``/``out_b``) replicated.  A tree of :class:`Placement` in the
    tree's shape; a mesh without a ``model`` axis replicates the tables
    too.  Table rows must divide by the axis size (``train_ncf`` pads
    them first)."""
    n_model = int(mesh.shape.get("model", 1))

    def table(name, leaf):
        n = int(leaf.shape[0])
        if n % n_model:
            raise ValueError(
                f"param_shardings: {name} has {n} rows, which the model axis "
                f"of {n_model} does not divide"
            )
        return Placement(n_model, n // n_model)

    return {
        name: table(name, leaf) if name in TABLES
        else tree_map(lambda _: Placement(), leaf)
        for name, leaf in params.items()
    }


class _Layout:
    """Which slot holds and computes what on a mesh of ``{data: D, model:
    M}`` slots (either axis may be absent, size 1).  Slot ``(d, m)`` holds
    block ``m`` of each table and every replicated leaf whole; data
    position ``d`` computes on slot ``(d, 0)``, reading the blocks of the
    slots ``(d, m)``.  Across processes a rank computes the data positions
    whose slot ``(d, 0)`` is its own, and must hold every ``(d, m)`` of
    them."""

    def __init__(self, mesh):
        extra = set(mesh.shape) - {"data", "model"}
        if extra:
            raise ValueError(
                f"train_ncf: mesh axes {sorted(extra)} are neither 'data' nor "
                f"'model': {mesh.shape}"
            )
        n = len(mesh.slots)
        self.n_data = int(mesh.shape.get("data", 1))
        self.n_model = int(mesh.shape.get("model", 1))
        self.d_of = mesh.positions("data") if "data" in mesh.shape else [0] * n
        self.m_of = mesh.positions("model") if "model" in mesh.shape else [0] * n
        self.at = {}
        for slot in range(n):  # the first slot of each (d, m)
            self.at.setdefault((self.d_of[slot], self.m_of[slot]), slot)
        self.owner = [self.at[(d, 0)] for d in range(self.n_data)]
        local = set(mesh.local_slots)
        self.mine = [d for d in range(self.n_data) if self.owner[d] in local]
        for d in self.mine:
            far = [self.at[(d, m)] for m in range(self.n_model)
                   if self.at[(d, m)] not in local]
            if far:
                raise ValueError(
                    f"train_ncf: rank {mesh.process_index} computes data "
                    f"position {d} but slots {far} of its blocks are another "
                    "rank's; lay the mesh out so that a rank holds every "
                    "model block of its data positions"
                )


def _leaf_names(tree: dict) -> list[str]:
    """The top-level name of each leaf, in :func:`tree_leaves` order."""
    return [name for name in sorted(tree) for _ in tree_leaves(tree[name])]


class MeshNCF:
    """A parameter tree and its Adam state placed on a mesh
    (:func:`param_shardings`): each local slot holds its own copy of its
    leaves, block ``m`` of each table at model position ``m`` and every
    other leaf whole, and an optimizer of its own over them (so the Adam
    moments of a table are split as the table is).  Copies of one leaf
    take the same update, so they stay equal bit for bit.

    :meth:`step` is one optimization step on one global batch: data
    position ``d`` gathers the table rows its share of the batch reads
    from the slots ``(d, m)`` (the whole-catalog losses gather every item
    block), computes its loss terms over the whole batch's valid count and
    their gradients on its slot's stream, and routes each table row's
    gradient into dense per-block buffers.  The partials are summed in slot
    order on the merge device (across ranks, then ``all_reduce``d: one
    flat buffer a step), and each slot applies the sums to its leaves on
    its stream.  No float atomics cross slots."""

    def __init__(self, mesh, tree: dict, p: NCFParams):
        from predictionio_tpu_torch.ops.als import _PhaseClock

        self.mesh, self.p = mesh, p
        self.layout = _Layout(mesh)
        self.placement = param_shardings(mesh, tree)
        self.names = _leaf_names(tree)
        self.merge = mesh.merge_device
        #: milliseconds per phase of the steps so far (``clock.ms()``)
        self.clock = _PhaseClock(self.merge)
        self.trees: dict[int, dict] = {}
        self.optimizers: dict[int, torch.optim.Optimizer] = {}
        for slot in mesh.local_slots:
            m, dev = self.layout.m_of[slot], mesh.slots[slot]

            def place(name, leaf, m=m, dev=dev):
                if name in TABLES:
                    leaf = leaf[self.placement[name].block(m)]
                return tree_map(
                    lambda x: torch.as_tensor(x).detach().to(
                        dev, torch.float32, copy=True).requires_grad_(True),
                    leaf)

            self.trees[slot] = {k: place(k, v) for k, v in tree.items()}
            self.optimizers[slot] = make_optimizer(self.trees[slot], p)
        # the flat gradient's parts: each table block, then each other leaf
        self.keys = [
            (j, m)
            for j, name in enumerate(self.names)
            for m in (range(self.layout.n_model) if name in TABLES else (None,))
        ]

    def _holders(self, d: int) -> list[dict]:
        return [self.trees[self.layout.at[(d, m)]]
                for m in range(self.layout.n_model)]

    def _rows(self, name: str, holders: list[dict], ids: torch.Tensor,
              dev: torch.device) -> torch.Tensor:
        """Table rows ``ids`` gathered from their blocks, exactly."""
        rows = self.placement[name].rows
        blk, local = ids // rows, ids % rows
        out = None
        for m, held in enumerate(holders):
            t = held[name].detach()
            part = t[local.to(t.device)].to(dev)
            out = part if out is None else torch.where(
                (blk == m)[:, None], part, out)
        return out

    def _route(self, name: str, grad_rows: torch.Tensor,
               ids: torch.Tensor) -> list[torch.Tensor]:
        """Each block's gradient from per-row gradients: rows of other
        blocks go to a spare row past the block, which is dropped."""
        rows = self.placement[name].rows
        blk, local = ids // rows, ids % rows
        out = []
        for m in range(self.layout.n_model):
            buf = torch.zeros((rows + 1,) + grad_rows.shape[1:],
                              device=grad_rows.device, dtype=grad_rows.dtype)
            buf.index_put_((torch.where(blk == m, local, rows),), grad_rows,
                           accumulate=True)
            out.append(buf[:rows])
        return out

    def _position(self, d: int, u, pos, neg, valid, w, count,
                  n_items: int) -> list:
        """Data position ``d``'s loss partial and gradient parts (in
        ``self.keys`` order, the loss first), on its slot."""
        p, L = self.p, self.layout
        slot = L.owner[d]
        dev = self.mesh.slots[slot]
        u, pos, valid, w, count = (x.to(dev) for x in (u, pos, valid, w, count))
        holders = self._holders(d)
        head = {k: tree_map(lambda x: x.detach().requires_grad_(True), v)
                for k, v in self.trees[slot].items() if k not in TABLES}
        b = u.shape[0]
        local_u = torch.arange(b, device=dev)
        ue = self._rows("user_emb", holders, u, dev).requires_grad_(True)
        if p.loss in _SAMPLED_LOSSES:
            neg = neg.to(dev)
            k = neg.shape[1]
            item_ids = torch.cat([pos, neg.reshape(-1)])
            ie = self._rows("item_emb", holders, item_ids, dev).requires_grad_(True)
            compact = {**head, "user_emb": ue, "item_emb": ie}
            if "item_bias" in head:
                compact["item_bias"] = head["item_bias"][item_ids]
            loss = _SAMPLED_LOSSES[p.loss](
                compact, local_u, local_u,
                b + torch.arange(b * k, device=dev).view(b, k), valid, count)
        else:
            # the whole-catalog logits need every item block on this slot
            ie = torch.cat([h["item_emb"].detach().to(dev)
                            for h in holders]).requires_grad_(True)
            compact = {**head, "user_emb": ue, "item_emb": ie}
            if p.loss == "wals":
                loss = wals_loss(compact, local_u, pos, valid, w, p.alpha,
                                 n_items, count)
            else:
                loss = full_softmax_loss(compact, local_u, pos, valid, n_items,
                                         count)
        loss.backward()
        grads = {"user_emb": self._route("user_emb", ue.grad, u)}
        if p.loss in _SAMPLED_LOSSES:
            grads["item_emb"] = self._route("item_emb", ie.grad, item_ids)
        else:
            pl = self.placement["item_emb"]
            grads["item_emb"] = [ie.grad[pl.block(m)]
                                 for m in range(L.n_model)]
        head_grads = [x.grad if x.grad is not None else torch.zeros_like(x)
                      for x in tree_leaves(head)]
        out, rest = [loss.detach()], iter(head_grads)
        for j, m in self.keys:
            out.append(grads[self.names[j]][m] if m is not None else next(rest))
        return out

    def step(self, u, pos, neg, valid, w, n_items: int) -> torch.Tensor:
        """One optimization step on one global batch (tensors on the merge
        device, ``neg`` None for the whole-catalog losses); returns the
        step's loss before the update, a 0-d tensor on the merge device."""
        from predictionio_tpu_torch.ops.als import _on_slots, _together
        from predictionio_tpu_torch.parallel.mesh import all_reduce_sum

        L, mesh = self.layout, self.mesh
        count = torch.clamp(valid.sum(), min=1.0)
        share = u.shape[0] // L.n_data
        batch = (u, pos, neg, valid, w)

        def position(d):
            rows = slice(d * share, (d + 1) * share)
            return self._position(
                d, u[rows], pos[rows], None if neg is None else neg[rows],
                valid[rows], w[rows], count, n_items)

        def partials():
            with self.clock("position"):
                parts = _on_slots(
                    mesh, {d: (lambda d=d: position(d)) for d in L.mine},
                    L.owner, lambda d: (*batch, count))
            with self.clock("sum"):
                total = None
                for d in sorted(parts):  # slot order
                    part = [x.to(self.merge) for x in parts[d]]
                    total = part if total is None else [
                        a.add_(b) for a, b in zip(total, part)]
            return total

        total = _together(mesh, partials, "train_ncf")
        if mesh.is_multiprocess:
            with self.clock("collective"):
                flat = all_reduce_sum(torch.cat([x.reshape(-1) for x in total]))
                total = [piece.view(x.shape) for piece, x in zip(
                    flat.split([x.numel() for x in total]), total)]
        loss, grads = total[0], dict(zip(self.keys, total[1:]))

        def update(slot):
            m = L.m_of[slot]
            for j, leaf in enumerate(tree_leaves(self.trees[slot])):
                key = (j, m) if self.names[j] in TABLES else (j, None)
                leaf.grad.copy_(grads[key])
            self.optimizers[slot].step()

        def apply():
            with self.clock("update"):
                _on_slots(mesh, {s: (lambda s=s: update(s)) for s in mesh.local_slots},
                          list(range(len(mesh.slots))), lambda s: total)

        _together(mesh, apply, "train_ncf")
        return loss

    def train_epoch(self, stream: Stream, n_items: int,
                    generator: torch.Generator | None = None,
                    neg_cdf: torch.Tensor | None = None,
                    perm: torch.Tensor | None = None,
                    negatives: Callable[[int], torch.Tensor] | None = None,
                    ) -> torch.Tensor:
        """One epoch over :func:`epoch_batches` (the same draws as the
        one-slot :func:`train_epoch`); the mean step loss."""
        total = torch.zeros((), device=self.merge)
        for batch in epoch_batches(stream, self.p, n_items, generator,
                                   neg_cdf, perm, negatives):
            total = total + self.step(*batch, n_items)
        return total / stream.n_steps

    def gathered(self, grads: bool = False) -> dict:
        """The whole tree in the JAX package's layout (padded rows kept)
        on the merge device: each table's blocks in order, every other
        leaf from the first local slot.  ``grads`` gathers the gradient
        the last step applied instead."""
        def get(x):
            return (x.grad if grads else x).detach()

        first = self.trees[self.mesh.local_slots[0]]
        d = self.layout.d_of[self.mesh.local_slots[0]]
        tree = {k: tree_map(lambda x: get(x).to(self.merge, copy=True), v)
                for k, v in first.items() if k not in TABLES}
        for name in TABLES:
            tree[name] = torch.cat([get(h[name]).to(self.merge)
                                    for h in self._holders(d)])
        return tree

    def placed(self):
        """``(params, table moments)`` as ``placement.ShardedTensor``s for
        ``parallel.mesh.shard_attribution``: each top-level name's leaves
        with each local slot's copy, and the Adam moments of the two
        tables (``exp_avg`` and ``exp_avg_sq`` of each, once the first step
        made them)."""
        from predictionio_tpu_torch.parallel.placement import ShardedTensor

        n = len(self.mesh.slots)

        def sharded(pick, name, shape):
            locals_ = [None] * n
            for slot in self.mesh.local_slots:
                locals_[slot] = pick(slot)
            axis = "model" if name in TABLES and self.layout.n_model > 1 else None
            return ShardedTensor(self.mesh, axis, locals_, shape)

        slot0 = self.mesh.local_slots[0]
        params: dict[str, list] = {}
        moments: list = []
        for j, (name, leaf) in enumerate(
                zip(self.names, tree_leaves(self.trees[slot0]))):
            shape = tuple(leaf.shape)
            if name in TABLES:
                shape = (self.placement[name].blocks * shape[0],) + shape[1:]
            params.setdefault(name, []).append(sharded(
                lambda s, j=j: tree_leaves(self.trees[s])[j], name, shape))
            if name in TABLES and self.optimizers[slot0].state:
                for moment in ("exp_avg", "exp_avg_sq"):
                    moments.append(sharded(
                        lambda s, j=j, moment=moment: self.optimizers[s].state[
                            tree_leaves(self.trees[s])[j]][moment],
                        name, shape))
        return params, moments


def _train_mesh(user_idx, item_idx, n_users: int, n_items: int, p: NCFParams,
                initial_params, mesh) -> NCFState:
    """``train_ncf`` over a mesh of more than one slot."""
    from predictionio_tpu_torch.parallel.mesh import collective_backend, meter_shards

    t_setup = time.perf_counter()
    layout = _Layout(mesh)
    n_model = layout.n_model
    nu_pad = -(-n_users // n_model) * n_model
    ni_pad = -(-n_items // n_model) * n_model
    # the init at the padded shape, as the JAX package draws it; every rank
    # draws the same tree and places only its own slots' parts
    g_init = torch.Generator(device="cpu")
    g_init.manual_seed(p.seed)
    net = init_ncf(g_init, nu_pad, ni_pad, p)
    if initial_params is not None:
        net = _overlay(net, initial_params)
    merge = mesh.merge_device
    state = MeshNCF(mesh, net, p)
    del net
    stream = stage_stream(user_idx, item_idx, p, merge, multiple=layout.n_data)
    neg_cdf = torch.from_numpy(
        negative_sampling_cdf(item_idx, n_items, p.neg_power)).to(merge)
    generator = torch.Generator(device=merge)
    generator.manual_seed(p.seed)
    setup_s = time.perf_counter() - t_setup
    marks = [_mark(merge)]
    losses = []
    for _ in range(p.num_epochs):
        losses.append(state.train_epoch(stream, n_items, generator, neg_cdf))
        marks.append(_mark(merge))
    epoch_losses = torch.stack(losses).tolist() if losses else []
    tree = state.gathered()
    params_placed, moments = state.placed()
    width = int(tree["item_emb"].shape[1])
    share = stream.batch // layout.n_data
    k = max(p.negatives_per_positive, 1)
    whole_catalog = p.loss not in _SAMPLED_LOSSES
    LAST_MESH_INFO.clear()
    LAST_MESH_INFO.update(
        mesh=dict(mesh.shape),
        data_slots=layout.n_data,
        model_blocks=n_model,
        local_positions=list(layout.mine),
        padded=[nu_pad, ni_pad],
        # host seconds from the call to the first epoch: the init at the
        # padded shape, its placement on the slots, the stream's upload
        setup_s=setup_s,
        batch=stream.batch,
        steps_per_epoch=stream.n_steps,
        # per step and local data position: the table rows gathered from
        # the blocks (every item block under a whole-catalog loss), and the
        # dense per-block gradient buffers the rows are routed into
        gather_bytes_per_step=4.0 * width * len(layout.mine) * (
            share + (ni_pad if whole_catalog else share * (1 + k))),
        route_bytes_per_step=4.0 * width * len(layout.mine) * (nu_pad + ni_pad),
        collective_backend=collective_backend() or "in-process",
        mesh_ms=state.clock.ms(),
        shards={
            "params": meter_shards("ncf.params", params_placed),
            "table_moments": meter_shards("ncf.table_moments", moments),
        },
    )
    return NCFState(
        params=tree,
        n_users=n_users,
        n_items=n_items,
        config=p,
        epoch_losses=epoch_losses,
        epoch_seconds=[_elapsed_s(a, b) for a, b in zip(marks, marks[1:])],
    )
