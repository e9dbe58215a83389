"""Plain two-tower NCF (GMF + MLP), the reference the NCF cells are held
to.  Plain PyTorch; imports nothing of the program.

He et al., "Neural Collaborative Filtering" (WWW 2017), as NVIDIA's
DeepLearningExamples trains it: per pair, ``gmf = p_u * q_i`` over the GMF
halves of the two embeddings, an MLP with ReLU over ``[p'_u | q'_i]``, the
MLP halves, and one output layer over ``[gmf | mlp]``, plus a learned item
bias.  Parameters are a flat dict of named leaves: ``user_emb`` and
``item_emb`` ``[n, 2d]`` (columns ``[0:d]`` GMF, ``[d:2d]`` MLP),
``mlp.<j>.w`` ``[in, out]`` and ``mlp.<j>.b``, ``out_w`` ``[d + last, 1]``,
``out_b`` ``[1]``, ``item_bias`` ``[n_items]``.

Training is BPR over K sampled negatives, ``mean_k -log sigmoid(s_pos -
s_neg_k)`` averaged over the valid rows, with Adam (Kingma and Ba; eps
added to the root of the bias-corrected second moment), all by hand here.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in full precision, or in TF32 where ``tf32``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def n_layers(params: dict) -> int:
    return sum(1 for name in params if name.endswith(".w"))


def tower(params: dict, ue: torch.Tensor, ie: torch.Tensor) -> torch.Tensor:
    """Scores of paired rows ``ue``, ``ie`` ``[..., 2d]`` (no item bias)."""
    d = ue.shape[-1] // 2
    gmf = ue[..., :d] * ie[..., :d]
    h = torch.cat([ue[..., d:], ie[..., d:]], dim=-1)
    for j in range(n_layers(params)):
        h = torch.relu(h @ params[f"mlp.{j}.w"] + params[f"mlp.{j}.b"])
    return (torch.cat([gmf, h], dim=-1) @ params["out_w"])[..., 0] \
        + params["out_b"][0]


def score_pairs(params: dict, user: torch.Tensor,
                item: torch.Tensor) -> torch.Tensor:
    return (tower(params, params["user_emb"][user], params["item_emb"][item])
            + params["item_bias"][item])


def score_users(params: dict, users: torch.Tensor,
                block: int = 8) -> torch.Tensor:
    """``[len(users), n_items]`` scores of every item, ``block`` users at
    a time, in the params' dtype."""
    items = params["item_emb"]
    out = []
    for lo in range(0, len(users), block):
        ue = params["user_emb"][users[lo:lo + block]]
        b, n = ue.shape[0], items.shape[0]
        s = tower(params, ue[:, None, :].expand(b, n, ue.shape[1]),
                  items[None, :, :].expand(b, n, items.shape[1]))
        out.append(s + params["item_bias"][None, :])
    return torch.cat(out)


def bpr_loss(params: dict, user, pos, neg, valid) -> torch.Tensor:
    """BPR over ``neg`` ``[b, K]``, the mean over valid rows (at least 1)."""
    b, k = neg.shape
    s_pos = score_pairs(params, user, pos)
    s_neg = score_pairs(params, user.repeat_interleave(k),
                        neg.reshape(-1)).reshape(b, k)
    per_row = -F.logsigmoid(s_pos[:, None] - s_neg).mean(dim=1)
    return (per_row * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def adam_steps(params: dict, batches, lr: float, betas=(0.9, 0.999),
               eps: float = 1e-8):
    """Adam over ``batches`` of ``(user, pos, neg, valid)`` from
    ``params`` (leaves in any float dtype, left unchanged).  Returns each
    step's loss, the first step's gradient per leaf and the params after
    the last step."""
    p = {n: x.detach().clone() for n, x in params.items()}
    m = {n: torch.zeros_like(x) for n, x in p.items()}
    v = {n: torch.zeros_like(x) for n, x in p.items()}
    losses, first_grad = [], None
    b1, b2 = betas
    for t, (user, pos, neg, valid) in enumerate(batches, start=1):
        for x in p.values():
            x.requires_grad_(True)
        loss = bpr_loss(p, user, pos, neg, valid)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = dict(zip(p, grads))
            if first_grad is None:
                first_grad = {n: x.clone() for n, x in g.items()}
            for n in p:
                m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                m_hat = m[n] / (1 - b1 ** t)
                v_hat = v[n] / (1 - b2 ** t)
                p[n] = p[n].detach() - lr * m_hat / (v_hat.sqrt() + eps)
        del grads, g, loss
    return losses, first_grad, {n: x.detach() for n, x in p.items()}
