"""Classification ops: multinomial Naive Bayes and logistic regression.

The port of the JAX package's ``ops/classifiers.py`` (Spark MLlib's
``NaiveBayes.train`` of the reference classification template,
examples/scala-parallel-classification/add-algorithm/src/main/scala/
NaiveBayesAlgorithm.scala:40-56, and full-batch softmax regression as the
second algorithm), as torch functions on the caller's device.

Nothing here is computed in Pallas in the JAX package (``segment_sum``,
``x @ theta.T`` and a ``lax.scan`` of gradient steps), so nothing here is a
hand-written kernel.  Two properties are kept on purpose:

- **Determinism.** Two trains of the same data give the same bits, on a
  card as on the CPU.  The class counts are an integer ``bincount`` and the
  per-class feature sums are ``one_hot(y).T @ x`` (a GEMM, which cuBLAS
  computes in the same order on every run), never an ``index_add_`` whose
  float atomics sum in a different order each time.
- **No host sync in the step loop.** The logistic-regression gradient is
  written in closed form and every step stays on the device, as the JAX
  version is one compiled program; the weights come back once at the end.

Callers compare against a reference with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


@dataclass
class NaiveBayesModel:
    """log P(class) and per-class feature log-probabilities."""

    pi: Any  # [n_classes] log prior
    theta: Any  # [n_classes, n_features] log P(feature | class)
    labels: Any  # [n_classes] original label values (float)


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _log_scalar(v: float, device) -> torch.Tensor:
    """``log`` of a host scalar in fp32, as ``jnp.log`` of a weakly typed
    Python number computes it."""
    return torch.log(torch.tensor(v, dtype=torch.float32, device=device))


def train_naive_bayes(
    x, y_idx, n_classes: int, lam: float = 1.0, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multinomial NB sufficient statistics on ``device`` (``None``: CUDA,
    as every entry point of the port; ``"cpu"`` on request).

    MLlib semantics: pi_c = log((N_c + lam) / (N + lam * C)),
    theta_cf = log((sum_{i in c} x_if + lam) / (sum_f sum_{i in c} x_if +
    lam * F))."""
    device = resolve_device(device)
    x = _as_tensor(x, torch.float32, device)
    y = _as_tensor(y_idx, torch.int64, device)
    n, f = x.shape
    counts = torch.bincount(y, minlength=n_classes).to(torch.float32)
    onehot = torch.nn.functional.one_hot(y, n_classes).to(torch.float32)
    feat_sums = onehot.T @ x  # [C, F]
    pi = torch.log(counts + lam) - _log_scalar(n + lam * n_classes, device)
    theta = torch.log(feat_sums + lam) - torch.log(
        feat_sums.sum(dim=1, keepdim=True) + lam * f
    )
    return pi, theta


def naive_bayes_scores(pi, theta, x) -> torch.Tensor:
    """Per-class log joint for a batch: [batch, C]."""
    return pi[None, :] + x @ theta.T


@dataclass
class LogisticRegressionModel:
    w: Any  # [n_features, n_classes]
    b: Any  # [n_classes]
    labels: Any  # [n_classes]


def train_logistic_regression(
    x,
    y_idx,
    n_classes: int,
    reg: float = 0.0,
    learning_rate: float = 0.1,
    num_iterations: int = 200,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-batch softmax regression by plain gradient descent from zeros.

    The loss is the JAX package's ``-mean(sum(y * log_softmax(x@w + b))) +
    reg * sum(w*w)`` (the regularization falls on ``w`` only); its gradient
    in closed form is ``x.T @ g + 2 reg w`` and ``sum(g)`` with
    ``g = (softmax(x@w + b) - y) / n``.  No step reads back to the host.
    ``device`` resolves as in :func:`train_naive_bayes`."""
    device = resolve_device(device)
    x = _as_tensor(x, torch.float32, device)
    y = torch.nn.functional.one_hot(
        _as_tensor(y_idx, torch.int64, device), n_classes
    ).to(torch.float32)
    n, f = x.shape
    xt = x.T.contiguous()
    w = torch.zeros((f, n_classes), dtype=torch.float32, device=device)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=device)
    inv_n = 1.0 / n
    for _ in range(num_iterations):
        g = (torch.softmax(x @ w + b, dim=1) - y) * inv_n
        gw = xt @ g
        if reg:
            gw = gw + (2.0 * reg) * w
        w = w - learning_rate * gw
        b = b - learning_rate * g.sum(dim=0)
    return w, b


def logreg_scores(w, b, x) -> torch.Tensor:
    return x @ w + b
