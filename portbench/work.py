"""The yardstick's arithmetic: the card's peaks and the operations and bytes
of the work the cells drive, counted from the shapes and the ratings alone.

Frozen copies, each naming its origin, so that a change to the program can
never move the yardstick it is measured by.
"""

from __future__ import annotations

from typing import Sequence

#: Published peaks per card name (NVIDIA's data sheets, dense rates): HBM
#: bytes/s and float32 FLOP/s outside the tensor cores.  Frozen from
#: ``predictionio_tpu_torch/obs/device.py`` ``PEAK_TABLE``'s H100 rows.  The
#: rates assume the card's full power limit (700 W on the SXM part).
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),  # SXM
    "NVIDIA H100 PCIe": (2.0e12, 51e12),
    "NVIDIA H100 NVL": (3.9e12, 60e12),
}


def peaks(device_name: str) -> tuple[float, float] | None:
    """(bytes/s, fp32 FLOP/s) of the named card, or None for a card not in
    the table (its shares are then not reported)."""
    return PEAKS.get(device_name)


def ncf_pair_flops(table_width: int, mlp: Sequence[tuple[int, int]],
                   item_bias: bool) -> float:
    """Forward FLOPs of one scored (user, item) pair through the two-tower
    head: the GMF product, each MLP layer's product, bias and ReLU, the
    output layer over ``[gmf | mlp]`` and the item bias.  ``mlp`` lists each
    layer's (in, out); empty for pure GMF (one dot of ``table_width``).
    Frozen from ``predictionio_tpu_torch/ops/ncf.py`` ``ncf_wave_least_work``."""
    if not mlp:
        flops = 2.0 * table_width + 1.0
    else:
        d = table_width // 2
        flops = float(d)
        for fan_in, fan_out in mlp:
            flops += 2.0 * fan_in * fan_out + 2.0 * fan_out
        flops += 2.0 * (d + mlp[-1][1]) + 1.0
    return flops + (1.0 if item_bias else 0.0)


def ncf_wave_least_work(
    batch: int, n_items: int, table_width: int,
    mlp: Sequence[tuple[int, int]], k: int, item_bias: bool,
) -> dict[str, float]:
    """The least work of one scored wave, ``batch`` users against the whole
    catalog and then the top ``k``: each input read once (the user rows,
    the item table, the head's weights, the bias), the ``[2, batch, k]``
    result written once, and the tower's FLOPs for every pair.  Frozen from
    ``predictionio_tpu_torch/ops/ncf.py`` ``ncf_wave_least_work``."""
    weights = 1
    if mlp:
        d = table_width // 2
        for fan_in, fan_out in mlp:
            weights += fan_in * fan_out + fan_out
        weights += d + mlp[-1][1]
    return {
        "flops": float(batch) * n_items
        * ncf_pair_flops(table_width, mlp, item_bias),
        "bytes": 4.0 * (
            batch * table_width + n_items * table_width + weights
            + (n_items if item_bias else 0) + 2 * batch * k
        ),
    }


def ncf_train_step_flops(positives: int, negatives_per_positive: int,
                         table_width: int, mlp: Sequence[tuple[int, int]],
                         item_bias: bool) -> float:
    """FLOPs of one sampled-loss training step: every scored pair (each
    positive and each of its negatives) forward and backward, counted as
    three times the forward.  Written here; the program has no count."""
    pairs = float(positives) * (1 + negatives_per_positive)
    return 3.0 * pairs * ncf_pair_flops(table_width, mlp, item_bias)


def als_accum_least_work(nnz: int, k: int, n_seg: int,
                         n_oth: int) -> dict[str, float]:
    """The least work of one half-step's accumulation, counted from the
    ratings and not from any padded stream: per rating its segment id,
    opposite id and value read once; the opposite factor table read once;
    each segment's ``k*k + k + 1`` stats written once; per rating the
    ``3k^2 + 2k + 1`` FLOPs that form and add its row.  Re-counted from
    ``predictionio_tpu_torch/ops/als_accum.py`` ``als_accum_least_work``,
    which reads a segment id for every padded row and writes the padded
    output width."""
    return {
        "bytes": 4.0 * (3.0 * nnz + n_oth * k + n_seg * (k * k + k + 1)),
        "flops": float(nnz) * (3 * k * k + 2 * k + 1),
    }


def als_iteration_flops(nnz: int, k: int, n_users: int, n_items: int) -> float:
    """FLOPs of one ALS iteration: both half-steps' accumulation FLOPs and
    a ``k^3 / 3`` Cholesky factorization per solved row.  Written here from
    ``als_accum_least_work`` and ``predictionio_tpu_torch/ops/als.py``'s
    batched solve."""
    accum = 2.0 * nnz * (3 * k * k + 2 * k + 1)
    return accum + (n_users + n_items) * k ** 3 / 3.0


def least_seconds(work: dict[str, float], device_name: str) -> float | None:
    """The least time the named card could take for ``work``: the larger of
    its bytes over peak bandwidth and its FLOPs over peak fp32 rate."""
    pk = peaks(device_name)
    if pk is None:
        return None
    return max(work["bytes"] / pk[0], work["flops"] / pk[1])
