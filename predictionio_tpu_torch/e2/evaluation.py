"""Cross-validation helper (e2/evaluation/CrossValidation.scala:36).

``split_data`` k-folds a dataset by index (idx % k == fold -> test, the
reference's zipWithIndex selection) and builds the
(training_data, eval_info, [(query, actual)]) triples the DASE eval pipeline
consumes.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
    eval_k: int,
    dataset: Sequence[D],
    evaluator_info: EI,
    training_data_creator: Callable[[list[D]], TD],
    query_creator: Callable[[D], Q],
    actual_creator: Callable[[D], A],
) -> list[tuple[TD, EI, list[tuple[Q, A]]]]:
    if eval_k < 1:
        raise ValueError("eval_k must be >= 1")
    out = []
    for fold in range(eval_k):
        training = [d for i, d in enumerate(dataset) if i % eval_k != fold]
        testing = [d for i, d in enumerate(dataset) if i % eval_k == fold]
        out.append(
            (
                training_data_creator(training),
                evaluator_info,
                [(query_creator(d), actual_creator(d)) for d in testing],
            )
        )
    return out
