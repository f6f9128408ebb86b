"""k-fold cross-validation splitting (the port's copy of
``predictionio_tpu/e2/evaluation.py``).

Parity: ``e2/.../evaluation/CrossValidation.scala:33-64``
(``CommonHelperFunctions.splitData``): fold ``f`` tests on points where
``idx % k == f`` and trains on the rest.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(
    eval_k: int,
    dataset: Sequence[D],
    evaluator_info: EI,
    training_data_creator: Callable[[List[D]], TD],
    query_creator: Callable[[D], Q],
    actual_creator: Callable[[D], A],
) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
    """Split into eval_k folds; returns [(TD, EI, [(Q, A)])] — the shape
    ``read_eval`` wants."""
    if eval_k < 1:
        raise ValueError(f"eval_k must be >= 1, got {eval_k}")
    out = []
    for fold in range(eval_k):
        training = [pt for idx, pt in enumerate(dataset)
                    if idx % eval_k != fold]
        testing = [pt for idx, pt in enumerate(dataset)
                   if idx % eval_k == fold]
        out.append((
            training_data_creator(training),
            evaluator_info,
            [(query_creator(d), actual_creator(d)) for d in testing],
        ))
    return out
