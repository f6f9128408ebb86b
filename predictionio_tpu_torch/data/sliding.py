"""Shared evaluation-split helpers: sliding time windows + leave-last-out.

The port's copy of ``predictionio_tpu/data/sliding.py``. The
recommendation template evaluates with the two protocols of the
reference's movielens-evaluation example (``EventsSlidingEvalParams``:
firstTrainingUntilTime / evalDuration / evalCount, and the leave-last-out
default); the split math lives here, on bare arrays, and the template
only decodes the masks and holdouts into its training data.

Window semantics (the boundary contract the tests pin):

- window ``k`` trains on events strictly BEFORE ``t0 + k*duration``;
- it tests on events in ``[t0 + k*duration, t0 + (k+1)*duration)`` —
  an event exactly AT a cut belongs to that cut's TEST window and to
  every LATER window's training set.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np

K = TypeVar("K")
V = TypeVar("V")


def sliding_window_masks(times: np.ndarray, t0: float, duration: float,
                         count: int,
                         hint: str = "move the first cut later or "
                                     "reduce the window count"
                         ) -> Iterator[
                             Tuple[int, np.ndarray, np.ndarray]]:
    """Yield ``(k, train_mask, test_mask)`` per sliding window.

    ``times`` is float64 epoch seconds aligned with whatever row set the
    caller slices; ``t0`` the first cut; ``duration`` the window length
    in seconds. A window with NO training events raises — training on
    an empty set would crash deeper in with a far worse message.
    ``hint`` lets the caller name ITS configuration flags in the error
    (the templates pass "move eval_first_until later or reduce
    eval_count" so operators see the knobs they actually set).
    """
    times = np.asarray(times, dtype=np.float64)
    if duration <= 0:
        raise ValueError(
            f"sliding-eval window duration must be positive, got "
            f"{duration}")
    for k in range(int(count)):
        cut = t0 + k * duration
        train_mask = times < cut
        if not train_mask.any():
            raise ValueError(
                f"sliding-eval window {k} has no training events before "
                f"its cut — {hint}")
        test_mask = (times >= cut) & (times < cut + duration)
        yield k, train_mask, test_mask


def leave_last_out(groups: Dict[K, List[V]]) \
        -> Tuple[List[V], List[Tuple[K, V]]]:
    """Per-group leave-last-out split over ALREADY-ORDERED groups.

    ``groups`` maps key -> its events in evaluation order (stream or
    time order — the caller's choice is the protocol). Groups with
    fewer than 2 events go whole into training (no holdout: a
    single-event user cannot both train and test). Returns
    ``(train_events, [(key, held_out_last_event), ...])`` preserving
    each group's internal order and the dict's group order.
    """
    train: List[V] = []
    held: List[Tuple[K, V]] = []
    for key, rs in groups.items():
        if len(rs) < 2:
            train.extend(rs)
            continue
        train.extend(rs[:-1])
        held.append((key, rs[-1]))
    return train, held


def ndcg_at_k(ranked: Sequence, relevant, k: int) -> float:
    """Binary-relevance NDCG@k of one ranked list (the sequence-aware
    metric next to Precision@k — rank position matters, so a model
    that puts the held-out next item FIRST beats one that buries it at
    position k, which Precision@k cannot distinguish).

    ``ranked`` is the recommendation list best-first; ``relevant`` the
    held-out item collection (set semantics). DCG uses the standard
    ``1/log2(rank+1)`` gain; the ideal DCG places all |relevant| items
    (clipped to k) on top. Empty ``relevant`` returns 0.0 — callers
    following OptionAverageMetric semantics should skip those instead.
    """
    rel = set(relevant)
    if not rel:
        return 0.0
    k = int(k)
    dcg = 0.0
    for pos, item in enumerate(ranked[:k]):
        if item in rel:
            dcg += 1.0 / np.log2(pos + 2.0)
    ideal = sum(1.0 / np.log2(pos + 2.0)
                for pos in range(min(k, len(rel))))
    return float(dcg / ideal)


def group_by_entity(entities: Sequence, payloads: Sequence[V]) \
        -> Dict[str, List[V]]:
    """Group aligned (entity, payload) rows into an insertion-ordered
    dict of per-entity payload lists — the shared precursor of
    :func:`leave_last_out`."""
    groups: Dict[str, List[V]] = {}
    for ent, payload in zip(entities, payloads):
        groups.setdefault(str(ent), []).append(payload)
    return groups


__all__ = ["sliding_window_masks", "leave_last_out", "group_by_entity",
           "ndcg_at_k"]
