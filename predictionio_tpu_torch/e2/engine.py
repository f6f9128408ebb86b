"""e2 engine helpers: categorical naive Bayes, Markov chain, one-hot
vectorizer. The port's copy of ``predictionio_tpu/e2/engine.py``.

Parity targets (semantics matched, Spark shapes replaced by numpy):

- ``e2/.../engine/CategoricalNaiveBayes.scala:29-176`` — model = log
  priors + per-feature-slot log likelihood maps; ``log_score`` with a
  pluggable default likelihood for unseen values; ``predict`` = argmax.
  The ``combineByKey`` tally becomes one vectorized ``np.add.at`` over
  integer-encoded labels/values.
- ``e2/.../engine/MarkovChain.scala:32-89`` — top-N row-normalized
  transition matrix from a sparse tally; ``predict`` = vector-matrix
  product (one dense matmul instead of an RDD map).
- ``e2/.../engine/BinaryVectorizer.scala:24-61`` — (property, value) →
  index one-hot encoder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    """One data point (CategoricalNaiveBayes.scala:155-176)."""

    label: str
    features: Tuple[str, ...]

    def __post_init__(self):
        if not isinstance(self.features, tuple):
            object.__setattr__(self, "features", tuple(self.features))


DefaultLikelihood = Callable[[Sequence[float]], float]


def _neg_inf_default(likelihoods: Sequence[float]) -> float:
    return float("-inf")


class CategoricalNaiveBayesModel:
    """NB over categorical string features.

    ``priors``: label -> log P(label); ``likelihoods``: label -> one
    dict per feature slot mapping value -> log P(value | label)
    (CategoricalNaiveBayesModel, CategoricalNaiveBayes.scala:88-153).
    """

    def __init__(self, priors: Mapping[str, float],
                 likelihoods: Mapping[str, Sequence[Mapping[str, float]]]):
        self.priors = dict(priors)
        self.likelihoods = {
            label: [dict(slot) for slot in slots]
            for label, slots in likelihoods.items()
        }
        first = next(iter(self.likelihoods.values()))
        self.feature_count = len(first)

    def log_score(
        self, point: LabeledPoint,
        default_likelihood: DefaultLikelihood = _neg_inf_default,
    ) -> Optional[float]:
        """Log score of (label, features); None for an unknown label
        (CategoricalNaiveBayes.scala:104-116)."""
        if point.label not in self.priors:
            return None
        return self._log_score(point.label, point.features,
                               default_likelihood)

    def _log_score(self, label: str, features: Sequence[str],
                   default_likelihood: DefaultLikelihood) -> float:
        likelihood = self.likelihoods[label]
        total = self.priors[label]
        for feature, slot in zip(features, likelihood):
            if feature in slot:
                total += slot[feature]
            else:
                total += default_likelihood(list(slot.values()))
        return total

    def predict(self, features: Sequence[str]) -> str:
        """argmax label (CategoricalNaiveBayes.scala:140-152)."""
        return max(
            self.priors,
            key=lambda label: self._log_score(
                label, features, _neg_inf_default))

    def predict_batch(self, features: Sequence[Sequence[str]]) -> List[str]:
        """Vectorized argmax over many points: integer-encode values once,
        then a single gather + sum per label — the batch path the
        reference lacks."""
        labels = sorted(self.priors)
        scores = np.zeros((len(features), len(labels)), dtype=np.float64)
        for lx, label in enumerate(labels):
            slots = self.likelihoods[label]
            scores[:, lx] = self.priors[label]
            for n, point in enumerate(features):
                for feature, slot in zip(point, slots):
                    scores[n, lx] += slot.get(feature, float("-inf"))
        return [labels[i] for i in np.argmax(scores, axis=1)]


class CategoricalNaiveBayes:
    """Trainer (CategoricalNaiveBayes.scala:29-79)."""

    @staticmethod
    def train(points: Sequence[LabeledPoint]) -> CategoricalNaiveBayesModel:
        if not points:
            raise ValueError("cannot train on an empty data set")
        n_slots = len(points[0].features)
        labels = sorted({p.label for p in points})
        label_ix = {l: i for i, l in enumerate(labels)}
        vocabs: List[Dict[str, int]] = []
        for s in range(n_slots):
            values = sorted({p.features[s] for p in points})
            vocabs.append({v: i for i, v in enumerate(values)})

        label_codes = np.fromiter((label_ix[p.label] for p in points),
                                  dtype=np.int64, count=len(points))
        label_counts = np.bincount(label_codes, minlength=len(labels))

        likelihoods: Dict[str, List[Dict[str, float]]] = {
            l: [] for l in labels}
        for s, vocab in enumerate(vocabs):
            value_codes = np.fromiter(
                (vocab[p.features[s]] for p in points),
                dtype=np.int64, count=len(points))
            counts = np.zeros((len(labels), len(vocab)), dtype=np.int64)
            np.add.at(counts, (label_codes, value_codes), 1)
            with np.errstate(divide="ignore"):
                log_lik = np.log(counts / label_counts[:, None])
            for l, lx in label_ix.items():
                likelihoods[l].append({
                    v: float(log_lik[lx, vx])
                    for v, vx in vocab.items() if counts[lx, vx] > 0
                })

        total = float(label_counts.sum())
        priors = {
            l: math.log(label_counts[lx] / total)
            for l, lx in label_ix.items()
        }
        return CategoricalNaiveBayesModel(priors, likelihoods)


class MarkovChainModel:
    """Row-stochastic top-N transition matrix (MarkovChain.scala:57-89).

    Stored dense [S, S] float32 — at e2 scale a dense matmul beats the
    reference's per-row RDD sparse products.
    """

    def __init__(self, transition: np.ndarray, n: int):
        self.transition = np.asarray(transition, dtype=np.float32)
        self.n = n

    def predict(self, current_state: Sequence[float]) -> np.ndarray:
        """Next-state distribution = state · P (MarkovChain.scala:70-88)."""
        s = np.asarray(current_state, dtype=np.float32)
        return s @ self.transition


class MarkovChain:
    """Trainer (MarkovChain.scala:32-55)."""

    @staticmethod
    def train(rows: Sequence[int], cols: Sequence[int],
              values: Sequence[float], n_states: int,
              top_n: int) -> MarkovChainModel:
        """Tally entries (row, col, count) -> keep each row's top-N by
        count, normalized by the row's FULL total (matches the reference:
        sum over all entries, then take(topN))."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        counts = np.zeros((n_states, n_states), dtype=np.float64)
        np.add.at(counts, (rows, cols), values)

        totals = counts.sum(axis=1, keepdims=True)
        transition = np.zeros_like(counts)
        nonzero = totals[:, 0] > 0
        if top_n < n_states:
            # zero everything below each row's top-N tally
            kth = np.partition(counts, -top_n, axis=1)[:, -top_n][:, None]
            keep = counts >= kth
            # ties at the threshold: cap to exactly top_n per row, matching
            # the reference's take(topN) after a stable sort
            for r in np.nonzero(keep.sum(axis=1) > top_n)[0]:
                order = np.argsort(-counts[r], kind="stable")[:top_n]
                mask = np.zeros(n_states, dtype=bool)
                mask[order] = True
                keep[r] = mask
            counts = np.where(keep, counts, 0.0)
        transition[nonzero] = counts[nonzero] / totals[nonzero]
        return MarkovChainModel(transition.astype(np.float32), top_n)


class BinaryVectorizer:
    """(property, value) -> one-hot index (BinaryVectorizer.scala:24-61)."""

    def __init__(self, property_map: Mapping[Tuple[str, str], int]):
        self.property_map = dict(property_map)
        self.num_features = len(self.property_map)
        self.properties = [
            kv for kv, _ in sorted(self.property_map.items(),
                                   key=lambda e: e[1])
        ]

    def __str__(self) -> str:
        pairs = ",".join(f"({p}, {v})" for p, v in self.properties)
        return f"BinaryVectorizer({self.num_features}): {pairs}"

    def to_binary(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        vec = np.zeros(self.num_features, dtype=np.float32)
        for pair in pairs:
            idx = self.property_map.get(tuple(pair))
            if idx is not None:
                vec[idx] = 1.0
        return vec

    def to_binary_batch(
            self, rows: Sequence[Sequence[Tuple[str, str]]]) -> np.ndarray:
        out = np.zeros((len(rows), self.num_features), dtype=np.float32)
        for i, pairs in enumerate(rows):
            out[i] = self.to_binary(pairs)
        return out

    @classmethod
    def from_maps(cls, maps: Sequence[Mapping[str, str]],
                  properties: Sequence[str]) -> "BinaryVectorizer":
        """Distinct (property, value) pairs restricted to ``properties``
        (BinaryVectorizer.scala:45-55)."""
        wanted = set(properties)
        seen: Dict[Tuple[str, str], int] = {}
        for m in maps:
            for k, v in m.items():
                if k in wanted and (k, v) not in seen:
                    seen[(k, v)] = len(seen)
        return cls(seen)

    @classmethod
    def from_pairs(
            cls, pairs: Sequence[Tuple[str, str]]) -> "BinaryVectorizer":
        return cls({tuple(p): i for i, p in enumerate(pairs)})
