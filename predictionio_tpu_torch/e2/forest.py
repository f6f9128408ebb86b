"""Random-forest classifier — the MLlib ``RandomForest.trainClassifier``
capability (invoked by the reference classification template's
``add-algorithm/src/main/scala/RandomForestAlgorithm.scala:28-41``).
The port's copy of ``predictionio_tpu/e2/forest.py``.

Not a port of MLlib's distributed tree induction: this is a vectorized
host-side implementation shaped for the framework's workloads (tabular
features extracted from entity properties — thousands of rows, a handful
of features). Split search is one sorted prefix-count pass per
(node, feature): all candidate thresholds are scored at once from
cumulative class counts, no Python loop over cut points. Trees are
grown depth-first to ``max_depth``; per-tree bootstrap sampling and
per-node feature subsetting give the usual variance reduction.

Params mirror the reference's ``RandomForestAlgorithmParams`` 1:1
(num_classes, num_trees, feature_subset_strategy, impurity, max_depth,
max_bins).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class _Tree:
    """Flat array-form binary tree (index 0 = root; -1 child = leaf)."""

    feature: np.ndarray     # int32 [n_nodes] split feature (-1 = leaf)
    threshold: np.ndarray   # float64 [n_nodes] go left if x <= t (same
    #                         precision the split search partitioned with)
    left: np.ndarray        # int32 [n_nodes]
    right: np.ndarray       # int32 [n_nodes]
    leaf_class: np.ndarray  # int32 [n_nodes] argmax class at the node

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Vectorized traversal: every sample walks one level per step."""
        node = np.zeros(len(X), dtype=np.int32)
        while True:
            feat = self.feature[node]
            active = feat >= 0
            if not active.any():
                break
            f = np.where(active, feat, 0)
            go_left = X[np.arange(len(X)), f] <= self.threshold[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(active, nxt, node)
        return self.leaf_class[node]


def _impurity_from_counts(counts: np.ndarray, impurity: str) -> np.ndarray:
    """counts [..., C] -> impurity [...] (gini or entropy)."""
    n = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(n, 1)
    if impurity == "entropy":
        with np.errstate(divide="ignore", invalid="ignore"):
            h = -np.where(p > 0, p * np.log2(p), 0.0).sum(axis=-1)
        return h
    return 1.0 - (p * p).sum(axis=-1)


def _best_split(X: np.ndarray, y: np.ndarray, n_classes: int,
                feat_idx: np.ndarray, impurity: str, max_bins: int
                ) -> Optional[Tuple[int, float]]:
    """Best (feature, threshold) by weighted impurity decrease, scoring
    EVERY cut of each candidate feature in one prefix-count pass."""
    n = len(y)
    onehot = np.eye(n_classes, dtype=np.float64)[y]
    total = onehot.sum(axis=0)
    parent_imp = float(_impurity_from_counts(total, impurity))
    if parent_imp <= 0:
        return None
    best: Optional[Tuple[float, int, float]] = None
    for f in feat_idx:
        xs = X[:, f]
        order = np.argsort(xs, kind="stable")
        xsorted = xs[order]
        left = np.cumsum(onehot[order], axis=0)        # [n, C]
        # cut i = left gets rows 0..i; valid only between distinct values
        valid = xsorted[:-1] < xsorted[1:]
        if not valid.any():
            continue
        cuts = np.nonzero(valid)[0]
        if len(cuts) > max_bins:                       # bin the cut set
            cuts = cuts[np.linspace(0, len(cuts) - 1, max_bins,
                                    dtype=np.int64)]
        nl = (cuts + 1).astype(np.float64)
        lc = left[cuts]
        rc = total[None, :] - lc
        gain = parent_imp - (
            nl * _impurity_from_counts(lc, impurity)
            + (n - nl) * _impurity_from_counts(rc, impurity)) / n
        gx = int(np.argmax(gain))
        if gain[gx] > 1e-12:
            t = float((xsorted[cuts[gx]] + xsorted[cuts[gx] + 1]) / 2.0)
            if best is None or gain[gx] > best[0]:
                best = (float(gain[gx]), int(f), t)
    if best is None:
        return None
    return best[1], best[2]


def _n_sub_features(strategy: str, d: int) -> int:
    """MLlib featureSubsetStrategy semantics: 'auto' = sqrt for
    classification; 'all', 'sqrt', 'log2', 'onethird' as named.
    Unknown strategies raise, as MLlib's enum validation does."""
    s = strategy.lower()
    if s in ("auto", "sqrt"):
        return max(1, int(np.sqrt(d)))
    if s == "log2":
        return max(1, int(np.log2(d)))
    if s == "onethird":
        return max(1, d // 3)
    if s == "all":
        return d
    raise ValueError(
        f"unsupported feature_subset_strategy {strategy!r}; use "
        "auto|all|sqrt|log2|onethird")


def _grow(X: np.ndarray, y: np.ndarray, n_classes: int,
          rng: np.random.Generator, max_depth: int, max_bins: int,
          n_sub: int, impurity: str) -> _Tree:
    feature: List[int] = []
    threshold: List[float] = []
    left: List[int] = []
    right: List[int] = []
    leaf_class: List[int] = []

    def node(idx: np.ndarray, depth: int) -> int:
        me = len(feature)
        counts = np.bincount(y[idx], minlength=n_classes)
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        leaf_class.append(int(np.argmax(counts)))
        if depth >= max_depth or len(idx) < 2:
            return me
        feats = rng.choice(X.shape[1], size=n_sub, replace=False)
        split = _best_split(X[idx], y[idx], n_classes, feats, impurity,
                            max_bins)
        if split is None:
            return me
        f, t = split
        go_left = X[idx, f] <= t
        if not go_left.any() or go_left.all():
            return me
        feature[me] = f
        threshold[me] = t
        left[me] = node(idx[go_left], depth + 1)
        right[me] = node(idx[~go_left], depth + 1)
        return me

    node(np.arange(len(y)), 0)
    return _Tree(np.asarray(feature, dtype=np.int32),
                 np.asarray(threshold, dtype=np.float64),
                 np.asarray(left, dtype=np.int32),
                 np.asarray(right, dtype=np.int32),
                 np.asarray(leaf_class, dtype=np.int32))


@dataclasses.dataclass
class RandomForestModel:
    """Majority-vote forest (RandomForestModel.predict analog)."""

    trees: List[_Tree]
    n_classes: int

    def predict(self, features) -> float:
        return float(self.predict_batch(
            np.asarray(features, dtype=np.float64)[None, :])[0])

    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        votes = np.zeros((len(X), self.n_classes), dtype=np.int64)
        for t in self.trees:
            votes[np.arange(len(X)), t.predict(X)] += 1
        return votes.argmax(axis=1).astype(np.float64)


def train_classifier(X: np.ndarray, y: np.ndarray, *,
                     num_classes: int, num_trees: int = 10,
                     feature_subset_strategy: str = "auto",
                     impurity: str = "gini", max_depth: int = 5,
                     max_bins: int = 32,
                     seed: Optional[int] = None) -> RandomForestModel:
    """``RandomForest.trainClassifier`` parity entry: bootstrap-sampled,
    feature-subset trees, majority vote."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.int64)
    if X.ndim != 2 or len(X) != len(y):
        raise ValueError(f"bad shapes: X {X.shape}, y {y.shape}")
    if len(X) == 0:
        raise ValueError("cannot train a forest on zero samples")
    if y.min() < 0 or y.max() >= num_classes:
        raise ValueError(
            f"labels must be in [0, {num_classes}); got "
            f"[{y.min()}, {y.max()}]")
    if impurity not in ("gini", "entropy"):
        raise ValueError(f"unsupported impurity {impurity!r}")
    if not 1 <= max_depth <= 30:  # MLlib's own depth cap
        raise ValueError(f"max_depth must be in [1, 30], got {max_depth}")
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    if max_bins < 2:
        raise ValueError(f"max_bins must be >= 2, got {max_bins}")
    rng = np.random.default_rng(seed)
    n_sub = _n_sub_features(feature_subset_strategy, X.shape[1])
    trees = []
    for _ in range(num_trees):
        boot = rng.integers(0, len(X), size=len(X))
        trees.append(_grow(X[boot], y[boot], num_classes, rng, max_depth,
                           max_bins, n_sub, impurity))
    return RandomForestModel(trees, num_classes)
