"""Classification engine: ``$set`` entity properties -> Naive Bayes label.

The port's copy of ``predictionio_tpu/templates/classification/engine.py``.

Capability parity with ``examples/scala-parallel-classification/
add-algorithm``:

- DataSource aggregates user properties, requiring ``plan`` (the label)
  and ``attr0..attr2`` (features) — ``DataSource.scala:31-65``
- ``NaiveBayesAlgorithm`` (P2L) = multinomial NB with additive smoothing,
  numerically identical to MLlib ``NaiveBayes.train(lambda)``
  (``NaiveBayesAlgorithm.scala:16-23``): one vectorized count + log
  instead of an RDD aggregate
- a second registered algorithm (``categorical``, e2
  CategoricalNaiveBayes over stringified features) mirrors the
  template's multi-algorithm "add-algorithm" variant
- k-fold ``read_eval`` via e2 ``split_data`` + an ``Accuracy`` metric
  (the template's evaluation setup)
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    LFirstServing,
    P2LAlgorithm,
    Params,
    PDataSource,
    PIdentityPreparator,
)
from predictionio_tpu_torch.controller.metrics import AverageMetric
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.e2 import (
    CategoricalNaiveBayes,
    LabeledPoint as E2LabeledPoint,
    split_data,
)

FEATURE_PROPS = ("attr0", "attr1", "attr2")
LABEL_PROP = "plan"


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str
    channel_name: Optional[str] = None
    eval_k: int = 3


@dataclasses.dataclass(frozen=True)
class LabeledPoint:
    label: float
    features: Tuple[float, ...]


@dataclasses.dataclass
class TrainingData:
    labeled_points: List[LabeledPoint]

    def sanity_check(self) -> None:
        assert self.labeled_points, (
            "labeled_points in TrainingData cannot be empty. Please check "
            "if DataSource generates TrainingData correctly.")


@dataclasses.dataclass(frozen=True)
class Query:
    features: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: float


@dataclasses.dataclass(frozen=True)
class ActualResult:
    label: float


@dataclasses.dataclass(frozen=True)
class EmptyEvalInfo:
    pass


class EventDataSource(PDataSource):
    """Aggregated user properties -> labeled points
    (DataSource.scala:31-65: required plan/attr0/attr1/attr2)."""

    params_class = DataSourceParams

    def _labeled_points(self) -> List[LabeledPoint]:
        p: DataSourceParams = self.params
        props = PEventStore.aggregate_properties(
            app_name=p.app_name,
            channel_name=p.channel_name,
            entity_type="user",
            required=[LABEL_PROP, *FEATURE_PROPS],
        )
        return [
            LabeledPoint(
                label=pm.get(LABEL_PROP, float),
                features=tuple(pm.get(a, float) for a in FEATURE_PROPS),
            )
            for pm in props.values()
        ]

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        return TrainingData(self._labeled_points())

    def read_eval(self, ctx: ComputeContext):
        """k-fold CV via e2 split_data (CrossValidation.scala:33-64)."""
        p: DataSourceParams = self.params
        return split_data(
            p.eval_k,
            self._labeled_points(),
            EmptyEvalInfo(),
            TrainingData,
            lambda lp: Query(features=lp.features),
            lambda lp: ActualResult(label=lp.label),
        )


@dataclasses.dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0


@dataclasses.dataclass
class NaiveBayesModel:
    """Multinomial NB: log priors pi [L], log likelihood theta [L, F],
    label values [L] (the MLlib NaiveBayesModel fields)."""

    labels: np.ndarray   # [L] float
    pi: np.ndarray       # [L] float
    theta: np.ndarray    # [L, F] float

    def predict_scores(self, features: np.ndarray) -> np.ndarray:
        """[..., F] -> [..., L]: pi + x·thetaᵀ — one matmul, batch-ready."""
        return self.pi + np.asarray(features, dtype=np.float64) @ self.theta.T

    def sanity_check(self) -> None:
        assert np.isfinite(self.pi).all() and np.isfinite(self.theta).all()


class NaiveBayesAlgorithm(P2LAlgorithm):
    """MLlib NaiveBayes.train parity: pi_l = log(n_l + λ) -
    log(n + L·λ); theta_lj = log(sum_j x_j + λ) - log(sum_all + F·λ)."""

    params_class = NaiveBayesParams
    query_cls = Query

    def train(self, ctx: ComputeContext, pd: TrainingData) -> NaiveBayesModel:
        lam = self.params.lambda_
        pts = pd.labeled_points
        X = np.asarray([p.features for p in pts], dtype=np.float64)
        y = np.asarray([p.label for p in pts], dtype=np.float64)
        if np.any(X < 0):
            raise ValueError("multinomial NB requires non-negative features")
        labels = np.unique(y)
        L, F = len(labels), X.shape[1]
        codes = np.searchsorted(labels, y)
        counts = np.bincount(codes, minlength=L).astype(np.float64)
        pi = np.log(counts + lam) - np.log(len(pts) + L * lam)
        sums = np.zeros((L, F), dtype=np.float64)
        np.add.at(sums, codes, X)
        theta = (np.log(sums + lam)
                 - np.log(sums.sum(axis=1, keepdims=True) + F * lam))
        return NaiveBayesModel(labels=labels, pi=pi, theta=theta)

    def predict(self, model: NaiveBayesModel, query: Query) -> PredictedResult:
        scores = model.predict_scores(
            np.asarray(query.features, dtype=np.float64))
        return PredictedResult(label=float(model.labels[np.argmax(scores)]))

    def batch_predict(self, ctx: ComputeContext, model: NaiveBayesModel,
                      indexed_queries: Sequence[Tuple[int, Query]]):
        """One batched matmul for the whole eval query set (replaces the
        reference's default per-query mapValues)."""
        if not indexed_queries:
            return []
        X = np.asarray([q.features for _, q in indexed_queries],
                       dtype=np.float64)
        best = np.argmax(model.predict_scores(X), axis=1)
        return [
            (qx, PredictedResult(label=float(model.labels[b])))
            for (qx, _), b in zip(indexed_queries, best)
        ]


class CategoricalNBAlgorithm(P2LAlgorithm):
    """Second algorithm (the "add-algorithm" variant slot): e2 categorical
    NB over stringified feature values."""

    params_class = None
    query_cls = Query

    def train(self, ctx: ComputeContext, pd: TrainingData):
        points = [
            E2LabeledPoint(label=str(p.label),
                           features=tuple(str(f) for f in p.features))
            for p in pd.labeled_points
        ]
        return CategoricalNaiveBayes.train(points)

    def predict(self, model, query: Query) -> PredictedResult:
        label = model.predict(tuple(str(f) for f in query.features))
        return PredictedResult(label=float(label))


@dataclasses.dataclass(frozen=True)
class RandomForestParams(Params):
    """RandomForestAlgorithmParams 1:1
    (add-algorithm/src/main/scala/RandomForestAlgorithm.scala:12-19)."""

    num_classes: int = 2
    num_trees: int = 10
    feature_subset_strategy: str = "auto"
    impurity: str = "gini"
    max_depth: int = 5
    max_bins: int = 32
    seed: Optional[int] = None


class RandomForestAlgorithm(P2LAlgorithm):
    """Random forest over the same labeled points
    (RandomForestAlgorithm.scala:23-50; the MLlib dependency is replaced
    by e2/forest.py's vectorized implementation)."""

    params_class = RandomForestParams
    query_cls = Query

    def train(self, ctx: ComputeContext, pd: TrainingData):
        from predictionio_tpu_torch.e2.forest import train_classifier

        p: RandomForestParams = self.params
        X = np.asarray([lp.features for lp in pd.labeled_points],
                       dtype=np.float64)
        y_float = np.asarray([lp.label for lp in pd.labeled_points],
                             dtype=np.float64)
        y = y_float.astype(np.int64)
        if not (y == y_float).all():
            # int64 cast would silently truncate (e.g. label 1.5 -> 1)
            bad = sorted(set(y_float[y != y_float].tolist()))
            raise ValueError(
                f"random forest labels must be integers in "
                f"[0, num_classes); got non-integer labels {bad[:5]}")
        return train_classifier(
            X, y, num_classes=p.num_classes, num_trees=p.num_trees,
            feature_subset_strategy=p.feature_subset_strategy,
            impurity=p.impurity, max_depth=p.max_depth,
            max_bins=p.max_bins, seed=p.seed)

    def predict(self, model, query: Query) -> PredictedResult:
        return PredictedResult(label=model.predict(query.features))

    def batch_predict(self, ctx: ComputeContext, model,
                      indexed_queries) -> List[Tuple[int, Any]]:
        X = np.asarray([q.features for _, q in indexed_queries],
                       dtype=np.float64)
        labels = model.predict_batch(X)
        return [(qx, PredictedResult(label=float(lb)))
                for (qx, _), lb in zip(indexed_queries, labels)]


class Accuracy(AverageMetric):
    """Fraction of exact label matches (the template's evaluation metric)."""

    def calculate_qpa(self, q, p, a) -> float:
        return 1.0 if p.label == a.label else 0.0


def engine_factory() -> Engine:
    """ClassificationEngine (add-algorithm Engine.scala:60-68)."""
    return Engine(
        EventDataSource,
        PIdentityPreparator,
        {"naive": NaiveBayesAlgorithm,
         "categorical": CategoricalNBAlgorithm,
         "randomforest": RandomForestAlgorithm,
         "": NaiveBayesAlgorithm},
        LFirstServing,
    )
