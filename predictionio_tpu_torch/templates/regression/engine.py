"""Local linear-regression engine — the experimental L-flavor template
with a real Preparator and an eval metric.

The port's copy of ``predictionio_tpu/templates/regression/engine.py``.

Capability parity with the reference's
``examples/experimental/scala-local-regression/Run.scala``:

- ``LocalDataSource`` reads ``y x1 x2 ...`` lines from a file; the one
  eval set pairs every feature row with its target (``Run.scala:37-51``)
- ``LocalPreparator`` drops rows whose index ≡ k (mod n) when n > 0 —
  the template's toy train/test split knob (``Run.scala:55-67``)
- ``LocalAlgorithm`` fits ordinary least squares (the reference calls
  nak's ``LinearRegression.regress``; here ``np.linalg.lstsq``); the
  model is the coefficient vector, predict is a dot product
  (``Run.scala:69-86``)
- ``MeanSquareError`` scores (query, prediction, actual) triples
  (the reference wires ``classOf[MeanSquareError]``, ``Run.scala:135``)

Queries arrive as ``{"features": [...]}`` objects (the reference's
custom ``VectorSerializer`` accepted bare arrays, ``Run.scala:91-103``,
but this framework's query server takes JSON objects).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    LAlgorithm,
    LDataSource,
    LFirstServing,
    LPreparator,
    Params,
)
from predictionio_tpu_torch.controller.metrics import AverageMetric


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    filepath: str


@dataclasses.dataclass
class TrainingData:
    """x [n, d], y [n] (TrainingData at Run.scala:29-32)."""

    x: np.ndarray
    y: np.ndarray

    def sanity_check(self) -> None:
        assert len(self.x), "regression training data cannot be empty"
        assert len(self.x) == len(self.y), "misaligned x/y"


@dataclasses.dataclass(frozen=True)
class Query:
    """A feature vector; wire form ``{"features": [...]}``."""

    features: Tuple[float, ...] = ()


class LocalDataSource(LDataSource):
    """``y x1 x2 ...`` file -> one eval set (Run.scala:34-51)."""

    params_class = DataSourceParams

    def _read(self) -> TrainingData:
        p: DataSourceParams = self.params
        xs: List[List[float]] = []
        ys: List[float] = []
        with open(p.filepath, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                ys.append(float(parts[0]))
                xs.append([float(v) for v in parts[1:]])
        return TrainingData(np.asarray(xs, dtype=np.float64),
                            np.asarray(ys, dtype=np.float64))

    def read_training(self) -> TrainingData:
        return self._read()

    def read_eval(self):
        td = self._read()
        qa = [(Query(tuple(row)), float(target))
              for row, target in zip(td.x, td.y)]
        return [(td, "The One", qa)]


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    """n = 0 keeps everything; n > 0 drops rows with index % n == k
    (Run.scala:53-55)."""

    n: int = 0
    k: int = 0


class LocalPreparator(LPreparator):
    params_class = PreparatorParams

    def prepare(self, td: TrainingData) -> TrainingData:
        p: PreparatorParams = self.params
        if p.n <= 0:
            return td
        keep = np.arange(len(td.y)) % p.n != p.k
        return TrainingData(td.x[keep], td.y[keep])


class LocalAlgorithm(LAlgorithm):
    """OLS fit; model = coefficient vector (Run.scala:69-86)."""

    query_cls = Query

    def train(self, td: TrainingData) -> np.ndarray:
        coef, *_ = np.linalg.lstsq(td.x, td.y, rcond=None)
        return coef

    def predict(self, model: np.ndarray, query: Query) -> float:
        return float(np.dot(model, np.asarray(query.features,
                                              dtype=np.float64)))


class MeanSquareError(AverageMetric):
    """MSE over (Q, P, A) triples (controller MeanSquareError analog the
    reference wires as its evaluator, Run.scala:135)."""

    @property
    def header(self) -> str:
        return "MeanSquareError"

    def calculate_qpa(self, q, p, a) -> float:
        return float((p - a) ** 2)

    def compare(self, a: float, b: float) -> int:
        # smaller error wins (AverageMetric defaults to bigger-is-better)
        return (b > a) - (b < a)


def engine_factory() -> Engine:
    """RegressionEngineFactory (Run.scala:105-113)."""
    return Engine(
        LocalDataSource,
        LocalPreparator,
        {"": LocalAlgorithm},
        LFirstServing,
    )
