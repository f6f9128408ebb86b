"""Metric hierarchy — scoring (Q, P, A) tuples from evaluation runs.

The port's copy of ``predictionio_tpu/controller/metrics.py`` (the
reference's ``Metric.scala``): the evaluation data are host lists, and
``stdev`` is the population one (variance = M2/n), as Spark's
``StatCounter`` computes it.
"""

from __future__ import annotations

import abc
import math
from typing import Any, List, Sequence, Tuple


# One evaluation run's output: [(EI, [(Q, P, A), ...]), ...]
EvalDataSet = Sequence[Tuple[Any, Sequence[Tuple[Any, Any, Any]]]]


class Metric(abc.ABC):
    """Scores a full evaluation data set (Metric.scala:36-55).

    ``compare`` orders results; bigger-is-better by default, matching the
    reference's implicit Ordering on Double.
    """

    @property
    def header(self) -> str:
        """Display name (Metric.scala:47)."""
        return type(self).__name__

    @abc.abstractmethod
    def calculate(self, ctx: Any,
                  eval_data_set: EvalDataSet) -> Any: ...

    def compare(self, r0: Any, r1: Any) -> int:
        """Ordering of metric results (Metric.scala:54)."""
        return (r0 > r1) - (r0 < r1)


def _qpa_scores(metric: "QPAMetric",
                eval_data_set: EvalDataSet,
                optional: bool) -> List[float]:
    scores: List[float] = []
    for _ei, qpas in eval_data_set:
        for q, p, a in qpas:
            s = metric.calculate_qpa(q, p, a)
            if optional:
                if s is not None:
                    scores.append(float(s))
            else:
                scores.append(float(s))
    return scores


class QPAMetric(Metric):
    """Metric defined by a per-(Q, P, A) score (QPAMetric trait,
    Metric.scala:246-262)."""

    @abc.abstractmethod
    def calculate_qpa(self, q: Any, p: Any, a: Any) -> Any: ...


class AverageMetric(QPAMetric):
    """Global mean of per-tuple scores (Metric.scala:96-109)."""

    def calculate(self, ctx, eval_data_set) -> float:
        scores = _qpa_scores(self, eval_data_set, optional=False)
        return sum(scores) / len(scores) if scores else float("nan")


class OptionAverageMetric(QPAMetric):
    """Mean over non-None scores only (Metric.scala:111-133)."""

    def calculate(self, ctx, eval_data_set) -> float:
        scores = _qpa_scores(self, eval_data_set, optional=True)
        return sum(scores) / len(scores) if scores else float("nan")


def _population_stdev(scores: Sequence[float]) -> float:
    if not scores:
        return float("nan")
    mean = sum(scores) / len(scores)
    return math.sqrt(sum((s - mean) ** 2 for s in scores) / len(scores))


class StdevMetric(QPAMetric):
    """Population stdev of per-tuple scores (Metric.scala:135-155)."""

    def calculate(self, ctx, eval_data_set) -> float:
        return _population_stdev(_qpa_scores(self, eval_data_set,
                                             optional=False))


class OptionStdevMetric(QPAMetric):
    """Population stdev over non-None scores (Metric.scala:157-177)."""

    def calculate(self, ctx, eval_data_set) -> float:
        return _population_stdev(_qpa_scores(self, eval_data_set,
                                             optional=True))


class SumMetric(QPAMetric):
    """Sum of per-tuple scores (Metric.scala:179-205)."""

    def calculate(self, ctx, eval_data_set) -> Any:
        total: Any = 0
        for _ei, qpas in eval_data_set:
            for q, p, a in qpas:
                total = total + self.calculate_qpa(q, p, a)
        return total


class ZeroMetric(Metric):
    """Always 0.0 — placeholder during evaluation development
    (Metric.scala:207-219)."""

    def calculate(self, ctx, eval_data_set) -> float:
        return 0.0
