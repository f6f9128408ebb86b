"""Evaluation & hyper-parameter tuning.

The port's copy of ``predictionio_tpu/controller/evaluation.py``.
Parity targets:
- ``Evaluation`` trait (``controller/Evaluation.scala:31-122``): couples an
  engine with an evaluator; assigning an (engine, metric) pair implies a
  ``MetricEvaluator`` writing ``best.json``.
- ``EngineParamsGenerator`` (``EngineParamsGenerator.scala:27-43``).
- ``MetricEvaluator`` (``MetricEvaluator.scala:190-246``): scores every
  EngineParams set, picks the best by ``metric.compare`` (first wins ties,
  reduce semantics ``:242-246``), optionally writes the winning variant
  JSON (``saveEngineJson`` ``:190-213``).

The reference scores param sets with Scala parallel collections
(``.par``, ``MetricEvaluator.scala:221-230``); scoring here is likewise
thread-parallel over param sets (``WorkflowParams.eval_parallelism``),
as is the heavy ``Engine.batch_eval`` sweep that feeds it.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.controller.engine import (
    Engine, EngineParams, params_to_dict,
)
from predictionio_tpu_torch.controller.metrics import Metric
from predictionio_tpu_torch.core.base import (
    BaseEvaluator, BaseEvaluatorResult, Params, WorkflowParams,
)

logger = logging.getLogger("pio.torch.evaluation")


@dataclasses.dataclass
class MetricScores:
    """Primary + secondary metric scores for one EngineParams
    (MetricEvaluator.scala:40-52)."""

    score: Any
    other_scores: Sequence[Any] = ()


@dataclasses.dataclass
class MetricEvaluatorResult(BaseEvaluatorResult):
    """Tuning outcome (MetricEvaluator.scala:55-107)."""

    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: Sequence[str]
    engine_params_scores: Sequence[Tuple[EngineParams, MetricScores]]
    output_path: Optional[str] = None

    def to_one_liner(self) -> str:
        return (f"Best Params Index: {self.best_idx} "
                f"Score: {self.best_score.score}")

    def to_json(self) -> str:
        return json.dumps({
            "bestScore": {"score": self.best_score.score,
                          "otherScores": list(self.best_score.other_scores)},
            "bestEngineParams": _engine_params_to_jsonable(
                self.best_engine_params),
            "bestIdx": self.best_idx,
            "metricHeader": self.metric_header,
            "otherMetricHeaders": list(self.other_metric_headers),
            "engineParamsScores": [
                {"engineParams": _engine_params_to_jsonable(ep),
                 "score": s.score, "otherScores": list(s.other_scores)}
                for ep, s in self.engine_params_scores],
            "outputPath": self.output_path,
        })

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s.score}</td>"
            f"<td><pre>{json.dumps(_engine_params_to_jsonable(ep))}</pre>"
            f"</td></tr>"
            for i, (ep, s) in enumerate(self.engine_params_scores))
        return (f"<h3>{self.metric_header}</h3>"
                f"<p>{self.to_one_liner()}</p>"
                f"<table><tr><th>#</th><th>score</th><th>params</th></tr>"
                f"{rows}</table>")

    def __str__(self) -> str:
        lines = [
            "MetricEvaluatorResult:",
            f"  # engine params evaluated: {len(self.engine_params_scores)}",
            "Optimal Engine Params:",
            f"  {json.dumps(_engine_params_to_jsonable(self.best_engine_params), indent=2)}",
            "Metrics:",
            f"  {self.metric_header}: {self.best_score.score}",
        ]
        lines += [f"  {h}: {s}" for h, s in
                  zip(self.other_metric_headers, self.best_score.other_scores)]
        if self.output_path:
            lines.append(
                f"The best variant params can be found in {self.output_path}")
        return "\n".join(lines)


def _name_params_to_jsonable(np: Tuple[str, Params]) -> dict:
    name, params = np
    return {"name": name, "params": params_to_dict(params)}


def _engine_params_to_jsonable(ep: EngineParams) -> dict:
    return {
        "datasource": _name_params_to_jsonable(ep.data_source_params),
        "preparator": _name_params_to_jsonable(ep.preparator_params),
        "algorithms": [_name_params_to_jsonable(np)
                       for np in ep.algorithm_params_list],
        "serving": _name_params_to_jsonable(ep.serving_params),
    }


class MetricEvaluator(BaseEvaluator):
    """Scores every (EngineParams, eval output) pair, picks the best
    (MetricEvaluator.scala:177-246)."""

    def __init__(self, metric: Metric,
                 other_metrics: Sequence[Metric] = (),
                 output_path: Optional[str] = None):
        super().__init__()
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path

    def save_engine_json(self, evaluation: Any,
                         engine_params: EngineParams,
                         output_path: str) -> None:
        """Write the winning variant as an engine.json the CLI can train
        with (MetricEvaluator.saveEngineJson, :190-213)."""
        if evaluation is not None:
            # module:QualName — the form load_engine_factory parses, so the
            # tune -> train handoff works (the reference stores the JVM
            # class name for the same reason).
            cls = type(evaluation)
            eval_name = f"{cls.__module__}:{cls.__qualname__}"
        else:
            eval_name = ""
        variant = {
            "id": f"{eval_name} {_dt.datetime.now(tz=_dt.timezone.utc).isoformat()}",
            "description": "",
            "engineFactory": eval_name,
            **_engine_params_to_jsonable(engine_params),
        }
        logger.info("Writing best variant params to disk (%s)...", output_path)
        with open(output_path, "w", encoding="utf-8") as f:
            json.dump(variant, f, indent=2)

    def evaluate_base(self, ctx: Any, evaluation: Any,
                      engine_eval_data_set: Sequence[Tuple[EngineParams, Any]],
                      params: WorkflowParams) -> MetricEvaluatorResult:
        if not engine_eval_data_set:
            raise ValueError(
                "MetricEvaluator needs at least one (EngineParams, eval "
                "output) pair; got an empty engine_eval_data_set")

        # thread-parallel scoring over param sets (the reference's `.par`
        # map, MetricEvaluator.scala:221-230); order preserved
        from predictionio_tpu_torch.utils.concurrency import (
            eval_workers, parallel_map,
        )

        def score_one(pair):
            engine_params, eval_data_set = pair
            return (engine_params, MetricScores(
                score=self.metric.calculate(ctx, eval_data_set),
                other_scores=[m.calculate(ctx, eval_data_set)
                              for m in self.other_metrics]))

        workers = eval_workers(
            params.eval_parallelism if params is not None else 0,
            len(engine_eval_data_set))
        scored: List[Tuple[EngineParams, MetricScores]] = parallel_map(
            score_one, engine_eval_data_set, workers)

        for idx, (ep, r) in enumerate(scored):
            logger.info("Iteration %d", idx)
            logger.info("EngineParams: %s",
                        json.dumps(_engine_params_to_jsonable(ep)))
            logger.info("Result: %r", r)

        # reduce keeping the earlier element on ties (>= 0 keeps x,
        # MetricEvaluator.scala:242-246)
        best_idx = 0
        for idx in range(1, len(scored)):
            if self.metric.compare(scored[best_idx][1].score,
                                   scored[idx][1].score) < 0:
                best_idx = idx
        best_engine_params, best_score = scored[best_idx]

        if self.output_path:
            self.save_engine_json(evaluation, best_engine_params,
                                  self.output_path)

        return MetricEvaluatorResult(
            best_score=best_score,
            best_engine_params=best_engine_params,
            best_idx=best_idx,
            metric_header=self.metric.header,
            other_metric_headers=[m.header for m in self.other_metrics],
            engine_params_scores=scored,
            output_path=self.output_path,
        )


class Evaluation:
    """Couples an Engine with an evaluator (Evaluation.scala:31-122).

    Subclasses set exactly one of:
    - ``engine_metric = (engine, metric)`` -> MetricEvaluator writing
      ``best.json`` (Evaluation.scala:88-97)
    - ``engine_metrics = (engine, metric, [other metrics])`` -> plain
      MetricEvaluator (``:104-122``)
    - ``engine_evaluator = (engine, evaluator)`` (``:52-70``)
    """

    def __init__(self):
        self._engine: Optional[Engine] = None
        self._evaluator: Optional[BaseEvaluator] = None

    @property
    def engine(self) -> Engine:
        if self._engine is None:
            raise AssertionError("Engine not set")
        return self._engine

    @property
    def evaluator(self) -> BaseEvaluator:
        if self._evaluator is None:
            raise AssertionError("Evaluator not set")
        return self._evaluator

    @property
    def engine_evaluator(self) -> Tuple[Engine, BaseEvaluator]:
        return self.engine, self.evaluator

    @engine_evaluator.setter
    def engine_evaluator(self, pair: Tuple[Engine, BaseEvaluator]) -> None:
        if self._evaluator is not None:
            raise AssertionError("Evaluator can be set at most once")
        self._engine, self._evaluator = pair

    @property
    def engine_metric(self) -> Tuple[Engine, Metric]:
        raise NotImplementedError("write-only (matches the reference)")

    @engine_metric.setter
    def engine_metric(self, pair: Tuple[Engine, Metric]) -> None:
        engine, metric = pair
        self.engine_evaluator = (
            engine, MetricEvaluator(metric, (), output_path="best.json"))

    @property
    def engine_metrics(self) -> Tuple[Engine, Metric, Sequence[Metric]]:
        raise NotImplementedError("write-only (matches the reference)")

    @engine_metrics.setter
    def engine_metrics(
            self, triple: Tuple[Engine, Metric, Sequence[Metric]]) -> None:
        engine, metric, others = triple
        self.engine_evaluator = (engine, MetricEvaluator(metric, others))


class EngineParamsGenerator:
    """Holds the tuning grid (EngineParamsGenerator.scala:27-43); set
    ``engine_params_list`` exactly once in the subclass constructor."""

    def __init__(self):
        self._ep_list: Optional[List[EngineParams]] = None

    @property
    def engine_params_list(self) -> List[EngineParams]:
        if self._ep_list is None:
            raise AssertionError("EngineParamsList not set")
        return self._ep_list

    @engine_params_list.setter
    def engine_params_list(self, l: Sequence[EngineParams]) -> None:
        if self._ep_list is not None:
            raise AssertionError("EngineParamsList can be set at most once")
        self._ep_list = list(l)
