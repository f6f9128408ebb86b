"""FakeWorkflow: run an arbitrary compute function through the eval entry.

The port's copy of ``predictionio_tpu/workflow/fake.py`` (the
reference's ``FakeWorkflow.scala``): a tool that lets engine authors run
any function of the compute context under ``pio eval``, with the
framework's context and metadata plumbing. The function takes the
:class:`~predictionio_tpu_torch.core.context.ComputeContext`.
"""

from __future__ import annotations

from typing import Callable

from predictionio_tpu_torch.controller import (
    Engine,
    EngineParams,
    LFirstServing,
    LAlgorithm,
    LDataSource,
    LIdentityPreparator,
)
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_tpu_torch.core.base import BaseEvaluator, BaseEvaluatorResult
from predictionio_tpu_torch.core.context import ComputeContext


class _FakeDataSource(LDataSource):
    """Yields a single empty eval set so the pipeline runs once
    (FakeWorkflow.scala:36-41)."""

    def read_training(self):
        return None

    def read_eval(self):
        return [(None, None, [(None, None)])]


class _FakeAlgorithm(LAlgorithm):
    def train(self, pd):
        return None

    def predict(self, model, query):
        return None


class _FakeEvaluatorResult(BaseEvaluatorResult):
    """no_save: the run leaves no evaluation record or best.json behind
    (FakeWorkflow.scala:44-50 — FakeEvalResult with noSave=true)."""

    no_save = True

    def to_one_liner(self) -> str:
        return "FakeRun completed"


class _FakeEvaluator(BaseEvaluator):
    """Calls the user function exactly once (FakeWorkflow.scala:52-71)."""

    def __init__(self, fn: Callable[[ComputeContext], None]):
        self.fn = fn

    def evaluate_base(self, ctx, evaluation, eval_data,
                      params) -> _FakeEvaluatorResult:
        self.fn(ctx)
        return _FakeEvaluatorResult()


class FakeRun(Evaluation, EngineParamsGenerator):
    """``FakeRun(fn)`` — an Evaluation+params-generator that just
    executes ``fn(ctx)`` (FakeWorkflow.scala:84-106). Run it through
    ``pio eval`` / run_evaluation like any other Evaluation."""

    def __init__(self, fn: Callable[[ComputeContext], None]):
        Evaluation.__init__(self)
        EngineParamsGenerator.__init__(self)
        engine = Engine(
            _FakeDataSource,
            LIdentityPreparator,
            {"": _FakeAlgorithm},
            LFirstServing,
        )
        self.engine_evaluator = (engine, _FakeEvaluator(fn))
        self.engine_params_list = [EngineParams()]
