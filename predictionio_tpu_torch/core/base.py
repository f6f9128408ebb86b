"""Base contracts of the DASE pipeline.

The port's copy of ``predictionio_tpu/core/base.py``: ``Params``, the
workflow controls (``WorkflowParams``, the stop-after interruptions,
``run_sanity_check``), the persistence markers (``RETRAIN``,
``PersistentModelManifest``), the controller base with its one
``params`` argument, the data-source (training and evaluation reads),
preparator, algorithm and serving bases, and the evaluator bases
(``BaseEvaluator``, ``BaseEvaluatorResult``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable


class Params:
    """Marker base for controller hyper-parameter bundles. Use
    ``@dataclass`` subclasses."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """No parameters."""


@dataclasses.dataclass
class WorkflowParams:
    """Training-process controls: ``stop_after_read`` /
    ``stop_after_prepare`` interrupt the train dataflow after that
    stage; ``skip_sanity_check`` skips the data and model checks;
    ``batch`` is the run's label. ``eval_parallelism`` is the worker threads of a param-set evaluation
    sweep: 0 picks a CPU-count default (so controllers and metrics must
    tolerate concurrent param sets), 1 forces a serial sweep."""

    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    eval_parallelism: int = 0


class TrainingInterruption(Exception):
    """Base of the deliberate workflow interruptions."""


class StopAfterReadInterruption(TrainingInterruption):
    pass


class StopAfterPrepareInterruption(TrainingInterruption):
    pass


class _Retrain:
    """Sentinel: the model was not persisted; retrain at deploy."""

    _instance: Optional["_Retrain"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "RETRAIN"

    def __reduce__(self):  # pickles to the singleton
        return (_Retrain, ())


RETRAIN = _Retrain()


@dataclasses.dataclass(frozen=True)
class PersistentModelManifest:
    """Stored in place of a model that saved itself; ``class_path`` is
    ``module:Class`` of its :class:`~predictionio_tpu_torch.controller.
    persistent.PersistentModel`."""

    class_path: str


@runtime_checkable
class SanityCheck(Protocol):
    """Objects that check themselves: ``sanity_check`` raises on bad
    data."""

    def sanity_check(self) -> None: ...


def run_sanity_check(obj: Any) -> None:
    """Run the object's check iff it has one."""
    if isinstance(obj, SanityCheck):
        obj.sanity_check()


class AbstractDoer:
    """Controllers are constructed with exactly one ``params`` argument.
    Subclasses may declare ``params_class`` for typed JSON extraction."""

    params_class: Optional[type] = None

    def __init__(self, params: Optional[Params] = None):
        self.params = params if params is not None else EmptyParams()


def Doer(clazz: type, params: Optional[Params] = None) -> Any:
    """Instantiate a controller with its params."""
    return clazz(params)


class BaseDataSource(AbstractDoer, abc.ABC):
    """Reads the training and the evaluation data."""

    @abc.abstractmethod
    def read_training_base(self, ctx: Any) -> Any:
        """Return TD."""

    def read_eval_base(self, ctx: Any
                       ) -> Sequence[Tuple[Any, Any, Sequence[Tuple[Any, Any]]]]:
        """Return the eval sets ``[(TD, EI, [(Q, A), ...]), ...]``;
        default none."""
        return []


class BasePreparator(AbstractDoer, abc.ABC):
    """TD -> PD."""

    @abc.abstractmethod
    def prepare_base(self, ctx: Any, td: Any) -> Any: ...


class BaseAlgorithm(AbstractDoer, abc.ABC):
    """The algorithm contract: train, batch predict, predict."""

    @abc.abstractmethod
    def train_base(self, ctx: Any, pd: Any) -> Any:
        """PD -> model."""

    @abc.abstractmethod
    def batch_predict_base(self, ctx: Any, model: Any,
                           indexed_queries: Sequence[Tuple[int, Any]]
                           ) -> List[Tuple[int, Any]]:
        """Predict for indexed queries (the evaluation path)."""

    @abc.abstractmethod
    def predict_base(self, model: Any, query: Any) -> Any:
        """Single-query predict (the serving path)."""

    def make_persistent_model(self, ctx: Any, model_id: str,
                              algo_params: Params, model: Any) -> Any:
        """The trained model's stored form: the model itself (pickled),
        a :class:`PersistentModelManifest` (it saved itself) or
        ``RETRAIN`` (train again at deploy, the default)."""
        return RETRAIN

    @property
    def query_class(self) -> Optional[type]:
        """Query type for JSON extraction at serving time; None means
        raw dict queries."""
        return getattr(self, "query_cls", None)


class BaseServing(AbstractDoer, abc.ABC):
    """Query supplement and the combination of the predictions."""

    def supplement_base(self, query: Any) -> Any:
        return query

    @abc.abstractmethod
    def serve_base(self, query: Any, predictions: Sequence[Any]) -> Any: ...


class BaseEvaluatorResult:
    """Evaluation output renderings."""

    #: When True the result is not stored (FakeRun's).
    no_save: bool = False

    def to_one_liner(self) -> str:
        return ""

    def to_html(self) -> str:
        return ""

    def to_json(self) -> str:
        return ""


class BaseEvaluator(AbstractDoer, abc.ABC):
    """Scores the evaluation output of every param set."""

    @abc.abstractmethod
    def evaluate_base(self, ctx: Any, evaluation: Any,
                      engine_eval_data_set: Sequence[Tuple[Any, Any]],
                      params: WorkflowParams) -> BaseEvaluatorResult: ...
