"""Base contracts of the DASE pipeline, the subset serving needs.

The port's copy of ``predictionio_tpu/core/base.py``: ``Params``, the
controller base with its one ``params`` argument, ``BaseAlgorithm`` and
``BaseServing``. The data-source, preparator and evaluator bases come
with the slices that port training and evaluation.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple


class Params:
    """Marker base for controller hyper-parameter bundles. Use
    ``@dataclass`` subclasses."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    """No parameters."""


class AbstractDoer:
    """Controllers are constructed with exactly one ``params`` argument.
    Subclasses may declare ``params_class`` for typed JSON extraction."""

    params_class: Optional[type] = None

    def __init__(self, params: Optional[Params] = None):
        self.params = params if params is not None else EmptyParams()


def Doer(clazz: type, params: Optional[Params] = None) -> Any:
    """Instantiate a controller with its params."""
    return clazz(params)


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
