"""Data-source, preparator and serving flavors: the port's copy of
``PDataSource``, ``LDataSource``, ``PPreparator``, ``LPreparator``,
``IdentityPreparator`` (and its ``PIdentityPreparator`` and
``LIdentityPreparator`` aliases), ``LServing``, ``LFirstServing``,
``LAverageServing`` and ``TwoStageServing`` from
``predictionio_tpu/controller/controllers.py``."""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.base import (
    BaseDataSource,
    BasePreparator,
    BaseServing,
    Params,
)


class PDataSource(BaseDataSource):
    """Parallel data source: ``read_training(ctx)`` returns TD,
    ``read_eval(ctx)`` the eval sets ``[(TD, EI, [(Q, A), ...]), ...]``
    (none by default)."""

    @abc.abstractmethod
    def read_training(self, ctx: Any) -> Any: ...

    def read_eval(self, ctx: Any
                  ) -> Sequence[Tuple[Any, Any, Sequence[Tuple[Any, Any]]]]:
        return []

    def read_training_base(self, ctx):
        return self.read_training(ctx)

    def read_eval_base(self, ctx):
        return self.read_eval(ctx)


class LDataSource(BaseDataSource):
    """Local data source: the reads take no context."""

    @abc.abstractmethod
    def read_training(self) -> Any: ...

    def read_eval(self) -> Sequence[Tuple[Any, Any, Sequence[Tuple[Any, Any]]]]:
        return []

    def read_training_base(self, ctx):
        return self.read_training()

    def read_eval_base(self, ctx):
        return self.read_eval()


class PPreparator(BasePreparator):
    """Parallel preparator: ``prepare(ctx, td)`` returns PD."""

    @abc.abstractmethod
    def prepare(self, ctx: Any, td: Any) -> Any: ...

    def prepare_base(self, ctx, td):
        return self.prepare(ctx, td)


class LPreparator(BasePreparator):
    """Local preparator: ``prepare(td)`` returns PD, no context."""

    @abc.abstractmethod
    def prepare(self, td: Any) -> Any: ...

    def prepare_base(self, ctx, td):
        return self.prepare(td)


class IdentityPreparator(BasePreparator):
    """TD passes through unchanged."""

    def prepare_base(self, ctx, td):
        return td


PIdentityPreparator = IdentityPreparator
LIdentityPreparator = IdentityPreparator


class LServing(BaseServing):
    """Local serving."""

    def supplement(self, query: Any) -> Any:
        """Pre-predict query enrichment; identity by default."""
        return query

    @abc.abstractmethod
    def serve(self, query: Any, predictions: Sequence[Any]) -> Any: ...

    def supplement_base(self, query):
        return self.supplement(query)

    def serve_base(self, query, predictions):
        return self.serve(query, predictions)


class LFirstServing(LServing):
    """Returns the first algorithm's prediction."""

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        return predictions[0]


class LAverageServing(LServing):
    """Averages numeric predictions."""

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        ps: List[float] = [float(p) for p in predictions]
        return sum(ps) / len(ps)


class TwoStageServing(LServing):
    """Retrieval + re-rank over ``EngineParams.algorithms = [retrieval,
    reranker]``: the FIRST algorithm retrieves candidates, the LAST
    re-scores them. Two modes, one contract:

    * **Fused (live deployments).** ``workflow.create_server`` builds
      one :class:`~predictionio_tpu_torch.ops.twostage.TwoStageTopK`
      store over both models' tables and calls :meth:`bind_fused` with
      a route that serves whole queries through it; ``serve_query``
      then dispatches once per query batch and :meth:`serve` never
      runs.
    * **Unbound (the evaluation pipeline).** :meth:`serve` composes on
      the host: the first prediction's items are the candidates,
      re-ordered by the last prediction's scores (candidates the
      re-ranker did not score keep their retrieval order, after every
      scored one).

    Both predictions carry ``item_scores`` (the recommendation and
    sequentialrec templates' ``PredictedResult``)."""

    def __init__(self, params: Optional[Params] = None) -> None:
        super().__init__(params)
        self._fused = None

    @property
    def fused_bound(self) -> bool:
        """Whether a fused device route is bound (live deployments)."""
        return self._fused is not None

    def bind_fused(self, route) -> None:
        """Install the fused route: a callable ``query ->
        PredictedResult`` through the two-stage store."""
        self._fused = route

    def serve_fused(self, query: Any) -> Any:
        """Serve one query through the bound fused route."""
        return self._fused(query)

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        head = predictions[0]
        if len(predictions) < 2:
            return head
        tail = predictions[-1]
        rescores = {s.item: float(s.score)
                    for s in getattr(tail, "item_scores", ())}
        candidates = list(getattr(head, "item_scores", ()))
        scored = [s for s in candidates if s.item in rescores]
        unscored = [s for s in candidates if s.item not in rescores]
        scored.sort(key=lambda s: -rescores[s.item])
        reranked = tuple(
            [dataclasses.replace(s, score=rescores[s.item])
             for s in scored] + unscored)
        return dataclasses.replace(head, item_scores=reranked)
