"""Data-source, preparator and serving flavors: the port's copy of
``PDataSource``, ``LDataSource``, ``PPreparator``,
``IdentityPreparator`` (and its ``LIdentityPreparator`` alias),
``LServing`` and ``LFirstServing`` from ``predictionio_tpu/controller/controllers.py``."""

from __future__ import annotations

import abc
from typing import Any, Sequence, Tuple

from predictionio_tpu_torch.core.base import (
    BaseDataSource,
    BasePreparator,
    BaseServing,
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


class IdentityPreparator(BasePreparator):
    """TD passes through unchanged."""

    def prepare_base(self, ctx, td):
        return td


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
