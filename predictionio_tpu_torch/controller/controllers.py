"""Data-source, preparator and serving flavors: the port's copy of
``PDataSource``, ``PPreparator``, ``IdentityPreparator``, ``LServing``
and ``LFirstServing`` from ``predictionio_tpu/controller/controllers.py``."""

from __future__ import annotations

import abc
from typing import Any, Sequence

from predictionio_tpu_torch.core.base import (
    BaseDataSource,
    BasePreparator,
    BaseServing,
)


class PDataSource(BaseDataSource):
    """Parallel data source: ``read_training(ctx)`` returns TD."""

    @abc.abstractmethod
    def read_training(self, ctx: Any) -> Any: ...

    def read_training_base(self, ctx):
        return self.read_training(ctx)


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
