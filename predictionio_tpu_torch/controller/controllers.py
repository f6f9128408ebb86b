"""Serving flavors: the port's copy of ``LServing`` / ``LFirstServing``
from ``predictionio_tpu/controller/controllers.py``."""

from __future__ import annotations

import abc
from typing import Any, Sequence

from predictionio_tpu_torch.core.base import BaseServing


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
