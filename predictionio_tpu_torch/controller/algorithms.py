"""Algorithm flavors: the local and the parallel-to-local one.

The port's copy of ``LAlgorithm``, ``P2LAlgorithm`` and
``_persist_or_model`` from ``predictionio_tpu/controller/algorithms.py``:
the model lives on the host (a P2L model is served through the device),
``predict_base`` routes to the subclass's ``predict``, and the trained
model is stored as it is (or, for a :class:`~predictionio_tpu_torch.
controller.persistent.PersistentModel`, saves itself). Also
:func:`ordered_batch_results`, the ``batch_predict`` contract check the
bulk consumers share.
"""

from __future__ import annotations

import abc
from typing import Any, List, Sequence, Tuple

from predictionio_tpu_torch.controller.persistent import (
    PersistentModel,
    manifest_for,
)
from predictionio_tpu_torch.core.base import RETRAIN, BaseAlgorithm, Params


def ordered_batch_results(indexed_queries: Sequence[Tuple[int, Any]],
                          results: Sequence[Tuple[int, Any]],
                          who: str = "algorithm") -> List[Any]:
    """Enforce the ``batch_predict`` contract on a result set: every
    input query index answered exactly once, nothing extra. Returns the
    predictions aligned with the input order (``pio batchpredict``
    routes through here)."""
    by_qx: dict = {}
    for qx, p in results:
        if qx in by_qx:
            raise RuntimeError(
                f"{who}.batch_predict answered query {qx} twice")
        by_qx[qx] = p
    wanted = [qx for qx, _ in indexed_queries]
    missing = [qx for qx in wanted if qx not in by_qx]
    extra = sorted(set(by_qx) - set(wanted))
    if missing or extra:
        raise RuntimeError(
            f"{who}.batch_predict broke the index contract: "
            f"missing {missing[:5]}, unexpected {extra[:5]}")
    return [by_qx[qx] for qx in wanted]


def _persist_or_model(model: Any, model_id: str, params: Params,
                      ctx: Any) -> Any:
    """A PersistentModel saves itself and is stored as its manifest (or
    as ``RETRAIN`` when it declines); any other model is stored as it
    is."""
    if isinstance(model, PersistentModel):
        if model.save(model_id, params, ctx):
            return manifest_for(model)
        return RETRAIN
    return model


class LAlgorithm(BaseAlgorithm):
    """Local algorithm: host-only train and predict."""

    @abc.abstractmethod
    def train(self, pd: Any) -> Any: ...

    @abc.abstractmethod
    def predict(self, model: Any, query: Any) -> Any: ...

    def batch_predict(self, model: Any,
                      indexed_queries: Sequence[Tuple[int, Any]]
                      ) -> List[Tuple[int, Any]]:
        return [(qx, self.predict(model, q)) for qx, q in indexed_queries]

    def train_base(self, ctx: Any, pd: Any) -> Any:
        return self.train(pd)

    def batch_predict_base(self, ctx, model, indexed_queries):
        return self.batch_predict(model, indexed_queries)

    def predict_base(self, model: Any, query: Any) -> Any:
        return self.predict(model, query)

    def make_persistent_model(self, ctx, model_id, algo_params, model):
        return _persist_or_model(model, model_id, algo_params, ctx)


class P2LAlgorithm(BaseAlgorithm):
    """Parallel-to-local: train on the device, keep a host-local model."""

    @abc.abstractmethod
    def train(self, ctx: Any, pd: Any) -> Any: ...

    @abc.abstractmethod
    def predict(self, model: Any, query: Any) -> Any: ...

    def batch_predict(self, ctx: Any, model: Any,
                      indexed_queries: Sequence[Tuple[int, Any]]
                      ) -> List[Tuple[int, Any]]:
        """Default: map predict over the queries."""
        return [(qx, self.predict(model, q)) for qx, q in indexed_queries]

    def train_base(self, ctx: Any, pd: Any) -> Any:
        return self.train(ctx, pd)

    def batch_predict_base(self, ctx, model, indexed_queries):
        return self.batch_predict(ctx, model, indexed_queries)

    def predict_base(self, model: Any, query: Any) -> Any:
        return self.predict(model, query)

    def make_persistent_model(self, ctx, model_id, algo_params, model):
        return _persist_or_model(model, model_id, algo_params, ctx)
