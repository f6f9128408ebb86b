"""CoreWorkflow: train or evaluate, and record the instance.

The port's copy of ``serialize_models``, ``deserialize_models``,
``load_engine_factory``, ``run_train`` and ``run_evaluation`` from
``predictionio_tpu/workflow/core_workflow.py``: ``run_train`` trains,
pickles the models into the Models repository under the instance's id
(in the same sha256 envelope, so a torn blob is refused), then marks the
EngineInstance ``COMPLETED`` (``FAILED`` when training raises);
``run_evaluation`` evaluates every param set, scores them with the
evaluator and marks the EvaluationInstance ``EVALCOMPLETED`` with the
rendered results (``FAILED`` when it raises).

A stored blob is a pickle. The port unpickles it through
:class:`PortUnpickler`, which refuses every class of the JAX package
(``predictionio_tpu`` and below) without importing it: a model the JAX
package stored raises ``StorageError`` naming the class. Across several
hosts (a ``torch.distributed`` process group, ``pio train --num-hosts``)
every host trains in the collective run, and only the primary host
(rank 0) records the instance and stores the models.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import importlib
import io
import logging
import pickle
from typing import Any, Callable, List, Optional, Sequence

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.controller.persistent import (
    is_jax_package_module,
)
from predictionio_tpu_torch.core.base import (
    BaseEvaluator,
    BaseEvaluatorResult,
    TrainingInterruption,
    WorkflowParams,
)
from predictionio_tpu_torch.core.context import (
    ComputeContext,
    workflow_context,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    EvaluationInstance,
    Model,
    StorageError,
)

logger = logging.getLogger("pio.torch.workflow")

# model-blob envelope: magic + sha256(payload) + payload, as the JAX
# package writes it (pickle streams start with b"\x80", so a blob
# without the envelope cannot begin with the magic)
_MODEL_MAGIC = b"PIOM\x01"


def _now() -> _dt.datetime:
    return _dt.datetime.now(tz=_dt.timezone.utc)


class ModelIntegrityError(RuntimeError):
    """A stored model blob failed its sha256 check (a torn or corrupted
    write)."""


class PortUnpickler(pickle.Unpickler):
    """Unpickles model blobs for the port: a class of the JAX package is
    refused before its module is imported."""

    def find_class(self, module: str, name: str) -> Any:
        if is_jax_package_module(module):
            raise StorageError(
                f"the stored model holds {module}.{name}, a class of the "
                "JAX package; the port loads only models it trained "
                "itself (train this engine with the port)")
        return super().find_class(module, name)


def serialize_models(models: Sequence[Any]) -> bytes:
    """Stored models -> one blob in the integrity envelope."""
    payload = pickle.dumps(list(models), protocol=pickle.HIGHEST_PROTOCOL)
    return _MODEL_MAGIC + hashlib.sha256(payload).digest() + payload


def deserialize_models(blob: bytes) -> List[Any]:
    """The blob's models, unpickled by :class:`PortUnpickler`."""
    if blob[:len(_MODEL_MAGIC)] == _MODEL_MAGIC:
        digest = blob[len(_MODEL_MAGIC):len(_MODEL_MAGIC) + 32]
        payload = blob[len(_MODEL_MAGIC) + 32:]
        if len(digest) != 32 \
                or hashlib.sha256(payload).digest() != digest:
            raise ModelIntegrityError(
                "model blob failed its sha256 integrity check (torn or "
                "corrupted write); refusing to load it: retrain or deploy "
                "a known-good engine instance")
    else:
        payload = blob  # stored before the envelope: plain pickle
    return PortUnpickler(io.BytesIO(payload)).load()


def load_engine_factory(path: str) -> Callable[[], Engine]:
    """The engine factory named ``module:callable``; a module of the JAX
    package is refused."""
    mod_name, _, attr = path.partition(":")
    if not attr:
        raise ValueError(
            f"engine factory must be 'module:callable', got {path!r}")
    if is_jax_package_module(mod_name):
        raise ValueError(
            f"engine factory {path!r} belongs to the JAX package; name the "
            "port's (predictionio_tpu_torch....)")
    obj: Any = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    if not callable(obj):
        raise TypeError(f"{path} is not callable")
    return obj


def run_train(engine: Engine, engine_params: EngineParams,
              engine_instance: EngineInstance,
              params: Optional[WorkflowParams] = None,
              ctx: Optional[ComputeContext] = None) -> Optional[str]:
    """Train, store the models and mark the instance ``COMPLETED``.

    Returns the instance id, or None when a stop-after flag interrupted
    training. A preemption of checkpointed training marks the instance
    ``INTERRUPTED`` and raises (``TrainingPreempted``); any other failure
    marks it ``FAILED`` and raises. ``ctx`` names the device (None =
    cuda).

    On a secondary host of a process group (rank > 0) it trains in the
    collective run and writes nothing: no EngineInstance, no model
    (host 0 persists, as the reference's driver does); it returns
    None."""
    from predictionio_tpu_torch.parallel.distributed import is_primary_host

    params = params or WorkflowParams()
    ctx = ctx or workflow_context(
        mode="train", batch=params.batch or engine_instance.batch)
    if not is_primary_host():
        try:
            engine.train(ctx, engine_params, params, engine_instance_id="")
            logger.info("Secondary host: training complete, persistence "
                        "left to host 0.")
        except TrainingInterruption as e:
            logger.info("Training interrupted by %r.", e)
        finally:
            ctx.stop()
        return None
    engine_instances = storage.get_metadata_engine_instances()
    instance_id = engine_instances.insert(engine_instance)
    instance = engine_instances.get(instance_id)
    assert instance is not None
    try:
        models = engine.train(ctx, engine_params, params,
                              engine_instance_id=instance_id)
        logger.info("Inserting persistent model")
        storage.get_model_data_models().insert(
            Model(id=instance_id, models=serialize_models(models)))
        engine_instances.update(dataclasses.replace(
            instance, status="COMPLETED", end_time=_now()))
        logger.info("Training completed: engine instance %s", instance_id)
        return instance_id
    except TrainingInterruption as e:
        if getattr(e, "resumable", False):
            # a preemption (workflow/checkpoint.py): a final checkpoint
            # is on disk; the instance is marked terminal and the
            # interruption propagates, so the CLI says where to resume
            engine_instances.update(dataclasses.replace(
                instance, status="INTERRUPTED", end_time=_now()))
            raise
        logger.info("Training interrupted by %r.", e)
        return None
    except Exception:
        engine_instances.update(dataclasses.replace(
            instance, status="FAILED", end_time=_now()))
        raise


def run_evaluation(engine: Engine,
                   engine_params_list: Sequence[EngineParams],
                   evaluation_instance: EvaluationInstance,
                   evaluator: BaseEvaluator, evaluation: Any = None,
                   params: Optional[WorkflowParams] = None,
                   ctx: Optional[ComputeContext] = None
                   ) -> BaseEvaluatorResult:
    """``batch_eval`` over every param set, score with the evaluator,
    and record the EvaluationInstance: ``EVALCOMPLETED`` with the
    result's one-liner, HTML and JSON (not stored when the result says
    ``no_save``), ``FAILED`` when anything raises. ``ctx`` names the
    device (None = cuda)."""
    params = params or WorkflowParams()
    ctx = ctx or workflow_context(mode="eval", batch=params.batch)
    evaluation_instances = storage.get_metadata_evaluation_instances()
    instance_id = evaluation_instances.insert(evaluation_instance)
    logger.info("Starting evaluation instance ID: %s", instance_id)
    instance = evaluation_instances.get(instance_id)
    assert instance is not None
    try:
        eval_data = engine.batch_eval(ctx, list(engine_params_list), params)
        result = evaluator.evaluate_base(ctx, evaluation, eval_data, params)
        if result.no_save:
            logger.info("Result not inserted into database: %r", result)
        else:
            evaluation_instances.update(dataclasses.replace(
                instance, status="EVALCOMPLETED", end_time=_now(),
                evaluator_results=result.to_one_liner(),
                evaluator_results_html=result.to_html(),
                evaluator_results_json=result.to_json()))
        return result
    except Exception:
        evaluation_instances.update(dataclasses.replace(
            instance, status="FAILED", end_time=_now()))
        raise
