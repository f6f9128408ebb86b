"""CreateWorkflow: the train entry point.

The port's copy of ``predictionio_tpu/workflow/create_workflow.py``:
resolve the engine factory, parse the variant into EngineParams, record
an EngineInstance with a JSON snapshot of every stage's params, and run
:func:`~predictionio_tpu_torch.workflow.core_workflow.run_train`.
Training runs on the device ``ctx`` names (None = cuda).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import os
from typing import Any, Dict, Mapping, Optional

from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    params_to_dict,
)
from predictionio_tpu_torch.core.base import WorkflowParams
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data.storage.base import EngineInstance
from predictionio_tpu_torch.workflow import core_workflow


@dataclasses.dataclass
class WorkflowConfig:
    """The engine's coordinates and the training controls."""

    engine_id: str = "default"
    engine_version: str = "default"
    engine_variant: str = "engine.json"
    engine_factory: str = ""
    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False

    def workflow_params(self) -> WorkflowParams:
        return WorkflowParams(
            skip_sanity_check=self.skip_sanity_check,
            stop_after_read=self.stop_after_read,
            stop_after_prepare=self.stop_after_prepare)


def pio_env_vars() -> Dict[str, str]:
    """The process's ``PIO_*`` variables, recorded with the instance."""
    return {k: v for k, v in os.environ.items() if k.startswith("PIO_")}


def _params_snapshot(engine_params: EngineParams) -> Dict[str, str]:
    """JSON snapshots of every stage's params for the EngineInstance."""
    def one(pair):
        name, params = pair
        return json.dumps({"name": name, "params": params_to_dict(params)})

    return {
        "data_source_params": one(engine_params.data_source_params),
        "preparator_params": one(engine_params.preparator_params),
        "algorithms_params": json.dumps([
            {"name": n, "params": params_to_dict(p)}
            for n, p in engine_params.algorithm_params_list]),
        "serving_params": one(engine_params.serving_params),
    }


def new_engine_instance(config: WorkflowConfig,
                        engine_params: EngineParams) -> EngineInstance:
    now = _dt.datetime.now(tz=_dt.timezone.utc)
    return EngineInstance(
        id="", status="INIT", start_time=now, end_time=now,
        engine_id=config.engine_id, engine_version=config.engine_version,
        engine_variant=config.engine_variant,
        engine_factory=config.engine_factory, batch=config.batch,
        env=pio_env_vars(), **_params_snapshot(engine_params))


def create_workflow(config: WorkflowConfig,
                    variant: Optional[Mapping[str, Any]] = None,
                    engine: Optional[Engine] = None,
                    ctx: Optional[ComputeContext] = None) -> Optional[str]:
    """Resolve the engine and its params and train; returns the engine
    instance's id (None when a stop-after flag interrupted training).

    ``engine`` stands in for ``config.engine_factory`` ("module:callable")
    and ``variant`` for the JSON file ``config.engine_variant``."""
    if engine is None:
        engine = core_workflow.load_engine_factory(config.engine_factory)()
    if variant is None:
        with open(config.engine_variant, "r", encoding="utf-8") as f:
            variant = json.load(f)
    engine_params = engine.engine_params_from_variant(variant)
    instance = new_engine_instance(config, engine_params)
    return core_workflow.run_train(
        engine, engine_params, instance, params=config.workflow_params(),
        ctx=ctx)
