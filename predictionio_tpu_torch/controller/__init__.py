"""Controller API of the port (the training, persistence and serving
subset)."""

from predictionio_tpu_torch.controller.algorithms import P2LAlgorithm
from predictionio_tpu_torch.controller.controllers import (
    IdentityPreparator,
    LFirstServing,
    LServing,
    PDataSource,
    PPreparator,
)
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineConfigError,
    EngineParams,
    params_from_dict,
    params_to_dict,
    train_pipeline,
)
from predictionio_tpu_torch.controller.persistent import PersistentModel
from predictionio_tpu_torch.core.base import (
    EmptyParams,
    Params,
    WorkflowParams,
)

__all__ = [
    "EmptyParams",
    "Engine",
    "EngineConfigError",
    "EngineParams",
    "IdentityPreparator",
    "LFirstServing",
    "LServing",
    "P2LAlgorithm",
    "PDataSource",
    "PPreparator",
    "Params",
    "PersistentModel",
    "WorkflowParams",
    "params_from_dict",
    "params_to_dict",
    "train_pipeline",
]
