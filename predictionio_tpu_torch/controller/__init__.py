"""Controller API of the port (the serving subset)."""

from predictionio_tpu_torch.controller.algorithms import P2LAlgorithm
from predictionio_tpu_torch.controller.controllers import LFirstServing, LServing
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineConfigError,
    EngineParams,
    params_from_dict,
)
from predictionio_tpu_torch.core.base import EmptyParams, Params

__all__ = [
    "EmptyParams",
    "Engine",
    "EngineConfigError",
    "EngineParams",
    "LFirstServing",
    "LServing",
    "P2LAlgorithm",
    "Params",
    "params_from_dict",
]
