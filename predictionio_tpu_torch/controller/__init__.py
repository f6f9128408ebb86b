"""Controller API of the port: engines, controller flavors, params,
persistence, and the evaluation stack (metrics, ``Evaluation``,
``MetricEvaluator``, ``FastEvalEngine``)."""

from predictionio_tpu_torch.controller.algorithms import (
    LAlgorithm,
    P2LAlgorithm,
)
from predictionio_tpu_torch.controller.controllers import (
    IdentityPreparator,
    LDataSource,
    LFirstServing,
    LIdentityPreparator,
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
from predictionio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
    MetricScores,
)
from predictionio_tpu_torch.controller.fast_eval import FastEvalEngine
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    Metric,
    OptionAverageMetric,
    OptionStdevMetric,
    QPAMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller.persistent import PersistentModel
from predictionio_tpu_torch.core.base import (
    EmptyParams,
    Params,
    WorkflowParams,
)

__all__ = [
    "AverageMetric",
    "EmptyParams",
    "Engine",
    "EngineConfigError",
    "EngineParams",
    "EngineParamsGenerator",
    "Evaluation",
    "FastEvalEngine",
    "IdentityPreparator",
    "LAlgorithm",
    "LDataSource",
    "LFirstServing",
    "LIdentityPreparator",
    "LServing",
    "Metric",
    "MetricEvaluator",
    "MetricEvaluatorResult",
    "MetricScores",
    "OptionAverageMetric",
    "OptionStdevMetric",
    "P2LAlgorithm",
    "PDataSource",
    "PPreparator",
    "Params",
    "PersistentModel",
    "QPAMetric",
    "StdevMetric",
    "SumMetric",
    "WorkflowParams",
    "ZeroMetric",
    "params_from_dict",
    "params_to_dict",
    "train_pipeline",
]
