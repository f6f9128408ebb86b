"""E-commerce recommendation template (ALS + business-rule filters).

The port's copy.
"""

from predictionio_tpu_torch.templates.ecommercerecommendation.engine import (  # noqa: F401
    DataSourceParams,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommModel,
    EventDataSource,
    Item,
    ItemScore,
    PredictedResult,
    Query,
    TrainingData,
    engine_factory,
)
