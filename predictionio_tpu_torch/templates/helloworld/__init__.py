"""Hello-world L-flavor engine template (day -> average temperature).

The port's copy.
"""

from predictionio_tpu_torch.templates.helloworld.engine import (  # noqa: F401
    DataSourceParams,
    HelloWorldAlgorithm,
    HelloWorldDataSource,
    HelloWorldModel,
    Query,
    PredictedResult,
    TrainingData,
    engine_factory,
)
