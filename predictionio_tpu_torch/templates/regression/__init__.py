"""Local linear-regression engine template (experimental family).

The port's copy.
"""

from predictionio_tpu_torch.templates.regression.engine import (  # noqa: F401
    DataSourceParams,
    LocalAlgorithm,
    LocalDataSource,
    LocalPreparator,
    MeanSquareError,
    PreparatorParams,
    Query,
    TrainingData,
    engine_factory,
)
