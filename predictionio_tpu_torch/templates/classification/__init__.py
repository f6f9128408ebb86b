"""Classification engine template (Naive Bayes on entity properties).

The port's copy.
"""

from predictionio_tpu_torch.templates.classification.engine import (  # noqa: F401
    Accuracy,
    CategoricalNBAlgorithm,
    DataSourceParams,
    EventDataSource,
    LabeledPoint,
    NaiveBayesAlgorithm,
    NaiveBayesModel,
    NaiveBayesParams,
    PredictedResult,
    Query,
    RandomForestAlgorithm,
    RandomForestParams,
    TrainingData,
    engine_factory,
)
