"""Friend-recommendation engine template (KDD Cup 2012 track 1 shape).

The port's copy.
"""

from predictionio_tpu_torch.templates.friendrecommendation.engine import (  # noqa: F401,E501
    DataSourceParams,
    FriendRecommendationDataSource,
    KeywordSimilarityAlgorithm,
    KeywordSimilarityModel,
    Prediction,
    Query,
    RandomAlgorithm,
    RandomModel,
    TrainingData,
    engine_factory,
    engine_factory_random,
)
