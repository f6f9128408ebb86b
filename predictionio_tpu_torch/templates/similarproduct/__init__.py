"""Similar-product engine template (item-to-item on view events).

The port's copy.
"""

from predictionio_tpu_torch.templates.similarproduct.engine import (  # noqa: F401
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSourceParams,
    DIMSUMAlgorithm,
    DIMSUMAlgorithmParams,
    DIMSUMModel,
    EventDataSource,
    FollowDataSource,
    FollowTrainingData,
    Item,
    ItemScore,
    LikeAlgorithm,
    LikeEvent,
    MultiServing,
    PredictedResult,
    Query,
    RecommendedUserAlgorithm,
    RecommendedUserModel,
    RecommendedUsersResult,
    RichItemScore,
    SimilarProductModel,
    SimilarUserScore,
    TrainingData,
    UserQuery,
    ViewEvent,
    YearItemScore,
    engine_factory,
    engine_factory_dimsum,
    engine_factory_multi,
    engine_factory_recommended_user,
)
