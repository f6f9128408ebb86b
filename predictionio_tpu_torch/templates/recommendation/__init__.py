"""Recommendation template (ALS): the port's copy of
``predictionio_tpu/templates/recommendation``."""

from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSModel,
    ALSShardedAlgorithm,
    DataSourceParams,
    EventDataSource,
    ItemScore,
    PrecisionAtK,
    PredictedResult,
    PreparatorParams,
    Query,
    RatingsPreparator,
    RecommendationEvaluation,
    RecommendationParamsList,
    RecommendationServing,
    ShardedALSModel,
    TrainingData,
    engine_factory,
    sharded_engine_factory,
)

__all__ = [
    "ALSAlgorithm",
    "ALSModel",
    "ALSShardedAlgorithm",
    "DataSourceParams",
    "EventDataSource",
    "ItemScore",
    "PrecisionAtK",
    "PredictedResult",
    "PreparatorParams",
    "Query",
    "RatingsPreparator",
    "RecommendationEvaluation",
    "RecommendationParamsList",
    "RecommendationServing",
    "ShardedALSModel",
    "TrainingData",
    "engine_factory",
    "sharded_engine_factory",
]
