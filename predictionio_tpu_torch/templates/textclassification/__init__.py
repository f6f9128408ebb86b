"""Text-classification template (hashed embedding table + LR on device,
NB over token counts) — the net-new config named by BASELINE.json; shape
modeled on ``examples/scala-parallel-classification`` (SURVEY §2.5).

The port's copy.
"""

from predictionio_tpu_torch.templates.textclassification.engine import (
    Accuracy,
    ActualResult,
    DataSourceParams,
    Document,
    EventDataSource,
    PredictedResult,
    PreparatorParams,
    PreparedDocs,
    Query,
    TextEmbeddingLRAlgorithm,
    TextLRModel,
    TextLRParams,
    TextNBAlgorithm,
    TextEvaluation,
    TextNBParams,
    TextParamsList,
    TextPreparator,
    TrainingData,
    encode_texts,
    engine_factory,
    hash_tokens,
    tokenize,
)

__all__ = [
    "Accuracy",
    "ActualResult",
    "DataSourceParams",
    "Document",
    "EventDataSource",
    "PredictedResult",
    "PreparatorParams",
    "PreparedDocs",
    "Query",
    "TextEmbeddingLRAlgorithm",
    "TextLRModel",
    "TextLRParams",
    "TextNBAlgorithm",
    "TextEvaluation",
    "TextNBParams",
    "TextParamsList",
    "TextPreparator",
    "TrainingData",
    "encode_texts",
    "engine_factory",
    "hash_tokens",
    "tokenize",
]
