"""Batch prediction (``pio batchpredict``): bulk offline scoring through
the whole DASE serve path in restartable chunks. See
:mod:`predictionio_tpu_torch.batch.predict`."""

from predictionio_tpu_torch.batch.predict import (
    BatchPredictConfig,
    BatchPredictor,
    Manifest,
    chunk_spans,
    input_fingerprint,
    read_queries_jsonl,
    read_results,
    run_batch_predict,
    run_smoke,
    synthesize_queries,
)

__all__ = [
    "BatchPredictConfig",
    "BatchPredictor",
    "Manifest",
    "chunk_spans",
    "input_fingerprint",
    "read_queries_jsonl",
    "read_results",
    "run_batch_predict",
    "run_smoke",
    "synthesize_queries",
]
