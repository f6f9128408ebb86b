from predictionio_tpu_torch.templates.twostage.engine import (  # noqa: F401
    TwoStageALSAlgorithm,
    TwoStagePrepared,
    TwoStagePreparator,
    TwoStagePreparatorParams,
    TwoStageSeqRecAlgorithm,
    engine_factory,
)
