"""Workflow runtime: train/deploy/eval entries around the DASE engine.

The names exported here are the crash-safe training lane's
(:mod:`~predictionio_tpu_torch.workflow.checkpoint`) and the evaluation
entry ``run_evaluation``, as the JAX package's ``workflow/__init__.py``
exports them. The checkpoint module imports no torch, and
``run_evaluation`` (whose module does) loads on first access, so
``import predictionio_tpu_torch.workflow`` stays light.
"""

from predictionio_tpu_torch.workflow.checkpoint import (
    CheckpointMismatchError,
    TrainCheckpointer,
    TrainingDivergedError,
    TrainingPreempted,
)

__all__ = [
    "CheckpointMismatchError",
    "TrainCheckpointer",
    "TrainingDivergedError",
    "TrainingPreempted",
    "run_evaluation",
]


def __getattr__(name: str):
    if name == "run_evaluation":
        from predictionio_tpu_torch.workflow.core_workflow import (
            run_evaluation,
        )

        return run_evaluation
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
