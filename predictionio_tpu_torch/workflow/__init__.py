"""Workflow runtime: train/deploy entries around the DASE engine.

The names exported here are the crash-safe training lane's
(:mod:`~predictionio_tpu_torch.workflow.checkpoint`), as the JAX
package's ``workflow/__init__.py`` exports them; that module imports
no torch, so ``import predictionio_tpu_torch.workflow`` stays light.
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
]
