"""The trainer the templates call.

The port's copy of ``train_als_auto`` from
``predictionio_tpu/parallel/als_sharding.py``, single device only: the
sharded trainers of that module come with the sharded store (ROADMAP
A6).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from predictionio_tpu_torch.device import DeviceLike
from predictionio_tpu_torch.ops.als import (
    ALSParams,
    BucketedRatings,
    train_als,
    train_als_bucketed,
)


def train_als_auto(user_side, item_side, params: ALSParams,
                   device: Union[DeviceLike, Sequence[DeviceLike]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Train on uniform :class:`~predictionio_tpu_torch.ops.als.
    PaddedRatings` or length-bucketed :class:`~predictionio_tpu_torch.
    ops.als.BucketedRatings` sides (the preparator's choice) on one
    device (None = cuda), under the trainers' precision policy and
    checkpoint lane (``params.precision`` / ``PIO_ALS_PRECISION``,
    ``PIO_CHECKPOINT_*``, resolved by the trainer per call). A sequence
    of several devices raises: the sharded trainers are not ported yet."""
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            raise NotImplementedError(
                f"training across {len(device)} devices is not ported yet "
                "(ROADMAP A6: the sharded trainers); pass one "
                "device")
        device = device[0] if device else None
    if isinstance(user_side, BucketedRatings):
        return train_als_bucketed(user_side, item_side, params, device)
    return train_als(user_side, item_side, params, device)
