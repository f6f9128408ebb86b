"""Where a training or serving run computes.

The port's copy of ``predictionio_tpu/core/context.py``, the subset one
device needs: the ``ctx`` handed to ``Engine.train`` and to the
controllers names the device they run on (None = cuda).
"""

from __future__ import annotations

import dataclasses

from predictionio_tpu_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class ComputeContext:
    device: DeviceLike = None
