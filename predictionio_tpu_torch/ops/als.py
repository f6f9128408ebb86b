"""ALS hyper-parameters.

The port's copy of ``predictionio_tpu.ops.als.ALSParams``, so an
engine.json written for the JAX package parses here unchanged. The
trainers of that module (``train_als``, ``train_als_bucketed``,
``_solve_rows``) and their two kernels come with the ALS training slice
(ROADMAP, queue A item 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from predictionio_tpu_torch.core.base import Params


@dataclasses.dataclass(frozen=True)
class ALSParams(Params):
    """Field for field the reference's ALS parameters; see
    ``predictionio_tpu/ops/als.py:44-90`` for what each one does in
    training."""

    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = True
    seed: Optional[int] = None
    solve_block_rows: Optional[int] = None
    bucket_slot_budget: Optional[int] = None
    precision: str = "fp32"
    solve_refine: bool = False
    checkpoint_every: Optional[int] = None
