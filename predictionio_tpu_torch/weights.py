"""Carry an ALS model trained elsewhere into the port.

Besides ``ALSAlgorithm.train``, a model may come from arrays: the JAX
package's ``ALSModel`` fields (numpy factors, the user/item maps' string
keys, the seen lists) or factors made from a seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel


def als_model_from_numpy(user_factors: np.ndarray, item_factors: np.ndarray,
                         user_ids: Sequence[str], item_ids: Sequence[str],
                         seen: Dict[int, np.ndarray],
                         item_categories: Optional[
                             Dict[int, Tuple[str, ...]]] = None,
                         device: DeviceLike = None) -> ALSModel:
    """The port's :class:`ALSModel` from host arrays. ``user_ids[i]`` /
    ``item_ids[j]`` name factor row i / j (for a JAX model:
    ``model.user_map.labels``); ``seen`` maps a user index to the item
    indices it rated. The model serves on ``device`` (None = cuda,
    which must be present)."""
    X = np.ascontiguousarray(user_factors, dtype=np.float32)
    Y = np.ascontiguousarray(item_factors, dtype=np.float32)
    if X.ndim != 2 or Y.ndim != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"factors must be [N, R] and [M, R]; got "
                         f"{X.shape} and {Y.shape}")
    if len(user_ids) != X.shape[0] or len(item_ids) != Y.shape[0]:
        raise ValueError(f"{len(user_ids)} user ids for {X.shape[0]} rows, "
                         f"{len(item_ids)} item ids for {Y.shape[0]} rows")
    dev = resolve_device(device)
    return ALSModel(
        X, Y, StringIndexBiMap.from_distinct(list(user_ids)),
        StringIndexBiMap.from_distinct(list(item_ids)),
        {int(u): np.asarray(v, dtype=np.int64) for u, v in seen.items()},
        item_categories=None if item_categories is None else
        {int(i): tuple(c) for i, c in item_categories.items()},
        device=str(dev))
