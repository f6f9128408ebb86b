"""Carry a model trained elsewhere into the port.

Besides the algorithms' ``train``, a model may come from arrays: the JAX
package's ``ALSModel`` fields (numpy factors, the user/item maps' string
keys, the seen lists) or its ``SeqRecModel`` fields (θ, the encoded user
vectors, the maps, the seen lists and the encoder's params), or arrays
made from a seed.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.templates.recommendation.engine import ALSModel

if TYPE_CHECKING:
    from predictionio_tpu_torch.templates.sequentialrec.engine import (
        SeqRecModel,
    )


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


def seqrec_model_from_numpy(theta: Dict[str, np.ndarray],
                            user_vectors: np.ndarray,
                            user_ids: Sequence[str], item_ids: Sequence[str],
                            seen: Dict[int, np.ndarray], params: Any,
                            device: DeviceLike = None) -> "SeqRecModel":
    """The port's sequentialrec ``SeqRecModel`` from host arrays: θ (the
    encoder's parameters by the JAX package's names; ``item_emb`` is the
    served item table), the encoded user vectors, the maps' ids, the seen
    lists and the encoder's params (any object with
    :class:`~predictionio_tpu_torch.ops.seqrec.SeqRecParams`' fields,
    such as the JAX package's). The model serves and folds in on
    ``device`` (None = cuda, which must be present)."""
    import dataclasses

    from predictionio_tpu_torch.ops.seqrec import SeqRecParams
    from predictionio_tpu_torch.templates.sequentialrec.engine import (
        SeqRecModel,
    )

    th = {k: np.ascontiguousarray(v, dtype=np.float32)
          for k, v in theta.items()}
    U = np.ascontiguousarray(user_vectors, dtype=np.float32)
    E = th["item_emb"]
    if U.ndim != 2 or E.ndim != 2 or U.shape[1] != E.shape[1]:
        raise ValueError(f"user vectors and item_emb must be [N, R] and "
                         f"[M, R]; got {U.shape} and {E.shape}")
    if len(user_ids) != U.shape[0] or len(item_ids) != E.shape[0]:
        raise ValueError(f"{len(user_ids)} user ids for {U.shape[0]} rows, "
                         f"{len(item_ids)} item ids for {E.shape[0]} rows")
    p = SeqRecParams(**{f.name: getattr(params, f.name)
                        for f in dataclasses.fields(SeqRecParams)})
    dev = resolve_device(device)
    return SeqRecModel(
        U, E, StringIndexBiMap.from_distinct(list(user_ids)),
        StringIndexBiMap.from_distinct(list(item_ids)),
        {int(u): np.asarray(v, dtype=np.int64) for u, v in seen.items()},
        th, p, int(p.max_seq_len), device=str(dev))
