"""Carry a model trained elsewhere into the port.

Besides the algorithms' ``train``, a model may come from arrays: the JAX
package's ``ALSModel`` fields (numpy factors, the user/item maps' string
keys, the seen lists) or its ``SeqRecModel`` fields (θ, the encoded user
vectors, the maps, the seen lists and the encoder's params), or arrays
made from a seed. The other templates' models that hold arrays come the
same way: similarproduct's ``SimilarProductModel``, ``DIMSUMModel`` and
``RecommendedUserModel``, ecommercerecommendation's ``ECommModel``,
textclassification's ``TextLRModel`` and ``TextNBModel``, and
classification's ``NaiveBayesModel`` and ``RandomForestModel``. Item
metadata may be given as the JAX package's items (any object with the
port's ``Item`` fields) or as dicts of those fields.
"""

from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Any, Dict, Mapping, Optional, Sequence,
                    Tuple)

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


def _f32(a: np.ndarray, ndim: int, what: str) -> np.ndarray:
    out = np.ascontiguousarray(a, dtype=np.float32)
    if out.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dimensions; got "
                         f"{list(out.shape)}")
    return out


def _id_map(ids: Sequence[str], rows: int, what: str) -> StringIndexBiMap:
    if len(ids) != rows:
        raise ValueError(f"{len(ids)} {what} ids for {rows} rows")
    return StringIndexBiMap.from_distinct(list(ids))


def _items(item_cls: type, items: Optional[Mapping[int, Any]]
           ) -> Dict[int, Any]:
    """Index -> the template's ``Item``, each from an object with its
    fields (a JAX package item) or a dict of them; tuples stay tuples."""
    names = [f.name for f in dataclasses.fields(item_cls)]

    def one(meta):
        get = meta.get if isinstance(meta, Mapping) \
            else (lambda k, d=None: getattr(meta, k, d))
        kw = {k: get(k) for k in names if get(k) is not None}
        if "categories" in kw:
            kw["categories"] = tuple(kw["categories"])
        return item_cls(**kw)

    return {int(ix): one(meta) for ix, meta in (items or {}).items()}


def similar_product_model_from_numpy(product_features: np.ndarray,
                                     item_ids: Sequence[str],
                                     items: Optional[Mapping[int, Any]]
                                     = None):
    """similarproduct's ``SimilarProductModel``: item factors ``[M, R]``,
    ``item_ids[j]`` naming row j, and each row's item metadata."""
    from predictionio_tpu_torch.templates.similarproduct.engine import (
        Item,
        SimilarProductModel,
    )

    Y = _f32(product_features, 2, "product_features")
    return SimilarProductModel(Y, _id_map(item_ids, Y.shape[0], "item"),
                               _items(Item, items))


def dimsum_model_from_numpy(similarities: np.ndarray,
                            item_ids: Sequence[str],
                            items: Optional[Mapping[int, Any]] = None):
    """similarproduct's ``DIMSUMModel``: the ``[M, M]`` similarity table
    and the items' ids and metadata."""
    from predictionio_tpu_torch.templates.similarproduct.engine import (
        DIMSUMModel,
        Item,
    )

    S = _f32(similarities, 2, "similarities")
    if S.shape[0] != S.shape[1]:
        raise ValueError(f"similarities must be square; got {list(S.shape)}")
    return DIMSUMModel(S, _id_map(item_ids, S.shape[0], "item"),
                       _items(Item, items))


def recommended_user_model_from_numpy(similar_user_features: np.ndarray,
                                      user_ids: Sequence[str]):
    """similarproduct's ``RecommendedUserModel``: the followed users'
    factors ``[N, R]`` and their ids."""
    from predictionio_tpu_torch.templates.similarproduct.engine import (
        RecommendedUserModel,
    )

    F = _f32(similar_user_features, 2, "similar_user_features")
    return RecommendedUserModel(F, _id_map(user_ids, F.shape[0], "user"))


def ecomm_model_from_numpy(user_factors: np.ndarray,
                           item_factors: np.ndarray,
                           user_ids: Sequence[str], item_ids: Sequence[str],
                           items: Optional[Mapping[int, Any]] = None):
    """ecommercerecommendation's ``ECommModel``: both factor matrices,
    the maps' ids and the items' categories."""
    from predictionio_tpu_torch.templates.ecommercerecommendation.engine \
        import ECommModel, Item

    X = _f32(user_factors, 2, "user_factors")
    Y = _f32(item_factors, 2, "item_factors")
    if X.shape[1] != Y.shape[1]:
        raise ValueError(f"factors must be [N, R] and [M, R]; got "
                         f"{X.shape} and {Y.shape}")
    return ECommModel(int(X.shape[1]), X, Y,
                      _id_map(user_ids, X.shape[0], "user"),
                      _id_map(item_ids, Y.shape[0], "item"),
                      _items(Item, items))


def text_lr_model_from_numpy(embeddings: np.ndarray, w: np.ndarray,
                             b: np.ndarray, labels: Sequence[str],
                             vocab_size: int, max_tokens: int):
    """textclassification's ``TextLRModel``: the embedding table
    ``[V, D]``, the head ``w [D, C]`` and ``b [C]``, the labels in code
    order and the encoder's sizes."""
    from predictionio_tpu_torch.templates.textclassification.engine import (
        TextLRModel,
    )

    E, W = _f32(embeddings, 2, "embeddings"), _f32(w, 2, "w")
    bias = _f32(b, 1, "b")
    if E.shape != (vocab_size, W.shape[0]) \
            or bias.shape != (len(labels),) or W.shape[1] != len(labels):
        raise ValueError(f"embeddings {E.shape}, w {W.shape}, b "
                         f"{bias.shape} do not fit {vocab_size} buckets "
                         f"and {len(labels)} labels")
    return TextLRModel(E, W, bias, tuple(labels), int(vocab_size),
                       int(max_tokens))


def text_nb_model_from_numpy(pi: np.ndarray, theta: np.ndarray,
                             labels: Sequence[str], vocab_size: int,
                             max_tokens: int):
    """textclassification's ``TextNBModel``: log priors ``[C]`` and log
    likelihoods ``[C, V]`` (float64, as trained)."""
    from predictionio_tpu_torch.templates.textclassification.engine import (
        TextNBModel,
    )

    P = np.asarray(pi, dtype=np.float64)
    T = np.asarray(theta, dtype=np.float64)
    if T.shape != (len(labels), vocab_size) or P.shape != (len(labels),):
        raise ValueError(f"pi {P.shape} and theta {T.shape} do not fit "
                         f"{len(labels)} labels and {vocab_size} buckets")
    return TextNBModel(P, T, tuple(labels), int(vocab_size),
                       int(max_tokens))


def naive_bayes_model_from_numpy(labels: np.ndarray, pi: np.ndarray,
                                 theta: np.ndarray):
    """classification's ``NaiveBayesModel``: label values ``[L]``, log
    priors ``[L]`` and log likelihoods ``[L, F]`` (float64)."""
    from predictionio_tpu_torch.templates.classification.engine import (
        NaiveBayesModel,
    )

    lab = np.asarray(labels, dtype=np.float64)
    P = np.asarray(pi, dtype=np.float64)
    T = np.asarray(theta, dtype=np.float64)
    if P.shape != lab.shape or T.ndim != 2 or T.shape[0] != len(lab):
        raise ValueError(f"labels {lab.shape}, pi {P.shape} and theta "
                         f"{T.shape} do not agree")
    return NaiveBayesModel(labels=lab, pi=P, theta=T)


def random_forest_model_from_numpy(trees: Sequence[Mapping[str, np.ndarray]],
                                   n_classes: int):
    """classification's ``RandomForestModel`` (``e2.forest``): each tree
    as its flat arrays ``feature``, ``threshold``, ``left``, ``right``
    and ``leaf_class`` (a dict, or the JAX package's tree)."""
    from predictionio_tpu_torch.e2.forest import RandomForestModel, _Tree

    dtypes = {"feature": np.int32, "threshold": np.float64,
              "left": np.int32, "right": np.int32, "leaf_class": np.int32}

    def field(t, k):
        return t[k] if isinstance(t, Mapping) else getattr(t, k)

    return RandomForestModel(
        [_Tree(**{k: np.asarray(field(t, k), dtype=d)
                  for k, d in dtypes.items()}) for t in trees],
        int(n_classes))
