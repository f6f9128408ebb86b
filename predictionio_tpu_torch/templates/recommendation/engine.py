"""Recommendation engine, serving half: top-N items from ALS factors.

The port's copy of the query path of
``predictionio_tpu/templates/recommendation/engine.py``: the query and
result types, ``ALSModel`` (host factors and maps, served through
:func:`~predictionio_tpu_torch.ops.serving.choose_server`), the shared
top-k serving logic, and ``ALSAlgorithm.predict`` / ``batch_predict``.
Training (``ALSAlgorithm.train``), the data source and the preparator
come with the ALS training slice; until then a model is carried over
from arrays with :func:`predictionio_tpu_torch.weights.als_model_from_numpy`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    LFirstServing,
    P2LAlgorithm,
)
from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.ops.als import ALSParams


@dataclasses.dataclass(frozen=True)
class Query:
    """Top-N query: by user (personal recs) or by items (similarity)."""

    user: Optional[str] = None
    items: Tuple[str, ...] = ()
    num: int = 10
    blacklist: Tuple[str, ...] = ()
    # only items in these categories
    categories: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...]


@dataclasses.dataclass
class ALSModel:
    """Host factors and maps. ``device_server()`` builds the server on
    first use: the device store on ``device`` (None = cuda), at every
    size."""

    user_factors: np.ndarray     # [N, R]
    item_factors: np.ndarray     # [M, R]
    user_map: StringIndexBiMap
    item_map: StringIndexBiMap
    seen: Dict[int, np.ndarray]
    item_categories: Optional[Dict[int, Tuple[str, ...]]] = None
    device: Optional[str] = None
    _server: Any = dataclasses.field(default=None, repr=False, compare=False)

    _server_lock = threading.Lock()

    def device_server(self):
        # locked: concurrent first queries must not each build a store
        with self._server_lock:
            if self._server is None:
                from predictionio_tpu_torch.ops.serving import choose_server

                self._server = choose_server(
                    self.user_factors, self.item_factors, self.seen,
                    device=self.device)
            return self._server


def _coerce_query(query: Any) -> Query:
    """Raw JSON query -> typed Query."""
    if isinstance(query, dict):
        return Query(user=query.get("user"),
                     items=tuple(query.get("items", ())),
                     num=int(query.get("num", 10)),
                     blacklist=tuple(query.get("blacklist", ())),
                     categories=tuple(query.get("categories", ())))
    return query


def _winners_to_result(idx, scores, black, num: int,
                       item_map: StringIndexBiMap,
                       positive_only: bool = True) -> PredictedResult:
    """Fetched top-k row -> PredictedResult: drop blacklisted, non-finite
    and (for ALS) non-positive scores, clip to num."""
    keep = [(i, s) for i, s in zip(idx.tolist(), scores.tolist())
            if i not in black and math.isfinite(s)
            and (s > 0 or not positive_only)][:num]
    if not keep:
        return PredictedResult(())
    items = item_map.decode(np.asarray([i for i, _ in keep], dtype=np.int64))
    return PredictedResult(tuple(
        ItemScore(item=item, score=s) for item, (_, s) in zip(items, keep)))


_CAT_BLACKLIST_CACHE_MAX = 64
_cat_cache_lock = threading.Lock()


def _category_blacklist(model, categories: Tuple[str, ...]) -> set:
    """Item indices OUTSIDE the requested categories. The inverted
    category index and a bounded LRU of complements are cached on the
    model, so a query does not pay an O(n_items) Python loop."""
    with _cat_cache_lock:
        cache = getattr(model, "_cat_black_cache", None)
        if cache is None:
            cache = collections.OrderedDict()
            model._cat_black_cache = cache
        black = cache.get(categories)
        if black is not None:
            cache.move_to_end(categories)
            return black
    index = getattr(model, "_cat_index", None)
    if index is None:
        index = {}
        for ix, cats in model.item_categories.items():
            for c in cats:
                index.setdefault(c, set()).add(ix)
        model._cat_index = index
    eligible: set = set()
    for c in categories:
        eligible |= index.get(c, set())
    black = set(range(len(model.item_map))) - eligible
    with _cat_cache_lock:
        cache[categories] = black
        while len(cache) > _CAT_BLACKLIST_CACHE_MAX:
            cache.popitem(last=False)
    return black


def _serve_topk(server, model, query: Query) -> PredictedResult:
    """Ask the server for num + |blacklist| winners (seen items already
    masked on the device), drop blacklisted / non-positive ones, clip to
    num. A category restriction joins the blacklist."""
    user_map, item_map = model.user_map, model.item_map
    black = {item_map[i] for i in query.blacklist if i in item_map}
    if query.categories:
        if getattr(model, "item_categories", None) is None:
            raise ValueError(
                "query has categories but the model was trained without "
                "read_item_categories=True on the datasource")
        black = black | _category_blacklist(model, query.categories)
    k = query.num + len(black)
    if query.items:
        idxs = [item_map[i] for i in query.items if i in item_map]
        if not idxs:
            return PredictedResult(())
        idx, scores = server.items_topk(idxs, k)
    elif query.user is not None:
        uidx = user_map.get(query.user)
        if uidx is None:
            return PredictedResult(())
        idx, scores = server.user_topk(uidx, k)
    else:
        return PredictedResult(())
    return _winners_to_result(idx, scores, black, query.num, item_map)


class ALSAlgorithm(P2LAlgorithm):
    """Implicit ALS, serving side."""

    params_class = ALSParams
    query_cls = Query

    def train(self, ctx: Any, pd: Any) -> ALSModel:
        raise NotImplementedError(
            "ALS training is not ported yet (ROADMAP queue A item 1: "
            "ALS training); build the model with "
            "predictionio_tpu_torch.weights.als_model_from_numpy")

    def warmup_base(self, model: ALSModel) -> None:
        """Build the server (and the kernel, on the GPU) at deploy so the
        first real query pays neither."""
        if len(model.user_map):
            model.device_server().warmup()

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return _serve_topk(model.device_server(), model, _coerce_query(query))

    def batch_predict(self, ctx: Any, model: ALSModel,
                      indexed_queries) -> List[Tuple[int, Any]]:
        """Known-user queries grouped per k and dispatched through
        ``users_topk`` (one launch per group); item-similarity,
        category and unknown-user queries take the per-query path."""
        queries = [(qx, _coerce_query(q)) for qx, q in indexed_queries]
        server = model.device_server()
        results: Dict[int, Any] = {}
        groups: Dict[int, List[Tuple[int, int, set, int]]] = {}
        for qx, q in queries:
            uidx = (model.user_map.get(q.user)
                    if q.user is not None and not q.items
                    and not q.categories else None)
            if uidx is None:
                results[qx] = self.predict(model, q)
                continue
            black = {model.item_map[i] for i in q.blacklist
                     if i in model.item_map}
            groups.setdefault(q.num + len(black), []).append(
                (qx, uidx, black, q.num))
        for k, rows in groups.items():
            uids = np.asarray([r[1] for r in rows], dtype=np.int64)
            idx, scores = server.users_topk(uids, k)
            for row, (qx, _, black, num) in enumerate(rows):
                results[qx] = _winners_to_result(
                    idx[row], scores[row], black, num, model.item_map)
        return [(qx, results[qx]) for qx, _ in queries]


class RecommendationServing(LFirstServing):
    """First-serving: the single algorithm's result."""


def engine_factory() -> Engine:
    return Engine({"als": ALSAlgorithm, "": ALSAlgorithm},
                  {"": RecommendationServing})
