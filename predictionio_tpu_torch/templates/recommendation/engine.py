"""Recommendation engine: ratings -> implicit ALS -> top-N items.

The port's copy of ``predictionio_tpu/templates/recommendation/engine.py``:

- training data (``Rating``, ``TrainingData``, ``IndexedTrainingData``),
  ``RatingsPreparator`` (entity ids to indices, then the uniform or the
  length-bucketed layout) and ``ALSAlgorithm.train`` (through
  ``train_als_auto`` and the two training kernels);
- the query path: the query and result types, ``ALSModel`` (host
  factors and maps, served through
  :func:`~predictionio_tpu_torch.ops.serving.choose_server`), the shared
  top-k serving logic, and ``ALSAlgorithm.predict`` / ``batch_predict``.

The event-store data source comes with the storage slice (ROADMAP
queue A item 2): until then the caller registers a data source of its
own, which returns ``TrainingData`` or ``IndexedTrainingData``. A model
may also be carried over from arrays with
:func:`predictionio_tpu_torch.weights.als_model_from_numpy`.
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
    Params,
    PPreparator,
)
from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.als import (
    ALSParams,
    bucket_ratings_pair,
    pad_ratings,
)


@dataclasses.dataclass
class Rating:
    user: str
    item: str
    rating: float


class TrainingData:
    """Columnar rating triples (users and items as object arrays,
    float32 values); a ``Rating`` list is accepted too, and
    ``.ratings`` materializes lazily."""

    def __init__(self, ratings: Optional[List[Rating]] = None, *,
                 users: Optional[np.ndarray] = None,
                 items: Optional[np.ndarray] = None,
                 values: Optional[np.ndarray] = None):
        if ratings is not None:
            users = np.asarray([r.user for r in ratings], dtype=object)
            items = np.asarray([r.item for r in ratings], dtype=object)
            values = np.fromiter((r.rating for r in ratings),
                                 dtype=np.float32, count=len(ratings))
        self.users = users if users is not None \
            else np.empty(0, dtype=object)
        self.items = items if items is not None \
            else np.empty(0, dtype=object)
        self.values = values if values is not None \
            else np.empty(0, dtype=np.float32)
        if not (len(self.users) == len(self.items) == len(self.values)):
            raise ValueError(
                f"misaligned rating columns: {len(self.users)} users, "
                f"{len(self.items)} items, {len(self.values)} values")
        self.item_categories: Optional[Dict[str, Tuple[str, ...]]] = None
        # a None id would become the string 'None' when indexed
        for name, col in (("user", self.users), ("item", self.items)):
            if any(x is None for x in col):
                raise ValueError(
                    f"TrainingData has events without a {name} id; filter "
                    "the event scan (e.g. by target_entity_type)")
        self._ratings: Optional[List[Rating]] = ratings

    @property
    def ratings(self) -> List[Rating]:
        if self._ratings is None:
            self._ratings = [
                Rating(str(u), str(i), float(v))
                for u, i, v in zip(self.users, self.items, self.values)]
        return self._ratings

    def __len__(self) -> int:
        return int(self.users.shape[0])

    def sanity_check(self) -> None:
        assert len(self), (
            "ratings in TrainingData cannot be empty. Please check if "
            "DataSource generates TrainingData correctly.")


class IndexedTrainingData:
    """Already-indexed rating triples: int64 user/item codes plus their
    BiMaps. The preparator takes them as they are, so no whole-store
    string columns are ever built."""

    def __init__(self, user_map: StringIndexBiMap,
                 item_map: StringIndexBiMap, rows: np.ndarray,
                 cols: np.ndarray, values: np.ndarray):
        self.user_map = user_map
        self.item_map = item_map
        self.rows = rows
        self.cols = cols
        self.values = values
        self.item_categories: Optional[Dict[str, Tuple[str, ...]]] = None

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def sanity_check(self) -> None:
        assert len(self), (
            "ratings in TrainingData cannot be empty. Please check if "
            "DataSource generates TrainingData correctly.")


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
class PreparedData:
    """Indexed ratings in the training layout: uniform
    (:class:`~predictionio_tpu_torch.ops.als.PaddedRatings`) or
    length-bucketed (:class:`~predictionio_tpu_torch.ops.als.
    BucketedRatings`) sides, and each user's rated items."""

    user_map: StringIndexBiMap
    item_map: StringIndexBiMap
    user_side: Any
    item_side: Any
    seen: Dict[int, np.ndarray]  # user idx -> item idx array
    item_categories: Optional[Dict[int, Tuple[str, ...]]] = None

    def sanity_check(self) -> None:
        assert self.user_side.n_rows > 0, "no users after indexing"
        assert self.user_side.n_cols > 0, "no items after indexing"


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    """``bucketed=True`` lays the ratings out as length buckets
    (``bucket_ratings_pair``): each row pads only to its own length
    class and nothing is truncated; the recommended layout at 10M+
    ratings. ``max_len`` bounds the padded row length, keeping each
    row's largest-magnitude ratings."""

    max_len: Optional[int] = None
    bucketed: bool = False


class RatingsPreparator(PPreparator):
    """Entity ids to indices (``TrainingData``; ``IndexedTrainingData``
    is taken as it is), then the training layout and the seen lists."""

    params_class = PreparatorParams

    def prepare(self, ctx: Any, td: Any) -> PreparedData:
        if isinstance(td, IndexedTrainingData):
            user_map, item_map = td.user_map, td.item_map
            rows = np.asarray(td.rows, dtype=np.int64)
            cols = np.asarray(td.cols, dtype=np.int64)
        else:
            u_labels, rows = np.unique(td.users.astype(str),
                                       return_inverse=True)
            i_labels, cols = np.unique(td.items.astype(str),
                                       return_inverse=True)
            user_map = StringIndexBiMap.from_distinct(u_labels)
            item_map = StringIndexBiMap.from_distinct(i_labels)
            rows = rows.astype(np.int64)
            cols = cols.astype(np.int64)
        vals = np.asarray(td.values, dtype=np.float32)
        n_u, n_i = len(user_map), len(item_map)
        max_len = getattr(self.params, "max_len", None)
        if getattr(self.params, "bucketed", False):
            user_side, item_side = bucket_ratings_pair(
                rows, cols, vals, n_u, n_i, max_len=max_len)
        else:
            user_side = pad_ratings(rows, cols, vals, n_u, n_i,
                                    max_len=max_len)
            item_side = pad_ratings(cols, rows, vals, n_i, n_u,
                                    max_len=max_len)
        # per-user seen items via one stable sort
        order = np.argsort(rows, kind="stable")
        s_rows, s_cols = rows[order], cols[order]
        starts = np.searchsorted(s_rows, np.arange(n_u))
        ends = np.searchsorted(s_rows, np.arange(n_u), side="right")
        seen = {u: s_cols[starts[u]:ends[u]] for u in range(n_u)}
        cats = None
        raw_cats = getattr(td, "item_categories", None)
        if raw_cats is not None:
            cats = {item_map[iid]: tuple(c)
                    for iid, c in raw_cats.items() if iid in item_map}
        return PreparedData(user_map, item_map, user_side, item_side, seen,
                            item_categories=cats)


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

    def sanity_check(self) -> None:
        assert np.isfinite(self.user_factors).all(), "non-finite user factors"
        assert np.isfinite(self.item_factors).all(), "non-finite item factors"


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
    """Implicit ALS: trains on the device ``ctx`` names (None = cuda) and
    serves from there."""

    params_class = ALSParams
    query_cls = Query

    def train(self, ctx: Any, pd: PreparedData) -> ALSModel:
        from predictionio_tpu_torch.parallel.als_sharding import train_als_auto

        # a ComputeContext names the device; ctx=None means cuda
        dev = resolve_device(getattr(ctx, "device", None))
        X, Y = train_als_auto(pd.user_side, pd.item_side, self.params, dev)
        return ALSModel(X, Y, pd.user_map, pd.item_map, pd.seen,
                        item_categories=pd.item_categories, device=str(dev))

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
    """The template's engine. Its data-source map stays empty until the
    storage slice ports the event-store reader: register one (a
    ``PDataSource`` returning ``TrainingData`` or
    ``IndexedTrainingData``) to train."""
    return Engine({}, RatingsPreparator,
                  {"als": ALSAlgorithm, "": ALSAlgorithm},
                  {"": RecommendationServing})
