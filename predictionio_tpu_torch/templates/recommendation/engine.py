"""Recommendation engine: ratings -> implicit ALS -> top-N items.

The port's copy of ``predictionio_tpu/templates/recommendation/engine.py``:

- ``EventDataSource`` (``rate`` / ``view`` events through
  ``PEventStore``, in one columnar scan or streamed in blocks, serially
  or pipelined, with the items' ``$set`` categories), training data
  (``Rating``,
  ``TrainingData``, ``IndexedTrainingData``), ``RatingsPreparator``
  (entity ids to indices, then the uniform or the length-bucketed
  layout) and ``ALSAlgorithm.train`` (through ``train_als_auto`` and the
  two training kernels);
- the query path: the query and result types, ``ALSModel`` (host
  factors and maps, served through
  :func:`~predictionio_tpu_torch.ops.serving.choose_server`), the shared
  top-k serving logic, ``ALSAlgorithm.predict`` / ``batch_predict``, and
  the custom-serving variant ``FileBlacklistServing`` (``"fileblacklist"``);
- the PAlgorithm flavor, ``sharded_engine_factory``: ``ALSShardedAlgorithm``
  trains with ``train_als_device`` over the context's mesh and keeps the
  factors there as a ``ShardedALSModel`` (persisted ``RETRAIN``), served
  over the mesh's devices;
- evaluation: ``EventDataSource.read_eval`` (leave-last-out per user, or
  sliding time windows with ``eval_count > 0``), ``ActualResult``,
  ``PrecisionAtK`` / ``NDCGAtK``, and ``RecommendationEvaluation``, the
  ``pio eval`` entry over ``RecommendationParamsList``'s grid.

A model may also be carried over from arrays with
:func:`predictionio_tpu_torch.weights.als_model_from_numpy`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    LFirstServing,
    LServing,
    OptionAverageMetric,
    P2LAlgorithm,
    PAlgorithm,
    Params,
    PDataSource,
    PPreparator,
)
from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.als import (
    ALSParams,
    bucket_ratings_pair,
    pad_ratings,
)


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    """Field for field the JAX template's, so an engine.json written for
    it parses here. ``streaming_block_size`` streams the read in
    columnar blocks through an incremental indexer (no whole-store
    object columns); None keeps the single-scan read.
    ``pipelined_ingest`` (with ``streaming_block_size``) sorts each
    block as it arrives and merges the sorted runs natively, so the
    preparator's dedup gets sorted triples; ``decode_prefetch`` lets
    the store decode that many partitions ahead (``jsonlfs``).
    ``read_item_categories`` also reads each item's ``$set``
    categories, for category queries. ``eval_count > 0`` makes
    ``read_eval`` slide time windows: eval set ``k`` trains on the events
    before ``eval_first_until`` (ISO-8601) ``+ k * eval_duration_days``
    and tests on the next window; 0 keeps leave-last-out."""

    app_name: str
    event_names: Tuple[str, ...] = ("rate",)
    channel_name: Optional[str] = None
    streaming_block_size: Optional[int] = None
    pipelined_ingest: bool = False
    decode_prefetch: int = 0
    read_item_categories: bool = False
    eval_first_until: Optional[str] = None
    eval_duration_days: float = 7.0
    eval_count: int = 0


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


def _training_data_prechecked(users: np.ndarray, items: np.ndarray,
                              values: np.ndarray) -> TrainingData:
    """TrainingData from columns already checked for None ids: the
    sliding windows slice one checked scan per window."""
    td = TrainingData.__new__(TrainingData)
    td.users, td.items, td.values = users, items, values
    td.item_categories = None
    td._ratings = None
    return td


class IndexedTrainingData:
    """Already-indexed rating triples: int64 user/item codes plus their
    BiMaps. The preparator takes them as they are, so no whole-store
    string columns are ever built. ``runs``, when the triples arrived in
    blocks in stream order, holds where each block begins (``[0, ...,
    n]``): the preparator's dedup sort then sorts each block on its own
    and merges them natively; the pipelined read hands over triples
    already sorted by (row, col) and no runs. ``timeline``, from a
    streamed read, holds its stages' spans (decode, index, and merge or
    finalize)."""

    def __init__(self, user_map: StringIndexBiMap,
                 item_map: StringIndexBiMap, rows: np.ndarray,
                 cols: np.ndarray, values: np.ndarray,
                 runs: Optional[np.ndarray] = None):
        self.user_map = user_map
        self.item_map = item_map
        self.rows = rows
        self.cols = cols
        self.values = values
        self.runs = runs
        self.item_categories: Optional[Dict[str, Tuple[str, ...]]] = None
        self.timeline = None

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def sanity_check(self) -> None:
        assert len(self), (
            "ratings in TrainingData cannot be empty. Please check if "
            "DataSource generates TrainingData correctly.")


class EventDataSource(PDataSource):
    """Reads rating events: ``rate`` -> its ``rating`` property, any
    other event name -> an implicit 1.0. One columnar scan, or with
    ``streaming_block_size`` bounded blocks through an incremental
    indexer, read on a background thread (pipelined with
    ``pipelined_ingest``)."""

    params_class = DataSourceParams

    def read_training(self, ctx: Any) -> Any:
        return self._read_training(pipelined=None)

    def _read_training(self, pipelined: Optional[bool]) -> Any:
        """``pipelined=None`` follows the params; ``False`` forces the
        serial builder (an evaluation split consumes the raw triple
        order, and the pipelined read returns merged (row, col)
        order)."""
        p: DataSourceParams = self.params
        if p.pipelined_ingest and not p.streaming_block_size:
            raise ValueError(
                "pipelined_ingest requires streaming_block_size: the "
                "pipelined builder consumes streamed columnar blocks "
                "(set datasource {\"streamingBlockSize\": N} alongside "
                "\"pipelinedIngest\": true)")
        if pipelined is None:
            pipelined = bool(p.pipelined_ingest)
        if p.streaming_block_size:
            from predictionio_tpu_torch.data.columnar import (
                PipelinedRatingsBuilder,
                StreamingRatingsBuilder,
                iter_blocks_threaded,
            )
            from predictionio_tpu_torch.utils.tracing import StageTimeline

            builder = (PipelinedRatingsBuilder() if pipelined
                       else StreamingRatingsBuilder())
            timeline = StageTimeline()
            blocks = PEventStore.find_columnar_blocks(
                app_name=p.app_name,
                channel_name=p.channel_name,
                entity_type="user",
                event_names=list(p.event_names),
                target_entity_type="item",
                value_property="rating",
                default_value=1.0,
                block_size=int(p.streaming_block_size),
                prefetch=int(p.decode_prefetch))
            # decode thread + indexing consumer overlap (bounded queue)
            for block in iter_blocks_threaded(
                    timeline.wrap_iter(blocks, "decode")):
                with timeline.scope("index"):
                    builder.add_block(block)
            with timeline.scope("merge" if pipelined else "finalize"):
                td = IndexedTrainingData(
                    *builder.finalize(),
                    runs=None if pipelined else builder.run_offsets)
            td.timeline = timeline
        else:
            batch = PEventStore.find_columnar(
                app_name=p.app_name,
                channel_name=p.channel_name,
                entity_type="user",
                event_names=list(p.event_names),
                target_entity_type="item",
                value_property="rating",
                default_value=1.0)
            td = TrainingData(users=batch.entity_ids,
                              items=batch.target_ids, values=batch.values)
        td.item_categories = read_item_categories(p)
        return td

    def read_eval(self, ctx: Any):
        """Leave-last-out per user by default: each user's last rating in
        stream order is held out. With ``eval_count > 0``: time-sliding
        windows (:meth:`_sliding_eval`)."""
        p: DataSourceParams = self.params
        if p.eval_count > 0:
            return self._sliding_eval(p)
        from predictionio_tpu_torch.data.sliding import leave_last_out

        # the serial builder even under pipelined_ingest: leave-last-out
        # splits on the raw triple order, which the pipelined read does
        # not keep
        td = self._read_training(pipelined=False)
        if isinstance(td, IndexedTrainingData):
            td = TrainingData(users=td.user_map.decode(td.rows),
                              items=td.item_map.decode(td.cols),
                              values=td.values)
        by_user: Dict[str, List[Rating]] = {}
        for r in td.ratings:
            by_user.setdefault(r.user, []).append(r)
        train, holdouts = leave_last_out(by_user)
        qa = [(Query(user=user, num=10), ActualResult([held.item]))
              for user, held in holdouts]
        return [(TrainingData(train), EmptyEvalInfo(), qa)]

    def _sliding_eval(self, p: DataSourceParams):
        """For k in range(eval_count): train on the events before
        ``first_until + k * duration`` and hold out each user's items in
        the following window as the actuals."""
        import datetime as _dt

        from predictionio_tpu_torch.data.event import _parse_time
        from predictionio_tpu_torch.data.sliding import sliding_window_masks

        if not p.eval_first_until:
            raise ValueError(
                "eval_count > 0 requires eval_first_until (ISO-8601)")
        if p.streaming_block_size:
            raise ValueError(
                "sliding-window eval materializes the scanned window and "
                "is incompatible with streaming_block_size; drop one of "
                "the two (the scan is bounded to the eval horizon)")
        first_until = _parse_time(p.eval_first_until)
        t0 = first_until.timestamp()
        dur = float(p.eval_duration_days) * 86400.0
        horizon = first_until + _dt.timedelta(
            seconds=dur * int(p.eval_count))
        # the scan never needs events past the last test window
        batch = PEventStore.find_columnar(
            app_name=p.app_name, channel_name=p.channel_name,
            entity_type="user", event_names=list(p.event_names),
            target_entity_type="item", value_property="rating",
            default_value=1.0, until_time=horizon)
        # check the id columns once; each window slices them
        TrainingData(users=batch.entity_ids, items=batch.target_ids,
                     values=batch.values)
        sets = []
        for _k, train_mask, test_mask in sliding_window_masks(
                batch.event_times, t0, dur, int(p.eval_count),
                hint="move eval_first_until later or reduce eval_count"):
            td = _training_data_prechecked(
                batch.entity_ids[train_mask], batch.target_ids[train_mask],
                batch.values[train_mask])
            held: Dict[str, List[str]] = {}
            for u, i in zip(batch.entity_ids[test_mask],
                            batch.target_ids[test_mask]):
                held.setdefault(str(u), []).append(str(i))
            qa = [(Query(user=u, num=10), ActualResult(items))
                  for u, items in held.items()]
            sets.append((td, EmptyEvalInfo(), qa))
        return sets


def read_item_categories(p: DataSourceParams
                         ) -> Optional[Dict[str, Tuple[str, ...]]]:
    """Each item's ``$set`` categories, or None when the variant does
    not ask for them."""
    if not p.read_item_categories:
        return None
    return {
        iid: tuple(pm.get_opt("categories", list) or ())
        for iid, pm in PEventStore.aggregate_properties(
            app_name=p.app_name, channel_name=p.channel_name,
            entity_type="item").items()
    }


@dataclasses.dataclass(frozen=True)
class EmptyEvalInfo:
    pass


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


@dataclasses.dataclass(frozen=True)
class ActualResult:
    items: Tuple[str, ...]

    def __init__(self, items: Sequence[str]):
        object.__setattr__(self, "items", tuple(items))


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
        runs = None
        if isinstance(td, IndexedTrainingData):
            user_map, item_map = td.user_map, td.item_map
            rows = np.asarray(td.rows, dtype=np.int64)
            cols = np.asarray(td.cols, dtype=np.int64)
            runs = td.runs
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
                rows, cols, vals, n_u, n_i, max_len=max_len, runs=runs)
        else:
            user_side = pad_ratings(rows, cols, vals, n_u, n_i,
                                    max_len=max_len, runs=runs)
            item_side = pad_ratings(cols, rows, vals, n_i, n_u,
                                    max_len=max_len, runs=runs)
        return PreparedData(
            user_map, item_map, user_side, item_side,
            seen_lists(rows, cols, n_u),
            item_categories=index_categories(
                getattr(td, "item_categories", None), item_map))


def seen_lists(rows: np.ndarray, cols: np.ndarray,
               n_rows: int) -> Dict[int, np.ndarray]:
    """Each user's rated items, through one stable sort."""
    order = np.argsort(rows, kind="stable")
    s_rows, s_cols = rows[order], cols[order]
    starts = np.searchsorted(s_rows, np.arange(n_rows))
    ends = np.searchsorted(s_rows, np.arange(n_rows), side="right")
    return {u: s_cols[starts[u]:ends[u]] for u in range(n_rows)}


def index_categories(raw: Optional[Dict[str, Tuple[str, ...]]],
                     item_map: StringIndexBiMap
                     ) -> Optional[Dict[int, Tuple[str, ...]]]:
    """Item id -> categories as item index -> categories (items the
    ratings never name are dropped)."""
    if raw is None:
        return None
    return {item_map[iid]: tuple(c) for iid, c in raw.items()
            if iid in item_map}


class _DeviceServedModel:
    """The device-serving plumbing every served model shares: the server
    built on first use by the model's ``_make_server`` hook, under a lock
    (concurrent first queries must not each build a store), and a pickle
    that drops the device handles, the lock and the caches derived from
    the host fields (they rebuild on demand)."""

    _server: Any = None
    # the device plane a deployment hands the model (its context's mesh,
    # ``ComputeContext.serving_plane``); None serves on ``device``
    serve_plane: Any = None

    def _make_server(self):
        raise NotImplementedError

    def _serve_device(self):
        """Where the store is built: the deployment's plane, else the
        model's ``device``."""
        return self.device if self.serve_plane is None else self.serve_plane

    def device_server(self):
        with self._server_lock:
            if self._server is None:
                self._server = self._make_server()
            return self._server

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_server"] = None
        state.pop("_server_lock", None)
        state.pop("serve_plane", None)
        state.pop("_cat_index", None)
        state.pop("_cat_black_cache", None)
        state.pop("_theta_device", None)  # the sequentialrec device cache
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._server_lock = threading.Lock()


@dataclasses.dataclass
class ALSModel(_DeviceServedModel):
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
    _server_lock: Any = dataclasses.field(default_factory=threading.Lock,
                                          repr=False, compare=False)

    def _make_server(self):
        from predictionio_tpu_torch.ops.serving import choose_server

        return choose_server(self.user_factors, self.item_factors, self.seen,
                             device=self._serve_device())

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
    and (with ``positive_only``, implicit ALS) non-positive scores, clip
    to num. A model whose scores are only relatively calibrated (the
    sequentialrec encoder's logits) sets ``serve_positive_scores_only =
    False``: a user whose unseen items all score below zero still has a
    ranking, and only the device's -inf masks drop."""
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
    return _winners_to_result(
        idx, scores, black, query.num, item_map,
        positive_only=getattr(model, "serve_positive_scores_only", True))


class _DeviceServingAlgo:
    """Predict, batch-predict and warm-up for every model served by
    :class:`~predictionio_tpu_torch.ops.serving.DeviceTopK`."""

    def warmup_base(self, model) -> None:
        """Build the server (and the kernel, on the GPU) at deploy so the
        first real query pays neither."""
        if len(model.user_map):
            model.device_server().warmup()

    def predict(self, model, query: Query) -> PredictedResult:
        return _serve_topk(model.device_server(), model, _coerce_query(query))

    def _batched_predict(self, model, indexed_queries
                         ) -> List[Tuple[int, Any]]:
        """Known-user queries grouped per k and dispatched through
        ``users_topk`` (one launch per group); item-similarity,
        category and unknown-user queries take the per-query path."""
        queries = [(qx, _coerce_query(q)) for qx, q in indexed_queries]
        server = model.device_server()
        positive = getattr(model, "serve_positive_scores_only", True)
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
                    idx[row], scores[row], black, num, model.item_map,
                    positive_only=positive)
        return [(qx, results[qx]) for qx, _ in queries]


class ALSAlgorithm(_DeviceServingAlgo, P2LAlgorithm):
    """Implicit ALS: trains on the device ``ctx`` names (None = cuda) and
    serves from there."""

    params_class = ALSParams
    query_cls = Query

    def train(self, ctx: Any, pd: PreparedData) -> ALSModel:
        from predictionio_tpu_torch.parallel.als_sharding import train_als_auto
        from predictionio_tpu_torch.workflow import runlog
        from predictionio_tpu_torch.workflow.checkpoint import (
            bimap_fingerprint_scope,
        )

        # a ComputeContext names the device, or a plane of several
        # (sharded training over it); ctx=None means cuda
        plane = _training_plane(ctx)
        dev = plane[0] if isinstance(plane, list) else plane
        # the entity maps join the checkpoint fingerprint (two stores of
        # the same shapes but other entities never resume each other's
        # checkpoints; a no-op while checkpointing is off), and the run
        # context stamps the run log's header for `pio runs list`
        with bimap_fingerprint_scope(pd.user_map, pd.item_map), \
                runlog.run_context_scope(
                    template="recommendation",
                    nUsers=pd.user_side.n_rows,
                    nItems=pd.user_side.n_cols):
            X, Y = train_als_auto(pd.user_side, pd.item_side, self.params,
                                  plane)
        return ALSModel(X, Y, pd.user_map, pd.item_map, pd.seen,
                        item_categories=pd.item_categories, device=str(dev))

    def batch_predict(self, ctx: Any, model: ALSModel,
                      indexed_queries) -> List[Tuple[int, Any]]:
        return self._batched_predict(model, indexed_queries)


def _training_plane(ctx):
    """Where ``ALSAlgorithm`` trains: the context's devices when it names
    several (a list: the sharded trainers), else its one device (None =
    cuda)."""
    if ctx is not None and getattr(ctx, "device_count", 1) > 1:
        return list(ctx.devices)
    return resolve_device(getattr(ctx, "device", None))


def _context_mesh(ctx):
    """The mesh ``ALSShardedAlgorithm`` trains over: the context's mesh
    when it names its devices or one device, else None (every visible
    card, laid out by ``train_als_device``)."""
    if ctx is None:
        return None
    if getattr(ctx, "serving_plane", None) is not None:
        return ctx.serving_plane
    if getattr(ctx, "device", None) is not None:
        return ctx.mesh
    return None


@dataclasses.dataclass
class ShardedALSModel(_DeviceServedModel):
    """A device-resident model: the factor tables stay on the mesh they
    trained on (padded :class:`~predictionio_tpu_torch.parallel.mesh.
    ShardedTensor` s from ``train_als_device``) and never reach the
    host: the reference's PAlgorithm, whose model lives distributed.
    Served by :class:`~predictionio_tpu_torch.ops.serving.DeviceTopK`
    over the mesh's devices (or the deployment's plane), with the item
    layout the model carries. It does not pickle: its engine persists
    ``RETRAIN`` and trains again at deploy."""

    user_factors: Any            # ShardedTensor [N_pad, R]
    item_factors: Any            # ShardedTensor [M_pad, R]
    n_users: int
    n_items: int
    user_map: StringIndexBiMap
    item_map: StringIndexBiMap
    seen: Dict[int, np.ndarray]
    item_categories: Optional[Dict[int, Tuple[str, ...]]] = None
    # the density-aware item layout of a sharded store
    # (parallel.als_sharding.ItemShardLayout), carried with the model so
    # serving and fold-in see one placement; None serves unsharded
    item_layout: Any = None
    _server: Any = dataclasses.field(default=None, repr=False, compare=False)
    _server_lock: Any = dataclasses.field(default_factory=threading.Lock,
                                          repr=False, compare=False)

    def _make_server(self):
        from predictionio_tpu_torch.ops.serving import DeviceTopK

        plane = self.serve_plane if self.serve_plane is not None \
            else self.user_factors.mesh
        # the whole tables gathered on the first device, device to device
        return DeviceTopK(
            self.user_factors.gathered(), self.item_factors.gathered(),
            self.seen, n_users=self.n_users, n_items=self.n_items,
            item_layout=self.item_layout, device=plane)

    def sanity_check(self) -> None:
        # a reduction on the device: the factors are not gathered
        assert self.user_factors.all_finite(), "non-finite user factors"
        assert self.item_factors.all_finite(), "non-finite item factors"

    def __getstate__(self):
        raise TypeError(
            "a ShardedALSModel lives on its device mesh and does not "
            "pickle; its engine persists RETRAIN and trains again at "
            "deploy")


class ALSShardedAlgorithm(_DeviceServingAlgo, PAlgorithm):
    """The PAlgorithm flavor of ALS: trains with ``train_als_device``
    over the context's mesh and serves from the device tables; no host
    copy of the factors exists at any point."""

    params_class = ALSParams
    query_cls = Query

    def train(self, ctx: Any, pd: PreparedData) -> ShardedALSModel:
        from predictionio_tpu_torch.ops.als import item_interaction_counts
        from predictionio_tpu_torch.parallel.als_sharding import (
            density_aware_item_layout,
            train_als_device,
        )
        from predictionio_tpu_torch.workflow import runlog
        from predictionio_tpu_torch.workflow.checkpoint import (
            bimap_fingerprint_scope,
        )

        mesh = _context_mesh(ctx)
        with bimap_fingerprint_scope(pd.user_map, pd.item_map), \
                runlog.run_context_scope(
                    template="recommendation-sharded",
                    nUsers=pd.user_side.n_rows,
                    nItems=pd.user_side.n_cols):
            X, Y = train_als_device(pd.user_side, pd.item_side, self.params,
                                    mesh)
        # over several devices the item store takes the density-aware
        # layout (the power-law head spread over the shards); it travels
        # in the model
        layout = None
        n_dev = X.mesh.size
        if n_dev > 1:
            layout = density_aware_item_layout(
                item_interaction_counts(pd.item_side), n_dev)
        return ShardedALSModel(
            X, Y, pd.user_side.n_rows, pd.user_side.n_cols,
            pd.user_map, pd.item_map, pd.seen,
            item_categories=pd.item_categories, item_layout=layout)

    def batch_predict(self, ctx: Any, model: ShardedALSModel,
                      indexed_queries) -> List[Tuple[int, Any]]:
        """Known-user queries grouped into ``users_topk`` dispatches
        against the device shards: one round trip a group."""
        return self._batched_predict(model, indexed_queries)


class RecommendationServing(LFirstServing):
    """First-serving: the single algorithm's result."""


@dataclasses.dataclass(frozen=True)
class ServingParams(Params):
    """The custom-serving variant's params: the file that lists disabled
    item ids, one per line."""

    filepath: str = "disabled.txt"


class FileBlacklistServing(LServing):
    """The custom-serving variant: re-reads the disabled-items file on
    every query (so an operator can edit it under a live server) and
    drops those items from the first algorithm's result."""

    params_class = ServingParams

    def serve(self, query: Query,
              predictions: List[PredictedResult]) -> PredictedResult:
        import os

        filepath = getattr(self.params, "filepath", "disabled.txt")
        disabled = set()
        if os.path.exists(filepath):
            with open(filepath, "r", encoding="utf-8") as f:
                disabled = {ln.strip() for ln in f if ln.strip()}
        head = predictions[0]
        return PredictedResult(tuple(
            s for s in head.item_scores if s.item not in disabled))


class PrecisionAtK(OptionAverageMetric):
    """Precision@k on top-N recommendations: for each (query, predicted,
    actual), the share of the top k recommended items found in the
    held-out actuals; None (skipped) when the user has no actuals."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"Precision@{self.k}"

    def calculate_qpa(self, q: Query, p: PredictedResult,
                      a: ActualResult) -> Optional[float]:
        if not a.items:
            return None
        actual = set(a.items)
        top = [s.item for s in p.item_scores[:self.k]]
        if not top:
            return 0.0
        return sum(1 for i in top if i in actual) / float(self.k)


class NDCGAtK(OptionAverageMetric):
    """NDCG@k on top-N recommendations (binary relevance,
    :func:`~predictionio_tpu_torch.data.sliding.ndcg_at_k`): rank position
    counts, unlike :class:`PrecisionAtK`."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def header(self) -> str:
        return f"NDCG@{self.k}"

    def calculate_qpa(self, q: Query, p: PredictedResult,
                      a: ActualResult) -> Optional[float]:
        if not a.items:
            return None
        from predictionio_tpu_torch.data.sliding import ndcg_at_k

        return ndcg_at_k([s.item for s in p.item_scores], a.items, self.k)


class RecommendationParamsList(EngineParamsGenerator):
    """The default tuning grid: rank in (8, 16) x lambda in (0.01, 0.1),
    10 iterations, seed 3."""

    def __init__(self, app_name: str = "recommendation-app"):
        super().__init__()
        self.engine_params_list = [
            EngineParams(
                data_source_params=("", DataSourceParams(app_name=app_name)),
                algorithm_params_list=[
                    ("als", ALSParams(rank=rank, num_iterations=10,
                                      lambda_=lam, seed=3))])
            for rank in (8, 16)
            for lam in (0.01, 0.1)
        ]


class RecommendationEvaluation(Evaluation, RecommendationParamsList):
    """The ``pio eval`` entry: the ALS grid scored by Precision@10, the
    best params written to ``best.json``. It is its own params generator,
    so ``pio eval <this class>`` needs no second argument and ``app_name``
    reaches every grid point's data source."""

    def __init__(self, app_name: str = "recommendation-app", k: int = 10):
        Evaluation.__init__(self)
        RecommendationParamsList.__init__(self, app_name=app_name)
        self.engine_metric = (engine_factory(), PrecisionAtK(k))


def engine_factory() -> Engine:
    """The template's engine: the event-store data source, the
    preparator, ALS under ``"als"`` (and ``""``), first serving under
    ``""`` and the custom-serving variant under ``"fileblacklist"``
    (chosen by engine.json's serving section)."""
    return Engine(EventDataSource, RatingsPreparator,
                  {"als": ALSAlgorithm, "": ALSAlgorithm},
                  {"": RecommendationServing,
                   "fileblacklist": FileBlacklistServing})


def sharded_engine_factory() -> Engine:
    """The engine whose model stays on its device mesh (the PAlgorithm
    flavor): deploy trains again (``RETRAIN``) and serves from the
    device."""
    return Engine(EventDataSource, RatingsPreparator,
                  {"als": ALSShardedAlgorithm, "": ALSShardedAlgorithm},
                  RecommendationServing)
