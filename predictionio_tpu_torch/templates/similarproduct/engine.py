"""Similar-product engine: view events -> ALS item factors -> item-to-item
cosine similarity.

The port's copy of ``predictionio_tpu/templates/similarproduct/engine.py``.

Capability parity with ``examples/scala-parallel-similarproduct``:

- DataSource reads ``$set`` user/item entities and ``view`` events
  (``DataSource.scala``); items carry a ``categories`` property
- ALSAlgorithm aggregates view counts per (user, item), trains implicit
  ALS, keeps the item ("product") factors
  (``filterbyyear/src/main/scala/ALSAlgorithm.scala:36-87``)
- predict: sum of cosine similarities of the query items' factors against
  every item, filtered by candidate rules — not a query item, category
  intersection, white/black lists (``ALSAlgorithm.scala:89-135``).
  The reference's per-item ``.par`` cosine map becomes ONE [Q,R]x[M,R]
  host matmul + reduction (``cosine_scores``).
- filterbyyear variant: items carry a ``year`` property and queries a
  ``recommendFromYear`` floor; candidates must satisfy
  ``year > recommendFromYear`` and results carry the year
  (``filterbyyear/src/main/scala/ALSAlgorithm.scala:225-240``,
  ``Engine.scala:10-23``)
- recommended-user variant: ALS on ``follow`` events (user -> user),
  user-to-user cosine recommendations with white/black lists
  (``recommended-user/src/main/scala/ALSAlgorithm.scala:44-168``)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    LFirstServing,
    LServing,
    P2LAlgorithm,
    Params,
    PDataSource,
    PIdentityPreparator,
)
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data.bimap import BiMap, StringIndexBiMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.parallel.als_sharding import (
    train_als_auto as _train_als_auto,
)
from predictionio_tpu_torch.ops.als import ALSParams, cosine_scores, pad_ratings


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str
    channel_name: Optional[str] = None
    # multi variant: also scan like/dislike events (an extra event-store
    # pass the base ALS engine never needs)
    read_like_events: bool = False
    # no-set-user variant: users come from the view events themselves —
    # no $set user entities required
    # (no-set-user/src/main/scala/ALSAlgorithm.scala:58: BiMap over
    # viewEvents.map(_.user))
    no_set_user: bool = False
    # add-and-return-item-properties variant: capture title/date/imdbUrl
    # into the model so the algorithm's return_item_properties flag can
    # serve them; off by default so base-flavor model blobs don't carry
    # strings they never serve
    read_item_properties: bool = False


@dataclasses.dataclass(frozen=True)
class Item:
    categories: Tuple[str, ...] = ()
    # filterbyyear variant (DataSource.scala:52/:100 there requires it;
    # merged template keeps it optional so the base flavor is unchanged)
    year: Optional[int] = None
    # add-and-return-item-properties variant
    # (add-and-return-item-properties/.../DataSource.scala:53-55)
    title: str = ""
    date: str = ""
    imdb_url: str = ""


@dataclasses.dataclass(frozen=True)
class ViewEvent:
    user: str
    item: str


@dataclasses.dataclass(frozen=True)
class LikeEvent:
    """like/dislike with time (multi variant, LikeAlgorithm.scala)."""
    user: str
    item: str
    like: bool
    t: float  # epoch seconds; latest event wins per (user, item)


@dataclasses.dataclass
class TrainingData:
    users: Dict[str, None]
    items: Dict[str, Item]
    view_events: List[ViewEvent]
    like_events: List[LikeEvent] = dataclasses.field(default_factory=list)
    # True when the DataSource captured title/date/imdbUrl (the
    # add-and-return-item-properties prerequisite)
    item_properties_read: bool = False

    def sanity_check(self) -> None:
        assert self.view_events, (
            "viewEvents in PreparedData cannot be empty. Please check if "
            "DataSource generates TrainingData correctly.")
        assert self.users, "users in PreparedData cannot be empty."
        assert self.items, "items in PreparedData cannot be empty."


@dataclasses.dataclass(frozen=True)
class Query:
    items: Tuple[str, ...] = ()
    num: int = 10
    categories: Tuple[str, ...] = ()
    white_list: Tuple[str, ...] = ()
    black_list: Tuple[str, ...] = ()
    # filterbyyear variant: only items with year > this floor recommend
    # (filterbyyear Engine.scala:12, ALSAlgorithm.scala:231)
    recommend_from_year: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class YearItemScore:
    """filterbyyear's ItemScore shape (its Engine.scala:19-23 adds the
    year). A distinct type so the BASE flavor's wire format stays
    byte-identical to the reference base template (no `year` key)."""

    item: str
    score: float
    year: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RichItemScore:
    """add-and-return-item-properties' ItemScore shape (its
    Engine.scala:18-24): results carry the stored item properties."""

    item: str
    title: str
    date: str
    imdb_url: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...]


class EventDataSource(PDataSource):
    """$set users/items + view events (similarproduct DataSource.scala).
    With ``no_set_user`` the user set is derived from the view events
    instead of $set entities (no-set-user variant)."""

    params_class = DataSourceParams

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        p: DataSourceParams = self.params
        def to_item(pm) -> Item:
            kw = {"categories": tuple(pm.get_opt("categories", list) or ()),
                  "year": pm.get_opt("year", int)}
            if p.read_item_properties:
                kw.update(title=pm.get_opt("title", str) or "",
                          date=pm.get_opt("date", str) or "",
                          imdb_url=pm.get_opt("imdbUrl", str) or "")
            return Item(**kw)

        items = {
            iid: to_item(pm)
            for iid, pm in PEventStore.aggregate_properties(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="item").items()
        }
        views = [
            ViewEvent(user=e.entity_id, item=e.target_entity_id)
            for e in PEventStore.find(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="user", event_names=["view"],
                target_entity_type="item")
        ]
        if p.no_set_user:
            # users are whoever viewed (no-set-user ALSAlgorithm.scala:58)
            users = {v.user: None for v in views}
        else:
            users = {
                uid: None
                for uid in PEventStore.aggregate_properties(
                    app_name=p.app_name, channel_name=p.channel_name,
                    entity_type="user")
            }
        likes: List[LikeEvent] = []
        if p.read_like_events:
            likes = [
                LikeEvent(user=e.entity_id, item=e.target_entity_id,
                          like=(e.event == "like"),
                          t=e.event_time.timestamp())
                for e in PEventStore.find(
                    app_name=p.app_name, channel_name=p.channel_name,
                    entity_type="user", event_names=["like", "dislike"],
                    target_entity_type="item")
            ]
        return TrainingData(users, items, views, likes,
                            item_properties_read=p.read_item_properties)


@dataclasses.dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None
    # add-and-return-item-properties variant: results carry the stored
    # item title/date/imdbUrl (RichItemScore). Ignored when a query's
    # recommend_from_year is set (that filter returns YearItemScore).
    return_item_properties: bool = False


@dataclasses.dataclass
class SimilarProductModel:
    """Item factors + maps + item metadata (ALSModel analog)."""

    product_features: np.ndarray      # [M, R]
    item_map: StringIndexBiMap
    items: Dict[int, Item]            # item index -> metadata

    def sanity_check(self) -> None:
        assert np.isfinite(self.product_features).all()


def _factors_from_ratings(ratings: Dict[Tuple[int, int], float],
                          n_rows: int, n_cols: int,
                          p: "ALSAlgorithmParams",
                          empty_msg: str, device: DeviceLike = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(row,col)->value dict -> implicit ALS factor pair, trained on the
    uniform tables on ``device`` (None = cuda: the two training
    kernels); the tail every flavor in this module shares."""
    if not ratings:
        raise ValueError(empty_msg)
    keys = np.asarray(list(ratings), dtype=np.int64)
    vals = np.asarray(list(ratings.values()), dtype=np.float32)
    params = ALSParams(rank=p.rank, num_iterations=p.num_iterations,
                       lambda_=p.lambda_,
                       seed=0 if p.seed is None else p.seed)
    return _train_als_auto(
        pad_ratings(keys[:, 0], keys[:, 1], vals, n_rows, n_cols),
        pad_ratings(keys[:, 1], keys[:, 0], vals, n_cols, n_rows),
        params, device)


def _train_item_model(ratings: Dict[Tuple[int, int], float],
                      user_map: StringIndexBiMap,
                      item_map: StringIndexBiMap,
                      item_meta: Dict[str, Item],
                      p: "ALSAlgorithmParams",
                      device: DeviceLike = None) -> SimilarProductModel:
    """Shared (user,item)->rating dict -> implicit ALS -> item-factor
    model tail used by ALSAlgorithm and LikeAlgorithm."""
    _, item_factors = _factors_from_ratings(
        ratings, len(user_map), len(item_map), p,
        "ratings cannot be empty. Please check if your events "
        "contain valid user and item ID.", device)
    items = {item_map[iid]: item for iid, item in item_meta.items()}
    return SimilarProductModel(item_factors, item_map, items)


def _filter_topk(scores: np.ndarray, idxs: List[int], num: int,
                 id_map: StringIndexBiMap,
                 white_list: Tuple[str, ...],
                 black_list: Tuple[str, ...],
                 extra_mask: Optional[np.ndarray] = None
                 ) -> List[Tuple[str, float, int]]:
    """The candidate-filter + top-k shared by every score-serving flavor
    (isCandidateItem / isCandidateSimilarUser in the reference variants):
    keep positive scores, drop the query rows themselves, apply
    white/black lists (and any variant-specific ``extra_mask``), return
    ``(decoded id, score, row index)`` descending."""
    scores = np.where(np.isfinite(scores), scores, 0.0)
    mask = scores > 0
    mask[np.asarray(idxs, dtype=np.int64)] = False
    if extra_mask is not None:
        mask &= extra_mask
    if white_list:
        white = {id_map[i] for i in white_list if i in id_map}
        keep = np.zeros_like(mask)
        if white:
            keep[np.asarray(list(white), dtype=np.int64)] = True
        mask &= keep
    for i in black_list:
        ix = id_map.get(i)
        if ix is not None:
            mask[ix] = False
    scores = np.where(mask, scores, -np.inf)
    k = min(num, int(mask.sum()))
    if k <= 0:
        return []
    top = np.argpartition(-scores, k - 1)[:k]
    top = top[np.argsort(-scores[top])]
    decoded = id_map.decode(top)
    return [(str(d), float(scores[ix]), int(ix))
            for d, ix in zip(decoded, top)]


def _category_mask(items: Dict[int, Item], n: int,
                   categories: Tuple[str, ...]) -> np.ndarray:
    """Candidate mask for the category-intersection rule shared by every
    similarproduct flavor (isCandidateItem's categories clause): items
    without an overlapping category — or without metadata — are out."""
    mask = np.zeros(n, dtype=bool)
    cats = set(categories)
    for ix, item in items.items():
        if cats.intersection(item.categories):
            mask[ix] = True
    return mask


def _cosine_topk(features: np.ndarray, idxs: List[int], num: int,
                 id_map: StringIndexBiMap,
                 white_list: Tuple[str, ...],
                 black_list: Tuple[str, ...],
                 extra_mask: Optional[np.ndarray] = None
                 ) -> List[Tuple[str, float, int]]:
    """Summed cosine scores of the query rows against all rows, then the
    shared candidate filter + top-k."""
    qf = features[np.asarray(idxs, dtype=np.int64)]
    scores = cosine_scores(qf, features)
    return _filter_topk(scores, idxs, num, id_map, white_list, black_list,
                        extra_mask)


class ALSAlgorithm(P2LAlgorithm):
    """Implicit ALS on view counts; keeps productFeatures
    (ALSAlgorithm.scala:36-87)."""

    params_class = ALSAlgorithmParams
    query_cls = Query

    def train(self, ctx: ComputeContext,
              pd: TrainingData) -> SimilarProductModel:
        p: ALSAlgorithmParams = self.params
        user_map = BiMap.string_int(pd.users)
        item_map = BiMap.string_int(pd.items)
        # aggregate all view events of the same user-item pair
        counts: Dict[Tuple[int, int], float] = {}
        for v in pd.view_events:
            u, i = user_map.get(v.user), item_map.get(v.item)
            if u is None or i is None:
                continue  # view of an entity without a $set (scala :59-66)
            counts[(u, i)] = counts.get((u, i), 0.0) + 1.0
        if getattr(p, "return_item_properties", False) \
                and not getattr(pd, "item_properties_read", False):
            # a mismatched flag pair would silently serve empty strings
            raise ValueError(
                "return_item_properties=True requires "
                "DataSourceParams(read_item_properties=True) so the "
                "title/date/imdbUrl properties are captured into the "
                "model")
        return _train_item_model(counts, user_map, item_map, pd.items, p,
                                 getattr(ctx, "device", None))

    def predict(self, model: SimilarProductModel,
                query: Query) -> PredictedResult:
        idxs = [model.item_map[i] for i in query.items
                if i in model.item_map]
        if not idxs:
            return PredictedResult(())
        extra = None
        year_filter = query.recommend_from_year is not None
        if query.categories or year_filter:
            n = model.product_features.shape[0]
            extra = (_category_mask(model.items, n, query.categories)
                     if query.categories else np.ones(n, dtype=bool))
            if year_filter:
                # year floor (filterbyyear ALSAlgorithm.scala:231): items
                # without a year never recommend under this filter,
                # matching the variant's required `year` property. Old
                # pickled models may predate the field -> getattr.
                for ix, item in model.items.items():
                    year = getattr(item, "year", None)
                    if year is None or year <= query.recommend_from_year:
                        extra[ix] = False
        winners = _cosine_topk(model.product_features, idxs, query.num,
                               model.item_map, query.white_list,
                               query.black_list, extra)
        if year_filter:
            # the filterbyyear variant's results carry the item year
            # (its Engine.scala:19-23); the base flavor's wire format
            # stays untouched
            return PredictedResult(tuple(
                YearItemScore(item=item, score=score,
                              year=getattr(model.items.get(ix, Item()),
                                           "year", None))
                for item, score, ix in winners))
        if getattr(self.params, "return_item_properties", False):
            # add-and-return-item-properties variant (its
            # Engine.scala:18-24); getattr guards old pickled Items
            def rich(item, score, ix):
                meta = model.items.get(ix, Item())
                return RichItemScore(
                    item=item, score=score,
                    title=getattr(meta, "title", ""),
                    date=getattr(meta, "date", ""),
                    imdb_url=getattr(meta, "imdb_url", ""))
            return PredictedResult(tuple(
                rich(*w) for w in winners))
        return PredictedResult(tuple(
            ItemScore(item=item, score=score)
            for item, score, _ in winners))


class LikeAlgorithm(ALSAlgorithm):
    """multi variant: ALS on like/dislike events — an user may flip
    opinion, so the LATEST event per (user, item) wins; like -> +1,
    dislike -> -1, trained with implicit confidence (negative value =
    negative signal). Mirrors ``multi/.../LikeAlgorithm.scala:21-102``."""

    def train(self, ctx: ComputeContext,
              pd: TrainingData) -> SimilarProductModel:
        p: ALSAlgorithmParams = self.params
        if not pd.like_events:
            raise ValueError(
                "likeEvents in PreparedData cannot be empty. Please check "
                "if DataSource generates TrainingData correctly.")
        user_map = BiMap.string_int(pd.users)
        item_map = BiMap.string_int(pd.items)
        latest: Dict[Tuple[int, int], Tuple[bool, float]] = {}
        for ev in pd.like_events:
            u, i = user_map.get(ev.user), item_map.get(ev.item)
            if u is None or i is None:
                continue
            prev = latest.get((u, i))
            if prev is None or ev.t > prev[1]:
                latest[(u, i)] = (ev.like, ev.t)
        ratings = {k: (1.0 if like else -1.0)
                   for k, (like, _) in latest.items()}
        return _train_item_model(ratings, user_map, item_map, pd.items, p,
                                 getattr(ctx, "device", None))


@dataclasses.dataclass(frozen=True)
class DIMSUMAlgorithmParams(Params):
    """DIMSUMAlgorithmParams (experimental similarproduct-dimsum,
    ``DIMSUMAlgorithm.scala:23``): similarities below ``threshold`` are
    dropped. Spark's columnSimilarities(threshold) SAMPLES to
    approximate high-similarity pairs cheaply; one device matmul
    computes them exactly here, so the threshold is an exact cut."""

    threshold: float = 0.0


@dataclasses.dataclass
class DIMSUMModel:
    """Item-item cosine similarity matrix + maps + item metadata
    (DIMSUMModel, ``DIMSUMAlgorithm.scala:25-52`` — the RDD of sparse
    similarity vectors becomes one dense [M, M] float32 table; item
    vocabularies at this template's scale fit comfortably)."""

    similarities: np.ndarray          # [M, M] float32, zero diagonal
    item_map: StringIndexBiMap
    items: Dict[int, Item]

    def sanity_check(self) -> None:
        assert np.isfinite(self.similarities).all()


class DIMSUMAlgorithm(P2LAlgorithm):
    """Item-to-item cosine similarity computed DIRECTLY from the binary
    user x item view matrix — no factorization
    (``DIMSUMAlgorithm.scala:72-140``: RowMatrix.columnSimilarities).
    Column-normalize the dense interaction matrix and take one fp32
    ``A^T A`` product on the context's device (None = cuda; TF32 off)
    instead of Spark's sampled shuffle."""

    params_class = DIMSUMAlgorithmParams
    query_cls = Query

    def train(self, ctx: ComputeContext,
              pd: TrainingData) -> DIMSUMModel:
        p: DIMSUMAlgorithmParams = self.params
        user_map = BiMap.string_int(pd.users)
        item_map = BiMap.string_int(pd.items)
        n_u, n_i = len(user_map), len(item_map)
        # binary de-duplicated (user, item) matrix ("keep one copy",
        # DIMSUMAlgorithm.scala:104-115)
        pairs = {(user_map[v.user], item_map[v.item])
                 for v in pd.view_events
                 if v.user in user_map and v.item in item_map}
        if not pairs:
            raise ValueError(
                "viewEvents produced no valid (user, item) pairs. Please "
                "check if your events contain valid user and item ID.")
        A = np.zeros((n_u, n_i), dtype=np.float32)
        keys = np.asarray(list(pairs), dtype=np.int64)
        A[keys[:, 0], keys[:, 1]] = 1.0
        sims = column_similarities(A, p.threshold,
                                   getattr(ctx, "device", None))
        items = {item_map[iid]: item for iid, item in pd.items.items()}
        return DIMSUMModel(sims, item_map, items)

    def predict(self, model: DIMSUMModel, query: Query) -> PredictedResult:
        idxs = [model.item_map[i] for i in query.items
                if i in model.item_map]
        if not idxs:
            return PredictedResult(())
        # sum the query items' similarity rows (DIMSUMAlgorithm.scala:
        # 153-180 flatMap + groupBy-sum), then the shared filters
        scores = model.similarities[np.asarray(idxs, dtype=np.int64)] \
            .sum(axis=0)
        extra = (_category_mask(model.items, len(scores),
                                query.categories)
                 if query.categories else None)
        winners = _filter_topk(scores, idxs, query.num, model.item_map,
                               query.white_list, query.black_list, extra)
        return PredictedResult(tuple(
            ItemScore(item=item, score=score)
            for item, score, _ in winners))


def column_similarities(A: np.ndarray, threshold: float,
                        device: DeviceLike = None) -> np.ndarray:
    """Cosine similarity of every pair of columns of ``A [N, M]``, the
    diagonal zeroed and entries below ``threshold`` dropped: one fp32
    ``A_n^T A_n`` product on ``device`` (None = cuda), returned to the
    host as ``[M, M]`` float32."""
    import torch

    dev = resolve_device(device)
    At = torch.as_tensor(A, dtype=torch.float32, device=dev)
    norms = torch.clamp(torch.linalg.vector_norm(At, dim=0), min=1e-12)
    An = At / norms[None, :]
    S = torch.matmul(An.T, An)
    S = S * (1.0 - torch.eye(S.shape[0], dtype=S.dtype, device=dev))
    S = torch.where(S >= threshold, S, torch.zeros((), dtype=S.dtype,
                                                     device=dev))
    return S.cpu().numpy()


class MultiServing(LServing):
    """multi variant Serving: z-score standardize each algorithm's scores
    (skipped for num==1), then sum per item and take top num
    (``multi/.../Serving.scala:16-52``)."""

    def serve(self, query: Query,
              predictions: List[PredictedResult]) -> PredictedResult:
        if query.num == 1:
            standardized = [pr.item_scores for pr in predictions]
        else:
            standardized = []
            for pr in predictions:
                scores = np.asarray([s.score for s in pr.item_scores],
                                    dtype=np.float64)
                if len(scores) and scores.std() > 0:
                    z = (scores - scores.mean()) / scores.std()
                else:
                    z = np.zeros_like(scores)
                standardized.append(tuple(
                    ItemScore(s.item, float(zs))
                    for s, zs in zip(pr.item_scores, z)))
        combined: Dict[str, float] = {}
        for group in standardized:
            for s in group:
                combined[s.item] = combined.get(s.item, 0.0) + s.score
        ranked = sorted(combined.items(), key=lambda kv: -kv[1])
        return PredictedResult(tuple(
            ItemScore(item=k, score=v)
            for k, v in ranked[:query.num]))


# ---------------------------------------------------------------------------
# recommended-user variant: who to follow
# (examples/scala-parallel-similarproduct/recommended-user/)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UserQuery:
    """recommended-user Engine.scala:6-13: query by user IDs."""

    users: Tuple[str, ...] = ()
    num: int = 10
    white_list: Tuple[str, ...] = ()
    black_list: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SimilarUserScore:
    user: str
    score: float


@dataclasses.dataclass(frozen=True)
class RecommendedUsersResult:
    similar_user_scores: Tuple[SimilarUserScore, ...]


@dataclasses.dataclass
class FollowTrainingData:
    users: Dict[str, None]
    follow_events: List[ViewEvent]  # user -> followed user (reuses shape)

    def sanity_check(self) -> None:
        assert self.follow_events, (
            "followEvents in PreparedData cannot be empty. Please check "
            "if DataSource generates TrainingData correctly.")
        assert self.users, "users in PreparedData cannot be empty."


class FollowDataSource(PDataSource):
    """$set users + follow events (recommended-user DataSource.scala:
    user -> followedUser, both entity types 'user')."""

    params_class = DataSourceParams

    def read_training(self, ctx: ComputeContext) -> FollowTrainingData:
        p: DataSourceParams = self.params
        users = {
            uid: None
            for uid in PEventStore.aggregate_properties(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="user")
        }
        follows = [
            ViewEvent(user=e.entity_id, item=e.target_entity_id)
            for e in PEventStore.find(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="user", event_names=["follow"],
                target_entity_type="user")
        ]
        return FollowTrainingData(users, follows)


@dataclasses.dataclass
class RecommendedUserModel:
    """similarUserFeatures + one shared user map
    (recommended-user ALSAlgorithm.scala:18-34)."""

    similar_user_features: np.ndarray  # [N, R]
    user_map: StringIndexBiMap

    def sanity_check(self) -> None:
        assert np.isfinite(self.similar_user_features).all()


class RecommendedUserAlgorithm(P2LAlgorithm):
    """Implicit ALS on follow counts over one user x user matrix; the
    'product' factors are the followed-user features served by cosine
    (recommended-user ALSAlgorithm.scala:44-168)."""

    params_class = ALSAlgorithmParams
    query_cls = UserQuery

    def train(self, ctx: ComputeContext,
              pd: FollowTrainingData) -> RecommendedUserModel:
        p: ALSAlgorithmParams = self.params
        user_map = BiMap.string_int(pd.users)
        counts: Dict[Tuple[int, int], float] = {}
        for f in pd.follow_events:
            u, v = user_map.get(f.user), user_map.get(f.item)
            if u is None or v is None:
                continue  # follow of an un-$set user (scala :66-80)
            counts[(u, v)] = counts.get((u, v), 0.0) + 1.0
        n = len(user_map)
        _, followed_factors = _factors_from_ratings(
            counts, n, n, p,
            "mllibRatings cannot be empty. Please check if your "
            "events contain valid user and followedUser ID.",
            getattr(ctx, "device", None))
        return RecommendedUserModel(followed_factors, user_map)

    def predict(self, model: RecommendedUserModel,
                query: UserQuery) -> RecommendedUsersResult:
        idxs = [model.user_map[u] for u in query.users
                if u in model.user_map]
        if not idxs:
            return RecommendedUsersResult(())
        winners = _cosine_topk(model.similar_user_features, idxs,
                               query.num, model.user_map,
                               query.white_list, query.black_list)
        return RecommendedUsersResult(tuple(
            SimilarUserScore(user=user, score=score)
            for user, score, _ in winners))


def engine_factory() -> Engine:
    """SimilarProductEngine (similarproduct Engine.scala)."""
    return Engine(
        EventDataSource,
        PIdentityPreparator,
        {"als": ALSAlgorithm, "": ALSAlgorithm},
        LFirstServing,
    )


def engine_factory_recommended_user() -> Engine:
    """RecommendedUserEngine (recommended-user Engine.scala:22-30)."""
    return Engine(
        FollowDataSource,
        PIdentityPreparator,
        {"als": RecommendedUserAlgorithm, "": RecommendedUserAlgorithm},
        LFirstServing,
    )


def engine_factory_dimsum() -> Engine:
    """DIMSUM variant: similarities from the raw interaction matrix
    instead of factors (experimental scala-parallel-similarproduct-dimsum
    Engine.scala)."""
    return Engine(
        EventDataSource,
        PIdentityPreparator,
        {"dimsum": DIMSUMAlgorithm, "": DIMSUMAlgorithm},
        LFirstServing,
    )


def engine_factory_multi() -> Engine:
    """multi variant: ALS + LikeAlgorithm ensemble combined by z-score
    serving (``multi/.../Engine.scala:29-33``)."""
    return Engine(
        EventDataSource,
        PIdentityPreparator,
        {"als": ALSAlgorithm, "likealgo": LikeAlgorithm},
        MultiServing,
    )
