"""E-commerce recommendation engine: ALS + live business-rule filters.

The port's copy of
``predictionio_tpu/templates/ecommercerecommendation/engine.py``.

Capability parity with ``examples/scala-parallel-ecommercerecommendation/
train-with-rate-event``:

- DataSource reads ``$set`` user/item entities plus ``view`` and ``buy``
  events; a ``buy`` counts stronger than a ``view`` (the rate-event
  variant's weighting)
- ECommAlgorithm trains implicit ALS keeping BOTH factor matrices
  (``ALSAlgorithm.scala:10-29``: userFeatures + productFeatures), on
  the context's device (None = cuda: the two training kernels); queries
  score on the host (``predict_scores_for_user`` / ``cosine_scores``)
- predict applies live constraints read from the event store at query
  time (``ALSAlgorithm.scala predict``):
  - ``unseen_only``: drop items the user already touched (live
    LEventStore read of ``seen_events``)
  - the latest ``$set`` on entity ``constraint/unavailableItems`` is a
    dynamic blacklist
  - category / whiteList / blackList filters
- unknown user falls back to recent-view similarity (the template's
  recentFeatures path): cosine of the user's latest viewed items'
  factors against the catalog
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    LFirstServing,
    P2LAlgorithm,
    Params,
    PDataSource,
    PIdentityPreparator,
)
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data.bimap import BiMap, StringIndexBiMap
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.parallel.als_sharding import (
    train_als_auto as _train_als_auto,
)
from predictionio_tpu_torch.ops.als import (
    ALSParams,
    cosine_scores,
    pad_ratings,
    predict_scores_for_user,
)

logger = logging.getLogger("pio.templates.ecommerce")


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str
    channel_name: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Item:
    categories: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class RateEvent:
    user: str
    item: str
    rating: float


@dataclasses.dataclass
class TrainingData:
    users: Dict[str, None]
    items: Dict[str, Item]
    rate_events: List[RateEvent]

    def sanity_check(self) -> None:
        assert self.rate_events, (
            "rateEvents in PreparedData cannot be empty. Please check if "
            "DataSource generates TrainingData correctly.")
        assert self.users, "users in PreparedData cannot be empty."
        assert self.items, "items in PreparedData cannot be empty."


@dataclasses.dataclass(frozen=True)
class Query:
    user: str = ""
    num: int = 10
    categories: Tuple[str, ...] = ()
    white_list: Tuple[str, ...] = ()
    black_list: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    item_scores: Tuple[ItemScore, ...]


VIEW_WEIGHT = 1.0
BUY_WEIGHT = 4.0  # a buy is a stronger implicit signal than a view


class EventDataSource(PDataSource):
    """$set users/items + view/buy events (train-with-rate-event
    DataSource.scala)."""

    params_class = DataSourceParams

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        p: DataSourceParams = self.params
        users = {
            uid: None
            for uid in PEventStore.aggregate_properties(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="user")
        }
        items = {
            iid: Item(categories=tuple(pm.get_opt("categories", list) or ()))
            for iid, pm in PEventStore.aggregate_properties(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="item").items()
        }
        rates = [
            RateEvent(
                user=e.entity_id, item=e.target_entity_id,
                rating=BUY_WEIGHT if e.event == "buy" else VIEW_WEIGHT)
            for e in PEventStore.find(
                app_name=p.app_name, channel_name=p.channel_name,
                entity_type="user", event_names=["view", "buy"],
                target_entity_type="item")
        ]
        return TrainingData(users, items, rates)


@dataclasses.dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    """ALSAlgorithmParams (train-with-rate-event ALSAlgorithm.scala:30-38):
    app_name for the live event lookups, unseen_only + seen_events for
    the seen filter, plus the ALS hyper-parameters."""

    app_name: str
    unseen_only: bool = False
    seen_events: Tuple[str, ...] = ("buy", "view")
    similar_events: Tuple[str, ...] = ("view",)
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: Optional[int] = None


@dataclasses.dataclass
class ECommModel:
    rank: int
    user_features: np.ndarray         # [N, R]
    product_features: np.ndarray      # [M, R]
    user_map: StringIndexBiMap
    item_map: StringIndexBiMap
    items: Dict[int, Item]

    def sanity_check(self) -> None:
        assert np.isfinite(self.user_features).all()
        assert np.isfinite(self.product_features).all()


class ECommAlgorithm(P2LAlgorithm):
    params_class = ECommAlgorithmParams
    query_cls = Query

    def train(self, ctx: ComputeContext, pd: TrainingData) -> ECommModel:
        p: ECommAlgorithmParams = self.params
        user_map = BiMap.string_int(pd.users)
        item_map = BiMap.string_int(pd.items)
        counts: Dict[Tuple[int, int], float] = {}
        for r in pd.rate_events:
            u, i = user_map.get(r.user), item_map.get(r.item)
            if u is None or i is None:
                continue
            counts[(u, i)] = counts.get((u, i), 0.0) + r.rating
        if not counts:
            raise ValueError(
                "ratings cannot be empty. Please check if your events "
                "contain valid user and item ID.")
        keys = np.asarray(list(counts), dtype=np.int64)
        vals = np.asarray(list(counts.values()), dtype=np.float32)
        rows, cols = keys[:, 0], keys[:, 1]
        n_u, n_i = len(user_map), len(item_map)
        from predictionio_tpu_torch.workflow import runlog
        from predictionio_tpu_torch.workflow.checkpoint import (
            bimap_fingerprint_scope)

        # entity maps join the crash-safe checkpoint fingerprint
        # (no-op while checkpointing is off); the run-context scope
        # labels this training's run-history entries
        with bimap_fingerprint_scope(user_map, item_map), \
                runlog.run_context_scope(
                    template="ecommercerecommendation",
                    nUsers=n_u, nItems=n_i):
            X, Y = _train_als_auto(
                pad_ratings(rows, cols, vals, n_u, n_i),
                pad_ratings(cols, rows, vals, n_i, n_u),
                ALSParams(rank=p.rank, num_iterations=p.num_iterations,
                          lambda_=p.lambda_,
                          seed=0 if p.seed is None else p.seed),
                getattr(ctx, "device", None))
        items = {item_map[iid]: item for iid, item in pd.items.items()}
        return ECommModel(p.rank, X, Y, user_map, item_map, items)

    # -- live constraint reads (predict-time LEventStore) ------------------
    def _seen_items(self, query: Query) -> Set[str]:
        p: ECommAlgorithmParams = self.params
        if not p.unseen_only:
            return set()
        try:
            events = LEventStore.find_by_entity(
                app_name=p.app_name, entity_type="user",
                entity_id=query.user, event_names=list(p.seen_events),
                target_entity_type="item", timeout=10.0)
        except Exception as e:
            logger.error("Error when reading seen events: %s", e)
            return set()
        return {e.target_entity_id for e in events
                if e.target_entity_id is not None}

    def _unavailable_items(self) -> Set[str]:
        """Latest $set on constraint/unavailableItems
        (ALSAlgorithm predict, unavailableItems block)."""
        p: ECommAlgorithmParams = self.params
        try:
            events = list(LEventStore.find_by_entity(
                app_name=p.app_name, entity_type="constraint",
                entity_id="unavailableItems", event_names=["$set"],
                latest=True, limit=1, timeout=0.2))
        except Exception as e:
            logger.error("Error when reading unavailableItems: %s", e)
            return set()
        if not events:
            return set()
        return set(events[0].properties.get_opt("items", list) or ())

    def _item_weights(self, model: ECommModel) -> Optional[np.ndarray]:
        """weighted-items variant: latest $set on constraint/weightedItems
        carries ``weights: [{"items": [...], "weight": w}, ...]``; scores
        are multiplied by the item's group weight, default 1.0
        (weighted-items ALSAlgorithm.scala:217-242,277-278)."""
        p: ECommAlgorithmParams = self.params
        try:
            events = list(LEventStore.find_by_entity(
                app_name=p.app_name, entity_type="constraint",
                entity_id="weightedItems", event_names=["$set"],
                latest=True, limit=1, timeout=0.2))
        except Exception as e:
            logger.error("Error when reading set weightedItems event: %s", e)
            return None
        if not events:
            return None
        groups = events[0].properties.get_opt("weights", list) or ()
        if not groups:
            return None
        weights = np.ones(len(model.item_map), dtype=np.float64)
        for group in groups:
            # live client data: degrade gracefully on ANY malformed group
            # rather than taking down query serving
            try:
                w = float(group["weight"])
                for item in group["items"]:
                    ix = model.item_map.get(item)
                    if ix is not None:
                        weights[ix] = w
            except (TypeError, KeyError, ValueError):
                logger.error("Malformed weights group: %r", group)
        return weights

    def _recent_item_features(self, query: Query,
                              model: ECommModel) -> Optional[np.ndarray]:
        """Latest similar_events of the user -> their item factors
        (the recentFeatures fallback for users unseen at train time)."""
        p: ECommAlgorithmParams = self.params
        try:
            events = LEventStore.find_by_entity(
                app_name=p.app_name, entity_type="user",
                entity_id=query.user, event_names=list(p.similar_events),
                target_entity_type="item", latest=True, limit=10,
                timeout=10.0)
        except Exception as e:
            logger.error("Error when reading recent events: %s", e)
            return None
        idxs = [model.item_map[e.target_entity_id] for e in events
                if e.target_entity_id in model.item_map]
        if not idxs:
            return None
        return model.product_features[np.asarray(idxs, dtype=np.int64)]

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        black: Set[str] = set(query.black_list)
        black |= self._seen_items(query)
        black |= self._unavailable_items()

        uidx = model.user_map.get(query.user)
        if uidx is not None:
            scores = predict_scores_for_user(
                model.user_features[uidx], model.product_features)
        else:
            recent = self._recent_item_features(query, model)
            if recent is None:
                logger.info("No userFeature and no recent events for "
                            "user %s.", query.user)
                return PredictedResult(())
            scores = cosine_scores(recent, model.product_features)

        weights = self._item_weights(model)
        if weights is not None:
            scores = scores * weights  # adjustedScore (scala :277-278)

        mask = np.ones(len(scores), dtype=bool)
        if query.categories:
            cats = set(query.categories)
            for ix, item in model.items.items():
                if not cats.intersection(item.categories):
                    mask[ix] = False
        if query.white_list:
            white = {model.item_map[i] for i in query.white_list
                     if i in model.item_map}
            keep = np.zeros_like(mask)
            if white:
                keep[np.asarray(list(white), dtype=np.int64)] = True
            mask &= keep
        for i in black:
            ix = model.item_map.get(i)
            if ix is not None:
                mask[ix] = False

        scores = np.where(mask, scores, -np.inf)
        k = min(query.num, int(mask.sum()))
        if k <= 0:
            return PredictedResult(())
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        finite = np.isfinite(scores[top])
        top = top[finite]
        items = model.item_map.decode(top)
        return PredictedResult(tuple(
            ItemScore(item=str(i), score=float(scores[ix]))
            for i, ix in zip(items, top)))


def engine_factory() -> Engine:
    """ECommerceRecommendationEngine (train-with-rate-event Engine.scala)."""
    return Engine(
        EventDataSource,
        PIdentityPreparator,
        {"als": ECommAlgorithm, "": ECommAlgorithm},
        LFirstServing,
    )
