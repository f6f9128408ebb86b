"""Friend-recommendation engine — keyword-similarity acceptance on the
KDD Cup 2012 track-1 data shape.

The port's copy of
``predictionio_tpu/templates/friendrecommendation/engine.py``.

Capability parity with the reference's
``examples/experimental/scala-local-friend-recommendation``:

- ``FriendRecommendationDataSource`` (LDataSource) reads the KDD file
  formats: ``item.txt`` (``id category kw;kw;...``),
  ``user_key_word.txt`` (``id kw:weight;kw:weight;...``), and the
  social-action file (``src dst a b c`` edges summed into weights) —
  ``FriendRecommendationDataSource.scala:13-98``
- ``KeywordSimilarityAlgorithm`` (LAlgorithm): confidence = sparse dot
  product of the user's and item's keyword weight maps; acceptance =
  ``confidence * weight >= threshold`` with the reference's fixed
  weight/threshold of 1.0 (``KeywordSimilarityAlgorithm.scala:14-67``;
  its perceptron-style threshold training is commented out there and
  equally omitted here)
- ``RandomAlgorithm``: the baseline coin flip against a 0.5 threshold
  (``RandomAlgorithm.scala:13-24``) — seedable here so tests and evals
  are reproducible
- queries are ``{"user": <ext id>, "item": <ext id>}`` and predictions
  carry (confidence, acceptance) — ``FriendRecommendationQuery.scala``/
  ``FriendRecommendationPrediction.scala``
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    LAlgorithm,
    LDataSource,
    LFirstServing,
    LIdentityPreparator,
    Params,
)


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    item_file_path: str
    user_keyword_file_path: str
    user_action_file_path: str


@dataclasses.dataclass
class TrainingData:
    """External->internal id maps, per-entity sparse keyword maps, and
    the summed social-action adjacency
    (FriendRecommendationTrainingData.scala)."""

    user_id_map: Dict[int, int]
    item_id_map: Dict[int, int]
    user_keyword: List[Dict[int, float]]   # internal user idx -> kw->w
    item_keyword: List[Dict[int, float]]   # internal item idx -> kw->w
    social_action: List[List[Tuple[int, int]]]  # src idx -> [(dst, w)]

    def sanity_check(self) -> None:
        assert self.user_id_map and self.item_id_map, \
            "friend-recommendation training data cannot be empty"


@dataclasses.dataclass(frozen=True)
class Query:
    """Given a user and an item (a followable entity), predict
    acceptance (FriendRecommendationQuery.scala)."""

    user: int = 0
    item: int = 0


@dataclasses.dataclass(frozen=True)
class Prediction:
    confidence: float
    acceptance: bool


class FriendRecommendationDataSource(LDataSource):
    """KDD-format file reader (FriendRecommendationDataSource.scala)."""

    params_class = DataSourceParams

    def read_training(self) -> TrainingData:
        p: DataSourceParams = self.params
        item_id_map, item_keyword = self._read_item(p.item_file_path)
        user_id_map, user_keyword = self._read_user(
            p.user_keyword_file_path)
        social = self._read_relationship(p.user_action_file_path,
                                         len(user_keyword), user_id_map)
        return TrainingData(user_id_map, item_id_map, user_keyword,
                            item_keyword, social)

    @staticmethod
    def _read_item(path: str):
        """``id category kw;kw;...`` -> ids + unit-weight keyword maps
        (readItem, :27-49)."""
        id_map: Dict[int, int] = {}
        keywords: List[Dict[int, float]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                data = line.split()
                if not data:
                    continue
                id_map[int(data[0])] = len(keywords)
                # tolerate keyword-less/short lines: empty keyword map
                keywords.append({int(kw): 1.0
                                 for kw in data[2].split(";") if kw}
                                if len(data) > 2 else {})
        return id_map, keywords

    @staticmethod
    def _read_user(path: str):
        """``id kw:weight;kw:weight;...`` (readUser, :51-74)."""
        id_map: Dict[int, int] = {}
        keywords: List[Dict[int, float]] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                data = line.split()
                if not data:
                    continue
                id_map[int(data[0])] = len(keywords)
                kw_map: Dict[int, float] = {}
                if len(data) > 1:
                    for term_weight in data[1].split(";"):
                        if term_weight:
                            term, weight = term_weight.split(":")
                            kw_map[int(term)] = float(weight)
                keywords.append(kw_map)
        return id_map, keywords

    @staticmethod
    def _read_relationship(path: str, n_users: int,
                           user_id_map: Dict[int, int]):
        """``src dst a b c`` -> adjacency with a+b+c edge weights, edges
        between unknown users dropped (readRelationship, :76-98)."""
        adj: List[List[Tuple[int, int]]] = [[] for _ in range(n_users)]
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                data = [int(v) for v in line.split()]
                if len(data) < 2:
                    continue
                if data[0] in user_id_map and data[1] in user_id_map:
                    adj[user_id_map[data[0]]].append(
                        (user_id_map[data[1]], sum(data[2:5])))
        return adj


def keyword_similarity(a: Dict[int, float], b: Dict[int, float]) -> float:
    """Sparse dot product (findKeywordSimilarity, :38-44)."""
    if len(b) < len(a):
        a, b = b, a
    return sum(w * b.get(kw, 0.0) for kw, w in a.items())


@dataclasses.dataclass
class KeywordSimilarityModel:
    """Id maps + keyword maps + the (fixed) weight/threshold pair
    (KeywordSimilarityModel.scala)."""

    user_id_map: Dict[int, int]
    item_id_map: Dict[int, int]
    user_keyword: List[Dict[int, float]]
    item_keyword: List[Dict[int, float]]
    keyword_sim_weight: float = 1.0
    keyword_sim_threshold: float = 1.0


class KeywordSimilarityAlgorithm(LAlgorithm):
    """Keyword-overlap acceptance (KeywordSimilarityAlgorithm.scala)."""

    query_cls = Query

    def train(self, td: TrainingData) -> KeywordSimilarityModel:
        return KeywordSimilarityModel(
            td.user_id_map, td.item_id_map,
            td.user_keyword, td.item_keyword)

    def predict(self, model: KeywordSimilarityModel,
                query: Query) -> Prediction:
        # unseen users/items score 0 (scala :50-64)
        confidence = 0.0
        if query.user in model.user_id_map \
                and query.item in model.item_id_map:
            confidence = keyword_similarity(
                model.user_keyword[model.user_id_map[query.user]],
                model.item_keyword[model.item_id_map[query.item]])
        acceptance = (confidence * model.keyword_sim_weight
                      >= model.keyword_sim_threshold)
        return Prediction(confidence=float(confidence),
                          acceptance=bool(acceptance))


@dataclasses.dataclass(frozen=True)
class RandomAlgoParams(Params):
    seed: Optional[int] = None


@dataclasses.dataclass
class RandomModel:
    random_threshold: float = 0.5
    seed: Optional[int] = None


class RandomAlgorithm(LAlgorithm):
    """Coin-flip baseline (RandomAlgorithm.scala:13-24), seedable."""

    params_class = RandomAlgoParams
    query_cls = Query

    def train(self, td: TrainingData) -> RandomModel:
        return RandomModel(0.5, seed=self.params.seed
                           if hasattr(self.params, "seed") else None)

    def predict(self, model: RandomModel, query: Query) -> Prediction:
        if model.seed is not None:
            # reproducible per (user, item) — tests and evals rerun stably
            rng = np.random.default_rng(
                (model.seed, query.user, query.item))
            confidence = float(rng.random())
        else:
            confidence = float(np.random.random())
        return Prediction(
            confidence=confidence,
            acceptance=confidence >= model.random_threshold)


def engine_factory() -> Engine:
    """KeywordSimilarityEngineFactory.scala analog."""
    return Engine(
        FriendRecommendationDataSource,
        LIdentityPreparator,
        {"keywordsimilarity": KeywordSimilarityAlgorithm,
         "": KeywordSimilarityAlgorithm},
        LFirstServing,
    )


def engine_factory_random() -> Engine:
    """RandomEngineFactory.scala analog."""
    return Engine(
        FriendRecommendationDataSource,
        LIdentityPreparator,
        {"random": RandomAlgorithm, "": RandomAlgorithm},
        LFirstServing,
    )
