"""Two-stage template: ALS retrieval + seqrec re-rank in one engine. The
port's copy of ``predictionio_tpu/templates/twostage/engine.py``.

``EngineParams.algorithms = [("als", ...), ("seqrec", ...)]`` trains both
stages from one event stream, and
:class:`~predictionio_tpu_torch.controller.TwoStageServing` combines
them: through one :class:`~predictionio_tpu_torch.ops.twostage.
TwoStageTopK` store on live deployments (``workflow.create_server``
binds it), composed on the host in the evaluation pipeline.

Both stages MUST share one user map and one item map (stage 1's
candidate ids index stage 2's item table directly on the device), so
:class:`TwoStagePreparator` indexes the event stream once and lays it out
both ways: padded rating tables for the ALS half-steps and time-ordered
bucketed sequences for the transformer, in one :class:`TwoStagePrepared`
whose sides share one map object.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    Params,
    PPreparator,
    TwoStageServing,
)
from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.ops.als import pad_ratings
from predictionio_tpu_torch.ops.seqrec import bucket_sequences
from predictionio_tpu_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSModel,
    PreparedData,
)
from predictionio_tpu_torch.templates.sequentialrec.engine import (
    PreparedSequences,
    SeqRecAlgorithm,
    SeqRecModel,
    SequenceDataSource,
    SequenceTrainingData,
    index_sequences,
)


@dataclasses.dataclass(frozen=True)
class TwoStagePreparatorParams(Params):
    """``max_seq_len`` caps the re-ranker's sequence buckets;
    ``max_len`` (optional) caps the ALS rating-row padding."""

    max_seq_len: int = 32
    max_len: Optional[int] = None


@dataclasses.dataclass
class TwoStagePrepared:
    """Both stages' layouts over ONE shared (user, item) index space."""

    ratings: PreparedData
    sequences: PreparedSequences

    @property
    def user_map(self) -> StringIndexBiMap:
        return self.ratings.user_map

    @property
    def item_map(self) -> StringIndexBiMap:
        return self.ratings.item_map


class TwoStagePreparator(PPreparator):
    """Index the event stream ONCE, lay it out twice: each event is an
    implicit rating of 1.0 on the ALS side (repeats add weight through
    the normal equations' sums), and each user's run in time order,
    bucketed, on the sequence side. Both sides carry the SAME map
    objects; :func:`~predictionio_tpu_torch.ops.twostage.
    build_two_stage_store` checks the maps again at deploy."""

    params_class = TwoStagePreparatorParams

    def prepare(self, ctx: Any, td: SequenceTrainingData) -> TwoStagePrepared:
        p: TwoStagePreparatorParams = self.params
        user_map, item_map, rows, cols, seqs = index_sequences(td)
        n_u, n_i = len(user_map), len(item_map)
        vals = np.ones(len(rows), dtype=np.float32)
        user_side = pad_ratings(rows, cols, vals, n_u, n_i,
                                max_len=p.max_len)
        item_side = pad_ratings(cols, rows, vals, n_i, n_u,
                                max_len=p.max_len)
        seen = {u: np.unique(s) for u, s in enumerate(seqs) if len(s)}
        buckets = bucket_sequences(seqs, max_len=int(p.max_seq_len))
        ratings = PreparedData(user_map, item_map, user_side, item_side,
                               seen)
        sequences = PreparedSequences(user_map, item_map, buckets, seen,
                                      int(p.max_seq_len))
        return TwoStagePrepared(ratings, sequences)


class TwoStageALSAlgorithm(ALSAlgorithm):
    """Stage 1 (retrieval): the ALS algorithm on the shared preparation's
    rating side."""

    def train(self, ctx: Any, pd: TwoStagePrepared) -> ALSModel:
        return super().train(ctx, pd.ratings)


class TwoStageSeqRecAlgorithm(SeqRecAlgorithm):
    """Stage 2 (re-rank): the seqrec algorithm on the shared
    preparation's sequence side."""

    def train(self, ctx: Any, pd: TwoStagePrepared) -> SeqRecModel:
        return super().train(ctx, pd.sequences)


def engine_factory() -> Engine:
    return Engine(
        SequenceDataSource,
        TwoStagePreparator,
        {"als": TwoStageALSAlgorithm,
         "seqrec": TwoStageSeqRecAlgorithm,
         "": TwoStageALSAlgorithm},
        {"": TwoStageServing},
    )
