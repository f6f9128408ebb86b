"""Sequential-recommendation engine: per-user event sequences ->
SASRec-style next-item prediction. The port's copy of
``predictionio_tpu/templates/sequentialrec/engine.py``.

The DASE shape is the recommendation template's, so the serving plane
is inherited:

- ``SequenceDataSource`` reads time-stamped interaction events (``view``
  by default) in one columnar scan, or streamed in blocks
  (``streaming_block_size``, ``decode_prefetch``), and evaluates by
  leave-last-out in time order or by sliding windows
  (``data/sliding.py``).
- ``SequencePreparator`` indexes users and items, orders each user's
  items by event time and groups them into power-of-two length buckets
  (``ops/seqrec.bucket_sequences``).
- ``SeqRecAlgorithm`` trains the causal transformer encoder
  (``ops/seqrec.train_seqrec``) on the device the context names and
  encodes every user's sequence into a vector. The model serves like an
  ALS model: user vectors × the tied item table through
  ``choose_server`` → ``DeviceTopK``, so the serving kernel (B1) ranks
  it, with the positive-score filter off (the encoder's logits are only
  relatively calibrated).
- Online fold-in: ``SeqRecModel.fold_in_rows`` re-encodes the touched
  users' full time-ordered sequences on the device, so ``pio deploy
  --foldin on`` patches fresh user vectors into the live store.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    LFirstServing,
    P2LAlgorithm,
    Params,
    PDataSource,
    PPreparator,
)
from predictionio_tpu_torch.data.bimap import StringIndexBiMap
from predictionio_tpu_torch.data.sliding import (
    group_by_entity,
    leave_last_out,
    sliding_window_masks,
)
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.seqrec import (
    SeqRecParams,
    SequenceBucket,
    bucket_sequences,
    encode_bucket,
    encode_users,
    length_bucket,
    theta_to_device,
    train_seqrec,
)
# the query / result surface and the device-serving glue are the
# recommendation template's: one definition
from predictionio_tpu_torch.templates.recommendation.engine import (
    ActualResult,
    EmptyEvalInfo,
    ItemScore,
    PredictedResult,
    PrecisionAtK,
    Query,
    _DeviceServedModel,
    _DeviceServingAlgo,
)


@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    """``streaming_block_size`` streams the read in bounded columnar
    blocks in storage order (``decode_prefetch`` partitions decoded
    ahead); the sliding-window evaluation knobs are the recommendation
    template's (``eval_count = 0`` keeps leave-last-out)."""

    app_name: str
    event_names: Tuple[str, ...] = ("view",)
    channel_name: Optional[str] = None
    streaming_block_size: Optional[int] = None
    decode_prefetch: int = 0
    eval_first_until: Optional[str] = None   # ISO-8601
    eval_duration_days: float = 7.0
    eval_count: int = 0


class SequenceTrainingData:
    """Columnar (user, item, time) interaction triples in storage order;
    the preparator sorts by time once. A streamed read carries its
    ``index`` instead of the label columns: ``(user labels, rows, item
    labels, cols)``, the labels sorted as ``np.unique`` of the columns as
    strings gives them, and :meth:`columns` builds labels from it only
    for the rows asked for."""

    def __init__(self, users: Optional[np.ndarray] = None,
                 items: Optional[np.ndarray] = None,
                 times: Optional[np.ndarray] = None,
                 index: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]] = None):
        self._users, self._items = users, items
        self.times = times
        self.index = index
        n_u, n_i = ((len(users), len(items)) if index is None
                    else (len(index[1]), len(index[3])))
        if not (n_u == n_i == len(times)):
            raise ValueError(
                f"misaligned sequence columns: {n_u} users, "
                f"{n_i} items, {len(times)} times")

    def columns(self, idx: Any = slice(None)
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The (user, item) labels of the rows ``idx``."""
        if self.index is None:
            return self._users[idx], self._items[idx]
        u_labels, rows, i_labels, cols = self.index
        return u_labels[rows[idx]], i_labels[cols[idx]]

    @property
    def users(self) -> np.ndarray:
        return self.columns()[0]

    @property
    def items(self) -> np.ndarray:
        return self.columns()[1]

    def take(self, idx: Any) -> "SequenceTrainingData":
        """The rows ``idx`` (indices or a mask); an index is compacted to
        the labels those rows use."""
        if self.index is None:
            return SequenceTrainingData(self._users[idx], self._items[idx],
                                        self.times[idx])
        u_labels, rows, i_labels, cols = self.index
        u_used, rows = np.unique(rows[idx], return_inverse=True)
        i_used, cols = np.unique(cols[idx], return_inverse=True)
        return SequenceTrainingData(
            times=self.times[idx],
            index=(u_labels[u_used], rows.astype(np.int64),
                   i_labels[i_used], cols.astype(np.int64)))

    def __len__(self) -> int:
        return int(self.times.shape[0])

    def sanity_check(self) -> None:
        assert len(self), (
            "events in SequenceTrainingData cannot be empty. Please "
            "check if DataSource generates TrainingData correctly.")


class _BlockIndexer:
    """Indexes a streamed read block by block: each block's distinct ids
    (a dictionary-encoded block's label tables, else its rows) get codes
    in order of appearance, and ``finalize`` renumbers them in sorted
    label order, which gives the codes ``np.unique`` of the whole columns
    as strings would, without a string sort of every row. Events without
    a target are dropped."""

    def __init__(self):
        self.users: Dict[str, int] = {}
        self.items: Dict[str, int] = {}
        self.rows: List[np.ndarray] = []
        self.cols: List[np.ndarray] = []
        self.times: List[np.ndarray] = []

    @staticmethod
    def _codes(table: Dict[str, int], labels: np.ndarray,
               codes: np.ndarray) -> np.ndarray:
        used = np.flatnonzero(np.bincount(codes, minlength=len(labels)))
        lut = np.full(len(labels), -1, dtype=np.int64)
        lut[used] = np.fromiter(
            (table.setdefault(x if type(x) is str else str(x), len(table))
             for x in labels[used]), dtype=np.int64, count=len(used))
        return lut[codes]

    def add(self, block) -> None:
        if block.is_encoded and block.target_codes is not None:
            keep = block.target_codes >= 0
            self.rows.append(self._codes(self.users, block.entity_labels,
                                         block.entity_codes[keep]))
            self.cols.append(self._codes(self.items, block.target_labels,
                                         block.target_codes[keep]))
        else:
            block = block.materialize()
            keep = np.fromiter((x is not None for x in block.target_ids),
                               dtype=bool, count=len(block))
            n = int(keep.sum())
            self.rows.append(self._codes(self.users, block.entity_ids[keep],
                                         np.arange(n)))
            self.cols.append(self._codes(self.items, block.target_ids[keep],
                                         np.arange(n)))
        self.times.append(block.event_times[keep])

    @staticmethod
    def _sorted(table: Dict[str, int], codes: List[np.ndarray]):
        distinct = np.asarray(list(table), dtype=str)
        order = np.argsort(distinct)
        rank = np.empty(len(order), dtype=np.int64)
        rank[order] = np.arange(len(order))
        cat = np.concatenate(codes) if codes else np.empty(0, np.int64)
        return distinct[order], rank[cat]

    def finalize(self) -> SequenceTrainingData:
        u_labels, rows = self._sorted(self.users, self.rows)
        i_labels, cols = self._sorted(self.items, self.cols)
        times = np.concatenate(self.times) if self.times \
            else np.empty(0, dtype=np.float64)
        return SequenceTrainingData(
            times=times, index=(u_labels, rows, i_labels, cols))


class SequenceDataSource(PDataSource):
    """Time-stamped interaction events -> columnar sequence triples."""

    params_class = DataSourceParams

    def _read_columns(self, until_time=None) -> SequenceTrainingData:
        p: DataSourceParams = self.params
        kwargs = dict(
            app_name=p.app_name, channel_name=p.channel_name,
            entity_type="user", event_names=list(p.event_names),
            target_entity_type="item", value_property=None,
            default_value=1.0, until_time=until_time)
        if p.streaming_block_size:
            from predictionio_tpu_torch.data.columnar import (
                iter_blocks_threaded,
            )

            indexer = _BlockIndexer()
            # the store's read and decode overlap the indexing
            for block in iter_blocks_threaded(
                    PEventStore.find_columnar_blocks(
                        block_size=int(p.streaming_block_size),
                        prefetch=int(p.decode_prefetch), **kwargs)):
                indexer.add(block)
            return indexer.finalize()
        batch = PEventStore.find_columnar(**kwargs)
        users, items, times = (batch.entity_ids, batch.target_ids,
                               batch.event_times)
        # events without a target id cannot join a sequence
        keep = np.fromiter((x is not None for x in items), dtype=bool,
                           count=len(items))
        if not keep.all():
            users, items, times = users[keep], items[keep], times[keep]
        return SequenceTrainingData(users, items, times)

    def read_training(self, ctx: Any) -> SequenceTrainingData:
        return self._read_columns()

    def read_eval(self, ctx: Any):
        p: DataSourceParams = self.params
        if p.eval_count > 0:
            return self._sliding_eval(p)
        td = self._read_columns()
        # leave-last-out in TIME order per user: the held-out event is
        # each user's most recent item
        n = len(td)
        users, items = td.columns()
        users_str = users.astype(str)
        order = np.lexsort((np.arange(n), td.times, users_str))
        groups = group_by_entity(users_str[order], list(order))
        train_idx, held = leave_last_out(groups)
        train = td.take(np.asarray(sorted(train_idx), dtype=np.int64))
        qa = [(Query(user=u, num=10),
               ActualResult([str(items[i])])) for u, i in held]
        return [(train, EmptyEvalInfo(), qa)]

    def _sliding_eval(self, p: DataSourceParams):
        """Sliding time windows, the recommendation template's protocol
        (split math in ``data/sliding.py``)."""
        import datetime as _dt

        from predictionio_tpu_torch.data.event import _parse_time

        if not p.eval_first_until:
            raise ValueError(
                "eval_count > 0 requires eval_first_until (ISO-8601)")
        first_until = _parse_time(p.eval_first_until)
        t0 = first_until.timestamp()
        dur = float(p.eval_duration_days) * 86400.0
        horizon = first_until + _dt.timedelta(
            seconds=dur * int(p.eval_count))
        td = self._read_columns(until_time=horizon)
        sets = []
        for _k, train_mask, test_mask in sliding_window_masks(
                td.times, t0, dur, int(p.eval_count),
                hint="move eval_first_until later or reduce eval_count"):
            train = td.take(train_mask)
            held: Dict[str, List[str]] = {}
            for u, i in zip(*td.columns(test_mask)):
                held.setdefault(str(u), []).append(str(i))
            qa = [(Query(user=u, num=10), ActualResult(items))
                  for u, items in held.items()]
            sets.append((train, EmptyEvalInfo(), qa))
        return sets


@dataclasses.dataclass(frozen=True)
class SeqPreparatorParams(Params):
    """``max_seq_len`` keeps each user's LAST that-many items; the padded
    length classes round it up the power-of-two ladder."""

    max_seq_len: int = 32


@dataclasses.dataclass
class PreparedSequences:
    """BiMap-indexed, length-bucketed per-user sequences."""

    user_map: StringIndexBiMap
    item_map: StringIndexBiMap
    buckets: List[SequenceBucket]
    seen: Dict[int, np.ndarray]   # user idx -> unique item idx array
    max_seq_len: int

    def sanity_check(self) -> None:
        assert len(self.user_map) > 0, "no users after indexing"
        assert len(self.item_map) > 0, "no items after indexing"
        assert self.buckets, "no non-empty sequences after bucketing"


def index_sequences(td: SequenceTrainingData
                    ) -> Tuple[StringIndexBiMap, StringIndexBiMap,
                               np.ndarray, np.ndarray, List[np.ndarray]]:
    """Entity ids to indices (sorted distinct labels) and each user's
    items in (event time, arrival) order, through one stable sort:
    ``(user_map, item_map, rows, cols, seqs)``."""
    if td.index is not None:
        u_labels, rows, i_labels, cols = td.index
    else:
        u_labels, rows = np.unique(td.users.astype(str), return_inverse=True)
        i_labels, cols = np.unique(td.items.astype(str), return_inverse=True)
        rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    user_map = StringIndexBiMap.from_distinct(u_labels)
    item_map = StringIndexBiMap.from_distinct(i_labels)
    n = len(td)
    order = np.lexsort((np.arange(n), td.times, rows))
    s_rows, s_cols = rows[order], cols[order]
    n_u = len(user_map)
    starts = np.searchsorted(s_rows, np.arange(n_u))
    ends = np.searchsorted(s_rows, np.arange(n_u), side="right")
    seqs = [s_cols[starts[u]:ends[u]] for u in range(n_u)]
    return user_map, item_map, rows, cols, seqs


class SequencePreparator(PPreparator):
    """Index -> time-order -> bucket."""

    params_class = SeqPreparatorParams

    def prepare(self, ctx: Any,
                td: SequenceTrainingData) -> PreparedSequences:
        p: SeqPreparatorParams = self.params
        user_map, item_map, _, _, seqs = index_sequences(td)
        seen = {u: np.unique(s) for u, s in enumerate(seqs) if len(s)}
        buckets = bucket_sequences(seqs, max_len=int(p.max_seq_len))
        return PreparedSequences(user_map, item_map, buckets, seen,
                                 int(p.max_seq_len))


@dataclasses.dataclass
class SeqRecModel(_DeviceServedModel):
    """User vectors and the tied item table, served through the factor
    store top-k path exactly like an ALS model, plus the encoder's θ, so
    fold-in RE-ENCODES a user's sequence instead of solving for a row.
    The host fields are numpy only."""

    user_vectors: np.ndarray      # [N, R]
    item_vectors: np.ndarray      # [M, R] == theta["item_emb"]
    user_map: StringIndexBiMap
    item_map: StringIndexBiMap
    seen: Dict[int, np.ndarray]
    theta: Dict[str, np.ndarray]
    enc_params: SeqRecParams
    max_seq_len: int
    device: Optional[str] = None
    _server: Any = dataclasses.field(default=None, repr=False, compare=False)
    _server_lock: Any = dataclasses.field(default_factory=threading.Lock,
                                          repr=False, compare=False)

    # online fold-in: the gather hands this model's touched users'
    # histories in EVENT-TIME order (re-encoding is order-sensitive)
    foldin_time_ordered = True
    # the encoder's logits are only relatively calibrated: a user whose
    # unseen items all score below zero still has a ranking
    serve_positive_scores_only = False

    def _make_server(self):
        from predictionio_tpu_torch.ops.serving import choose_server

        return choose_server(self.user_vectors, self.item_vectors,
                             self.seen, device=self._serve_device())

    def _device_theta(self):
        """θ as device tensors, cached (a fold would otherwise copy the
        whole model, item table included, to the card each time);
        dropped at pickle like the serving handles."""
        th = getattr(self, "_theta_device", None)
        if th is None:
            th = theta_to_device(self.theta, resolve_device(self.device))
            self._theta_device = th
        return th

    def fold_in_rows(self, cols_list, vals_list) -> np.ndarray:
        """Re-encode ``k`` users' full time-ordered item sequences into
        fresh ``[k, R]`` user vectors: the fold-in consumer's solve hook.
        The batch pads to ``bucket_size(k, 8)`` rows and the sequences'
        length class, so a long-lived server's folds reuse a few
        shapes."""
        from predictionio_tpu_torch.ops.serving import bucket_size

        k = len(cols_list)
        if k == 0:
            return np.zeros((0, self.item_vectors.shape[1]),
                            dtype=np.float32)
        seqs = []
        for c in cols_list:
            c = np.asarray(c, dtype=np.int32)
            if len(c) > self.max_seq_len:
                c = c[-self.max_seq_len:]
            seqs.append(c)
        longest = max((len(s) for s in seqs), default=1)
        L = length_bucket(max(longest, 1))
        B = bucket_size(k, 8)
        ids = np.zeros((B, L), dtype=np.int32)
        mask = np.zeros((B, L), dtype=np.float32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1.0
        bucket = SequenceBucket(np.arange(B, dtype=np.int64), ids, mask)
        return encode_bucket(self._device_theta(), bucket, self.enc_params,
                             device=self.device)[:k]

    def sanity_check(self) -> None:
        assert np.isfinite(self.user_vectors).all(), \
            "non-finite user vectors"
        assert np.isfinite(self.item_vectors).all(), \
            "non-finite item vectors"


class SeqRecAlgorithm(_DeviceServingAlgo, P2LAlgorithm):
    """SASRec-style next-item transformer: trains and encodes on the
    device the context names (None = cuda) and serves from there."""

    params_class = SeqRecParams
    query_cls = Query

    def train(self, ctx: Any, pd: PreparedSequences) -> SeqRecModel:
        from predictionio_tpu_torch.workflow import runlog

        p = dataclasses.replace(self.params, max_seq_len=pd.max_seq_len) \
            if self.params.max_seq_len != pd.max_seq_len else self.params
        # a context of several devices trains on its first and encodes
        # with the sequence-parallel attention over its mesh (the JAX
        # package's test: more than one visible device and sp_mode on)
        mesh = None
        if ctx is not None and getattr(ctx, "device_count", 1) > 1:
            dev = ctx.devices[0]
            if p.sp_mode != "off":
                mesh = ctx.mesh
        else:
            dev = resolve_device(getattr(ctx, "device", None))
        with runlog.run_context_scope(template="sequentialrec",
                                      nUsers=len(pd.user_map),
                                      nItems=len(pd.item_map)):
            theta, _ = train_seqrec(pd.buckets, len(pd.item_map), p,
                                    device=dev)
            U = encode_users(theta, pd.buckets, len(pd.user_map), p,
                             device=dev, mesh=mesh)
        return SeqRecModel(U, theta["item_emb"], pd.user_map, pd.item_map,
                           pd.seen, theta, p, pd.max_seq_len,
                           device=str(dev))

    def batch_predict(self, ctx: Any, model: SeqRecModel,
                      indexed_queries) -> List[Tuple[int, Any]]:
        return self._batched_predict(model, indexed_queries)


class SeqRecServing(LFirstServing):
    """First-serving, like the recommendation template."""


class SeqRecParamsList(EngineParamsGenerator):
    """A small tuning grid over width and depth."""

    def __init__(self, app_name: str = "seqrec-app"):
        super().__init__()
        self.engine_params_list = [
            EngineParams(
                data_source_params=("", DataSourceParams(
                    app_name=app_name)),
                preparator_params=("", SeqPreparatorParams()),
                algorithm_params_list=[
                    ("seqrec", SeqRecParams(rank=rank, n_layers=layers,
                                            seed=7))],
            )
            for rank in (16, 32)
            for layers in (1, 2)
        ]


class SeqRecEvaluation(Evaluation, SeqRecParamsList):
    """The ``pio eval`` entry: the width / depth grid scored by
    Precision@10 over the leave-last-out (or sliding-window) split."""

    def __init__(self, app_name: str = "seqrec-app", k: int = 10):
        Evaluation.__init__(self)
        SeqRecParamsList.__init__(self, app_name=app_name)
        self.engine_metric = (engine_factory(), PrecisionAtK(k))


def engine_factory() -> Engine:
    return Engine(
        SequenceDataSource,
        SequencePreparator,
        {"seqrec": SeqRecAlgorithm, "": SeqRecAlgorithm},
        SeqRecServing,
    )
