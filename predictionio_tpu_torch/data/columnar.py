"""Columnar event batches — the ingest format.

The reference's training reads return ``RDD[Event]`` (``PEvents.scala:77-86``)
and every template immediately re-shapes them into numeric triples for MLlib
(``examples/scala-parallel-recommendation/custom-query/src/main/scala/
DataSource.scala:31-65``). On the training host that per-row object path is the
ingest bottleneck (SURVEY hard part #2), so the data plane's canonical bulk
read is a struct-of-arrays batch instead: entity/target IDs as numpy object
arrays, one extracted numeric property column, and event times — everything
downstream (BiMap indexing, padding, the copy to the device) is vectorized.

Backends may build these straight from their native scan (see
``SqlitePEvents.find_columnar`` which extracts the value column inside SQL);
``events_to_columnar`` is the generic fallback and also the conformance
oracle the backend fast paths are tested against.

The port's copy of ``predictionio_tpu/data/columnar.py``: the columnar
batch, the streaming builder (which also reports where each block's
triples begin, so the preparator's dedup sort can merge sorted runs
natively), the pipelined builder and ``ingest_ratings_pipelined`` (each
block sorted as it arrives, the runs merged natively, both solve sides
bucketed and staged to the card while the host works on), and the
threaded block reader.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np

from predictionio_tpu_torch.data.event import Event


@dataclasses.dataclass
class ColumnarEvents:
    """Struct-of-arrays view of an event scan, aligned by row.

    ``entity_ids``/``target_ids`` are object arrays (``target_ids`` entries
    may be None for events without a target); ``values`` is the extracted
    numeric property (``default_value`` where absent or non-numeric);
    ``event_times`` is float64 epoch seconds (UTC).

    DICTIONARY-ENCODED blocks (the 10M+-event ingest fast lane from the
    native codec): the ``*_codes``/``*_labels`` fields carry int32 codes
    into small distinct-label tables and the object columns are None —
    only distinct values ever become Python strings. Call
    :meth:`materialize` for the object-array form;
    :class:`StreamingRatingsBuilder` consumes the codes directly. A code
    of -1 means absent (None target).
    """

    entity_ids: Optional[np.ndarray]   # object [n] (None when encoded)
    target_ids: Optional[np.ndarray]   # object [n] (None when encoded)
    values: np.ndarray       # float32 [n]
    event_times: np.ndarray  # float64 [n] epoch seconds
    events: Optional[np.ndarray] = None  # object [n] event names (optional)
    entity_codes: Optional[np.ndarray] = None   # int32 [n]
    entity_labels: Optional[np.ndarray] = None  # object [k] distinct
    target_codes: Optional[np.ndarray] = None
    target_labels: Optional[np.ndarray] = None
    event_codes: Optional[np.ndarray] = None
    event_labels: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def is_encoded(self) -> bool:
        return self.entity_codes is not None

    def materialize(self) -> "ColumnarEvents":
        """Encoded block -> object-array block (labels gathered by code;
        -1 target codes become None)."""
        if not self.is_encoded:
            return self

        def decode(codes, labels, none_for_missing):
            out = np.empty(len(codes), dtype=object)
            present = codes >= 0
            out[present] = labels[codes[present]]
            if none_for_missing:
                out[~present] = None
            return out

        return ColumnarEvents(
            entity_ids=decode(self.entity_codes, self.entity_labels,
                              False),
            target_ids=decode(self.target_codes, self.target_labels,
                              True)
            if self.target_codes is not None else self.target_ids,
            values=self.values,
            event_times=self.event_times,
            events=decode(self.event_codes, self.event_labels, False)
            if self.event_codes is not None else self.events,
        )

    def encode_entities(self):
        """Vectorized dense indexing of both ID columns.

        Returns ``(user_map, item_map, rows, cols)`` where the maps are
        :class:`~predictionio_tpu_torch.data.bimap.StringIndexBiMap` over the
        distinct IDs (sorted) and ``rows``/``cols`` are int64 dense codes —
        the BiMap.stringInt step of every template, done with two
        ``np.unique`` calls instead of per-row dict lookups.

        Raises ``ValueError`` if any row has no target entity (a phantom
        "None" item must never get a matrix column); filter the scan by
        ``target_entity_type`` or call :meth:`drop_missing_targets` first.
        """
        from predictionio_tpu_torch.data.bimap import StringIndexBiMap

        if self.is_encoded:
            return self.materialize().encode_entities()
        missing = np.fromiter((x is None for x in self.target_ids),
                              dtype=bool, count=len(self.target_ids))
        if missing.any():
            raise ValueError(
                f"{int(missing.sum())} events have no target entity; filter "
                "by target_entity_type or use drop_missing_targets() before "
                "encode_entities()")
        ent = self.entity_ids.astype(str)
        tgt = self.target_ids.astype(str)
        e_labels, rows = np.unique(ent, return_inverse=True)
        t_labels, cols = np.unique(tgt, return_inverse=True)
        return (StringIndexBiMap.from_distinct(e_labels),
                StringIndexBiMap.from_distinct(t_labels),
                rows.astype(np.int64), cols.astype(np.int64))

    def drop_missing_targets(self) -> "ColumnarEvents":
        """Rows with a target entity only (aligned across all columns)."""
        if self.is_encoded and self.target_codes is not None:
            return self.take(self.target_codes >= 0)
        keep = np.fromiter((x is not None for x in self.target_ids),
                           dtype=bool, count=len(self.target_ids))
        return self.take(keep)

    def take(self, index) -> "ColumnarEvents":
        """Aligned row selection (boolean mask, index array, or slice)."""
        def sl(a):
            return None if a is None else a[index]

        return ColumnarEvents(
            entity_ids=sl(self.entity_ids),
            target_ids=sl(self.target_ids),
            values=self.values[index],
            event_times=self.event_times[index],
            events=sl(self.events),
            entity_codes=sl(self.entity_codes),
            entity_labels=self.entity_labels,
            target_codes=sl(self.target_codes),
            target_labels=self.target_labels,
            event_codes=sl(self.event_codes),
            event_labels=self.event_labels,
        )

    @staticmethod
    def concat(batches: "list[ColumnarEvents]") -> "ColumnarEvents":
        """Row-wise concatenation in object-array form (encoded inputs
        are materialized first — label tables differ across blocks);
        events column kept only if every batch has one."""
        batches = [b.materialize() for b in batches]
        if not batches:
            return ColumnarEvents(
                entity_ids=np.empty(0, dtype=object),
                target_ids=np.empty(0, dtype=object),
                values=np.empty(0, dtype=np.float32),
                event_times=np.empty(0, dtype=np.float64),
                events=np.empty(0, dtype=object))
        has_events = all(b.events is not None for b in batches)
        return ColumnarEvents(
            entity_ids=np.concatenate([b.entity_ids for b in batches]),
            target_ids=np.concatenate([b.target_ids for b in batches]),
            values=np.concatenate([b.values for b in batches]),
            event_times=np.concatenate([b.event_times for b in batches]),
            events=np.concatenate([b.events for b in batches])
            if has_events else None,
        )


def _unique_codes(codes: np.ndarray, n_labels: int):
    """``np.unique(codes, return_inverse=True)`` for NON-NEGATIVE codes
    bounded by a (small) label-table size: O(n + k) presence scan +
    table lookup instead of an O(n log n) sort — the ingest consumer's
    hottest per-block step. Same contract: sorted distinct codes, and
    the inverse mapping into them."""
    present = np.zeros(n_labels, dtype=bool)
    present[codes] = True
    uniq = np.flatnonzero(present)
    remap = np.empty(n_labels, dtype=np.int64)
    remap[uniq] = np.arange(len(uniq))
    return uniq, remap[codes]


class StreamingRatingsBuilder:
    """Incremental (user, item, value) triple builder over columnar
    blocks — the ≥10M-rating ingest core (SURVEY hard part #2).

    Feeding blocks from ``find_columnar_blocks`` keeps peak memory at
    one block of object-dtype IDs plus the accumulated INTEGER triples
    (16 bytes/rating) — per-event Python objects and whole-store string
    columns never exist. ID indexing is the BiMap.stringInt step done
    incrementally: one ``np.unique`` per block plus dictionary inserts
    per NEW distinct entity (distinct users/items are orders of
    magnitude fewer than events at MovieLens-20M scale).
    """

    def __init__(self):
        self._users: dict = {}
        self._items: dict = {}
        self._rows: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []
        self.n_events = 0

    @property
    def run_offsets(self) -> np.ndarray:
        """Where each added block's triples begin in the finalized
        columns, and their end: ``[0, n_0, n_0 + n_1, ..., n]``. The
        preparator sorts each run on its own and merges them natively
        (:func:`~predictionio_tpu_torch.ops.als.stable_key_order`)."""
        offsets = np.zeros(len(self._rows) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in self._rows], out=offsets[1:])
        return offsets

    def _encode(self, ids: np.ndarray, table: dict) -> np.ndarray:
        labels, inv = np.unique(ids.astype(str), return_inverse=True)
        return self._merge_labels(labels, table)[inv]

    def _merge_labels(self, labels: np.ndarray, table: dict) -> np.ndarray:
        """Block-local distinct labels -> global codes (the only per-item
        Python work on the encoded path)."""
        out = np.empty(len(labels), dtype=np.int64)
        for j, lab in enumerate(labels):
            code = table.get(lab)
            if code is None:
                code = len(table)
                table[lab] = code
            out[j] = code
        return out

    def add_block(self, block: ColumnarEvents) -> None:
        if not len(block):
            return
        if block.is_encoded:
            # dictionary-encoded block (native-codec fast lane): remap
            # the block's small label tables into the global dicts and
            # gather — zero per-event Python objects. Only labels a KEPT
            # row actually references are registered: a part's label
            # table spans the whole file, and upstream filters must not
            # leak phantom entities into the maps.
            ecodes = block.entity_codes
            tcodes = block.target_codes
            if (ecodes < 0).any():
                raise ValueError(
                    f"{int((ecodes < 0).sum())} events have no entity id; "
                    "filter the scan (e.g. by entity_type) before "
                    "streaming ingest")
            keep = tcodes >= 0
            if not keep.all():
                ecodes, tcodes = ecodes[keep], tcodes[keep]
                vals = np.asarray(block.values, dtype=np.float32)[keep]
            else:
                vals = np.asarray(block.values, dtype=np.float32)
            if not len(ecodes):
                return
            uniq_e, inv_e = _unique_codes(ecodes,
                                          len(block.entity_labels))
            uniq_t, inv_t = _unique_codes(tcodes,
                                          len(block.target_labels))
            self._rows.append(self._merge_labels(
                block.entity_labels[uniq_e], self._users)[inv_e])
            self._cols.append(self._merge_labels(
                block.target_labels[uniq_t], self._items)[inv_t])
            self._vals.append(vals)
            self.n_events += len(ecodes)
            return
        # same guard as TrainingData/encode_entities: a None entity id
        # must never become the literal string "None" and train a
        # phantom row — the streaming path may not silently diverge
        bad = np.fromiter((x is None for x in block.entity_ids),
                          dtype=bool, count=len(block.entity_ids))
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} events have no entity id; filter the "
                "scan (e.g. by entity_type) before streaming ingest")
        missing = np.fromiter((x is None for x in block.target_ids),
                              dtype=bool, count=len(block.target_ids))
        if missing.any():
            block = block.take(~missing)
            if not len(block):
                return
        self._rows.append(self._encode(block.entity_ids, self._users))
        self._cols.append(self._encode(block.target_ids, self._items))
        self._vals.append(np.asarray(block.values, dtype=np.float32))
        self.n_events += len(block)

    def finalize(self):
        """-> (user_map, item_map, rows, cols, values) with dense int64
        codes in first-seen order."""
        from predictionio_tpu_torch.data.bimap import StringIndexBiMap

        user_map = StringIndexBiMap.from_distinct(list(self._users))
        item_map = StringIndexBiMap.from_distinct(list(self._items))
        rows = (np.concatenate(self._rows) if self._rows
                else np.empty(0, dtype=np.int64))
        cols = (np.concatenate(self._cols) if self._cols
                else np.empty(0, dtype=np.int64))
        vals = (np.concatenate(self._vals) if self._vals
                else np.empty(0, dtype=np.float32))
        return user_map, item_map, rows, cols, vals


class PipelinedRatingsBuilder(StreamingRatingsBuilder):
    """StreamingRatingsBuilder whose consumer stage also PRE-SORTS each
    block's triples by their packed (row, col) key as blocks arrive —
    the per-block share of the dedup sort, done inside the
    decode/index overlap window. :meth:`finalize_bucketed` then
    replaces the monolithic O(N log N) argsort over the full COO
    arrays with a stable O(N log k) k-way merge of the already-sorted
    runs (native kernel, GIL released) and feeds both solve sides'
    bucket scatter + async staging to the card from it.

    Byte-identity with the serial path is by construction: the merge
    permutation equals ``np.argsort(key, kind="stable")`` over the
    stream-ordered triples (per-block stable sorts + stable merge keep
    every duplicate pair's stream order), and the dedup summation and
    bucket scatter are the very same code the serial
    ``bucket_ratings_pair`` runs.

    Note :meth:`finalize` (the uniform-path contract) returns triples
    in merged (row, col) order rather than stream order — the same
    multiset, and identical training inputs for every consumer that
    dedups (pad_ratings / bucket_ratings_pair both do). A consumer
    that is sensitive to raw triple ORDER (e.g. a leave-last-out eval
    split) must use :class:`StreamingRatingsBuilder` instead."""

    def add_block(self, block: ColumnarEvents) -> None:
        runs_before = len(self._rows)
        super().add_block(block)
        if len(self._rows) == runs_before:
            return  # block empty or fully filtered
        r, c = self._rows[-1], self._cols[-1]
        # rows fit 31 bits at any realistic entity count; cols 32
        key = (r << np.int64(32)) | c
        order = np.argsort(key, kind="stable")
        self._rows[-1] = r[order]
        self._cols[-1] = c[order]
        self._vals[-1] = self._vals[-1][order]

    def merge_sorted(self):
        """-> (rows, cols, vals, keys) globally stable-sorted by
        (row, col): the k-way merge of the per-block sorted runs
        (``keys`` is the sorted packed key array — callers feed it to
        the dedup without re-packing). Equal keys keep stream order, so
        :func:`ops.als.dedup_sum_sorted` sums duplicates in exactly the
        serial path's order."""
        from predictionio_tpu_torch.native import codec as _native

        if not self._rows:
            z = np.empty(0, dtype=np.int64)
            return z, z.copy(), np.empty(0, dtype=np.float32), z.copy()
        rows = np.concatenate(self._rows)
        cols = np.concatenate(self._cols)
        vals = np.concatenate(self._vals)
        keys = (rows << np.int64(32)) | cols
        if len(self._rows) > 1:
            offsets = np.zeros(len(self._rows) + 1, dtype=np.int64)
            np.cumsum([len(a) for a in self._rows], out=offsets[1:])
            perm = _native.merge_sorted_runs(keys, offsets)
            if perm is None:  # PIO_NATIVE_DISABLE=1: the same permutation
                perm = np.argsort(keys, kind="stable")
            rows, cols, vals, keys = \
                rows[perm], cols[perm], vals[perm], keys[perm]
        return rows, cols, vals, keys

    def finalize(self):
        """Uniform-path contract (user_map, item_map, rows, cols,
        values) — triples arrive merged-sorted, not stream-ordered."""
        from predictionio_tpu_torch.data.bimap import StringIndexBiMap

        user_map = StringIndexBiMap.from_distinct(list(self._users))
        item_map = StringIndexBiMap.from_distinct(list(self._items))
        rows, cols, vals, _ = self.merge_sorted()
        return user_map, item_map, rows, cols, vals

    def finalize_bucketed(self, bucket_lengths=None, max_len=None,
                          pad_multiple: int = 8, row_multiple: int = 8,
                          stage_device: bool = False, device=None,
                          warmup_params=None,
                          timeline=None) -> "PipelinedIngestResult":
        """Merge + dedup + bucketize both solve sides, overlapping each
        side's async copy to ``device`` (None = cuda) with the other
        side's host scatter (and, when ``warmup_params`` is given, with
        :func:`~predictionio_tpu_torch.ops.als.warmup_train_als_bucketed`
        on a background thread).

        Identical bucket layouts to
        ``ops.als.bucket_ratings_pair(rows, cols, vals, ...)`` over the
        stream-ordered triples."""
        import threading as _threading

        from predictionio_tpu_torch.data.bimap import StringIndexBiMap
        from predictionio_tpu_torch.ops import als as _als
        from predictionio_tpu_torch.utils.tracing import (
            StageTimeline,
            current_trace_context,
        )

        timeline = timeline if timeline is not None else StageTimeline()
        # the caller's trace (if any) parents every stage span, on
        # whichever thread the stage runs
        parent = current_trace_context()
        user_map = StringIndexBiMap.from_distinct(list(self._users))
        item_map = StringIndexBiMap.from_distinct(list(self._items))
        n_u, n_i = len(user_map), len(item_map)
        with timeline.scope("merge", parent):
            rows, cols, vals, key = self.merge_sorted()
            rows, cols, vals = _als.dedup_sum_sorted(key, rows, cols,
                                                     vals)
        with timeline.scope("bucket.user", parent):
            user_side = _als._bucket_grouped(
                rows, cols, vals, n_u, n_i, bucket_lengths, max_len,
                pad_multiple, row_multiple)
        nnz = int(len(rows))
        if stage_device:
            # user side's transfers stream WHILE the item side's
            # re-sort + scatter runs on host (double buffering)
            with timeline.scope("h2d.user.dispatch", parent):
                user_side = user_side.to_device_async(device)
        with timeline.scope("bucket.item", parent):
            o = np.argsort(cols, kind="stable")
            item_side = _als._bucket_grouped(
                cols[o], rows[o], vals[o], n_i, n_u, bucket_lengths,
                max_len, pad_multiple, row_multiple)
        if stage_device:
            with timeline.scope("h2d.item.dispatch", parent):
                item_side = item_side.to_device_async(device)
        warmup_thread = None
        warmup_failure: list = []
        if warmup_params is not None:
            # the kernel build and CUDA set-up hide inside the copy
            # window; the programs are captured on the staged sides (a
            # graph reads its tables at their device addresses), their
            # capture waiting on the copies' events, not on the host
            def _warm():
                try:
                    with timeline.scope("warmup_compile", parent):
                        _als.warmup_train_als_bucketed(
                            user_side, item_side, warmup_params, device)
                except BaseException as e:   # join_warmup raises it
                    warmup_failure.append(e)

            warmup_thread = _threading.Thread(
                target=_warm, daemon=True, name="pio-ingest-warmup")
            warmup_thread.start()
        return PipelinedIngestResult(
            user_map=user_map, item_map=item_map, user_side=user_side,
            item_side=item_side, n_events=self.n_events, nnz=nnz,
            staged=bool(stage_device), timeline=timeline,
            _warmup_thread=warmup_thread,
            _warmup_failure=warmup_failure)


@dataclasses.dataclass
class PipelinedIngestResult:
    """Everything the training step needs, plus the overlap evidence.

    ``user_side``/``item_side`` are :class:`~predictionio_tpu_torch.ops.
    als.BucketedRatings`; with ``staged`` their tables are device tensors
    whose copies may still be in flight — call :meth:`wait` (idempotent)
    before timing-sensitive work, or just train (the trainer waits on
    each side's copy event first)."""

    user_map: object
    item_map: object
    user_side: object
    item_side: object
    n_events: int
    nnz: int
    staged: bool
    timeline: object
    _warmup_thread: object = None
    _warmup_failure: object = None

    def wait(self, warmup: bool = True) -> "PipelinedIngestResult":
        """``warmup=False`` closes only the copy window (ingest is
        done); the warm-up tail then belongs to the first training
        call — join it there via :meth:`join_warmup`."""
        from predictionio_tpu_torch.utils.tracing import current_trace_context

        parent = current_trace_context()
        if self.staged:
            with self.timeline.scope("h2d.wait", parent):
                self.user_side.block_until_staged()
                self.item_side.block_until_staged()
        if warmup:
            self.join_warmup()
        return self

    def join_warmup(self) -> "PipelinedIngestResult":
        """Wait for the background warm-up (no-op without one); train
        right after and the kernels are built and set up, the programs
        captured. Raises what the warm-up raised (a capture that failed),
        once."""
        if self._warmup_thread is not None:
            with self.timeline.scope("warmup_wait"):
                self._warmup_thread.join()
            self._warmup_thread = None
            if self._warmup_failure:
                raise self._warmup_failure.pop()
        return self


def ingest_ratings_pipelined(blocks, queue_size: int = 4,
                             bucket_lengths=None, max_len=None,
                             pad_multiple: int = 8, row_multiple: int = 8,
                             stage_device: bool = False, device=None,
                             warmup_params=None,
                             timeline=None) -> PipelinedIngestResult:
    """The overlapped ingest pipeline, end to end: drive ``blocks`` (a
    ColumnarEvents iterator, e.g. ``find_columnar_blocks``) on a
    producer thread through a bounded queue; index + block-sort each
    block on the consumer as it arrives; then merge/dedup/bucketize
    with each side's copy to ``device`` (and the optional training
    warm-up) overlapping the remaining host work. Returns a
    :class:`PipelinedIngestResult`; call ``.wait()`` to close the
    overlap window.

    Training inputs are byte-identical to the serial
    ``StreamingRatingsBuilder`` + ``bucket_ratings_pair`` chain — see
    :class:`PipelinedRatingsBuilder`."""
    from predictionio_tpu_torch.utils.tracing import (
        StageTimeline,
        current_trace_context,
    )

    timeline = timeline if timeline is not None else StageTimeline()
    parent = current_trace_context()
    builder = PipelinedRatingsBuilder()
    timed_blocks = timeline.wrap_iter(blocks, "decode", parent)
    for block in iter_blocks_threaded(timed_blocks,
                                      queue_size=queue_size):
        with timeline.scope("index", parent):
            builder.add_block(block)
    return builder.finalize_bucketed(
        bucket_lengths=bucket_lengths, max_len=max_len,
        pad_multiple=pad_multiple, row_multiple=row_multiple,
        stage_device=stage_device, device=device,
        warmup_params=warmup_params, timeline=timeline)


def iter_blocks_threaded(block_iter, queue_size: int = 4):
    """Drive a block-producing iterator on a background thread, yielding
    blocks through a bounded queue — partition read + native-codec
    decode (the C++ call releases the GIL) overlap the consumer's numpy
    indexing. The bound caps in-flight memory at ``queue_size`` blocks.
    The reference gets the same overlap for free from Spark executor
    scans feeding the driver (``HBPEvents.scala:83-89``).

    Early consumer exit (an exception downstream, or the generator being
    abandoned) stops the producer promptly: the yield loop's ``finally``
    sets a stop flag, drains the queue so a blocked ``put`` wakes, joins
    the thread, and the source iterator is closed — no leaked thread
    pinning decoded blocks in a long-lived server process."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=queue_size)
    done = object()
    stop = threading.Event()
    failure = []

    def put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for b in block_iter:
                if not put(b):
                    return
        except BaseException as e:  # re-raised on the consumer side
            failure.append(e)
        finally:
            close = getattr(block_iter, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            put(done)

    t = threading.Thread(target=produce, daemon=True,
                         name="pio-block-decode")
    t.start()
    try:
        while True:
            b = q.get()
            if b is done:
                break
            yield b
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10)
    if failure:
        raise failure[0]


def events_to_columnar(events: Iterable[Event],
                       value_property: Optional[str] = None,
                       default_value: float = 1.0,
                       strict: bool = True) -> ColumnarEvents:
    """Generic Event-objects -> columnar conversion (backend fallback).

    ``value_property`` names the DataMap field to extract as the value
    column (e.g. ``"rating"``); rows without it (or with JSON null) get
    ``default_value`` — the template convention where a ``view`` event
    counts as an implicit 1.0 (``DataSource.scala:44-56``). A present but
    non-numeric value (string, bool, list, ...) raises ``ValueError`` when
    ``strict`` (matching ``DataMap.get(name, float)``'s loud failure);
    ``strict=False`` maps it to ``default_value``.
    """
    ents, tgts, vals, times, names = [], [], [], [], []
    for e in events:
        ents.append(e.entity_id)
        tgts.append(e.target_entity_id)
        times.append(e.event_time.timestamp())
        names.append(e.event)
        v = default_value
        if value_property is not None and value_property in e.properties:
            raw = e.properties[value_property]
            if isinstance(raw, (int, float)) and not isinstance(raw, bool):
                v = float(raw)
            elif raw is not None and strict:
                raise ValueError(
                    f"property {value_property!r} of event "
                    f"{e.event_id or e.event!r} is non-numeric: {raw!r}")
        vals.append(v)
    n = len(ents)
    return ColumnarEvents(
        entity_ids=np.asarray(ents, dtype=object) if n
        else np.empty(0, dtype=object),
        target_ids=np.asarray(tgts, dtype=object) if n
        else np.empty(0, dtype=object),
        values=np.asarray(vals, dtype=np.float32),
        event_times=np.asarray(times, dtype=np.float64),
        events=np.asarray(names, dtype=object) if n
        else np.empty(0, dtype=object),
    )
