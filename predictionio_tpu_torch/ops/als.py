"""Alternating least squares: host layouts, the device math and trainers.

The port's copy of ``predictionio_tpu/ops/als.py`` (names kept, so each
counterpart is easy to find):

- **Host layouts** (numpy only): ``PaddedRatings`` / ``pad_ratings`` /
  ``pad_rows_to_block``, the uniform ``[N, L]`` tables, and
  ``RatingsBucket`` / ``BucketedRatings`` / ``bucket_ratings`` /
  ``bucket_ratings_pair``, the length-bucketed ones. As in the JAX
  package, the tables are filled by the native ingest kernels
  (:mod:`~predictionio_tpu_torch.native.codec`: ``bucket_fill``,
  ``segment_starts``, and ``merge_sorted_runs`` when the ratings arrive
  as sorted runs); ``PIO_NATIVE_DISABLE=1`` takes the numpy scatter,
  which gives the same bytes.
- **Device math** (torch): ``_solve_rows`` solves one batch of rows
  through the two CUDA kernels of :mod:`~predictionio_tpu_torch.ops.
  als_cuda`, ``assemble_normal_equations`` then ``spd_solve`` (their
  plain versions on CPU tensors); ``als_iterations`` and
  ``als_iterations_bucketed`` are the training loops, as Python loops.
  ``Y^T Y`` is a plain large product and stays ``torch.matmul``.
- **The precision policy** (``PRECISION_MODES``, ``_als_precision_mode``,
  ``factor_dtype``, ``init_policy_factors``): ``fp32``, or ``bf16``, the
  ALX storage/compute split: factors stored and gathered bf16, weights
  rounded to bf16, the normal equations summed and solved in fp32. The
  factor tensors' dtype carries the policy through the loops.
- **Trainers**: ``train_als`` and ``train_als_bucketed`` return host
  fp32 numpy ``(X [N, R], Y [M, R])`` as the JAX ones do, in either
  precision; with ``PIO_CHECKPOINT_DIR`` set they run the crash-safe
  chunked lane of :mod:`~predictionio_tpu_torch.workflow.checkpoint`
  (atomic checkpoints, preemption, exact resume), bitwise equal to the
  unchunked loop. ``warmup_train_als_bucketed`` readies the card for the
  second.
- **Training objective** (``training_objective``, ``_objective_pack``):
  the ``[fit, l2, finite]`` sample the chunked lane records per chunk.
- **Staging**: ``BucketedRatings.to_device_async`` copies the tables to
  the card from pinned memory on a copy stream of their own, and
  ``block_until_staged`` hands them to the current stream.
- **Online fold-in**: ``pad_fold_in_batch`` and ``fold_in_users``, the
  training half-step for a few users against fixed item factors (the
  solve of :mod:`~predictionio_tpu_torch.online.foldin`).

Implicit objective (Hu-Koren-Volinsky, as in MLlib): confidence
``c = 1 + alpha * |r|``, preference ``p = 1`` iff ``r > 0``; per row
``(Y^T Y + Y^T (C - I) Y + lambda I) x = Y^T C p``. Explicit (ALS-WR):
``(Y_u^T Y_u + lambda * n_u * I) x = Y_u^T r_u``.

- **The config grid** (``_solve_rows_grid``, ``_solve_side_bucketed_grid``,
  ``_als_iterations_grid``, ``_grid_call_args``, ``_objective_pack_grid``):
  ``k`` configurations with a leading config axis on the factors and
  ``[k]`` ``lam`` / ``alpha`` against one copy of the bucketed tables (JAX
  ``vmap``s the half-step); each bucket's assembly is one launch for all
  configs, and rank sweeps ride ``extra_ridge`` (exact-zero pad columns).
  :mod:`~predictionio_tpu_torch.ops.tuning` trains through them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.base import Params
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.native import codec as native_codec
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.utils import device_telemetry as _dtel
from predictionio_tpu_torch.utils import tracing as _tracing


@dataclasses.dataclass(frozen=True)
class ALSParams(Params):
    """Field for field the reference's ALS parameters, so an engine.json
    written for the JAX package parses here unchanged; see
    ``predictionio_tpu/ops/als.py:44-90`` for what each one does."""

    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    implicit_prefs: bool = True
    seed: Optional[int] = None
    solve_block_rows: Optional[int] = None
    bucket_slot_budget: Optional[int] = None
    precision: str = "fp32"
    solve_refine: bool = False
    checkpoint_every: Optional[int] = None


# -- host layouts --------------------------------------------------------------

@dataclasses.dataclass
class PaddedRatings:
    """One side's ragged ratings padded to ``[n_rows, max_len]``:
    ``cols`` the column index of each rating (0 when padded),
    ``weights`` its value, ``mask`` 1.0 for real entries. Rows at or
    past ``n_valid_rows`` (set by :func:`pad_rows_to_block`) are
    padding."""

    cols: np.ndarray      # int32 [n_rows, L]
    weights: np.ndarray   # float32 [n_rows, L]
    mask: np.ndarray      # float32 [n_rows, L]
    n_rows: int
    n_cols: int
    n_valid_rows: Optional[int] = None

    @property
    def max_len(self) -> int:
        return int(self.cols.shape[1])

    @property
    def valid_rows(self) -> int:
        return self.n_rows if self.n_valid_rows is None \
            else self.n_valid_rows


# rows pad to a multiple of this in every solve-table layout
PAD_MULTIPLE = 8


def stable_key_order(key: np.ndarray,
                     runs: Optional[np.ndarray] = None) -> np.ndarray:
    """``np.argsort(key, kind="stable")``. With ``runs`` (offsets of
    contiguous runs, ``[0, ..., len(key)]``: the blocks of a streaming
    read) each run is sorted on its own and the native k-way merge
    joins them; ties keep index order either way, so the permutation is
    the same."""
    if runs is None or len(runs) <= 2:
        return np.argsort(key, kind="stable")
    runs = np.asarray(runs, dtype=np.int64)
    if int(runs[0]) != 0 or int(runs[-1]) != len(key):
        raise ValueError(f"runs {runs[[0, -1]]} do not span {len(key)} keys")
    local = np.empty(len(key), dtype=np.int64)
    for a, b in zip(runs[:-1].tolist(), runs[1:].tolist()):
        local[a:b] = a + np.argsort(key[a:b], kind="stable")
    perm = native_codec.merge_sorted_runs(key[local], runs)
    if perm is None:
        return np.argsort(key, kind="stable")
    return local[perm]


def dedup_sum_ratings(rows: np.ndarray, cols: np.ndarray,
                      values: np.ndarray, n_cols: int,
                      runs: Optional[np.ndarray] = None):
    """Sum duplicate (row, col) pairs (the template's ``reduceByKey(_ +
    _)``); returns unique (rows, cols, summed values) sorted by (row,
    col). ``runs``: see :func:`stable_key_order`."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.float32)
    if not len(rows):
        return rows, cols, values
    key = rows * n_cols + cols
    order = stable_key_order(key, runs)
    return dedup_sum_sorted(key[order], rows[order], cols[order],
                            values[order])


def dedup_sum_sorted(key: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                     values: np.ndarray):
    """The dedup-sum over triples already stably sorted by the (row,
    col) key: segment starts, then one ``np.add.reduceat``."""
    if not len(rows):
        return (np.asarray(rows, dtype=np.int64),
                np.asarray(cols, dtype=np.int64),
                np.asarray(values, dtype=np.float32))
    starts = native_codec.segment_starts(key)
    if starts is None:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    sums = np.add.reduceat(values, starts).astype(np.float32)
    return (rows[starts].astype(np.int64),
            cols[starts].astype(np.int64), sums)


def _strongest_first(rows, cols, values):
    """Each row's ratings strongest magnitude first, so a ``max_len``
    cut keeps the heaviest."""
    order = np.lexsort((-np.abs(values), rows))
    return rows[order], cols[order], values[order]


def pad_ratings(rows: np.ndarray, cols: np.ndarray, values: np.ndarray,
                n_rows: int, n_cols: int, pad_multiple: int = PAD_MULTIPLE,
                max_len: Optional[int] = None,
                runs: Optional[np.ndarray] = None) -> PaddedRatings:
    """Host-side padding of rating triples for one solve side, after
    summing duplicates. ``max_len`` truncates long rows, keeping their
    largest-magnitude ratings. ``runs``: see :func:`stable_key_order`."""
    rows, cols, values = dedup_sum_ratings(rows, cols, values, n_cols, runs)
    counts = np.bincount(rows, minlength=n_rows)
    true_top = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    L = true_top if max_len is None else min(true_top, int(max_len))
    L = max(1, -(-L // pad_multiple) * pad_multiple)
    if true_top > L:
        rows, cols, values = _strongest_first(rows, cols, values)
    row_starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_starts[1:])
    pos = np.arange(len(rows)) - row_starts[rows]
    if true_top > L:
        keep = pos < L
        rows, cols, values, pos = rows[keep], cols[keep], values[keep], \
            pos[keep]
    out_cols = np.zeros((n_rows, L), dtype=np.int32)
    out_w = np.zeros((n_rows, L), dtype=np.float32)
    out_m = np.zeros((n_rows, L), dtype=np.float32)
    # the uniform table is the one-bucket case of the native fill (row
    # rank == row index)
    if not native_codec.bucket_fill(rows, cols, values, pos,
                                    np.zeros(n_rows, dtype=np.int32),
                                    np.arange(n_rows, dtype=np.int64),
                                    [(out_cols, out_w, out_m)]):
        out_cols[rows, pos] = cols
        out_w[rows, pos] = values
        out_m[rows, pos] = 1.0
    return PaddedRatings(out_cols, out_w, out_m, n_rows, n_cols)


def pad_rows_to_block(side: PaddedRatings, block: int) -> PaddedRatings:
    """Pad the row dimension to a multiple of ``block`` with empty rows,
    recording the true row count in ``n_valid_rows``."""
    pad = (-side.n_rows) % block
    if pad == 0:
        return side

    def z(a):
        return np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)])

    return PaddedRatings(z(side.cols), z(side.weights), z(side.mask),
                         side.n_rows + pad, side.n_cols,
                         n_valid_rows=side.valid_rows)


@dataclasses.dataclass
class RatingsBucket:
    """Rows of one length class, padded to the bucket's own ``L``.
    ``row_ids[i]`` is the true row of table row ``i``; rows added to
    round the count up carry the sentinel ``n_rows`` and a zero mask,
    and the half-step drops them. Tables are numpy arrays, or torch
    tensors after :meth:`BucketedRatings.to_device`."""

    row_ids: np.ndarray   # int32 [B]
    cols: np.ndarray      # int32 [B, L]
    weights: np.ndarray   # float32 [B, L]
    mask: np.ndarray      # float32 [B, L]

    @property
    def max_len(self) -> int:
        return int(self.cols.shape[1])


@dataclasses.dataclass
class BucketedRatings:
    """One solve side's ratings grouped into row-length buckets, each
    padded only to its own length class."""

    buckets: List[RatingsBucket]
    n_rows: int
    n_cols: int

    @property
    def padded_slots(self) -> int:
        return sum(int(np.prod(b.cols.shape)) for b in self.buckets)

    @property
    def nnz(self) -> int:
        return int(sum(float(b.mask.sum()) for b in self.buckets))

    @property
    def occupancy(self) -> float:
        slots = self.padded_slots
        return self.nnz / slots if slots else 0.0

    # the copies in flight from :meth:`to_device_async` (None when the
    # tables are numpy arrays or already usable on every stream)
    staging: Optional["Staging"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def to_device(self, device: DeviceLike = None) -> "BucketedRatings":
        """A BucketedRatings whose tables are torch tensors on ``device``
        (None = cuda), usable on the current stream when it returns; the
        original stays as it is. Tables already there are not copied."""
        return self.to_device_async(device).block_until_staged()

    def to_device_async(self, device: DeviceLike = None
                        ) -> "BucketedRatings":
        """Start every table's copy to ``device`` (None = cuda) without
        waiting for it, so the host can go on (bucketing the other solve
        side) while these bytes move. On CUDA the tables are copied into
        pinned host memory (a copy from pageable memory would not be
        asynchronous; :attr:`Staging.pin_seconds` says what the pinning
        took), then to the card with ``non_blocking=True`` on a copy
        stream of their own, and a CUDA event is recorded after the last
        copy. On the CPU the copy is synchronous. Call
        :meth:`block_until_staged` before the tables are used on another
        stream (``to_device`` and the trainers do). Returns ``self`` when
        every table is already on ``device``."""
        dev = resolve_device(device)
        tables = [(b.row_ids, b.cols, b.weights, b.mask)
                  for b in self.buckets]
        if all(isinstance(a, torch.Tensor) and a.device.type == dev.type
               and dev.index in (None, a.device.index)
               for t in tables for a in t):
            return self
        self.block_until_staged()       # the copies below read the tables
        if dev.type != "cuda":
            return dataclasses.replace(self, buckets=[
                RatingsBucket(*(torch.as_tensor(a, device=dev) for a in t))
                for t in tables])
        t0 = time.perf_counter()
        pinned = [[torch.as_tensor(a).pin_memory() for a in t]
                  for t in tables]
        pin_seconds = time.perf_counter() - t0
        stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(stream):
            moved = [[a.to(dev, non_blocking=True) for a in t]
                     for t in pinned]
            done = torch.cuda.Event()
            done.record(stream)
        out = dataclasses.replace(self, buckets=[
            RatingsBucket(*t) for t in moved])
        out.staging = Staging(
            event=done, stream=stream, pin_seconds=pin_seconds,
            nbytes=sum(a.nbytes for t in pinned for a in t),
            tensors=[a for t in moved for a in t], host=pinned)
        return out

    def block_until_staged(self) -> "BucketedRatings":
        """Wait for this instance's copies from :meth:`to_device_async`,
        then make them safe on the current stream: it waits on the copy
        event, and each table records that stream, so its memory is not
        reused before the current stream's work on it ends. Returns
        ``self``; a no-op when nothing is in flight."""
        st = self.staging
        if st is not None:
            st.event.synchronize()
            current = torch.cuda.current_stream(st.stream.device)
            current.wait_event(st.event)
            for t in st.tensors:
                t.record_stream(current)
            self.staging = None
        return self


@dataclasses.dataclass
class Staging:
    """The copies :meth:`BucketedRatings.to_device_async` started: the
    copy stream and the event recorded after its last copy, the seconds
    the host spent pinning the tables and their bytes. ``tensors`` are
    the tables on the card (allocated on the copy stream); ``host``
    keeps their pinned sources alive until the copies end."""

    event: object
    stream: object
    pin_seconds: float
    nbytes: int
    tensors: list
    host: list


def bucket_ratings(rows: np.ndarray, cols: np.ndarray, values: np.ndarray,
                   n_rows: int, n_cols: int,
                   bucket_lengths: Optional[Sequence[int]] = None,
                   max_len: Optional[int] = None,
                   pad_multiple: int = PAD_MULTIPLE,
                   row_multiple: int = 8) -> BucketedRatings:
    """Group rows by rating count into geometric length buckets, after
    summing duplicates. ``max_len=None`` truncates nothing;
    ``bucket_lengths=None`` builds a x2 ladder from 16 up to the longest
    row."""
    rows, cols, values = dedup_sum_ratings(rows, cols, values, n_cols)
    return _bucket_grouped(rows, cols, values, n_rows, n_cols,
                           bucket_lengths, max_len, pad_multiple,
                           row_multiple)


def bucket_ratings_pair(
        rows: np.ndarray, cols: np.ndarray, values: np.ndarray,
        n_rows: int, n_cols: int,
        bucket_lengths: Optional[Sequence[int]] = None,
        max_len: Optional[int] = None, pad_multiple: int = PAD_MULTIPLE,
        row_multiple: int = 8, runs: Optional[np.ndarray] = None
) -> Tuple[BucketedRatings, BucketedRatings]:
    """Both solve sides from one dedup-sum: the row side from the
    row-grouped result, the column side after one stable re-sort.
    Returns ``(row_side, col_side)``. ``runs``: see
    :func:`stable_key_order`."""
    rows, cols, values = dedup_sum_ratings(rows, cols, values, n_cols, runs)
    row_side = _bucket_grouped(rows, cols, values, n_rows, n_cols,
                               bucket_lengths, max_len, pad_multiple,
                               row_multiple)
    o = np.argsort(cols, kind="stable")
    col_side = _bucket_grouped(cols[o], rows[o], values[o], n_cols, n_rows,
                               bucket_lengths, max_len, pad_multiple,
                               row_multiple)
    return row_side, col_side


def _bucket_grouped(rows, cols, values, n_rows: int, n_cols: int,
                    bucket_lengths, max_len, pad_multiple: int,
                    row_multiple: int) -> BucketedRatings:
    """Bucketing over deduplicated triples sorted by row."""
    counts = np.bincount(rows, minlength=n_rows)
    true_top = int(counts.max()) if counts.size and counts.max() > 0 else 1
    L_top = true_top if max_len is None else min(true_top, int(max_len))
    L_top = max(1, -(-L_top // pad_multiple) * pad_multiple)
    if bucket_lengths is None:
        lengths = []
        L = min(16, L_top)
        while L < L_top:
            lengths.append(L)
            L *= 2
        lengths.append(L_top)
    else:
        lengths = sorted({min(int(x), L_top) for x in bucket_lengths})
        if not lengths or lengths[-1] < L_top:
            lengths.append(L_top)
    lengths = sorted({max(1, -(-x // pad_multiple) * pad_multiple)
                      for x in lengths})

    if true_top > L_top:
        rows, cols, values = _strongest_first(rows, cols, values)
    row_starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_starts[1:])
    pos = np.arange(len(rows)) - row_starts[rows]
    if true_top > L_top:
        keep = pos < L_top
        rows, cols, values, pos = rows[keep], cols[keep], values[keep], \
            pos[keep]

    eff = np.minimum(counts, L_top)
    b_of_row = np.searchsorted(lengths, eff, side="left")
    rank = np.empty(n_rows, dtype=np.int64)  # valid only at member rows
    # every bucket's zeroed tables first, then one fill: the native one
    # pass over all entries, or the numpy scatter (one boolean pass over
    # the entries per bucket), byte for byte the same
    tables: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    id_lists: List[np.ndarray] = []
    table_of_bucket = np.full(len(lengths), -1, dtype=np.int32)
    for b, L in enumerate(lengths):
        members = np.nonzero((b_of_row == b) & (eff > 0))[0]
        if members.size == 0:
            continue
        B = int(members.size)
        Bp = -(-B // row_multiple) * row_multiple
        rank[members] = np.arange(B)
        oc = np.zeros((Bp, L), dtype=np.int32)
        ow = np.zeros((Bp, L), dtype=np.float32)
        om = np.zeros((Bp, L), dtype=np.float32)
        row_ids = np.full(Bp, n_rows, dtype=np.int32)  # pad sentinel
        row_ids[:B] = members
        table_of_bucket[b] = len(tables)
        tables.append((oc, ow, om))
        id_lists.append(row_ids)
    if tables and not native_codec.bucket_fill(
            rows, cols, values, pos, table_of_bucket[b_of_row], rank,
            tables):
        b_of_entry = b_of_row[rows]
        for b in range(len(lengths)):
            if table_of_bucket[b] < 0:
                continue
            oc, ow, om = tables[table_of_bucket[b]]
            sel = b_of_entry == b
            r, p = rank[rows[sel]], pos[sel]
            oc[r, p] = cols[sel]
            ow[r, p] = values[sel]
            om[r, p] = 1.0
    out = [RatingsBucket(ids, *t) for ids, t in zip(id_lists, tables)]
    return BucketedRatings(out, n_rows, n_cols)


# -- device math ----------------------------------------------------------------

def implicit_weights(w: torch.Tensor, alpha: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hu-Koren-Volinsky weights: A weights ``alpha*|r|`` and b weights
    ``pref*(1+alpha*|r|)`` with ``pref = 1 iff r > 0``."""
    aw = alpha * torch.abs(w)
    return aw, (w > 0).to(w.dtype) * (1.0 + aw)


def zero_empty_rows(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows with no ratings keep a zero factor."""
    return X * (mask.sum(dim=1) > 0).to(X.dtype)[:, None]


PRECISION_MODES = ("fp32", "bf16")


def normalize_precision(value: str, source: str) -> str:
    """Canonicalize a training precision (``float32`` / ``bfloat16``
    accepted for ``fp32`` / ``bf16``) or raise ``ValueError`` naming
    ``source``."""
    mode = {"float32": "fp32", "bfloat16": "bf16"}.get(value, value)
    if mode not in PRECISION_MODES:
        raise ValueError(
            f"{source}={mode!r} is not a known precision mode "
            f"(expected one of: {', '.join(PRECISION_MODES)})")
    return mode


def _als_precision_mode(params: Optional[ALSParams] = None) -> str:
    """The training precision, ``fp32`` or ``bf16``: ``PIO_ALS_PRECISION``
    over ``ALSParams.precision``; an unknown value raises. Resolved once
    per ``train_als*`` / ``fold_in_users`` call, so an env change between
    trainings takes effect."""
    forced = os.environ.get("PIO_ALS_PRECISION", "").strip().lower()
    if forced:
        return normalize_precision(forced, "PIO_ALS_PRECISION")
    mode = str(getattr(params, "precision", None)
               or "fp32").strip().lower()
    return normalize_precision(mode, "ALSParams.precision")


def factor_dtype(precision: str) -> torch.dtype:
    """The factor store's dtype for a resolved precision mode."""
    return torch.bfloat16 if precision == "bf16" else torch.float32


def init_policy_factors(n_rows: int, n_cols: int, rank: int,
                        seed: Optional[int], precision: str,
                        device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`init_factors` under the precision policy: drawn in fp32,
    then cast to the factor dtype, so both lanes start from the same
    numbers up to one rounding."""
    X, Y = init_factors(n_rows, n_cols, rank, seed, device)
    dt = factor_dtype(precision)
    return X.to(dt), Y.to(dt)


def _gram(Y: torch.Tensor) -> torch.Tensor:
    """``Y^T Y`` in fp32. A bf16 store is widened first: a bf16 product
    in torch returns bf16 and would round the Gram; widened, each
    product of two bf16 values is exact in fp32 (TF32 stays off) and the
    sums are fp32, as JAX's ``preferred_element_type=f32``."""
    Yf = Y.float()
    return Yf.T @ Yf


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and back: the bf16 lane's weights, which JAX
    rounds before its products."""
    return t.to(torch.bfloat16).float()


def init_factors(n_rows: int, n_cols: int, rank: int, seed: Optional[int],
                 device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MLlib-style init: normal factors scaled by ``1/sqrt(rank)``,
    drawn on the host from a ``torch.Generator`` seeded with ``seed``
    (0 when None), so every device starts from the same numbers. They
    are not ``jax.random``'s numbers: differential tests inject one
    shared init."""
    g = torch.Generator().manual_seed(0 if seed is None else int(seed))
    scale = 1.0 / np.sqrt(rank)
    X = torch.randn((n_rows, rank), generator=g) * scale
    Y = torch.randn((n_cols, rank), generator=g) * scale
    dev = resolve_device(device)
    return X.to(dev), Y.to(dev)


def _solve_rows(Y: torch.Tensor, cols: torch.Tensor, weights: torch.Tensor,
                mask: torch.Tensor, lam: float, alpha: float, implicit: bool,
                gram: Optional[torch.Tensor] = None, refine: bool = False,
                extra_ridge=None, events: Optional[list] = None
                ) -> torch.Tensor:
    """Normal-equation solve for one batch of rows: fixed factors
    ``Y [M, R]`` and padded ratings ``[B, L]`` (+ validity mask) give new
    factors ``[B, R]`` in ``Y``'s dtype. ``gram`` (``Y^T Y``, fp32) may
    be passed in so bucketed solves share one.

    Implicit: ``lam * I`` is folded into the Gram term the assembly
    adds (as the JAX ``solve_side_pallas`` does; the JAX XLA path adds
    it after the sum, so the two differ in the last bits). Explicit: the
    assembly's Gram term is zero and ``lam * max(n_b, 1)`` joins the
    diagonal after it, ``n_b`` counted over the real slots.
    ``refine`` adds one refinement pass ``x += solve(A, b - A x)``.
    ``extra_ridge``, an optional ``[R]`` diagonal addition, is the config
    grid's rank padding (JAX's): a config of rank ``r < R`` carries zero
    factor columns past ``r``, which zero those rows and columns of ``A``
    and ``b``; a positive ridge on their diagonal makes them solve to
    exact zeros and leaves the leading ``r`` coordinates untouched. It
    joins the Gram term's diagonal (after ``lam * I``), so a zero ridge
    changes no bit. ``events``, a list (CUDA only), gains one pair of
    ``torch.cuda.Event(enable_timing=True)`` per kernel launch (the
    assembly, each solve), recorded inside the launch around its
    kernels: the sum of their elapsed times is the kernels' device time
    (the fold-in solve's).

    A bf16 ``Y`` is the bf16 lane (JAX ``_solve_rows_bf16``): the
    assembly gathers the bf16 rows (B3's bf16 route), the weights are
    computed in fp32 and rounded to bf16 as JAX rounds them before its
    products, ``A``/``b`` are summed and solved in fp32, and the new
    factors are cast to bf16. ``lam * I`` is folded into the Gram term
    here too (JAX's bf16 lane adds it after the sum; the two orders
    agree to within fp32 rounding, far inside the lane's bf16
    tolerance).

    The counterpart of both JAX ``_solve_rows`` and ``solve_side_pallas``:
    the port has one solver, the ``spd_solve`` kernel, so JAX's solver
    dispatch ``_spd_solve`` has no counterpart of its own."""
    R = Y.shape[1]
    f32 = torch.float32
    mask = mask.to(f32)
    w = weights.to(f32) * mask                # zero out padded slots
    eye = torch.eye(R, dtype=f32, device=Y.device)
    if implicit:
        aw, bw = implicit_weights(w, alpha)
        if gram is None:
            gram = _gram(Y)
        gram = gram + lam * eye
    else:
        aw, bw, gram = mask, w, torch.zeros_like(eye)
        n_b = mask.sum(dim=1)
    if extra_ridge is not None:
        gram = gram.clone()
        gram.diagonal().add_(torch.as_tensor(extra_ridge, dtype=f32,
                                             device=Y.device))
    if Y.dtype == torch.bfloat16:
        aw, bw = _round_bf16(aw), _round_bf16(bw)

    def timed() -> dict:
        if events is None:
            return {}
        events.append((torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)))
        return {"events": events[-1]}

    A, b = als_cuda.assemble_normal_equations(Y, cols, aw, bw, gram,
                                              **timed())
    if not implicit:
        A.diagonal(dim1=1, dim2=2).add_((lam * n_b.clamp(min=1.0))[:, None])
    X = als_cuda.spd_solve(A, b, **timed())
    if refine:
        X = X + als_cuda.spd_solve(A, b - torch.einsum("brs,bs->br", A, X),
                                   **timed())
    return zero_empty_rows(X.to(Y.dtype), mask)


def _solve_side_blocked(Y, cols, weights, mask, lam: float, alpha: float,
                        implicit: bool, block: Optional[int],
                        refine: bool = False) -> torch.Tensor:
    """One uniform-table half-step, over sequential row blocks of
    ``block`` rows when set (the caller pads rows to a multiple)."""
    B = cols.shape[0]
    if not block or B <= block:
        return _solve_rows(Y, cols, weights, mask, lam, alpha, implicit,
                           refine=refine)
    return torch.cat([
        _solve_rows(Y, cols[s:s + block], weights[s:s + block],
                    mask[s:s + block], lam, alpha, implicit, refine=refine)
        for s in range(0, B, block)])


def als_iterations(X, Y, u_cols, u_w, u_m, i_cols, i_w, i_m, *, lam: float,
                   alpha: float, implicit: bool, num_iterations: int,
                   block: Optional[int] = None, refine: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniform training loop (``_als_iterations_impl``): each
    iteration solves the user side against ``Y``, then the item side
    against the new ``X``. Returns new tensors; the inputs are not
    changed. The factors' dtype (fp32 or bf16) is the precision lane."""
    for _ in range(int(num_iterations)):
        X = _solve_side_blocked(Y, u_cols, u_w, u_m, lam, alpha, implicit,
                                block, refine)
        Y = _solve_side_blocked(X, i_cols, i_w, i_m, lam, alpha, implicit,
                                block, refine)
    return X, Y


def _solve_side_bucketed(Y: torch.Tensor, buckets, n_rows_out: int,
                         lam: float, alpha: float, implicit: bool,
                         slot_budget: Optional[int],
                         refine: bool = False) -> torch.Tensor:
    """One half-step over length buckets: one shared Gram matrix, one
    batched solve per bucket (in row blocks of at most ``slot_budget``
    slots when set), results written into the ``[n_rows_out, R]``
    factors. Rows in no bucket keep zero factors; bucket pad rows carry
    the sentinel ``row_id == n_rows_out`` and are dropped. The factors
    keep ``Y``'s dtype; the shared Gram is fp32 (:func:`_gram`)."""
    gram = _gram(Y) if implicit else None
    # one spare row takes every sentinel write (no host sync to filter
    # them), and is cut off at the end
    X = torch.zeros((n_rows_out + 1, Y.shape[1]), dtype=Y.dtype,
                    device=Y.device)
    for row_ids, cols, w, m in buckets:
        B, L = cols.shape
        step = B
        if slot_budget and B * L > slot_budget:
            step = max(8, (slot_budget // L) // 8 * 8)
        Xb = torch.cat([
            _solve_rows(Y, cols[s:s + step], w[s:s + step], m[s:s + step],
                        lam, alpha, implicit, gram, refine)
            for s in range(0, B, step)])
        X[row_ids.long()] = Xb
    return X[:n_rows_out]


def als_iterations_bucketed(X, Y, u_buckets, i_buckets, *, lam: float,
                            alpha: float, implicit: bool,
                            num_iterations: int,
                            slot_budget: Optional[int] = None,
                            refine: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bucketed training loop (``_als_iterations_bucketed_impl``);
    ``u_buckets``/``i_buckets`` are sequences of ``(row_ids, cols,
    weights, mask)`` tensors. The factors' dtype is the precision lane."""
    n_u, n_i = X.shape[0], Y.shape[0]
    for _ in range(int(num_iterations)):
        X = _solve_side_bucketed(Y, u_buckets, n_u, lam, alpha, implicit,
                                 slot_budget, refine)
        Y = _solve_side_bucketed(X, i_buckets, n_i, lam, alpha, implicit,
                                 slot_budget, refine)
    return X, Y


# -- the config grid (several configurations in one program) -----------------

def _grid_grams(Y: torch.Tensor, lam: torch.Tensor, implicit: bool,
                ridge: Optional[torch.Tensor]) -> torch.Tensor:
    """``[k, R, R]`` fp32 Gram terms of ``k`` configs' factors ``Y [k, M,
    R]``: implicit, each config's ``_gram(Y[z]) + lam[z] * I`` (the same
    ``_gram`` call per config as the serial half-step, not one batched
    product, so cuBLAS sums each in the serial order); explicit, zeros.
    ``ridge [k, R]`` joins the diagonal (:func:`_solve_rows`'s
    ``extra_ridge``)."""
    k, _, R = Y.shape
    f32 = torch.float32
    if implicit:
        eye = torch.eye(R, dtype=f32, device=Y.device)
        grams = torch.stack([_gram(Y[z]) for z in range(k)]) \
            + lam[:, None, None] * eye
    else:
        grams = torch.zeros((k, R, R), dtype=f32, device=Y.device)
    if ridge is not None:
        grams.diagonal(dim1=1, dim2=2).add_(ridge)
    return grams


def _solve_rows_grid(Y: torch.Tensor, cols: torch.Tensor,
                     weights: torch.Tensor, mask: torch.Tensor,
                     lam: torch.Tensor, alpha: torch.Tensor, implicit: bool,
                     grams: torch.Tensor, refine: bool = False
                     ) -> torch.Tensor:
    """:func:`_solve_rows` for ``k`` configs at once: ``Y [k, M, R]``,
    ``lam``/``alpha [k]`` fp32, ``grams`` from :func:`_grid_grams`, the
    tables ``[B, L]`` shared; returns ``[k, B, R]`` in ``Y``'s dtype.
    The assembly is one launch for all configs
    (``als_cuda.assemble_normal_equations_grid``), the solve one launch
    over the ``[k * B, R, R]`` systems; each config's weights, sums and
    solve take the serial half-step's operations in its order, so a
    config equals its serial run bit for bit."""
    k, _, R = Y.shape
    B = cols.shape[0]
    f32 = torch.float32
    mask = mask.to(f32)
    w = weights.to(f32) * mask                # zero out padded slots
    if implicit:
        aw = alpha[:, None, None] * torch.abs(w)[None]
        bw = (w > 0).to(f32)[None] * (1.0 + aw)
    else:
        aw = mask[None].expand(k, -1, -1).contiguous()
        bw = w[None].expand(k, -1, -1).contiguous()
        n_b = mask.sum(dim=1)
    if Y.dtype == torch.bfloat16:
        aw, bw = _round_bf16(aw), _round_bf16(bw)
    A, b = als_cuda.assemble_normal_equations_grid(Y, cols, aw, bw, grams)
    if not implicit:
        A.diagonal(dim1=2, dim2=3).add_(
            (lam[:, None] * n_b.clamp(min=1.0)[None])[:, :, None])
    A, b = A.reshape(k * B, R, R), b.reshape(k * B, R)
    X = als_cuda.spd_solve(A, b)
    if refine:
        X = X + als_cuda.spd_solve(A, b - torch.einsum("brs,bs->br", A, X))
    return X.reshape(k, B, R).to(Y.dtype) \
        * (mask.sum(dim=1) > 0).to(Y.dtype)[None, :, None]


def _solve_side_bucketed_grid(Y: torch.Tensor, buckets, n_rows_out: int,
                              lam: torch.Tensor, alpha: torch.Tensor,
                              implicit: bool, slot_budget: Optional[int],
                              ridge: Optional[torch.Tensor] = None,
                              refine: bool = False) -> torch.Tensor:
    """:func:`_solve_side_bucketed` for ``k`` configs at once: ``Y [k, M,
    R]`` in, ``[k, n_rows_out, R]`` out (contiguous), the bucket tables
    shared with no config axis."""
    k, _, R = Y.shape
    grams = _grid_grams(Y, lam, implicit, ridge)
    X = torch.zeros((k, n_rows_out + 1, R), dtype=Y.dtype, device=Y.device)
    for row_ids, cols, w, m in buckets:
        B, L = cols.shape
        step = B
        if slot_budget and B * L > slot_budget:
            step = max(8, (slot_budget // L) // 8 * 8)
        Xb = torch.cat([
            _solve_rows_grid(Y, cols[s:s + step], w[s:s + step],
                             m[s:s + step], lam, alpha, implicit, grams,
                             refine)
            for s in range(0, B, step)], dim=1)
        X[:, row_ids.long()] = Xb
    return X[:, :n_rows_out].contiguous()


def _als_iterations_grid(X, Y, lam, alpha, ridge, u_buckets, i_buckets, *,
                         implicit: bool, num_iterations: int,
                         slot_budget: Optional[int] = None,
                         refine: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The config grid's training loop (JAX ``_als_iterations_grid_impl``,
    its ``vmap`` over the config axis): ``X [k, N, R]`` / ``Y [k, M, R]``
    hold one factor set per config, ``lam``/``alpha [k]`` and ``ridge [k,
    R]`` (1.0 on each config's rank-padded columns) are fp32 tensors, and
    the bucket tables are shared. Each half-step assembles every config
    in one launch per bucket and solves all their systems in one."""
    n_u, n_i = X.shape[1], Y.shape[1]
    for _ in range(int(num_iterations)):
        X = _solve_side_bucketed_grid(Y, u_buckets, n_u, lam, alpha,
                                      implicit, slot_budget, ridge, refine)
        Y = _solve_side_bucketed_grid(X, i_buckets, n_i, lam, alpha,
                                      implicit, slot_budget, ridge, refine)
    return X, Y


def _grid_call_args(user_side: BucketedRatings, item_side: BucketedRatings,
                    configs, precision: str, device: DeviceLike = None,
                    num_iterations: Optional[int] = None,
                    r_max: Optional[int] = None):
    """The ``(args, kw)`` the grid's trainer passes to
    :func:`_als_iterations_grid` (JAX ``_grid_call_args``): ``args`` is
    ``(None, None, lam, alpha, ridge, user tables, item tables)`` on
    ``device`` (None = cuda; the caller inits the factors), ``kw`` the
    shared statics from ``configs[0]``. ``r_max`` is the factor width
    (default the largest rank). ``precision`` is resolved by the caller
    (the port has no compiled signature it must match)."""
    dev = resolve_device(device)
    base = configs[0]
    r_max = max([int(c.rank) for c in configs] + [int(r_max or 0)])
    f32 = torch.float32
    lam = torch.tensor([float(c.lambda_) for c in configs], dtype=f32,
                       device=dev)
    alpha = torch.tensor([float(c.alpha) for c in configs], dtype=f32,
                         device=dev)
    # 1.0 exactly on rank-padded columns, 0.0 on real ones
    ridge = torch.as_tensor(
        (np.arange(r_max)[None, :]
         >= np.asarray([int(c.rank) for c in configs])[:, None]
         ).astype(np.float32), device=dev)

    def tables(side):
        return [(b.row_ids, b.cols, b.weights, b.mask)
                for b in side.to_device(dev).buckets]

    args = (None, None, lam, alpha, ridge, tables(user_side),
            tables(item_side))
    kw = dict(implicit=bool(base.implicit_prefs),
              num_iterations=int(base.num_iterations if num_iterations is None
                                 else num_iterations),
              slot_budget=None if not base.bucket_slot_budget
              else int(base.bucket_slot_budget),
              refine=bool(base.solve_refine))
    return args, kw


# -- training objective (the chunked lane's telemetry) -------------------------

def _objective_pack(X: torch.Tensor, Y: torch.Tensor, u_buckets, *,
                    lam: float, alpha: float, implicit: bool
                    ) -> torch.Tensor:
    """``[fit, l2, finite]`` fp32 pack of the objective the solver
    minimizes (JAX ``_objective_pack_impl``), on the factors' device.

    Implicit (Hu-Koren-Volinsky): ``sum_{u,i} c (p - x.y)^2 + lam (|X|^2
    + |Y|^2)``; the sum over all pairs is ``sum_u x_u^T (Y^T Y) x_u``
    plus, over the observed entries, ``bw - 2 bw s + aw s^2`` with ``s =
    x.y`` and ``(aw, bw)`` exactly :func:`implicit_weights`. Explicit
    (ALS-WR): ``sum_obs (r - s)^2 + lam (sum_u n_u |x_u|^2 + sum_i n_i
    |y_i|^2)``, both count-weighted norms from the user-side tables.
    ``u_buckets`` are ``(row_ids, cols, weights, mask)`` tensors of the
    user side (pad rows carry the sentinel id one past the end, clipped
    here; their weights are 0). ``finite`` is 1.0 when both carries are
    finite: the divergence guard in the same sample. Reads the carries
    only; sums in fp32 (a bf16 store is widened once)."""
    f32 = torch.float32
    finite = (torch.isfinite(X).all() & torch.isfinite(Y).all()).to(f32)
    Xf, Yf = X.float(), Y.float()
    fit = torch.zeros((), dtype=f32, device=X.device)
    l2n = torch.zeros((), dtype=f32, device=X.device)
    if implicit:
        fit = fit + ((Xf @ _gram(Yf)) * Xf).sum()
    for row_ids, cols, w, m in u_buckets:
        Xb = Xf[row_ids.long().clamp(0, Xf.shape[0] - 1)]        # [B, R]
        Yg = Yf[cols.long().clamp(0, Yf.shape[0] - 1)]           # [B, L, R]
        s = torch.einsum("blr,br->bl", Yg, Xb)
        m32 = m.to(f32)
        wm = w.to(f32) * m32                   # pads -> aw = bw = 0
        if implicit:
            aw, bw = implicit_weights(wm, alpha)
            fit = fit + (bw - 2.0 * bw * s + aw * s * s).sum()
        else:
            fit = fit + (m32 * (wm - s) ** 2).sum()
            l2n = l2n + (m32.sum(dim=1) * (Xb * Xb).sum(dim=1)).sum()
            l2n = l2n + (m32[:, :, None] * Yg * Yg).sum()
    if implicit:
        l2 = lam * ((Xf * Xf).sum() + (Yf * Yf).sum())
    else:
        l2 = lam * l2n
    return torch.stack([fit, l2, finite])


def _objective_pack_grid(X: torch.Tensor, Y: torch.Tensor, lam, alpha,
                         u_buckets, *, implicit: bool) -> torch.Tensor:
    """Per-config ``[k, 3]`` packs (JAX ``_objective_pack_grid_impl``):
    :func:`_objective_pack` of each config's carries with its own
    ``lam``/``alpha`` (``[k]`` tensors or sequences) against the shared
    user-side tables; rank-padded columns are zeros and add nothing."""
    lams = [float(v) for v in torch.as_tensor(lam).tolist()]
    alphas = [float(v) for v in torch.as_tensor(alpha).tolist()]
    return torch.stack([
        _objective_pack(X[z], Y[z], u_buckets, lam=lams[z], alpha=alphas[z],
                        implicit=implicit)
        for z in range(X.shape[0])])


def _objective_statics(params) -> dict:
    """The objective's hyperparameters for one config."""
    return dict(lam=float(params.lambda_), alpha=float(params.alpha),
                implicit=bool(params.implicit_prefs))


def _uniform_objective_bucket(cols, weights, mask, n_rows: int) -> tuple:
    """A uniform ``[N, L]`` table as the one-bucket case: table row ``i``
    is factor row ``i``."""
    return (torch.arange(int(n_rows), dtype=torch.int32, device=cols.device),
            cols, weights, mask)


def _train_telemetry_enabled() -> bool:
    from predictionio_tpu_torch.workflow import runlog as _runlog

    return _runlog.telemetry_enabled()


def training_objective(X, Y, user_side, params: ALSParams,
                       device: DeviceLike = None) -> dict:
    """One objective sample for a factor pair against the user-side
    tables (the side whose rows align with ``X``: a uniform
    :class:`PaddedRatings` or a :class:`BucketedRatings`):
    ``{"fit", "l2", "total", "finite"}``. Factors may be host numpy
    (placed on ``device``, None = cuda) or tensors, which stay on their
    device."""
    dev = X.device if isinstance(X, torch.Tensor) else resolve_device(device)

    def put(a):
        return torch.as_tensor(a, device=dev)

    if isinstance(user_side, BucketedRatings):
        u_t = [tuple(put(a) for a in (b.row_ids, b.cols, b.weights, b.mask))
               for b in user_side.buckets]
    else:
        u_t = [_uniform_objective_bucket(
            put(user_side.cols), put(user_side.weights),
            put(user_side.mask), np.shape(X)[0])]
    pack = _objective_pack(put(X), put(Y), u_t,
                           **_objective_statics(params)).double().cpu().numpy()
    return {"fit": float(pack[0]), "l2": float(pack[1]),
            "total": float(pack[0] + pack[1]),
            "finite": bool(pack[2] == 1.0)}


# -- checkpointed training ------------------------------------------------------

def checkpoint_layout_uniform(user_side: PaddedRatings,
                              item_side: PaddedRatings):
    """Layout half of the checkpoint fingerprint for uniform tables:
    row/col spaces, padded shapes and valid-row counts (JAX's, value
    for value)."""
    def side(s):
        return (int(s.n_rows), int(s.n_cols), int(s.max_len),
                int(s.valid_rows))

    return ("uniform", side(user_side), side(item_side))


def checkpoint_layout_bucketed(user_side: BucketedRatings,
                               item_side: BucketedRatings):
    """Layout half of the checkpoint fingerprint for bucketed sides:
    row/col spaces and every bucket's padded table shape."""
    def side(s):
        return (int(s.n_rows), int(s.n_cols),
                tuple(tuple(int(d) for d in b.cols.shape)
                      for b in s.buckets))

    return ("bucketed", side(user_side), side(item_side))


def _solver_route(dev: torch.device) -> str:
    """The fingerprint's solver field: what solves on ``dev``, the CUDA
    kernels (``"cuda"``) or their plain versions (``"plain"``). The two
    differ in the last bits, so a checkpoint of one does not resume on
    the other as if it were the same run."""
    return "cuda" if dev.type == "cuda" else "plain"


def _maybe_checkpointer(layout, params: ALSParams, solver: str,
                        precision: str):
    """The active ``TrainCheckpointer`` for this call, or None. Reads
    ``PIO_CHECKPOINT_DIR`` before importing the checkpoint module, so
    the default path costs one env lookup."""
    if not os.environ.get("PIO_CHECKPOINT_DIR", "").strip():
        return None
    from predictionio_tpu_torch.workflow import checkpoint as _checkpoint

    return _checkpoint.checkpointer_for(layout, params, solver, precision)


def _run_lane(run_iters, X, Y, params: ALSParams, ckpt, objective_buckets,
              dev: torch.device):
    """``run_iters(X, Y, n)`` over all iterations: at once without a
    checkpointer, else through ``run_chunked`` (chunks, atomic
    checkpoints, preemption, the divergence guard and, with telemetry
    on, an objective sample per chunk against ``objective_buckets``)."""
    total = int(params.num_iterations)
    if ckpt is None:
        return run_iters(X, Y, total)
    from predictionio_tpu_torch.workflow import checkpoint as _checkpoint

    fdt = X.dtype
    objective = None
    if _train_telemetry_enabled():
        obj_kw = _objective_statics(params)

        def objective(Xc, Yc):
            return _objective_pack(Xc, Yc, objective_buckets, **obj_kw)

    return _checkpoint.run_chunked(
        run_iters, X, Y, total, ckpt, to_host=_to_host,
        from_host=lambda a: torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(dev).to(fdt),
        objective=objective)


# -- trainers ---------------------------------------------------------------------

def _loop_kwargs(params: ALSParams) -> dict:
    return dict(lam=float(params.lambda_), alpha=float(params.alpha),
                implicit=bool(params.implicit_prefs),
                refine=bool(params.solve_refine))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Host fp32 numpy, whatever the factor dtype: persistence, serving
    and checkpoints see fp32 in either precision lane."""
    return t.to("cpu", torch.float32).numpy()


def train_als_bucketed(user_side: BucketedRatings, item_side: BucketedRatings,
                       params: ALSParams, device: DeviceLike = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Train on length-bucketed tables (built with
    :func:`bucket_ratings_pair`) on ``device`` (None = cuda) and return
    host fp32 numpy ``(user_factors [N, R], item_factors [M, R])``. The
    same per-row solves as :func:`train_als` on the same ratings. The
    precision policy and ``PIO_CHECKPOINT_*`` are resolved per call."""
    assert user_side.n_rows >= item_side.n_cols
    assert item_side.n_rows >= user_side.n_cols
    precision = _als_precision_mode(params)
    dev = resolve_device(device)
    ckpt = _maybe_checkpointer(
        checkpoint_layout_bucketed(user_side, item_side), params,
        _solver_route(dev), precision)
    X, Y = init_policy_factors(user_side.n_rows, item_side.n_rows,
                               params.rank, params.seed, precision, dev)

    def tables(side):
        return [(b.row_ids, b.cols, b.weights, b.mask)
                for b in side.to_device(dev).buckets]

    u_t, i_t = tables(user_side), tables(item_side)
    budget = params.bucket_slot_budget
    kw = dict(slot_budget=int(budget) if budget else None,
              **_loop_kwargs(params))

    def run_iters(Xc, Yc, n):
        return als_iterations_bucketed(Xc, Yc, u_t, i_t,
                                       num_iterations=int(n), **kw)

    X, Y = _run_lane(run_iters, X, Y, params, ckpt, u_t, dev)
    return _to_host(X), _to_host(Y)


def warmup_train_als_bucketed(user_side: BucketedRatings,
                              item_side: BucketedRatings, params,
                              device: DeviceLike = None) -> bool:
    """Make the next :func:`train_als_bucketed` call on ``device`` (None =
    cuda) start computing at once: build and load both kernel libraries
    (one ``nvcc`` per missing source, all started together) and create
    the CUDA context with each library's per-device set-up. The
    pipelined ingest runs this on a background thread while the tables'
    copies stream. The port compiles nothing per shape, so the sides
    only name the call's signature, and a config grid (``params`` with
    ``configs``, a :class:`~predictionio_tpu_torch.ops.tuning.
    ConfigGrid`) needs what one config needs: the same libraries, whose
    assembly takes the config axis. Returns True. On the CPU there is
    nothing to prepare."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from predictionio_tpu_torch.ops import _build

        _build.build_libraries(als_cuda.KERNEL_NAMES)
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        als_cuda._kernel(index)
        als_cuda._solve_kernels(index)
    return True


def train_als(user_side: PaddedRatings, item_side: PaddedRatings,
              params: ALSParams, device: DeviceLike = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Train on uniform tables (``user_side`` padded by user, its cols
    item indices; ``item_side`` by item) on ``device`` (None = cuda) and
    return host fp32 numpy ``(user_factors [N, R], item_factors [M,
    R])``. With ``solve_block_rows`` set, rows pad to a block multiple;
    the pad rows' init is zeroed before the first Gram term and the
    result is cut back to the true rows. The precision policy and
    ``PIO_CHECKPOINT_*`` are resolved per call."""
    assert user_side.n_rows >= item_side.n_cols
    assert item_side.n_rows >= user_side.n_cols
    precision = _als_precision_mode(params)
    block = params.solve_block_rows
    if block:
        user_side = pad_rows_to_block(user_side, block)
        item_side = pad_rows_to_block(item_side, block)
    dev = resolve_device(device)
    ckpt = _maybe_checkpointer(
        checkpoint_layout_uniform(user_side, item_side), params,
        _solver_route(dev), precision)
    n_u, n_i = user_side.valid_rows, item_side.valid_rows
    X, Y = init_policy_factors(user_side.n_rows, item_side.n_rows,
                               params.rank, params.seed, precision, dev)
    # the init filled the pad rows too: zero them, or the first Gram
    # term (Y^T Y over all rows) would see phantom factors
    X[n_u:] = 0.0
    Y[n_i:] = 0.0

    def put(a):
        return torch.as_tensor(a, device=dev)

    u_cols, u_w, u_m = (put(a) for a in (user_side.cols, user_side.weights,
                                         user_side.mask))
    i_tables = [put(a) for a in (item_side.cols, item_side.weights,
                                 item_side.mask)]
    kw = dict(block=int(block) if block else None, **_loop_kwargs(params))

    def run_iters(Xc, Yc, n):
        return als_iterations(Xc, Yc, u_cols, u_w, u_m, *i_tables,
                              num_iterations=int(n), **kw)

    X, Y = _run_lane(run_iters, X, Y, params, ckpt,
                     [_uniform_objective_bucket(u_cols, u_w, u_m,
                                                user_side.n_rows)], dev)
    return _to_host(X)[:n_u], _to_host(Y)[:n_i]


# -- online fold-in ---------------------------------------------------------------

def pad_fold_in_batch(cols_list: Sequence[np.ndarray],
                      vals_list: Sequence[np.ndarray],
                      row_bucket: int = 8, len_bucket: int = 8,
                      max_len: Optional[int] = None):
    """Pad k ragged per-user rating sets into one ``[B, L]`` solve table
    (the JAX package's ``pad_fold_in_batch``, byte for byte).

    Both dimensions round up the power-of-two ladder (``B`` from
    ``row_bucket``, ``L`` from ``len_bucket``), so a long-lived server's
    folds see a handful of shapes. Duplicate (user, item) pairs are
    summed first, as training sums them (:func:`dedup_sum_ratings`).
    ``max_len`` applies training's per-row truncation at its EFFECTIVE
    cap, ``max_len`` rounded up to ``PAD_MULTIPLE``: the
    largest-magnitude ratings are kept, in a stable order; a fold that
    cut at the raw ``max_len`` would solve a smaller problem than
    training did for rows in the rounding gap. Padding rows and slots
    carry a zero mask, so they solve to zero rows and slice off."""
    # lazy: serving does not import this module, and stays that way
    from predictionio_tpu_torch.ops.serving import bucket_size

    k = len(cols_list)
    cap = None if max_len is None else max(
        1, -(-int(max_len) // PAD_MULTIPLE) * PAD_MULTIPLE)
    deduped = []
    longest = 1
    for c, v in zip(cols_list, vals_list):
        c = np.asarray(c, dtype=np.int64)
        v = np.asarray(v, dtype=np.float32)
        if len(c):
            order = np.argsort(c, kind="stable")
            _, cc, vv = dedup_sum_sorted(c[order], c[order], c[order],
                                         v[order])
            if cap is not None and len(cc) > cap:
                sel = np.argsort(-np.abs(vv), kind="stable")[:cap]
                cc, vv = cc[sel], vv[sel]
            deduped.append((cc, vv))
            longest = max(longest, len(cc))
        else:
            deduped.append((c, v))
    B = bucket_size(max(k, 1), row_bucket)
    L = bucket_size(longest, len_bucket)
    cols = np.zeros((B, L), dtype=np.int32)
    weights = np.zeros((B, L), dtype=np.float32)
    mask = np.zeros((B, L), dtype=np.float32)
    for i, (c, v) in enumerate(deduped):
        m = len(c)
        cols[i, :m] = c
        weights[i, :m] = v
        mask[i, :m] = 1.0
    return cols, weights, mask


def fold_in_users(item_factors, cols_list: Sequence[np.ndarray],
                  vals_list: Sequence[np.ndarray], params: ALSParams,
                  max_len: Optional[int] = None,
                  device: DeviceLike = None) -> np.ndarray:
    """Solve ``k`` user rows against FIXED item factors: one training
    half-step (:func:`_solve_rows`, so on the card the assembly kernel
    then the solve kernel) over the users' padded rating sets.

    ``cols_list[i]`` / ``vals_list[i]`` are user ``i``'s FULL rating set
    (item indices and values; duplicates are summed here). Returns the
    ``[k, R]`` fp32 rows, on the host. ``item_factors`` is a host array
    (placed on ``device``, None = cuda) or a tensor, which stays on its
    device. The precision policy is training's (``ALSParams.precision`` /
    ``PIO_ALS_PRECISION``, resolved per call): item factors of another
    dtype are cast through fp32 to the policy's factor dtype, so under
    ``bf16`` the fold is the bf16 half-step (B3's bf16 route), and a
    bf16 store folds under ``fp32`` as an fp32 one would. ``params``
    gives ``lambda_``, ``alpha``, ``implicit_prefs`` and
    ``solve_refine``.

    Each call is one flight-recorder dispatch (lane ``"foldin"``,
    ``kBucket`` the padded history length L, ``bucket`` the padded user
    batch B) and a ``device.execute`` span under the ambient span; on
    the card its device time is the sum of the CUDA-event windows that
    each kernel launch records around its kernels, read once the rows
    are on the host. On the card the half-step runs on a stream of its
    own (it waits for the caller's stream first), so no query kernel
    that another thread enqueues meanwhile falls inside a window."""
    precision = _als_precision_mode(params)
    if isinstance(item_factors, torch.Tensor):
        Y = item_factors
    else:
        Y = torch.from_numpy(np.ascontiguousarray(item_factors)).to(
            resolve_device(device))
    want = factor_dtype(precision)
    if Y.dtype != want:
        Y = Y.float().to(want)
    Y = Y.contiguous()
    k = len(cols_list)
    if k == 0:
        return np.zeros((0, Y.shape[1]), dtype=np.float32)
    cols, weights, mask = pad_fold_in_batch(cols_list, vals_list,
                                            max_len=max_len)
    dev = Y.device
    ct, wt, mt = (torch.from_numpy(a).to(dev) for a in (cols, weights, mask))

    def solve(events: Optional[list] = None) -> torch.Tensor:
        return _solve_rows(Y, ct, wt, mt, float(params.lambda_),
                           float(params.alpha), bool(params.implicit_prefs),
                           refine=bool(params.solve_refine), events=events)

    on_card = dev.type == "cuda"
    events = [] if on_card and _dtel.enabled() else None
    t0 = _tracing.span_now()
    if on_card:
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the copy to the host waits for the side stream, so Y and the
            # tables are no longer in use when this returns
            out = _to_host(solve(events)[:k])
    else:
        out = _to_host(solve(events)[:k])
    t1 = _tracing.span_now()
    if not _dtel.enabled():
        return out
    rec = _dtel.record_dispatch(
        lane="foldin", kernel="als_solve" if events is not None else "plain",
        precision=precision, aot="jit", k_bucket=int(cols.shape[1]), batch=k,
        bucket=int(cols.shape[0]), host_us=(t1 - t0) * 1e6,
        device_us=None if events is None
        else sum(e0.elapsed_time(e1) for e0, e1 in events) * 1e3,
        started_epoch=t0)
    attributes = dict(rec or {})
    if events is None:
        attributes["deviceTiming"] = (
            "none: no CUDA events on the CPU (the kernels' plain versions)")
    _tracing.record_completed_span("device.execute", start=t0, end=t1,
                                   attributes=attributes)
    return out
