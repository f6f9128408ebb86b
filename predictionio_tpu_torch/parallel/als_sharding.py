"""Sharded ALS training over a device mesh, the trainer the templates
call, and the item layout of a sharded store.

The port's copy of ``predictionio_tpu/parallel/als_sharding.py``. The
layouts (``ItemShardLayout``, ``contiguous_item_layout``,
``density_aware_item_layout``) are numpy, byte-equal to the JAX
package's for the same counts.

The trainers (``train_als_sharded``, ``train_als_sharded_2d``,
``train_als_bucketed_sharded``, ``train_als_device``,
``sharded_train_step``, and ``train_als_auto``, which picks one) lay the
rating tables out row-sharded over a :class:`~predictionio_tpu_torch.
parallel.mesh.Mesh` and write out the steps GSPMD inserts in the JAX
package:

- Every device of the mesh holds an equal contiguous row block of each
  rating table (of each bucket), over all of the mesh's axes, data-major.
  On a 1-D mesh that is the JAX package's ``P("data", None)``; on a 2-D
  mesh JAX replicates the block of a ``data`` row over its ``model``
  devices, and here each of them holds and solves its own part, so no
  row is solved twice.
- Each device solves its rows with ``_solve_rows`` (the B3 and B2
  kernels of :mod:`~predictionio_tpu_torch.ops.als_cuda`, one launch
  each per device and per bucket that holds a real row) against its
  whole copy of the fixed side, whose fp32 Gram matrix it computes over
  the side's true rows.
- The factor tables follow ``factor_spec``: replicated (every device a
  whole copy) or ``P("model", None)`` (each ``model`` position its row
  span; the fixed side is gathered whole onto each device for the
  half-step and then dropped). The new rows reach their devices by
  device copies: the blocks of a uniform side joined in row order (an
  all-gather), the disjoint scatters of a bucketed side summed (JAX's
  psum; shards of one device scatter into one buffer).
- With a ``torch.distributed`` process group, the tables' rows split
  over the processes first (:func:`~predictionio_tpu_torch.parallel.
  distributed.process_row_block`), and the new rows merge through the
  group: an all-gather of equal blocks (uniform) or an
  ``all_reduce(SUM)`` of the disjoint scatters (bucketed), whatever the
  world size. Every process ends with the whole factor tables.

Each row's sums and solve depend on that row alone, and the merges add
only zeros, so sharded training gives the single-device trainers'
factors from the same init.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import als as _als
from predictionio_tpu_torch.ops.als import (
    ALSParams,
    BucketedRatings,
    PaddedRatings,
    RatingsBucket,
    train_als,
    train_als_bucketed,
)
from predictionio_tpu_torch.parallel import distributed
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    ShardedTensor,
    data_parallel_mesh,
    default_devices,
    row_part,
    spec_axes,
)

logger = logging.getLogger("pio.torch.als_sharding")


# ---------------------------------------------------------------------------
# Density-aware item sharding (the layout a sharded serving store uses)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ItemShardLayout:
    """How the item axis of a sharded factor store is laid out.

    ``perm[pos] -> item id`` (or -1 for an empty pad slot) over
    ``n_shards * cap`` contiguous positions: shard ``s`` owns positions
    ``[s*cap, (s+1)*cap)``; ``inv[item] -> pos`` is its inverse. Serving
    permutes the item factor rows into it, fold-in reads the item store
    back through it, and top-k results translate back to item ids on the
    host."""

    perm: np.ndarray            # int64 [n_shards * cap], -1 = pad slot
    inv: np.ndarray             # int64 [n_items], item id -> position
    n_shards: int
    n_items: int
    counts_per_shard: np.ndarray  # int64 [n_shards] interaction mass

    @property
    def n_positions(self) -> int:
        return int(self.perm.shape[0])

    @property
    def cap(self) -> int:
        return self.n_positions // self.n_shards

    @property
    def items_per_shard(self) -> np.ndarray:
        """Real items each shard holds (pad slots excluded)."""
        return (self.perm.reshape(self.n_shards, self.cap)
                >= 0).sum(axis=1)

    def valid_mask(self) -> np.ndarray:
        """float32 [n_positions]: 1.0 where the position holds a real
        item, the validity row each shard's top-k masks by."""
        return (self.perm >= 0).astype(np.float32)

    def balance_report(self) -> Dict[str, Any]:
        """Interaction-mass balance across the shards."""
        c = self.counts_per_shard.astype(np.float64)
        mean = float(c.mean()) if len(c) else 0.0
        return {
            "nShards": int(self.n_shards),
            "itemsPerShard": [int(v) for v in self.items_per_shard],
            "interactionsPerShard": [int(v) for v in
                                     self.counts_per_shard],
            "maxOverMeanInteractions": round(
                float(c.max()) / mean, 4) if mean > 0 else None,
        }

    def to_json(self) -> Dict[str, Any]:
        return {"perm": self.perm.tolist(), "nShards": int(self.n_shards),
                "nItems": int(self.n_items),
                "countsPerShard": self.counts_per_shard.tolist()}

    @classmethod
    def from_json(cls, blob: Dict[str, Any]) -> "ItemShardLayout":
        perm = np.asarray(blob["perm"], dtype=np.int64)
        n_items = int(blob["nItems"])
        inv = np.full(n_items, -1, dtype=np.int64)
        real = perm >= 0
        inv[perm[real]] = np.flatnonzero(real)
        return cls(perm, inv, int(blob["nShards"]), n_items,
                   np.asarray(blob["countsPerShard"], dtype=np.int64))


def _layout_from_assignment(shards, counts: np.ndarray, n_shards: int,
                            cap: int) -> ItemShardLayout:
    n_items = int(len(counts))
    perm = np.full(n_shards * cap, -1, dtype=np.int64)
    mass = np.zeros(n_shards, dtype=np.int64)
    for s, items in enumerate(shards):
        items = np.sort(np.asarray(items, dtype=np.int64))
        perm[s * cap:s * cap + len(items)] = items
        mass[s] = int(counts[items].sum()) if len(items) else 0
    inv = np.full(n_items, -1, dtype=np.int64)
    real = perm >= 0
    inv[perm[real]] = np.flatnonzero(real)
    return ItemShardLayout(perm, inv, n_shards, n_items, mass)


def contiguous_item_layout(n_items: int, n_shards: int,
                           counts: Optional[np.ndarray] = None,
                           cap_multiple: int = 8) -> ItemShardLayout:
    """The span layout (items ``[s*cap, (s+1)*cap)`` on shard ``s``): the
    balance baseline, and the layout of a store without counts."""
    n_shards = max(1, int(n_shards))
    cap = -(-max(int(n_items), 1) // n_shards)
    cap = -(-cap // cap_multiple) * cap_multiple
    if counts is None:
        counts = np.zeros(n_items, dtype=np.int64)
    ids = np.arange(n_items, dtype=np.int64)
    shards = [ids[s * cap:(s + 1) * cap] for s in range(n_shards)]
    return _layout_from_assignment(shards, np.asarray(counts), n_shards,
                                   cap)


def density_aware_item_layout(counts, n_shards: int,
                              cap_multiple: int = 8) -> ItemShardLayout:
    """Assign items to shards by interaction count: a greedy bin-pack
    (the heaviest item first, onto the lightest shard with room), so the
    power-law head spreads over the shards. Every shard holds at most
    ``cap`` items; within a shard items sit in ascending id order."""
    counts = np.asarray(counts, dtype=np.int64)
    n_items = int(counts.shape[0])
    n_shards = max(1, int(n_shards))
    cap = -(-max(n_items, 1) // n_shards)
    cap = -(-cap // cap_multiple) * cap_multiple
    # heaviest first; ties broken by item id
    order = np.lexsort((np.arange(n_items), -counts))
    heap = [(0, s) for s in range(n_shards)]  # (mass, shard)
    heapq.heapify(heap)
    shards = [[] for _ in range(n_shards)]
    for item in order:
        while True:
            mass, s = heapq.heappop(heap)
            if len(shards[s]) < cap:
                break
            # a full shard leaves the heap for good (the capacity covers
            # every item, so the heap never empties early)
        shards[s].append(int(item))
        heapq.heappush(heap, (mass + int(counts[item]), s))
    return _layout_from_assignment(shards, counts, n_shards, cap)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _multihost_checkpointer(layout, params: ALSParams, solver: str,
                            precision: str, multi_host: bool):
    """The crash-safe checkpointer of a sharded trainer, or None. A run
    of one process checkpoints between chunks as the single-device
    trainers do; a run across several processes writes no checkpoint,
    and says so when ``PIO_CHECKPOINT_DIR`` asks for them."""
    if not multi_host:
        return _als._maybe_checkpointer(layout, params, solver, precision)
    if os.environ.get("PIO_CHECKPOINT_DIR", "").strip():
        logger.warning(
            "checkpointing (PIO_CHECKPOINT_DIR) is not supported across "
            "several processes yet: this training runs as ONE "
            "uninterruptible loop and writes NO checkpoints; --resume "
            "will find nothing from this run")
    return None


def _pad_rows_to(arr, n: int):
    """Pad the leading dim to ``n`` rows with zeros (no-op ratings, or
    factor rows no real row scatters into); numpy or a tensor."""
    if arr.shape[0] == n:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros((n - arr.shape[0],)
                                             + tuple(arr.shape[1:]))])
    pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _pad_bucket_rows(b: RatingsBucket, multiple: int,
                     sentinel: int) -> RatingsBucket:
    """Pad a bucket's row count to ``multiple`` with sentinel-id empty
    rows (dropped by the scatter) so the table shards evenly; numpy
    tables or tensors."""
    B = int(b.cols.shape[0])
    pad = (-B) % multiple
    if pad == 0:
        return b
    if isinstance(b.row_ids, torch.Tensor):
        rid = torch.cat([b.row_ids, b.row_ids.new_full((pad,), sentinel)])
    else:
        rid = np.concatenate([np.asarray(b.row_ids),
                              np.full(pad, sentinel, dtype=np.int32)])
    return RatingsBucket(rid, *(_pad_rows_to(a, B + pad)
                                for a in (b.cols, b.weights, b.mask)))


def _table_spec(mesh: Mesh):
    """Rating-table rows over every axis of the mesh, data-major."""
    return P(tuple(mesh.axis_names), None)


def _factor_divisor(mesh: Mesh, factor_spec) -> int:
    n = 1
    for name in spec_axes(factor_spec[0]):
        n *= mesh.shape[name]
    return n


def _process_block(a, n_rows: int):
    """This process's rows of an array of ``n_rows`` (all of them
    without a process group of several)."""
    if distributed.process_count() <= 1:
        return a
    start, stop = distributed.process_row_block(n_rows)
    return a[start:stop]


def _rows_on(t: torch.Tensor, lo: int, hi: int,
             dev: torch.device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``t`` on ``dev``, in memory of their own (a
    slice on its own device is copied, so a block never keeps a whole
    table alive)."""
    part = t[lo:hi]
    here = part.device.type == dev.type and dev.index in (
        None, part.device.index)
    if not here:
        return part.to(dev)
    return part if (lo, hi) == (0, t.shape[0]) else part.clone()


def _place(sources, mesh: Mesh, spec, n_rows: int) -> ShardedTensor:
    """The factor table ``[n_rows, R]`` laid out by ``spec``, from
    ``sources``: ``(start, stop, tensor)`` row blocks that cover it
    (spec splits that do not cross the processes)."""
    blocks, placed = [], {}
    for k, dev in enumerate(mesh.device_list()):
        part, n_parts = row_part(mesh, spec, k)
        rows = n_rows // n_parts
        a, b = part * rows, (part + 1) * rows
        key = (dev, a)
        if key not in placed:
            pieces = [_rows_on(t, max(a, s0) - s0, min(b, s1) - s0, dev)
                      for s0, s1, t in sources if s0 < b and s1 > a]
            placed[key] = pieces[0] if len(pieces) == 1 \
                else torch.cat(pieces)
        blocks.append(placed[key])
    t0 = sources[0][2]
    return ShardedTensor(blocks, mesh, spec, (n_rows,) + tuple(t0.shape[1:]))


def _place_factor(a: torch.Tensor, mesh: Mesh, spec,
                  n_rows: int) -> ShardedTensor:
    """Host factors padded to ``n_rows`` rows and laid out by ``spec``
    (every process holds the whole table)."""
    return _place([(0, n_rows, _pad_rows_to(a, n_rows))], mesh, spec,
                  n_rows)


class _Solver:
    """One half-step's work over a mesh: each device's rows solved
    against its whole copy of the fixed side, the new rows merged and
    laid out by ``factor_spec``. ``kw`` are ``_solve_rows``' ``lam``,
    ``alpha``, ``implicit`` and ``refine``."""

    def __init__(self, mesh: Mesh, factor_spec, kw: dict,
                 slot_budget: Optional[int] = None):
        self.mesh = mesh
        self.devices = mesh.device_list()
        self.factor_spec = factor_spec
        self.kw = kw
        self.slot_budget = slot_budget
        self.multi = distributed.group_initialized()

    def _fixed(self, F: ShardedTensor, n_fixed: int):
        """Per device, the whole fixed side (its replica, or its model
        group's spans gathered) and its Gram matrix over the true rows;
        once a distinct device."""
        whole, grams = {}, {}
        for k, dev in enumerate(self.devices):
            if dev not in whole:
                whole[dev] = F.gathered(k)
                grams[dev] = _als._gram(whole[dev][:n_fixed]) \
                    if self.kw["implicit"] else None
        return whole, grams

    def uniform(self, F: ShardedTensor, n_fixed: int, tables,
                n_real: int, n_out: int) -> ShardedTensor:
        """A uniform side: device ``k`` solves its table block (a block
        of padding rows only is zeros, with no launch); the blocks join
        in row order."""
        cols, w, m = tables
        whole, grams = self._fixed(F, n_fixed)
        new = []
        for k, dev in enumerate(self.devices):
            a, b = cols.span(k)
            g0 = cols.row_offset + a
            if g0 >= n_real:
                Xk = torch.zeros((b - a, F.shape[1]), dtype=F.dtype,
                                 device=dev)
            else:
                Xk = _als._solve_rows(whole[dev], cols.blocks[k],
                                      w.blocks[k], m.blocks[k],
                                      gram=grams[dev], **self.kw)
            new.append((g0, g0 + b - a, Xk))
        if self.multi:
            # this process's rows, then every process's (equal blocks)
            home = self.devices[0]
            local = {s0: t for s0, _, t in new}
            joined = torch.cat([local[s].to(home) for s in sorted(local)])
            new = [(0, n_out, distributed.all_gather_rows(joined))]
        return _place(new, self.mesh, self.factor_spec, n_out)

    def bucketed(self, F: ShardedTensor, n_fixed: int, buckets,
                 n_rows: int, n_out: int) -> ShardedTensor:
        """A bucketed side: device ``k`` solves each bucket block that
        holds a real row and scatters it by row id into its device's
        buffer (one spare row takes the sentinel writes); the buffers of
        the devices, and then of the processes, are summed."""
        whole, grams = self._fixed(F, n_fixed)
        bufs: Dict[torch.device, torch.Tensor] = {}
        n_buf = max(n_out, n_rows + 1)
        for k, dev in enumerate(self.devices):
            if dev not in bufs:
                bufs[dev] = torch.zeros((n_buf, F.shape[1]), dtype=F.dtype,
                                        device=dev)
            for ids, cols, w, m, live in buckets:
                if not live[k]:
                    continue
                bufs[dev][ids.blocks[k]] = _als._solve_bucket(
                    whole[dev], cols.blocks[k], w.blocks[k], m.blocks[k],
                    gram=grams[dev], slot_budget=self.slot_budget,
                    **self.kw)
        devs = list(bufs)
        total = bufs[devs[0]]
        for dev in devs[1:]:
            total = total + bufs[dev].to(devs[0])
        if self.multi:
            distributed.all_reduce_sum(total)
        return _place([(0, n_out, total[:n_out])], self.mesh,
                      self.factor_spec, n_out)


def _solve_kwargs(params: ALSParams) -> dict:
    return dict(lam=float(params.lambda_), alpha=float(params.alpha),
                implicit=bool(params.implicit_prefs),
                refine=bool(params.solve_refine))


def _uniform_tables(side: PaddedRatings, mesh: Mesh, n_pad: int):
    """``(cols, weights, mask)`` of a uniform side padded with zero rows
    to ``n_pad``, this process's rows placed by the table spec."""
    spec = _table_spec(mesh)
    return [distributed.make_global_array(
        mesh, spec, _process_block(_pad_rows_to(a, n_pad), n_pad))
        for a in (side.cols, side.weights, side.mask)]


def _host_ids(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).astype(np.int64)


def _bucket_tables(side: BucketedRatings, mesh: Mesh) -> List[tuple]:
    """Per bucket ``(row_ids [long], cols, weights, mask, live)``: the
    bucket padded with sentinel rows to a multiple of ``8 * n_data`` (and
    of the mesh's device count), this process's rows placed by the
    table spec, and per device whether its block holds a real row (its
    launches: none for a block of sentinels)."""
    count = distributed.process_count()
    n_data = count * mesh.shape.get("data", 1)
    multiple = math.lcm(8 * n_data, count * mesh.size)
    spec = _table_spec(mesh)
    out = []
    for b in side.buckets:
        b = _pad_bucket_rows(b, multiple, side.n_rows)
        real = _host_ids(b.row_ids) < side.n_rows
        B = int(real.shape[0])
        ids, cols, w, m = (distributed.make_global_array(
            mesh, spec, _process_block(a, B))
            for a in (b.row_ids, b.cols, b.weights, b.mask))
        live = []
        for k in range(mesh.size):
            a, stop = cols.span(k)
            live.append(bool(real[cols.row_offset + a:
                                  cols.row_offset + stop].any()))
        ids.blocks = [t.long() for t in ids.blocks]
        out.append((ids, cols, w, m, live))
    return out


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------


def _finish(X: ShardedTensor, Y: ShardedTensor, n_u: int, n_i: int,
            gather: bool):
    """``gather``: host fp32 numpy cut to the true rows (every process's
    rows joined first); else the padded tables on the mesh."""
    if not gather:
        return X, Y
    return (_als._to_host(distributed.process_allgather(X))[:n_u],
            _als._to_host(distributed.process_allgather(Y))[:n_i])


def _run(run_iters, X: ShardedTensor, Y: ShardedTensor, params: ALSParams,
         ckpt, objective_tables, mesh: Mesh, factor_spec):
    """All iterations at once, or through the chunked lane (checkpoints
    of the whole tables as host fp32, scattered back on resume)."""
    total = int(params.num_iterations)
    if ckpt is None:
        return run_iters(X, Y, total)
    from predictionio_tpu_torch.workflow import checkpoint as _checkpoint

    fdt = X.dtype
    objective = None
    if _als._train_telemetry_enabled():
        obj_kw = _als._objective_statics(params)
        # the user side's blocks as buckets, on the first device
        home = mesh.device_list()[0]
        u_obj = [tuple(a.to(home) for a in t) for t in objective_tables]

        def objective(Xc, Yc):
            return _als._objective_pack(
                distributed.process_allgather(Xc),
                distributed.process_allgather(Yc), u_obj, **obj_kw)

    def from_host(a):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return _place_factor(t.to(fdt), mesh, factor_spec, int(t.shape[0]))

    return _checkpoint.run_chunked(
        run_iters, X, Y, total, ckpt,
        to_host=lambda a: _als._to_host(distributed.process_allgather(a)),
        from_host=from_host, objective=objective)


def _train_sharded(user_side: PaddedRatings, item_side: PaddedRatings,
                   params: ALSParams, mesh: Mesh, row_divisor: int,
                   factor_spec, gather: bool = True):
    """The uniform body: pad rows to ``row_divisor`` times the process
    count (tables with empty rows, factors with zero rows), place the
    tables over the mesh and the factors by ``factor_spec``, run every
    iteration, then cut the padding off (``gather``) or keep the padded
    tables on the mesh."""
    if not isinstance(user_side, PaddedRatings):
        raise TypeError(
            "this ALS flavor trains uniform PaddedRatings tables; for "
            "length-bucketed sides use train_als_bucketed_sharded (or "
            "the default ALSAlgorithm via train_als_auto), or set "
            "bucketed=False on the preparator")
    precision = _als._als_precision_mode(params)
    divisor = row_divisor * distributed.process_count()
    n_u = -(-user_side.n_rows // divisor) * divisor
    n_i = -(-item_side.n_rows // divisor) * divisor
    X0, Y0 = _als.init_policy_factors(user_side.n_rows, item_side.n_rows,
                                      params.rank, params.seed, precision,
                                      "cpu")
    X = _place_factor(X0, mesh, factor_spec, n_u)
    Y = _place_factor(Y0, mesh, factor_spec, n_i)
    u_t = _uniform_tables(user_side, mesh, n_u)
    i_t = _uniform_tables(item_side, mesh, n_i)
    solver = _Solver(mesh, factor_spec, _solve_kwargs(params))

    def run_iters(Xc, Yc, n):
        for _ in range(int(n)):
            Xc = solver.uniform(Yc, item_side.n_rows, u_t,
                                user_side.n_rows, n_u)
            Yc = solver.uniform(Xc, user_side.n_rows, i_t,
                                item_side.n_rows, n_i)
        return Xc, Yc

    ckpt = _multihost_checkpointer(
        _als.checkpoint_layout_uniform(user_side, item_side), params,
        _als._solver_route(mesh.device_list()[0]), precision,
        distributed.process_count() > 1)
    u_obj = []
    if ckpt is not None:
        # each block as a bucket whose row ids are its rows
        cols, w, m = u_t
        u_obj = [(torch.arange(*cols.span(k), dtype=torch.int32),
                  cols.blocks[k], w.blocks[k], m.blocks[k])
                 for k in range(mesh.size)]
    X, Y = _run(run_iters, X, Y, params, ckpt, u_obj, mesh, factor_spec)
    return _finish(X, Y, user_side.n_rows, item_side.n_rows, gather)


def train_als_sharded(user_side: PaddedRatings, item_side: PaddedRatings,
                      params: ALSParams, mesh: Mesh
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Train with the rating tables row-sharded over ``mesh`` and the
    factor tables replicated (every device a whole copy); host fp32
    numpy ``(X [N, R], Y [M, R])``. The single-device trainers' numerics
    (same init, same solves)."""
    return _train_sharded(user_side, item_side, params, mesh,
                          row_divisor=mesh.size,
                          factor_spec=P(None, None))


def train_als_sharded_2d(user_side: PaddedRatings, item_side: PaddedRatings,
                         params: ALSParams, mesh: Mesh
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """2-D (data x model) training: the factor tables row-sharded over
    ``model``, so each device holds ``rows / model`` of each (rows pad
    to a multiple of ``data * model``); each half-step gathers the fixed
    side whole onto every device for its solves and drops it after.
    Numerics as :func:`train_als_sharded`."""
    return _train_sharded(user_side, item_side, params, mesh,
                          row_divisor=mesh.shape["data"]
                          * mesh.shape["model"],
                          factor_spec=P("model", None))


def train_als_bucketed_sharded(user_side: BucketedRatings,
                               item_side: BucketedRatings,
                               params: ALSParams, mesh: Mesh,
                               factor_spec=None, gather: bool = True):
    """Length-bucketed training over a mesh: every bucket row-sharded
    (its rows padded with sentinel ids to a multiple of ``8 * n_data``),
    the factor tables replicated, or laid out by ``factor_spec`` (e.g.
    ``P("model", None)``: rows pad to the axis product). ``gather=False``
    returns the padded tables on the mesh (the PAlgorithm flavor);
    else host fp32 numpy. ``bucket_slot_budget`` splits each device's
    bucket block as the single-device trainer splits a bucket."""
    factor_spec = factor_spec or P(None, None)
    precision = _als._als_precision_mode(params)
    divisor = _factor_divisor(mesh, factor_spec)
    n_u = -(-user_side.n_rows // divisor) * divisor
    n_i = -(-item_side.n_rows // divisor) * divisor
    X0, Y0 = _als.init_policy_factors(user_side.n_rows, item_side.n_rows,
                                      params.rank, params.seed, precision,
                                      "cpu")
    # pad rows are ZEROS (a random pad row would join the Gram term);
    # no real bucket row scatters into them
    X = _place_factor(X0, mesh, factor_spec, n_u)
    Y = _place_factor(Y0, mesh, factor_spec, n_i)
    u_t, i_t = _bucket_tables(user_side, mesh), _bucket_tables(item_side,
                                                               mesh)
    budget = params.bucket_slot_budget
    solver = _Solver(mesh, factor_spec, _solve_kwargs(params),
                     int(budget) if budget else None)

    def run_iters(Xc, Yc, n):
        for _ in range(int(n)):
            Xc = solver.bucketed(Yc, item_side.n_rows, u_t,
                                 user_side.n_rows, n_u)
            Yc = solver.bucketed(Xc, user_side.n_rows, i_t,
                                 item_side.n_rows, n_i)
        return Xc, Yc

    ckpt = _multihost_checkpointer(
        _als.checkpoint_layout_bucketed(user_side, item_side), params,
        _als._solver_route(mesh.device_list()[0]), precision,
        distributed.process_count() > 1)
    u_obj = [(ids.blocks[k], cols.blocks[k], w.blocks[k], m.blocks[k])
             for ids, cols, w, m, _ in u_t for k in range(mesh.size)] \
        if ckpt is not None else []
    X, Y = _run(run_iters, X, Y, params, ckpt, u_obj, mesh, factor_spec)
    return _finish(X, Y, user_side.n_rows, item_side.n_rows, gather)


def train_als_device(user_side, item_side, params: ALSParams,
                     mesh: Optional[Mesh] = None):
    """Train and KEEP the factors on the mesh (the PAlgorithm flavor:
    nothing lands on the host). Uniform or bucketed sides. Returns
    ``(X, Y)`` :class:`~predictionio_tpu_torch.parallel.mesh.
    ShardedTensor` s padded to the mesh's divisor: row-sharded over
    ``model`` on a 2-D mesh, else replicated. Serve them with
    :class:`~predictionio_tpu_torch.ops.serving.DeviceTopK` and the true
    ``n_users``/``n_items`` bounds. ``mesh=None`` lays every visible card
    out with ``host_aware_mesh``, a ``model`` axis of 2 when their count
    is even and at least 4."""
    if mesh is None:
        n = len(default_devices())
        mesh = distributed.host_aware_mesh(
            model=2 if (n % 2 == 0 and n >= 4) else 1)
    if "model" in mesh.axis_names:
        divisor = mesh.shape["data"] * mesh.shape["model"]
        spec = P("model", None)
    else:
        divisor = mesh.size
        spec = P(None, None)
    if isinstance(user_side, BucketedRatings):
        return train_als_bucketed_sharded(user_side, item_side, params,
                                          mesh, factor_spec=spec,
                                          gather=False)
    return _train_sharded(user_side, item_side, params, mesh,
                          row_divisor=divisor, factor_spec=spec,
                          gather=False)


def _plane(device) -> Optional[List[torch.device]]:
    """The devices a mesh or a sequence names, else None."""
    if isinstance(device, Mesh):
        return device.device_list()
    if isinstance(device, (list, tuple)):
        return [resolve_device(d) for d in device]
    return None


def train_als_auto(user_side, item_side, params: ALSParams,
                   device: Union[DeviceLike, Sequence[DeviceLike], Mesh]
                   = None) -> Tuple[np.ndarray, np.ndarray]:
    """The trainer the templates call, on uniform :class:`~predictionio_
    tpu_torch.ops.als.PaddedRatings` or length-bucketed
    :class:`~predictionio_tpu_torch.ops.als.BucketedRatings` sides (the
    preparator's choice); host fp32 numpy ``(X, Y)``.

    - A process group (``pio train --num-hosts K``): ``host_aware_mesh``
      over this process's devices (``device``, None = every visible
      card), all processes training one collective run.
    - A plane of several devices (a sequence or a mesh, or None with
      more than one card visible): ``data_parallel_mesh`` over it.
    - One device (None = cuda): ``train_als`` / ``train_als_bucketed``.

    The three give the same factors from the same init. The precision
    policy and ``PIO_CHECKPOINT_*`` are resolved per call."""
    bucketed = isinstance(user_side, BucketedRatings)
    devs = _plane(device)
    mesh = None
    if distributed.group_initialized():
        mesh = distributed.host_aware_mesh(
            devices=devs or ([resolve_device(device)]
                             if device is not None else None))
    else:
        if devs is None and device is None:
            devs = default_devices()
        if devs is not None and len(devs) > 1:
            mesh = data_parallel_mesh(devices=devs)
    if mesh is not None:
        if bucketed:
            return train_als_bucketed_sharded(user_side, item_side, params,
                                              mesh)
        return train_als_sharded(user_side, item_side, params, mesh)
    if devs:
        device = devs[0]
    if bucketed:
        return train_als_bucketed(user_side, item_side, params, device)
    return train_als(user_side, item_side, params, device)


def sharded_train_step(mesh: Mesh, rank: int,
                       params: Optional[ALSParams] = None):
    """``(step, specs)`` for ONE alternating iteration over ``mesh``, the
    unit a multi-device dry run executes: ``step(X, Y, u_cols, u_w, u_m,
    i_cols, i_w, i_m)`` takes host arrays (rows a multiple of the mesh's
    device count), places the tables by ``specs["rows"]`` and the
    factors (in the precision policy's dtype) by ``specs["factors"]``
    (replicated), and returns the new ``(X, Y)`` ShardedTensors."""
    params = params or ALSParams(rank=rank, num_iterations=1)
    rows, factors = _table_spec(mesh), P(None, None)

    def run(X, Y, u_cols, u_w, u_m, i_cols, i_w, i_m):
        fdt = _als.factor_dtype(_als._als_precision_mode(params))
        Xs, Ys = (_place_factor(torch.as_tensor(np.asarray(a)).to(fdt),
                                mesh, factors, int(np.shape(a)[0]))
                  for a in (X, Y))
        u_t = [distributed.make_global_array(mesh, rows, a)
               for a in (u_cols, u_w, u_m)]
        i_t = [distributed.make_global_array(mesh, rows, a)
               for a in (i_cols, i_w, i_m)]
        solver = _Solver(mesh, factors, _solve_kwargs(params))
        n_u, n_i = Xs.shape[0], Ys.shape[0]
        Xs = solver.uniform(Ys, n_i, u_t, n_u, n_u)
        Ys = solver.uniform(Xs, n_u, i_t, n_i, n_i)
        return Xs, Ys

    return run, {"rows": rows, "factors": factors}
