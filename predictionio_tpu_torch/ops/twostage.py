"""Two-stage serving: retrieval and re-rank in one dispatch per query
batch. The port's copy of ``predictionio_tpu/ops/twostage.py``.

ALS retrieves N candidates from the whole catalog (stage 1), and the
sequentialrec encoder's user state re-ranks only those N (stage 2). The
candidates never leave the card: one dispatch launches the serving
kernel (B1, :func:`~predictionio_tpu_torch.ops.als_cuda.
fused_gather_score_topk`) UNMASKED at k = the N bucket, gathers the
candidates' stage-2 item rows, scores them against the user's encoded
state, applies the seen mask exactly once and takes the final top-k;
the host fetches the k winners in one copy. Stage 2 is plain PyTorch, as
it is jnp inside the JAX package's program (no Pallas kernel there).

:class:`TwoStageTopK` extends :class:`~predictionio_tpu_torch.ops.
serving.DeviceTopK`: the stage-1 store IS the parent store (precision,
seen tables, fold-in patches), and two-stage queries ride a micro-batch
lane of their own (``pio-microbatch-two``). Both stages fold in online:
:meth:`patch_users` patches the ALS rows, :meth:`patch_seq_users` the
encoded user states, and both grow along one ladder under the one
``_store_lock``.

Over shards (an ``item_layout``, ``shards`` or ``PIO_SERVE_SHARDS``
over a plane of devices, as :class:`~predictionio_tpu_torch.ops.serving.
DeviceTopK` takes them), stage 1 is the sharded route (B1 once per shard
on its block, unmasked, at k = the N bucket, the lists merged), and the
stage-2 item table is re-ordered into the store's positions, so one
candidate position indexes both stages. The stage-2 tables and the seen
tables (in position space) stay on the first shard's device, with the
user table.

Tie-break: stage 1 retrieves without the seen mask, and the candidate
run is re-sorted ascending by item id (through a position-to-id table
on a density-permuted store) before the stable descending sort of stage
2, so ties go to the lowest item id as in a brute-force re-rank of the
whole catalog: at N = the catalog the two are equal.

The serving ladder: :meth:`TwoStageTopK.aot_plan` adds a ``("two", kb,
nb, bb)`` entry per k bucket and uid bucket to the parent's, and each is
captured as ONE CUDA graph holding both stages (B1 at k = the N bucket,
once per shard over shards, then the re-rank), so a hit is one replay.
"""

from __future__ import annotations

import collections
import os
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.als_cuda import fused_gather_score_topk
from predictionio_tpu_torch.ops.quantize import (
    QuantFactors,
    dequantize_rows,
    is_quantized,
    quantize_rows_int8,
    quantize_rows_int8_np,
)
from predictionio_tpu_torch.ops.serving import (
    BatchLane,
    DeviceTopK,
    _answer,
    _bucket,
    _component,
    _gather_rows_f32,
    _grown,
    _on_cuda,
    _pack,
    _Pending,
    _serve_precision_explicit,
    _serve_shards_env,
    _sharded_score_topk,
    _table_sig,
    foldin_enabled,
    serving_backend,
    validate_serving_policy,
)
from predictionio_tpu_torch.utils.tracing import span as _trace_span

DEFAULT_CANDIDATES = 128


def _candidates_env() -> int:
    raw = os.environ.get("PIO_TWOSTAGE_N", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            raise ValueError(f"PIO_TWOSTAGE_N={raw!r} is not an integer")
    return DEFAULT_CANDIDATES


def _dispatch_two_group(srv: "TwoStageTopK", group: List[_Pending]) -> None:
    """Queued two-stage queries -> ONE ``twos_topk`` dispatch at the
    group's largest k."""
    uids = np.asarray([it.payload for it in group], dtype=np.int64)
    _answer(group, *srv.twos_topk(uids, max(it.k for it in group)))


def twostage_rerank(E, S: torch.Tensor, vals1: torch.Tensor,
                    pos: torch.Tensor, scq: Optional[torch.Tensor],
                    smq: Optional[torch.Tensor], *, kb: int,
                    mask_seen: bool,
                    pos_ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of a dispatch: candidate gather -> re-rank score -> ONE
    seen mask -> final top-k.

    ``vals1`` / ``pos`` ``[B, nb]`` are stage 1's run (scores, store
    positions); ``S [B, R2]`` the query users' stage-2 states (fp32);
    ``E`` the stage-2 item table in position order (fp32, bf16 or int8
    :class:`QuantFactors`); ``scq`` / ``smq`` ``[B, L]`` the users' seen
    positions and mask. The candidates re-sort ascending by item id
    first (``pos_ids [positions]`` maps a position to its id on a
    density-permuted store, pad positions to int32 max; positions are
    ids without it) and the final sort is stable and descending, so ties
    go to the lowest item id. A candidate stage 1 scored -inf stays
    -inf. The seen test looks each candidate up in a ``[B, positions]``
    table of the users' seen positions, the same answers as the JAX
    package's ``[B, N, L]`` comparison at a fraction of its size.
    Returns ``(vals [B, kb] f32, positions [B, kb] i32)``."""
    key = pos if pos_ids is None else pos_ids[pos.long()]
    order = torch.argsort(key, dim=1, stable=True)
    pos = torch.gather(pos, 1, order).long()
    vals1 = torch.gather(vals1, 1, order)
    n_rows = int((E.data if is_quantized(E) else E).shape[0])
    C = _gather_rows_f32(E, pos.clamp(0, n_rows - 1))    # [B, nb, R2]
    s2 = torch.einsum("bnr,br->bn", C, S)
    s2 = torch.where(torch.isfinite(vals1), s2,
                     torch.full_like(s2, float("-inf")))
    if mask_seen:
        B = pos.shape[0]
        cols = scq.long()
        live = (smq > 0) & (cols >= 0) & (cols < n_rows)
        seen = torch.zeros((B, n_rows + 1), dtype=torch.bool,
                           device=pos.device)
        # masked slots land in a spare last column that no candidate reads
        seen.scatter_(1, torch.where(live, cols, n_rows), True)
        hit = torch.gather(seen, 1, pos.clamp(0, n_rows - 1)) \
            & (pos < n_rows)
        s2 = s2.masked_fill(hit, float("-inf"))
    out_vals, sel = torch.sort(s2, dim=1, descending=True, stable=True)
    out_vals, sel = out_vals[:, :kb], sel[:, :kb]
    return out_vals.contiguous(), torch.gather(pos, 1, sel).to(torch.int32)


class TwoStageTopK(DeviceTopK):
    """Retrieval + re-rank store over TWO factor stores, on one device
    or over shards.

    Stage 1 is the inherited :class:`DeviceTopK` store (``user_factors``
    / ``item_factors``, the ALS retrieval model; ``item_layout``,
    ``shards`` and a ``device`` plane shard it as they shard the parent).
    Stage 2 keeps the re-ranker's tables beside it on the first device:
    ``seq_item_vectors`` (item embeddings, re-ordered into the stage-1
    store's positions and padded to its rows) and ``seq_user_vectors``
    (encoded user states, grown with the stage-1 user capacity). Both
    follow the store's precision (fp32, bf16, or int8 with per-row
    scales).

    ``candidates`` (or ``PIO_TWOSTAGE_N``, default 128) sets N, the
    stage-1 run stage 2 re-ranks, bucketed like k. Two-stage queries go
    through :meth:`two_topk` / :meth:`twos_topk`; every inherited lane
    still serves. ``stage_times`` keeps, per dispatch timed with CUDA
    events (telemetry on, on the card), the microseconds of B1's kernels
    and of stage 2 (from B1's return to the dispatch's end); over
    shards, B1's kernels on every shard summed and stage 2 from the
    merge's end."""

    def __init__(self, user_factors, item_factors, seq_user_vectors,
                 seq_item_vectors,
                 seen: Optional[Dict[int, np.ndarray]] = None,
                 candidates: Optional[int] = None,
                 n_users: Optional[int] = None,
                 n_items: Optional[int] = None,
                 microbatch: Optional[bool] = None,
                 device=None, item_layout=None,
                 shards: Optional[int] = None):
        super().__init__(user_factors, item_factors, seen, n_users=n_users,
                         n_items=n_items, microbatch=microbatch,
                         device=device, item_layout=item_layout,
                         shards=shards)
        self._two_batcher: Optional[BatchLane] = None
        if self._dispatcher is not None:
            self._two_batcher = self._dispatcher.add_lane(
                "pio-microbatch-two", max_batch=256,
                dispatch_fn=_dispatch_two_group)
        n_cand = int(candidates) if candidates is not None \
            else _candidates_env()
        if n_cand < 1:
            raise ValueError(
                f"two-stage candidate count must be >= 1, got {n_cand}")
        self._candidates = n_cand
        self._n_bucket = min(_bucket(max(n_cand, 16)), self.n_items)
        self.stage_times: collections.deque = collections.deque(maxlen=4096)
        with self._store_lock:
            self._E = self._prep_stage2_items(seq_item_vectors)
            self._U = self._prep_stage2_users(seq_user_vectors)
        # position -> item id (invalid positions int32 max, so they sort
        # last): the re-rank sorts candidates by id on a permuted store
        self._pos_ids: Optional[torch.Tensor] = None
        if self._perm_np is not None:
            ids = np.where(self._perm_np >= 0, self._perm_np,
                           np.iinfo(np.int32).max).astype(np.int32)
            self._pos_ids = self._to_device(ids)

    # -- stage-2 tables ---------------------------------------------------

    def _n_positions(self) -> int:
        """Rows of the stage-1 item store: its positions."""
        if self._shards is not None:
            return int(self._shards[0].valid.shape[0]) * len(self._shards)
        return int(self._Y.shape[0])

    def _align_rows_to_positions(self, a: np.ndarray, n_pos: int,
                                 fill) -> np.ndarray:
        """An item-id-indexed table re-ordered into the stage-1 store's
        positions (the identity without a layout), padded to ``n_pos``
        rows with ``fill``: one candidate position indexes both stages'
        item tables."""
        out = np.full((n_pos,) + a.shape[1:], fill, dtype=a.dtype)
        if self._perm_np is not None:
            real = self._perm_np >= 0
            out[real] = a[self._perm_np[real]]
        else:
            m = min(n_pos, a.shape[0])
            out[:m] = a[:m]
        return out

    def _cast_stage2(self, data: np.ndarray, scale: Optional[np.ndarray]):
        """Host rows -> a device table in the store's precision (an input
        that arrived quantized keeps its scales)."""
        if scale is not None:
            return QuantFactors(
                self._to_device(data).to(torch.int8),
                self._to_device(np.asarray(scale, dtype=np.float32)))
        arr = self._to_device(np.asarray(data, dtype=np.float32))
        if self._mode == "int8":
            return quantize_rows_int8(arr)
        return arr.to(torch.bfloat16 if self._mode == "bf16"
                      else torch.float32)

    @staticmethod
    def _host_rows(table) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """A host table's rows and, quantized, its scales."""
        if is_quantized(table):
            return np.asarray(table.data), np.asarray(table.scale)
        return np.asarray(table), None

    def _prep_stage2_items(self, E):
        """Stage-2 item embeddings in the stage-1 store's position order,
        padded to its rows (zeros, scale 1). Caller holds
        ``_store_lock``."""
        data, scale = self._host_rows(E)
        if data.ndim != 2:
            raise ValueError(
                f"stage-2 item table must be [items, rank], got shape "
                f"{data.shape}")
        if data.shape[0] < self.n_items:
            raise ValueError(
                f"stage-2 item table covers {data.shape[0]} items but "
                f"the stage-1 catalog has {self.n_items}: the two "
                "stages must be trained against one shared item map")
        n_pos = self._n_positions()
        out = self._align_rows_to_positions(data, n_pos, 0)
        if scale is not None:
            scale = self._align_rows_to_positions(
                np.asarray(scale, dtype=np.float32), n_pos, 1.0)
        return self._cast_stage2(out, scale)

    def _prep_stage2_users(self, U):
        """Stage-2 encoded user states padded to the stage-1 user
        capacity (rows past ``n_users`` zero until folded in). Caller
        holds ``_store_lock``."""
        data, scale = self._host_rows(U)
        if data.ndim != 2:
            raise ValueError(
                f"stage-2 user table must be [users, rank], got shape "
                f"{data.shape}")
        if data.shape[0] < self.n_users:
            raise ValueError(
                f"stage-2 user table covers {data.shape[0]} users but "
                f"the stage-1 store serves {self.n_users}: the two "
                "stages must be trained against one shared user map")
        cap = int(self._X.shape[0])
        padded = np.zeros((cap, data.shape[1]), dtype=data.dtype)
        padded[:min(cap, data.shape[0])] = data[:cap]
        if scale is not None:
            s = np.ones((cap,), dtype=np.float32)
            s[:min(cap, len(scale))] = scale[:cap]
            scale = s
        return self._cast_stage2(padded, scale)

    def _sync_seq_capacity_locked(self) -> None:
        """Grow the stage-2 user table to the stage-1 capacity (new rows
        zero, int8 scales 1). Caller holds ``_store_lock``."""
        cap = int(self._X.shape[0])
        U = self._U
        if is_quantized(U):
            if int(U.data.shape[0]) < cap:
                self._U = QuantFactors(
                    _grown(U.data, (cap, U.data.shape[1])),
                    _grown(U.scale, (cap,), 1.0))
        elif int(U.shape[0]) < cap:
            self._U = _grown(U, (cap, U.shape[1]))

    # -- serving ----------------------------------------------------------

    def _nb_for(self, kb: int) -> int:
        """The N bucket a k-bucket dispatch retrieves: at least the
        configured candidate bucket and kb, at most the catalog."""
        return min(max(self._n_bucket, kb), self.n_items)

    # -- the serving ladder -----------------------------------------------

    def _store_sig_locked(self) -> Tuple:
        """The parent's signature plus the stage-2 tables and the N
        bucket."""
        base = super()._store_sig_locked()
        if getattr(self, "_U", None) is None:  # mid-__init__
            return base
        return base + (_table_sig(self._E), _table_sig(self._U),
                       _table_sig(self._pos_ids), self._n_bucket)

    def _ladder_tables_locked(self) -> Tuple:
        return super()._ladder_tables_locked() + (self._E, self._U,
                                                  self._pos_ids)

    def aot_plan(self, max_k: int = 128,
                 batch_sizes: Tuple[int, ...] = ()) -> List[Tuple]:
        """The parent's ladder plus one ``("two", kb, nb, bb)`` entry per
        (k bucket, uid bucket): steady two-stage traffic captures
        nothing."""
        plan = super().aot_plan(max_k=max_k, batch_sizes=batch_sizes)
        ks = sorted({e[1] for e in plan if e[0] == "user"})
        buckets = sorted({e[2] for e in plan if e[0] == "users"})
        for kb in ks:
            for bb in buckets:
                plan.append(("two", kb, self._nb_for(kb), bb))
        return plan

    def _aot_lower_entry(self, entry: Tuple):
        if entry[0] != "two":
            return super()._aot_lower_entry(entry)
        _, kb, nb, bb = entry
        return (self._two_fn(kb, nb),
                (torch.zeros(bb, dtype=torch.int64, device=self.device),))

    def _warm_entry(self, entry: Tuple) -> None:
        if entry[0] != "two":
            return super()._warm_entry(entry)
        _, kb, nb, bb = entry
        self.twos_topk(np.zeros(bb, dtype=np.int64), kb)

    def warmup(self, max_k: int = 128,
               batch_sizes: Tuple[int, ...] = ()) -> Dict[str, int]:
        """The parent's warm-up over the whole ladder (the ``two``
        entries with it), then one sacrificial two-stage query."""
        stats = super().warmup(max_k=max_k, batch_sizes=batch_sizes)
        self.twos_topk(np.zeros(8, dtype=np.int64), min(16, self.n_items))
        return stats

    def two_topk(self, uid: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(item indices, scores) for one user through retrieval and
        re-rank, descending by the stage-2 score; seen items masked once
        on the device. Concurrent callers share one dispatch through the
        ``pio-microbatch-two`` lane."""
        with _trace_span("device.two_topk", attributes={"k": int(k)}) as sp:
            if self._two_batcher is not None:
                return self._two_batcher.submit(int(uid), int(k), span=sp)
            idx, scores = self.twos_topk(
                np.asarray([int(uid)], dtype=np.int64), k)
            valid = np.isfinite(scores[0])
            return idx[0][valid], scores[0][valid]

    def twos_topk(self, uids, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched two-stage top-k: ONE dispatch of the ``("two", kb, nb,
        bb)`` entry (B1 unmasked at the N bucket, once per shard over a
        sharded store, then stage 2) and ONE copy back for the batch,
        padded with uid 0 to its power-of-two bucket. Returns ``(idx [B,
        k] int32 item ids, scores [B, k] float32)``, rows descending;
        rows may hold -inf past the valid candidates (callers filter per
        row). An eager dispatch on the card with telemetry on appends
        its B1 / stage-2 microseconds to ``stage_times``; a replayed
        graph times only as a whole."""
        uids = np.asarray(uids, dtype=np.int64)
        n = len(uids)
        with _trace_span("device.twos_topk",
                         attributes={"batch": int(n), "k": int(k)}):
            bb = _bucket(max(n, 1), lo=8)
            padded = np.zeros(bb, dtype=np.int64)
            padded[:n] = uids
            kb = min(_bucket(k), self.n_items)
            nb = self._nb_for(kb)
            fn = self._two_fn(kb, nb)
            split: Dict[str, Any] = {}
            idx, scores = self._dispatch_entry(
                ("two", kb, nb, bb), fn, (padded,), batch=n, bucket=bb,
                eager=lambda u, events=None: fn(u, events=events,
                                                split=split))
            if "events" in split:
                b1, stage2, end = split["events"]
                self.stage_times.append((
                    sum(a.elapsed_time(b) for a, b in b1) * 1e3,
                    stage2.elapsed_time(end) * 1e3))
            return self._positions_to_items(idx[:n, :k]), scores[:n, :k]

    def _two_fn(self, kb: int, nb: int) -> Callable[..., torch.Tensor]:
        """The two lane's program: ``u [B]`` int64 uids on the device ->
        the packed ``[B, 2 kb]`` result. It gathers the users' stage-1
        rows, stage-2 states and seen rows, launches B1 unmasked at k =
        ``nb`` (over shards, once per shard, the lists merged) and
        re-ranks (:func:`twostage_rerank`), under ``_store_lock``,
        eagerly or captured; the store held weakly. ``events``, an eager
        call's timing pair, is recorded around the whole dispatch, and
        then ``split`` (a dict) receives B1's own pairs (one a shard) and
        stage 2's start and end events."""
        ref = weakref.ref(self)

        def fn(u: torch.Tensor, events: Optional[Tuple] = None,
               split: Optional[dict] = None) -> torch.Tensor:
            srv = ref()
            sc = sm = None
            if srv._mask_seen:
                sc, sm = srv._seen_cols[u], srv._seen_mask[u]
            Q = _gather_rows_f32(srv._X, u)
            S = _gather_rows_f32(srv._U, u)
            shards = srv._shards
            b1 = stage2 = None
            if events is not None:
                b1 = [tuple(torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                      for _ in range(1 if shards is None else len(shards))]
                stage2 = torch.cuda.Event(enable_timing=True)
                events[0].record()
            if shards is None:
                vals1, pos = fused_gather_score_topk(
                    Q, srv._Y, None, None, k=nb, n_items=srv.n_items,
                    mask_seen=False, events=None if b1 is None else b1[0])
            else:
                vals1, pos = _sharded_score_topk(
                    shards, Q, None, None, k=nb, mask_seen=False, events=b1)
            if stage2 is not None:
                stage2.record()
            out = _pack(*twostage_rerank(
                srv._E, S, vals1, pos, sc, sm, kb=kb,
                mask_seen=srv._mask_seen, pos_ids=srv._pos_ids))
            if events is not None:
                events[1].record()
                if split is not None:
                    split["events"] = (b1, stage2, events[1])
            return out
        return fn

    def stats(self) -> Dict[str, Dict[str, Any]]:
        out = super().stats()
        if self._two_batcher is not None:
            out["two"] = self._two_batcher.stats()
        return out

    def memory_report(self) -> Dict[str, Any]:
        report = super().memory_report()
        with self._store_lock:
            E, U = self._E, self._U
        extra = {"stage2ItemVectors": _component(E),
                 "stage2UserVectors": _component(U)}
        report["components"].update(extra)
        report["totalBytes"] += sum(c["bytes"] + c["scaleBytes"]
                                    for c in extra.values())
        report["twoStage"] = {"candidates": self._candidates,
                              "nBucket": self._n_bucket}
        return report

    # -- live store patching (online fold-in, both stages) ----------------

    @property
    def seq_item_factors(self) -> torch.Tensor:
        """The stage-2 item table in item-id order, fp32 ``[n_items,
        R2]`` (dequantized, and de-permuted on a sharded store, per
        access)."""
        with self._store_lock:
            E = self._E
        Ef = dequantize_rows(E) if is_quantized(E) else E.float()
        if self._inv_np is not None:
            return Ef[torch.from_numpy(self._inv_np).to(Ef.device)]
        return Ef[:self.n_items].contiguous()

    def patch_users(self, uids, factors,
                    seen_items: Optional[Dict[int, np.ndarray]] = None
                    ) -> None:
        """The stage-1 fold-in write path, plus the invariant that the
        stage-2 user table spans the stage-1 capacity (grown rows zero
        until :meth:`patch_seq_users` writes them)."""
        with self._store_lock:
            super().patch_users(uids, factors, seen_items=seen_items)
            sig = self._store_sig_locked()
            self._sync_seq_capacity_locked()
            if self._store_sig_locked() != sig:
                self._clear_ladder_locked()

    def patch_seq_users(self, uids, vectors,
                        seen_items: Optional[Dict[int, np.ndarray]] = None
                        ) -> None:
        """Write freshly RE-ENCODED user states into the live stage-2
        table: the re-ranker's fold-in write path, under the same lock
        and in-stream ordering as :meth:`patch_users`. A uid past the
        capacity grows BOTH stores through the stage-1 path first (the new
        user's retrieval row stays zero until its ALS fold lands), so the
        two tables never disagree about capacity."""
        uids = np.asarray(uids, dtype=np.int64)
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or len(uids) != vectors.shape[0]:
            raise ValueError(
                f"patch_seq_users: {len(uids)} uids vs vectors "
                f"{vectors.shape}")
        if not len(uids):
            return
        if uids.min() < 0:
            raise ValueError("patch_seq_users: negative user index")
        if seen_items:
            seen_items = self._translate_seen(seen_items)
        dev = self.device
        idx = torch.from_numpy(uids).to(dev)
        with self._store_lock:
            sig_before = self._store_sig_locked()
            U = self._U
            rank2 = int((U.data if is_quantized(U) else U).shape[1])
            if vectors.shape[1] != rank2:
                raise ValueError(
                    f"patch_seq_users: vectors rank {vectors.shape[1]} "
                    f"vs stage-2 store rank {rank2}")
            needed = int(uids.max()) + 1
            if needed > int(self._X.shape[0]):
                r1 = int((self._X.data if is_quantized(self._X)
                          else self._X).shape[1])
                # a NEW uid: zero is the row the growth gives it anyway
                super().patch_users(np.asarray([needed - 1], dtype=np.int64),
                                    np.zeros((1, r1), dtype=np.float32))
            self._sync_seq_capacity_locked()
            if self._mask_seen and seen_items:
                cols, mask, sids, row_c, row_m = self._prep_seen_locked(
                    seen_items, int(self._X.shape[0]))
                cols.index_copy_(0, sids, row_c)
                mask.index_copy_(0, sids, row_m)
                self._seen_cols, self._seen_mask = cols, mask
            U = self._U
            if is_quantized(U):
                q = quantize_rows_int8_np(vectors)
                U.data.index_copy_(0, idx, torch.from_numpy(q.data).to(dev))
                U.scale.index_copy_(0, idx,
                                    torch.from_numpy(q.scale).to(dev))
            else:
                U.index_copy_(0, idx, torch.from_numpy(vectors).to(dev)
                              .to(U.dtype))
            self.n_users = max(self.n_users, needed)
            if self._store_sig_locked() != sig_before:
                self._clear_ladder_locked()

    # -- serving facets ---------------------------------------------------

    def two_facet(self) -> "_TwoStageFacet":
        """The handle the RETRIEVAL model serves through: per-user
        queries go to the two-stage lane; fold-in writes, warm-up and
        accounting stay the stage-1 surface."""
        return _TwoStageFacet(self)

    def seq_facet(self) -> "_SeqStoreFacet":
        """The handle the RE-RANK model holds: its fold-in writes land in
        the stage-2 table, its queries go to the shared two-stage lane,
        and its warm-up and close are no-ops (the store warms and closes
        once, through the retrieval facet)."""
        return _SeqStoreFacet(self)


class _TwoStageFacet:
    """A DeviceTopK-shaped view of a :class:`TwoStageTopK` for the
    retrieval model: ``user_topk`` / ``users_topk`` dispatch the
    two-stage lane, so the recommendation template's serving helpers
    (blacklists, categories, batch grouping) run unchanged on it."""

    def __init__(self, store: TwoStageTopK):
        self.store = store

    def user_topk(self, uid: int, k: int):
        return self.store.two_topk(uid, k)

    def users_topk(self, uids, k: int):
        return self.store.twos_topk(uids, k)

    def items_topk(self, idxs, k: int):
        return self.store.items_topk(idxs, k)

    def warmup(self, max_k: int = 128,
               batch_sizes: Tuple[int, ...] = ()) -> Dict[str, int]:
        return self.store.warmup(max_k=max_k, batch_sizes=batch_sizes)

    def patch_users(self, uids, factors, seen_items=None):
        return self.store.patch_users(uids, factors, seen_items=seen_items)

    @property
    def growable(self) -> bool:
        return self.store.growable

    @property
    def item_factors(self):
        return self.store.item_factors

    def item_factors_as(self, dtype):
        return self.store.item_factors_as(dtype)

    @property
    def user_capacity(self) -> int:
        return self.store.user_capacity

    def stats(self):
        return self.store.stats()

    def memory_report(self):
        return self.store.memory_report()

    def ladder_report(self):
        return self.store.ladder_report()

    def close(self) -> None:
        self.store.close()


class _SeqStoreFacet:
    """A DeviceTopK-shaped view of a :class:`TwoStageTopK` for the
    re-rank model: fold-in writes patch the stage-2 user table,
    ``item_factors`` is the stage-2 item table, queries go to the shared
    lane, and the lifecycle ops are no-ops."""

    def __init__(self, store: TwoStageTopK):
        self.store = store

    def user_topk(self, uid: int, k: int):
        return self.store.two_topk(uid, k)

    def users_topk(self, uids, k: int):
        return self.store.twos_topk(uids, k)

    def items_topk(self, idxs, k: int):
        return self.store.items_topk(idxs, k)

    def warmup(self, max_k: int = 128,
               batch_sizes: Tuple[int, ...] = ()) -> None:
        return None

    def patch_users(self, uids, factors, seen_items=None):
        return self.store.patch_seq_users(uids, factors,
                                          seen_items=seen_items)

    @property
    def growable(self) -> bool:
        return True

    @property
    def item_factors(self):
        return self.store.seq_item_factors

    @property
    def user_capacity(self) -> int:
        return self.store.user_capacity

    def stats(self):
        return {}

    def memory_report(self):
        return {"totalBytes": 0, "components": {}, "sharedWith": "twoStage"}

    def close(self) -> None:  # the retrieval facet owns the dispatcher
        return None


def _retrieval_plane(model):
    """Where a retrieval model's store is built: its deployment's plane
    (``serve_plane``), else a sharded model's mesh, else its device."""
    plane = getattr(model, "serve_plane", None)
    if plane is None and hasattr(model.user_factors, "gathered"):
        plane = model.user_factors.mesh
    return plane if plane is not None else getattr(model, "device", None)


def build_two_stage_store(retrieval_model, rerank_model,
                          candidates: Optional[int] = None,
                          device=None) -> TwoStageTopK:
    """Check a two-model deployment and build its ONE store on
    ``device``: one device, a sequence of devices or a mesh (None: the
    retrieval model's serving plane or device, else cuda). The store
    shards as the retrieval model's ``item_layout`` or
    ``PIO_SERVE_SHARDS`` asks, over that plane.

    ``retrieval_model`` must be ALS-shaped (``user_factors`` /
    ``item_factors`` / ``user_map`` / ``item_map``; a
    :class:`~predictionio_tpu_torch.templates.recommendation.engine.
    ShardedALSModel`'s factors are gathered on their mesh's first device,
    device to device), ``rerank_model`` seqrec-shaped (``user_vectors`` /
    ``item_vectors``), both over one user and item map. Refused at load,
    never at query time: an explicit ``PIO_SERVING_BACKEND=host`` (the
    serving-policy table's ``two_stage`` row: the host lane has no
    two-stage store), mismatched maps, and fold-in (``PIO_FOLDIN``) with
    a re-ranker that cannot re-encode (no ``fold_in_rows``)."""
    for attr in ("user_factors", "item_factors", "user_map", "item_map"):
        if getattr(retrieval_model, attr, None) is None:
            raise ValueError(
                "two-stage serving: the FIRST algorithm must be the "
                "retrieval stage (ALS-shaped: user_factors/item_factors"
                f"/user_map/item_map); {type(retrieval_model).__name__} "
                f"has no {attr}")
    for attr in ("user_vectors", "item_vectors"):
        if getattr(rerank_model, attr, None) is None:
            raise ValueError(
                "two-stage serving: the LAST algorithm must be the "
                "re-rank stage (seqrec-shaped: user_vectors/"
                f"item_vectors); {type(rerank_model).__name__} has no "
                f"{attr}")
    if len(retrieval_model.item_map) != len(rerank_model.item_map):
        raise ValueError(
            "two-stage serving: the stages disagree about the catalog "
            f"({len(retrieval_model.item_map)} vs "
            f"{len(rerank_model.item_map)} items) — both algorithms "
            "must train from one Preparator with one shared item map")
    if len(retrieval_model.user_map) != len(rerank_model.user_map):
        raise ValueError(
            "two-stage serving: the stages disagree about the users "
            f"({len(retrieval_model.user_map)} vs "
            f"{len(rerank_model.user_map)}) — both algorithms must "
            "train from one Preparator with one shared user map")
    X, Y = retrieval_model.user_factors, retrieval_model.item_factors
    sharded = hasattr(X, "gathered")       # a ShardedTensor pair
    validate_serving_policy(
        serving_backend(),
        host_capable=not (sharded or _on_cuda(X) or _on_cuda(Y)),
        explicit_precision=_serve_precision_explicit(),
        foldin=foldin_enabled(), sharded=_serve_shards_env() > 1,
        two_stage=True)
    if foldin_enabled() and not callable(
            getattr(rerank_model, "fold_in_rows", None)):
        raise ValueError(
            "two-stage serving with PIO_FOLDIN=on needs a re-ranker "
            "that can re-encode folded-in users (fold_in_rows); "
            f"{type(rerank_model).__name__} has none — disable fold-in "
            "or use a re-rank model with an online encode hook")
    if device is None:
        device = _retrieval_plane(retrieval_model)
    if sharded:
        X, Y = X.gathered(), Y.gathered()
    return TwoStageTopK(
        X, Y, rerank_model.user_vectors, rerank_model.item_vectors,
        seen=getattr(retrieval_model, "seen", None), candidates=candidates,
        n_users=getattr(retrieval_model, "n_users", None),
        n_items=getattr(retrieval_model, "n_items", None), device=device,
        item_layout=getattr(retrieval_model, "item_layout", None))


__all__ = ["DEFAULT_CANDIDATES", "TwoStageTopK", "build_two_stage_store",
           "twostage_rerank"]
