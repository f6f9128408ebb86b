"""Device-resident top-N serving on one GPU.

The port's counterpart of ``predictionio_tpu/ops/serving.py`` for the
single-device path: the factor tables live on the card (fp32, bf16 or
int8 with per-row scales), and every query batch is one call of the
fused score -> mask -> top-k kernel (:mod:`.als_cuda`), whose k winners
come back to the host in one copy. Concurrent single queries are
micro-batched by :class:`BatchDispatcher`.

Each launch of the serving kernel is recorded by the device flight
recorder (:mod:`~predictionio_tpu_torch.utils.device_telemetry`) and as a
``device.execute`` span under the query's ``device.*`` span; the
micro-batcher feeds the ``pio_microbatch_*`` families.

The user store is live-patchable (:meth:`DeviceTopK.patch_users`, the
write path of online fold-in): rows are rewritten in place and the
store grows along the power-of-two ladder, under the store lock every
dispatch snapshots under.

Not here yet (later slices): the AOT ladder (CUDA graphs on the GPU),
sharded stores, and the memory/ladder reports.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import os
import threading
import time
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import (
    DeviceLike,
    default_serve_precision,
    resolve_device,
)
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.ops.als_cuda import TOPK_TILE_M, fused_gather_score_topk
from predictionio_tpu_torch.ops.quantize import (
    QuantFactors,
    dequantize_rows,
    is_quantized,
    quantize_rows_int8,
    quantize_rows_int8_np,
)
from predictionio_tpu_torch.utils import device_telemetry as _dtel
from predictionio_tpu_torch.utils import metrics as _metrics
from predictionio_tpu_torch.utils import tracing as _tracing
from predictionio_tpu_torch.utils.tracing import span as _trace_span

SERVE_PRECISION_MODES = ("fp32", "bf16", "int8")


def _serve_precision_explicit() -> Optional[str]:
    """The operator's explicit ``PIO_SERVE_PRECISION``, or None when
    unset. Unknown values raise."""
    mode = os.environ.get("PIO_SERVE_PRECISION", "").strip().lower()
    if not mode:
        return None
    if mode not in SERVE_PRECISION_MODES:
        raise ValueError(
            f"PIO_SERVE_PRECISION={mode!r} is not a serving precision "
            f"(expected one of: {', '.join(SERVE_PRECISION_MODES)})")
    return mode


def foldin_enabled() -> bool:
    """``PIO_FOLDIN``, set while a query server deploys with fold-in
    (``pio deploy --foldin on`` or ``ServerConfig(foldin=True)``) and
    readable by embedders: the deployed server runs the online fold-in
    consumer, which needs the updatable :class:`DeviceTopK` store. The
    port serves every model from that store, so the flag changes no
    choice here."""
    return os.environ.get("PIO_FOLDIN", "").strip().lower() in (
        "1", "on", "true", "yes")


def seen_tables(seen: Dict[int, np.ndarray], n_rows: int,
                pad_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a ``{user_idx: item_idx array}`` dict into padded
    ``(cols [N, L] int32, mask [N, L] float32)`` tables for on-device
    masking. L = longest seen list, padded to ``pad_multiple``."""
    longest = max((len(v) for v in seen.values()), default=0)
    L = max(1, -(-max(longest, 1) // pad_multiple) * pad_multiple)
    cols = np.zeros((n_rows, L), dtype=np.int32)
    mask = np.zeros((n_rows, L), dtype=np.float32)
    for u, items in seen.items():
        m = min(len(items), L)
        cols[u, :m] = items[:m]
        mask[u, :m] = 1.0
    return cols, mask


def _gather_rows_f32(factors, idx: torch.Tensor) -> torch.Tensor:
    """Factor rows gathered by index (any index shape) as fp32; int8
    rows dequantize with their own per-row scales."""
    if is_quantized(factors):
        return factors.data[idx].float() * factors.scale[idx][..., None]
    return factors[idx].float()


def _pad_item_rows_for_kernel(Y):
    """Item table padded (zeros, scale 1) to the kernel's tile multiple,
    once at store construction. Pad rows sit past ``n_items`` and score
    -inf."""
    m = int(Y.shape[0])
    pad = (-m) % TOPK_TILE_M
    if not pad:
        return Y
    if is_quantized(Y):
        d, s = Y.data, Y.scale
        return QuantFactors(
            torch.cat([d, d.new_zeros((pad, d.shape[1]))]),
            torch.cat([s, s.new_ones((pad,))]))
    return torch.cat([Y, Y.new_zeros((pad, Y.shape[1]))])


def _grown(t: torch.Tensor, shape, fill: float = 0) -> torch.Tensor:
    """A new table of ``shape`` filled with ``fill``, ``t`` copied into
    its leading corner: the live table is left as it was."""
    out = t.new_full(tuple(shape), fill)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _normalize_rows(Y):
    """Row-normalize with the norms taken in fp32 whatever the storage
    dtype (a bf16 norm would square bf16 values); the result keeps Y's
    dtype. A quantized store re-quantizes the normalized rows (absmax
    <= 1, so the new scales keep full int8 resolution)."""
    Yf = dequantize_rows(Y) if is_quantized(Y) else Y.float()
    norms = torch.sqrt((Yf * Yf).sum(dim=1, keepdim=True))
    Yn = Yf / torch.clamp(norms, min=1e-12)
    if is_quantized(Y):
        return quantize_rows_int8(Yn)
    return Yn.to(Y.dtype)


def bucket_size(n: int, lo: int = 16) -> int:
    """The power-of-two bucket ``n`` rounds up to (min ``lo``)."""
    b = lo
    while b < n:
        b *= 2
    return b


_bucket = bucket_size


def choose_server(user_factors, item_factors,
                  seen: Optional[Dict[int, np.ndarray]] = None,
                  n_users: Optional[int] = None,
                  n_items: Optional[int] = None,
                  device: DeviceLike = None) -> "DeviceTopK":
    """The server for a model: :class:`DeviceTopK` on ``device`` (None =
    cuda), at every size. The JAX package's host lane (``HostTopK``,
    picked below a size rule) is not ported: no run on the card has
    measured where a host matvec and the device cross over. Sharded and
    two-stage stores join this choice with the slices that port them."""
    return DeviceTopK(user_factors, item_factors, seen,
                      n_users=n_users, n_items=n_items, device=device)


class QueryRejectedError(RuntimeError):
    """A query waited in the micro-batch queue past the deadline and was
    rejected instead of queuing without bound; the query server answers
    503 with a ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _queue_deadline() -> Optional[float]:
    """``PIO_QUERY_QUEUE_DEADLINE``: seconds a query may wait in the
    micro-batch queue before a fast 503 (<= 0 disables; default 10)."""
    val = _env_float("PIO_QUERY_QUEUE_DEADLINE", 10.0)
    return val if val > 0 else None


def _batch_window() -> float:
    """``PIO_BATCH_WINDOW``: how long (seconds, default 2 ms) the
    dispatcher may hold a lone query hoping more arrive to share its
    device dispatch."""
    return max(0.0, _env_float("PIO_BATCH_WINDOW", 0.002))


class _BatchResult:
    """One batched dispatch's output, shared by every request in the
    group; each waiting thread renders its own row. ``telemetry`` is the
    flight record of the launch that produced it (None with telemetry
    off): the waiters attach it to their ``device.*`` span."""

    __slots__ = ("idx", "scores", "telemetry")

    def __init__(self, idx: np.ndarray, scores: np.ndarray,
                 telemetry: Optional[Dict[str, Any]] = None):
        self.idx = idx
        self.scores = scores
        self.telemetry = telemetry

    def render(self, row: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        ri = self.idx[row, :k]
        rs = self.scores[row, :k]
        valid = np.isfinite(rs)
        return ri[valid], rs[valid]


class _Pending:
    """One queued query: payload (uid, or item-index tuple), its k, its
    batching deadline (the EDF sort key) and the future its thread waits
    on. ``arrival`` (monotonic) feeds the flight recorder's queue wait;
    ``ctx`` carries the submitting thread's trace context, so the
    dispatcher thread can parent ``device.execute`` under a query's
    trace."""

    __slots__ = ("payload", "k", "deadline", "seq", "future", "arrival",
                 "ctx")

    def __init__(self, payload, k: int, deadline: float, seq: int,
                 arrival: float, ctx=None):
        self.payload = payload
        self.k = k
        self.deadline = deadline
        self.seq = seq
        self.arrival = arrival
        self.ctx = ctx
        self.future: Future = Future()

    def __lt__(self, other: "_Pending") -> bool:
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class BatchLane:
    """One query kind's lane in the shared :class:`BatchDispatcher`: its
    own EDF queue, batch cap and group-dispatch function."""

    def __init__(self, dispatcher: "BatchDispatcher", name: str,
                 max_batch: int,
                 dispatch_fn: Callable[["DeviceTopK", List[_Pending]], None]):
        self._d = dispatcher
        self.name = name
        self.max_batch = int(max_batch)
        self.dispatch_fn = dispatch_fn
        self.queue: List[_Pending] = []  # dispatcher-owned, EDF-sorted
        # written under the dispatcher's stats lock. `pending` counts the
        # queries waiting anywhere (handoff deque or lane queue), so the
        # depth gauge also covers a dispatcher busy in a dispatch
        self.pending = 0
        self.dispatches = 0
        self.batched_queries = 0
        self.rejections = 0
        self.triggers = {"size": 0, "window": 0, "drain": 0}
        self.depth_samples: collections.deque = collections.deque(
            maxlen=512)

    def submit(self, payload, k: int,
               span=None) -> Tuple[np.ndarray, np.ndarray]:
        """Enqueue, block for the shared dispatch, render this request's
        row. Raises :class:`QueryRejectedError` past the queue deadline.
        ``span`` (a live trace span) receives the dispatch's flight
        record as its ``dispatch`` attribute."""
        k = int(k)
        res, row = self._d.submit_wait(self, payload, k)
        if span is not None and res.telemetry is not None:
            span.attributes["dispatch"] = res.telemetry
        return res.render(row, k)

    def stats(self) -> Dict[str, Any]:
        """The JAX package's ``batcher_stats`` shape: throughput
        counters, dispatch triggers, batch-fill ratio and queue-depth
        percentiles over the last 512 dispatches."""
        with self._d._stats_lock:
            depths = list(self.depth_samples)
            st: Dict[str, Any] = {
                "batcher": self.name,
                "dispatches": self.dispatches,
                "batchedQueries": self.batched_queries,
                "queueDepth": self.pending,
                "maxBatch": self.max_batch,
                "windowSec": self._d.window,
                "dispatchTriggers": dict(self.triggers),
                "rejectedQueries": self.rejections,
                "batchFillRatio": round(
                    self.batched_queries
                    / (self.dispatches * self.max_batch), 4)
                if self.dispatches else 0.0,
            }
        if depths:
            a = np.asarray(depths)
            st["queueDepthPercentiles"] = {
                "p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)),
                "p99": float(np.percentile(a, 99)),
                "max": int(a.max()),
            }
        else:
            st["queueDepthPercentiles"] = None
        return st


class BatchDispatcher:
    """Deadline-aware cross-request batching for device queries.

    One dispatcher thread serves every lane. Callers hand off through a
    deque and an event; the lock the submit path shares with the
    dispatcher is never held across a device dispatch. A lane dispatches
    when it holds ``max_batch`` queries (``size``), when its oldest
    query's batching window expired (``window``), or when the dispatcher
    closes (``drain``). A query still queued past the queue deadline is
    shed as a 503."""

    name = "pio-microbatch-dispatcher"

    def __init__(self, server: "DeviceTopK", window: Optional[float] = None):
        # weakref: the thread must not keep the server's tables alive
        self._srv_ref = weakref.ref(server)
        self.window = _batch_window() if window is None else float(window)
        self._deadline = _queue_deadline()
        self._lanes: List[BatchLane] = []
        self._handoff: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._closed = False

    def add_lane(self, name: str, max_batch: int, dispatch_fn) -> BatchLane:
        lane = BatchLane(self, name, max_batch, dispatch_fn)
        self._lanes.append(lane)
        return lane

    # -- submit side -------------------------------------------------------

    def enqueue(self, lane: BatchLane, payload, k: int) -> Future:
        now = time.monotonic()
        item = _Pending(payload, k, now + self.window, next(self._seq),
                        arrival=now, ctx=_tracing.current_trace_context())
        # pending rises before the item is visible in the handoff, so the
        # dispatcher's decrement can never run first
        with self._stats_lock:
            lane.pending += 1
        # the closed check and the append are one step against close():
        # nothing can enter the handoff after its final drain
        try:
            with self._thread_lock:
                if self._closed:
                    raise RuntimeError("serving backend is closed")
                self._handoff.append((lane, item))
        except BaseException:
            with self._stats_lock:
                lane.pending -= 1
            raise
        self._set_queue_gauge(lane)
        self._wake.set()
        self._ensure_thread()
        return item.future

    def submit_wait(self, lane: BatchLane, payload,
                    k: int) -> Tuple[_BatchResult, int]:
        fut = self.enqueue(lane, payload, k)
        try:
            return fut.result(timeout=self._deadline)
        except _FuturesTimeout:
            # cancel-if-still-queued wins a fast 503; losing the race
            # means the dispatcher owns it and the result is imminent
            if fut.cancel():
                with self._stats_lock:
                    lane.rejections += 1
                _metrics.MICROBATCH_REJECTIONS.inc(batcher=lane.name)
                raise QueryRejectedError(
                    f"query queued past {self._deadline}s without a device "
                    "dispatch slot; retry shortly",
                    retry_after=min(5.0, max(1.0, self._deadline / 4)))
            return fut.result()

    def _ensure_thread(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._thread_lock:
            if self._closed:
                return
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name=self.name)
                self._thread.start()

    def close(self) -> None:
        """Stop accepting queries, answer what is queued, stop the
        thread. Idempotent."""
        with self._thread_lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
        self._wake.set()
        if thread is threading.current_thread():
            return  # inside a dispatch: the loop drains after it returns
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)
            if thread.is_alive():
                # wedged in a device dispatch: the thread owns the queues
                # and drains them itself when it returns
                return
        with self._thread_lock:
            self._drain_handoff()
            for lane in self._lanes:
                leftover, lane.queue = lane.queue, []
                with self._stats_lock:
                    lane.pending -= len(leftover)
                for it in leftover:
                    if it.future.set_running_or_notify_cancel():
                        it.future.set_exception(
                            RuntimeError("serving backend closed"))
                self._set_queue_gauge(lane)

    # -- dispatcher thread -------------------------------------------------

    def _drain_handoff(self) -> None:
        while True:
            try:
                lane, item = self._handoff.popleft()
            except IndexError:
                return
            bisect.insort(lane.queue, item)

    def _set_queue_gauge(self, lane: BatchLane) -> None:
        _metrics.MICROBATCH_QUEUE_DEPTH.set(lane.pending, batcher=lane.name)

    def _all_empty(self) -> bool:
        return not self._handoff and all(not ln.queue for ln in self._lanes)

    def _pick(self, now: float) -> Tuple[Optional[BatchLane], Optional[str]]:
        """A full lane first, else the lane whose earliest deadline has
        expired (earliest wins), else nothing yet."""
        best: Optional[BatchLane] = None
        best_deadline = 0.0
        for lane in self._lanes:
            q = lane.queue
            if not q:
                continue
            if self._closed:
                return lane, "drain"
            if len(q) >= lane.max_batch:
                return lane, "size"
            d = q[0].deadline
            if d <= now and (best is None or d < best_deadline):
                best, best_deadline = lane, d
        return (best, "window") if best is not None else (None, None)

    def _next_delay(self, now: float) -> Optional[float]:
        deadlines = [ln.queue[0].deadline for ln in self._lanes if ln.queue]
        return max(0.0, min(deadlines) - now) if deadlines else None

    def _run(self) -> None:
        while True:
            self._wake.clear()
            self._drain_handoff()
            now = time.monotonic()
            lane, trigger = self._pick(now)
            if lane is not None:
                self._dispatch(lane, trigger)
                continue
            if self._closed:
                if self._all_empty():
                    return
                continue
            delay = self._next_delay(now)
            if delay is None:
                # idle: bounded wait, exit once the owner is gone
                if not self._wake.wait(1.0) and self._srv_ref() is None:
                    with self._thread_lock:
                        self._drain_handoff()
                        if self._all_empty():
                            self._thread = None
                            return
            elif delay > 0:
                self._wake.wait(delay)

    def _dispatch(self, lane: BatchLane, trigger: str) -> None:
        q = lane.queue
        with self._stats_lock:
            depth = lane.pending  # waiting anywhere, handoff included
        group: List[_Pending] = []
        popped = 0
        while q and len(group) < lane.max_batch:
            it = q.pop(0)  # EDF: the earliest deadlines form the batch
            popped += 1
            # False: the waiter already shed it with a 503
            if it.future.set_running_or_notify_cancel():
                group.append(it)
        with self._stats_lock:
            lane.pending -= popped
        self._set_queue_gauge(lane)
        if not group:
            return
        srv = self._srv_ref()
        try:
            if srv is None:
                raise RuntimeError("serving backend was released")
            if _dtel.enabled():
                # what the launch site cannot see: the oldest grouped
                # query's queue wait, the group size, and a trace parent
                # (the dispatcher thread has no trace of its own: it
                # borrows the first traced query's, so device.execute
                # lands in a tree)
                wait = max(0.0, time.monotonic()
                           - min(it.arrival for it in group))
                parent = next((it.ctx for it in group
                               if it.ctx is not None), None)
                with _dtel.dispatch_scope(queue_wait_us=wait * 1e6,
                                          group=len(group),
                                          trace_parent=parent):
                    lane.dispatch_fn(srv, group)
            else:
                lane.dispatch_fn(srv, group)
        except BaseException as e:  # propagate to every waiter
            for it in group:
                if not it.future.done():
                    it.future.set_exception(e)
        finally:
            del srv  # never hold the server across the idle wait
            for it in group:
                if not it.future.done():
                    it.future.set_exception(RuntimeError(
                        "batch dispatch completed without a result"))
        with self._stats_lock:
            lane.dispatches += 1
            lane.batched_queries += len(group)
            lane.triggers[trigger] += 1
            lane.depth_samples.append(depth)
        _metrics.MICROBATCH_DISPATCHES.inc(batcher=lane.name)
        _metrics.MICROBATCH_QUERIES.inc(amount=len(group), batcher=lane.name)
        _metrics.MICROBATCH_BATCH_SIZE.observe(len(group), batcher=lane.name)
        _metrics.MICROBATCH_TRIGGERS.inc(batcher=lane.name, trigger=trigger)
        _metrics.MICROBATCH_FILL.observe(len(group) / lane.max_batch,
                                         batcher=lane.name)
        _metrics.MICROBATCH_QUEUE_AT_DISPATCH.observe(depth,
                                                      batcher=lane.name)


def _k_buckets(srv: "DeviceTopK",
               group: List[_Pending]) -> List[List[_Pending]]:
    """The group split by k bucket (k as the store rounds it), so each
    part dispatches at its own k: one wide query (a category query asks
    for num + |complement|) does not send the narrow rows through the
    wide sort."""
    parts: Dict[int, List[_Pending]] = {}
    for it in group:
        parts.setdefault(min(_bucket(it.k), srv.n_items), []).append(it)
    return list(parts.values())


def _answer(part: List[_Pending], idx: np.ndarray, scores: np.ndarray) -> None:
    # the launch just recorded on this thread (telemetry on) goes to
    # every waiter of the part through the shared result
    res = _BatchResult(idx, scores, telemetry=_dtel.last_record()
                       if _dtel.enabled() else None)
    for row, it in enumerate(part):
        if not it.future.done():
            it.future.set_result((res, row))


def _dispatch_user_group(srv: "DeviceTopK", group: List[_Pending]) -> None:
    """Per-user top-k requests -> one ``users_topk`` dispatch per k
    bucket."""
    for part in _k_buckets(srv, group):
        uids = np.asarray([it.payload for it in part], dtype=np.int64)
        _answer(part, *srv.users_topk(uids, max(it.k for it in part)))


def _dispatch_item_group(srv: "DeviceTopK", group: List[_Pending]) -> None:
    """Item-similarity requests (each a tuple of query-item indices) ->
    one ``_items_topk_batched`` dispatch per k bucket; each row's item
    list pads to its part's common power-of-two length."""
    for part in _k_buckets(srv, group):
        B = srv.ITEM_QUERY_BUCKET
        while B < max(len(it.payload) for it in part):
            B *= 2
        idxs = np.zeros((len(part), B), dtype=np.int32)
        masks = np.zeros((len(part), B), dtype=np.float32)
        for row, it in enumerate(part):
            m = len(it.payload)
            idxs[row, :m] = np.asarray(it.payload, dtype=np.int32)
            masks[row, :m] = 1.0
        _answer(part, *srv._items_topk_batched(
            idxs, masks, max(it.k for it in part)))


class DeviceTopK:
    """Top-N server over factor tables resident on one device.

    ``user_factors``/``item_factors`` are numpy arrays, tensors, or
    :class:`QuantFactors`; they are copied to ``device`` (None = cuda).
    The store's precision is ``PIO_SERVE_PRECISION`` when set, else bf16
    on the GPU and fp32 on the CPU; an input that is already int8 with
    scales stays int8. Scores always accumulate and return in fp32.

    Concurrent ``user_topk``/``items_topk`` callers are micro-batched
    into one dispatch each (``microbatch=False`` or
    ``PIO_SERVING_MICROBATCH=0`` dispatches per call).

    The user store is LIVE-PATCHABLE (:meth:`patch_users`, online
    fold-in): a user dispatch enqueues its gathers of the user rows and
    seen rows under ``_store_lock``, and a patch enqueues its writes
    under the same lock, so each query reads the whole store as one
    patch left it, never a torn mix (see :meth:`patch_users`)."""

    ITEM_QUERY_BUCKET = 8  # padded query-item count for similarity queries

    def __init__(self, user_factors, item_factors,
                 seen: Optional[Dict[int, np.ndarray]] = None,
                 n_users: Optional[int] = None,
                 n_items: Optional[int] = None,
                 microbatch: Optional[bool] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._yn_lock = threading.Lock()
        self._store_lock = threading.RLock()
        # one entry per patch that grew the store: the shapes before and
        # after, the seconds the patch held _store_lock and, on the card,
        # the seconds of stream time its writes occupy
        self.growths: List[Dict[str, Any]] = []
        if microbatch is None:
            microbatch = os.environ.get(
                "PIO_SERVING_MICROBATCH",
                "1").strip().lower() not in ("0", "off", "false")
        self._dispatcher: Optional[BatchDispatcher] = None
        self._batcher: Optional[BatchLane] = None
        self._item_batcher: Optional[BatchLane] = None
        if microbatch:
            self._dispatcher = BatchDispatcher(self)
            self._batcher = self._dispatcher.add_lane(
                "pio-microbatch", max_batch=256,
                dispatch_fn=_dispatch_user_group)
            self._item_batcher = self._dispatcher.add_lane(
                "pio-microbatch-items", max_batch=64,
                dispatch_fn=_dispatch_item_group)

        explicit = _serve_precision_explicit()
        mode = explicit or default_serve_precision(self.device)
        if is_quantized(user_factors) or is_quantized(item_factors):
            mode = "int8"
        self._mode = mode
        self._X = self._store(user_factors)
        self._Y = self._store(item_factors)
        self.n_users = int(n_users if n_users is not None
                           else self._X.shape[0])
        self.n_items = int(n_items if n_items is not None
                           else self._Y.shape[0])
        self._Y = _pad_item_rows_for_kernel(self._Y)
        self._mask_seen = bool(seen)
        self._seen_cols = self._seen_mask = None
        if self._mask_seen:
            cols, mask = seen_tables(seen, int(self._X.shape[0]))
            self._seen_cols = torch.from_numpy(cols).to(self.device)
            self._seen_mask = torch.from_numpy(mask).to(self.device)
        self._Yn = None  # normalized item table, built on first item query
        _live_servers.add(self)

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _store(self, f):
        """One factor table in the store's precision, on the device."""
        if is_quantized(f):
            return QuantFactors(self._to_device(f.data).to(torch.int8),
                                self._to_device(f.scale).float())
        t = self._to_device(f)
        if self._mode == "int8":
            return quantize_rows_int8(t)
        return t.to(torch.bfloat16 if self._mode == "bf16" else torch.float32)

    @property
    def precision(self) -> str:
        return self._mode

    def warmup(self) -> None:
        """Build the kernel (first use compiles it) and run one query per
        lane, so the first real query pays neither."""
        kmin = min(16, self.n_items)
        self._user_topk_direct(0, kmin)
        self._items_topk_direct([0], kmin)

    def close(self) -> None:
        """Release the micro-batch dispatcher (answers pending queries;
        idempotent)."""
        if self._dispatcher is not None:
            self._dispatcher.close()

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Micro-batcher counters (consistent snapshots; also exported
        process-wide as the ``pio_microbatch_*`` families)."""
        out: Dict[str, Dict[str, Any]] = {}
        if self._batcher is not None:
            out["users"] = self._batcher.stats()
        if self._item_batcher is not None:
            out["items"] = self._item_batcher.stats()
        return out

    def store_bytes(self) -> int:
        """Device bytes the store holds: both factor tables (with int8
        scales), the seen tables and the normalized item table once
        built."""
        with self._store_lock:
            tables = (self._X, self._Y, self._seen_cols, self._seen_mask,
                      self._Yn)
        total = 0
        for t in tables:
            if t is None:
                continue
            if is_quantized(t):
                total += t.data.nbytes + t.scale.nbytes
            else:
                total += t.nbytes
        return total

    # -- serving ----------------------------------------------------------

    def _timed_fetch(self, lane: str, kb: int, batch: int,
                     launch: Callable[[Optional[Tuple]],
                                      Tuple[torch.Tensor, torch.Tensor]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """``launch(events)`` (one launch of the serving kernel) and its
        copy back. With telemetry on, recorded as one dispatch and one
        ``device.execute`` span: ``hostUs`` is the host's window from the
        launch to the end of the copy back; ``deviceUs`` the time between
        two CUDA events the launch records on its stream just around the
        kernels, read once the copy back (which the query waits for
        anyway) has completed, so timing adds no synchronisation. The
        JAX package times this window on the host clock around
        ``block_until_ready`` instead. On the CPU there are no events:
        no device time is recorded, and the span says so. Telemetry off
        is the killed lane: no clock, no event."""
        if not _dtel.enabled():
            return self._fetch(*launch(None))
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = _tracing.span_now()
        out = self._fetch(*launch(events))
        t1 = _tracing.span_now()
        device_us = (None if events is None
                     else events[0].elapsed_time(events[1]) * 1e3)
        rec = _dtel.record_dispatch(
            lane=lane, kernel=als_cuda.last_route() or "?",
            precision=self._mode, aot="jit", k_bucket=kb, batch=batch,
            bucket=batch, host_us=(t1 - t0) * 1e6, device_us=device_us,
            started_epoch=t0)
        # {} when the recorder was switched off during this launch
        attributes = dict(rec or {})
        if events is None:
            attributes["deviceTiming"] = (
                "none: no CUDA events on the CPU (the kernel's plain "
                "version)")
        ctx = _dtel.current_dispatch_context() or {}
        _tracing.record_completed_span(
            "device.execute", start=t0, end=t1, attributes=attributes,
            parent=ctx.get("traceParent"))
        return out

    def _fetch(self, vals: torch.Tensor, idx: torch.Tensor
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(idx, scores) on the host through ONE device-to-host copy:
        the indices travel bitcast inside the score buffer."""
        kb = vals.shape[1]
        packed = torch.cat([vals, idx.view(torch.float32)], dim=1).cpu().numpy()
        return packed[:, kb:].view(np.int32), packed[:, :kb]

    def user_topk(self, uid: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(item indices, scores) for one user, descending; seen items
        are masked on the device. Concurrent callers share one dispatch.
        The ``device.user_topk`` span covers submit to result."""
        with _trace_span("device.user_topk", attributes={"k": int(k)}) as sp:
            if self._batcher is not None:
                return self._batcher.submit(int(uid), int(k), span=sp)
            return self._user_topk_direct(uid, k)

    def _user_topk_direct(self, uid: int,
                          k: int) -> Tuple[np.ndarray, np.ndarray]:
        idx, scores = self._users_topk(np.asarray([uid]), k, "user")
        idx, scores = idx[0], scores[0]
        valid = np.isfinite(scores)
        return idx[valid], scores[valid]

    def users_topk(self, uids, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for a vector of user indices: ONE kernel launch and ONE
        copy back for the whole batch. Returns ``(idx [B, k] int32,
        scores [B, k] float32)`` rows descending; rows may hold -inf
        past the valid candidates (callers filter per row). k rounds up
        to a power-of-two bucket, capped at n_items, as in the
        reference."""
        uids = np.asarray(uids, dtype=np.int64)
        with _trace_span("device.users_topk",
                         attributes={"batch": len(uids), "k": int(k)}):
            return self._users_topk(uids, k, "users")

    def _users_topk(self, uids: np.ndarray, k: int,
                    lane: str) -> Tuple[np.ndarray, np.ndarray]:
        kb = min(_bucket(k), self.n_items)
        u = torch.from_numpy(np.asarray(uids, dtype=np.int64)).to(self.device)
        sc = sm = None
        # the gathers are enqueued under the lock a patch enqueues its
        # writes under (see patch_users): Q and the seen rows are one
        # patch's state, and the kernel reads only them and the item
        # table, which no patch touches
        with self._store_lock:
            if self._mask_seen:  # the [B, L] rows, read as [L, B] views
                sc, sm = self._seen_cols[u].T, self._seen_mask[u].T
            Q = _gather_rows_f32(self._X, u)
        idx, scores = self._timed_fetch(
            lane, kb, len(uids), lambda events: fused_gather_score_topk(
                Q, self._Y, sc, sm, k=kb, n_items=self.n_items,
                mask_seen=self._mask_seen, events=events))
        return idx[:, :k], scores[:, :k]

    def items_topk(self, idxs, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Item-similarity top-k (summed cosine) for a list of query item
        indices; the query items never recommend themselves."""
        with _trace_span("device.items_topk",
                         attributes={"items": len(idxs), "k": int(k)}) as sp:
            if self._item_batcher is not None:
                return self._item_batcher.submit(
                    tuple(int(i) for i in idxs), int(k), span=sp)
            return self._items_topk_direct(idxs, k)

    def _items_topk_direct(self, idxs,
                           k: int) -> Tuple[np.ndarray, np.ndarray]:
        B = self.ITEM_QUERY_BUCKET
        while B < len(idxs):
            B *= 2
        pad_idx = np.zeros((1, B), dtype=np.int32)
        pad_mask = np.zeros((1, B), dtype=np.float32)
        pad_idx[0, :len(idxs)] = np.asarray(idxs, dtype=np.int32)
        pad_mask[0, :len(idxs)] = 1.0
        idx, scores = self._items_topk_batched(pad_idx, pad_mask, k)
        idx, scores = idx[0, :k], scores[0, :k]
        valid = np.isfinite(scores)
        return idx[valid], scores[valid]

    def _normalized_items(self):
        """Row-normalized item table for similarity queries, built once
        on first use."""
        with self._yn_lock:
            if self._Yn is None:
                self._Yn = _normalize_rows(self._Y)
            return self._Yn

    def _items_topk_batched(self, idxs: np.ndarray, masks: np.ndarray,
                            k: int) -> Tuple[np.ndarray, np.ndarray]:
        """A [G, B] bucket of item queries, one launch: each group's
        summed normalized query row is scored against every item, with
        its query items masked (they play the seen table's role)."""
        kb = min(_bucket(k), self.n_items)
        # out-of-range query item ids drop from the query (mask 0)
        in_range = (idxs >= 0) & (idxs < self.n_items)
        if not in_range.all():
            masks = masks * in_range.astype(masks.dtype)
            idxs = np.where(in_range, idxs, 0).astype(idxs.dtype)
        Yn = self._normalized_items()
        it = torch.from_numpy(np.ascontiguousarray(idxs, dtype=np.int32)
                              ).to(self.device)
        mt = torch.from_numpy(np.ascontiguousarray(masks, dtype=np.float32)
                              ).to(self.device)
        qf = _gather_rows_f32(Yn, it.long())                 # [G, B, R]
        Q = (qf * mt[..., None]).sum(dim=1)                  # [G, R]
        return self._timed_fetch(
            "items", kb, int(idxs.shape[0]),
            lambda events: fused_gather_score_topk(
                Q, Yn, it.T, mt.T, k=kb, n_items=self.n_items,
                mask_seen=True, events=events))

    # -- live store patching (online fold-in) ------------------------------

    @property
    def item_factors(self) -> torch.Tensor:
        """The item factors as served, which the fold-in solve holds
        fixed: the store's first ``n_items`` rows (the kernel's tile
        padding cut off) as a contiguous fp32 ``[n_items, R]`` tensor on
        the store's device, the layout the assembly kernel takes. A bf16
        store casts through fp32; an int8 store dequantizes with its
        per-row scales. Built per access, never cached: an fp32 copy kept
        beside a bf16 or int8 store would hold more device memory than
        the narrow store saves, and fold-in reads it once a fold."""
        return self.item_factors_as(torch.float32)

    def item_factors_as(self, dtype: torch.dtype) -> torch.Tensor:
        """:attr:`item_factors` in ``dtype`` (fp32 or bf16, the fold's
        training precision): a dense store of that dtype hands over its
        first ``n_items`` rows as they are (a view, no copy: a bf16 fold
        against a bf16 store reads the served rows directly); any other
        store is cast through fp32."""
        with self._store_lock:
            Y = self._Y
        n = self.n_items
        if is_quantized(Y):
            Yn = dequantize_rows(QuantFactors(Y.data[:n], Y.scale[:n]))
        else:
            Yn = Y[:n]
        if Yn.dtype != dtype:
            Yn = Yn.float().to(dtype)
        return Yn.contiguous()

    @property
    def user_capacity(self) -> int:
        """Allocated user rows (>= ``n_users``; grows along the ladder)."""
        with self._store_lock:
            return int(self._X.shape[0])

    @property
    def growable(self) -> bool:
        """Whether :meth:`patch_users` can grow the user store: always."""
        return True

    def patch_users(self, uids, factors,
                    seen_items: Optional[Dict[int, np.ndarray]] = None
                    ) -> None:
        """Write freshly solved user rows into the LIVE store (the online
        fold-in write path: no ``/reload``, no retrain).

        ``uids`` may index past the capacity: the store then grows along
        the power-of-two ladder (``_bucket(needed, lo=max(cap, 16))``;
        grown rows are zero, int8 scales 1, until patched). ``factors``
        rows are cast to the store's dtype, or, in an int8 store,
        re-quantized with recomputed per-row scales, so a patched row is
        what quantizing the updated factors at load would give.
        ``seen_items`` replaces the users' seen rows with their full item
        sets; the seen tables grow in rows with the store (grown rows
        mask nothing) and in row length along the same ladder.

        Ordering on the card: the dispatcher thread and the fold-in
        thread both launch on the device's default stream (neither sets
        a stream), and a stream runs its work in the order it was
        enqueued. A query enqueues its gathers of the user and seen rows
        under ``_store_lock`` (``_users_topk``), and this method enqueues
        its writes under the same lock, so every query's gathers run
        wholly before or wholly after a patch's writes: rows are
        rewritten in place (``index_copy_``) without tearing. What can
        fail, the host-side rows, their copies to the card and a grown
        store's allocation and copy, is done before any write to a live
        table or reference; the seen tables are published before the
        user rows (new rows with short seen tables would let a grown uid
        read past them), then ``n_users`` rises. A grown store's old
        tables are freed to the caching allocator on the same stream,
        after the gathers already enqueued on them. Each growth records
        in ``growths`` its shapes, the seconds the patch held the lock
        (``lockSec``, host time: the copies are enqueued, not waited on)
        and, on the card, ``deviceSec``: the stream time between two CUDA
        events, one recorded when the lock is taken and one after the last
        write, which a query enqueued after the patch waits behind (a
        query kernel launched meanwhile, outside the lock, counts in it).
        This method waits for the second event after it releases the
        lock."""
        uids = np.asarray(uids, dtype=np.int64)
        factors = np.asarray(factors, dtype=np.float32)
        if factors.ndim != 2 or len(uids) != factors.shape[0]:
            raise ValueError(
                f"patch_users: {len(uids)} uids vs factors "
                f"{factors.shape}")
        if not len(uids):
            return
        if uids.min() < 0:
            raise ValueError("patch_users: negative user index")
        dev = self.device
        idx = torch.from_numpy(uids).to(dev)
        if self._mode == "int8":
            q = quantize_rows_int8_np(factors)
            rows = QuantFactors(torch.from_numpy(q.data).to(dev),
                                torch.from_numpy(q.scale).to(dev))
        else:
            rows = torch.from_numpy(factors).to(dev).to(
                torch.bfloat16 if self._mode == "bf16" else torch.float32)
        needed = int(uids.max()) + 1
        events = None
        if dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        grown = None
        with self._store_lock:
            t0 = time.perf_counter()
            if events is not None:
                events[0].record()
            X = self._X
            cap = int(X.shape[0])
            if needed > cap:
                new_cap = _bucket(needed, lo=max(cap, 16))
                if is_quantized(X):
                    X = QuantFactors(
                        _grown(X.data, (new_cap, X.data.shape[1])),
                        _grown(X.scale, (new_cap,), 1.0))
                else:
                    X = _grown(X, (new_cap, X.shape[1]))
            seen_before = None if self._seen_cols is None \
                else tuple(self._seen_cols.shape)
            seen_prep = None
            if self._mask_seen and (
                    seen_items or X.shape[0] > self._seen_cols.shape[0]):
                # a seen-less growth grows the seen tables too: a grown
                # uid must find a row of its own (masking nothing)
                seen_prep = self._prep_seen_locked(seen_items or {},
                                                   int(X.shape[0]))
            if seen_prep is not None:
                cols, mask, sids, row_c, row_m = seen_prep
                cols.index_copy_(0, sids, row_c)
                mask.index_copy_(0, sids, row_m)
                self._seen_cols, self._seen_mask = cols, mask
            if is_quantized(X):
                X.data.index_copy_(0, idx, rows.data)
                X.scale.index_copy_(0, idx, rows.scale)
            else:
                X.index_copy_(0, idx, rows)
            self._X = X
            self.n_users = max(self.n_users, needed)
            seen_after = None if self._seen_cols is None \
                else tuple(self._seen_cols.shape)
            if int(X.shape[0]) != cap or seen_after != seen_before:
                if events is not None:
                    events[1].record()
                grown = {"rows": [cap, int(X.shape[0])],
                         "seenShape": [seen_before, seen_after],
                         "lockSec": time.perf_counter() - t0}
                self.growths.append(grown)
        if grown is not None and events is not None:
            events[1].synchronize()
            grown["deviceSec"] = events[0].elapsed_time(events[1]) / 1e3

    def _prep_seen_locked(self, seen_items: Dict[int, np.ndarray],
                          n_rows: int):
        """The seen tables to publish (grown to ``n_rows`` rows and to
        the row length the longest new list needs, as new tables, or the
        live ones when they suffice) and the touched users' replacement
        rows on the card. Caller holds ``_store_lock``."""
        cols, mask = self._seen_cols, self._seen_mask
        rows, L = (int(n) for n in cols.shape)
        longest = max((len(v) for v in seen_items.values()), default=0)
        new_L = _bucket(max(longest, 1), lo=L)
        if new_L > L or n_rows > rows:
            shape = (max(n_rows, rows), new_L)
            cols, mask = _grown(cols, shape), _grown(mask, shape)
        sids = np.fromiter(seen_items.keys(), dtype=np.int64,
                           count=len(seen_items))
        row_c = np.zeros((len(sids), new_L), dtype=np.int32)
        row_m = np.zeros((len(sids), new_L), dtype=np.float32)
        for i, uid in enumerate(sids):
            items = np.asarray(seen_items[int(uid)], dtype=np.int32)
            row_c[i, :len(items)] = items
            row_m[i, :len(items)] = 1.0
        dev = self.device
        return (cols, mask, torch.from_numpy(sids).to(dev),
                torch.from_numpy(row_c).to(dev),
                torch.from_numpy(row_m).to(dev))


_live_servers: "weakref.WeakSet[DeviceTopK]" = weakref.WeakSet()


def batcher_stats() -> List[Dict[str, Any]]:
    """Every live micro-batch lane's stats, process-wide: the
    ``/stats.json`` ``batchers`` list."""
    out: List[Dict[str, Any]] = []
    for srv in list(_live_servers):
        out.extend(srv.stats().values())
    return out


def _live_store_bytes() -> float:
    """Device bytes held by the live stores (the pull source of
    ``pio_device_store_bytes``)."""
    return float(sum(srv.store_bytes() for srv in list(_live_servers)))


# a pull gauge: read at scrape time from whatever servers are live
_metrics.DEVICE_STORE_BYTES.set_function(_live_store_bytes)


def device_report() -> Dict[str, Any]:
    """The ``/stats.json`` ``device`` block: each live store's bytes and
    precision, and the flight recorder's counts and per-lane dispatch
    summary (the JAX package's block without its ladder entries)."""
    stores = []
    for srv in list(_live_servers):
        with srv._store_lock:  # n_users and the tables of one patch
            stores.append({"precision": srv.precision,
                           "nUsers": srv.n_users, "nItems": srv.n_items,
                           "totalBytes": srv.store_bytes()})
    rec = _dtel.recorder()
    return {"telemetry": {"enabled": rec.enabled, **rec.counts()},
            "storeBytes": sum(st["totalBytes"] for st in stores),
            "stores": stores,
            "dispatch": rec.summary()}
