"""Top-N serving: the device store on one GPU or over shards, and the
host lane.

The port's counterpart of ``predictionio_tpu/ops/serving.py``. In
:class:`DeviceTopK` the factor tables live on the card (fp32, bf16 or
int8 with per-row scales), and every query batch is one call of the
fused score -> mask -> top-k kernel (:mod:`.als_cuda`), whose k winners
come back to the host in one copy. Concurrent single queries are
micro-batched by :class:`BatchDispatcher`.

A sharded store (an ``item_layout``, ``shards`` or ``PIO_SERVE_SHARDS``
over a plane of several devices, which may name one card several times)
holds its items in a density-aware layout, one block a shard on its
device: each dispatch launches the kernel once per shard and merges the
shards' lists stably, the lower shard first on a tie
(:func:`_sharded_score_topk`, :func:`_tree_merge_topk`).

:class:`HostTopK` is the host lane, numpy as in the JAX package;
:func:`choose_server` picks a lane by ``PIO_SERVING_BACKEND``, the
serving-policy table (:func:`validate_serving_policy`) and the size
limit :data:`HOST_SERVE_MAX_ELEMS`.

Each launch of the serving kernel is recorded by the device flight
recorder (:mod:`~predictionio_tpu_torch.utils.device_telemetry`) and as a
``device.execute`` span under the query's ``device.*`` span; the
micro-batcher feeds the ``pio_microbatch_*`` families.

The user store is live-patchable (:meth:`DeviceTopK.patch_users`, the
write path of online fold-in): rows are rewritten in place and the
store grows along the power-of-two ladder, under the store lock every
dispatch snapshots under.

:meth:`DeviceTopK.memory_report` and :func:`device_report` give the
``/stats.json`` device block in the JAX package's shape.

The serving ladder (the JAX package's AOT ladder): :meth:`DeviceTopK.
warmup` captures every program live traffic can dispatch, one per
``(lane, k bucket, batch bucket)`` entry of :meth:`DeviceTopK.aot_plan`,
as a CUDA graph that launches B1 from inside it (:mod:`.aot`). A
dispatch looks its entry up under the store signature (the shapes and
the device addresses of every table the graphs read), copies its inputs
into the graph's static buffers, replays it and copies the result out;
an entry the ladder lacks runs eagerly, counted as ``missJit``.
``PIO_SERVE_AOT=0`` captures nothing. :meth:`DeviceTopK.ladder_report`
gives the coverage, the lookups and the graphs' measured device bytes.
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
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import (
    DeviceLike,
    default_serve_precision,
    resolve_device,
)
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.ops.als_cuda import TOPK_TILE_M, fused_gather_score_topk
from predictionio_tpu_torch.ops.aot import AOTCache, capture
from predictionio_tpu_torch.ops.quantize import (
    QuantFactors,
    dequantize_rows,
    dequantize_rows_np,
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


def _serve_shards_env() -> int:
    """``PIO_SERVE_SHARDS``: shard the device store's items over this
    many devices (a density-aware layout from the seen sets). 0 or unset
    keeps one store. Like the bf16 / int8 stores it is a device policy:
    a value > 1 forces the device backend under ``auto`` and conflicts
    with an explicit ``host``. A non-integer raises."""
    raw = os.environ.get("PIO_SERVE_SHARDS", "").strip()
    if not raw:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"PIO_SERVE_SHARDS={raw!r} is not an integer shard count")
    return max(0, n)


def foldin_enabled() -> bool:
    """``PIO_FOLDIN``, set while a query server deploys with fold-in
    (``pio deploy --foldin on`` or ``ServerConfig(foldin=True)``) and
    readable by embedders: the deployed server runs the online fold-in
    consumer, which needs the updatable :class:`DeviceTopK` store, so
    the flag forces the device backend (:func:`choose_server`)."""
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


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under the JAX package's (numpy's) name:
    ``float32``, ``bfloat16``, ``int8``."""
    return str(dtype).rsplit(".", 1)[-1]


def _component(f) -> Optional[Dict[str, Any]]:
    """One table's entry of :meth:`DeviceTopK.memory_report`."""
    if f is None:
        return None
    if is_quantized(f):
        return {"bytes": int(f.data.nbytes),
                "scaleBytes": int(f.scale.nbytes),
                "dtype": _dtype_name(f.data.dtype),
                "scaleDtype": _dtype_name(f.scale.dtype),
                "shape": [int(d) for d in f.data.shape]}
    return {"bytes": int(f.nbytes), "scaleBytes": 0,
            "dtype": _dtype_name(f.dtype),
            "shape": [int(d) for d in f.shape]}


def _joined_component(blocks) -> Dict[str, Any]:
    """The :func:`_component` of a sharded table: its blocks' bytes
    summed, its shape the blocks stacked."""
    parts = [_component(b) for b in blocks]
    out = dict(parts[0])
    out["bytes"] = sum(p["bytes"] for p in parts)
    out["scaleBytes"] = sum(p["scaleBytes"] for p in parts)
    out["shape"] = [sum(p["shape"][0] for p in parts)] + parts[0]["shape"][1:]
    return out


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


def _pack(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, 2k]`` fp32: the scores, then the indices bitcast, so the
    host fetches both in ONE device-to-host copy."""
    return torch.cat([vals, idx.view(torch.float32)], dim=1)


def _table_sig(t) -> Optional[Tuple]:
    """A table's shape, dtype and device address (with its scales' for
    an int8 table): what a captured graph reads from it."""
    if t is None:
        return None
    if is_quantized(t):
        return ("int8q", _table_sig(t.data), _table_sig(t.scale))
    return (tuple(t.shape), str(t.dtype), str(t.device), t.data_ptr())


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


def _host_array(f) -> np.ndarray:
    """A factor table as a host numpy array: a tensor (any device, any
    float dtype) comes over as fp32; numpy input is kept as it is."""
    if isinstance(f, torch.Tensor):
        return f.detach().to("cpu", torch.float32).numpy()
    return np.asarray(f)


def _is_bf16(arr) -> bool:
    """A numpy bfloat16 array (ml_dtypes-backed), by its dtype's name."""
    return getattr(getattr(arr, "dtype", None), "name", "") == "bfloat16"


class HostTopK:
    """Host-memory top-N server with :class:`DeviceTopK`'s interface:
    a numpy matvec and ``argpartition`` per query, no device round trip.
    The port's copy of the JAX package's ``HostTopK`` (the same numpy
    arithmetic, so the same ids and fp32 scores). :func:`choose_server`
    picks it for host factors of at most :data:`HOST_SERVE_MAX_ELEMS`
    item-factor elements, or when ``PIO_SERVING_BACKEND=host`` asks.

    An int8 + scales store is dequantized and a bf16 one widened: the
    host lane always scores fp32. A tensor (the port's one extra case)
    is taken to a CPU fp32 array. Ties are not broken toward the lowest
    id: ``argpartition`` picks the k winners and a stable sort orders
    them, as in the JAX package."""

    def __init__(self, user_factors, item_factors,
                 seen: Optional[Dict[int, np.ndarray]] = None,
                 n_users: Optional[int] = None,
                 n_items: Optional[int] = None):
        if is_quantized(user_factors):
            user_factors = dequantize_rows_np(QuantFactors(
                _host_array(user_factors.data),
                _host_array(user_factors.scale)))
        if is_quantized(item_factors):
            item_factors = dequantize_rows_np(QuantFactors(
                _host_array(item_factors.data),
                _host_array(item_factors.scale)))
        self._X = _host_array(user_factors)
        self._Y = _host_array(item_factors)
        if _is_bf16(self._X):
            self._X = self._X.astype(np.float32)
        if _is_bf16(self._Y):
            self._Y = self._Y.astype(np.float32)
        self.n_users = int(n_users if n_users is not None
                           else self._X.shape[0])
        self.n_items = int(n_items if n_items is not None
                           else self._Y.shape[0])
        self._seen = seen or {}
        self._Yn: Optional[np.ndarray] = None

    def warmup(self, max_k: int = 128, batch_sizes: Tuple[int, ...] = ()
               ) -> None:
        """Nothing to build on the host."""

    def close(self) -> None:
        """Nothing to release (interface parity with DeviceTopK)."""

    def stats(self) -> Dict[str, Dict[str, int]]:
        """No micro-batcher on the host."""
        return {}

    def _topk_row(self, scores: np.ndarray, k: int):
        k = min(k, scores.shape[0])
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top], kind="stable")]
        s = scores[top]
        valid = np.isfinite(s)
        return top[valid].astype(np.int32), s[valid]

    def _user_scores(self, uid: int) -> np.ndarray:
        scores = self._Y[:self.n_items] @ self._X[uid]
        s = self._seen.get(uid)
        if s is not None and len(s):
            scores[s[s < self.n_items]] = -np.inf
        return scores

    def user_topk(self, uid: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._topk_row(self._user_scores(uid), k)

    def users_topk(self, uids, k: int) -> Tuple[np.ndarray, np.ndarray]:
        uids = np.asarray(uids, dtype=np.int64)
        k = min(k, self.n_items)
        idx = np.zeros((len(uids), k), dtype=np.int32)
        scores = np.full((len(uids), k), -np.inf, dtype=np.float32)
        for row, uid in enumerate(uids):
            i, s = self._topk_row(self._user_scores(int(uid)), k)
            idx[row, :len(i)] = i
            scores[row, :len(s)] = s
        return idx, scores

    def items_topk(self, idxs, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._Yn is None:
            Y = self._Y[:self.n_items].astype(np.float32)
            norms = np.maximum(np.linalg.norm(Y, axis=1, keepdims=True),
                               1e-12)
            self._Yn = Y / norms
        idxs = np.asarray(idxs, dtype=np.int64)
        scores = self._Yn @ self._Yn[idxs].sum(axis=0)
        scores[idxs] = -np.inf
        return self._topk_row(scores, k)


# Item-factor elements up to which `auto` serves host factors from
# HostTopK, from ten readings of chip_smoke.py phase 8a on an NVIDIA
# H100 80GB HBM3 (power limit 700.00 W) and its 8-core host: fp32
# factors at rank 64, the device store micro-batched with its 2 ms
# window. The largest power of two up to which the host lane was no
# slower both in sequential p50 and in queries/s from 8 threads read
# 2^17 once, 2^20 three times and 2^21 six times: 2^20 held in nine
# readings of ten, 2^21 in six, its margin inside the host's spread
# (at 2^21 the host lane 1,122-3,791 q/s against 1,498-2,398). The host
# lane's sequential p50 was the lower at every size up to 2^21
# (0.045-0.32 ms against 3.2-4.8). The same rule picks a host model's
# batch lane, where HostTopK loops over users: one users_topk of 6,040
# uids took 325-457 ms at 3,706 items and 672-829 ms at 2^20 elements,
# against the device store's 1.4-1.9 and 3.4-3.8, so the limit stays
# at the lower value and ML-20M width (1,711,616) stays on the card.
HOST_SERVE_MAX_ELEMS = 1 << 20


# The serving-policy table: each feature that forces the device backend,
# and so conflicts with an explicit host backend, as a row of (name,
# predicate over the policy flags, the message an explicit
# ``PIO_SERVING_BACKEND=host`` raises when the row is active). Rows,
# messages and their order are the JAX package's.
_SERVING_POLICY_ROWS: Tuple[Tuple[str, Callable[[Dict[str, Any]], bool],
                                  str], ...] = (
    ("resident",
     lambda f: not f["host_capable"],
     "PIO_SERVING_BACKEND=host but the factors are device-resident "
     "jax Arrays"),
    ("precision",
     lambda f: f["explicit_precision"] in ("bf16", "int8"),
     "PIO_SERVE_PRECISION={explicit_precision} conflicts with "
     "PIO_SERVING_BACKEND=host: the quantized/bf16 store is a device "
     "(HBM) policy; host serving is always fp32"),
    ("foldin",
     lambda f: f["foldin"],
     "PIO_FOLDIN=on conflicts with PIO_SERVING_BACKEND=host: "
     "online fold-in patches the DEVICE factor store in place "
     "(DeviceTopK.patch_users); host serving has no updatable "
     "store"),
    ("sharded",
     lambda f: f["sharded"],
     "PIO_SERVE_SHARDS conflicts with PIO_SERVING_BACKEND="
     "host: sharding the factor store over a mesh is a "
     "device (HBM) policy; host serving has one store"),
    ("two_stage",
     lambda f: f["two_stage"],
     "two-stage serving conflicts with PIO_SERVING_BACKEND=host: the "
     "fused retrieval + re-rank top-k runs as ONE device program "
     "(TwoStageTopK); host serving has no fused candidate lane"),
)


def validate_serving_policy(backend: str, *, host_capable: bool = True,
                            explicit_precision: Optional[str] = None,
                            foldin: bool = False, sharded: bool = False,
                            two_stage: bool = False) -> str:
    """Rule on one backend / feature combination against
    :data:`_SERVING_POLICY_ROWS`: ``"host"`` (asked for, and no row
    forbids it), ``"device"`` (asked for, or an active row forces it) or
    ``"auto"`` (nothing decided: the caller applies its size rule). An
    explicit ``host`` raises ``ValueError`` with the first active row's
    message. An unknown backend falls through to ``auto``."""
    flags = {"host_capable": bool(host_capable),
             "explicit_precision": explicit_precision,
             "foldin": bool(foldin), "sharded": bool(sharded),
             "two_stage": bool(two_stage)}
    active = [row for row in _SERVING_POLICY_ROWS if row[1](flags)]
    if backend == "host":
        if active:
            raise ValueError(active[0][2].format(**flags))
        return "host"
    if backend == "device" or active:
        return "device"
    return "auto"


def _on_cuda(f) -> bool:
    """Whether a factor table is a tensor on a CUDA device."""
    t = f.data if is_quantized(f) else f
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


def serving_backend() -> str:
    """``PIO_SERVING_BACKEND``, trimmed and lower-cased (default auto)."""
    return os.environ.get("PIO_SERVING_BACKEND", "auto").strip().lower()


def choose_server(user_factors, item_factors,
                  seen: Optional[Dict[int, np.ndarray]] = None,
                  n_users: Optional[int] = None,
                  n_items: Optional[int] = None,
                  device=None):
    """The server for a model, by ``PIO_SERVING_BACKEND``:

    - ``host``: :class:`HostTopK`, unless a policy row forbids it (then
      ``ValueError`` with the row's message);
    - ``device``: :class:`DeviceTopK` on ``device`` (None = cuda; a
      sequence of devices or a :class:`~predictionio_tpu_torch.parallel.
      mesh.Mesh` is the plane a sharded store spans);
    - ``auto`` (or any other value): the device store when a policy row
      forces it (an explicit bf16 / int8 ``PIO_SERVE_PRECISION``,
      ``PIO_FOLDIN``, ``PIO_SERVE_SHARDS`` > 1, or factors already on a
      CUDA device), else HostTopK for at most
      :data:`HOST_SERVE_MAX_ELEMS` item-factor elements and the device
      store above."""
    host_capable = not (_on_cuda(user_factors) or _on_cuda(item_factors))
    decision = validate_serving_policy(
        serving_backend(), host_capable=host_capable,
        explicit_precision=_serve_precision_explicit(),
        foldin=foldin_enabled(), sharded=_serve_shards_env() > 1)
    if decision == "auto":
        elems = int(np.prod(item_factors.shape))
        decision = "host" if host_capable \
            and elems <= HOST_SERVE_MAX_ELEMS else "device"
    if decision == "host":
        return HostTopK(user_factors, item_factors, seen,
                        n_users=n_users, n_items=n_items)
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


def _serve_aot_enabled() -> bool:
    """``PIO_SERVE_AOT`` (default on): capture the serving ladder at
    warm-up. Off, every ladder entry falls back and runs eagerly, which
    :meth:`DeviceTopK.warmup` does once for each."""
    return os.environ.get("PIO_SERVE_AOT", "1").strip().lower() \
        not in ("0", "off", "false")


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
    list pads to its part's common power-of-two length, the rows to a
    power-of-two bucket of at least 8 (a ladder entry; the padding rows
    query nothing and are never answered)."""
    for part in _k_buckets(srv, group):
        B = srv.ITEM_QUERY_BUCKET
        while B < max(len(it.payload) for it in part):
            B *= 2
        G = _bucket(len(part), lo=8)
        idxs = np.zeros((G, B), dtype=np.int32)
        masks = np.zeros((G, B), dtype=np.float32)
        for row, it in enumerate(part):
            m = len(it.payload)
            idxs[row, :m] = np.asarray(it.payload, dtype=np.int32)
            masks[row, :m] = 1.0
        _answer(part, *srv._items_topk_batched(
            idxs, masks, max(it.k for it in part), groups=len(part)))


class _ItemShard(NamedTuple):
    """One shard of a sharded item store: its ``[cap, R]`` block (dense
    or int8 with scales), its ``[cap]`` validity row (1.0 = a real item),
    the global position of its first row and its device."""

    Y: Any
    valid: torch.Tensor
    offset: int
    device: torch.device


def _explicit_plane(device) -> Optional[List[torch.device]]:
    """The shard plane ``device`` names: a :class:`~predictionio_tpu_
    torch.parallel.mesh.Mesh`'s devices or a sequence's (a device may
    repeat: logical shards on one card), or None for one device."""
    if hasattr(device, "device_list"):
        devs = device.device_list()
    elif isinstance(device, (list, tuple)):
        devs = list(device)
    else:
        return None
    if not devs:
        raise ValueError("an empty device plane")
    return [resolve_device(d) for d in devs]


def _default_plane(device: torch.device) -> List[torch.device]:
    """The plane of a store given one device: every visible card for a
    CUDA device, the device itself on the CPU."""
    if device.type == "cuda":
        from predictionio_tpu_torch.parallel.mesh import default_devices

        return default_devices()
    return [device]


def _store_plane(device) -> List[torch.device]:
    """The shard plane of a store built with ``device``."""
    return _explicit_plane(device) or _default_plane(resolve_device(device))


def _resolved_shard_count(item_layout, shards: Optional[int],
                          plane: List[torch.device]) -> int:
    """The shards a store asks for (``shards``, else PIO_SERVE_SHARDS,
    else a layout's count), clamped with a warning to the plane's
    devices, as the JAX package clamps to its visible devices."""
    n_req = int(shards) if shards is not None else _serve_shards_env()
    if item_layout is not None and n_req <= 1:
        n_req = item_layout.n_shards
    if n_req > 1 and len(plane) < n_req:
        import logging

        logging.getLogger("pio.serving").warning(
            "requested %d serve shards but only %d device(s) "
            "are visible; clamping", n_req, len(plane))
        n_req = len(plane)
    return n_req


def _to_store_device(f, dev: torch.device):
    if f is None:
        return None
    if is_quantized(f):
        return QuantFactors(f.data.to(dev), f.scale.to(dev))
    return f.to(dev)


def _tree_merge_topk(vals: List[torch.Tensor], idx: List[torch.Tensor],
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the shards' candidate lists (each ``[B, k]``, descending,
    global positions) into the global top k on the first list's device:
    a stable descending sort of the lists concatenated in shard order, so
    a score tie goes to the lower shard, and within a shard to its own
    order (the lower position). The JAX package's butterfly of pairwise
    merges and its all-gather reach this answer; in one process the
    lists are simply joined."""
    home = vals[0].device
    cv = torch.cat([v.to(home) for v in vals], dim=1)
    ci = torch.cat([i.to(home) for i in idx], dim=1)
    v, sel = torch.sort(cv, dim=1, descending=True, stable=True)
    return v[:, :k].contiguous(), torch.gather(ci, 1, sel[:, :k])


def _sharded_score_topk(shards: List[_ItemShard], Q: torch.Tensor,
                        sc_q: Optional[torch.Tensor],
                        sm_q: Optional[torch.Tensor], *, k: int,
                        mask_seen: bool,
                        events: Optional[List[Tuple]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score + mask + top-k over a sharded item store: each shard runs
    the serving kernel (:func:`~.als_cuda.fused_gather_score_topk`, B1)
    once on its own ``[m, R]`` block, with its validity row, the queries'
    shard-local seen positions (-1 with mask 0 outside the shard) and
    ``k_local = min(k, m)``, padded to k with -inf; the lists merge by
    :func:`_tree_merge_topk`.

    ``Q [B, R]`` fp32 queries; ``sc_q`` / ``sm_q`` ``[B, L]`` each query's
    masked store positions and mask, on the first shard's device. The
    shards are the layout's equal blocks of ``m`` rows, shard ``s`` at
    position ``s * m``: every shard's local positions are translated at
    once, as one ``[n_shards, L, B]`` table. ``events``, one pair of CUDA
    events a shard, is handed to each shard's launch (its kernels' own
    time). Returns ``(vals [B, k] f32, positions [B, k] i32)`` on the
    first shard's device."""
    out_v: List[torch.Tensor] = []
    out_i: List[torch.Tensor] = []
    m = int(shards[0].valid.shape[0])
    kl = min(k, m)
    lc_all = lm_all = None
    if mask_seen:
        starts = torch.arange(len(shards), dtype=sc_q.dtype,
                              device=sc_q.device) * m
        loc = sc_q[None] - starts[:, None, None]
        inside = (loc >= 0) & (loc < m) & (sm_q[None] > 0)
        lc_all = torch.where(inside, loc, -1).transpose(1, 2)
        lm_all = inside.transpose(1, 2).float()
    for s, sh in enumerate(shards):
        lc = lm = None
        if mask_seen:
            lc, lm = lc_all[s].to(sh.device), lm_all[s].to(sh.device)
        vals, li = fused_gather_score_topk(
            Q.to(sh.device), sh.Y, lc, lm, k=kl, n_items=m,
            mask_seen=mask_seen, row_valid=sh.valid,
            events=None if events is None else events[s])
        if kl < k:  # a small shard: pad its list
            vals = torch.cat([vals, vals.new_full((vals.shape[0], k - kl),
                                                  float("-inf"))], dim=1)
            li = torch.cat([li, li.new_zeros((li.shape[0], k - kl))], dim=1)
        out_v.append(vals)
        out_i.append(li + sh.offset)
    return _tree_merge_topk(out_v, out_i, k)


def _gather_positions_f32(shards: List[_ItemShard],
                          pos: torch.Tensor) -> torch.Tensor:
    """Rows of a sharded item store gathered by global position (any
    index shape) as fp32 on the first shard's device: each shard gives
    the rows it holds, zeros elsewhere, and the parts are summed."""
    home = shards[0].device
    out = None
    for sh in shards:
        m = int(sh.valid.shape[0])
        loc = pos - sh.offset
        inside = (loc >= 0) & (loc < m)
        rows = _gather_rows_f32(sh.Y, loc.clamp(0, m - 1).to(sh.device))
        part = rows.to(home) * inside[..., None]
        out = part if out is None else out + part
    return out


class DeviceTopK:
    """Top-N server over factor tables resident on one device or
    sharded over several.

    ``user_factors``/``item_factors`` are numpy arrays, tensors, or
    :class:`QuantFactors`; they are copied to ``device`` (None = cuda).
    ``device`` may also be a sequence of devices or a :class:`~predictionio_
    tpu_torch.parallel.mesh.Mesh`: the plane a sharded store spans
    (``item_layout``, ``shards`` or ``PIO_SERVE_SHARDS``; see
    :meth:`_setup_sharded_store`). A sharded store answers in item ids,
    ties in store-position order.
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
                 device=None,
                 item_layout=None,
                 shards: Optional[int] = None):
        plane = _explicit_plane(device)
        self.device = plane[0] if plane else resolve_device(device)
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
        # a sharded store (an item layout, ``shards`` or PIO_SERVE_SHARDS
        # over a plane of several devices) holds its items as one block a
        # shard, each on its device, in the layout's position order;
        # ``_Y`` is then None and ``_shards`` the blocks
        self._shards: Optional[List[_ItemShard]] = None
        self._layout = None
        self._perm_np: Optional[np.ndarray] = None
        self._inv_np: Optional[np.ndarray] = None
        self._setup_sharded_store(item_layout, shards, seen, plane)
        if self._shards is None:
            self._Y = _pad_item_rows_for_kernel(self._Y)
        self._mask_seen = bool(seen)
        self._seen_cols = self._seen_mask = None
        if self._mask_seen:
            cols, mask = seen_tables(self._translate_seen(seen),
                                     int(self._X.shape[0]))
            self._seen_cols = torch.from_numpy(cols).to(self.device)
            self._seen_mask = torch.from_numpy(mask).to(self.device)
        self._Yn = None  # normalized item table, built on first item query
        # the serving ladder: a program per (store signature, entry), a
        # CUDA graph on the card, captured by warmup() / precompile()
        # into one memory pool per store; lookups and the last warm-up's
        # coverage, read by ladder_report()
        self._aot_programs = AOTCache(max_entries=512, name="serve-ladder")
        self._graph_pool = None
        self._aot_hits = 0
        self._aot_misses = 0
        self._ladder: Dict[str, int] = {"planned": 0, "compiled": 0,
                                        "fallback": 0, "warmed": 0}
        _live_servers.add(self)
        # a registry reset (test isolation) drops the pull gauges, so each
        # new store sets them again
        _metrics.DEVICE_STORE_BYTES.set_function(_live_store_bytes)
        _metrics.AOT_LADDER_BYTES.set_function(_live_ladder_bytes)

    def _setup_sharded_store(self, item_layout, shards: Optional[int],
                             seen, plane: Optional[List[torch.device]]
                             ) -> None:
        """Place the store over a shard plane when sharding is asked for:
        an ``item_layout``, ``shards`` or ``PIO_SERVE_SHARDS`` above 1,
        clamped (with a warning) to the devices of the plane: ``device``
        when it is a sequence or a :class:`~predictionio_tpu_torch.
        parallel.mesh.Mesh`, else every visible card (one device on the
        CPU). Without a layout of that shard count, the density-aware
        layout is derived from ``seen`` (the seen sets are the
        interaction sets). The item rows are permuted into the layout
        (pad slots zero, int8 scale 1) and split into one contiguous
        ``[cap, R]`` block per shard on its device. The user table and
        the seen tables stay on the first shard's device; the user rows
        are padded to a multiple of the shard count."""
        plane = plane or _default_plane(self.device)
        n_sh = _resolved_shard_count(item_layout, shards, plane)
        if n_sh <= 1:
            return
        from predictionio_tpu_torch.parallel.als_sharding import (
            density_aware_item_layout,
        )

        layout = item_layout
        if layout is None or layout.n_shards != n_sh:
            counts = np.zeros(self.n_items, dtype=np.int64)
            if seen:
                for items in seen.values():
                    it = np.asarray(items, dtype=np.int64)
                    it = it[(it >= 0) & (it < self.n_items)]
                    np.add.at(counts, it, 1)
            layout = density_aware_item_layout(counts, n_sh)
        devices = plane[:n_sh]
        self.device = devices[0]
        self._X = _to_store_device(self._X, self.device)
        self._Y = _to_store_device(self._Y, self.device)
        perm = torch.from_numpy(layout.perm).to(self.device)
        real = perm >= 0
        src = perm.clamp(0, max(int(self._Y.shape[0]) - 1, 0))

        def perm_rows(a, fill):
            out = a[src]
            keep = real.view((-1,) + (1,) * (out.ndim - 1))
            return torch.where(keep, out, out.new_full((), fill))

        if is_quantized(self._Y):
            Yp = QuantFactors(perm_rows(self._Y.data, 0),
                              perm_rows(self._Y.scale, 1.0))
        else:
            Yp = perm_rows(self._Y, 0.0)
        valid = torch.from_numpy(layout.valid_mask())
        cap = layout.cap
        blocks = []
        for s, dev in enumerate(devices):
            rows = slice(s * cap, (s + 1) * cap)
            if is_quantized(Yp):
                block = QuantFactors(Yp.data[rows].contiguous().to(dev),
                                     Yp.scale[rows].contiguous().to(dev))
            else:
                block = Yp[rows].contiguous().to(dev)
            blocks.append(_ItemShard(block, valid[rows].to(dev),
                                     s * cap, dev))
        pad = (-int(self._X.shape[0])) % n_sh
        if pad:
            X = self._X
            if is_quantized(X):
                self._X = QuantFactors(
                    _grown(X.data, (X.data.shape[0] + pad, X.data.shape[1])),
                    _grown(X.scale, (X.scale.shape[0] + pad,), 1.0))
            else:
                self._X = _grown(X, (X.shape[0] + pad, X.shape[1]))
        self._Y = None
        self._shards = blocks
        self._layout = layout
        self._perm_np = layout.perm
        self._inv_np = layout.inv

    def _translate_seen(self, seen):
        """Item-id seen sets -> store-position seen sets (the identity
        without a layout). Ids outside ``[0, n_items)`` are dropped:
        they have no position."""
        if self._inv_np is None or not seen:
            return seen
        inv = self._inv_np
        out = {}
        for u, items in seen.items():
            it = np.asarray(items, dtype=np.int64)
            it = it[(it >= 0) & (it < self.n_items)]
            out[u] = inv[it]
        return out

    def _positions_to_items(self, idx: np.ndarray) -> np.ndarray:
        """Store positions (the top-k's output) -> item ids on the host.
        A pad position, or the unspecified id of a -inf slot, maps to -1;
        every caller drops non-finite scores."""
        if self._perm_np is None:
            return idx
        perm = self._perm_np
        inside = (idx >= 0) & (idx < len(perm))
        return np.where(inside, perm[np.where(inside, idx, 0)],
                        -1).astype(np.int32)

    def _items_to_positions(self, idxs: np.ndarray) -> np.ndarray:
        """Item ids (a similarity query's input) -> store positions."""
        if self._inv_np is None:
            return idxs
        return self._inv_np[idxs].astype(np.int32)

    @property
    def shard_count(self) -> int:
        """Shards the item store spans (1 = a single store)."""
        return 1 if self._shards is None else len(self._shards)

    @property
    def item_layout(self):
        """The :class:`~predictionio_tpu_torch.parallel.als_sharding.
        ItemShardLayout` of a sharded store, or None."""
        return self._layout

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

    # -- the serving ladder ------------------------------------------------

    def _store_sig_locked(self) -> Tuple:
        """What every ladder program is keyed on: the shape, dtype and
        device address of each table a graph reads (the user table, the
        item table or each shard's block and validity row, the seen
        tables, the normalized item table once built), the precision and
        the shard count. A patch that replaces a table (growth) changes
        it, so no graph ever replays against a freed table; an in-place
        row patch keeps it, and the graphs read the patched rows. Caller
        holds ``_store_lock``."""
        if self._shards is not None:
            items = tuple((_table_sig(sh.Y), _table_sig(sh.valid))
                          for sh in self._shards)
            yn = None if self._Yn is None else tuple(
                _table_sig(sh.Y) for sh in self._Yn)
        else:
            items, yn = _table_sig(self._Y), _table_sig(self._Yn)
        return (_table_sig(self._X), items, _table_sig(self._seen_cols),
                _table_sig(self._seen_mask), yn, self._mode,
                self.shard_count)

    def _aot_get_locked(self, entry: Tuple):
        return self._aot_programs.get((self._store_sig_locked(), entry))

    def aot_plan(self, max_k: int = 128,
                 batch_sizes: Tuple[int, ...] = ()) -> List[Tuple]:
        """Every program live traffic can dispatch at, the one
        enumeration warm-up and the deploy consult: ``("user", kb)``
        (one query), ``("users", kb, bb)`` (a uid batch padded to ``bb``)
        and ``("items", kb, ITEM_QUERY_BUCKET, gg)`` (``gg`` similarity
        queries). ``kb`` sweeps the k buckets 16, 32, ... up to ``max_k``
        (clipped to ``n_items``); ``bb`` / ``gg`` sweep 8, 16, ... up to
        each micro-batch lane's cap (8 without one), ``bb`` further to
        cover ``batch_sizes``."""
        ks: List[int] = []
        k = 16
        while True:
            kb = min(k, self.n_items)
            if kb >= 1 and kb not in ks:
                ks.append(kb)
            if k >= max_k or k >= self.n_items:
                break
            k *= 2
        bmax = self._batcher.max_batch if self._batcher is not None else 8
        for b in batch_sizes:
            bmax = max(bmax, _bucket(int(b), lo=8))
        user_buckets = []
        b = 8
        while b <= bmax:
            user_buckets.append(b)
            b *= 2
        gmax = self._item_batcher.max_batch \
            if self._item_batcher is not None else 8
        item_buckets = []
        g = 8
        while g <= gmax:
            item_buckets.append(g)
            g *= 2
        plan: List[Tuple] = []
        for kb in ks:
            plan.append(("user", kb))
            for bb in user_buckets:
                plan.append(("users", kb, bb))
            for gg in item_buckets:
                plan.append(("items", kb, self.ITEM_QUERY_BUCKET, gg))
        return plan

    def _graphable(self) -> bool:
        """Whether a dispatch can be one graph: the store lives on one
        device (a sharded store's shards all on the first's, logical
        shards of one card included)."""
        return self._shards is None or all(
            sh.device == self.device for sh in self._shards)

    def _entry_program(self, entry: Tuple):
        """``(fn, static inputs)`` of one ladder entry, the inputs zeros
        of the shapes its dispatch passes, or None for an entry it cannot
        build (:meth:`_aot_lower_entry`). Caller holds ``_store_lock``."""
        kind, dev = entry[0], self.device
        if kind == "user":
            return (self._users_fn(entry[1]),
                    (torch.zeros(1, dtype=torch.int64, device=dev),))
        if kind == "users":
            return (self._users_fn(entry[1]),
                    (torch.zeros(entry[2], dtype=torch.int64, device=dev),))
        if kind == "items":
            _, kb, B, gg = entry
            return (self._items_fn(kb),
                    (torch.zeros((gg, B), dtype=torch.int32, device=dev),
                     torch.zeros((gg, B), dtype=torch.float32, device=dev)))
        return self._aot_lower_entry(entry)

    def _ladder_tables_locked(self) -> Tuple:
        """The tables the graphs read, which each program keeps alive
        until it is evicted or cleared. Caller holds ``_store_lock``."""
        return (self._X, self._Y, self._shards, self._seen_cols,
                self._seen_mask, self._Yn)

    def precompile(self, plan: List[Tuple]) -> Dict[str, int]:
        """Capture every ladder entry of ``plan`` not in the cache yet
        (on the CPU: bind it) into the cache the dispatches consult
        first. Each capture holds ``_store_lock``: no patch and no
        dispatch of this store runs meanwhile. A store spanning several
        devices cannot be one graph, so its entries fall back, as
        ``PIO_SERVE_AOT=0`` makes them all. A capture that fails raises.
        Returns ``{"compiled": n, "fallback": n}``."""
        if not _serve_aot_enabled() or not self._graphable():
            return {"compiled": 0, "fallback": len(plan)}
        if any(e[0] == "items" for e in plan):
            self._normalized_items()   # before the signature is taken
        compiled = fallback = 0
        for entry in plan:
            with self._store_lock:
                sig = self._store_sig_locked()
                if self._aot_programs.get((sig, entry)) is not None:
                    compiled += 1
                    continue
                built = self._entry_program(entry)
                if built is None:
                    fallback += 1
                    continue
                if self.device.type == "cuda" and self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                prog = capture(*built, pool=self._graph_pool,
                               keep=self._ladder_tables_locked())
                self._aot_programs.put((sig, entry), prog)
                compiled += 1
        return {"compiled": compiled, "fallback": fallback}

    def _clear_ladder_locked(self) -> None:
        """Drop every program (the store's tables were replaced): the
        graphs and their pool are freed; the next warm-up captures the
        ladder again. Caller holds ``_store_lock``."""
        self._aot_programs.clear()
        self._graph_pool = None

    def _aot_lower_entry(self, entry: Tuple):
        """``(fn, static inputs)`` of a ladder entry of a kind this class
        does not know: the hook through which a subclass's lanes (the
        two-stage ``("two", ...)`` entries) join the same capture, cache
        and coverage. None: the entry falls back, and :meth:`warmup`
        runs it once through :meth:`_warm_entry`."""
        return None

    def _warm_entry(self, entry: Tuple) -> None:
        """Run one subclass-lane entry eagerly at warm-up. Base class: no
        such lanes."""

    def warmup(self, max_k: int = 128,
               batch_sizes: Tuple[int, ...] = ()) -> Dict[str, int]:
        """Make every ladder program up to ``max_k`` serve-ready at
        deploy: capture the whole :meth:`aot_plan` (``batch_sizes``
        widens the uid buckets for callers with known batch shapes),
        run each entry that fell back once eagerly (the kernel builds and
        sets up at its first launch), then one sacrificial query per
        lane. Returns :meth:`precompile`'s counts."""
        plan = self.aot_plan(max_k=max_k, batch_sizes=tuple(batch_sizes))
        stats = self.precompile(plan)
        with self._store_lock:
            missing = [e for e in plan if self._aot_get_locked(e) is None]
            self._ladder = {"planned": len(plan),
                            "compiled": stats["compiled"],
                            "fallback": stats["fallback"],
                            "warmed": len(missing)}
        for entry in missing:
            if entry[0] == "user":
                self._user_topk_direct(0, entry[1])
            elif entry[0] == "users":
                _, kb, bb = entry
                self.users_topk(np.zeros(bb, dtype=np.int64), kb)
            elif entry[0] == "items":
                _, kb, B, gg = entry
                self._items_topk_batched(np.zeros((gg, B), dtype=np.int32),
                                         np.zeros((gg, B), dtype=np.float32),
                                         kb)
            else:
                self._warm_entry(entry)
        kmin = min(16, self.n_items)
        self.user_topk(0, kmin)
        self.users_topk(np.zeros(8, dtype=np.int64), kmin)
        self.items_topk([0], kmin)
        return stats

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
        return self.memory_report()["totalBytes"]

    def memory_report(self) -> Dict[str, Any]:
        """Device bytes this store pins, by component and dtype, in the
        JAX package's shape: the factor tables (int8 stores split data
        and per-row scales; the item table as padded to the kernel's
        tile), the seen tables and the normalized item table once built.
        Reads the live references under ``_store_lock``, so the report
        follows fold-in growth as it happens. ``kernel`` names the
        serving program: the port's fused CUDA top-k."""
        with self._store_lock:
            X, Y, Yn = self._X, self._Y, self._Yn
            sc, sm = self._seen_cols, self._seen_mask
            n_users, n_items = self.n_users, self.n_items
            shards, layout = self._shards, self._layout
        if shards is not None:
            Y = _joined_component([sh.Y for sh in shards])
            Yn = None if Yn is None else _joined_component(
                [sh.Y for sh in Yn])
        else:
            Y, Yn = _component(Y), _component(Yn)
        components: Dict[str, Any] = {
            "userFactors": _component(X),
            "itemFactors": Y,
            "normalizedItems": Yn,
            "seen": {"bytes": int(sc.nbytes + sm.nbytes),
                     "dtype": f"{_dtype_name(sc.dtype)}+"
                              f"{_dtype_name(sm.dtype)}",
                     "shape": [int(d) for d in sc.shape]}
            if self._mask_seen else None,
        }
        total = sum(c["bytes"] + c.get("scaleBytes", 0)
                    for c in components.values() if c is not None)
        report = {"precision": self._mode, "kernel": "fused",
                  "nUsers": n_users, "nItems": n_items,
                  "userCapacity": int(X.shape[0]),
                  "components": components, "totalBytes": int(total)}
        if shards is not None:
            # each shard's slice, items and interaction mass (the
            # aggregate hides a hot shard), in the JAX package's terms:
            # every table's bytes divided evenly over the shards
            n_sh = len(shards)

            def per_shard(c) -> int:
                return 0 if c is None else \
                    (c["bytes"] + c.get("scaleBytes", 0)) // n_sh

            items, mass = layout.items_per_shard, layout.counts_per_shard
            factor_bytes = sum(per_shard(components[name]) for name in (
                "userFactors", "itemFactors", "normalizedItems"))
            report["shardAxis"] = "data"
            report["nShards"] = n_sh
            report["shards"] = [{"shard": s, "factorBytes": int(factor_bytes),
                                 "items": int(items[s]),
                                 "interactions": int(mass[s])}
                                for s in range(n_sh)]
            report["shardBalance"] = layout.balance_report()
        return report

    def ladder_report(self) -> Dict[str, Any]:
        """The serving ladder in the JAX package's shape: the last
        warm-up's planned / compiled / fallback / warmed counts, the
        lookups since (``hit`` replayed a program, ``missJit`` ran
        eagerly), the cache's entries and evictions, and the device bytes
        the programs hold (``memory.totalBytes``: the graph pool's growth
        each capture caused, measured from the allocator's segments)."""
        with self._store_lock:
            hits, misses = self._aot_hits, self._aot_misses
            coverage = dict(self._ladder)
        return {"coverage": coverage,
                "requests": {"hit": hits, "missJit": misses},
                "cache": self._aot_programs.stats(),
                "memory": self._aot_programs.memory_report()}

    # -- serving ----------------------------------------------------------

    def _dispatch_entry(self, entry: Tuple, fn: Callable, host_inputs: Tuple,
                        *, batch: int, bucket: int,
                        eager: Optional[Callable] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """One laddered dispatch, under ``_store_lock`` (the lock a patch
        enqueues its writes under): the program lookup, counted as a hit
        or a miss; on a hit the inputs copied into the program's static
        buffers and its graph replayed; on a miss ``eager`` (else ``fn``)
        run on the inputs; then, on the card, the copy of the packed
        result into pinned host memory enqueued, before another dispatch
        can replay the program over it. The wait for the copy is outside
        the lock. Returns ``(idx [rows, kb] i32, scores [rows, kb] f32)``.

        With telemetry on, recorded as one dispatch (``aot`` "hit" or
        "miss_jit", ``bucket`` the padded bucket, ``kernel`` the route
        the graph or the launch recorded) and one ``device.execute``
        span: ``hostUs`` from the lookup to the result on the host,
        ``deviceUs`` the time between two CUDA events: on a hit the pair
        the graph records around its work (read under the program's lock,
        so no other replay re-records it first), on a miss the pair the
        eager launch records just around its kernels. On the CPU there
        are no events, and the span says so. Telemetry off: no clock, no
        event."""
        tel = _dtel.enabled()
        cuda = self.device.type == "cuda"
        events = held = None
        with self._store_lock:
            prog = self._aot_get_locked(entry)
            hit = prog is not None
            if hit:
                self._aot_hits += 1
            else:
                self._aot_misses += 1
            if tel:
                t0 = _tracing.span_now()
            if hit:
                if tel and cuda and prog.events is not None:
                    held = prog.lock
                    held.acquire()
                    events = prog.events
                out = prog(*host_inputs)
            else:
                if tel and cuda:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                out = (eager or fn)(*(self._host_to_device(x)
                                      for x in host_inputs), events=events)
            if cuda:
                out = out.to("cpu", non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            route = als_cuda.last_route() or "?"
        try:
            _metrics.AOT_CACHE_REQUESTS.inc(
                result="hit" if hit else "miss_jit")
            if cuda:
                copied.synchronize()
            device_us = (None if events is None
                         else events[0].elapsed_time(events[1]) * 1e3)
        finally:
            if held is not None:
                held.release()
        packed = out.numpy()
        kb = int(entry[1])
        idx, scores = packed[:, kb:].view(np.int32), packed[:, :kb]
        if not tel:
            return idx, scores
        t1 = _tracing.span_now()
        rec = _dtel.record_dispatch(
            lane=entry[0], kernel=route, precision=self._mode,
            aot="hit" if hit else "miss_jit", k_bucket=kb, batch=batch,
            bucket=bucket, host_us=(t1 - t0) * 1e6, device_us=device_us,
            started_epoch=t0)
        # {} when the recorder was switched off during this dispatch
        attributes = dict(rec or {})
        if not cuda:
            attributes["deviceTiming"] = (
                "none: no CUDA events on the CPU (the kernel's plain "
                "version)")
        ctx = _dtel.current_dispatch_context() or {}
        _tracing.record_completed_span(
            "device.execute", start=t0, end=t1, attributes=attributes,
            parent=ctx.get("traceParent"))
        return idx, scores

    def _host_to_device(self, a) -> torch.Tensor:
        """A host input (numpy) on the store's device, its copy enqueued
        without waiting on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, non_blocking=True)

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
        """One dispatch of the ``("user", kb)`` entry (one query) or of
        ``("users", kb, bb)``: the uids padded with uid 0 to their
        power-of-two bucket ``bb`` (at least 8), the padding rows cut
        before the results return."""
        kb = min(_bucket(k), self.n_items)
        n = len(uids)
        if lane == "user":
            bucket, entry = 1, ("user", kb)
            padded = np.asarray(uids, dtype=np.int64)
        else:
            bucket = _bucket(max(n, 1), lo=8)
            entry = ("users", kb, bucket)
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:n] = uids
        idx, scores = self._dispatch_entry(
            entry, self._users_fn(kb), (padded,), batch=n, bucket=bucket)
        return self._positions_to_items(idx[:n, :k]), scores[:n, :k]

    def _users_fn(self, kb: int) -> Callable[[torch.Tensor], torch.Tensor]:
        """The user lanes' program at k bucket ``kb``: ``u [B]`` int64
        uids on the device -> the packed ``[B, 2 kb]`` result. It gathers
        the users' rows and seen rows and launches B1 (once per shard on
        a sharded store, the lists merged), under ``_store_lock`` (see
        :meth:`patch_users`), eagerly or captured. ``events`` (an eager
        call's timing pair) is recorded around the launch. It holds the
        store weakly: a cached program keeps no store alive."""
        ref = weakref.ref(self)

        def fn(u: torch.Tensor, events: Optional[Tuple] = None
               ) -> torch.Tensor:
            srv = ref()
            sc = sm = None
            if srv._mask_seen:  # the [B, L] rows
                sc, sm = srv._seen_cols[u], srv._seen_mask[u]
            Q = _gather_rows_f32(srv._X, u)
            if srv._shards is not None:
                return _pack(*srv._sharded_launch(
                    Q, sc, sm, kb, srv._mask_seen, srv._shards, events))
            # the kernel reads the seen rows as [L, B] views
            return _pack(*fused_gather_score_topk(
                Q, srv._Y, None if sc is None else sc.T,
                None if sm is None else sm.T, k=kb, n_items=srv.n_items,
                mask_seen=srv._mask_seen, events=events))
        return fn

    def _sharded_launch(self, Q, sc_q, sm_q, kb: int, mask_seen: bool,
                        shards: List[_ItemShard], events=None):
        """:func:`_sharded_score_topk` over ``shards`` (B1 once per shard,
        the lists merged), with ``events``, a CUDA event pair, recorded on
        the first shard's stream around every shard's launch and the
        merge."""
        if events is not None:
            events[0].record(torch.cuda.current_stream(self.device))
        out = _sharded_score_topk(shards, Q, sc_q, sm_q, k=kb,
                                  mask_seen=mask_seen)
        if events is not None:
            events[1].record(torch.cuda.current_stream(self.device))
        return out

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
        on first use (on a sharded store, each shard's block on its
        device, with its validity row)."""
        with self._yn_lock:
            if self._Yn is None:
                if self._shards is not None:
                    self._Yn = [sh._replace(Y=_normalize_rows(sh.Y))
                                for sh in self._shards]
                else:
                    self._Yn = _normalize_rows(self._Y)
            return self._Yn

    def _items_topk_batched(self, idxs: np.ndarray, masks: np.ndarray,
                            k: int, groups: Optional[int] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """A [G, B] bucket of item queries, one dispatch of the
        ``("items", kb, B, G)`` entry: each group's summed normalized
        query row is scored against every item, with its query items
        masked (they play the seen table's role). ``groups`` counts the
        real rows (the rest pad the bucket), for the telemetry."""
        G, B = idxs.shape
        kb = min(_bucket(k), self.n_items)
        # out-of-range query item ids drop from the query (mask 0)
        in_range = (idxs >= 0) & (idxs < self.n_items)
        if not in_range.all():
            masks = masks * in_range.astype(masks.dtype)
            idxs = np.where(in_range, idxs, 0).astype(idxs.dtype)
        # a sharded store lives in position space: the query items are
        # translated in, the winners out (on the host, k a query)
        idxs = np.ascontiguousarray(self._items_to_positions(idxs),
                                    dtype=np.int32)
        masks = np.ascontiguousarray(masks, dtype=np.float32)
        self._normalized_items()
        idx, scores = self._dispatch_entry(
            ("items", kb, B, G), self._items_fn(kb), (idxs, masks),
            batch=G if groups is None else int(groups), bucket=G)
        return self._positions_to_items(idx), scores

    def _items_fn(self, kb: int) -> Callable[..., torch.Tensor]:
        """The item lane's program at k bucket ``kb``: ``it [G, B]``
        int32 query positions and ``mt [G, B]`` fp32 masks on the device
        -> the packed ``[G, 2 kb]`` result (the store held weakly, as in
        :meth:`_users_fn`)."""
        ref = weakref.ref(self)

        def fn(it: torch.Tensor, mt: torch.Tensor,
               events: Optional[Tuple] = None) -> torch.Tensor:
            srv = ref()
            Yn = srv._Yn
            if srv._shards is not None:
                qf = _gather_positions_f32(Yn, it.long())        # [G, B, R]
                Q = (qf * mt[..., None]).sum(dim=1)              # [G, R]
                return _pack(*srv._sharded_launch(Q, it, mt, kb, True, Yn,
                                                  events))
            qf = _gather_rows_f32(Yn, it.long())                 # [G, B, R]
            Q = (qf * mt[..., None]).sum(dim=1)                  # [G, R]
            return _pack(*fused_gather_score_topk(
                Q, Yn, it.T, mt.T, k=kb, n_items=srv.n_items,
                mask_seen=True, events=events))
        return fn

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
            Y, shards = self._Y, self._shards
        n = self.n_items
        if shards is not None:
            # a sharded store hands back item-id order (the fold-in
            # solve indexes by item id, not by store position)
            inv = torch.from_numpy(self._inv_np).to(self.device)
            parts = [_to_store_device(sh.Y, self.device) for sh in shards]
            if is_quantized(parts[0]):
                Y = QuantFactors(torch.cat([p.data for p in parts])[inv],
                                 torch.cat([p.scale for p in parts])[inv])
            else:
                Y = torch.cat(parts)[inv]
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
        lock.

        A growth replaces tables the ladder's graphs read, so it clears
        the ladder (they would replay against freed memory); dispatches
        then run eagerly until the next :meth:`warmup`. An in-place patch
        keeps the ladder: its graphs read the patched rows."""
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
        if seen_items:
            seen_items = self._translate_seen(seen_items)
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
            sig_before = self._store_sig_locked()
            X = self._X
            cap = int(X.shape[0])
            if needed > cap:
                new_cap = _bucket(needed, lo=max(cap, 16))
                # a sharded store's user rows stay a multiple of its
                # shard count
                n_sh = self.shard_count
                new_cap = -(-new_cap // n_sh) * n_sh
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
            if self._store_sig_locked() != sig_before:
                # a grown store: its graphs read the replaced tables
                self._clear_ladder_locked()
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


def _live_ladder_bytes() -> float:
    """Device bytes held by the live stores' ladder graphs (the pull
    source of ``pio_aot_ladder_bytes``)."""
    return float(sum(srv.ladder_report()["memory"]["totalBytes"]
                     for srv in list(_live_servers)))


_metrics.AOT_LADDER_BYTES.set_function(_live_ladder_bytes)


def device_report() -> Dict[str, Any]:
    """The ``/stats.json`` ``device`` block in the JAX package's shape:
    each live store as ``{"store": memory_report(), "aotLadder":
    ladder_report()}``, their bytes, the ladders' measured device bytes,
    and the flight recorder's counts and per-lane dispatch summary."""
    stores: List[Dict[str, Any]] = []
    store_bytes = ladder_bytes = 0
    for srv in list(_live_servers):
        mem, ladder = srv.memory_report(), srv.ladder_report()
        store_bytes += mem["totalBytes"]
        ladder_bytes += ladder["memory"]["totalBytes"]
        stores.append({"store": mem, "aotLadder": ladder})
    rec = _dtel.recorder()
    return {"telemetry": {"enabled": rec.enabled, **rec.counts()},
            "storeBytes": store_bytes,
            "aotLadderBytes": ladder_bytes,
            "stores": stores,
            "dispatch": rec.summary()}
