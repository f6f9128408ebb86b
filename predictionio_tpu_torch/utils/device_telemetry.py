"""Device-plane flight recorder: per-dispatch telemetry for live serving.

The port's copy of ``predictionio_tpu/utils/device_telemetry.py``, the
bounded thread-safe ring that says, for each launch of the serving
kernel, how much device time it cost, how full its batch was and how
long it queued:

- every dispatch of the serving store (the batched users lane, the
  single-user lane, item similarity, two-stage) records one dispatch
  record with the JAX package's field names: lane, k bucket, batch and
  the padded bucket, fill ratio, store precision, kernel (here the route
  the kernel took, as the launch or the replayed graph recorded it:
  ``chunked``, ``bitonic``, ``cluster_row``, ``radix_row``; ``plain``
  for the plain version on the CPU), ``aot`` (``"hit"``: a ladder
  graph replayed; ``"miss_jit"``: the dispatch ran eagerly), queue
  wait, ``hostUs`` (the host's window from the lookup to the end of the
  copy back) and ``deviceUs``;
- ``deviceUs`` is the time between two CUDA events recorded on the
  stream around the dispatch's program (a replay or the eager run),
  read after the copy back the query waits for anyway (no added
  synchronisation). The JAX package
  reads a host clock around ``block_until_ready`` instead. On the CPU
  there are no events: ``deviceUs`` is None and nothing is observed;
- the ring is bounded (``PIO_DEVICE_TELEMETRY_RING``, default 2048);
  evictions are counted, not silently dropped;
- surfaces: ``GET /dispatches.json`` on the query server (snapshot +
  per-lane summary), the ``pio_dispatch_device_seconds`` histogram and
  ``device.execute`` child spans in the trace tree;
- kill switch ``PIO_DEVICE_TELEMETRY=0``: every record site returns on
  one attribute check before touching a clock, an event or a lock.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "RECORDER",
    "recorder",
    "enabled",
    "set_enabled",
    "record_dispatch",
    "last_record",
    "dispatch_scope",
    "current_dispatch_context",
]


def _env_enabled() -> bool:
    return os.environ.get("PIO_DEVICE_TELEMETRY", "1").strip().lower() \
        not in ("0", "off", "false")


def _env_capacity(default: int = 2048) -> int:
    raw = os.environ.get("PIO_DEVICE_TELEMETRY_RING", "").strip()
    try:
        cap = int(raw) if raw else default
    except ValueError:
        cap = default
    return max(16, cap)


class FlightRecorder:
    """Bounded thread-safe ring of per-dispatch telemetry records.

    Records are plain dicts (JSON-shaped at write time; the scrape path
    never touches device state). ``recorded`` counts every record ever
    taken; ``evicted`` = recorded − retained, so a scraper can tell a
    quiet server from one whose history rolled over.
    """

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self.capacity = _env_capacity() if capacity is None \
            else max(16, int(capacity))
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._recorded = 0
        # the most recent record taken by THIS thread — how a batching
        # dispatcher hands the dispatch record to the result object
        # without changing the users_topk return signature
        self._tls = threading.local()

    # -- write side --------------------------------------------------------

    def record(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1
        self._tls.last = rec
        return rec

    def last(self) -> Optional[Dict[str, Any]]:
        """The most recent record taken on the CALLING thread (None when
        telemetry is off or this thread never dispatched)."""
        return getattr(self._tls, "last", None)

    # -- read side ---------------------------------------------------------

    def snapshot(self, limit: int = 100) -> List[Dict[str, Any]]:
        """The newest ``limit`` records, newest first (0 -> none —
        summaries-only scrapers pass limit=0 to skip the bulk)."""
        limit = int(limit)
        if limit <= 0:
            return []
        with self._lock:
            recent = list(self._ring)[-limit:]
        return recent[::-1]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            retained = len(self._ring)
            recorded = self._recorded
        return {"recorded": recorded, "retained": retained,
                "evicted": recorded - retained,
                "capacity": self.capacity}

    def summary(self) -> Dict[str, Any]:
        """Per-lane aggregates over the retained window: dispatch count,
        device/host-µs percentiles, queue-wait p50, mean batch fill,
        AOT outcome counts: the compact view of ``/stats.json``."""
        with self._lock:
            records = list(self._ring)
        lanes: Dict[str, List[Dict[str, Any]]] = {}
        for r in records:
            lanes.setdefault(r.get("lane", "?"), []).append(r)

        def pct(vals: List[float], q: float) -> Optional[float]:
            if not vals:
                return None
            vals = sorted(vals)
            i = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
            return round(vals[i], 1)

        out: Dict[str, Any] = {}
        for lane, rs in sorted(lanes.items()):
            dev = [r["deviceUs"] for r in rs
                   if r.get("deviceUs") is not None]
            host = [r["hostUs"] for r in rs if r.get("hostUs") is not None]
            waits = [r["queueWaitUs"] for r in rs
                     if r.get("queueWaitUs") is not None]
            fills = [r["fill"] for r in rs if r.get("fill") is not None]
            aot = collections.Counter(r.get("aot", "?") for r in rs)
            out[lane] = {
                "dispatches": len(rs),
                "deviceUsP50": pct(dev, 0.50),
                "deviceUsP99": pct(dev, 0.99),
                "hostUsP50": pct(host, 0.50),
                "hostUsP99": pct(host, 0.99),
                "queueWaitUsP50": pct(waits, 0.50),
                "meanFill": round(sum(fills) / len(fills), 4)
                if fills else None,
                "aot": dict(aot),
            }
        return out

    def report(self, limit: int = 100) -> Dict[str, Any]:
        """The ``GET /dispatches.json`` payload."""
        return {
            "enabled": self.enabled,
            **self.counts(),
            "summary": self.summary(),
            "dispatches": self.snapshot(limit),
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recorded = 0
        self._tls = threading.local()


RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return RECORDER


def enabled() -> bool:
    """THE kill-switch check every dispatch site makes first — one
    attribute read, no lock, no clock (``PIO_DEVICE_TELEMETRY=0``)."""
    return RECORDER.enabled


def set_enabled(flag: bool) -> None:
    RECORDER.enabled = bool(flag)


def last_record() -> Optional[Dict[str, Any]]:
    return RECORDER.last()


# -- dispatch context --------------------------------------------------------

# What the batching dispatcher knows that the device dispatch site does
# not: how long the group queued and how many requests share the
# dispatch. Thread-local (the dispatcher calls the dispatch fn
# synchronously on its own thread), never crosses threads.
_dispatch_ctx = threading.local()


@contextlib.contextmanager
def dispatch_scope(queue_wait_us: Optional[float] = None,
                   group: Optional[int] = None,
                   trace_parent: Any = None):
    """Bind batching context for the device dispatch(es) the block
    issues: queue wait of the oldest grouped query, the group size, and
    a trace parent for the ``device.execute`` span (the dispatcher
    thread has no ambient trace context of its own)."""
    prior = getattr(_dispatch_ctx, "ctx", None)
    _dispatch_ctx.ctx = {"queueWaitUs": queue_wait_us, "group": group,
                         "traceParent": trace_parent}
    try:
        yield
    finally:
        _dispatch_ctx.ctx = prior


def current_dispatch_context() -> Optional[Dict[str, Any]]:
    return getattr(_dispatch_ctx, "ctx", None)

def record_dispatch(*, lane: str, kernel: str, precision: str, aot: str,
                    k_bucket: int, batch: int, bucket: int,
                    host_us: float, device_us: Optional[float],
                    started_epoch: Optional[float] = None
                    ) -> Optional[Dict[str, Any]]:
    """Record one device dispatch (the caller already paid the timing;
    this is pure bookkeeping). Returns the record dict, or None when the
    recorder is disabled. ``device_us`` None (no CUDA events: the plain
    version on the CPU) records no device time. Also feeds
    ``pio_dispatch_device_seconds``, behind the metrics switch
    independently of this recorder's own."""
    if not RECORDER.enabled:
        return None
    ctx = current_dispatch_context() or {}
    rec: Dict[str, Any] = {
        "ts": started_epoch if started_epoch is not None else time.time(),
        "lane": lane,
        "kernel": kernel,
        "precision": precision,
        "aot": aot,
        "kBucket": int(k_bucket),
        "batch": int(batch),
        "bucket": int(bucket),
        "fill": round(batch / bucket, 4) if bucket else None,
        "queueWaitUs": None if ctx.get("queueWaitUs") is None
        else round(float(ctx["queueWaitUs"]), 1),
        "hostUs": round(float(host_us), 1),
        "deviceUs": None if device_us is None
        else round(float(device_us), 1),
    }
    RECORDER.record(rec)
    if device_us is not None:
        from predictionio_tpu_torch.utils import metrics

        metrics.DISPATCH_DEVICE_SECONDS.observe(
            device_us / 1e6, lane=lane, kernel=kernel, precision=precision)
    return rec
