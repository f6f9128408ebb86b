"""Tracing and profiling utilities.

The port's copy of ``predictionio_tpu/utils/tracing.py``:

- :class:`LatencyHistogram`: thread-safe log-bucketed latency histogram
  with percentile estimates (the query server's per-query serving times,
  and the sample store behind every
  :class:`~predictionio_tpu_torch.utils.metrics.Histogram`).
- request-scoped tracing: :func:`ensure_request_id` accepts or mints an
  ``X-Request-ID``, carried through a :mod:`contextvars` var so
  :func:`span` log lines attribute work to the request that caused it.
- structured span trees: :func:`span` is a real tracing span when a
  trace is active (trace / span / parent ids, start and end, attributes,
  error flag), recorded into a bounded thread-safe :class:`TraceBuffer`
  with head sampling plus an always-keep lane for slow or errored traces
  (the slow-query log). A local trace root is opened with
  :func:`trace_scope` (the HTTP servers open one per request).
- cross-process propagation: W3C ``traceparent``
  (:func:`parse_traceparent` / :func:`current_traceparent`).
- export: :func:`trace_to_chrome` renders a retained trace as
  Chrome-trace-event JSON (Perfetto, ``chrome://tracing``);
  :func:`set_trace_dir` (``$PIO_TRACE_DIR``) also appends every retained
  trace as a JSONL line (``traces-<pid>.jsonl``) and slow or errored
  summaries to ``slow-queries.log``, in the same format as the JAX
  package, so a directory written by either package loads in the other.
  :func:`render_trace_html` is the timeline view.
- kill switches, with the JAX package's meanings: ``PIO_TRACING=0|off``
  (span collection off: :func:`span` is the log-line timer),
  ``PIO_TRACE_SAMPLE`` (head-sampling rate), ``PIO_TRACE_SLOW_SEC`` (the
  slow lane's threshold) and ``PIO_TRACE_DIR``.
- :class:`StageTimeline`: the pipelined ingest's stage spans, mirrored
  into the trace under a caller's :class:`SpanContext`.
- :func:`profile_trace` / :class:`ProfilerCapture`: a ``torch.profiler``
  capture (CPU and, where CUDA is present, CUDA activities) written as
  a Chrome trace file into the capture directory. This is where the
  port differs from the JAX package, whose captures are
  ``jax.profiler`` traces.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import logging
import os
import random
import re
import secrets
import threading
import time
from bisect import bisect_left
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

logger = logging.getLogger("pio.tracing")
slow_logger = logging.getLogger("pio.tracing.slow")

# bucket upper bounds in seconds (log-ish scale), last bucket = +inf
_BOUNDS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5,
           1.0, 2.0, 5.0)


class LatencyHistogram:
    """Thread-safe histogram with percentile estimation.

    Percentiles are estimated by linear interpolation inside the matched
    bucket — good to within a bucket width, which is what a serving
    dashboard needs. Default bounds are latency-shaped (seconds, log
    scale); pass ``bounds`` to count other magnitudes (batch sizes,
    queue depths).
    """

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self._bounds: Tuple[float, ...] = (
            _BOUNDS if bounds is None else tuple(float(b) for b in bounds))
        if any(b2 <= b1 for b1, b2 in zip(self._bounds, self._bounds[1:])):
            raise ValueError("histogram bounds must be strictly increasing")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._bounds) + 1)
        self._total = 0
        self._sum = 0.0
        self._max = 0.0
        self._last = 0.0
        self._exemplar: Optional[Tuple[str, float]] = None

    @property
    def bounds(self) -> Tuple[float, ...]:
        return self._bounds

    def record(self, seconds: float,
               exemplar: Optional[str] = None) -> None:
        # bisect_left over the precomputed bounds: first bound >= value,
        # i.e. the same ``le`` bucket the old linear scan picked —
        # O(log n) instead of O(n) per observation on the hot path
        i = bisect_left(self._bounds, seconds)
        with self._lock:
            self._counts[i] += 1
            self._total += 1
            self._sum += seconds
            self._last = seconds
            if seconds > self._max:
                self._max = seconds
            if exemplar is not None:
                # trace-id exemplar: the most recent traced observation,
                # so a regressed histogram links to an openable trace
                self._exemplar = (exemplar, seconds)

    @property
    def exemplar(self) -> Optional[Tuple[str, float]]:
        """(trace_id, value) of the most recent traced observation."""
        with self._lock:
            return self._exemplar

    def _percentile_locked(self, q: float) -> float:
        if self._total == 0:
            return 0.0
        target = q * self._total
        acc = 0
        for i, c in enumerate(self._counts):
            if acc + c >= target and c > 0:
                lo = 0.0 if i == 0 else self._bounds[i - 1]
                hi = self._bounds[i] if i < len(self._bounds) else self._max
                frac = (target - acc) / c
                return lo + (max(hi, lo) - lo) * frac
            acc += c
        return self._max

    def summary(self) -> Dict[str, object]:
        with self._lock:
            if self._total == 0:
                return {"count": 0, "sumSec": 0.0}
            return {
                "count": self._total,
                "sumSec": self._sum,
                "meanSec": self._sum / self._total,
                "lastSec": self._last,
                "maxSec": self._max,
                "p50Sec": self._percentile_locked(0.50),
                "p90Sec": self._percentile_locked(0.90),
                "p99Sec": self._percentile_locked(0.99),
            }

    def buckets(self) -> List[Dict[str, object]]:
        """Per-bucket counts (NOT cumulative; see :meth:`cumulative` for
        the Prometheus ``le`` view)."""
        with self._lock:
            counts = list(self._counts)
        out = []
        for i, c in enumerate(counts):
            le = self._bounds[i] if i < len(self._bounds) else float("inf")
            out.append({"le": le, "count": c})
        return out

    @staticmethod
    def cumulate(counts: Sequence[int]) -> List[int]:
        """Per-bucket counts -> cumulative ``le`` counts. THE accumulation
        rule of the Prometheus histogram contract — both registry
        renderers and :meth:`cumulative` route through it so the
        exposition can never drift from this method."""
        out = []
        acc = 0
        for c in counts:
            acc += c
            out.append(acc)
        return out

    def cumulative(self) -> List[Dict[str, object]]:
        """Cumulative ``le`` buckets — the Prometheus histogram contract:
        each bucket counts every observation ≤ its bound, and the +inf
        bucket equals the total count (scrape-correct exposition)."""
        with self._lock:
            counts = list(self._counts)
        out = []
        for i, acc in enumerate(self.cumulate(counts)):
            le = self._bounds[i] if i < len(self._bounds) else float("inf")
            out.append({"le": le, "count": acc})
        return out

    def snapshot(self) -> Tuple[List[int], int, float, float, float]:
        """Consistent (counts, total, sum, max, last) under one lock."""
        with self._lock:
            return (list(self._counts), self._total, self._sum, self._max,
                    self._last)

    @classmethod
    def from_state(cls, bounds: Sequence[float], counts: Sequence[int],
                   total: Optional[int] = None, sum_sec: float = 0.0,
                   max_sec: float = 0.0,
                   last_sec: float = 0.0) -> "LatencyHistogram":
        """Rebuild a histogram from an externalized state (a parsed
        remote ``/metrics`` exposition, a snapshot entry) so fleet
        federation can fold member series through :meth:`merge` with
        exactly the local aggregation rules. ``bounds`` are the finite
        bucket bounds (the implicit +inf bucket is ``counts[-1]``);
        ``counts`` are per-bucket (NOT cumulative)."""
        h = cls(bounds=tuple(float(b) for b in bounds))
        counts = [int(c) for c in counts]
        if len(counts) != len(h._bounds) + 1:
            raise ValueError(
                "histogram state needs %d counts for %d bounds, got %d"
                % (len(h._bounds) + 1, len(h._bounds), len(counts)))
        if any(c < 0 for c in counts):
            raise ValueError("histogram bucket counts must be >= 0")
        h._counts = counts
        h._total = int(total) if total is not None else sum(counts)
        h._sum = float(sum_sec)
        h._max = float(max_sec)
        h._last = float(last_sec)
        return h

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold ``other``'s observations into this histogram (registry
        snapshot aggregation). Bounds must match; ``other`` is read under
        its own lock first so the merge never holds both locks at once."""
        if other._bounds != self._bounds:
            raise ValueError("cannot merge histograms with different bounds")
        counts, total, sum_, max_, last = other.snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._total += total
            self._sum += sum_
            if max_ > self._max:
                self._max = max_
            if total:
                self._last = last

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._total = 0
            self._sum = 0.0
            self._max = 0.0
            self._last = 0.0
            self._exemplar = None


# ---------------------------------------------------------------------------
# Request-scoped tracing
# ---------------------------------------------------------------------------

# The id of the HTTP request (or CLI run) the current thread is working
# for. contextvars propagate per-thread here: each server handler thread
# sets it on entry, so storage-op records and span() lines deep in the
# stack attribute themselves without any parameter threading.
_request_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pio_request_id", default=None)

# wire-safe id: printable, header-friendly, bounded
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._\-]{1,128}$")


def current_request_id() -> Optional[str]:
    return _request_id.get()


def set_request_id(rid: Optional[str]) -> contextvars.Token:
    """Bind the current context to ``rid``; returns the token for
    :func:`reset_request_id`."""
    return _request_id.set(rid)


def reset_request_id(token: contextvars.Token) -> None:
    _request_id.reset(token)


def ensure_request_id(given: Optional[str] = None) -> str:
    """Accept a client-supplied ``X-Request-ID`` when it is wire-safe,
    else mint a fresh one (16 hex chars)."""
    if given and _REQUEST_ID_RE.match(given):
        return given
    return secrets.token_hex(8)


@contextlib.contextmanager
def request_scope(given: Optional[str] = None):
    """Context manager binding a request id for the block; yields the id."""
    rid = ensure_request_id(given)
    token = set_request_id(rid)
    try:
        yield rid
    finally:
        reset_request_id(token)


# ---------------------------------------------------------------------------
# Structured spans — trace context + W3C traceparent
# ---------------------------------------------------------------------------

# monotonic→epoch anchor: every span timestamp is this one wall-clock
# reading plus a perf_counter delta, so all spans of a process share one
# clock — a child's start can never precede its parent's and integer-µs
# Chrome export stays monotonically consistent
_EPOCH_ANCHOR = time.time() - time.perf_counter()


def _now() -> float:
    return _EPOCH_ANCHOR + time.perf_counter()


# ids need uniqueness, not cryptographic strength — token_hex pays an
# os.urandom syscall per id, which dominated the per-span cost. One
# secrets-seeded PRNG per thread keeps ids unpredictable-enough and ~4x
# cheaper on the serving hot path.
_id_rng = threading.local()

_PID = os.getpid()
if hasattr(os, "register_at_fork"):  # keep span pids honest across fork
    os.register_at_fork(
        after_in_child=lambda: globals().__setitem__("_PID", os.getpid()))


def _rng() -> random.Random:
    rng = getattr(_id_rng, "rng", None)
    if rng is None:
        rng = _id_rng.rng = random.Random(secrets.randbits(64))
    return rng


def new_trace_id() -> str:
    return f"{_rng().getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_rng().getrandbits(64):016x}"


class SpanContext:
    """(trace_id, active span_id, sampled) — what propagates: into child
    spans in-process, as ``traceparent`` across processes."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self) -> str:
        return (f"SpanContext({self.trace_id!r}, {self.span_id!r}, "
                f"sampled={self.sampled})")


_trace_ctx: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar("pio_trace_ctx", default=None)


def current_trace_context() -> Optional[SpanContext]:
    return _trace_ctx.get()


def current_trace_id() -> Optional[str]:
    ctx = _trace_ctx.get()
    return ctx.trace_id if ctx is not None else None


# W3C Trace Context, version 00: 2-2-32-16-2 hex fields
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """A remote parent from a ``traceparent`` header, or None for any
    absent/malformed/all-zero value (a bad header must never break a
    request — the server just starts a fresh trace)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id,
                       sampled=bool(int(flags, 16) & 0x01))


def format_traceparent(ctx: SpanContext) -> str:
    return (f"00-{ctx.trace_id}-{ctx.span_id}-"
            f"{'01' if ctx.sampled else '00'}")


def current_traceparent() -> Optional[str]:
    """The header value to inject into an outgoing request (resthttp
    wire, feedback POST), or None when no trace is active."""
    ctx = _trace_ctx.get()
    return format_traceparent(ctx) if ctx is not None else None


def current_sampled_trace_id() -> Optional[str]:
    """The active trace id ONLY when head sampling retained it — what a
    histogram exemplar may point at (an unsampled trace's id would 404
    on GET /traces/<id> unless it later turns out slow/errored)."""
    ctx = _trace_ctx.get()
    return ctx.trace_id if ctx is not None and ctx.sampled else None


def outbound_context_headers() -> Dict[str, str]:
    """THE outbound propagation rule: the headers every cross-process
    call (resthttp wire, feedback POST) forwards so the receiving
    process joins this request's attribution — one definition, used by
    every client site."""
    headers: Dict[str, str] = {}
    rid = _request_id.get()
    if rid:
        headers["X-Request-ID"] = rid
    ctx = _trace_ctx.get()
    if ctx is not None:
        headers["traceparent"] = format_traceparent(ctx)
    return headers


def carrying_context(fn: Callable) -> Callable:
    """Wrap ``fn`` to run under a snapshot of the CURRENT contextvars
    (request id + trace context): hand the result to a worker thread and
    the work stays attributed to this request/trace."""
    snapshot = contextvars.copy_context()
    return lambda *args, **kwargs: snapshot.run(fn, *args, **kwargs)


class Span:
    """One timed operation in a trace tree."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "attributes", "error", "thread")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str,
                 attributes: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = _now()
        self.end: Optional[float] = None
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.error = False
        self.thread = threading.get_ident()

    def duration(self) -> float:
        return (self.end if self.end is not None else _now()) - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end if self.end is not None else self.start,
            "durationSec": round(self.duration(), 9),
            "attributes": self.attributes,
            "error": self.error,
            "thread": self.thread,
            "pid": _PID,
        }


def _iso(epoch: float) -> str:
    import datetime as _dt

    return _dt.datetime.fromtimestamp(
        epoch, tz=_dt.timezone.utc).isoformat()


class TraceBuffer:
    """Bounded thread-safe store of finished traces.

    - spans of in-flight traces accumulate per trace_id (capped at
      ``max_spans_per_trace``; overflow is counted, not stored);
    - when a LOCAL ROOT span ends (:meth:`flush`), the trace is retained
      iff it was head-sampled OR slow (duration ≥
      ``slow_threshold_sec``) OR errored — the always-keep lane;
    - retained traces live in a FIFO ring of ``max_traces`` (oldest
      evicted first); slow/errored roots additionally append a summary
      to the slow-query log ring (and the ``pio.tracing.slow`` logger);
    - the head-sampling decision is a seeded :class:`random.Random`, so
      a fixed seed reproduces the exact keep/drop sequence.
    """

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 512,
                 max_slow: int = 256,
                 sample_rate: Optional[float] = None,
                 slow_threshold_sec: Optional[float] = None,
                 enabled: Optional[bool] = None,
                 seed: Optional[int] = None):
        def env_float(name: str, default: float) -> float:
            # a malformed env knob must not crash every pio command at
            # import (the module singleton evaluates this) — same
            # tolerance contract as parse_traceparent
            raw = os.environ.get(name)
            if raw is None:
                return default
            try:
                return float(raw)
            except ValueError:
                logger.warning("ignoring malformed %s=%r (using %s)",
                               name, raw, default)
                return default

        if sample_rate is None:
            sample_rate = env_float("PIO_TRACE_SAMPLE", 1.0)
        if slow_threshold_sec is None:
            slow_threshold_sec = env_float("PIO_TRACE_SLOW_SEC", 0.5)
        if enabled is None:
            enabled = os.environ.get("PIO_TRACING", "1").strip().lower() \
                not in ("0", "off", "false")
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.slow_threshold_sec = float(slow_threshold_sec)
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        # open local roots per trace_id (a trace can have several, e.g.
        # two resthttp calls of one remote query hitting this server)
        self._roots: Dict[str, int] = {}
        self._open: Dict[str, List[Span]] = {}
        self._dropped: Dict[str, int] = {}
        self._done: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        self._slow: "collections.deque" = collections.deque(maxlen=max_slow)
        self._export_dir: Optional[str] = None
        self._export_lock = threading.Lock()

    # -- sampling ----------------------------------------------------------
    def sample(self) -> bool:
        """One head-sampling decision (deterministic under a seed)."""
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < rate

    # -- collection --------------------------------------------------------
    def root_started(self, trace_id: str) -> None:
        with self._lock:
            self._roots[trace_id] = self._roots.get(trace_id, 0) + 1

    def add_span(self, span: Span) -> None:
        """A finished span. Goes to the in-flight set while a local root
        is open; a late span (e.g. async work outliving its request)
        lands directly on the retained record, or is dropped when the
        trace was not retained."""
        if not self.enabled:
            return
        tid = span.trace_id
        with self._lock:
            if self._roots.get(tid):
                spans = self._open.setdefault(tid, [])
                if len(spans) >= self.max_spans_per_trace:
                    self._dropped[tid] = self._dropped.get(tid, 0) + 1
                    return
                spans.append(span)
                return
            rec = self._done.get(tid)
            if rec is not None \
                    and len(rec["spans"]) < self.max_spans_per_trace:
                rec["spans"].append(span)

    def flush(self, root: Span, sampled: bool) -> None:
        """Retire a local root: decide retention, update the slow-query
        log, export. Called by :func:`trace_scope` at root exit. Span
        objects are retained as-is — rendering them to dicts happens at
        READ time (``get``/``index``/export), off the serving path."""
        if not self.enabled:
            return
        tid = root.trace_id
        duration = root.duration()
        # batch jobs (train, batchpredict) exempt themselves: a 40min
        # train pass is not a slow QUERY and must not drown the log
        slow = duration >= self.slow_threshold_sec \
            and not root.attributes.get("slowExempt")
        err = root.error
        record: Optional[Dict[str, Any]] = None
        new_spans: List[Span] = []
        slow_entry: Optional[Dict[str, Any]] = None
        with self._lock:
            open_roots = self._roots.get(tid, 1) - 1
            if open_roots > 0:
                self._roots[tid] = open_roots
            else:
                self._roots.pop(tid, None)
            if open_roots > 0 and not (sampled or slow or err):
                # a sibling root is still collecting; leave the spans
                self._open.setdefault(tid, []).append(root)
                return
            new_spans = self._open.pop(tid, [])
            new_spans.append(root)
            dropped = self._dropped.pop(tid, 0)
            keep = sampled or slow or err
            existing = self._done.get(tid)
            if existing is not None:
                existing["spans"].extend(new_spans)
                existing["droppedSpans"] += dropped
                existing["error"] = existing["error"] or err
                existing["slow"] = existing["slow"] or slow
                existing["durationSec"] = max(existing["durationSec"],
                                              round(duration, 9))
                self._done.move_to_end(tid)
                record = existing
            elif keep:
                record = {
                    "traceId": tid,
                    "root": root.name,
                    "startEpoch": root.start,
                    "durationSec": round(duration, 9),
                    "slow": slow,
                    "error": err,
                    "sampled": sampled,
                    "droppedSpans": dropped,
                    "process": {"pid": _PID},
                    "spans": list(new_spans),
                }
                self._done[tid] = record
                while len(self._done) > self.max_traces:
                    self._done.popitem(last=False)
            if slow or err:
                slow_entry = {
                    "time": _iso(root.start),
                    "traceId": tid,
                    "name": root.name,
                    "durationSec": round(duration, 6),
                    "error": err,
                    "spans": len(new_spans),
                }
                # dispatch context: the device-telemetry layer
                # attaches its flight record to the device.* span, so a
                # slow exemplar names its bucket/batch/fill/kernel/AOT
                # outcome — diagnosable without reproducing it
                disp = None
                for s in new_spans:
                    d = getattr(s, "attributes", {}).get("dispatch")
                    if d is not None:
                        disp = d
                if disp is not None:
                    slow_entry["dispatch"] = disp
                capture = PROFILER.active_dir
                if capture:
                    # a profiler capture was running while this query
                    # was slow: the slow log links straight to it
                    slow_entry["profileCapture"] = capture
                self._slow.append(slow_entry)
        if slow_entry is not None:
            slow_logger.warning(
                "%s trace %s: %s took %.3fs (%d spans)",
                "errored" if err else "slow", tid, root.name, duration,
                slow_entry["spans"])
        if record is not None and self._export_dir:
            self._export(self._render(record, spans=new_spans),
                         slow_entry)

    @staticmethod
    def _render(record: Dict[str, Any],
                spans: Optional[List[Any]] = None) -> Dict[str, Any]:
        """A retained record as pure JSON-shaped data (spans may still
        be live Span objects internally)."""
        use = record["spans"] if spans is None else spans
        out = {k: v for k, v in record.items()
               if k not in ("spans", "startEpoch")}
        out["startTime"] = _iso(record["startEpoch"])
        out["spans"] = [s.to_dict() if isinstance(s, Span) else s
                        for s in use]
        return out

    # -- reads -------------------------------------------------------------
    def index(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Summaries of retained traces, newest first."""
        with self._lock:
            recent = [(rec, len(rec["spans"]))
                      for rec in list(self._done.values())[-limit:]]
        out = []
        for rec, n_spans in reversed(recent):
            summary = {k: rec[k] for k in
                       ("traceId", "root", "durationSec", "slow",
                        "error", "droppedSpans")}
            summary["startTime"] = _iso(rec["startEpoch"])
            summary["spans"] = n_spans
            out.append(summary)
        return out

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._done.get(trace_id)
            if rec is None:
                return None
            spans = list(rec["spans"])
        return self._render({**rec, "spans": spans})

    def slow_log(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Recent slow/errored trace summaries, newest first."""
        with self._lock:
            return list(self._slow)[-limit:][::-1]

    def reset(self) -> None:
        with self._lock:
            self._roots.clear()
            self._open.clear()
            self._dropped.clear()
            self._done.clear()
            self._slow.clear()

    # -- file export -------------------------------------------------------
    def set_export_dir(self, path: Optional[str]) -> None:
        if path:
            os.makedirs(path, exist_ok=True)
        self._export_dir = path

    def _export(self, record: Dict[str, Any],
                slow_entry: Optional[Dict[str, Any]]) -> None:
        d = self._export_dir
        if not d:
            return
        try:
            with self._export_lock:
                path = os.path.join(d, f"traces-{os.getpid()}.jsonl")
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(record, separators=(",", ":"))
                            + "\n")
                if slow_entry is not None:
                    with open(os.path.join(d, "slow-queries.log"), "a",
                              encoding="utf-8") as f:
                        f.write(json.dumps(slow_entry,
                                           separators=(",", ":")) + "\n")
        except OSError:
            logger.exception("trace export to %s failed", d)


# the process-wide buffer (the analog of metrics.REGISTRY)
TRACES = TraceBuffer()


def trace_buffer() -> TraceBuffer:
    return TRACES


def set_tracing_enabled(enabled: bool) -> None:
    """Process-wide tracing switch (``--tracing on|off`` /
    ``PIO_TRACING``). Disabled, :func:`span` is the plain log-line timer
    and :func:`trace_scope` yields None."""
    TRACES.enabled = bool(enabled)


def set_trace_dir(path: Optional[str]) -> None:
    """JSONL-export every retained trace (and slow-query summaries) to
    files under ``path`` (``--trace-dir`` / ``$PIO_TRACE_DIR``)."""
    TRACES.set_export_dir(path)


def load_traces_from_dir(path: str, trace_id: Optional[str] = None,
                         limit: Optional[int] = None
                         ) -> List[Dict[str, Any]]:
    """Read trace records back from a ``--trace-dir``, merging fragments
    of the same trace_id across files (i.e. across processes)."""
    # the fold itself (topmost-fragment-wins naming, max-duration, OR'd
    # error/slow) is shared with the balancer's live trace assembly:
    # predictionio_tpu_torch/obs/assemble.py. Lazy import: obs is a
    # consumer of this module.
    from predictionio_tpu_torch.obs import assemble as _assemble
    merged: "collections.OrderedDict[str, Dict[str, Any]]" = \
        collections.OrderedDict()
    try:
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("traces-") and n.endswith(".jsonl"))
    except OSError:
        return []
    for name in names:
        try:
            with open(os.path.join(path, name), "r",
                      encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if trace_id is not None and trace_id not in line:
                        # substring pre-filter: a single-trace lookup
                        # over a months-old export must skip ~every
                        # line at I/O speed, not json-parse it
                        continue
                    try:
                        rec = json.loads(line)
                        tid = rec["traceId"]
                    except (json.JSONDecodeError, TypeError, KeyError):
                        continue
                    if trace_id is not None and tid != trace_id:
                        continue  # exact check behind the substring gate
                    prior = merged.get(tid)
                    if prior is None:
                        merged[tid] = rec
                    else:
                        # the fragment holding the TOPMOST span (no
                        # parent) names the merged trace: "pio.train",
                        # not the event server's wire-request root
                        merged[tid] = _assemble.fold_fragment(prior, rec)
        except OSError:
            continue
    out = list(merged.values())
    if limit is not None:
        out = out[-limit:]
    return out


def load_slow_log_from_dir(path: str, limit: int = 50
                           ) -> List[Dict[str, Any]]:
    """The last ``limit`` slow-query-log entries under a trace dir."""
    entries: List[Dict[str, Any]] = []
    try:
        with open(os.path.join(path, "slow-queries.log"), "r",
                  encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return []
    for line in lines[-limit:]:
        line = line.strip()
        if not line:
            continue
        try:
            entries.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return entries[::-1]


# -- span machinery ---------------------------------------------------------

def begin_span(name: str, attributes: Optional[Dict[str, Any]] = None,
               set_current: bool = True
               ) -> Tuple[Optional[Span], Optional[contextvars.Token]]:
    """Manual span start: a child of the current context, or (None,
    None) when no trace is active / tracing is off. ``set_current=False``
    skips rebinding the contextvar (for spans finished by callbacks that
    may not nest, e.g. a lazy storage scan)."""
    if not TRACES.enabled:
        return None, None
    ctx = _trace_ctx.get()
    if ctx is None:
        return None, None
    sp = Span(ctx.trace_id, new_span_id(), ctx.span_id, name, attributes)
    token = None
    if set_current:
        token = _trace_ctx.set(
            SpanContext(ctx.trace_id, sp.span_id, ctx.sampled))
    return sp, token


def finish_span(sp: Optional[Span],
                token: Optional[contextvars.Token] = None,
                error: Optional[BaseException] = None) -> None:
    """Manual span end: stamps the end time, flags the error, restores
    the context and records the span into the buffer."""
    if token is not None:
        _trace_ctx.reset(token)
    if sp is None:
        return
    sp.end = _now()
    if error is not None:
        sp.error = True
        sp.attributes.setdefault("exception", type(error).__name__)
    TRACES.add_span(sp)


@contextlib.contextmanager
def trace_scope(name: str, parent: Optional[SpanContext] = None,
                attributes: Optional[Dict[str, Any]] = None,
                slow_exempt: bool = False):
    """Open a LOCAL TRACE ROOT for the block and flush it at exit.

    - no active context, no ``parent``: a fresh trace (head-sampled);
    - ``parent`` given (a remote W3C traceparent): this process's root
      joins that trace and inherits its sampling decision;
    - a local context already active: degrades to a plain child
      :func:`span` (nested scopes don't start new traces).

    ``slow_exempt`` keeps a long-by-design job (train, batchpredict)
    out of the slow-QUERY log. Yields the root :class:`Span` (mutable:
    handlers set status attributes / the error flag before exit), or
    None when tracing is disabled."""
    buf = TRACES
    if not buf.enabled:
        yield None
        return
    if _trace_ctx.get() is not None:
        with span(name, attributes=attributes) as sp:
            yield sp
        return
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
        sampled = parent.sampled
    else:
        trace_id, parent_id = new_trace_id(), None
        sampled = buf.sample()
    attributes = dict(attributes or {})
    if slow_exempt:
        attributes["slowExempt"] = True
    root = Span(trace_id, new_span_id(), parent_id, name, attributes)
    buf.root_started(trace_id)
    token = _trace_ctx.set(SpanContext(trace_id, root.span_id, sampled))
    error: Optional[BaseException] = None
    try:
        yield root
    except BaseException as e:
        error = e
        raise
    finally:
        _trace_ctx.reset(token)
        root.end = _now()
        if error is not None:
            root.error = True
            root.attributes.setdefault("exception", type(error).__name__)
        buf.flush(root, sampled)  # flush records the root itself


@contextlib.contextmanager
def span(name: str, level: int = logging.DEBUG,
         histogram: Optional[LatencyHistogram] = None,
         attributes: Optional[Dict[str, Any]] = None):
    """Time a block. Inside an active trace this records a real child
    span (trace/span/parent ids, attributes, error flag) into the trace
    buffer; otherwise — or with tracing killed — it is exactly the old
    request-id-tagged log line. ``histogram`` additionally records the
    duration (how the DASE-stage spans feed ``pio_train_stage_seconds``).
    Yields the :class:`Span` (or None)."""
    t0 = time.perf_counter()
    sp, token = begin_span(name, attributes)
    error: Optional[BaseException] = None
    try:
        yield sp
    except BaseException as e:
        error = e
        raise
    finally:
        took = time.perf_counter() - t0
        finish_span(sp, token, error=error)
        if histogram is not None:
            histogram.record(took)
        rid = current_request_id()
        if rid:
            logger.log(level, "%s took %.3fs [rid=%s]", name, took, rid)
        else:
            logger.log(level, "%s took %.3fs", name, took)


def span_now() -> float:
    """The span clock (monotonic-anchored epoch seconds) — public so
    instrumentation that times work OUTSIDE the span machinery (the
    device-dispatch telemetry window) can stamp spans on the same clock
    every other span uses."""
    return _now()


def record_completed_span(name: str, start: float, end: float,
                          attributes: Optional[Dict[str, Any]] = None,
                          parent: Optional[SpanContext] = None
                          ) -> Optional[Span]:
    """Record an ALREADY-FINISHED span — for work whose window was
    timed with raw clock reads rather than a context manager (e.g. the
    serving kernel's launch-to-copy-back window, which must cost two
    clock reads, not a contextvar rebind). Parents under ``parent``
    when given, else the ambient context; no-ops (returns None) when
    tracing is off or no trace is active. ``start``/``end`` must come
    from :func:`span_now`."""
    if not TRACES.enabled:
        return None
    ctx = parent if parent is not None else _trace_ctx.get()
    if ctx is None:
        return None
    sp = Span(ctx.trace_id, new_span_id(), ctx.span_id, name, attributes)
    sp.start = float(start)
    sp.end = float(end)
    TRACES.add_span(sp)
    return sp


@contextlib.contextmanager
def detached_span(name: str, parent: Optional[SpanContext] = None,
                  attributes: Optional[Dict[str, Any]] = None):
    """A child span parented EXPLICITLY under ``parent`` (a SpanContext
    snapshot) instead of the ambient contextvar — for pipeline stages
    that run on worker threads the context never crossed (e.g. the
    ingest decode producer). Records into the trace buffer like any
    span, so Perfetto renders the cross-thread overlap; no-ops when
    tracing is off or no parent is supplied."""
    if not TRACES.enabled or parent is None:
        yield None
        return
    sp = Span(parent.trace_id, new_span_id(), parent.span_id, name,
              attributes)
    error: Optional[BaseException] = None
    try:
        yield sp
    except BaseException as e:
        error = e
        raise
    finally:
        sp.end = _now()
        if error is not None:
            sp.error = True
            sp.attributes.setdefault("exception", type(error).__name__)
        TRACES.add_span(sp)


class StageTimeline:
    """Thread-safe wall-span collector for pipeline overlap accounting.

    Each :meth:`scope` (or :meth:`wrap_iter` step) appends one
    ``(stage, start, end, thread)`` record in epoch seconds, from
    WHICHEVER thread ran it — producer decode spans interleave with
    consumer index/bucket spans. :meth:`summary` reduces them to
    per-stage busy totals, the union wall span, and the overlap ratio
    (busy/wall; 1.0 = fully serial, higher = real overlap);
    ``to_json`` is the per-stage timeline artifact, and the
    same scopes mirror into the trace buffer (via :func:`detached_span`
    when a parent context is given) so Perfetto shows the identical
    picture."""

    def __init__(self):
        self._spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def add(self, stage: str, start: float, end: float) -> None:
        with self._lock:
            self._spans.append({
                "stage": stage, "start": start, "end": end,
                "durationSec": round(end - start, 6),
                "thread": threading.get_ident(),
            })

    @contextlib.contextmanager
    def scope(self, stage: str,
              trace_parent: Optional[SpanContext] = None):
        # _now(): monotonic-derived epoch (same clock as every Span) —
        # a wall-clock step mid-ingest must not corrupt durations
        with detached_span(f"ingest.{stage}", trace_parent):
            t0 = _now()
            try:
                yield
            finally:
                self.add(stage, t0, _now())

    def wrap_iter(self, it, stage: str,
                  trace_parent: Optional[SpanContext] = None):
        """Yield from ``it`` timing each ``next()`` as one stage span —
        run inside a producer thread this measures exactly the decode
        wall time, on the decode thread."""
        it = iter(it)
        while True:
            with self.scope(stage, trace_parent):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def summary(self, spans: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
        if spans is None:
            spans = self.spans()
        if not spans:
            return {"stages": {}, "wall_sec": 0.0, "busy_sec": 0.0,
                    "overlap_ratio": None}
        stages: Dict[str, Dict[str, Any]] = {}
        for s in spans:
            st = stages.setdefault(s["stage"],
                                   {"busy_sec": 0.0, "spans": 0,
                                    "first_start": s["start"],
                                    "last_end": s["end"]})
            st["busy_sec"] += s["end"] - s["start"]
            st["spans"] += 1
            st["first_start"] = min(st["first_start"], s["start"])
            st["last_end"] = max(st["last_end"], s["end"])
        wall = (max(s["end"] for s in spans)
                - min(s["start"] for s in spans))
        busy = sum(s["end"] - s["start"] for s in spans)
        for st in stages.values():
            st["busy_sec"] = round(st["busy_sec"], 4)
            st["wall_span_sec"] = round(st.pop("last_end")
                                        - st.pop("first_start"), 4)
        return {
            "stages": stages,
            "wall_sec": round(wall, 4),
            "busy_sec": round(busy, 4),
            "overlap_ratio": round(busy / wall, 3) if wall > 0 else None,
        }

    def to_json(self) -> Dict[str, Any]:
        # ONE snapshot for origin, span list, and summary — a stage
        # still recording on another thread (e.g. the warm-up compile)
        # must not land between them and tear the artifact
        spans = self.spans()
        base = min((s["start"] for s in spans), default=0.0)
        return {
            "origin_epoch_sec": base,
            "spans": [{**s, "start": round(s["start"] - base, 6),
                       "end": round(s["end"] - base, 6)}
                      for s in spans],
            "summary": self.summary(spans),
        }


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def trace_to_chrome(record: Dict[str, Any]) -> Dict[str, Any]:
    """A retained trace record as Chrome-trace-event JSON: one complete
    (``ph: "X"``) event per span, µs timestamps/durations. Loadable in
    Perfetto (ui.perfetto.dev) and ``chrome://tracing``. Integer-µs
    endpoints are truncated from the same monotonic clock, so a child
    event always sits inside its parent's [ts, ts+dur] window."""
    default_pid = (record.get("process") or {}).get("pid", 0)
    events = []
    for s in record.get("spans", ()):
        ts = int(float(s["start"]) * 1e6)
        end = int(float(s["end"]) * 1e6)
        args = {k: v for k, v in (s.get("attributes") or {}).items()}
        args["spanId"] = s.get("spanId")
        if s.get("parentId"):
            args["parentId"] = s["parentId"]
        if s.get("error"):
            args["error"] = True
        events.append({
            "name": s["name"],
            "cat": "pio",
            "ph": "X",
            "ts": ts,
            "dur": max(0, end - ts),
            "pid": s.get("pid", default_pid),
            "tid": s.get("thread", 0),
            "args": args,
        })
    return {
        "displayTimeUnit": "ms",
        "otherData": {
            "traceId": record.get("traceId"),
            "root": record.get("root"),
            "source": "predictionio-tpu",
        },
        "traceEvents": events,
    }


def render_trace_html(record: Dict[str, Any]) -> str:
    """A minimal self-contained HTML timeline of one trace (the
    dashboard's trace view): one bar per span, offset/width proportional
    to start/duration, indented by tree depth."""
    import html as _html

    spans = sorted(record.get("spans", ()),
                   key=lambda s: float(s["start"]))
    if spans:
        t0 = min(float(s["start"]) for s in spans)
        t1 = max(float(s["end"]) for s in spans)
    else:
        t0, t1 = 0.0, 1.0
    total = max(t1 - t0, 1e-9)
    by_id = {s.get("spanId"): s for s in spans}

    def depth(s, _seen=None) -> int:
        d = 0
        seen = set()
        cur = s
        while cur is not None and cur.get("parentId") in by_id:
            if cur.get("spanId") in seen:
                break
            seen.add(cur.get("spanId"))
            cur = by_id[cur["parentId"]]
            d += 1
        return d

    rows = []
    for s in spans:
        left = (float(s["start"]) - t0) / total * 100.0
        width = max((float(s["end"]) - float(s["start"])) / total * 100.0,
                    0.15)
        ms = (float(s["end"]) - float(s["start"])) * 1000.0
        pad = depth(s) * 14
        color = "#c0392b" if s.get("error") else "#2e86c1"
        name = _html.escape(str(s["name"]))
        pid = s.get("pid", "")
        rows.append(
            f"<div class='row'><div class='label' "
            f"style='padding-left:{pad}px'>{name} "
            f"<span class='ms'>{ms:.2f}ms · pid {pid}</span></div>"
            f"<div class='track'><div class='bar' style='left:{left:.3f}%;"
            f"width:{width:.3f}%;background:{color}'></div></div></div>")
    tid = _html.escape(str(record.get("traceId", "")))
    head = _html.escape(str(record.get("root", "")))
    dur = float(record.get("durationSec", 0.0)) * 1000.0
    flags = []
    if record.get("slow"):
        flags.append("SLOW")
    if record.get("error"):
        flags.append("ERROR")
    flag_s = (" [" + ", ".join(flags) + "]") if flags else ""
    return f"""<!DOCTYPE html>
<html><head><title>Trace {tid}</title><style>
body {{ font-family: monospace; margin: 16px; }}
.row {{ display: flex; align-items: center; margin: 1px 0; }}
.label {{ width: 42%; white-space: nowrap; overflow: hidden;
          text-overflow: ellipsis; font-size: 12px; }}
.ms {{ color: #888; }}
.track {{ position: relative; flex: 1; height: 14px;
          background: #f2f3f4; }}
.bar {{ position: absolute; top: 2px; height: 10px; min-width: 1px; }}
</style></head><body>
<h2>Trace {tid}{flag_s}</h2>
<p>root: {head} · {dur:.2f}ms · {len(rows)} spans ·
started {_html.escape(str(record.get('startTime', '')))}</p>
{''.join(rows)}
</body></html>"""



# ---------------------------------------------------------------------------
# torch.profiler capture
# ---------------------------------------------------------------------------

class ProfilerBusyError(RuntimeError):
    """``start`` while a capture is already running: the profiler is
    process-global, so captures are strictly single-flight."""


class ProfilerNotRunningError(RuntimeError):
    """``stop`` with no active capture."""


TRACE_FILE = "trace.json"


def _profiler():
    """A ``torch.profiler.profile`` over the CPU and, where CUDA is
    present, the card's kernels and copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


class ProfilerCapture:
    """Single-flight on-demand ``torch.profiler`` capture for a live
    process, the start / stop twin of :func:`profile_trace` (same
    counter, same build-counter listener side effect). ``stop`` writes
    the capture as a Chrome trace file, ``trace.json``, in its
    directory.

    Captures land under a ``profiles/`` subdirectory next to the
    ``PIO_TRACE_DIR`` JSONL exports (or ``$PIO_PROFILE_DIR``, or a temp
    directory as the last resort), and the slow-query log cross-links
    entries recorded while a capture was running.

    The profiler must start and stop on one thread, while a server
    handles each request on a thread of its own: both run on this
    capture's one worker thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._prof = None
        self._t0: float = 0.0
        self._worker = None

    def _on_worker(self, fn: Callable[[], Any]) -> Any:
        if self._worker is None:
            from concurrent.futures import ThreadPoolExecutor

            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pio-profiler")
        return self._worker.submit(fn).result()

    @property
    def active_dir(self) -> Optional[str]:
        return self._dir

    def resolve_base_dir(self) -> str:
        """Where captures go: next to the trace export, else
        $PIO_PROFILE_DIR, else a fresh temp dir."""
        export = TRACES._export_dir
        if export:
            return os.path.join(export, "profiles")
        env = os.environ.get("PIO_PROFILE_DIR")
        if env:
            return env
        import tempfile

        return tempfile.mkdtemp(prefix="pio-profile-")

    def start(self, base_dir: Optional[str] = None) -> str:
        from predictionio_tpu_torch.utils import metrics

        with self._lock:
            if self._dir is not None:
                raise ProfilerBusyError(
                    f"a profiler capture is already running "
                    f"({self._dir}); stop it first")
            base = base_dir or self.resolve_base_dir()
            path = os.path.join(
                base, time.strftime("profile-%Y%m%dT%H%M%SZ", time.gmtime()))
            os.makedirs(path, exist_ok=True)
            metrics.install_jit_compile_listener()
            prof = _profiler()
            self._on_worker(prof.start)
            self._prof = prof
            self._dir = path
            self._t0 = time.perf_counter()
        metrics.PROFILE_CAPTURES_ACTIVE.set(1)
        logger.info("profiler capture started -> %s", path)
        return path

    def stop(self) -> Dict[str, Any]:
        from predictionio_tpu_torch.utils import metrics

        with self._lock:
            if self._dir is None:
                raise ProfilerNotRunningError(
                    "no profiler capture is running")
            path, prof = self._dir, self._prof
            def finish():
                prof.stop()
                prof.export_chrome_trace(os.path.join(path, TRACE_FILE))

            try:
                self._on_worker(finish)
            finally:
                # whatever stop did, the capture is over: clear the slot
                # and the gauge, or a failed stop would pin
                # pio_profile_capture_active at 1 with nothing running
                self._dir = self._prof = None
                metrics.PROFILE_CAPTURES_ACTIVE.set(0)
            took = time.perf_counter() - self._t0
        metrics.PROFILE_TRACES.inc()
        logger.info("profiler capture written to %s (%.3fs)", path, took)
        return {"profileDir": path, "durationSec": round(took, 3)}


PROFILER = ProfilerCapture()


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block into
    ``trace_dir`` (no-op yielding None when None): yields the
    ``torch.profiler.profile`` object, so a caller can read its events,
    and writes ``trace.json`` (Chrome trace, Perfetto) into the
    directory at exit. Each capture is counted in the metrics registry
    (``pio_profile_traces_total``) and, as a side effect of the first
    call, installs the build listener, so kernel-build count and time
    show up beside the trace."""
    if not trace_dir:
        yield None
        return
    from predictionio_tpu_torch.utils import metrics

    metrics.install_jit_compile_listener()
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.perf_counter()
    with _profiler() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    metrics.PROFILE_TRACES.inc()
    logger.info("profiler trace written to %s (%.3fs)", trace_dir,
                time.perf_counter() - t0)
