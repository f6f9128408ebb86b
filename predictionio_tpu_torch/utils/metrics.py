"""Process-wide metrics registry with Prometheus + JSON exposition.

The port's copy of ``predictionio_tpu/utils/metrics.py``:

- :class:`Counter` / :class:`Gauge` / :class:`Histogram`: labeled,
  thread-safe, registered in one process-wide :class:`MetricsRegistry`
  (histograms keep their samples in
  :class:`~predictionio_tpu_torch.utils.tracing.LatencyHistogram`).
- Two renderers over the same state: :meth:`MetricsRegistry.
  render_prometheus` (text exposition, byte-equal to the JAX package's
  for the same calls) and :meth:`MetricsRegistry.snapshot` (JSON for
  ``/stats.json``); :func:`parse_prometheus` is the inverse of the first.
- A process-wide kill switch (:func:`set_enabled`, env ``PIO_METRICS=0``):
  disabled, every ``inc`` / ``observe`` returns before taking a lock.
- :class:`BoundedLabel` caps the values a client-controlled label mints.

Every family of the JAX package is declared here under the same name,
labels and buckets, so a scrape of either package reads the same way.
These families mean something else in the port, and their help text
says what:

- ``pio_jit_compiles_total`` / ``pio_jit_compile_seconds_total`` count
  the port's builds at first use, one per ``nvcc`` build of a kernel
  source (``ops/_build.py``) or ``g++`` build of a native host kernel
  (``native/__init__.py``), and their wall seconds; the JAX package
  counts XLA compilations (:func:`install_jit_compile_listener`).
- ``pio_dispatch_device_seconds`` is the serving kernel's time between a
  pair of CUDA events recorded on its stream around the launch; the JAX
  package reads a host clock around ``block_until_ready``. On the CPU
  (the kernel's plain version) no device time is recorded.
- ``pio_profile_traces_total`` / ``pio_profile_capture_active`` count
  ``torch.profiler`` captures.
- ``pio_aot_cache_requests_total`` counts the serving ladder's lookups
  (``hit``: a CUDA graph replayed; ``miss_jit``: an eager dispatch),
  ``pio_aot_cache_evictions_total`` its evictions, and
  ``pio_aot_ladder_bytes`` the device bytes its graphs hold.
"""

from __future__ import annotations

import collections
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.utils.tracing import (
    LatencyHistogram,
    current_sampled_trace_id,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricError(ValueError):
    pass


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Sample-value formatting: integers without a fraction, +Inf/-Inf
    spelled the Prometheus way."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def _pairs_str(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(str(v))}"'
                     for n, v in pairs)
    return "{" + inner + "}"


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra is not None:
        pairs.append(extra)
    return _pairs_str(pairs)


class _Metric:
    """One named metric family; children are per-label-set series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: Sequence[str]):
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"invalid label name {ln!r} on {name}")
        self._registry = registry
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise MetricError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.label_names)

    def _new_child(self):
        raise NotImplementedError

    def _child(self, labels: Dict[str, str]):
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def labels(self, **labels: str):
        """Get-or-create the series for one label set."""
        return self._child(labels)

    def _items(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    def clear(self) -> None:
        with self._lock:
            self._children.clear()


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    """Monotonic labeled counter."""

    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not self._registry.enabled:
            return
        self._child(labels).inc(amount)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
        return 0.0 if child is None else child.value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Pull gauge: ``fn`` is called at scrape time (e.g. live queue
        depth) instead of pushing every transition."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")


class Gauge(_Metric):
    """Labeled gauge; supports push (set/inc/dec) and pull
    (set_function) styles."""

    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float, **labels: str) -> None:
        if not self._registry.enabled:
            return
        self._child(labels).set(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not self._registry.enabled:
            return
        self._child(labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float], **labels: str) -> None:
        # registered even when disabled: pull gauges are scrape-time only
        self._child(labels).set_function(fn)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
        return 0.0 if child is None else child.value


class Histogram(_Metric):
    """Labeled histogram over :class:`LatencyHistogram` children."""

    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 label_names: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(registry, name, help, label_names)
        self._buckets = None if buckets is None else tuple(buckets)

    def _new_child(self) -> LatencyHistogram:
        return LatencyHistogram(bounds=self._buckets)

    def observe(self, value: float, **labels: str) -> None:
        if not self._registry.enabled:
            return
        # an active SAMPLED trace id rides along as the series'
        # exemplar, so a regressed histogram links straight to an
        # openable trace (an unsampled id would usually 404)
        self._child(labels).record(value,
                                   exemplar=current_sampled_trace_id())

    def time(self, **labels: str):
        """Context manager recording the block's wall time."""
        import contextlib

        @contextlib.contextmanager
        def timer():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.observe(time.perf_counter() - t0, **labels)
        return timer()

    def child(self, **labels: str) -> LatencyHistogram:
        """The underlying LatencyHistogram (e.g. for ``summary()``)."""
        return self._child(labels)


class MetricsRegistry:
    """Thread-safe name -> metric family registry.

    ``counter``/``gauge``/``histogram`` are get-or-create: calling twice
    with the same (name, kind, labels) returns the same family, so any
    module can declare the metrics it touches without import-order
    coupling; a redefinition with a DIFFERENT kind or label set is a
    programming error and raises.
    """

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        if enabled is None:
            enabled = os.environ.get("PIO_METRICS", "1").strip().lower() \
                not in ("0", "off", "false")
        self.enabled = bool(enabled)

    # -- declaration ------------------------------------------------------
    def _declare(self, cls, name: str, help: str,
                 label_names: Sequence[str], **kwargs) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.label_names != tuple(label_names)):
                    raise MetricError(
                        f"metric {name} already registered as "
                        f"{existing.kind}{existing.label_names}")
                if cls is Histogram:
                    want = kwargs.get("buckets")
                    want = None if want is None else tuple(want)
                    if existing._buckets != want:
                        # silently returning the first family would feed
                        # the second declarer's observations into the
                        # wrong bounds (e.g. minutes into a 5s-top scale)
                        raise MetricError(
                            f"histogram {name} already registered with "
                            f"buckets {existing._buckets}, redeclared "
                            f"with {want}")
                return existing
            metric = cls(self, name, help, label_names, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str,
                label_names: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, label_names)

    def gauge(self, name: str, help: str,
              label_names: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str,
                  label_names: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._declare(Histogram, name, help, label_names,
                             buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every series (families stay declared) — test isolation."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    # -- renderers --------------------------------------------------------
    def _families(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4): ``# HELP``/``# TYPE``
        per family, cumulative ``le`` buckets + ``_sum``/``_count`` for
        histograms."""
        lines: List[str] = []
        for m in self._families():
            items = m._items()
            if not items:
                continue
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in items:
                if m.kind == "histogram":
                    counts, total, sum_, _mx, _last = child.snapshot()
                    bounds = child.bounds
                    for i, acc in enumerate(
                            LatencyHistogram.cumulate(counts)):
                        le = bounds[i] if i < len(bounds) else math.inf
                        ls = _label_str(m.label_names, key,
                                        extra=("le", _fmt_le(le)))
                        lines.append(f"{m.name}_bucket{ls} {acc}")
                    ls = _label_str(m.label_names, key)
                    lines.append(f"{m.name}_sum{ls} {repr(float(sum_))}")
                    lines.append(f"{m.name}_count{ls} {total}")
                else:
                    ls = _label_str(m.label_names, key)
                    lines.append(f"{m.name}{ls} {_fmt_value(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON view of the same state the Prometheus renderer exposes
        (``/stats.json``). Histogram series carry BOTH the cumulative
        ``le`` buckets (scrape parity) and the percentile summary."""
        out: Dict[str, Any] = {}
        for m in self._families():
            items = m._items()
            if not items:
                continue
            series = []
            for key, child in items:
                labels = dict(zip(m.label_names, key))
                if m.kind == "histogram":
                    counts, total, sum_, mx, last = child.snapshot()
                    buckets = []
                    bounds = child.bounds
                    for i, acc in enumerate(
                            LatencyHistogram.cumulate(counts)):
                        le = bounds[i] if i < len(bounds) else math.inf
                        buckets.append({"le": _fmt_le(le),
                                        "cumulative": acc})
                    entry = {
                        "labels": labels,
                        "count": total,
                        "sum": sum_,
                        "max": mx,
                        "last": last,
                        "buckets": buckets,
                        "summary": child.summary(),
                    }
                    ex = child.exemplar
                    if ex is not None:
                        entry["exemplar"] = {"traceId": ex[0],
                                             "value": ex[1]}
                    series.append(entry)
                else:
                    series.append({"labels": labels, "value": child.value})
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out


# ---------------------------------------------------------------------------
# The process-wide registry + the metric families every layer shares
# ---------------------------------------------------------------------------

REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return REGISTRY


# ---------------------------------------------------------------------------
# Shareable (de)serialization entry points — fleet federation
# parses member expositions back into snapshot-shaped families and
# re-renders merged families; both directions live HERE so they can
# never drift from render_prometheus()/snapshot() above.
# ---------------------------------------------------------------------------

def _parse_label_block(line: str, start: int) -> Tuple[Dict[str, str], int]:
    """Parse ``{a="b",c="d"}`` starting at ``line[start] == '{'``;
    returns (labels, index just past the closing brace). Handles the
    text-format escapes (\\\\, \\", \\n) inside quoted values."""
    labels: Dict[str, str] = {}
    i = start + 1
    n = len(line)
    while i < n:
        while i < n and line[i] in ", ":
            i += 1
        if i < n and line[i] == "}":
            return labels, i + 1
        eq = line.find("=", i)
        if eq == -1:
            raise MetricError(f"unterminated label block: {line!r}")
        name = line[i:eq].strip()
        i = eq + 1
        if i >= n or line[i] != '"':
            raise MetricError(f"unquoted label value: {line!r}")
        i += 1
        buf: List[str] = []
        while i < n:
            ch = line[i]
            if ch == "\\" and i + 1 < n:
                nxt = line[i + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                i += 2
                continue
            if ch == '"':
                i += 1
                break
            buf.append(ch)
            i += 1
        else:
            raise MetricError(f"unterminated label value: {line!r}")
        labels[name] = "".join(buf)
    raise MetricError(f"unterminated label block: {line!r}")


def _parse_sample_value(text: str) -> float:
    text = text.strip().split()[0]
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Inverse of :meth:`MetricsRegistry.render_prometheus`: parse a
    text exposition (version 0.0.4) into the same snapshot-shaped dict
    :meth:`MetricsRegistry.snapshot` produces, so federation can merge
    remote members with the local snapshot uniformly.

    Histogram ``max``/``last`` are not carried by the text format and
    parse as 0.0; summaries are omitted (the merged histogram is
    rebuilt through :class:`LatencyHistogram`, which recomputes them).
    Unparseable sample lines raise :class:`MetricError` — a skewed or
    garbage member should surface as a scrape problem, not as silently
    partial data."""
    helps: Dict[str, str] = {}
    kinds: Dict[str, str] = {}
    scalars: Dict[str, "collections.OrderedDict"] = {}
    hists: Dict[str, "collections.OrderedDict"] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):].split(None, 1)
            if rest:
                helps[rest[0]] = rest[1] if len(rest) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):].split(None, 1)
            if len(rest) == 2:
                kinds[rest[0]] = rest[1].strip()
            continue
        if line.startswith("#"):
            continue
        brace = line.find("{")
        sp = line.find(" ")
        if brace != -1 and (sp == -1 or brace < sp):
            name = line[:brace]
            labels, after = _parse_label_block(line, brace)
            value = _parse_sample_value(line[after:])
        else:
            if sp == -1:
                raise MetricError(f"malformed sample line: {line!r}")
            name = line[:sp]
            labels = {}
            value = _parse_sample_value(line[sp:])
        base = None
        part = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) \
                    and kinds.get(name[:-len(suffix)]) == "histogram":
                base, part = name[:-len(suffix)], suffix
                break
        if base is not None:
            fam = hists.setdefault(base, collections.OrderedDict())
            rest_labels = {k: v for k, v in labels.items() if k != "le"}
            key = tuple(sorted(rest_labels.items()))
            entry = fam.setdefault(key, {"labels": rest_labels,
                                         "count": 0, "sum": 0.0,
                                         "max": 0.0, "last": 0.0,
                                         "buckets": []})
            if part == "_bucket":
                if "le" not in labels:
                    raise MetricError(
                        f"histogram bucket without le: {line!r}")
                entry["buckets"].append({"le": labels["le"],
                                         "cumulative": int(value)})
            elif part == "_sum":
                entry["sum"] = float(value)
            else:
                entry["count"] = int(value)
            continue
        fam = scalars.setdefault(name, collections.OrderedDict())
        key = tuple(sorted(labels.items()))
        fam[key] = {"labels": labels, "value": value}
    out: Dict[str, Any] = {}
    for name in sorted(set(scalars) | set(hists)):
        if name in hists:
            series: List[Dict[str, Any]] = []
            for entry in hists[name].values():
                entry["buckets"].sort(
                    key=lambda b: float(b["le"].replace("+Inf", "inf")))
                series.append(entry)
            out[name] = {"type": "histogram",
                         "help": helps.get(name, ""), "series": series}
        else:
            out[name] = {"type": kinds.get(name, "untyped"),
                         "help": helps.get(name, ""),
                         "series": list(scalars[name].values())}
    return out


def histogram_from_snapshot(entry: Dict[str, Any]) -> LatencyHistogram:
    """Rebuild a :class:`LatencyHistogram` from one snapshot-shaped
    histogram series entry (cumulative ``le`` buckets). Raises
    :class:`MetricError` on malformed bucket sets (missing +Inf,
    non-monotonic cumulative counts) — federation reports these as
    member problems instead of merging garbage."""
    buckets = list(entry.get("buckets") or ())
    if not buckets:
        raise MetricError("histogram series has no buckets")
    bounds: List[float] = []
    cums: List[int] = []
    for b in buckets:
        le = str(b["le"])
        bounds.append(math.inf if le == "+Inf" else float(le))
        cums.append(int(b["cumulative"]))
    if not math.isinf(bounds[-1]):
        raise MetricError("histogram series is missing the +Inf bucket")
    counts: List[int] = []
    prev = 0
    for c in cums:
        if c < prev:
            raise MetricError(
                "histogram cumulative buckets must be non-decreasing")
        counts.append(c - prev)
        prev = c
    try:
        return LatencyHistogram.from_state(
            tuple(bounds[:-1]), counts, total=cums[-1],
            sum_sec=float(entry.get("sum", 0.0)),
            max_sec=float(entry.get("max", 0.0)),
            last_sec=float(entry.get("last", 0.0)))
    except ValueError as exc:
        raise MetricError(str(exc)) from exc


def histogram_snapshot_entry(hist: LatencyHistogram,
                             labels: Dict[str, str]) -> Dict[str, Any]:
    """One snapshot-shaped histogram series entry for ``hist`` —
    byte-identical in structure to :meth:`MetricsRegistry.snapshot`'s
    histogram entries (used for merged fleet series)."""
    counts, total, sum_, mx, last = hist.snapshot()
    bounds = hist.bounds
    buckets = []
    for i, acc in enumerate(LatencyHistogram.cumulate(counts)):
        le = bounds[i] if i < len(bounds) else math.inf
        buckets.append({"le": _fmt_le(le), "cumulative": acc})
    return {"labels": dict(labels), "count": total, "sum": sum_,
            "max": mx, "last": last, "buckets": buckets,
            "summary": hist.summary()}


def render_family_lines(name: str, kind: str,
                        series: Sequence[Dict[str, Any]],
                        extra: Optional[Tuple[str, str]] = None
                        ) -> List[str]:
    """Sample lines (no HELP/TYPE header) for snapshot-shaped series,
    matching :meth:`MetricsRegistry.render_prometheus` formatting.
    ``extra`` appends one more label pair to every sample — federation
    uses it to stamp ``member=`` on drill-down series."""
    lines: List[str] = []
    for entry in series:
        base = list((entry.get("labels") or {}).items())
        if extra is not None:
            base = base + [extra]
        if kind == "histogram":
            for b in entry.get("buckets") or ():
                pairs = base + [("le", str(b["le"]))]
                lines.append(
                    f"{name}_bucket{_pairs_str(pairs)}"
                    f" {int(b['cumulative'])}")
            ls = _pairs_str(base)
            lines.append(f"{name}_sum{ls} {repr(float(entry.get('sum', 0.0)))}")
            lines.append(f"{name}_count{ls} {int(entry.get('count', 0))}")
        else:
            lines.append(
                f"{name}{_pairs_str(base)}"
                f" {_fmt_value(float(entry.get('value', 0.0)))}")
    return lines


def set_enabled(enabled: bool) -> None:
    """Process-wide instrumentation switch (``--metrics on|off`` /
    ``PIO_METRICS``). Disabled, every inc/observe returns before taking
    a lock; declared families and live series stay readable."""
    REGISTRY.enabled = bool(enabled)


# power-of-two-ish counts for batch sizes / queue depths
COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)

# long-running work (training stages): seconds to hours — the default
# latency bounds top out at 5s and would collapse real stage times into
# the +Inf bucket
LONG_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0,
                1800.0, 7200.0)

# -- HTTP serving (event server + query server) ----------------------------
HTTP_REQUESTS = REGISTRY.counter(
    "pio_http_requests_total",
    "HTTP requests by server, route pattern, method and status code",
    ("server", "route", "method", "status"))
HTTP_LATENCY = REGISTRY.histogram(
    "pio_http_request_seconds",
    "End-to-end HTTP request latency by server and route pattern",
    ("server", "route"))

# -- ingest (event server) -------------------------------------------------
INGEST_EVENTS = REGISTRY.counter(
    "pio_ingest_events_total",
    "Ingested events by app, event type and response status",
    ("app_id", "event", "status"))

# -- query serving ---------------------------------------------------------
QUERY_LATENCY = REGISTRY.histogram(
    "pio_query_seconds",
    "Query-path latency (extract+predict+serve) per engine variant",
    ("variant",))
MICROBATCH_QUERIES = REGISTRY.counter(
    "pio_microbatch_queries_total",
    "Queries served through a micro-batched device dispatch",
    ("batcher",))
MICROBATCH_DISPATCHES = REGISTRY.counter(
    "pio_microbatch_dispatches_total",
    "Device dispatches issued by the micro-batcher",
    ("batcher",))
MICROBATCH_QUEUE_DEPTH = REGISTRY.gauge(
    "pio_microbatch_queue_depth",
    "Requests currently waiting in the micro-batcher queue",
    ("batcher",))
MICROBATCH_BATCH_SIZE = REGISTRY.histogram(
    "pio_microbatch_batch_size",
    "Queries merged into one device dispatch",
    ("batcher",), buckets=COUNT_BUCKETS)
MICROBATCH_TRIGGERS = REGISTRY.counter(
    "pio_microbatch_dispatch_triggers_total",
    "Dispatches by what formed the batch (size = max_batch reached; "
    "window = the oldest query's PIO_BATCH_WINDOW budget expired; "
    "drain = shutdown flush)",
    ("batcher", "trigger"))
# fill ratio needs its own bounds: COUNT_BUCKETS are absolute sizes,
# but a half-full 256-batch and a half-full 8-batch mean the same thing
FILL_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
MICROBATCH_FILL = REGISTRY.histogram(
    "pio_microbatch_fill_ratio",
    "Dispatched batch size as a fraction of the lane's max_batch",
    ("batcher",), buckets=FILL_BUCKETS)
MICROBATCH_QUEUE_AT_DISPATCH = REGISTRY.histogram(
    "pio_microbatch_queue_depth_at_dispatch",
    "Pending queue depth observed at each dispatch (the percentile "
    "source for batcher_stats queueDepthPercentiles)",
    ("batcher",), buckets=COUNT_BUCKETS)

# -- storage ---------------------------------------------------------------
# ``shard`` is empty for direct (single-store) DAOs; the fleet router
# stamps it with the shard index on the per-shard legs it issues, so one
# slow or failing shard is visible inside the fan-out.
STORAGE_OP_LATENCY = REGISTRY.histogram(
    "pio_storage_op_seconds",
    "Event-store DAO operation latency by backend, op and shard",
    ("backend", "op", "shard"))
STORAGE_OP_ERRORS = REGISTRY.counter(
    "pio_storage_op_errors_total",
    "Event-store DAO operation failures by backend, op, error class "
    "and shard",
    ("backend", "op", "error", "shard"))

# -- resilience (retries, breakers, degradation, fault injection) ----------
STORAGE_RETRIES = REGISTRY.counter(
    "pio_storage_retries_total",
    "Storage-op retry attempts by backend and op (each retry masked one "
    "transient failure)",
    ("backend", "op"))
CIRCUIT_STATE = REGISTRY.gauge(
    "pio_circuit_state",
    "Circuit-breaker state per endpoint (0 closed, 1 open, 2 half-open)",
    ("endpoint",))
CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "pio_circuit_transitions_total",
    "Circuit-breaker state transitions by endpoint and target state",
    ("endpoint", "to"))
DEGRADED_QUERIES = REGISTRY.counter(
    "pio_degraded_queries_total",
    "Queries answered in degraded mode (storage down / breaker open / "
    "read timed out) instead of failing",
    ("reason",))
FEEDBACK_DROPPED = REGISTRY.counter(
    "pio_feedback_dropped_total",
    "Feedback-loop predict events dropped after the bounded retry", ())
MICROBATCH_REJECTIONS = REGISTRY.counter(
    "pio_microbatch_rejections_total",
    "Queries rejected (503 + Retry-After) after waiting past the "
    "micro-batcher queue deadline",
    ("batcher",))
FAULTS_INJECTED = REGISTRY.counter(
    "pio_faults_injected_total",
    "Faults fired by the PIO_FAULTS deterministic injection harness",
    ("backend", "op", "kind"))

# -- materialized entity-property aggregation ------------------------------
AGGREGATE_HITS = REGISTRY.counter(
    "pio_aggregate_hits_total",
    "aggregate_properties reads served from materialized state",
    ("backend",))
AGGREGATE_REPLAYS = REGISTRY.counter(
    "pio_aggregate_replays_total",
    "aggregate_properties reads that replayed event history "
    "(bounded = time-travel query; fallback = no/failed materialized state)",
    ("backend", "reason"))
AGGREGATE_BACKFILLS = REGISTRY.counter(
    "pio_aggregate_backfills_total",
    "Materialized-aggregation scope backfills (full history refolds)",
    ("backend",))
AGGREGATE_SCOPE_DROPS = REGISTRY.counter(
    "pio_aggregate_scope_drops_total",
    "Materialized-aggregation scope invalidations (partition rewrites, "
    "bulk deletes, app removals)",
    ("backend",))

# -- batch prediction ------------------------------------------------------
BATCHPREDICT_QUERIES = REGISTRY.counter(
    "pio_batchpredict_queries_total",
    "Batch-prediction queries by outcome (scored = computed this run; "
    "skipped = chunk already complete in the manifest)",
    ("status",))
BATCHPREDICT_CHUNK_LATENCY = REGISTRY.histogram(
    "pio_batchpredict_chunk_seconds",
    "Wall time to score and persist one batch-prediction chunk")
BATCHPREDICT_QPS = REGISTRY.gauge(
    "pio_batchpredict_queries_per_sec",
    "Scoring throughput of the most recent batch-prediction run")

# -- online fold-in --------------------------------------------------------
# event-ingested -> reflected-in-top-k can legitimately span the fold
# cadence (seconds), which the default latency bounds would collapse
# into +Inf
FRESHNESS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
                     60.0)
FOLDIN_FOLDS = REGISTRY.counter(
    "pio_foldin_folds_total",
    "Online fold-in batches by outcome (ok / error / dropped)",
    ("status",))
FOLDIN_TAIL_ERRORS = REGISTRY.counter(
    "pio_foldin_tail_errors_total",
    "Failed tail reads (one per failing poll; pio_foldin_stale holds 1 "
    "for the duration of the outage)", ())
FOLDIN_USERS = REGISTRY.counter(
    "pio_foldin_users_total",
    "User rows patched into the live factor store by the fold-in "
    "consumer (known = re-solved existing rows; new = store grown)",
    ("kind",))
FOLDIN_EVENTS = REGISTRY.counter(
    "pio_foldin_events_total",
    "Rating events consumed from the tail read and folded", ())
FOLDIN_FRESHNESS = REGISTRY.histogram(
    "pio_foldin_freshness_seconds",
    "Event ingested -> factors servable latency per folded event",
    buckets=FRESHNESS_BUCKETS)
FOLDIN_STALE = REGISTRY.gauge(
    "pio_foldin_stale",
    "1 while the fold-in tail read is failing (serving continues from "
    "the last-good factors, responses carry degradedReasons "
    "foldin_stale)", ())

# -- device-plane telemetry ------------------------------------------------
# device dispatches are sub-millisecond on a healthy accelerator; the
# default latency bounds' 0.5ms floor would collapse every dispatch
# into one bucket
DEVICE_DISPATCH_BUCKETS = (0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
                           0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.5, 2.0)
DISPATCH_DEVICE_SECONDS = REGISTRY.histogram(
    "pio_dispatch_device_seconds",
    "Device time per serving dispatch (CUDA events recorded on the "
    "launching stream around the serving kernel) by lane, kernel route "
    "and store precision",
    ("lane", "kernel", "precision"), buckets=DEVICE_DISPATCH_BUCKETS)
AOT_CACHE_REQUESTS = REGISTRY.counter(
    "pio_aot_cache_requests_total",
    "Serving-program lookups against the captured ladder (hit: a CUDA "
    "graph replayed; miss_jit: the dispatch ran eagerly)",
    ("result",))
AOT_CACHE_EVICTIONS = REGISTRY.counter(
    "pio_aot_cache_evictions_total",
    "Captured serving programs evicted from a bounded cache", ())
DEVICE_STORE_BYTES = REGISTRY.gauge(
    "pio_device_store_bytes",
    "HBM bytes pinned by live device factor stores (factors + scales + "
    "seen tables + normalized item matrix, across all live servers)", ())
AOT_LADDER_BYTES = REGISTRY.gauge(
    "pio_aot_ladder_bytes",
    "Device bytes held by the live stores' captured serving programs "
    "(their graph pools, measured)", ())
PROFILE_CAPTURES_ACTIVE = REGISTRY.gauge(
    "pio_profile_capture_active",
    "1 while an on-demand torch.profiler capture is running", ())

# -- training workflow -----------------------------------------------------
TRAIN_STAGE_LATENCY = REGISTRY.histogram(
    "pio_train_stage_seconds",
    "DASE pipeline stage wall time (read/prepare/train/eval)",
    ("stage",), buckets=LONG_BUCKETS)
JIT_COMPILES = REGISTRY.counter(
    "pio_jit_compiles_total",
    "Kernel builds at first use: one per nvcc build of a CUDA source or "
    "g++ build of a native host kernel", ())
JIT_COMPILE_SECONDS = REGISTRY.counter(
    "pio_jit_compile_seconds_total",
    "Cumulative wall time of the kernel builds at first use (nvcc and "
    "g++; parallel builds overlap)", ())
PROFILE_TRACES = REGISTRY.counter(
    "pio_profile_traces_total",
    "torch.profiler traces captured by profile_trace", ())
TRAIN_DIVERGED = REGISTRY.counter(
    "pio_train_diverged_total",
    "Training runs aborted by the per-chunk non-finite factor guard "
    "(the last intact checkpoint is retained)", ())
TRAIN_CHECKPOINTS = REGISTRY.counter(
    "pio_train_checkpoints_total",
    "Training-checkpoint events by outcome (saved / resumed / "
    "torn_skipped)", ("status",))
TRAIN_LOSS = REGISTRY.gauge(
    "pio_train_loss",
    "Latest on-device training-objective sample by component "
    "(fit / l2 / total); on the vmapped grid lane the best alive "
    "config's sample", ("component",))
TRAIN_CHUNK_SECONDS = REGISTRY.histogram(
    "pio_train_chunk_seconds",
    "Wall time of one checkpoint chunk (iteration scan + objective "
    "sample + checkpoint write)", (), buckets=LONG_BUCKETS)


class BoundedLabel:
    """Cap the distinct values a CLIENT-CONTROLLED label may mint.

    Series live for the process lifetime, so a label fed from request
    data (e.g. event names) would otherwise be an unbounded-memory lever
    for any client with an access key. The first ``cap`` distinct values
    keep their identity; everything after collapses to ``overflow``.
    """

    def __init__(self, cap: int = 100, overflow: str = "<other>"):
        self._cap = int(cap)
        self._overflow = overflow
        self._seen: set = set()
        self._lock = threading.Lock()

    def __call__(self, value: str) -> str:
        v = str(value)
        with self._lock:
            if v in self._seen:
                return v
            if len(self._seen) < self._cap:
                self._seen.add(v)
                return v
        return self._overflow


_jit_listener_lock = threading.Lock()
_jit_listener_installed = False


def install_jit_compile_listener() -> bool:
    """Register a listener on the port's two build-at-first-use steps
    (``ops/_build.py``'s ``nvcc`` and ``native``'s ``g++``) feeding the
    build counters (idempotent). The listener is a no-op while the
    registry is disabled, so installing it does not tax a metrics-off
    process."""
    global _jit_listener_installed
    with _jit_listener_lock:
        if _jit_listener_installed:
            return True
        from predictionio_tpu_torch import native
        from predictionio_tpu_torch.ops import _build

        def _on_build(name: str, seconds: float) -> None:
            if not REGISTRY.enabled:
                return
            JIT_COMPILES.inc()
            JIT_COMPILE_SECONDS.inc(max(0.0, float(seconds)))

        _build.BUILD_LISTENERS.append(_on_build)
        native.BUILD_LISTENERS.append(_on_build)
        _jit_listener_installed = True
        return True
