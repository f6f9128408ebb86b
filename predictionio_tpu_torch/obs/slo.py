"""Declarative SLOs evaluated as multi-window burn rates.

The port's copy of ``predictionio_tpu/obs/slo.py``.

The Google-SRE alerting recipe: an objective grants an error budget
(e.g. 1% of queries may be slower than 500ms); the *burn rate* is how
fast the fleet is spending that budget relative to plan (burn 1.0 =
exactly exhausting the budget over the window; 14.4 = the classic
"page: the 30-day budget is gone in 2 days" threshold). An alert fires
only when BOTH a fast window (default 5m — is it happening *now*?) and
a slow window (default 1h — is it *sustained*?) burn above threshold,
which keeps one bad request from paging while still catching real
regressions within minutes.

Objectives are evaluated against the *federated* metrics snapshot
(:mod:`predictionio_tpu_torch.obs.federation`), so the burn rate is
fleet-wide: a single bad replica moves it in proportion to the traffic
it serves. Built-in objectives:

- ``query_latency_p99`` — fraction of balancer ``/queries.json``
  requests slower than ``thresholdSec`` (default 0.5s), budget 1%.
  Computed bucket-exactly from the cumulative histogram, not from an
  interpolated percentile.
- ``error_rate`` — 5xx fraction of balancer ``/queries.json``
  responses, budget 1%.
- ``degraded_rate`` — fleet-wide ``pio_degraded_queries_total``
  (breaker-open / fault-injected / replica-down degradations) over
  balancer query traffic, budget 5%.

Config resolution order (later wins): built-in defaults →
``$PIO_SLO_CONFIG`` (inline JSON if it starts with ``{``, else a file
path) → ``--slo-config`` (same grammar) → targeted env overrides
(``PIO_SLO_FAST_WINDOW_SEC``, ``PIO_SLO_SLOW_WINDOW_SEC``,
``PIO_SLO_BURN_THRESHOLD``, ``PIO_SLO_<NAME>_BUDGET``,
``PIO_SLO_<NAME>_TARGET_SEC``, ``PIO_SLO_<NAME>_DISABLED``). JSON
grammar::

    {"fastWindowSec": 300, "slowWindowSec": 3600, "burnThreshold": 14.4,
     "objectives": {"query_latency_p99": {"thresholdSec": 0.5,
                                          "budget": 0.01,
                                          "disabled": false}}}

The engine keeps a ring of cumulative (total, bad) samples per
objective; a window's burn is computed from the delta between the
newest sample and the newest sample at least window-old. Until enough
history accumulates, windows shrink to the available history — alerts
can therefore fire (and clear) fast after startup, which is the
behavior an operator bootstrapping a fleet wants (and what the tests
rely on).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from predictionio_tpu_torch.utils import metrics

__all__ = ["Objective", "SLOConfig", "SLOEngine", "load_slo_config",
           "SLO_BURN_RATE", "SLO_BUDGET_REMAINING"]

DEFAULT_FAST_WINDOW_SEC = 300.0
DEFAULT_SLOW_WINDOW_SEC = 3600.0
DEFAULT_BURN_THRESHOLD = 14.4

# fleet SLO gauges, re-exported through the balancer's federated
# /metrics (and /stats.json "alerts" block)
SLO_BURN_RATE = metrics.REGISTRY.gauge(
    "pio_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = spending "
    "exactly the budget over the window)",
    label_names=("objective", "window"))
SLO_BUDGET_REMAINING = metrics.REGISTRY.gauge(
    "pio_slo_budget_remaining",
    "Fraction of the error budget left over the slow window "
    "(1.0 = untouched, <= 0 = exhausted)",
    label_names=("objective",))


@dataclasses.dataclass
class Objective:
    name: str
    kind: str                      # "latency" | "error" | "degraded"
    budget: float                  # allowed bad fraction, e.g. 0.01
    threshold_sec: Optional[float] = None  # latency objectives only
    disabled: bool = False

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "budget": self.budget}
        if self.threshold_sec is not None:
            out["thresholdSec"] = self.threshold_sec
        if self.disabled:
            out["disabled"] = True
        return out


def _default_objectives() -> "collections.OrderedDict[str, Objective]":
    return collections.OrderedDict([
        ("query_latency_p99",
         Objective("query_latency_p99", "latency", budget=0.01,
                   threshold_sec=0.5)),
        ("error_rate", Objective("error_rate", "error", budget=0.01)),
        ("degraded_rate",
         Objective("degraded_rate", "degraded", budget=0.05)),
    ])


@dataclasses.dataclass
class SLOConfig:
    fast_window_sec: float = DEFAULT_FAST_WINDOW_SEC
    slow_window_sec: float = DEFAULT_SLOW_WINDOW_SEC
    burn_threshold: float = DEFAULT_BURN_THRESHOLD
    objectives: "collections.OrderedDict[str, Objective]" = \
        dataclasses.field(default_factory=_default_objectives)


def _apply_json(cfg: SLOConfig, doc: Dict[str, Any], origin: str) -> None:
    if not isinstance(doc, dict):
        raise ValueError(f"SLO config from {origin} must be a JSON object")
    if "fastWindowSec" in doc:
        cfg.fast_window_sec = float(doc["fastWindowSec"])
    if "slowWindowSec" in doc:
        cfg.slow_window_sec = float(doc["slowWindowSec"])
    if "burnThreshold" in doc:
        cfg.burn_threshold = float(doc["burnThreshold"])
    for name, spec in (doc.get("objectives") or {}).items():
        if not isinstance(spec, dict):
            raise ValueError(
                f"SLO objective {name!r} from {origin} must be an object")
        obj = cfg.objectives.get(name)
        if obj is None:
            kind = spec.get("kind")
            if kind not in ("latency", "error", "degraded"):
                raise ValueError(
                    f"unknown SLO objective {name!r} from {origin} "
                    "needs kind latency|error|degraded")
            obj = Objective(name, kind, budget=0.01)
            cfg.objectives[name] = obj
        if "budget" in spec:
            obj.budget = float(spec["budget"])
        if "thresholdSec" in spec:
            obj.threshold_sec = float(spec["thresholdSec"])
        if "disabled" in spec:
            obj.disabled = bool(spec["disabled"])


def _load_json_source(cfg: SLOConfig, source: str, origin: str) -> None:
    text = source.strip()
    if not text:
        return
    if not text.startswith("{"):
        with open(text, "r", encoding="utf-8") as f:
            text = f.read()
        origin = f"{origin} ({source})"
    _apply_json(cfg, json.loads(text), origin)


def load_slo_config(explicit: Optional[str] = None,
                    env: Optional[Dict[str, str]] = None) -> SLOConfig:
    """Resolve the effective SLO config (see module docstring for the
    precedence chain and grammar)."""
    env = os.environ if env is None else env
    cfg = SLOConfig()
    src = env.get("PIO_SLO_CONFIG")
    if src:
        _load_json_source(cfg, src, "$PIO_SLO_CONFIG")
    if explicit:
        _load_json_source(cfg, explicit, "--slo-config")
    if env.get("PIO_SLO_FAST_WINDOW_SEC"):
        cfg.fast_window_sec = float(env["PIO_SLO_FAST_WINDOW_SEC"])
    if env.get("PIO_SLO_SLOW_WINDOW_SEC"):
        cfg.slow_window_sec = float(env["PIO_SLO_SLOW_WINDOW_SEC"])
    if env.get("PIO_SLO_BURN_THRESHOLD"):
        cfg.burn_threshold = float(env["PIO_SLO_BURN_THRESHOLD"])
    for name, obj in cfg.objectives.items():
        prefix = "PIO_SLO_" + name.upper()
        if env.get(prefix + "_BUDGET"):
            obj.budget = float(env[prefix + "_BUDGET"])
        if env.get(prefix + "_TARGET_SEC"):
            obj.threshold_sec = float(env[prefix + "_TARGET_SEC"])
        if env.get(prefix + "_DISABLED"):
            obj.disabled = env[prefix + "_DISABLED"].lower() \
                not in ("0", "false", "no", "")
    if cfg.fast_window_sec <= 0 or cfg.slow_window_sec <= 0:
        raise ValueError("SLO windows must be > 0 seconds")
    if cfg.fast_window_sec > cfg.slow_window_sec:
        raise ValueError("SLO fast window must be <= slow window")
    return cfg


# -- extraction from a merged metrics snapshot ------------------------------

def _series(snapshot: Dict[str, Any], name: str) -> List[Dict[str, Any]]:
    return (snapshot.get(name) or {}).get("series") or []


def _balancer_query(entry: Dict[str, Any]) -> bool:
    labels = entry.get("labels") or {}
    return labels.get("server") == "balancer" \
        and labels.get("route") == "/queries.json"


def _http_totals(snapshot: Dict[str, Any]) -> Tuple[float, float]:
    """(total, 5xx) balancer /queries.json requests."""
    total = bad = 0.0
    for entry in _series(snapshot, "pio_http_requests_total"):
        if not _balancer_query(entry):
            continue
        v = float(entry.get("value", 0.0))
        total += v
        if str((entry.get("labels") or {}).get("status", "")
               ).startswith("5"):
            bad += v
    return total, bad


def _latency_counts(snapshot: Dict[str, Any],
                    threshold_sec: float) -> Tuple[float, float]:
    """(total, slower-than-threshold) balancer /queries.json requests,
    bucket-exact: "good" is the cumulative count at the smallest bound
    >= threshold, so a threshold between bounds rounds *against* the
    SLO (conservative)."""
    total = bad = 0.0
    for entry in _series(snapshot, "pio_http_request_seconds"):
        if not _balancer_query(entry):
            continue
        count = float(entry.get("count", 0.0))
        good = None
        for b in entry.get("buckets") or ():
            le = str(b["le"])
            bound = float("inf") if le == "+Inf" else float(le)
            if bound >= threshold_sec:
                good = float(b["cumulative"])
                break
        total += count
        bad += count - (count if good is None else min(good, count))
    return total, bad


def _degraded_counts(snapshot: Dict[str, Any]) -> Tuple[float, float]:
    total, _ = _http_totals(snapshot)
    bad = sum(float(e.get("value", 0.0))
              for e in _series(snapshot, "pio_degraded_queries_total"))
    return total, bad


def _extract(obj: Objective, snapshot: Dict[str, Any]
             ) -> Tuple[float, float]:
    if obj.kind == "latency":
        return _latency_counts(snapshot, obj.threshold_sec or 0.5)
    if obj.kind == "error":
        return _http_totals(snapshot)
    return _degraded_counts(snapshot)


# -- the engine -------------------------------------------------------------

class SLOEngine:
    """Evaluates objectives over a ring of cumulative samples and
    remembers the firing state (so ``/healthz`` readiness can consult
    it without triggering a scrape)."""

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = config or SLOConfig()
        self._lock = threading.Lock()
        self._samples: Deque[Tuple[float, Dict[str, Tuple[float, float]]]] \
            = collections.deque()
        self._since: Dict[str, str] = {}
        self._firing: List[str] = []
        self._last_block: Optional[Dict[str, Any]] = None

    # -- window math --------------------------------------------------------
    def _window_delta(self, name: str, window: float, now: float
                      ) -> Tuple[float, float]:
        """Delta (total, bad) between the newest sample and the newest
        sample at least ``window`` old (or the oldest retained — the
        startup window-shrink documented in the module docstring)."""
        cur = self._samples[-1][1].get(name, (0.0, 0.0))
        ref = None
        for t, vals in self._samples:
            if t <= now - window:
                ref = vals.get(name, (0.0, 0.0))
            else:
                break
        if ref is None:
            ref = self._samples[0][1].get(name, (0.0, 0.0))
        # counter resets (member restart) can make deltas negative;
        # clamp instead of reporting a negative burn
        return (max(0.0, cur[0] - ref[0]), max(0.0, cur[1] - ref[1]))

    @staticmethod
    def _burn(total: float, bad: float, budget: float) -> float:
        if total <= 0 or budget <= 0:
            return 0.0
        return (bad / total) / budget

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, snapshot: Dict[str, Any],
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Fold one federated snapshot into the sample ring, update the
        ``pio_slo_*`` gauges, and return the ``alerts`` block."""
        now = time.time() if now is None else float(now)
        cfg = self.config
        with self._lock:
            vals = {name: _extract(obj, snapshot)
                    for name, obj in cfg.objectives.items()
                    if not obj.disabled}
            self._samples.append((now, vals))
            horizon = now - cfg.slow_window_sec * 1.5
            while len(self._samples) > 2 and self._samples[1][0] < horizon:
                self._samples.popleft()
            objectives: Dict[str, Any] = {}
            firing: List[str] = []
            for name, obj in cfg.objectives.items():
                if obj.disabled:
                    continue
                ft, fb = self._window_delta(name, cfg.fast_window_sec, now)
                st, sb = self._window_delta(name, cfg.slow_window_sec, now)
                burn_fast = self._burn(ft, fb, obj.budget)
                burn_slow = self._burn(st, sb, obj.budget)
                spend = (sb / st) / obj.budget if st > 0 and obj.budget > 0 \
                    else 0.0
                remaining = max(-1.0, min(1.0, 1.0 - spend))
                is_firing = (fb > 0
                             and burn_fast >= cfg.burn_threshold
                             and burn_slow >= cfg.burn_threshold)
                SLO_BURN_RATE.set(burn_fast, objective=name, window="fast")
                SLO_BURN_RATE.set(burn_slow, objective=name, window="slow")
                SLO_BUDGET_REMAINING.set(remaining, objective=name)
                if is_firing:
                    firing.append(name)
                    self._since.setdefault(
                        name, time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime(now)))
                else:
                    self._since.pop(name, None)
                objectives[name] = {
                    **obj.describe(),
                    "burn": {"fast": round(burn_fast, 4),
                             "slow": round(burn_slow, 4)},
                    "budgetRemaining": round(remaining, 4),
                    "firing": is_firing,
                }
                if is_firing:
                    objectives[name]["since"] = self._since[name]
            block = {
                "firing": firing,
                "burnThreshold": cfg.burn_threshold,
                "windows": {"fastSec": cfg.fast_window_sec,
                            "slowSec": cfg.slow_window_sec},
                "objectives": objectives,
            }
            self._firing = firing
            self._last_block = block
            return block

    # -- reads --------------------------------------------------------------
    def firing(self) -> List[str]:
        with self._lock:
            return list(self._firing)

    def alerts_block(self) -> Dict[str, Any]:
        """The last evaluated alerts block (an empty shell before the
        first evaluation)."""
        with self._lock:
            if self._last_block is not None:
                return self._last_block
        cfg = self.config
        return {"firing": [], "burnThreshold": cfg.burn_threshold,
                "windows": {"fastSec": cfg.fast_window_sec,
                            "slowSec": cfg.slow_window_sec},
                "objectives": {}}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._since.clear()
            self._firing = []
            self._last_block = None
