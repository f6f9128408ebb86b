"""Fleet metrics federation: scrape every member, merge into one view.

The port's copy of ``predictionio_tpu/obs/federation.py``.

The query fleet splits observability across processes: the balancer
and its query replicas share one registry/trace buffer (in-process
replicas), but every event-store shard is its own process with its own
``/metrics``. This module gives the balancer (and ``pio status/top
--fleet``) a single federated view:

- **Members** = the local process (named ``balancer``) + every remote
  HTTP member (event-store shards from the fleet storage topology).
  Each remote is scraped over a keep-alive connection with a
  per-member timeout: ``GET /metrics`` (required — the member is
  ``member_down`` without it), ``GET /healthz`` (health detail + pid;
  a 503 still counts as a successful scrape — the member is alive and
  telling us it is not ready), ``GET /stats.json`` (optional
  enrichment, ignored unless it answers 200 with JSON).
- **Breakers**: each member's scrape runs behind a circuit
  breaker keyed ``scrape:<url>`` — namespaced away from the serving
  path's breakers so a flaky scrape can NEVER open the breaker the
  query router relies on, and vice versa. A dead member reports
  ``member_down`` in the scrape result; the scrape itself never
  raises and never blocks on a known-dead member beyond the breaker's
  probe schedule.
- **In-process members**: tests and benches run "remote" members in
  the balancer's own process, where they share the local registry.
  Members whose ``/healthz`` pid equals ours are flagged
  ``inProcess`` and excluded from the merge (their series already
  arrive via the local snapshot) — otherwise every shared counter
  would double-count.
- **Merge semantics**: counters sum across members; gauges stay
  per-member (each series gains a ``member`` label — summing
  utilization gauges would be a lie); histograms are rebuilt from
  their cumulative buckets and folded through
  :meth:`LatencyHistogram.merge`, which refuses mismatched bucket
  bounds — a version-skewed member surfaces in ``problems`` instead
  of corrupting the fleet series.
- **Exposition**: the merged families render as ONE fleet-wide
  Prometheus exposition, followed by per-member drill-down series
  labeled ``member="<name>"``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from predictionio_tpu_torch.utils import metrics, resilience

__all__ = ["FleetFederation", "FleetScrape", "merge_member_families",
           "render_fleet_prometheus"]

DEFAULT_TIMEOUT_SEC = 2.0


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

def merge_member_families(
        named: Sequence[Tuple[str, Dict[str, Any]]]
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Merge snapshot-shaped metric families from ``(member, snapshot)``
    pairs into one fleet-wide snapshot. Returns ``(merged, problems)``;
    problems record series that could not be merged (histogram bound
    skew, malformed entries) without failing the scrape."""
    problems: List[Dict[str, Any]] = []
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    counters: Dict[str, "dict"] = {}
    gauges: Dict[str, "dict"] = {}
    hists: Dict[str, "dict"] = {}

    def _problem(member: str, family: str, why: str) -> None:
        problems.append({"member": member, "family": family,
                         "problem": why})

    for member, snap in named:
        for name, fam in (snap or {}).items():
            kind = fam.get("type", "untyped")
            if name not in kinds:
                kinds[name] = kind
                helps[name] = fam.get("help", "")
            elif kinds[name] != kind:
                _problem(member, name,
                         f"type skew: {kind} vs {kinds[name]}")
                continue
            for entry in fam.get("series") or ():
                try:
                    labels = dict(entry.get("labels") or {})
                    if kind == "counter":
                        key = tuple(sorted(labels.items()))
                        slot = counters.setdefault(name, {})
                        prior = slot.get(key)
                        if prior is None:
                            slot[key] = {"labels": labels,
                                         "value": float(entry["value"])}
                        else:
                            prior["value"] += float(entry["value"])
                    elif kind == "histogram":
                        key = tuple(sorted(labels.items()))
                        h = metrics.histogram_from_snapshot(entry)
                        slot = hists.setdefault(name, {})
                        prior = slot.get(key)
                        if prior is None:
                            slot[key] = {"labels": labels, "hist": h}
                        else:
                            prior["hist"].merge(h)
                    else:
                        # gauges (and untyped): per-member series
                        key = tuple(sorted(labels.items())) \
                            + (("member", member),)
                        slot = gauges.setdefault(name, {})
                        slot[key] = {
                            "labels": {**labels, "member": member},
                            "value": float(entry.get("value", 0.0))}
                except (metrics.MetricError, ValueError, KeyError,
                        TypeError) as exc:
                    _problem(member, name, str(exc) or repr(exc))

    merged: Dict[str, Any] = {}
    for name in sorted(kinds):
        kind = kinds[name]
        if kind == "counter":
            series = list(counters.get(name, {}).values())
        elif kind == "histogram":
            series = [metrics.histogram_snapshot_entry(s["hist"],
                                                       s["labels"])
                      for s in hists.get(name, {}).values()]
        else:
            series = list(gauges.get(name, {}).values())
        if not series:
            continue
        merged[name] = {"type": kind, "help": helps.get(name, ""),
                        "series": series}
    return merged, problems


def render_fleet_prometheus(
        merged: Dict[str, Any],
        member_families: Sequence[Tuple[str, Dict[str, Any]]]) -> str:
    """One text exposition: the merged fleet series per family,
    followed by per-member drill-down series under ``member=``.
    Drill-down is emitted for counters and histograms only — merged
    gauge series already carry the ``member`` label (gauges never
    sum), so re-emitting them would duplicate identical samples."""
    lines: List[str] = []
    all_names = sorted(set(merged)
                       | {n for _, snap in member_families for n in snap})
    for name in all_names:
        fam = merged.get(name)
        kind = (fam or {}).get("type")
        help_ = (fam or {}).get("help", "")
        if fam is None:
            for _, snap in member_families:
                if name in snap:
                    kind = snap[name].get("type", "untyped")
                    help_ = snap[name].get("help", "")
                    break
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        if fam is not None:
            lines.extend(metrics.render_family_lines(
                name, fam["type"], fam["series"]))
        for member, snap in member_families:
            mfam = snap.get(name)
            if not mfam or mfam.get("type") not in ("counter",
                                                    "histogram"):
                continue
            lines.extend(metrics.render_family_lines(
                name, mfam.get("type"),
                mfam.get("series") or (), extra=("member", member)))
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Scraping
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetScrape:
    """One federated observation of the whole fleet."""
    at: float
    duration_sec: float
    members: List[Dict[str, Any]]
    families: List[Tuple[str, Dict[str, Any]]]  # counted members only
    merged: Dict[str, Any]
    problems: List[Dict[str, Any]]
    alerts: Optional[Dict[str, Any]] = None

    def prometheus(self) -> str:
        return render_fleet_prometheus(self.merged, self.families)


class _MemberClient:
    """Keep-alive HTTP client for one member (one redial on a stale
    pooled connection, like the router's shard clients)."""

    def __init__(self, url: str, timeout: float):
        parts = urlsplit(url)
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or (443 if parts.scheme == "https" else 80)
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    def _connect(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def get(self, path: str) -> Tuple[int, bytes]:
        for attempt in (0, 1):
            conn = self._connect()
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt:
                    raise
        raise OSError("unreachable")  # pragma: no cover


class FleetFederation:
    """Scrapes fleet members in parallel and merges the result.

    ``targets`` is a callable returning ``[(name, url), ...]`` for the
    remote members (re-resolved every observation, so topology changes
    — reload onto a different storage fleet — are picked up without
    restarting the poller). The local process is always member
    ``balancer``."""

    def __init__(self,
                 targets: Callable[[], Sequence[Tuple[str, str]]],
                 slo: Optional[Any] = None,
                 timeout_sec: Optional[float] = None,
                 local_name: str = "balancer"):
        self._targets = targets
        self._slo = slo
        self.timeout_sec = float(
            timeout_sec if timeout_sec is not None
            else os.environ.get("PIO_FED_TIMEOUT_SEC",
                                DEFAULT_TIMEOUT_SEC) or DEFAULT_TIMEOUT_SEC)
        self.local_name = local_name
        self._lock = threading.Lock()
        self._clients: Dict[str, _MemberClient] = {}
        self._last_ok: Dict[str, float] = {}
        self._last: Optional[FleetScrape] = None

    # -- member scrape ------------------------------------------------------
    def _client(self, url: str) -> _MemberClient:
        cli = self._clients.get(url)
        if cli is None or cli.timeout != self.timeout_sec:
            cli = _MemberClient(url, self.timeout_sec)
            self._clients[url] = cli
        return cli

    def _scrape_member(self, name: str, url: str, now: float
                       ) -> Tuple[Dict[str, Any],
                                  Optional[Dict[str, Any]]]:
        row: Dict[str, Any] = {"member": name, "url": url, "ok": False}
        last_ok = self._last_ok.get(url)
        if last_ok is not None:
            row["lastOkAgeSec"] = round(max(0.0, now - last_ok), 3)
        breaker = resilience.breaker_for("scrape:" + url)
        try:
            breaker.before_call()
        except resilience.CircuitOpenError as exc:
            row["reason"] = "member_down"
            row["error"] = str(exc)
            row["breakerState"] = breaker.state
            return row, None
        cli = self._client(url)
        try:
            status, body = cli.get("/metrics")
            if status != 200:
                raise OSError(f"GET /metrics -> HTTP {status}")
            families = metrics.parse_prometheus(body.decode("utf-8"))
            row["expositionBytes"] = len(body)
            health: Dict[str, Any] = {}
            try:
                hstatus, hbody = cli.get("/healthz")
                health = json.loads(hbody.decode("utf-8"))
                row["ready"] = bool(health.get("ready",
                                               hstatus == 200))
            except (OSError, ValueError, http.client.HTTPException):
                # /metrics answered; a flaky healthz alone is detail,
                # not member_down
                row["ready"] = None
            try:
                sstatus, sbody = cli.get("/stats.json")
                if sstatus == 200:
                    stats = json.loads(sbody.decode("utf-8"))
                    if isinstance(stats, dict):
                        summary = {}
                        for k in ("foldin", "device", "fleet", "status"):
                            if k in stats:
                                summary[k] = stats[k]
                        if summary:
                            row["stats"] = summary
            except (OSError, ValueError, http.client.HTTPException):
                pass
            breaker.record_success()
        except (OSError, http.client.HTTPException, ValueError,
                metrics.MetricError) as exc:
            breaker.record_failure(exc)
            cli.close()
            row["reason"] = "member_down"
            row["error"] = f"{type(exc).__name__}: {exc}"
            row["breakerState"] = breaker.state
            return row, None
        self._last_ok[url] = now
        row["ok"] = True
        row["lastOkAgeSec"] = 0.0
        row["breakerState"] = breaker.state
        if health:
            row["server"] = health.get("server")
            row["alive"] = health.get("alive")
            row["checks"] = health.get("checks")
            pid = health.get("pid")
            row["pid"] = pid
            if pid is not None and pid == os.getpid():
                # shares our registry/trace buffer (an in-process member):
                # counted once via the local snapshot
                row["inProcess"] = True
        return row, families

    # -- the observation ----------------------------------------------------
    def observe(self, max_age_sec: float = 0.0) -> FleetScrape:
        """Scrape the fleet (or reuse a scrape newer than
        ``max_age_sec``) and return the merged view."""
        with self._lock:
            if max_age_sec > 0 and self._last is not None \
                    and time.time() - self._last.at <= max_age_sec:
                return self._last
            t0 = time.time()
            targets = list(self._targets() or ())
            results: List[Tuple[Dict[str, Any],
                                Optional[Dict[str, Any]]]] = \
                [None] * len(targets)  # type: ignore[list-item]

            def _run(i: int, name: str, url: str) -> None:
                try:
                    results[i] = self._scrape_member(name, url, t0)
                except Exception as exc:  # defensive: never lose a slot
                    results[i] = ({"member": name, "url": url,
                                   "ok": False,
                                   "reason": "member_down",
                                   "error": repr(exc)}, None)

            threads = [threading.Thread(
                target=_run, args=(i, name, url), daemon=True,
                name=f"pio-fed-scrape-{name}")
                for i, (name, url) in enumerate(targets)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            local_row = {"member": self.local_name, "url": None,
                         "ok": True, "local": True, "pid": os.getpid()}
            local_snap = metrics.registry().snapshot()
            members = [local_row]
            named: List[Tuple[str, Dict[str, Any]]] = \
                [(self.local_name, local_snap)]
            for row, families in results:
                members.append(row)
                if families is not None and not row.get("inProcess"):
                    named.append((row["member"], families))
            merged, problems = merge_member_families(named)
            alerts = None
            if self._slo is not None:
                alerts = self._slo.evaluate(merged)
                # fold the freshly-set pio_slo_* gauges into the
                # merged view (they postdate local_snap)
                slo_snap = metrics.registry().snapshot()
                for fam_name in ("pio_slo_burn_rate",
                                 "pio_slo_budget_remaining"):
                    fam = slo_snap.get(fam_name)
                    if fam is None:
                        continue
                    series = [{"labels": {**(e.get("labels") or {}),
                                          "member": self.local_name},
                               "value": e.get("value", 0.0)}
                              for e in fam.get("series") or ()]
                    if series:
                        merged[fam_name] = {"type": fam.get("type"),
                                            "help": fam.get("help", ""),
                                            "series": series}
                        named[0][1][fam_name] = fam
            scrape = FleetScrape(
                at=t0, duration_sec=round(time.time() - t0, 6),
                members=members, families=named, merged=merged,
                problems=problems, alerts=alerts)
            self._last = scrape
            return scrape

    def last(self) -> Optional[FleetScrape]:
        with self._lock:
            return self._last

    def close(self) -> None:
        with self._lock:
            for cli in self._clients.values():
                cli.close()
            self._clients.clear()
