"""``pio top``: a refreshing terminal view of a live query server.

The port's copy of ``predictionio_tpu/tools/top_command.py``. It polls
``GET /stats.json`` and ``GET /dispatches.json`` and renders what an
operator reaches for first: QPS (the request counter's delta between
polls), served p50/p99, batch fill, each dispatch lane's device and
host time, the device bytes of the factor store and the AOT ladder (the
port has no ladder yet: its fields read zero), and the degraded and
fold-in state. ``--once`` prints one plain frame instead of looping.
``--fleet`` (a balancer's federated view) raises: the fleet is not
ported yet (ROADMAP A2.6); :func:`render` draws the fleet and SLO blocks
all the same when a ``/stats.json`` carries them.

The view reads two untraced scrape routes per refresh and nothing else.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_URL = "http://127.0.0.1:8000"


def _fetch(url: str, timeout: float = 5.0) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "—"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TiB"


def _fmt_us(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.0f}µs"


def _ms(sec: Optional[float]) -> str:
    return "—" if sec is None else f"{sec * 1e3:.2f}ms"


def _metric_series(stats: Dict[str, Any], name: str) -> List[Dict]:
    return ((stats.get("metrics") or {}).get(name) or {}).get("series", [])


def _query_count(stats: Dict[str, Any]) -> int:
    return int(stats.get("requestCount") or 0)


def render(stats: Dict[str, Any], dispatches: Dict[str, Any],
           prev: Optional[Tuple[float, int]] = None,
           now: Optional[float] = None) -> str:
    """One frame of the top view as plain text (the --once output)."""
    now = time.monotonic() if now is None else now
    lines: List[str] = []
    inst = stats.get("engineInstanceId") or "—"
    lines.append(f"pio top · engine {inst} · started "
                 f"{stats.get('startTime') or '—'}")

    # -- throughput / latency ---------------------------------------------
    count = _query_count(stats)
    qps = None
    if prev is not None:
        prev_t, prev_count = prev
        dt = now - prev_t
        if dt > 0:
            qps = max(0.0, (count - prev_count) / dt)
    lat = stats.get("servingLatency") or {}
    lines.append(
        f"queries  {count:>10d} total · "
        f"qps {'—' if qps is None else f'{qps:.1f}'} · "
        f"p50 {_ms(lat.get('p50Sec'))} · p99 {_ms(lat.get('p99Sec'))} · "
        f"max {_ms(lat.get('maxSec'))}")

    # -- batchers ----------------------------------------------------------
    for b in stats.get("batchers") or []:
        qd = b.get("queueDepthPercentiles") or {}
        lines.append(
            f"batcher  {b.get('batcher', '?'):<22} "
            f"dispatches {b.get('dispatches', 0):>8d} · "
            f"fill {b.get('batchFillRatio', 0.0):.3f} · "
            f"depth {b.get('queueDepth', 0)} "
            f"(p99 {qd.get('p99', '—')}) · "
            f"shed {b.get('rejectedQueries', 0)}")

    # -- device plane ------------------------------------------------------
    device = stats.get("device") or {}
    tele = device.get("telemetry") or {}
    lines.append(
        f"device   HBM store {_fmt_bytes(device.get('storeBytes'))} · "
        f"AOT ladder {_fmt_bytes(device.get('aotLadderBytes'))} · "
        f"recorder {'on' if tele.get('enabled') else 'OFF'} "
        f"({tele.get('recorded', 0)} recorded)")
    for entry in device.get("stores") or []:
        store = entry.get("store") or {}
        ladder = entry.get("aotLadder") or {}
        cov = ladder.get("coverage") or {}
        req = ladder.get("requests") or {}
        lines.append(
            f"store    {store.get('precision', '?')}/"
            f"{store.get('kernel', '?')} · "
            f"{store.get('nUsers', 0)}u × {store.get('nItems', 0)}i · "
            f"{_fmt_bytes(store.get('totalBytes'))} · ladder "
            f"{cov.get('compiled', 0)}/{cov.get('planned', 0)} compiled "
            f"(+{cov.get('warmed', 0)} warmed) · "
            f"hit {req.get('hit', 0)} / missJit {req.get('missJit', 0)} · "
            f"evicted {((ladder.get('cache') or {}).get('evictions', 0))}")
        # mesh-sharded store: one line per shard so a hot shard (HBM
        # or interaction mass) is visible at a glance
        for sh in store.get("shards") or []:
            mass = sh.get("interactions")
            lines.append(
                f"shard    #{sh.get('shard', '?'):<3} "
                f"{_fmt_bytes(sh.get('factorBytes'))} · "
                f"{sh.get('items', 0)} items"
                + ("" if mass is None else f" · {mass} interactions"))
    summary = (dispatches or {}).get("summary") or {}
    for lane, s in sorted(summary.items()):
        lines.append(
            f"lane     {lane:<8} {s.get('dispatches', 0):>8d} dispatches "
            f"· device p50 {_fmt_us(s.get('deviceUsP50'))} "
            f"p99 {_fmt_us(s.get('deviceUsP99'))} · "
            f"host p50 {_fmt_us(s.get('hostUsP50'))} · "
            f"wait p50 {_fmt_us(s.get('queueWaitUsP50'))} · "
            f"fill {s.get('meanFill') if s.get('meanFill') is not None else '—'} "
            f"· aot {s.get('aot') or {}}")

    # -- health: breakers / degraded / fold-in -----------------------------
    open_breakers = [
        s["labels"].get("endpoint", "?")
        for s in _metric_series(stats, "pio_circuit_state")
        if s.get("value")]
    degraded = sum(s.get("value", 0) for s in
                   _metric_series(stats, "pio_degraded_queries_total"))
    lines.append(
        f"health   breakers open: "
        f"{', '.join(open_breakers) if open_breakers else 'none'} · "
        f"degraded queries {int(degraded)}")
    foldin = stats.get("foldin")
    if foldin:
        lines.append(
            f"foldin   folds {foldin.get('folds', 0)} "
            f"(err {foldin.get('foldErrors', 0)}) · "
            f"users {foldin.get('usersPatched', 0)} "
            f"(+{foldin.get('newUsers', 0)} new) · pending "
            f"{foldin.get('pendingEvents', 0)} · "
            f"{'STALE' if foldin.get('stale') else 'fresh'} · "
            f"solve {_fmt_us(foldin.get('lastSolveDeviceUs'))}")

    # -- fleet federation (balancer /stats.json, `pio top --fleet`) --------
    fleet = stats.get("fleet") or {}
    members = fleet.get("members")
    if members:
        scrape = fleet.get("scrape") or {}
        lines.append(
            f"fleet    {fleet.get('readyReplicas', 0)}/"
            f"{len(fleet.get('replicas') or ())} replicas ready · "
            f"{len(members)} members · scrape "
            f"{float(scrape.get('durationSec') or 0) * 1e3:.1f}ms · "
            f"problems {len(scrape.get('problems') or ())}")
        for m in members:
            state = "ok" if m.get("ok") else (m.get("reason") or "down")
            extra = " in-process" if m.get("inProcess") else ""
            lines.append(
                f"member   {str(m.get('member', '?')):<10} "
                f"{str(m.get('url') or 'local'):<28} [{state}{extra}]")
    alerts = stats.get("alerts")
    if alerts is not None:
        firing = alerts.get("firing") or []
        lines.append(
            f"slo      firing: "
            f"{', '.join(firing) if firing else 'none'} · "
            f"burn threshold {alerts.get('burnThreshold')}")
        for name, obj in (alerts.get("objectives") or {}).items():
            burn = obj.get("burn") or {}
            line = (f"slo      {name:<20} "
                    f"burn fast {float(burn.get('fast', 0)):.2f} / "
                    f"slow {float(burn.get('slow', 0)):.2f} · "
                    f"budget left "
                    f"{float(obj.get('budgetRemaining', 1.0)):.1%}")
            if obj.get("firing"):
                line += f" · FIRING since {obj.get('since', '?')}"
            lines.append(line)
    return "\n".join(lines)


def snapshot(url: str, prev: Optional[Tuple[float, int]] = None
             ) -> Tuple[str, Tuple[float, int]]:
    """Fetch + render one frame; returns (text, state-for-next-frame)."""
    stats = _fetch(url.rstrip("/") + "/stats.json")
    try:
        dispatches = _fetch(url.rstrip("/") + "/dispatches.json?limit=0")
    except (urllib.error.URLError, OSError, ValueError):
        dispatches = {}
    text = render(stats, dispatches, prev)
    return text, (time.monotonic(), _query_count(stats))


def cmd_top(args) -> int:
    url = args.url or DEFAULT_URL
    if getattr(args, "fleet", False):
        raise NotImplementedError(
            "pio top --fleet: the query fleet and its federated view are "
            "not ported yet (ROADMAP A2.6)")
    try:
        if args.once:
            text, _ = snapshot(url)
            print(text)
            return 0
        prev: Optional[Tuple[float, int]] = None
        while True:
            try:
                text, prev = snapshot(url, prev)
            except (urllib.error.URLError, OSError) as e:
                text = f"pio top · {url} unreachable: {e}"
            # ANSI clear + home, then the frame: a refreshing view
            # without curses
            print(f"\x1b[2J\x1b[H{text}\n\n(refresh "
                  f"{args.interval:.1f}s · ctrl-c to exit)", flush=True)
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0
    except (urllib.error.URLError, OSError) as e:
        print(f"[ERROR] {url} unreachable: {e}")
        return 1
