"""Per-app ingestion counters with hourly rotation.

Parity targets: ``data/.../api/Stats.scala:48-79`` (counts keyed by
(appId, statusCode) and (appId, EntityTypesEvent)) and
``StatsActor.scala`` (long-lived + current-hour + previous-hour windows,
rotated on the hour). The actor mailbox is replaced by a lock — the
counters are tiny and the server is thread-per-request.

The port's copy of ``predictionio_tpu/data/api/stats.py``.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import Counter
from typing import Any, Dict, Optional

from predictionio_tpu_torch.data.event import Event

UTC = _dt.timezone.utc


def _ete(event: Event) -> tuple:
    """EntityTypesEvent key (Stats.scala:28-37)."""
    return (event.entity_type, event.target_entity_type, event.event)


class Stats:
    """One counting window (Stats.scala:48-79)."""

    def __init__(self, start_time: _dt.datetime):
        self.start_time = start_time
        self.end_time: Optional[_dt.datetime] = None
        self.status_code_count: Counter = Counter()   # (appId, status) -> n
        self.ete_count: Counter = Counter()           # (appId, ete) -> n

    def cutoff(self, end_time: _dt.datetime) -> None:
        self.end_time = end_time

    def update(self, app_id: int, status_code: int, event: Event) -> None:
        self.status_code_count[(app_id, status_code)] += 1
        self.ete_count[(app_id, _ete(event))] += 1

    def snapshot(self, app_id: int) -> Dict[str, Any]:
        """StatsSnapshot as a JSON-ready dict (Stats.scala:40-45)."""
        return {
            "startTime": self.start_time.isoformat(),
            "endTime": self.end_time.isoformat() if self.end_time else None,
            "basic": [
                {
                    "entityType": k[1][0],
                    "targetEntityType": k[1][1],
                    "event": k[1][2],
                    "count": v,
                }
                for k, v in sorted(self.ete_count.items(), key=lambda x: -x[1])
                if k[0] == app_id
            ],
            "statusCode": [
                {"status": k[1], "count": v}
                for k, v in sorted(self.status_code_count.items())
                if k[0] == app_id
            ],
        }


def _hour_floor(t: _dt.datetime) -> _dt.datetime:
    return t.replace(minute=0, second=0, microsecond=0)


class StatsKeeper:
    """Long-lived + hourly + previous-hour windows (StatsActor.scala:34-75)."""

    def __init__(self, now: Optional[_dt.datetime] = None):
        now = now or _dt.datetime.now(tz=UTC)
        self._lock = threading.Lock()
        self.long_live = Stats(now)
        self.hourly = Stats(_hour_floor(now))
        self.prev_hourly = Stats(_hour_floor(now) - _dt.timedelta(hours=1))
        self.prev_hourly.cutoff(self.hourly.start_time)

    def bookkeeping(self, app_id: int, status_code: int, event: Event,
                    now: Optional[_dt.datetime] = None) -> None:
        now = now or _dt.datetime.now(tz=UTC)
        current = _hour_floor(now)
        with self._lock:
            if current != self.hourly.start_time:
                self.prev_hourly = self.hourly
                self.prev_hourly.cutoff(current)
                self.hourly = Stats(current)
            self.hourly.update(app_id, status_code, event)
            self.long_live.update(app_id, status_code, event)

    def get(self, app_id: int) -> Dict[str, Any]:
        """Wire shape of GET /stats.json (EventServer.scala:441-467)."""
        with self._lock:
            return {
                "startTime": self.long_live.start_time.isoformat(),
                "hourly": self.hourly.snapshot(app_id),
                "prevHourly": self.prev_hourly.snapshot(app_id),
                "longLive": self.long_live.snapshot(app_id),
            }
