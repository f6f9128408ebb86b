"""In-memory storage backend (test + dev; cf. reference test-mode clients).

Provides every DAO over plain dicts with the exact filter semantics of the
reference's HBase scan construction (``HBEventsUtil.scala:286-410``): time
range is [start, until), equality filters on entity/event/target fields,
``target_entity_type=None`` (explicitly) matches only events WITHOUT a
target entity.

The port's copy of ``predictionio_tpu/data/storage/memory.py``, tail
reads included.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from predictionio_tpu_torch.data.aggregator import (
    AGGREGATOR_EVENT_NAMES,
    EntityState,
    fold_event,
    fold_events,
    states_to_property_maps,
)
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event, new_event_id, validate_event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    UNSET, AccessKey, App, Channel, EngineInstance, EvaluationInstance, Model,
)


def match_event(
    e: Event,
    start_time=None,
    until_time=None,
    entity_type=None,
    entity_id=None,
    event_names=None,
    target_entity_type=UNSET,
    target_entity_id=UNSET,
) -> bool:
    """Shared filter predicate used by memory/sqlite post-filters."""
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in set(event_names):
        return False
    if target_entity_type is not UNSET and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not UNSET and e.target_entity_id != target_entity_id:
        return False
    return True


class MemLEvents(base.LEvents):
    metrics_backend = "memory"
    # insert is an upsert keyed by event id: a retried insert with the
    # same (pre-assigned) ids replays to the identical state
    idempotent_event_writes = True

    def __init__(self, config: Optional[dict] = None):
        # (app_id, channel_id) -> {event_id: Event}; insertion order kept
        self._tables: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}
        # write-through materialized aggregate: the same scope key ->
        # {(entity_type, entity_id): EntityState}, updated on every
        # special-event insert/delete — the unbounded
        # aggregate_properties reads it instead of replaying the table
        self._props: Dict[Tuple[int, Optional[int]],
                          Dict[Tuple[str, str], EntityState]] = {}
        # arrival-ordered event ids per scope — the tail-read (find_since)
        # order; an id-keyed upsert appends AGAIN so tail consumers see
        # the newest version (re-delivery, never a miss), and deleted ids
        # are skipped at read time (until compaction, below)
        self._seq: Dict[Tuple[int, Optional[int]], List[str]] = {}
        # tail generation per scope: bumped whenever positions in _seq
        # stop meaning what an outstanding cursor recorded (scope remove,
        # tombstone compaction) so the cursor resets to a full replay.
        # NEVER popped — it must survive a remove + re-ingest, where the
        # rebuilt _seq can grow past an old cursor's position
        self._gen: Dict[Tuple[int, Optional[int]], int] = {}
        self._lock = threading.RLock()

    def _key(self, app_id, channel_id):
        return (int(app_id), None if channel_id is None else int(channel_id))

    def init(self, app_id, channel_id=None) -> bool:
        with self._lock:
            self._tables.setdefault(self._key(app_id, channel_id), {})
        return True

    def remove(self, app_id, channel_id=None) -> bool:
        from predictionio_tpu_torch.utils import metrics

        with self._lock:
            if self._props.pop(self._key(app_id, channel_id), None) \
                    is not None:
                metrics.AGGREGATE_SCOPE_DROPS.inc(
                    backend=self.metrics_backend)
            key = self._key(app_id, channel_id)
            if self._seq.pop(key, None) is not None:
                self._gen[key] = self._gen.get(key, 0) + 1
            return self._tables.pop(key, None) is not None

    def close(self) -> None:
        pass

    def _refold_entity_locked(self, key, entity_type: str,
                              entity_id: str) -> None:
        """Re-derive ONE entity's state from its (small) event history —
        the out-of-order / delete repair path. Caller holds the lock."""
        evs = [e for e in self._tables.get(key, {}).values()
               if e.entity_type == entity_type and e.entity_id == entity_id
               and e.event in AGGREGATOR_EVENT_NAMES]
        props = self._props.setdefault(key, {})
        st = fold_events(evs)
        if st is None:
            props.pop((entity_type, entity_id), None)
        else:
            props[(entity_type, entity_id)] = st

    def _fold_in_locked(self, key, event: Event) -> None:
        if event.event not in AGGREGATOR_EVENT_NAMES:
            return
        props = self._props.setdefault(key, {})
        pkey = (event.entity_type, event.entity_id)
        st = props.get(pkey)
        if st is not None and st.last_updated is not None \
                and event.event_time < st.last_updated:
            # out-of-order arrival: the replay would fold this BEFORE
            # already-applied events — re-derive from history instead
            self._refold_entity_locked(key, *pkey)
        else:
            props[pkey] = fold_event(st, event)

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        validate_event(event)
        eid = event.event_id or new_event_id()
        with self._lock:
            key = self._key(app_id, channel_id)
            table = self._tables.setdefault(key, {})
            replaced = table.get(eid)
            table[eid] = event.with_id(eid)
            self._seq.setdefault(key, []).append(eid)
            if replaced is not None:
                # upsert semantics: the replaced event's fold contribution
                # is gone — re-derive the touched entities. When NEITHER
                # side is special the fold state cannot have changed, so
                # the common idempotent-retry of a non-special event
                # stays O(1) instead of rescanning the scope.
                if replaced.event in AGGREGATOR_EVENT_NAMES:
                    self._refold_entity_locked(
                        key, replaced.entity_type, replaced.entity_id)
                if event.event in AGGREGATOR_EVENT_NAMES:
                    self._refold_entity_locked(
                        key, event.entity_type, event.entity_id)
                # each upsert leaves a duplicate _seq entry behind —
                # the same unbounded-growth hazard as delete tombstones
                self._compact_seq_locked(key)
            else:
                self._fold_in_locked(key, event)
        return eid

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        with self._lock:
            return self._tables.get(self._key(app_id, channel_id), {}).get(event_id)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        with self._lock:
            key = self._key(app_id, channel_id)
            table = self._tables.get(key, {})
            gone = table.pop(event_id, None)
            if gone is not None:
                if gone.event in AGGREGATOR_EVENT_NAMES:
                    self._refold_entity_locked(key, gone.entity_type,
                                               gone.entity_id)
                self._compact_seq_locked(key)
            return gone is not None

    def _compact_seq_locked(self, key) -> None:
        """Drop tombstones (deleted ids) and upsert duplicates from
        ``_seq`` once they outnumber the live events — without this, a
        long-lived store under retention trimming (``delete_until``
        walks ``delete``) grows one dead entry per ever-inserted event.
        Compaction renumbers positions, so the generation bumps and
        outstanding tail cursors replay. Caller holds the lock."""
        seq = self._seq.get(key)
        table = self._tables.get(key, {})
        if seq is None or len(seq) < 64 or len(seq) <= 2 * len(table):
            return
        kept_rev: List[str] = []
        seen = set()
        for eid in reversed(seq):
            if eid in table and eid not in seen:
                seen.add(eid)
                kept_rev.append(eid)
        kept_rev.reverse()
        self._seq[key] = kept_rev
        self._gen[key] = self._gen.get(key, 0) + 1

    def materialized_aggregate(self, app_id, entity_type, channel_id=None
                               ) -> Optional[Dict[str, PropertyMap]]:
        with self._lock:
            props = self._props.get(self._key(app_id, channel_id), {})
            states = {eid: st for (etype, eid), st in props.items()
                      if etype == entity_type}
        return states_to_property_maps(states)

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=UNSET, target_entity_id=UNSET,
             limit=None, reversed=False) -> Iterable[Event]:
        with self._lock:
            events = list(self._tables.get(self._key(app_id, channel_id), {}).values())
        out = [e for e in events if match_event(
            e, start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id)]
        out.sort(key=lambda e: e.event_time, reverse=bool(reversed))
        if limit is not None and limit >= 0:
            out = out[:limit]
        return iter(out)

    # -- tail reads (find_since contract, base.py) -------------------------

    def find_since(self, app_id, channel_id=None, cursor=None, limit=None):
        key = self._key(app_id, channel_id)
        pos = int(cursor.get("pos", 0)) if cursor else 0
        cgen = int(cursor.get("gen", 0)) if cursor else 0
        out: List[Event] = []
        with self._lock:
            seq = self._seq.get(key, [])
            table = self._tables.get(key, {})
            gen = self._gen.get(key, 0)
            if cgen != gen or pos > len(seq):
                # positions stopped meaning what the cursor recorded
                # (scope removed + re-ingested, or _seq compacted):
                # replay from the start (contract in base.py). The
                # position check alone cannot catch a re-ingest that
                # grew PAST the old cursor — the generation does.
                pos = 0
            while pos < len(seq):
                if limit is not None and len(out) >= int(limit):
                    break
                e = table.get(seq[pos])
                if e is not None:
                    out.append(e)
                pos += 1
        return out, {"kind": "memory", "pos": pos, "gen": gen}

    def tail_cursor(self, app_id, channel_id=None):
        key = self._key(app_id, channel_id)
        with self._lock:
            seq = self._seq.get(key, [])
            return {"kind": "memory", "pos": len(seq),
                    "gen": self._gen.get(key, 0)}

    def tail_watermark(self, app_id, channel_id=None):
        key = self._key(app_id, channel_id)
        with self._lock:
            seq = self._seq.get(key, [])
            table = self._tables.get(key, {})
            last = next((table[eid] for eid in reversed(seq)
                         if eid in table), None)
            cursor = {"kind": "memory", "pos": len(seq),
                      "gen": self._gen.get(key, 0)}
        return {
            "cursor": cursor,
            "lastEventId": None if last is None else last.event_id,
            "lastEventTime": None if last is None
            else last.event_time.isoformat(),
        }


class _IdTable:
    """Auto-increment record table keyed by int id."""

    def __init__(self):
        self.rows: Dict[int, Any] = {}
        self.next_id = itertools.count(1)
        self.lock = threading.RLock()


class MemApps(base.Apps):
    def __init__(self, config: Optional[dict] = None):
        self._t = _IdTable()

    def insert(self, app: App) -> Optional[int]:
        with self._t.lock:
            if any(a.name == app.name for a in self._t.rows.values()):
                return None
            if app.id:
                if app.id in self._t.rows:
                    return None  # explicit id conflict (matches sqlite)
                aid = app.id
            else:
                aid = next(self._t.next_id)
                while aid in self._t.rows:
                    aid = next(self._t.next_id)
            self._t.rows[aid] = App(aid, app.name, app.description)
            return aid

    def get(self, app_id):
        return self._t.rows.get(int(app_id))

    def get_by_name(self, name):
        return next((a for a in self._t.rows.values() if a.name == name), None)

    def get_all(self):
        return sorted(self._t.rows.values(), key=lambda a: a.id)

    def update(self, app: App) -> bool:
        with self._t.lock:
            if app.id not in self._t.rows:
                return False
            self._t.rows[app.id] = app
            return True

    def delete(self, app_id) -> bool:
        with self._t.lock:
            return self._t.rows.pop(int(app_id), None) is not None


class MemAccessKeys(base.AccessKeys):
    def __init__(self, config: Optional[dict] = None):
        self._rows: Dict[str, AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or base.generate_access_key()
        with self._lock:
            self._rows[key] = AccessKey(key, k.appid, tuple(k.events))
        return key

    def get(self, key):
        return self._rows.get(key)

    def get_all(self):
        return list(self._rows.values())

    def get_by_appid(self, appid):
        return [k for k in self._rows.values() if k.appid == appid]

    def update(self, k: AccessKey) -> bool:
        with self._lock:
            if k.key not in self._rows:
                return False
            self._rows[k.key] = k
            return True

    def delete(self, key) -> bool:
        with self._lock:
            return self._rows.pop(key, None) is not None


class MemChannels(base.Channels):
    def __init__(self, config: Optional[dict] = None):
        self._t = _IdTable()

    def insert(self, c: Channel) -> Optional[int]:
        if not Channel.is_valid_name(c.name):
            return None
        with self._t.lock:
            if c.id:
                if c.id in self._t.rows:
                    return None  # explicit id conflict (matches sqlite)
                cid = c.id
            else:
                cid = next(self._t.next_id)
                while cid in self._t.rows:
                    cid = next(self._t.next_id)
            self._t.rows[cid] = Channel(cid, c.name, c.appid)
            return cid

    def get(self, channel_id):
        return self._t.rows.get(int(channel_id))

    def get_by_appid(self, appid):
        return [c for c in self._t.rows.values() if c.appid == appid]

    def delete(self, channel_id) -> bool:
        with self._t.lock:
            return self._t.rows.pop(int(channel_id), None) is not None


class MemEngineInstances(base.EngineInstances):
    def __init__(self, config: Optional[dict] = None):
        self._rows: Dict[str, EngineInstance] = {}
        self._counter = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, i: EngineInstance) -> str:
        with self._lock:
            iid = i.id or f"ei_{next(self._counter):08d}"
            import dataclasses as _dc
            self._rows[iid] = _dc.replace(i, id=iid)
            return iid

    def get(self, iid):
        return self._rows.get(iid)

    def get_all(self):
        return list(self._rows.values())

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = [
            r for r in self._rows.values()
            if r.status == "COMPLETED" and r.engine_id == engine_id
            and r.engine_version == engine_version
            and r.engine_variant == engine_variant
        ]
        rows.sort(key=lambda r: r.start_time, reverse=True)
        return rows

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    def update(self, i: EngineInstance) -> bool:
        with self._lock:
            if i.id not in self._rows:
                return False
            self._rows[i.id] = i
            return True

    def delete(self, iid) -> bool:
        with self._lock:
            return self._rows.pop(iid, None) is not None


class MemEvaluationInstances(base.EvaluationInstances):
    def __init__(self, config: Optional[dict] = None):
        self._rows: Dict[str, EvaluationInstance] = {}
        self._counter = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, i: EvaluationInstance) -> str:
        with self._lock:
            iid = i.id or f"evi_{next(self._counter):08d}"
            import dataclasses as _dc
            self._rows[iid] = _dc.replace(i, id=iid)
            return iid

    def get(self, iid):
        return self._rows.get(iid)

    def get_all(self):
        return list(self._rows.values())

    def get_completed(self):
        rows = [r for r in self._rows.values() if r.status == "EVALCOMPLETED"]
        rows.sort(key=lambda r: r.start_time, reverse=True)
        return rows

    def update(self, i: EvaluationInstance) -> bool:
        with self._lock:
            if i.id not in self._rows:
                return False
            self._rows[i.id] = i
            return True

    def delete(self, iid) -> bool:
        with self._lock:
            return self._rows.pop(iid, None) is not None


class MemModels(base.Models):
    def __init__(self, config: Optional[dict] = None):
        self._rows: Dict[str, Model] = {}
        self._lock = threading.RLock()

    def insert(self, m: Model) -> None:
        with self._lock:
            self._rows[m.id] = m

    def get(self, mid):
        return self._rows.get(mid)

    def delete(self, mid) -> bool:
        with self._lock:
            return self._rows.pop(mid, None) is not None
