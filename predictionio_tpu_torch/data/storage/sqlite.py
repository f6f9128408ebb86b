"""SQLite storage backend — the zero-service default.

Capability parity with the reference's JDBC backend
(``data/.../storage/jdbc/`` — the only reference backend implementing every
DAO, SURVEY §2.2): events + all metadata + model blobs in one file DB.

Schema notes: one ``events`` table partitioned by (app_id, channel_id)
columns with a covering index on (app_id, channel_id, event_time) — the
sqlite analog of the reference's HBase rowkey layout
(``HBEventsUtil.scala:81-129``: hashed entity prefix ++ event time ++ uuid).

``entity_props`` materializes the ``$set/$unset/$delete`` fold per
(app, channel, entity_type, entity_id) so the unbounded
``aggregate_properties`` — every template's training read — is one
indexed SELECT over current entities instead of an O(event history)
replay. A scope (app, channel, entity_type) becomes materialized lazily
on its first unbounded read (one backfill replay, recorded in
``entity_props_scope``); from then on every insert folds write-through
in the same transaction. Out-of-order arrivals, event-id upserts and
deletes re-derive only the touched entity; ``delete_until``/``remove``
drop the scope rows so the next read backfills fresh.

The port's copy of ``predictionio_tpu/data/storage/sqlite.py``, tail
reads and the raw-row export read included. A store written by either
package reads in the other: the schema is the same.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import sqlite3
import threading
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence

import dataclasses

from predictionio_tpu_torch.data.aggregator import (
    AGGREGATOR_EVENT_NAMES,
    EntityState,
    fold_event,
    fold_events,
)
from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import Event, new_event_id, validate_event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    UNSET, AccessKey, App, Channel, EngineInstance, EvaluationInstance, Model,
)
from predictionio_tpu_torch.utils import metrics

_SCHEMA = """
CREATE TABLE IF NOT EXISTS events (
  event_id TEXT NOT NULL,
  app_id INTEGER NOT NULL,
  channel_id INTEGER NOT NULL DEFAULT -1,
  event TEXT NOT NULL,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  target_entity_type TEXT,
  target_entity_id TEXT,
  properties TEXT NOT NULL,
  event_time REAL NOT NULL,
  tags TEXT NOT NULL,
  pr_id TEXT,
  creation_time REAL NOT NULL,
  PRIMARY KEY (app_id, channel_id, event_id)
);
CREATE INDEX IF NOT EXISTS idx_events_scan
  ON events (app_id, channel_id, event_time);
CREATE INDEX IF NOT EXISTS idx_events_entity
  ON events (app_id, channel_id, entity_type, entity_id, event_time);
CREATE TABLE IF NOT EXISTS entity_props (
  app_id INTEGER NOT NULL,
  channel_id INTEGER NOT NULL DEFAULT -1,
  entity_type TEXT NOT NULL,
  entity_id TEXT NOT NULL,
  props TEXT,
  first_updated REAL,
  last_updated REAL,
  PRIMARY KEY (app_id, channel_id, entity_type, entity_id)
);
CREATE TABLE IF NOT EXISTS entity_props_scope (
  app_id INTEGER NOT NULL,
  channel_id INTEGER NOT NULL DEFAULT -1,
  entity_type TEXT NOT NULL,
  PRIMARY KEY (app_id, channel_id, entity_type)
);
CREATE TABLE IF NOT EXISTS apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL UNIQUE,
  description TEXT
);
CREATE TABLE IF NOT EXISTS access_keys (
  key TEXT PRIMARY KEY,
  appid INTEGER NOT NULL,
  events TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS channels (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL,
  appid INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS engine_instances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  start_time REAL NOT NULL,
  end_time REAL NOT NULL,
  engine_id TEXT NOT NULL,
  engine_version TEXT NOT NULL,
  engine_variant TEXT NOT NULL,
  engine_factory TEXT NOT NULL,
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  spark_conf TEXT NOT NULL DEFAULT '{}',
  data_source_params TEXT NOT NULL DEFAULT '{}',
  preparator_params TEXT NOT NULL DEFAULT '{}',
  algorithms_params TEXT NOT NULL DEFAULT '[]',
  serving_params TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS evaluation_instances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  start_time REAL NOT NULL,
  end_time REAL NOT NULL,
  evaluation_class TEXT NOT NULL DEFAULT '',
  engine_params_generator_class TEXT NOT NULL DEFAULT '',
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  evaluator_results TEXT NOT NULL DEFAULT '',
  evaluator_results_html TEXT NOT NULL DEFAULT '',
  evaluator_results_json TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS models (
  id TEXT PRIMARY KEY,
  models BLOB NOT NULL
);
"""


class SqliteClient:
    """Shared connection manager; one client per DB path per process.

    File-backed paths get thread-local connections (WAL mode; sqlite file
    locking isolates their transactions). ``:memory:`` uses ONE connection
    shared by all threads (check_same_thread=False; sqlite's serialized mode
    makes that safe) — per-thread connections would each see a separate empty
    database. Because a shared connection also shares one transaction, every
    write goes through :meth:`tx`, which serializes execute+commit under a
    client lock. DAO-level ``close()`` is a no-op — ``shutdown()`` (or
    ``shutdown_all()``) tears down every connection and evicts the client.
    """

    _clients: Dict[str, "SqliteClient"] = {}
    _clients_lock = threading.Lock()

    def __init__(self, path: str):
        self.path = path
        self._in_memory = path == ":memory:"
        self._local = threading.local()
        # Per-thread connections keyed by thread ident with a weakref to the
        # owning Thread: a dying thread must not pin its connection open, so
        # conn() prunes-and-closes entries whose thread is gone.
        self._thread_conns: Dict[int, tuple] = {}
        self._conns_lock = threading.Lock()
        self._tx_lock = threading.RLock()
        self._closed = False
        self._refs = 0
        self._shared_conn: Optional[sqlite3.Connection] = None
        if self._in_memory:
            self._shared_conn = sqlite3.connect(
                ":memory:", timeout=30.0, check_same_thread=False)
        conn = self.conn()
        conn.executescript(_SCHEMA)
        conn.commit()

    @classmethod
    def shared(cls, path: str) -> "SqliteClient":
        """Obtain the client for ``path``, taking one reference. Each caller
        (one per DAO) must balance with ``release()``; the client tears down
        only when the last reference is gone."""
        with cls._clients_lock:
            client = cls._clients.get(path)
            if client is None or client._closed:
                client = cls(path)
                cls._clients[path] = client
            client._refs += 1
            return client

    @classmethod
    def shutdown_all(cls) -> None:
        """Force-teardown every client regardless of refcounts (tests)."""
        with cls._clients_lock:
            clients = list(cls._clients.values())
            cls._clients.clear()
        for c in clients:
            c._teardown()

    def release(self) -> None:
        """Drop one DAO's reference; teardown when the last one is released.
        Extra releases past zero are ignored (double-shutdown safety)."""
        with SqliteClient._clients_lock:
            if self._refs <= 0:
                return
            self._refs -= 1
            if self._refs > 0:
                return
            if SqliteClient._clients.get(self.path) is self:
                del SqliteClient._clients[self.path]
        self._teardown()

    def conn(self) -> sqlite3.Connection:
        if self._closed:
            raise base.StorageError(f"SqliteClient({self.path}) is shut down")
        if self._shared_conn is not None:
            return self._shared_conn
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self.path, timeout=30.0,
                                check_same_thread=False)
            c.execute("PRAGMA journal_mode=WAL")
            c.execute("PRAGMA synchronous=NORMAL")
            thread = threading.current_thread()
            with self._conns_lock:
                # Re-check under the lock: a concurrent _teardown() must not
                # leave a fresh connection registered on a dead client.
                if self._closed:
                    c.close()
                    raise base.StorageError(
                        f"SqliteClient({self.path}) is shut down")
                self._prune_dead_locked()
                self._thread_conns[thread.ident] = (weakref.ref(thread), c)
            self._local.conn = c
        return c

    def _prune_dead_locked(self) -> None:
        def gone(tref):
            t = tref()
            return t is None or not t.is_alive()

        dead = [ident for ident, (tref, _) in self._thread_conns.items()
                if gone(tref)]
        for ident in dead:
            _, conn = self._thread_conns.pop(ident)
            try:
                conn.close()
            except sqlite3.Error:  # pragma: no cover - best-effort cleanup
                pass

    @contextlib.contextmanager
    def tx(self):
        """One atomic write transaction: execute under the client lock,
        commit on success, roll back on error."""
        with self._tx_lock:
            conn = self.conn()
            try:
                yield conn
                conn.commit()
            except BaseException:
                conn.rollback()
                raise

    def query(self, sql: str, args: Sequence[Any] = ()) -> List[tuple]:
        """Read query returning all rows. On the shared :memory: connection
        this holds the tx lock so readers never observe another thread's
        uncommitted writes (file-backed threads have their own connections
        and WAL snapshot isolation instead)."""
        if self._shared_conn is not None:
            with self._tx_lock:
                return self._shared_conn.execute(sql, tuple(args)).fetchall()
        return self.conn().execute(sql, tuple(args)).fetchall()

    def query_iter(self, sql: str, args: Sequence[Any] = ()):
        """Streaming read with snapshot semantics for large scans.

        File-backed: a FRESH read connection per scan, so the WAL snapshot
        isolates it from writes the caller makes through its own connection
        while iterating (same-connection write-while-step visibility is
        undefined in sqlite). Shared ``:memory:``: no second connection can
        see the data, so materialize under the tx lock instead.
        """
        if self._shared_conn is not None:
            with self._tx_lock:
                rows = self._shared_conn.execute(sql, tuple(args)).fetchall()
            yield from rows
            return
        if self._closed:
            raise base.StorageError(f"SqliteClient({self.path}) is shut down")
        conn = sqlite3.connect(self.path, timeout=30.0)
        try:
            yield from conn.execute(sql, tuple(args))
        finally:
            conn.close()

    def query_one(self, sql: str, args: Sequence[Any] = ()) -> Optional[tuple]:
        rows = self.query(sql, args)
        return rows[0] if rows else None

    def shutdown(self) -> None:
        """Close every connection and evict this client from the cache."""
        with SqliteClient._clients_lock:
            if SqliteClient._clients.get(self.path) is self:
                del SqliteClient._clients[self.path]
        self._teardown()

    def _teardown(self) -> None:
        with self._conns_lock:
            self._closed = True
            conns = [c for _, c in self._thread_conns.values()]
            self._thread_conns.clear()
        if self._shared_conn is not None:
            conns.append(self._shared_conn)
            self._shared_conn = None
        for c in conns:
            try:
                c.close()
            except sqlite3.Error:  # pragma: no cover - best-effort cleanup
                pass

    def close(self) -> None:
        """DAO-level close: a no-op (other DAOs share this client).

        Use :meth:`shutdown` for an explicit client-level teardown.
        """


def _ts(t: _dt.datetime) -> float:
    return t.timestamp()


def _from_ts(x: float) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(x, tz=_dt.timezone.utc)


def _row_to_event(row) -> Event:
    (event_id, event, entity_type, entity_id, tet, tei, props, etime, tags,
     pr_id, ctime) = row
    # most rows carry no properties and no tags, and most were created at
    # their event time: skip the parser and the second conversion there
    when = _from_ts(etime)
    return Event(
        event=event, entity_type=entity_type, entity_id=entity_id,
        target_entity_type=tet, target_entity_id=tei,
        properties=DataMap({} if props == "{}" else json.loads(props)),
        event_time=when, tags=() if tags == "[]" else tuple(json.loads(tags)),
        pr_id=pr_id, creation_time=when if ctime == etime
        else _from_ts(ctime), event_id=event_id,
    )


_EVENT_COLS = ("event_id, event, entity_type, entity_id, target_entity_type, "
               "target_entity_id, properties, event_time, tags, pr_id, "
               "creation_time")


class SqliteLEvents(base.LEvents):
    metrics_backend = "sqlite"
    # INSERT OR REPLACE keyed by (app, channel, event_id): retried
    # inserts with pre-assigned ids replay to the identical state
    idempotent_event_writes = True
    # entity_id-filtered finds are lookups in idx_events_entity, not
    # table scans: readers (the fold-in gather) may issue many small
    # per-entity reads instead of one shared scan
    indexed_entity_reads = True

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self._client = SqliteClient.shared(config.get("path", ":memory:"))

    def _chan(self, channel_id) -> int:
        return -1 if channel_id is None else int(channel_id)

    def init(self, app_id, channel_id=None) -> bool:
        return True  # single-table layout; nothing per-app to create

    def remove(self, app_id, channel_id=None) -> bool:
        with self._client.tx() as c:
            c.execute("DELETE FROM events WHERE app_id=? AND channel_id=?",
                      (int(app_id), self._chan(channel_id)))
            self._drop_materialized(c, int(app_id), self._chan(channel_id))
        return True

    # -- materialized entity-property state -------------------------------
    # All helpers run on the transaction connection ``c`` so fold
    # maintenance commits (or rolls back) atomically with the event write.

    @staticmethod
    def _materialized_scopes(c, aid: int, chan: int) -> set:
        return {r[0] for r in c.execute(
            "SELECT entity_type FROM entity_props_scope"
            " WHERE app_id=? AND channel_id=?", (aid, chan))}

    @staticmethod
    def _drop_materialized(c, aid: int, chan: int) -> None:
        cur = c.execute(
            "DELETE FROM entity_props_scope WHERE app_id=? AND channel_id=?",
            (aid, chan))
        c.execute("DELETE FROM entity_props WHERE app_id=? AND channel_id=?",
                  (aid, chan))
        if cur.rowcount:
            metrics.AGGREGATE_SCOPE_DROPS.inc(amount=cur.rowcount,
                                              backend="sqlite")

    @staticmethod
    def _load_state(c, aid: int, chan: int, etype: str,
                    eid: str) -> Optional[EntityState]:
        row = c.execute(
            "SELECT props, first_updated, last_updated FROM entity_props"
            " WHERE app_id=? AND channel_id=? AND entity_type=?"
            " AND entity_id=?", (aid, chan, etype, eid)).fetchone()
        if row is None:
            return None
        return EntityState.from_record(
            [None if row[0] is None else json.loads(row[0]), row[1], row[2]])

    @staticmethod
    def _write_state(c, aid: int, chan: int, etype: str, eid: str,
                     st: Optional[EntityState]) -> None:
        if st is None:
            c.execute(
                "DELETE FROM entity_props WHERE app_id=? AND channel_id=?"
                " AND entity_type=? AND entity_id=?", (aid, chan, etype, eid))
            return
        rec = st.to_record()
        c.execute(
            "INSERT OR REPLACE INTO entity_props (app_id, channel_id,"
            " entity_type, entity_id, props, first_updated, last_updated)"
            " VALUES (?,?,?,?,?,?,?)",
            (aid, chan, etype, eid,
             None if rec[0] is None else json.dumps(rec[0], sort_keys=True),
             rec[1], rec[2]))

    def _entity_events(self, c, aid: int, chan: int, etype: str,
                       eid: str) -> List[Event]:
        """One entity's special events in replay order (event_time, with
        rowid breaking ties the same way the index scan does)."""
        names = ",".join("?" * len(AGGREGATOR_EVENT_NAMES))
        rows = c.execute(
            f"SELECT event, properties, event_time FROM events"
            f" WHERE app_id=? AND channel_id=? AND entity_type=?"
            f" AND entity_id=? AND event IN ({names})"
            f" ORDER BY event_time, rowid",
            (aid, chan, etype, eid) + AGGREGATOR_EVENT_NAMES).fetchall()
        return [Event(event=name, entity_type=etype, entity_id=eid,
                      properties=DataMap(json.loads(props)),
                      event_time=_from_ts(etime))
                for name, props, etime in rows]

    def _refold_entity(self, c, aid: int, chan: int, etype: str,
                       eid: str) -> None:
        """Re-derive ONE entity's state from its (indexed, small) event
        history — the out-of-order / upsert / delete repair path."""
        st = None
        for e in self._entity_events(c, aid, chan, etype, eid):
            st = fold_event(st, e)
        self._write_state(c, aid, chan, etype, eid, st)

    def _fold_through(self, c, aid: int, chan: int, events: List[Event],
                      refold: Optional[set] = None) -> None:
        """Write-through fold of freshly inserted events (already in the
        ``events`` table on this transaction). Only scopes a reader has
        materialized pay anything; entities in ``refold`` (replaced
        event ids, out-of-order arrivals) re-derive from history, the
        rest fold incrementally."""
        special = [e for e in events if e.event in AGGREGATOR_EVENT_NAMES]
        if not special and not refold:
            return
        scopes = self._materialized_scopes(c, aid, chan)
        if not scopes:
            return
        refold = {k for k in (refold or set()) if k[0] in scopes}
        by_entity: Dict[tuple, List[Event]] = {}
        for e in special:
            if e.entity_type in scopes:
                by_entity.setdefault((e.entity_type, e.entity_id),
                                     []).append(e)
        for key, evs in by_entity.items():
            if key in refold:
                continue
            st = self._load_state(c, aid, chan, *key)
            if st is not None and st.last_updated is not None and \
                    min(e.event_time for e in evs) < st.last_updated:
                # out-of-order arrival: the replay would sort this before
                # already-folded events — re-derive from history
                refold.add(key)
                continue
            self._write_state(c, aid, chan, *key, fold_events(evs, st))
        for key in refold:
            self._refold_entity(c, aid, chan, *key)

    def _collision_refolds(self, c, aid: int, chan: int,
                           events: List[Event]) -> set:
        """Entities whose fold is invalidated by event-id upserts: the
        replaced row's contribution disappears, so both the old and the
        new row's entity must re-derive. Only pre-set event ids can
        collide (generated ids are fresh UUIDs)."""
        preset = [e for e in events if e.event_id]
        refold: set = set()
        # duplicates WITHIN the batch: only the last row survives the
        # INSERT OR REPLACE, so every duplicated event's entity must
        # re-derive from the table instead of being folded incrementally
        seen: Dict[str, Event] = {}
        for e in preset:
            prev = seen.get(e.event_id)
            if prev is not None:
                for dup in (prev, e):
                    if dup.event in AGGREGATOR_EVENT_NAMES:
                        refold.add((dup.entity_type, dup.entity_id))
            seen[e.event_id] = e
        for i in range(0, len(preset), 500):
            chunk = preset[i:i + 500]
            marks = ",".join("?" * len(chunk))
            hits = {r[0]: (r[1], r[2], r[3]) for r in c.execute(
                f"SELECT event_id, event, entity_type, entity_id FROM events"
                f" WHERE app_id=? AND channel_id=? AND event_id IN ({marks})",
                (aid, chan) + tuple(e.event_id for e in chunk))}
            for e in chunk:
                hit = hits.get(e.event_id)
                if hit is None:
                    continue
                old_event, old_etype, old_eid = hit
                if old_event in AGGREGATOR_EVENT_NAMES:
                    refold.add((old_etype, old_eid))
                if e.event in AGGREGATOR_EVENT_NAMES:
                    refold.add((e.entity_type, e.entity_id))
        return refold

    def materialized_aggregate(self, app_id, entity_type, channel_id=None
                               ) -> Optional[Dict[str, PropertyMap]]:
        aid, chan = int(app_id), self._chan(channel_id)
        try:
            # scope check, (one-time) backfill and the state read all run
            # under ONE tx: a concurrent delete_until/remove dropping the
            # scope can never interleave between the check and the read
            # (it would hand back an empty table for a non-empty store)
            with self._client.tx() as c:
                if c.execute(
                        "SELECT 1 FROM entity_props_scope WHERE app_id=?"
                        " AND channel_id=? AND entity_type=?",
                        (aid, chan, entity_type)).fetchone() is None:
                    # backfill ONCE: replay the scope's history into
                    # entity_props (tombstones too) and record the scope.
                    # The scope row goes in BEFORE scanning: the write
                    # upgrades this tx to a real write transaction, so a
                    # concurrent sqlite writer (another process; threads
                    # already serialize on the tx lock) blocks until the
                    # backfill commits instead of inserting an event the
                    # scan missed and the scope-row check skipped
                    c.execute(
                        "INSERT OR REPLACE INTO entity_props_scope"
                        " (app_id, channel_id, entity_type) VALUES (?,?,?)",
                        (aid, chan, entity_type))
                    metrics.AGGREGATE_BACKFILLS.inc(backend="sqlite")
                    names = ",".join("?" * len(AGGREGATOR_EVENT_NAMES))
                    rows = c.execute(
                        f"SELECT entity_id, event, properties, event_time"
                        f" FROM events WHERE app_id=? AND channel_id=?"
                        f" AND entity_type=? AND event IN ({names})"
                        f" ORDER BY event_time, rowid",
                        (aid, chan, entity_type)
                        + AGGREGATOR_EVENT_NAMES).fetchall()
                    states: Dict[str, Optional[EntityState]] = {}
                    for eid, name, props, etime in rows:
                        states[eid] = fold_event(
                            states.get(eid),
                            Event(event=name, entity_type=entity_type,
                                  entity_id=eid,
                                  properties=DataMap(json.loads(props)),
                                  event_time=_from_ts(etime)))
                    for eid, st in states.items():
                        self._write_state(c, aid, chan, entity_type, eid, st)
                state_rows = c.execute(
                    "SELECT entity_id, props, first_updated, last_updated"
                    " FROM entity_props WHERE app_id=? AND channel_id=?"
                    " AND entity_type=? AND props IS NOT NULL",
                    (aid, chan, entity_type)).fetchall()
        except sqlite3.OperationalError:
            # e.g. a read-only DB file/filesystem rejecting the backfill
            # write, or lock contention: aggregate_properties must stay
            # servable — fall back to the pure-read replay
            return None
        out: Dict[str, PropertyMap] = {}
        for eid, props, first, last in state_rows:
            out[eid] = PropertyMap(
                json.loads(props),
                first_updated=None if first is None else _from_ts(first),
                last_updated=None if last is None else _from_ts(last))
        return out

    def close(self) -> None:
        self._client.close()

    def shutdown(self) -> None:
        """Release this DAO's client reference (idempotent)."""
        if not getattr(self, "_released", False):
            self._released = True
            self._client.release()

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Iterable[Event], app_id,
                     channel_id=None) -> List[str]:
        """Bulk insert in one transaction (no reference analog; the
        ingest path needs it for import throughput). Write-through: the
        same transaction folds the special events into any materialized
        entity_props scopes."""
        aid, chan = int(app_id), self._chan(channel_id)
        ids: List[str] = []
        rows = []
        evs: List[Event] = []
        for event in events:
            validate_event(event)
            eid = event.event_id or new_event_id()
            ids.append(eid)
            evs.append(event.with_id(eid))
            rows.append(
                (eid, aid, chan, event.event,
                 event.entity_type, event.entity_id, event.target_entity_type,
                 event.target_entity_id, event.properties.to_json(),
                 _ts(event.event_time), json.dumps(list(event.tags)),
                 event.pr_id, _ts(event.creation_time)))
        with self._client.tx() as c:
            refold = self._collision_refolds(c, aid, chan, evs)
            c.executemany(
                "INSERT OR REPLACE INTO events (event_id, app_id, channel_id,"
                " event, entity_type, entity_id, target_entity_type,"
                " target_entity_id, properties, event_time, tags, pr_id,"
                " creation_time) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)", rows)
            self._fold_through(c, aid, chan, evs, refold)
        return ids

    def insert_raw_batch(self, rows: List[tuple], app_id: int,
                         channel_id: Optional[int] = None) -> None:
        """Pre-validated columnar insert for the native import path: rows
        are (event_id, event, entity_type, entity_id, target_entity_type,
        target_entity_id, properties_json, event_time_epoch_sec,
        tags_json, pr_id, creation_time_epoch_sec) — app/channel encoding
        stays the backend's business. Callers (tools/export_import) are
        responsible for validation — this is the data-plane fast lane,
        not the API."""
        aid, chan = int(app_id), self._chan(channel_id)
        full = [(r[0], aid, chan) + r[1:] for r in rows]
        with self._client.tx() as c:
            # the fast lane skips per-event fold bookkeeping: entities of
            # special rows landing in a materialized scope re-derive from
            # the table after the bulk insert (imports usually target
            # fresh apps, where no scope is materialized and this is free)
            scopes = self._materialized_scopes(c, aid, chan)
            refold = set()
            if scopes:
                refold = {(r[2], r[3]) for r in rows
                          if r[1] in AGGREGATOR_EVENT_NAMES
                          and r[2] in scopes}
                # rows replacing an EXISTING special event (id collision)
                # erase that event's fold contribution too — its entity
                # must re-derive even if the new row is non-special
                ids = [r[0] for r in rows]
                for i in range(0, len(ids), 500):
                    chunk = ids[i:i + 500]
                    marks = ",".join("?" * len(chunk))
                    names = ",".join("?" * len(AGGREGATOR_EVENT_NAMES))
                    refold.update(
                        (r[0], r[1]) for r in c.execute(
                            f"SELECT entity_type, entity_id FROM events"
                            f" WHERE app_id=? AND channel_id=?"
                            f" AND event_id IN ({marks})"
                            f" AND event IN ({names})",
                            (aid, chan) + tuple(chunk)
                            + AGGREGATOR_EVENT_NAMES)
                        if r[0] in scopes)
            c.executemany(
                "INSERT OR REPLACE INTO events (event_id, app_id, channel_id,"
                " event, entity_type, entity_id, target_entity_type,"
                " target_entity_id, properties, event_time, tags, pr_id,"
                " creation_time) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)", full)
            for key in refold:
                self._refold_entity(c, aid, chan, *key)

    def iter_raw_rows(self, app_id: int,
                      channel_id: Optional[int] = None):
        """Data-plane raw read (inverse of ``insert_raw_batch``, same
        tuple shape): the columnar exporter streams rows without ever
        building Event objects."""
        yield from self._client.query_iter(
            "SELECT event_id, event, entity_type, entity_id,"
            " target_entity_type, target_entity_id, properties,"
            " event_time, tags, pr_id, creation_time FROM events"
            " WHERE app_id=? AND channel_id=? ORDER BY event_time, rowid",
            (int(app_id), self._chan(channel_id)))

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        row = self._client.query_one(
            f"SELECT {_EVENT_COLS} FROM events WHERE app_id=? AND channel_id=?"
            " AND event_id=?",
            (int(app_id), self._chan(channel_id), event_id))
        return _row_to_event(row) if row else None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        aid, chan = int(app_id), self._chan(channel_id)
        with self._client.tx() as c:
            hit = c.execute(
                "SELECT event, entity_type, entity_id FROM events"
                " WHERE app_id=? AND channel_id=? AND event_id=?",
                (aid, chan, event_id)).fetchone()
            cur = c.execute(
                "DELETE FROM events WHERE app_id=? AND channel_id=?"
                " AND event_id=?", (aid, chan, event_id))
            if cur.rowcount > 0 and hit is not None \
                    and hit[0] in AGGREGATOR_EVENT_NAMES \
                    and hit[1] in self._materialized_scopes(c, aid, chan):
                self._refold_entity(c, aid, chan, hit[1], hit[2])
            return cur.rowcount > 0

    def delete_until(self, app_id, until_time, channel_id=None) -> int:
        """One DELETE statement instead of the per-event loop."""
        aid, chan = int(app_id), self._chan(channel_id)
        with self._client.tx() as c:
            cur = c.execute(
                "DELETE FROM events WHERE app_id=? AND channel_id=? AND "
                "event_time<?", (aid, chan, _ts(until_time)))
            if cur.rowcount:
                # bulk cutoff touches arbitrarily many entities: drop the
                # materialized scopes and let the next unbounded read
                # backfill from the surviving history
                self._drop_materialized(c, aid, chan)
            return int(cur.rowcount)

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=UNSET, target_entity_id=UNSET,
             limit=None, reversed=False) -> Iterable[Event]:
        where = ["app_id=?", "channel_id=?"]
        args: List[Any] = [int(app_id), self._chan(channel_id)]
        if start_time is not None:
            where.append("event_time>=?")
            args.append(_ts(start_time))
        if until_time is not None:
            where.append("event_time<?")
            args.append(_ts(until_time))
        if entity_type is not None:
            where.append("entity_type=?")
            args.append(entity_type)
        if entity_id is not None:
            where.append("entity_id=?")
            args.append(entity_id)
        if event_names is not None:
            names = list(event_names)
            where.append(f"event IN ({','.join('?' * len(names))})")
            args.extend(names)
        if target_entity_type is not UNSET:
            if target_entity_type is None:
                where.append("target_entity_type IS NULL")
            else:
                where.append("target_entity_type=?")
                args.append(target_entity_type)
        if target_entity_id is not UNSET:
            if target_entity_id is None:
                where.append("target_entity_id IS NULL")
            else:
                where.append("target_entity_id=?")
                args.append(target_entity_id)
        order = "DESC" if reversed else "ASC"
        sql = (f"SELECT {_EVENT_COLS} FROM events WHERE {' AND '.join(where)} "
               f"ORDER BY event_time {order}")
        if limit is not None and limit >= 0:
            sql += f" LIMIT {int(limit)}"
        # query_iter gives snapshot semantics (fresh WAL read connection
        # for files; materialized under lock for shared :memory:) so
        # callers may write while iterating.
        for row in self._client.query_iter(sql, args):
            yield _row_to_event(row)

    # -- tail reads (find_since contract, base.py) -------------------------
    # Arrival order = rowid order (INSERT OR REPLACE re-inserts, so an
    # id-keyed upsert re-surfaces to tail consumers — re-delivery of the
    # newest version, never a miss).

    def find_since(self, app_id, channel_id=None, cursor=None, limit=None):
        aid, chan = int(app_id), self._chan(channel_id)
        after = int(cursor.get("rowid", -1)) if cursor else -1
        last_eid = cursor.get("eventId") if cursor else None
        if after >= 0:
            # the cursor is self-validating: the row it points at must
            # still exist AND still hold the event it held when the
            # cursor was minted. A bulk delete followed by re-ingest
            # RECYCLES rowids (sqlite hands out max+1, so trimming the
            # tail re-issues the trimmed range) — a bare rowid compare
            # against MAX(rowid) cannot see that, and would silently
            # skip every event re-landed at a recycled rowid <= cursor.
            row = self._client.query_one(
                "SELECT event_id FROM events WHERE app_id=? AND"
                " channel_id=? AND rowid=?", (aid, chan, after))
            if row is None or (last_eid is not None
                               and row[0] != last_eid):
                after = -1
                last_eid = None
        sql = (f"SELECT {_EVENT_COLS}, rowid FROM events WHERE app_id=?"
               f" AND channel_id=? AND rowid>? ORDER BY rowid ASC")
        args: List[Any] = [aid, chan, after]
        if limit is not None and int(limit) >= 0:
            sql += f" LIMIT {int(limit)}"
        events: List[Event] = []
        last = after
        for row in self._client.query_iter(sql, args):
            events.append(_row_to_event(row[:-1]))
            last = int(row[-1])
        if events:
            last_eid = events[-1].event_id
        cur = {"kind": "sqlite", "rowid": last}
        if last >= 0 and last_eid is not None:
            cur["eventId"] = last_eid
        return events, cur

    def tail_cursor(self, app_id, channel_id=None):
        row = self._client.query_one(
            "SELECT rowid, event_id FROM events WHERE app_id=? AND"
            " channel_id=? ORDER BY rowid DESC LIMIT 1",
            (int(app_id), self._chan(channel_id)))
        if row is None:
            return {"kind": "sqlite", "rowid": -1}
        return {"kind": "sqlite", "rowid": int(row[0]),
                "eventId": row[1]}

    def tail_watermark(self, app_id, channel_id=None):
        row = self._client.query_one(
            "SELECT event_id, event_time, rowid FROM events WHERE app_id=?"
            " AND channel_id=? ORDER BY rowid DESC LIMIT 1",
            (int(app_id), self._chan(channel_id)))
        if row is None:
            return {"cursor": {"kind": "sqlite", "rowid": -1},
                    "lastEventId": None, "lastEventTime": None}
        return {"cursor": {"kind": "sqlite", "rowid": int(row[2]),
                           "eventId": row[0]},
                "lastEventId": row[0],
                "lastEventTime": _from_ts(row[1]).isoformat()}


class SqlitePEvents(base.LEventsBackedPEvents):
    def __init__(self, config: Optional[dict] = None):
        super().__init__(SqliteLEvents(config))

    def shutdown(self) -> None:
        self._l.shutdown()

    def find_columnar(self, app_id, channel_id=None, start_time=None,
                      until_time=None, entity_type=None, event_names=None,
                      target_entity_type=UNSET, value_property=None,
                      default_value=1.0, strict=True):
        """Native columnar scan: the value column is extracted inside SQL
        (``json_extract``) so no per-row Python Event/DataMap objects are
        built — the ingest fast path (SURVEY hard part #2)."""
        import numpy as np

        from predictionio_tpu_torch.data.columnar import ColumnarEvents

        if value_property is not None and '"' in value_property:
            # sqlite JSON paths cannot escape double quotes in key names;
            # fall back to the generic (oracle) path for exotic names
            return super().find_columnar(
                app_id, channel_id=channel_id, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                event_names=event_names,
                target_entity_type=target_entity_type,
                value_property=value_property, default_value=default_value,
                strict=strict)

        sql, args = self._columnar_sql(
            app_id, channel_id, start_time, until_time, entity_type,
            event_names, target_entity_type, value_property,
            order="event_time ASC")
        rows = list(self._l._client.query_iter(sql, args))
        return self._columnar_rows(rows, value_property, default_value,
                                   strict)

    def find_columnar_blocks(self, app_id, channel_id=None, start_time=None,
                             until_time=None, entity_type=None,
                             event_names=None, target_entity_type=UNSET,
                             value_property=None, default_value=1.0,
                             strict=True, block_size=1_000_000,
                             prefetch=0):
        """Streaming scan via rowid keyset pagination — fixed-size
        columnar blocks in storage (rowid) order, never materializing the
        whole result set (the JDBCPEvents.scala:31-100 partitioned-read
        analog). Falls back to the generic sliced scan for exotic
        property names (same reason as find_columnar). ``prefetch`` is
        accepted but ignored: one connection, one cursor — there is no
        decode stage to run ahead."""
        del prefetch
        if value_property is not None and '"' in value_property:
            yield from super().find_columnar_blocks(
                app_id, channel_id=channel_id, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                event_names=event_names,
                target_entity_type=target_entity_type,
                value_property=value_property, default_value=default_value,
                strict=strict, block_size=block_size)
            return
        last_rowid = -1
        while True:
            sql, args = self._columnar_sql(
                app_id, channel_id, start_time, until_time, entity_type,
                event_names, target_entity_type, value_property,
                order="rowid ASC", rowid_after=last_rowid,
                limit=int(block_size), with_rowid=True)
            rows = list(self._l._client.query_iter(sql, args))
            if not rows:
                return
            last_rowid = int(rows[-1][-1])
            yield self._columnar_rows([r[:-1] for r in rows],
                                      value_property, default_value, strict)
            if len(rows) < block_size:
                return

    def _columnar_sql(self, app_id, channel_id, start_time, until_time,
                      entity_type, event_names, target_entity_type,
                      value_property, *, order: str,
                      rowid_after: Optional[int] = None,
                      limit: Optional[int] = None,
                      with_rowid: bool = False):
        lev = self._l
        where = ["app_id=?", "channel_id=?"]
        args: List[Any] = [int(app_id), lev._chan(channel_id)]
        if rowid_after is not None:
            where.append("rowid>?")
            args.append(int(rowid_after))
        if start_time is not None:
            where.append("event_time>=?")
            args.append(_ts(start_time))
        if until_time is not None:
            where.append("event_time<?")
            args.append(_ts(until_time))
        if entity_type is not None:
            where.append("entity_type=?")
            args.append(entity_type)
        if event_names is not None:
            names = list(event_names)
            where.append(f"event IN ({','.join('?' * len(names))})")
            args.extend(names)
        if target_entity_type is not UNSET:
            if target_entity_type is None:
                where.append("target_entity_type IS NULL")
            else:
                where.append("target_entity_type=?")
                args.append(target_entity_type)
        if value_property is not None:
            # json_type distinguishes numbers from booleans (both extract
            # as ints) and from missing/null keys; the type column drives
            # the strict-mode check in _columnar_rows
            prop_path = '$."' + value_property + '"'
            value_col = ("json_extract(properties, ?), "
                         "json_type(properties, ?)")
            # SELECT-list params bind before the WHERE params
            args = [prop_path, prop_path] + args
        else:
            value_col = "NULL, NULL"
        rowid_col = ", rowid" if with_rowid else ""
        sql = (f"SELECT entity_id, target_entity_id, {value_col}, event_time,"
               f" event{rowid_col} FROM events"
               f" WHERE {' AND '.join(where)} ORDER BY {order}")
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        return sql, args

    def _columnar_rows(self, rows, value_property, default_value, strict):
        import numpy as np

        from predictionio_tpu_torch.data.columnar import ColumnarEvents

        n = len(rows)
        ents = np.empty(n, dtype=object)
        tgts = np.empty(n, dtype=object)
        vals = np.full(n, float(default_value), dtype=np.float32)
        times = np.empty(n, dtype=np.float64)
        names_out = np.empty(n, dtype=object)
        for i, (ent, tgt, val, jtype, etime, name) in enumerate(rows):
            ents[i] = ent
            tgts[i] = tgt
            if jtype in ("integer", "real"):
                vals[i] = val
            elif strict and jtype not in (None, "null"):
                raise ValueError(
                    f"property {value_property!r} of event for entity "
                    f"{ent!r} is non-numeric (JSON {jtype})")
            times[i] = etime
            names_out[i] = name
        return ColumnarEvents(ents, tgts, vals, times, names_out)


class _SqliteMetaDAO:
    """Shared client plumbing for the metadata/model DAOs."""

    def __init__(self, config: Optional[dict] = None):
        self._c = SqliteClient.shared((config or {}).get("path", ":memory:"))

    def close(self) -> None:
        self._c.close()

    def shutdown(self) -> None:
        """Release this DAO's client reference (idempotent)."""
        if not getattr(self, "_released", False):
            self._released = True
            self._c.release()


class SqliteApps(_SqliteMetaDAO, base.Apps):

    def insert(self, app: App) -> Optional[int]:
        try:
            with self._c.tx() as c:
                if app.id:
                    cur = c.execute(
                        "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                        (app.id, app.name, app.description))
                else:
                    cur = c.execute(
                        "INSERT INTO apps (name, description) VALUES (?,?)",
                        (app.name, app.description))
                return cur.lastrowid if not app.id else app.id
        except sqlite3.IntegrityError:
            return None

    def get(self, app_id):
        row = self._c.query_one(
            "SELECT id, name, description FROM apps WHERE id=?",
            (int(app_id),))
        return App(*row) if row else None

    def get_by_name(self, name):
        row = self._c.query_one(
            "SELECT id, name, description FROM apps WHERE name=?", (name,))
        return App(*row) if row else None

    def get_all(self):
        return [App(*r) for r in self._c.query(
            "SELECT id, name, description FROM apps ORDER BY id")]

    def update(self, app: App) -> bool:
        with self._c.tx() as c:
            cur = c.execute("UPDATE apps SET name=?, description=? WHERE id=?",
                            (app.name, app.description, app.id))
            return cur.rowcount > 0

    def delete(self, app_id) -> bool:
        with self._c.tx() as c:
            cur = c.execute("DELETE FROM apps WHERE id=?", (int(app_id),))
            return cur.rowcount > 0


class SqliteAccessKeys(_SqliteMetaDAO, base.AccessKeys):

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or base.generate_access_key()
        with self._c.tx() as c:
            c.execute("INSERT OR REPLACE INTO access_keys (key, appid, events)"
                      " VALUES (?,?,?)",
                      (key, k.appid, json.dumps(list(k.events))))
        return key

    def get(self, key):
        row = self._c.query_one(
            "SELECT key, appid, events FROM access_keys WHERE key=?", (key,))
        return AccessKey(row[0], row[1], tuple(json.loads(row[2]))) if row else None

    def get_all(self):
        return [AccessKey(r[0], r[1], tuple(json.loads(r[2])))
                for r in self._c.query(
                    "SELECT key, appid, events FROM access_keys")]

    def get_by_appid(self, appid):
        return [AccessKey(r[0], r[1], tuple(json.loads(r[2])))
                for r in self._c.query(
                    "SELECT key, appid, events FROM access_keys WHERE appid=?",
                    (int(appid),))]

    def update(self, k: AccessKey) -> bool:
        with self._c.tx() as c:
            cur = c.execute(
                "UPDATE access_keys SET appid=?, events=? WHERE key=?",
                (k.appid, json.dumps(list(k.events)), k.key))
            return cur.rowcount > 0

    def delete(self, key) -> bool:
        with self._c.tx() as c:
            cur = c.execute("DELETE FROM access_keys WHERE key=?", (key,))
            return cur.rowcount > 0


class SqliteChannels(_SqliteMetaDAO, base.Channels):

    def insert(self, c: Channel) -> Optional[int]:
        if not Channel.is_valid_name(c.name):
            return None
        try:
            with self._c.tx() as conn:
                if c.id:
                    cur = conn.execute(
                        "INSERT INTO channels (id, name, appid) VALUES (?,?,?)",
                        (c.id, c.name, c.appid))
                else:
                    cur = conn.execute(
                        "INSERT INTO channels (name, appid) VALUES (?,?)",
                        (c.name, c.appid))
                return c.id if c.id else cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id):
        row = self._c.query_one(
            "SELECT id, name, appid FROM channels WHERE id=?",
            (int(channel_id),))
        return Channel(*row) if row else None

    def get_by_appid(self, appid):
        return [Channel(*r) for r in self._c.query(
            "SELECT id, name, appid FROM channels WHERE appid=?",
            (int(appid),))]

    def delete(self, channel_id) -> bool:
        with self._c.tx() as c:
            cur = c.execute("DELETE FROM channels WHERE id=?",
                            (int(channel_id),))
            return cur.rowcount > 0


_EI_COLS = ("id, status, start_time, end_time, engine_id, engine_version,"
            " engine_variant, engine_factory, batch, env, spark_conf,"
            " data_source_params, preparator_params, algorithms_params,"
            " serving_params")


def _row_to_ei(r) -> EngineInstance:
    return EngineInstance(
        id=r[0], status=r[1], start_time=_from_ts(r[2]), end_time=_from_ts(r[3]),
        engine_id=r[4], engine_version=r[5], engine_variant=r[6],
        engine_factory=r[7], batch=r[8], env=json.loads(r[9]),
        spark_conf=json.loads(r[10]), data_source_params=r[11],
        preparator_params=r[12], algorithms_params=r[13], serving_params=r[14])


class SqliteEngineInstances(_SqliteMetaDAO, base.EngineInstances):

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or new_ei_id()
        i = dataclasses.replace(i, id=iid)
        with self._c.tx() as c:
            c.execute(
                f"INSERT OR REPLACE INTO engine_instances ({_EI_COLS})"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (i.id, i.status, _ts(i.start_time), _ts(i.end_time),
                 i.engine_id, i.engine_version, i.engine_variant,
                 i.engine_factory, i.batch, json.dumps(i.env),
                 json.dumps(i.spark_conf), i.data_source_params,
                 i.preparator_params, i.algorithms_params, i.serving_params))
        return iid

    def get(self, iid):
        row = self._c.query_one(
            f"SELECT {_EI_COLS} FROM engine_instances WHERE id=?", (iid,))
        return _row_to_ei(row) if row else None

    def get_all(self):
        return [_row_to_ei(r) for r in self._c.query(
            f"SELECT {_EI_COLS} FROM engine_instances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        return [_row_to_ei(r) for r in self._c.query(
            f"SELECT {_EI_COLS} FROM engine_instances WHERE status='COMPLETED'"
            " AND engine_id=? AND engine_version=? AND engine_variant=?"
            " ORDER BY start_time DESC",
            (engine_id, engine_version, engine_variant))]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    def update(self, i: EngineInstance) -> bool:
        with self._c.tx() as c:
            cur = c.execute(
                "UPDATE engine_instances SET status=?, start_time=?,"
                " end_time=?, engine_id=?, engine_version=?, engine_variant=?,"
                " engine_factory=?, batch=?, env=?, spark_conf=?,"
                " data_source_params=?, preparator_params=?,"
                " algorithms_params=?, serving_params=? WHERE id=?",
                (i.status, _ts(i.start_time), _ts(i.end_time), i.engine_id,
                 i.engine_version, i.engine_variant, i.engine_factory, i.batch,
                 json.dumps(i.env), json.dumps(i.spark_conf),
                 i.data_source_params, i.preparator_params,
                 i.algorithms_params, i.serving_params, i.id))
            return cur.rowcount > 0

    def delete(self, iid) -> bool:
        with self._c.tx() as c:
            cur = c.execute("DELETE FROM engine_instances WHERE id=?", (iid,))
            return cur.rowcount > 0


_EVI_COLS = ("id, status, start_time, end_time, evaluation_class,"
             " engine_params_generator_class, batch, env, evaluator_results,"
             " evaluator_results_html, evaluator_results_json")


def _row_to_evi(r) -> EvaluationInstance:
    return EvaluationInstance(
        id=r[0], status=r[1], start_time=_from_ts(r[2]), end_time=_from_ts(r[3]),
        evaluation_class=r[4], engine_params_generator_class=r[5], batch=r[6],
        env=json.loads(r[7]), evaluator_results=r[8],
        evaluator_results_html=r[9], evaluator_results_json=r[10])


class SqliteEvaluationInstances(_SqliteMetaDAO, base.EvaluationInstances):

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or new_ei_id("evi")
        i = dataclasses.replace(i, id=iid)
        with self._c.tx() as c:
            c.execute(
                f"INSERT OR REPLACE INTO evaluation_instances ({_EVI_COLS})"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (i.id, i.status, _ts(i.start_time), _ts(i.end_time),
                 i.evaluation_class, i.engine_params_generator_class, i.batch,
                 json.dumps(i.env), i.evaluator_results,
                 i.evaluator_results_html, i.evaluator_results_json))
        return iid

    def get(self, iid):
        row = self._c.query_one(
            f"SELECT {_EVI_COLS} FROM evaluation_instances WHERE id=?", (iid,))
        return _row_to_evi(row) if row else None

    def get_all(self):
        return [_row_to_evi(r) for r in self._c.query(
            f"SELECT {_EVI_COLS} FROM evaluation_instances")]

    def get_completed(self):
        return [_row_to_evi(r) for r in self._c.query(
            f"SELECT {_EVI_COLS} FROM evaluation_instances"
            " WHERE status='EVALCOMPLETED' ORDER BY start_time DESC")]

    def update(self, i: EvaluationInstance) -> bool:
        with self._c.tx() as c:
            cur = c.execute(
                "UPDATE evaluation_instances SET status=?, start_time=?,"
                " end_time=?, evaluation_class=?,"
                " engine_params_generator_class=?, batch=?, env=?,"
                " evaluator_results=?, evaluator_results_html=?,"
                " evaluator_results_json=? WHERE id=?",
                (i.status, _ts(i.start_time), _ts(i.end_time),
                 i.evaluation_class, i.engine_params_generator_class, i.batch,
                 json.dumps(i.env), i.evaluator_results,
                 i.evaluator_results_html, i.evaluator_results_json, i.id))
            return cur.rowcount > 0

    def delete(self, iid) -> bool:
        with self._c.tx() as c:
            cur = c.execute("DELETE FROM evaluation_instances WHERE id=?",
                            (iid,))
            return cur.rowcount > 0


class SqliteModels(_SqliteMetaDAO, base.Models):

    def insert(self, m: Model) -> None:
        with self._c.tx() as c:
            c.execute("INSERT OR REPLACE INTO models (id, models) VALUES (?,?)",
                      (m.id, m.models))

    def get(self, mid):
        row = self._c.query_one(
            "SELECT id, models FROM models WHERE id=?", (mid,))
        return Model(row[0], row[1]) if row else None

    def delete(self, mid) -> bool:
        with self._c.tx() as c:
            cur = c.execute("DELETE FROM models WHERE id=?", (mid,))
            return cur.rowcount > 0


def new_ei_id(prefix: str = "ei") -> str:
    import uuid
    return f"{prefix}_{uuid.uuid4().hex[:16]}"
