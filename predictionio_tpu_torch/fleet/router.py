"""Consistent-hash router DAOs over N event-server shards.

The port's copy of ``predictionio_tpu/fleet/router.py``.

The ``fleet`` storage source type: ``FleetLEvents`` / ``FleetPEvents``
implement the exact single-store contracts (``base.LEvents`` /
``base.PEvents``) over a fleet of event servers, each spoken to through
the resthttp wire (per-shard retries, per-URL breaker, keep-alive
connection pool, traceparent propagation — all inherited).

Routing: every event is owned by the shard the hash ring assigns its
ENTITY key (``entity_type/entity_id``), so

- all events of one entity live on one shard → per-entity order and
  ``reversed`` semantics are the shard's own;
- per-shard materialized aggregations cover DISJOINT entity sets → the
  fleet aggregate is a plain dict union of shard answers;
- entity-filtered ``find`` (the fold-in gather and the serving
  constraint reads) is a single-shard fast path, not a fan-out.

Reads without an entity key scatter to every shard in parallel and
merge: ``find`` heap-merges the per-shard time-ordered scans,
``find_since`` composes per-shard cursors into one opaque fleet cursor
(``{"fleetShards": {url: shard_cursor}}``) so fold-in tails all shards
transparently.

Degradation semantics: inside a serving
``degraded_scope`` a dead shard's leg is DROPPED from scatter reads and
the scope is marked ``shard_down`` (aggregations additionally
``partial_aggregation``) — the query answers from the surviving shards
and says so. Outside a scope (training reads, admin ops) a failed leg
raises: a batch read must never silently lose a shard's data. Writes
always raise on failure. ``find_since`` is the exception either way: a
dead shard's cursor entry is simply NOT advanced, so its events deliver
after recovery — delayed, never lost.
"""

from __future__ import annotations

import datetime as _dt
import heapq
import itertools
import logging
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import UNSET, StorageError
from predictionio_tpu_torch.fleet.ring import HashRing
from predictionio_tpu_torch.utils import resilience

logger = logging.getLogger("pio.torch.fleet.router")

# key of the composed cursor inside the opaque fleet cursor dict
CURSOR_KEY = "fleetShards"

DEFAULT_VIRTUAL_NODES = 128

# config keys consumed by the router itself; everything else passes
# through to each shard's resthttp wire config (service_key, timeouts,
# ca_file, pool_max, ...)
_ROUTER_KEYS = ("type", "urls", "virtual_nodes")


def entity_key(entity_type: str, entity_id: str) -> str:
    """The ring key owning one entity's events."""
    return f"{entity_type}/{entity_id}"


def _as_utc(t: Any) -> Optional[_dt.datetime]:
    """Wire timestamp → aware UTC datetime, or None if unparseable."""
    if isinstance(t, _dt.datetime):
        d = t
    else:
        try:
            d = _dt.datetime.fromisoformat(str(t).replace("Z", "+00:00"))
        except ValueError:
            return None
    if d.tzinfo is None:
        d = d.replace(tzinfo=_dt.timezone.utc)
    return d


def _time_newer(a: Any, b: Any) -> bool:
    """Is timestamp ``a`` strictly after ``b``? Shards may render the
    same instant with different UTC offsets or precision, so compare as
    datetimes; string compare is only the last-resort fallback."""
    da, db = _as_utc(a), _as_utc(b)
    if da is not None and db is not None:
        return da > db
    return str(a) > str(b)


def parse_urls(cfg: Dict[str, Any]) -> List[str]:
    raw = cfg.get("urls") or cfg.get("url") or ""
    urls = [u.rstrip("/") for u in re.split(r"[,\s]+", raw) if u]
    if not urls:
        raise StorageError(
            "fleet storage source needs URLS (comma-separated shard "
            "event-server URLs), e.g. "
            "PIO_STORAGE_SOURCES_FLEET_URLS=http://h1:7070,http://h2:7070")
    return urls


class _ShardSet:
    """Shared plumbing: per-shard clients, the ring, a scatter pool."""

    def __init__(self, cfg: Dict[str, Any],
                 make_client: Callable[[Dict[str, Any], int], Any]):
        self.urls = parse_urls(cfg)
        passthrough = {k: v for k, v in cfg.items()
                       if k not in _ROUTER_KEYS}
        self.clients = []
        for i, url in enumerate(self.urls):
            self.clients.append(make_client(dict(passthrough, url=url), i))
        self.ring = HashRing(
            len(self.urls),
            virtual_nodes=int(cfg.get("virtual_nodes")
                              or DEFAULT_VIRTUAL_NODES))
        self.pool = ThreadPoolExecutor(
            max_workers=min(32, 4 * len(self.urls)),
            thread_name_prefix="pio-fleet")
        self._closed = False
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.urls)

    def scatter(self, fn: Callable[[int], Any]
                ) -> Tuple[List[Any], List[Optional[BaseException]]]:
        """Run ``fn(shard_index)`` on every shard in parallel. Returns
        index-aligned ``(results, errors)``; a shard's slot holds its
        result or its StorageError. Non-storage exceptions (bugs)
        propagate immediately."""
        n = len(self.urls)
        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n
        futs = {self.pool.submit(fn, i): i for i in range(n)}
        bug: Optional[BaseException] = None
        for fut, i in futs.items():
            try:
                results[i] = fut.result()
            except StorageError as e:
                errors[i] = e
            except Exception as e:  # noqa: BLE001 — re-raised below
                bug = bug or e
        if bug is not None:
            raise bug
        return results, errors

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for c in self.clients:
            # PEvents-shaped clients have no wire of their own to close
            fn = getattr(c, "close", None)
            if fn is None:
                continue
            try:
                fn()
            except Exception:
                logger.exception("fleet shard close failed (non-fatal)")
        self.pool.shutdown(wait=False)


class FleetLEvents(base.LEvents):
    """LEvents over a consistent-hash fleet of event-server shards."""

    metrics_backend = "fleet"
    # each shard leg runs under ITS wire's retries + breaker; stacking
    # the registry wrapper's retry loop on top would double-retry
    self_resilient = True
    idempotent_event_writes = True
    resilience_endpoint = "fleet"
    # an entity's read goes to its one owner shard, which answers it
    # server-side: k entity reads cost k one-shard requests, where a
    # scan would ship and decode the whole fleet here (the fold-in
    # gather reads per user on this flag)
    indexed_entity_reads = True

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        from predictionio_tpu_torch.data.storage.observed import DAOMetricsWrapper
        from predictionio_tpu_torch.data.storage.resthttp import RestLEvents

        cfg = dict(config or {})
        # each shard client is metrics-wrapped with its shard index so
        # one slow or failing shard is visible INSIDE the fan-out
        # (pio_storage_op_seconds{backend="fleet",shard="2"}); the
        # wrapper passes resilience through (RestLEvents owns it)
        self._set = _ShardSet(
            cfg, lambda scfg, i: DAOMetricsWrapper(
                RestLEvents(scfg), backend="fleet", shard=str(i)))
        self._partial_reads = 0

    # -- shard plumbing ---------------------------------------------------
    @property
    def urls(self) -> List[str]:
        return self._set.urls

    @property
    def _clients(self) -> List[Any]:
        return self._set.clients

    def _shard_for_entity(self, entity_type: str, entity_id: str) -> int:
        return self._set.ring.node_for(entity_key(entity_type, entity_id))

    def _shard_for_event(self, event: Event) -> int:
        return self._shard_for_entity(event.entity_type, event.entity_id)

    def _survivors(self, errors: Sequence[Optional[BaseException]],
                   op: str, aggregation: bool = False) -> List[int]:
        """Indices of shards that answered. All dead → raise. Some dead
        → inside a degraded_scope mark and continue with the partial
        answer; outside, raise (training/admin must fail loud)."""
        ok = [i for i, e in enumerate(errors) if e is None]
        failed = [i for i, e in enumerate(errors) if e is not None]
        if not failed:
            return ok
        for i in failed:
            logger.warning("fleet %s: shard %d (%s) failed: %r",
                           op, i, self.urls[i], errors[i])
        if not ok or not resilience.in_degraded_scope():
            raise errors[failed[0]]  # type: ignore[misc]
        resilience.mark_degraded("shard_down")
        if aggregation:
            resilience.mark_degraded("partial_aggregation")
        self._partial_reads += 1
        return ok

    def topology(self) -> Dict[str, Any]:
        """Fleet health for ``/stats.json`` and ``pio status``: every
        shard with its breaker state (the same per-URL breaker the
        wire feeds)."""
        shards = []
        for i, url in enumerate(self.urls):
            br = resilience.breaker_for(url)
            shards.append({"index": i, "url": url,
                           "breakerState": br.state,
                           "healthy": not br.is_blocking})
        return {"type": "fleet",
                "shards": shards,
                "healthyShards": sum(1 for s in shards if s["healthy"]),
                "virtualNodes": self._set.ring.virtual_nodes,
                "partialReads": self._partial_reads}

    # -- lifecycle --------------------------------------------------------
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        results, errors = self._set.scatter(
            lambda i: self._clients[i].init(app_id, channel_id))
        for e in errors:
            if e is not None:
                raise e
        return all(bool(r) for r in results)

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        results, errors = self._set.scatter(
            lambda i: self._clients[i].remove(app_id, channel_id))
        for e in errors:
            if e is not None:
                raise e
        return all(bool(r) for r in results)

    def close(self) -> None:
        self._set.close()

    def shutdown(self) -> None:
        self._set.close()

    # -- writes (fan out by entity key; failures raise — a lost write
    # is data loss, never a degradation) ----------------------------------
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self._clients[self._shard_for_event(event)].insert(
            event, app_id, channel_id)

    def insert_batch(self, events: Iterable[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        seq = list(events)
        if not seq:
            return []
        groups: Dict[int, List[int]] = {}
        for pos, ev in enumerate(seq):
            groups.setdefault(self._shard_for_event(ev), []).append(pos)
        if len(groups) == 1:
            shard = next(iter(groups))
            return self._clients[shard].insert_batch(seq, app_id,
                                                     channel_id)
        futs = {}
        for shard, positions in groups.items():
            futs[self._set.pool.submit(
                self._clients[shard].insert_batch,
                [seq[p] for p in positions], app_id, channel_id)] = positions
        ids: List[Optional[str]] = [None] * len(seq)
        first_err: Optional[BaseException] = None
        for fut, positions in futs.items():
            try:
                got = fut.result()
                for p, eid in zip(positions, got):
                    ids[p] = eid
            except BaseException as e:  # noqa: BLE001
                first_err = first_err or e
        if first_err is not None:
            raise first_err
        return ids  # type: ignore[return-value]

    # -- point reads ------------------------------------------------------
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        # event ids carry no entity key: ask everyone, first hit wins
        results, errors = self._set.scatter(
            lambda i: self._clients[i].get(event_id, app_id, channel_id))
        for r in results:
            if r is not None:
                return r
        self._survivors(errors, "get")
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        results, errors = self._set.scatter(
            lambda i: self._clients[i].delete(event_id, app_id,
                                              channel_id))
        for e in errors:
            if e is not None:
                raise e
        return any(bool(r) for r in results)

    def delete_until(self, app_id: int, until_time: _dt.datetime,
                     channel_id: Optional[int] = None) -> int:
        results, errors = self._set.scatter(
            lambda i: self._clients[i].delete_until(app_id, until_time,
                                                    channel_id))
        for e in errors:
            if e is not None:
                raise e
        return sum(int(r) for r in results)

    # -- filtered scans ---------------------------------------------------
    def find(self, app_id: int, channel_id: Optional[int] = None,
             start_time: Optional[_dt.datetime] = None,
             until_time: Optional[_dt.datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[Sequence[str]] = None,
             target_entity_type: Any = UNSET,
             target_entity_id: Any = UNSET,
             limit: Optional[int] = None,
             reversed: bool = False) -> Iterable[Event]:
        kwargs = dict(
            start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit, reversed=reversed)
        if entity_type is not None and entity_id is not None:
            # single-shard fast path: the ring owner holds ALL of this
            # entity's events (the fold-in gather + serving constraint
            # reads land here). Inside a degraded_scope a dead owner
            # degrades to an empty scan, marked — matching the
            # scatter-path semantics instead of failing the query.
            shard = self._shard_for_entity(entity_type, entity_id)
            it = self._clients[shard].find(
                app_id=app_id, channel_id=channel_id, **kwargs)
            if not resilience.in_degraded_scope():
                return it
            try:
                return iter(list(it))
            except StorageError as e:
                logger.warning("fleet find: owner shard %d (%s) failed: "
                               "%r", shard, self.urls[shard], e)
                resilience.mark_degraded("shard_down")
                self._partial_reads += 1
                return iter(())
        results, errors = self._set.scatter(
            lambda i: list(self._clients[i].find(
                app_id=app_id, channel_id=channel_id, **kwargs)))
        ok = self._survivors(errors, "find")
        merged = heapq.merge(
            *(results[i] for i in ok),
            key=lambda e: e.event_time, reverse=bool(reversed))
        if limit is not None and limit >= 0:
            return itertools.islice(merged, limit)
        return merged

    # -- aggregation (materialized state, merged on read) -----------------
    def materialized_aggregate(self, app_id: int, entity_type: str,
                               channel_id: Optional[int] = None):
        results, errors = self._set.scatter(
            lambda i: self._clients[i].materialized_aggregate(
                app_id, entity_type, channel_id))
        if any(e is not None for e in errors) or \
                any(r is None for r in results):
            return None  # caller falls back to the replay fold
        out: Dict[str, Any] = {}
        for r in results:
            out.update(r)  # entity sets are ring-disjoint
        return out

    def aggregate_properties(self, app_id: int, entity_type: str,
                             channel_id: Optional[int] = None,
                             start_time: Optional[_dt.datetime] = None,
                             until_time: Optional[_dt.datetime] = None,
                             required: Optional[Sequence[str]] = None):
        """Scatter the aggregate to every shard (each serves from ITS
        materialized state or replays per the base contract) and union
        the disjoint per-entity answers."""
        results, errors = self._set.scatter(
            lambda i: self._clients[i].aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                required=required))
        ok = self._survivors(errors, "aggregate", aggregation=True)
        out: Dict[str, Any] = {}
        for i in ok:
            out.update(results[i])
        return out

    # -- tail reads (the fleet cursor fold-in consumes) -------------------
    def find_since(self, app_id: int, channel_id: Optional[int] = None,
                   cursor: Optional[Dict] = None,
                   limit: Optional[int] = None
                   ) -> Tuple[List[Event], Dict]:
        """Fleet tail read. ``limit`` is split as ceil(limit/n) PER
        SHARD, so one call may return up to n*ceil(limit/n) events — a
        deliberate loosening of the base contract's "limit bounds one
        call": per-shard cursors are opaque and already advanced past
        every delivered event, so truncating fleet-side would DROP the
        tail the composed cursor has passed (lost events, which the
        cursor contract forbids). Consumers treat ``limit`` as a
        per-cycle batch-size hint, never an exact cap — the
        fold-in consumer does."""
        n = len(self._set)
        prior: Dict[str, Any] = {}
        if cursor:
            prior = dict(cursor.get(CURSOR_KEY) or {})
        per_limit = None if limit is None \
            else max(1, -(-int(limit) // n))  # ceil(limit / n)
        results, errors = self._set.scatter(
            lambda i: self._clients[i].find_since(
                app_id, channel_id, cursor=prior.get(self.urls[i]),
                limit=per_limit))
        ok = [i for i, e in enumerate(errors) if e is None]
        if not ok:
            raise errors[0]  # type: ignore[misc]
        events: List[Event] = []
        # a dead shard KEEPS its prior cursor entry: its events deliver
        # after recovery — delayed, never lost, and never a gap
        composed = dict(prior)
        for i in ok:
            evs, cur = results[i]
            events.extend(evs)
            composed[self.urls[i]] = cur
        if len(ok) < n:
            for i, e in enumerate(errors):
                if e is not None:
                    logger.warning(
                        "fleet find_since: shard %d (%s) skipped this "
                        "cycle: %r", i, self.urls[i], e)
            resilience.mark_degraded("shard_down")
            self._partial_reads += 1
        return events, {CURSOR_KEY: composed}

    def tail_cursor(self, app_id: int,
                    channel_id: Optional[int] = None) -> Dict:
        # minting a "future events only" anchor needs EVERY shard: a
        # missing entry would replay that shard from the start later
        results, errors = self._set.scatter(
            lambda i: self._clients[i].tail_cursor(app_id, channel_id))
        for e in errors:
            if e is not None:
                raise e
        return {CURSOR_KEY: {self.urls[i]: results[i]
                             for i in range(len(self._set))}}

    def tail_watermark(self, app_id: int,
                       channel_id: Optional[int] = None) -> Optional[Dict]:
        results, errors = self._set.scatter(
            lambda i: self._clients[i].tail_watermark(app_id, channel_id))
        if any(e is not None for e in errors) or \
                any(r is None for r in results):
            return None  # contract: None when not cheaply knowable
        cursors: Dict[str, Any] = {}
        last_id = None
        last_time = None
        for i, wm in enumerate(results):
            cursors[self.urls[i]] = wm.get("cursor")
            t = wm.get("lastEventTime")
            if t is not None and (last_time is None
                                  or _time_newer(t, last_time)):
                last_time = t
                last_id = wm.get("lastEventId")
        return {"cursor": {CURSOR_KEY: cursors},
                "lastEventId": last_id, "lastEventTime": last_time}


class FleetPEvents(base.PEvents):
    """Bulk training reads over the fleet — the batch plane. No
    degradation here: a training scan that silently lost a shard would
    train on a biased slice, so every failed leg raises."""

    metrics_backend = "fleet"

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        from predictionio_tpu_torch.data.storage.resthttp import RestPEvents

        self._set = _ShardSet(dict(config or {}),
                              lambda scfg, i: RestPEvents(scfg))

    @property
    def urls(self) -> List[str]:
        return self._set.urls

    @property
    def _clients(self) -> List[Any]:
        return self._set.clients

    def close(self) -> None:
        self._set.close()

    def shutdown(self) -> None:
        self._set.close()

    @staticmethod
    def _raise_any(errors: Sequence[Optional[BaseException]]) -> None:
        for e in errors:
            if e is not None:
                raise e

    def find(self, app_id, channel_id=None, start_time=None,
             until_time=None, entity_type=None, entity_id=None,
             event_names=None, target_entity_type=UNSET,
             target_entity_id=UNSET) -> List[Event]:
        results, errors = self._set.scatter(
            lambda i: self._clients[i].find(
                app_id=app_id, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id))
        self._raise_any(errors)
        return list(heapq.merge(*results, key=lambda e: e.event_time))

    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> None:
        seq = list(events)
        if not seq:
            return
        groups: Dict[int, List[Event]] = {}
        for ev in seq:
            shard = self._set.ring.node_for(
                entity_key(ev.entity_type, ev.entity_id))
            groups.setdefault(shard, []).append(ev)
        futs = [self._set.pool.submit(self._clients[shard].write, evs,
                                      app_id, channel_id)
                for shard, evs in groups.items()]
        first_err: Optional[BaseException] = None
        for fut in futs:
            try:
                fut.result()
            except BaseException as e:  # noqa: BLE001
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def delete(self, event_ids: Iterable[str], app_id: int,
               channel_id: Optional[int] = None) -> None:
        ids = list(event_ids)
        if not ids:
            return
        _, errors = self._set.scatter(
            lambda i: self._clients[i].delete(ids, app_id, channel_id))
        self._raise_any(errors)

    def find_columnar(self, app_id, channel_id=None, start_time=None,
                      until_time=None, entity_type=None, event_names=None,
                      target_entity_type=UNSET, value_property=None,
                      default_value=1.0, strict=True):
        import numpy as np

        from predictionio_tpu_torch.data.columnar import ColumnarEvents

        results, errors = self._set.scatter(
            lambda i: self._clients[i].find_columnar(
                app_id=app_id, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, event_names=event_names,
                target_entity_type=target_entity_type,
                value_property=value_property,
                default_value=default_value, strict=strict))
        self._raise_any(errors)
        batch = ColumnarEvents.concat(results)
        if len(batch) == 0:
            return batch
        # single-store find_columnar is time-ordered; a stable sort
        # keeps per-shard (= per-entity) relative order on ties
        order = np.argsort(batch.event_times, kind="stable")
        if np.array_equal(order, np.arange(len(order))):
            return batch
        return batch.take(order)

    def find_columnar_blocks(self, app_id, channel_id=None,
                             start_time=None, until_time=None,
                             entity_type=None, event_names=None,
                             target_entity_type=UNSET, value_property=None,
                             default_value=1.0, strict=True,
                             block_size=1_000_000, prefetch=0):
        """Per-shard block streams issued TOGETHER, yielded in shard
        order — blocks are STORAGE order by contract, and with the
        background readers every shard decodes in parallel while the
        consumer drains shard 0 (the ``prefetch`` hint bounds how many
        blocks each reader runs ahead)."""
        from predictionio_tpu_torch.data.columnar import iter_blocks_threaded

        gens = [c.find_columnar_blocks(
                    app_id=app_id, channel_id=channel_id,
                    start_time=start_time, until_time=until_time,
                    entity_type=entity_type, event_names=event_names,
                    target_entity_type=target_entity_type,
                    value_property=value_property,
                    default_value=default_value, strict=strict,
                    block_size=block_size, prefetch=prefetch)
                for c in self._clients]
        threaded = [iter_blocks_threaded(g, queue_size=max(2, prefetch))
                    for g in gens]
        for it in threaded:
            for block in it:
                yield block

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        results, errors = self._set.scatter(
            lambda i: self._clients[i].aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                required=required))
        self._raise_any(errors)
        out: Dict[str, Any] = {}
        for r in results:
            out.update(r)
        return out
