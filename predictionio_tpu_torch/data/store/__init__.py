"""Name-based, engine-facing event store facades.

Parity targets: ``PEventStore`` (``data/.../store/PEventStore.scala:30-116``),
``LEventStore`` (``store/LEventStore.scala:30-142``), and
``Common.appNameToId`` (``store/Common.scala:28-49``) which resolves
(appName, channelName) -> (appId, channelId) via the metadata repositories.

The port's copy of ``predictionio_tpu/data/store/__init__.py``, over the
port's storage registry. A predict-time read fails fast while the event
store's circuit breaker is open, runs under its deadline on a pool
thread that carries the caller's request id and trace context, and
marks the active degradation scope with the reason it failed
(``circuit_open``, ``timeout``, ``storage_error``), as in the JAX
package.
"""

from __future__ import annotations

import datetime as _dt
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import UNSET, StorageCircuitOpen
from predictionio_tpu_torch.utils import resilience
from predictionio_tpu_torch.utils.tracing import carrying_context


def app_name_to_id(app_name: str,
                   channel_name: Optional[str] = None) -> Tuple[int, Optional[int]]:
    """(appName, channelName) -> (appId, channelId); raises on unknown names
    (Common.scala:28-49)."""
    apps = storage.get_metadata_apps()
    app = apps.get_by_name(app_name)
    if app is None:
        raise ValueError(
            f"App name {app_name} is not found. Have you created this app?")
    channel_id: Optional[int] = None
    if channel_name is not None:
        channels = storage.get_metadata_channels().get_by_appid(app.id)
        match = next((c for c in channels if c.name == channel_name), None)
        if match is None:
            raise ValueError(
                f"Channel name {channel_name} is not found for app {app_name}.")
        channel_id = match.id
    return app.id, channel_id


class PEventStore:
    """Bulk reads for training (PEventStore.scala:54,94)."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
    ) -> List[Event]:
        app_id, channel_id = app_name_to_id(app_name, channel_name)
        return storage.get_pevents().find(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id)

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Current entity-property state for training reads.

        The unbounded call (no ``start_time``/``until_time``) is served
        from the backend's MATERIALIZED aggregate — O(current entities),
        not O(event history); bounded calls replay (see
        ``LEvents.aggregate_properties``)."""
        app_id, channel_id = app_name_to_id(app_name, channel_name)
        return storage.get_pevents().aggregate_properties(
            app_id=app_id, entity_type=entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time, required=required)

    @staticmethod
    def find_columnar(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        value_property: Optional[str] = None,
        default_value: float = 1.0,
        strict: bool = True,
    ):
        """Struct-of-arrays bulk read — the ingest path (no reference
        analog; replaces RDD[Event] + per-template reshaping with one
        vectorized scan, see data/columnar.py)."""
        app_id, channel_id = app_name_to_id(app_name, channel_name)
        return storage.get_pevents().find_columnar(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
            value_property=value_property, default_value=default_value,
            strict=strict)

    @staticmethod
    def find_columnar_blocks(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        value_property: Optional[str] = None,
        default_value: float = 1.0,
        strict: bool = True,
        block_size: int = 1_000_000,
        prefetch: int = 0,
    ):
        """Streaming bulk read: ColumnarEvents blocks in storage order —
        the ≥10M-event ingest path (partitioned reads like
        JDBCPEvents.scala:31-100 / HBPEvents.scala:83-89; backends bound
        per-block memory). ``prefetch`` hints how far the backend may
        read/decode ahead (jsonlfs: that many partitions in parallel);
        backends without a natural unit ignore it."""
        app_id, channel_id = app_name_to_id(app_name, channel_name)
        return storage.get_pevents().find_columnar_blocks(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
            value_property=value_property, default_value=default_value,
            strict=strict, block_size=block_size, prefetch=prefetch)


class LEventStoreTimeoutError(TimeoutError):
    """Predict-time read exceeded its deadline (the reference's
    TimeoutException from Await.result, LEventStore.scala:58)."""


class _DaemonReadPool:
    """Minimal worker pool with DAEMON threads for deadline-bounded reads.

    ``concurrent.futures.ThreadPoolExecutor`` joins its (non-daemon)
    workers at interpreter exit — a permanently wedged read (exactly the
    scenario the pool guards against) would hang process shutdown.
    Daemon workers match every other background thread in the codebase.
    """

    def __init__(self, max_workers: int = 16):
        import queue

        self._tasks: "queue.Queue" = queue.Queue()
        self._max_workers = max_workers
        self._spawned = 0
        self._lock = threading.Lock()

    def _worker(self) -> None:
        while True:
            fn, box, done, started = self._tasks.get()
            started.set()
            try:
                box.append((True, fn()))
            except BaseException as e:  # delivered to the waiter
                box.append((False, e))
            finally:
                done.set()

    def submit(self, fn):
        with self._lock:
            # grow lazily up to the cap (a wedged worker never returns,
            # so permanently losing threads to wedged reads is bounded)
            if self._spawned < self._max_workers:
                self._spawned += 1
                t = threading.Thread(target=self._worker, daemon=True,
                                     name=f"pio-leventstore-{self._spawned}")
                t.start()
        box: list = []
        done = threading.Event()
        started = threading.Event()
        self._tasks.put((fn, box, done, started))
        return box, done, started


_read_pool = None
_read_pool_lock = threading.Lock()


def _pool() -> _DaemonReadPool:
    global _read_pool
    with _read_pool_lock:
        if _read_pool is None:
            _read_pool = _DaemonReadPool()
        return _read_pool


# (DAO instance, its breaker): re-resolved only when storage.reset()
# swaps the DAO — predict-time reads must not pay the process-global
# breaker-registry lock per call
_breaker_cache: Tuple[Any, Any] = (None, None)


def _event_store_breaker():
    """The circuit breaker guarding the EVENTDATA backend this process
    reads at predict time (None when storage is not resolvable)."""
    global _breaker_cache

    try:
        le = storage.get_levents()
    except Exception:
        return None
    cached_le, cached_br = _breaker_cache
    if cached_le is le:
        return cached_br
    ep = resilience.endpoint_of(le)
    br = resilience.breaker_for(ep) if ep else None
    _breaker_cache = (le, br)
    return br


def _bounded(fn, timeout: Optional[float]):
    """Run ``fn`` with an optional deadline (seconds). ``None`` = direct
    call (no extra thread hop on the common local-backend path). The
    deadline path hops to a pool thread, which would otherwise lose the
    caller's request-id/trace contextvars — exactly where slow-read
    attribution matters most — so the snapshot rides along.

    Resilience wiring: when the event store's circuit breaker is open,
    the read fails IMMEDIATELY (no pool hop, no timeout wait — a
    blacked-out store must cost a query microseconds, not its full
    deadline). Every failure marks the active
    :func:`~predictionio_tpu_torch.utils.resilience.degraded_scope`
    before propagating, so templates that swallow the error and serve
    from the device factor store still get the response stamped
    ``degraded``."""
    # the kill switch bypasses the breaker HERE too (consulting or
    # feeding it while disabled would let state accumulate invisibly)
    br = _event_store_breaker() if resilience.enabled() else None
    if br is not None and br.is_blocking:
        resilience.mark_degraded("circuit_open")
        raise StorageCircuitOpen(br.endpoint, br.retry_in)
    try:
        if timeout is None:
            return fn()
        box, done, started = _pool().submit(carrying_context(fn))
        if not done.wait(timeout):
            err = LEventStoreTimeoutError(
                f"event-store read exceeded {timeout}s")
            if br is not None and started.is_set():
                # a HUNG store never raises inside the DAO (where op
                # failures are normally counted) — the deadline here is
                # the only layer that sees it, and without this a
                # wedged backend would cost every query its full read
                # timeout instead of tripping the fast-fail breaker.
                # A task still QUEUED behind busy workers says nothing
                # about the store: counting client-side congestion as
                # endpoint failures would open the breaker (and flip
                # every replica's /healthz) on a healthy backend.
                br.record_failure(err)
            raise err
        ok, value = box[0]
        if ok:
            return value
        raise value
    except BaseException as e:
        resilience.mark_degraded(resilience.degrade_reason_for(e))
        raise


class LEventStore:
    """Low-latency reads at predict time (LEventStore.scala:58,114).

    The reference's calls block with a ``timeout: Duration``; here
    ``timeout`` (seconds) bounds the read the same way — predict-time
    constraint lookups are on the serving hot path, and a wedged backend
    must surface as a fast ``LEventStoreTimeoutError`` (which templates
    catch and degrade on), not a stalled query. ``None`` runs direct.
    """

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
        timeout: Optional[float] = None,
    ) -> List[Event]:
        def read():
            # the metadata lookup hits the same backend — it must run
            # under the deadline too, or a wedged store stalls the caller
            # before _bounded is ever reached
            app_id, channel_id = app_name_to_id(app_name, channel_name)
            return list(storage.get_levents().find(
                app_id=app_id, channel_id=channel_id, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                entity_id=entity_id, event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id, limit=limit,
                reversed=latest))

        return _bounded(read, timeout)

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> List[Event]:
        def read():
            # metadata lookup under the deadline too (see find_by_entity)
            app_id, channel_id = app_name_to_id(app_name, channel_name)
            return list(storage.get_levents().find(
                app_id=app_id, channel_id=channel_id, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                entity_id=entity_id, event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id, limit=limit))

        return _bounded(read, timeout)
