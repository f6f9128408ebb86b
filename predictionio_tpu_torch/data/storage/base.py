"""Storage DAO contracts + metadata records.

Parity targets:
- ``LEvents`` trait (reference ``data/.../storage/LEvents.scala:76-328``):
  CRUD + filtered find + property aggregation over one app/channel. The
  reference exposes Future-based and blocking variants; our servers use
  threads + sqlite/memory backends, so the blocking API is canonical and
  async wrappers live at the server layer.
- ``PEvents`` (``PEvents.scala:77-181``): bulk reads for training. Spark
  RDDs are replaced by list/numpy columnar batches — the ingest format.
- Metadata records: ``Apps.scala``, ``AccessKeys.scala`` (48-byte secure
  keygen, :65-70), ``Channels.scala`` (name regex, :51-54),
  ``EngineInstances.scala:43-59`` (15 fields), ``EvaluationInstances.scala``,
  ``Models.scala:30-49``.

The port's copy of ``predictionio_tpu/data/storage/base.py``, with the
breaker + retry shell the DAO wrapper and the ``resthttp`` wire share
(:func:`run_guarded`, :class:`StorageCircuitOpen`); every
``aggregate_properties`` read is counted as in the JAX package
(``pio_aggregate_hits_total``, ``pio_aggregate_replays_total``). The
tail reads (``find_since``, ``tail_cursor``, ``tail_watermark``) raise
``StorageError`` here, as in the JAX package; the ``jsonlfs``, memory
and sqlite backends implement them.
"""

from __future__ import annotations

import abc
import base64
import dataclasses
import datetime as _dt
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.utils import metrics, resilience

# Sentinel distinguishing "no filter" from "filter for None"
# (reference models this as Option[Option[String]], LEvents.scala:137-150).
UNSET = object()


class StorageError(RuntimeError):
    pass


class StorageCircuitOpen(StorageError,
                         resilience.CircuitOpenError):
    """The storage endpoint's circuit breaker refused the call — BOTH a
    ``StorageError`` (callers treating "storage is down" uniformly, e.g.
    ``pio status``, catch it) and a ``CircuitOpenError`` (resilience-aware
    callers read the breaker semantics and the ``pio_retry_after``
    hint)."""

    def __init__(self, endpoint: str, retry_in: float):
        resilience.CircuitOpenError.__init__(self, endpoint, retry_in)

    @classmethod
    def from_error(cls, e: "resilience.CircuitOpenError"
                   ) -> "StorageCircuitOpen":
        return cls(e.endpoint, getattr(e, "pio_retry_after", 0.0))


def run_guarded(breaker: "resilience.CircuitBreaker",
                policy: "resilience.RetryPolicy",
                attempt_fn, *, idempotent: Any = True,
                on_retry=None, defer_success: bool = False,
                first_failure=None):
    """The breaker + retry shell shared by the DAO wrapper
    (``observed.DAOMetricsWrapper``) and the resthttp ``_Wire``: gate on
    the breaker (an open circuit surfaces as :class:`StorageCircuitOpen`
    so "storage is down" handlers catch it), run ``attempt_fn`` under the
    retry policy, feed the final outcome back to the breaker.
    ``defer_success`` skips the success mark — for lazy ops (``find``
    returning a generator) the CALLER records the outcome when iteration
    ends, so generator creation cannot masquerade as a healthy read.
    ``first_failure`` (``(exception, start)``): the breaker already
    admitted attempt 0, which failed; the shell takes over from there
    (:meth:`~predictionio_tpu_torch.utils.resilience.RetryPolicy.run`)."""
    if first_failure is None:
        try:
            breaker.before_call()
        except resilience.CircuitOpenError as e:
            raise StorageCircuitOpen.from_error(e) from None
    try:
        result = policy.run(attempt_fn, idempotent=idempotent,
                            on_retry=on_retry, first_failure=first_failure)
    except BaseException as e:
        breaker.record_failure(e)
        raise
    if not defer_success:
        breaker.record_success()
    return result


class LEvents(abc.ABC):
    """Event store DAO scoped by (app_id, channel_id)."""

    # label value for this backend's storage/aggregation metrics;
    # concrete backends override (memory/sqlite/jsonlfs/resthttp)
    metrics_backend = "unknown"

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize the backing store for one app/channel (LEvents.scala:87)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop all events of one app/channel (LEvents.scala:95)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert; returns the assigned event ID (futureInsert parity)."""

    def insert_batch(self, events: Iterable[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Bulk insert; returns assigned IDs in order. Backends override with
        a transactional fast path (the ingest path needs the throughput;
        no single reference analog — closest is PEvents.write)."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterable[Event]:
        """Filtered scan ordered by event_time (LEvents.scala:118-176).

        ``limit=None`` or ``-1`` means no limit. ``reversed=True`` returns
        descending event time (only sensible with entity filters, as in the
        reference).
        """

    # -- tail reads (online fold-in) --------------------------------------
    #
    # The cursor is an opaque JSON-safe dict each backend mints for its
    # own notion of arrival order (memory: insertion sequence; sqlite:
    # rowid; jsonlfs: the per-partition byte watermark of its
    # materialized-aggregation snapshot; resthttp: whatever the remote
    # server's backend mints, passed through verbatim). Contract:
    # every event APPENDED after the cursor was minted is delivered by a
    # later find_since exactly once in arrival order; a store rewrite
    # (remove / delete_until / partition rewrite) may invalidate a
    # cursor, in which case the backend RESETS and replays from the
    # start — consumers must be replay-tolerant (the fold-in consumer
    # is: it re-gathers full per-user state, so a replay is wasted work,
    # never wrong results).

    def find_since(self, app_id: int, channel_id: Optional[int] = None,
                   cursor: Optional[Dict] = None,
                   limit: Optional[int] = None
                   ) -> Tuple[List[Event], Dict]:
        """Events appended after ``cursor`` (``None`` = from the start)
        in arrival order, plus the advanced cursor. ``limit`` bounds one
        call; the returned cursor resumes exactly after the last
        delivered event."""
        raise StorageError(
            f"{type(self).__name__} does not support tail reads "
            "(find_since)")

    def tail_cursor(self, app_id: int,
                    channel_id: Optional[int] = None) -> Dict:
        """A cursor at the CURRENT end of the stream — what a consumer
        that only wants future events starts from (O(1)-ish; never a
        store scan)."""
        raise StorageError(
            f"{type(self).__name__} does not support tail reads "
            "(tail_cursor)")

    def tail_watermark(self, app_id: int,
                       channel_id: Optional[int] = None
                       ) -> Optional[Dict]:
        """Observability view of the stream end: ``{"cursor": ...,
        "lastEventId": ..., "lastEventTime": ...}`` (id/time ``None``
        for an empty scope), or ``None`` when the backend keeps no
        cheap notion of it. Surfaced per (app, channel) by the event
        server's ``GET /stats.json`` — the freshness hook the online
        fold-in story needs."""
        return None

    def delete_until(self, app_id: int, until_time: _dt.datetime,
                     channel_id: Optional[int] = None) -> int:
        """Bulk-remove every event with event_time < until_time; returns
        the count removed. This is the cleanup-app capability
        (``examples/experimental/scala-cleanup-app/.../DataSource.scala``
        deletes pre-cutoff events one futureDelete at a time); backends
        override with single-pass bulk paths."""
        ids = [e.event_id for e in self.find(
            app_id=app_id, channel_id=channel_id, until_time=until_time)]
        n = 0
        for eid in ids:
            if eid and self.delete(eid, app_id, channel_id):
                n += 1
        return n

    def materialized_aggregate(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
    ) -> Optional[Dict[str, PropertyMap]]:
        """Serve the unbounded "state now" aggregation from materialized
        state, or return ``None`` when this backend keeps none (the
        caller then falls back to :meth:`aggregate_properties_replay`).
        An EMPTY scope with materialized support returns ``{}``, never
        ``None``. Backends maintain this state write-through at insert
        (sqlite/memory) or as a watermark snapshot + delta replay
        (jsonlfs); semantics are bit-identical to the replay fold."""
        return None

    def aggregate_properties_replay(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """The O(event history) fold over a filtered scan — the reference
        semantics (LEvents.scala:191-214) and the oracle the materialized
        path is differentially tested against."""
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=list(aggregate_event_names()),
        )
        return _apply_required(aggregate_properties(events), required)

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Fold special events into per-entity property state
        (LEvents.scala:191-214).

        The unbounded call — the shape every template training read
        issues — is served from materialized state when the backend
        keeps it (O(current entities) instead of O(event history)); any
        ``start_time``/``until_time`` bound falls back to the replay
        fold so time-travel semantics stay exact. Every read is
        accounted in the metrics registry: a materialized hit, a
        ``bounded`` replay (time-travel query) or a ``fallback`` replay
        (backend keeps no state)."""
        if start_time is None and until_time is None:
            result = self.materialized_aggregate(app_id, entity_type,
                                                 channel_id)
            if result is not None:
                metrics.AGGREGATE_HITS.inc(backend=self.metrics_backend)
                return _apply_required(result, required)
            metrics.AGGREGATE_REPLAYS.inc(backend=self.metrics_backend,
                                          reason="fallback")
        else:
            metrics.AGGREGATE_REPLAYS.inc(backend=self.metrics_backend,
                                          reason="bounded")
        return self.aggregate_properties_replay(
            app_id, entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time, required=required)


def _apply_required(result: Dict[str, PropertyMap],
                    required: Optional[Sequence[str]]) -> Dict[str, PropertyMap]:
    if not required:
        return result
    req = list(required)
    return {k: v for k, v in result.items() if all(r in v for r in req)}


def aggregate_event_names() -> Tuple[str, str, str]:
    return ("$set", "$unset", "$delete")


class PEvents(abc.ABC):
    """Bulk event reads for training (PEvents.scala:77-181).

    Returns full in-memory lists (a training host reads whole apps); the
    data plane columnizes these into numpy batches for the device.
    """

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        target_entity_id: Any = UNSET,
    ) -> List[Event]: ...

    @abc.abstractmethod
    def write(self, events: Iterable[Event], app_id: int,
              channel_id: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def delete(self, event_ids: Iterable[str], app_id: int,
               channel_id: Optional[int] = None) -> None: ...

    def find_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Any = UNSET,
        value_property: Optional[str] = None,
        default_value: float = 1.0,
        strict: bool = True,
    ):
        """Bulk scan as a struct-of-arrays batch — the ingest format
        (see ``predictionio_tpu_torch.data.columnar``). Default implementation
        materializes Events then columnizes; backends override with a
        native scan that never builds per-row Python objects."""
        from predictionio_tpu_torch.data.columnar import events_to_columnar

        return events_to_columnar(
            self.find(app_id=app_id, channel_id=channel_id,
                      start_time=start_time, until_time=until_time,
                      entity_type=entity_type, event_names=event_names,
                      target_entity_type=target_entity_type),
            value_property=value_property, default_value=default_value,
            strict=strict)

    def find_columnar_blocks(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
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
        """Streaming bulk scan: yields :class:`ColumnarEvents` blocks of at
        most ``block_size`` rows, in STORAGE order (not time order) — the
        scale-ingest contract (the reference partitions bulk reads the same
        way: per time range ``JDBCPEvents.scala:31-100``, per HBase region
        ``HBPEvents.scala:83-89``). Backends override so a block's memory
        is bounded; this default slices one materialized scan and only
        bounds what downstream consumers hold.

        ``prefetch`` is a read-ahead HINT (how many storage units the
        backend may read/decode ahead of the consumer, trading memory
        for decode parallelism); backends without a natural unit ignore
        it — block order and content never change."""
        batch = self.find_columnar(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
            value_property=value_property, default_value=default_value,
            strict=strict)
        for i in range(0, len(batch), block_size):
            yield batch.take(slice(i, i + block_size))

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> Dict[str, PropertyMap]:
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=list(aggregate_event_names()),
        )
        return _apply_required(aggregate_properties(events), required)


class LEventsBackedPEvents(PEvents):
    """Default PEvents over any LEvents backend (single-host data plane)."""

    def __init__(self, levents: LEvents):
        self._l = levents

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=UNSET, target_entity_id=UNSET) -> List[Event]:
        return list(self._l.find(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id))

    def write(self, events, app_id, channel_id=None) -> None:
        self._l.insert_batch(events, app_id, channel_id)

    def delete(self, event_ids, app_id, channel_id=None) -> None:
        for eid in event_ids:
            self._l.delete(eid, app_id, channel_id)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None) -> Dict[str, PropertyMap]:
        """Delegate to the LEvents DAO so training reads ride its
        materialized state (the base PEvents fold would replay)."""
        return self._l.aggregate_properties(
            app_id, entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time, required=required)


# ---------------------------------------------------------------------------
# Metadata records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class App:
    """Apps.scala record: id, name, description."""
    id: int
    name: str
    description: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AccessKey:
    """AccessKeys.scala record: key, appid, allowed events (empty = all)."""
    key: str
    appid: int
    events: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Channel:
    """Channels.scala record; name restricted (Channels.scala:51-54)."""
    id: int
    name: str
    appid: int

    NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(Channel.NAME_RE.match(name))


@dataclasses.dataclass(frozen=True)
class EngineInstance:
    """EngineInstances.scala:43-59 — one train run's full record."""
    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED | INTERRUPTED
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    spark_conf: Dict[str, str] = dataclasses.field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclasses.dataclass(frozen=True)
class EvaluationInstance:
    """EvaluationInstances.scala record."""
    id: str
    status: str  # INIT | EVALUATING | EVALCOMPLETED
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclasses.dataclass(frozen=True)
class Model:
    """Models.scala:30-49 — opaque model blob keyed by engine-instance id."""
    id: str
    models: bytes


def generate_access_key() -> str:
    """64 url-safe chars from 48 random bytes (AccessKeys.scala:65-70)."""
    return base64.urlsafe_b64encode(os.urandom(48)).decode("ascii")


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]: ...
    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...
    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...
    @abc.abstractmethod
    def get_all(self) -> List[App]: ...
    @abc.abstractmethod
    def update(self, app: App) -> bool: ...
    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]: ...
    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...
    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...
    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[AccessKey]: ...
    @abc.abstractmethod
    def update(self, k: AccessKey) -> bool: ...
    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, c: Channel) -> Optional[int]: ...
    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...
    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[Channel]: ...
    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...
    @abc.abstractmethod
    def get(self, iid: str) -> Optional[EngineInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...
    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str,
        engine_variant: str) -> Optional[EngineInstance]: ...
    @abc.abstractmethod
    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]: ...
    @abc.abstractmethod
    def update(self, i: EngineInstance) -> bool: ...
    @abc.abstractmethod
    def delete(self, iid: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...
    @abc.abstractmethod
    def get(self, iid: str) -> Optional[EvaluationInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...
    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]: ...
    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> bool: ...
    @abc.abstractmethod
    def delete(self, iid: str) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, m: Model) -> None: ...
    @abc.abstractmethod
    def get(self, mid: str) -> Optional[Model]: ...
    @abc.abstractmethod
    def delete(self, mid: str) -> bool: ...
