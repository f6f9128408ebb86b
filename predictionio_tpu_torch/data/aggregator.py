"""Fold ``$set/$unset/$delete`` events into current entity property state.

Parity target: reference ``LEventAggregator.scala:39-132`` /
``PEventAggregator.scala``. Semantics (dataMapAggregator, :91-112):

- ``$set``    : merge event properties over current state (event wins)
- ``$unset``  : remove the event's property keys from current state;
                a ``$unset`` before any ``$set`` leaves state nonexistent
- ``$delete`` : reset state to nonexistent
- other events: ignored entirely (do not touch first/lastUpdated)

Events are folded in ``event_time`` order; first/lastUpdated track the
min/max event time over the special events seen.

The fold is exposed at three grains so storage backends can keep the
aggregate MATERIALIZED instead of replaying full histories:

- :func:`fold_event` — the single-event step ``(state, event) -> state``
  used by write-through backends (fold at insert time);
- :func:`aggregate_properties_single` / :func:`aggregate_properties` —
  the replay fold over a (sorted) event stream, unchanged semantics;
- :class:`EntityState` — the per-entity accumulator, JSON-serializable
  (``to_record``/``from_record``) for snapshot/table persistence.

Incremental correctness contract: folding an event whose
``event_time >= state.last_updated`` is exactly equivalent to inserting
it into the replay (stable sort puts later arrivals after earlier ones
on ties). An event OLDER than ``state.last_updated`` is out-of-order —
the caller must re-fold that entity's history instead.

The port's copy of ``predictionio_tpu/data/aggregator.py``,
unchanged but for its imports.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Dict, Iterable, Optional

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event

AGGREGATOR_EVENT_NAMES = ("$set", "$unset", "$delete")


@dataclasses.dataclass(frozen=True)
class EntityState:
    """Accumulated property state of ONE entity after folding its
    special events in time order.

    ``fields is None`` is a TOMBSTONE: the entity's state is currently
    nonexistent (``$delete``d, or only ``$unset`` seen) but its
    first/last updated times keep tracking every special event — a later
    ``$set`` must resurrect the entity with the original
    ``first_updated`` (LEventAggregatorSpec: set-after-delete).
    """

    fields: Optional[Dict] = None
    first_updated: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None

    @property
    def exists(self) -> bool:
        return self.fields is not None

    def to_property_map(self) -> Optional[PropertyMap]:
        if self.fields is None:
            return None
        return PropertyMap(self.fields, first_updated=self.first_updated,
                           last_updated=self.last_updated)

    # -- persistence (sqlite entity_props table / jsonlfs snapshot) -------
    def to_record(self) -> list:
        """JSON-friendly ``[fields_or_null, first_epoch, last_epoch]``."""
        return [self.fields,
                None if self.first_updated is None
                else self.first_updated.timestamp(),
                None if self.last_updated is None
                else self.last_updated.timestamp()]

    @classmethod
    def from_record(cls, rec) -> "EntityState":
        def ts(x):
            return None if x is None else _dt.datetime.fromtimestamp(
                x, tz=_dt.timezone.utc)

        return cls(fields=rec[0] if rec[0] is None else dict(rec[0]),
                   first_updated=ts(rec[1]), last_updated=ts(rec[2]))


def fold_event(state: Optional[EntityState],
               event: Event) -> Optional[EntityState]:
    """One fold step: apply ``event`` to ``state`` and return the new
    state (the input is never mutated). Non-special events return the
    state unchanged. Callers must apply events in event-time order with
    ties in arrival order — see the module docstring's incremental
    contract for what that buys write-through backends."""
    name = event.event
    if name not in AGGREGATOR_EVENT_NAMES:
        return state
    fields = None if state is None else state.fields
    if name == "$set":
        merged = dict(fields) if fields else {}
        merged.update(event.properties.fields)
        fields = merged
    elif name == "$unset":
        if fields is not None:
            drop = event.properties.keySet()
            fields = {k: v for k, v in fields.items() if k not in drop}
    else:  # $delete
        fields = None
    t = event.event_time
    first = t if state is None or state.first_updated is None \
        or t < state.first_updated else state.first_updated
    last = t if state is None or state.last_updated is None \
        or t > state.last_updated else state.last_updated
    return EntityState(fields=fields, first_updated=first, last_updated=last)


def fold_events(events: Iterable[Event],
                state: Optional[EntityState] = None) -> Optional[EntityState]:
    """Fold one entity's events (sorted by event_time, stable over input
    order) into ``state``. The replay building block: with ``state=None``
    this IS the reference fold; with a snapshot state it folds a delta."""
    for e in sorted(events, key=lambda ev: ev.event_time):
        state = fold_event(state, e)
    return state


def _fold(events: Iterable[Event]) -> Optional[PropertyMap]:
    state = fold_events(events)
    return None if state is None else state.to_property_map()


def aggregate_properties_single(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Aggregate one entity's events (LEventAggregator.scala:69-87)."""
    return _fold(events)


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Group by entityId then fold; entities whose state resolved to

    nonexistent (deleted / never set) are dropped (LEventAggregator.scala:39-57).
    """
    by_entity: Dict[str, list] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: Dict[str, PropertyMap] = {}
    for eid, evs in by_entity.items():
        pm = _fold(evs)
        if pm is not None:
            out[eid] = pm
    return out


def aggregate_states(events: Iterable[Event]) -> Dict[str, EntityState]:
    """Like :func:`aggregate_properties` but KEEPS tombstones — the shape
    materialized state tables persist (a tombstone must survive so a
    re-``$set`` after ``$delete`` retains ``first_updated``)."""
    by_entity: Dict[str, list] = {}
    for e in events:
        by_entity.setdefault(e.entity_id, []).append(e)
    out: Dict[str, EntityState] = {}
    for eid, evs in by_entity.items():
        st = fold_events(evs)
        if st is not None:
            out[eid] = st
    return out


def states_to_property_maps(
        states: Dict[str, EntityState]) -> Dict[str, PropertyMap]:
    """Materialized states -> the aggregate_properties result shape
    (tombstones dropped)."""
    out: Dict[str, PropertyMap] = {}
    for eid, st in states.items():
        pm = st.to_property_map()
        if pm is not None:
            out[eid] = pm
    return out
