"""Canonical event model + validation.

Parity target: reference ``data/src/main/scala/io/prediction/data/storage/
Event.scala`` — same 11 fields, same validation rules (Event.scala:109-177):

- event / entityType / entityId must be non-empty
- targetEntityType and targetEntityId: both present or both absent, non-empty
- ``$unset`` must carry non-empty properties
- a reserved-prefix event name (``$`` or ``pio_``) must be one of the special
  events ``$set/$unset/$delete``
- special events cannot have a target entity
- reserved-prefix entity types only if built-in (``pio_pr``)
- property names must not use the reserved ``pio_``/``$`` prefix

The port's copy of ``predictionio_tpu/data/event.py``,
unchanged but for its imports.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import uuid
from typing import Any, Mapping, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.utils.compat import parse_iso8601

UTC = _dt.timezone.utc

SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
BUILTIN_PROPERTIES: frozenset = frozenset()


class EventValidationError(ValueError):
    """Raised when an Event violates the validation rules."""


def _now() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


@dataclasses.dataclass(frozen=True)
class Event:
    """One immutable event (cf. Event.scala:39-57).

    ``properties`` accepts any mapping and is normalized to a DataMap.
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = dataclasses.field(default_factory=DataMap)
    event_time: _dt.datetime = dataclasses.field(default_factory=_now)
    tags: Tuple[str, ...] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = dataclasses.field(default_factory=_now)
    event_id: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        for attr in ("event_time", "creation_time"):
            t = getattr(self, attr)
            if t.tzinfo is None:
                object.__setattr__(self, attr, t.replace(tzinfo=UTC))

    def with_id(self, event_id: str) -> "Event":
        return dataclasses.replace(self, event_id=event_id)

    # -- wire format (EventJson4sSupport.APISerializer parity) -------------
    def to_dict(self) -> dict:
        d: dict = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.fields,
            "eventTime": _fmt_time(self.event_time),
            "creationTime": _fmt_time(self.creation_time),
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Event":
        if "event" not in d:
            raise EventValidationError("field 'event' is required")
        if "entityType" not in d:
            raise EventValidationError("field 'entityType' is required")
        if "entityId" not in d:
            raise EventValidationError("field 'entityId' is required")
        now = _now()
        ev = cls(
            event=str(d["event"]),
            entity_type=str(d["entityType"]),
            entity_id=str(d["entityId"]),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(d.get("properties") or {}),
            event_time=_parse_time(d.get("eventTime")) or now,
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            creation_time=_parse_time(d.get("creationTime")) or now,
            event_id=d.get("eventId"),
        )
        return ev

    @classmethod
    def from_json(cls, s: str) -> "Event":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise EventValidationError(f"invalid JSON: {e}") from e
        if not isinstance(d, dict):
            raise EventValidationError("event JSON must be an object")
        return cls.from_dict(d)


def _fmt_time(t: _dt.datetime) -> str:
    return t.astimezone(UTC).isoformat()


def _parse_time(v: Any) -> Optional[_dt.datetime]:
    if v is None:
        return None
    if isinstance(v, _dt.datetime):
        return v if v.tzinfo else v.replace(tzinfo=UTC)
    if isinstance(v, (int, float)):
        return _dt.datetime.fromtimestamp(v / 1000.0, tz=UTC)
    try:
        t = parse_iso8601(str(v))
    except ValueError as e:
        raise EventValidationError(f"invalid time: {v!r}") from e
    return t if t.tzinfo else t.replace(tzinfo=UTC)


def is_reserved_prefix(name: str) -> bool:
    """Event.scala:74-75 — names starting with ``$`` or ``pio_`` are reserved."""
    return name.startswith("$") or name.startswith("pio_")


def is_special_event(name: str) -> bool:
    return name in SPECIAL_EVENTS


def validate_event(e: Event) -> None:
    """Validation rules, 1:1 with EventValidation.validate (Event.scala:109-138)."""
    def req(cond: bool, msg: str) -> None:
        if not cond:
            raise EventValidationError(msg)

    req(bool(e.event), "event must not be empty.")
    req(bool(e.entity_type), "entityType must not be empty string.")
    req(bool(e.entity_id), "entityId must not be empty string.")
    req(e.target_entity_type != "", "targetEntityType must not be empty string")
    req(e.target_entity_id != "", "targetEntityId must not be empty string.")
    req(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    req(
        not (e.event == "$unset" and e.properties.is_empty),
        "properties cannot be empty for $unset event",
    )
    req(
        not is_reserved_prefix(e.event) or is_special_event(e.event),
        f"{e.event} is not a supported reserved event name.",
    )
    req(
        not is_special_event(e.event)
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    req(
        not is_reserved_prefix(e.entity_type)
        or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    if e.target_entity_type is not None:
        req(
            not is_reserved_prefix(e.target_entity_type)
            or e.target_entity_type in BUILTIN_ENTITY_TYPES,
            f"The targetEntityType {e.target_entity_type} is not allowed. "
            "'pio_' is a reserved name prefix.",
        )
    for k in e.properties.keySet():
        req(
            not is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )
    _req_json_numbers(e.properties.fields)


def _req_json_numbers(v: Any) -> None:
    """NaN/Infinity are not JSON; json.loads accepts them as an extension
    but letting them into the store would fail at serialization time (and
    poison sqlite json_extract scans) — reject at validation instead so
    the API returns 400, not a 500 deep in the insert path."""
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            raise EventValidationError(
                f"property values must be JSON numbers; got {v!r}")
    elif isinstance(v, dict):
        for x in v.values():
            _req_json_numbers(x)
    elif isinstance(v, (list, tuple)):
        for x in v:
            _req_json_numbers(x)


def new_event_id() -> str:
    """Opaque unique event ID (replaces HBase rowkey uuid-low, HBEventsUtil.scala:81-129)."""
    return uuid.uuid4().hex
