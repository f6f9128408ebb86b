"""Property bags attached to events and entities.

Parity target: reference ``data/src/main/scala/io/prediction/data/storage/
DataMap.scala`` (JSON-backed ``DataMap`` with typed ``get``/``getOpt``/
``++``/``--``), ``PropertyMap.scala`` (adds first/lastUpdated timestamps) and
``EntityMap.scala`` (adds entity-ID remapping for matrix indexing).

Design: instead of wrapping a json4s AST we wrap plain Python values
(anything ``json``-serializable). Typed access is by example type, with
conversion errors raised as ``DataMapError``.

The port's copy of ``predictionio_tpu/data/datamap.py``,
unchanged but for its imports.
"""

from __future__ import annotations

import datetime as _dt
import json
import typing as _t
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence


class DataMapError(KeyError):
    """Missing field or wrong type in a DataMap (cf. DataMapException)."""


def _convert(value: Any, typ: Optional[type]) -> Any:
    if typ is None or typ is object:
        return value
    if typ is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise DataMapError(f"cannot convert {value!r} to float")
        return float(value)
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            if isinstance(value, float) and value.is_integer():
                return int(value)
            raise DataMapError(f"cannot convert {value!r} to int")
        return int(value)
    if typ is bool:
        if not isinstance(value, bool):
            raise DataMapError(f"cannot convert {value!r} to bool")
        return value
    if typ is str:
        if not isinstance(value, str):
            raise DataMapError(f"cannot convert {value!r} to str")
        return value
    if typ is list:
        if not isinstance(value, (list, tuple)):
            raise DataMapError(f"cannot convert {value!r} to list")
        return list(value)
    if typ is _dt.datetime:
        if isinstance(value, _dt.datetime):
            return value
        if isinstance(value, str):
            from predictionio_tpu_torch.utils.compat import parse_iso8601

            try:
                return parse_iso8601(value)
            except ValueError as e:
                raise DataMapError(
                    f"cannot convert {value!r} to datetime") from e
        raise DataMapError(f"cannot convert {value!r} to datetime")
    if isinstance(value, typ):
        return value
    raise DataMapError(f"cannot convert {value!r} to {typ}")


class DataMap(Mapping[str, Any]):
    """Immutable string-keyed property bag.

    Mirrors reference ``DataMap`` behavior: ``get`` raises on a missing
    field, ``get_opt`` returns None, ``++``/``--`` become ``merged``/
    ``without`` (and the ``|`` / ``-`` operators).
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: Dict[str, Any] = dict(fields or {})

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    # -- typed access -----------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    _NO_TYP = object()

    def get(self, name: str, typ: Any = _NO_TYP, default: Any = ...) -> Any:
        """Typed get; raises DataMapError when missing unless a default is given.

        Also honors ``Mapping.get``-style calls: a non-type second positional
        argument (including None) is treated as the default — ``dm.get('k', 0)``
        returns 0 when 'k' is absent. One deliberate divergence from Mapping:
        a field explicitly present with value None counts as ABSENT (returns
        the default) — parity with the reference, where json4s JNull extracts
        as missing (DataMap.scala get/getOpt).
        """
        if typ is DataMap._NO_TYP:
            typ = None
        elif not isinstance(typ, type) and typ is not None:
            # typing generics (Optional[int], List[str], ...) look like
            # defaults to isinstance — reject loudly instead of silently
            # disabling validation.
            if (getattr(typ, "__module__", None) == "typing"
                    or _t.get_origin(typ) is not None):
                raise TypeError(
                    f"get() does not support typing generics, got {typ!r}; "
                    f"use a concrete type (int, float, str, list, ...)")
            if default is not ...:
                raise TypeError(f"get() type argument must be a type, "
                                f"got {typ!r}")
            typ, default = None, typ
        elif typ is None and default is ...:
            default = None  # Mapping.get(key, None)
        if name not in self._fields or self._fields[name] is None:
            if default is not ...:
                return default
            raise DataMapError(f"The field {name} is required.")
        return _convert(self._fields[name], typ)

    def get_opt(self, name: str, typ: Optional[type] = None) -> Optional[Any]:
        if name not in self._fields or self._fields[name] is None:
            return None
        return _convert(self._fields[name], typ)

    def get_list(self, name: str) -> list:
        return self.get(name, list)

    @property
    def fields(self) -> Dict[str, Any]:
        return dict(self._fields)

    def keySet(self) -> set:  # reference-API spelling, kept for parity
        return set(self._fields)

    @property
    def is_empty(self) -> bool:
        return not self._fields

    # -- combination (DataMap.scala ++ / --) ------------------------------
    def merged(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        out = dict(self._fields)
        out.update(dict(other))
        return DataMap(out)

    def without(self, keys: Sequence[str]) -> "DataMap":
        out = {k: v for k, v in self._fields.items() if k not in set(keys)}
        return DataMap(out)

    __or__ = merged
    __sub__ = without

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        # allow_nan=False: NaN/Infinity are not JSON; letting them through
        # would poison every downstream JSON consumer (sqlite json_extract
        # aborts whole scans on a single malformed row)
        try:
            return json.dumps(self._fields, sort_keys=True,
                              default=_json_default, allow_nan=False)
        except ValueError as e:
            raise DataMapError(
                f"properties contain a non-JSON number (NaN/Infinity): {e}"
            ) from e

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        return cls(json.loads(s))

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:  # pragma: no cover - rarely used
        return hash(self.to_json())

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


def _json_default(o: Any) -> Any:
    if isinstance(o, _dt.datetime):
        return o.isoformat()
    raise TypeError(f"not JSON serializable: {o!r}")


class PropertyMap(DataMap):
    """DataMap plus first/last updated times (cf. PropertyMap.scala)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]] = None,
        first_updated: Optional[_dt.datetime] = None,
        last_updated: Optional[_dt.datetime] = None,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self._fields == other._fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first_updated={self.first_updated!r}, "
            f"last_updated={self.last_updated!r})"
        )


class EntityMap:
    """Map of entityId -> value plus a stable integer index per entity.

    Parity: reference ``EntityMap.scala`` — used to remap string entity IDs
    onto dense matrix rows. The index ordering is insertion order of the
    supplied mapping (deterministic).
    """

    def __init__(self, data: Mapping[str, Any]):
        self._data = dict(data)
        self._ids = {eid: i for i, eid in enumerate(self._data)}
        self._rev = {i: eid for eid, i in self._ids.items()}

    def __getitem__(self, entity_id: str) -> Any:
        return self._data[entity_id]

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._data

    def entity_ids(self) -> list:
        return list(self._data)

    def index_of(self, entity_id: str) -> int:
        return self._ids[entity_id]

    def entity_of(self, index: int) -> str:
        return self._rev[index]
