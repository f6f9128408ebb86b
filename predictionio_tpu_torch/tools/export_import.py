"""Event export/import: event store ↔ JSON-lines or columnar files.

Parity: ``tools/.../export/EventsToFile.scala:40-104`` (events of one
app/channel → file; the reference's DEFAULT format there is Parquet,
``EventsToFile.scala:35,94``, with JSON as the option) and
``tools/.../imprt/FileToEvents.scala:41-103`` (file → event store). The
Spark job becomes a host-side stream. Two formats:

- ``jsonl`` — one event JSON per line, the same wire format as the REST
  API (the interchange default here).
- ``columnar`` — the Parquet analog: a compressed ``.npz`` container of
  dictionary-encoded columns (ids/types/events as int32 codes + distinct
  label tables, times as float64, properties/tags as JSON text columns).
  Re-import rebuilds raw rows straight from the columns — zero
  per-event JSON parsing — so round-tripping a 10M-event store does not
  bottleneck on the JSON codec.

``pio import`` sniffs the format (npz files are zip archives).

The port's copy of ``predictionio_tpu/tools/export_import.py``.
"""

from __future__ import annotations

import datetime as _dt
import json
import sys
from typing import Optional

import numpy as np

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import (
    Event,
    EventValidationError,
    validate_event,
)

BATCH = 1000
COLUMNAR_FORMAT_VERSION = 1


def _resolve(app_name: Optional[str], app_id: Optional[int],
             channel: Optional[str]):
    apps = storage.get_metadata_apps()
    if app_name is not None:
        app = apps.get_by_name(app_name)
        if app is None:
            raise ValueError(f"App {app_name} does not exist.")
    elif app_id is not None:
        app = apps.get(app_id)
        if app is None:
            raise ValueError(f"App ID {app_id} does not exist.")
    else:
        raise ValueError("one of --app-name/--appid is required")
    channel_id = None
    if channel is not None:
        match = next(
            (c for c in storage.get_metadata_channels().get_by_appid(app.id)
             if c.name == channel), None)
        if match is None:
            raise ValueError(f"Channel {channel} does not exist.")
        channel_id = match.id
    return app.id, channel_id


def export_events(output: str, app_name: Optional[str] = None,
                  app_id: Optional[int] = None,
                  channel: Optional[str] = None,
                  format: str = "jsonl") -> int:
    """Dump every event of one app/channel (EventsToFile.scala:75-88);
    ``format`` picks jsonl (default) or the columnar npz container."""
    if format not in ("jsonl", "columnar"):
        raise ValueError(f"unknown export format {format!r} "
                         "(expected jsonl or columnar)")
    aid, channel_id = _resolve(app_name, app_id, channel)
    levents = storage.get_levents()
    events = levents.find(app_id=aid, channel_id=channel_id)
    if format == "columnar":
        if hasattr(levents, "iter_raw_rows"):
            # data-plane lane: stream raw rows straight into columns,
            # no Event objects, no per-event JSON round trip
            n = _export_columnar_raw(
                output, levents.iter_raw_rows(aid, channel_id))
        else:
            n = _export_columnar(output, events)
    else:
        n = 0
        with open(output, "w", encoding="utf-8") as f:
            for e in events:
                f.write(e.to_json())
                f.write("\n")
                n += 1
    print(f"[INFO] Events are exported to {output}. ({n} events)")
    return 0


def _dict_encode(values) -> tuple:
    """list of str|None -> (codes int32 with -1 = None, labels).

    Nulls are tracked OUT-OF-BAND (a boolean mask over the input), never
    as an in-band sentinel string: only genuinely non-null values reach
    the label table, so a real value equal to any would-be sentinel
    (e.g. the literal string ``"\\0N"``) round-trips intact."""
    null = np.fromiter((v is None for v in values), dtype=bool,
                       count=len(values))
    codes = np.full(len(values), -1, dtype=np.int32)
    present = [v for v in values if v is not None]
    if present:
        labels, pcodes = np.unique(np.asarray(present, dtype=np.str_),
                                   return_inverse=True)
        codes[~null] = pcodes.astype(np.int32)
    else:
        labels = np.empty(0, dtype=np.str_)
    return codes, labels


def _dict_decode(codes: np.ndarray, labels: np.ndarray) -> list:
    if labels.size == 0:  # every value was None
        return [None] * len(codes)
    out = labels[np.maximum(codes, 0)]
    return [None if c < 0 else v for c, v in zip(codes, out.tolist())]


def _export_columnar(output: str, events) -> int:
    cols: dict = {k: [] for k in
                  ("event_ids", "events", "entity_types", "entity_ids",
                   "target_entity_types", "target_entity_ids",
                   "properties", "tags", "pr_ids")}
    event_times, creation_times = [], []
    for e in events:
        cols["event_ids"].append(e.event_id or "")
        cols["events"].append(e.event)
        cols["entity_types"].append(e.entity_type)
        cols["entity_ids"].append(e.entity_id)
        cols["target_entity_types"].append(e.target_entity_type)
        cols["target_entity_ids"].append(e.target_entity_id)
        cols["properties"].append(
            json.dumps(e.properties.fields, sort_keys=True,
                       separators=(",", ":"))
            if e.properties.fields else "")
        cols["tags"].append(json.dumps(list(e.tags)) if e.tags else "")
        cols["pr_ids"].append(e.pr_id)
        event_times.append(e.event_time.timestamp())
        creation_times.append(e.creation_time.timestamp()
                              if e.creation_time else np.nan)
    n = len(cols["events"])
    arrays: dict = {
        "format_version": np.int64(COLUMNAR_FORMAT_VERSION),
        "n_events": np.int64(n),
        "event_ids": np.asarray(cols["event_ids"], dtype=np.str_),
        "event_times": np.asarray(event_times, dtype=np.float64),
        "creation_times": np.asarray(creation_times, dtype=np.float64),
        "properties": np.asarray(cols["properties"], dtype=np.str_),
        "tags": np.asarray(cols["tags"], dtype=np.str_),
    }
    for name in ("events", "entity_types", "entity_ids",
                 "target_entity_types", "target_entity_ids", "pr_ids"):
        codes, labels = _dict_encode(cols[name])
        arrays[f"{name}_codes"] = codes
        arrays[f"{name}_labels"] = labels
    with open(output, "wb") as f:
        np.savez_compressed(f, **arrays)
    return n


def _export_columnar_raw(output: str, raw_rows) -> int:
    """Columnar export from ``iter_raw_rows`` tuples (the
    ``insert_raw_batch`` shape) — zero Event construction."""
    rows = list(raw_rows)
    n = len(rows)

    def col(i):
        return [r[i] for r in rows]

    arrays: dict = {
        "format_version": np.int64(COLUMNAR_FORMAT_VERSION),
        "n_events": np.int64(n),
        "event_ids": np.asarray([r[0] or "" for r in rows],
                                dtype=np.str_),
        "event_times": np.asarray([float(r[7]) for r in rows],
                                  dtype=np.float64),
        "creation_times": np.asarray(
            [float(r[10]) if r[10] is not None else np.nan
             for r in rows], dtype=np.float64),
        "properties": np.asarray(
            [("" if (r[6] is None or r[6] == "{}") else r[6])
             for r in rows], dtype=np.str_),
        "tags": np.asarray(
            [("" if (r[8] is None or r[8] == "[]") else r[8])
             for r in rows], dtype=np.str_),
    }
    for name, i in (("events", 1), ("entity_types", 2),
                    ("entity_ids", 3), ("target_entity_types", 4),
                    ("target_entity_ids", 5), ("pr_ids", 9)):
        codes, labels = _dict_encode(col(i))
        arrays[f"{name}_codes"] = codes
        arrays[f"{name}_labels"] = labels
    with open(output, "wb") as f:
        np.savez_compressed(f, **arrays)
    return n


def is_columnar_export(path: str) -> bool:
    """npz containers are zip archives — sniff the magic."""
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def _import_columnar(input_path: str, levents, aid: int,
                     channel_id: Optional[int]) -> int:
    """Rebuild events from the columnar container — no per-event JSON
    parsing. Backends with the raw-row fast lane take tuples directly;
    others get typed Events (validation still applies either way: the
    exporter only writes store-validated events, but a hand-built file
    must not bypass the rules)."""
    import os as _os

    try:
        z = np.load(input_path, allow_pickle=False)
        ver = int(z["format_version"])
        if ver != COLUMNAR_FORMAT_VERSION:
            print(f"[ERROR] unsupported columnar export version {ver}",
                  file=sys.stderr)
            return 1
        n = int(z["n_events"])
        dec = {name: _dict_decode(z[f"{name}_codes"],
                                  z[f"{name}_labels"])
               for name in ("events", "entity_types", "entity_ids",
                            "target_entity_types", "target_entity_ids",
                            "pr_ids")}
        event_ids = z["event_ids"].tolist()
        props = z["properties"].tolist()
        tags = z["tags"].tolist()
        ets = z["event_times"]
        cts = z["creation_times"]
        if not all(len(c) == n for c in
                   (event_ids, props, tags, ets, cts,
                    *dec.values())):
            raise ValueError("column lengths disagree with n_events")
    except Exception as e:
        # any malformed container (zip-but-not-npz, missing arrays,
        # short columns) follows the import error contract
        print(f"[ERROR] {input_path}: not a readable columnar event "
              f"export ({e}) (nothing imported)", file=sys.stderr)
        return 1
    now_ts = _dt.datetime.now(tz=_dt.timezone.utc).timestamp()

    # validate without building Event objects (same rules as
    # validate_event; field-level, vectorized where possible)
    from predictionio_tpu_torch.data.event import (
        BUILTIN_ENTITY_TYPES, is_reserved_prefix, is_special_event,
    )

    def err(i: int, msg: str) -> int:
        print(f"[ERROR] {input_path}[{i}]: {msg} (nothing imported)",
              file=sys.stderr)
        return 1

    for i in range(n):
        ev, etype, eid = dec["events"][i], dec["entity_types"][i], \
            dec["entity_ids"][i]
        tet, tei = dec["target_entity_types"][i], \
            dec["target_entity_ids"][i]
        if not ev:
            return err(i, "event must not be empty.")
        if not etype:
            return err(i, "entityType must not be empty string.")
        if not eid:
            return err(i, "entityId must not be empty string.")
        if tet == "":
            return err(i, "targetEntityType must not be empty string")
        if tei == "":
            return err(i, "targetEntityId must not be empty string.")
        if (tet is None) != (tei is None):
            return err(i, "targetEntityType and targetEntityId must be "
                          "specified together.")
        if ev == "$unset" and (not props[i] or props[i] == "{}"):
            return err(i, "properties cannot be empty for $unset event")
        if is_reserved_prefix(ev) and not is_special_event(ev):
            return err(i, f"{ev} is not a supported reserved event name.")
        if is_special_event(ev) and tet is not None:
            return err(i, f"Reserved event {ev} cannot have targetEntity")
        if is_reserved_prefix(etype) \
                and etype not in BUILTIN_ENTITY_TYPES:
            return err(i, f"The entityType {etype} is not allowed. "
                          "'pio_' is a reserved name prefix.")
        if tet is not None and is_reserved_prefix(tet) \
                and tet not in BUILTIN_ENTITY_TYPES:
            return err(i, f"The targetEntityType {tet} is not allowed. "
                          "'pio_' is a reserved name prefix.")
        if not np.isfinite(ets[i]):
            return err(i, "eventTime is not a finite timestamp.")
        # the raw lane writes these strings VERBATIM into the store —
        # malformed JSON would poison every later read of the app
        if props[i]:
            try:
                pf = json.loads(props[i])
                if not isinstance(pf, dict):
                    raise ValueError("properties must be a JSON object")
            except ValueError as e:
                return err(i, f"bad properties JSON: {e}")
            for key in pf:
                if is_reserved_prefix(key):
                    return err(i, f"The property {key} is not allowed. "
                                  "'pio_' is a reserved name prefix.")
        if tags[i]:
            try:
                tg = json.loads(tags[i])
                if not isinstance(tg, list):
                    raise ValueError("tags must be a JSON array")
            except ValueError as e:
                return err(i, f"bad tags JSON: {e}")

    levents.init(aid, channel_id)
    id_hex = _os.urandom(16 * max(n, 1)).hex()
    if hasattr(levents, "insert_raw_batch"):
        rows = [
            (event_ids[i] or id_hex[i * 32:i * 32 + 32],
             dec["events"][i], dec["entity_types"][i],
             dec["entity_ids"][i], dec["target_entity_types"][i],
             dec["target_entity_ids"][i], props[i] or "{}",
             float(ets[i]), tags[i] or "[]", dec["pr_ids"][i],
             float(cts[i]) if np.isfinite(cts[i]) else now_ts)
            for i in range(n)
        ]
        for i in range(0, len(rows), 20000):
            levents.insert_raw_batch(rows[i:i + 20000], aid, channel_id)
    else:
        utc = _dt.timezone.utc
        events = [
            Event(
                event=dec["events"][i],
                entity_type=dec["entity_types"][i],
                entity_id=dec["entity_ids"][i],
                target_entity_type=dec["target_entity_types"][i],
                target_entity_id=dec["target_entity_ids"][i],
                properties=json.loads(props[i]) if props[i] else {},
                event_time=_dt.datetime.fromtimestamp(float(ets[i]), utc),
                tags=tuple(json.loads(tags[i])) if tags[i] else (),
                pr_id=dec["pr_ids"][i],
                creation_time=_dt.datetime.fromtimestamp(
                    float(cts[i]), utc) if np.isfinite(cts[i]) else None,
                event_id=event_ids[i] or id_hex[i * 32:i * 32 + 32],
            )
            for i in range(n)
        ]
        for i in range(0, len(events), BATCH):
            levents.insert_batch(events[i:i + BATCH], aid, channel_id)
    print(f"[INFO] Events are imported. ({n} events)")
    return 0


def import_events(input_path: str, app_name: Optional[str] = None,
                  app_id: Optional[int] = None,
                  channel: Optional[str] = None) -> int:
    """Load a JSON-lines event file into the store
    (FileToEvents.scala:85-103).

    Uses the native C++ codec when available and the target backend
    exposes the raw-row fast lane; otherwise the pure-python path. Both
    parse + validate the WHOLE file before touching the store, so a bad
    line aborts with nothing inserted (no silent partial import).
    """
    aid, channel_id = _resolve(app_name, app_id, channel)
    levents = storage.get_levents()
    if is_columnar_export(input_path):
        return _import_columnar(input_path, levents, aid, channel_id)
    if hasattr(levents, "insert_raw_batch"):
        rc = _import_native(input_path, levents, aid, channel_id)
        if rc is not None:
            return rc
    # pure-python path (memory backend, native lib unavailable, ...)
    events = []
    with open(input_path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = Event.from_json(line)
                validate_event(event)
            except EventValidationError as e:
                print(f"[ERROR] {input_path}:{lineno}: {e} "
                      "(nothing imported)", file=sys.stderr)
                return 1
            events.append(event)
    levents.init(aid, channel_id)
    n = 0
    for i in range(0, len(events), BATCH):
        chunk = events[i:i + BATCH]
        levents.insert_batch(chunk, aid, channel_id)
        n += len(chunk)
    print(f"[INFO] Events are imported. ({n} events)")
    return 0


def _import_native(input_path: str, levents, aid: int,
                   channel_id: Optional[int]) -> Optional[int]:
    """Native-codec import: C++ parses/decodes the file in one pass; rows
    it could not express 1:1 with python semantics are re-parsed here with
    the Event oracle. Returns None if the native lib is unavailable
    (caller falls through to the python path)."""
    import math

    import os as _os

    from predictionio_tpu_torch.data.event import (
        BUILTIN_ENTITY_TYPES, _parse_time, is_reserved_prefix,
        is_special_event,
    )
    from predictionio_tpu_torch.native import codec

    with open(input_path, "rb") as f:
        data = f.read()
    parsed = codec.parse_jsonl(data)
    if parsed is None:
        return None

    now_ts = _dt.datetime.now(tz=_dt.timezone.utc).timestamp()
    rows = []
    fallback_events = []
    # batched event-id generation (same entropy as new_event_id's uuid4,
    # ~10x cheaper at bulk scale)
    id_hex = _os.urandom(16 * len(parsed)).hex()

    def err(i: int, msg: str) -> int:
        print(f"[ERROR] {input_path}:{int(parsed.lineno[i])}: {msg} "
              "(nothing imported)", file=sys.stderr)
        return 1

    for i in range(len(parsed)):
        flags = int(parsed.flags[i])
        if flags & codec.FALLBACK:
            raw = data[parsed.line_start[i]:parsed.line_end[i]] \
                .decode("utf-8", errors="replace").strip()
            try:
                event = Event.from_json(raw)
                validate_event(event)
            except EventValidationError as e:
                return err(i, str(e))
            fallback_events.append(event)
            continue
        ev = parsed.event[i]
        etype = parsed.entity_type[i]
        eid = parsed.entity_id[i]
        tet = parsed.target_entity_type[i]
        tei = parsed.target_entity_id[i]
        # validation 1:1 with validate_event (data/event.py:163-208)
        if not ev:
            return err(i, "event must not be empty.")
        if not etype:
            return err(i, "entityType must not be empty string.")
        if not eid:
            return err(i, "entityId must not be empty string.")
        if tet == "":
            return err(i, "targetEntityType must not be empty string")
        if tei == "":
            return err(i, "targetEntityId must not be empty string.")
        if (tet is None) != (tei is None):
            return err(i, "targetEntityType and targetEntityId must be "
                          "specified together.")
        # PROPS_EMPTY is set by the codec only when a properties key was
        # present; a fully absent properties field is equally empty
        if ev == "$unset" and (flags & codec.PROPS_EMPTY
                               or parsed.properties_json[i] is None):
            return err(i, "properties cannot be empty for $unset event")
        if is_reserved_prefix(ev) and not is_special_event(ev):
            return err(i, f"{ev} is not a supported reserved event name.")
        if is_special_event(ev) and tet is not None:
            return err(i, f"Reserved event {ev} cannot have targetEntity")
        if is_reserved_prefix(etype) and etype not in BUILTIN_ENTITY_TYPES:
            return err(i, f"The entityType {etype} is not allowed. "
                          "'pio_' is a reserved name prefix.")
        if tet is not None and is_reserved_prefix(tet) \
                and tet not in BUILTIN_ENTITY_TYPES:
            return err(i, f"The targetEntityType {tet} is not allowed. "
                          "'pio_' is a reserved name prefix.")
        if flags & codec.BAD_PROP_KEY:
            return err(i, f"The property {parsed.bad_prop_key[i]} is not "
                          "allowed. 'pio_' is a reserved name prefix.")
        et = parsed.event_time[i]
        if math.isnan(et):
            raw_t = parsed.event_time_raw[i]
            if raw_t is None:
                et = now_ts
            else:
                try:
                    et = _parse_time(raw_t).timestamp()
                except EventValidationError as e:
                    return err(i, str(e))
        ct = parsed.creation_time[i]
        if math.isnan(ct):
            raw_t = parsed.creation_time_raw[i]
            if raw_t is None:
                ct = now_ts
            else:
                try:
                    ct = _parse_time(raw_t).timestamp()
                except EventValidationError as e:
                    return err(i, str(e))
        rows.append((parsed.event_id[i] or id_hex[i * 32:i * 32 + 32],
                     ev, etype, eid, tet, tei,
                     parsed.properties_json[i] or "{}", et,
                     parsed.tags_json[i] or "[]", parsed.pr_id[i], ct))

    levents.init(aid, channel_id)
    for i in range(0, len(rows), 20000):
        levents.insert_raw_batch(rows[i:i + 20000], aid, channel_id)
    for i in range(0, len(fallback_events), BATCH):
        levents.insert_batch(fallback_events[i:i + BATCH], aid, channel_id)
    n = len(rows) + len(fallback_events)
    print(f"[INFO] Events are imported. ({n} events)")
    return 0


def dispatch_export(args) -> int:
    try:
        return export_events(args.output, app_name=args.app_name,
                             app_id=args.appid, channel=args.channel,
                             format=getattr(args, "format", "jsonl"))
    except ValueError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1


def dispatch_import(args) -> int:
    try:
        return import_events(args.input, app_name=args.app_name,
                             app_id=args.appid, channel=args.channel)
    except ValueError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
