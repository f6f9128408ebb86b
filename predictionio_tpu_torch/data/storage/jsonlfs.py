"""Partitioned JSON-lines event store — the scale-ingest backend.

Reference analog: the reference's bulk training reads are partitioned at
the storage layer — per time range on JDBC (``JDBCPEvents.scala:31-100``,
partition count = min(days, PARTITIONS)) and per region on HBase
(``HBPEvents.scala:83-89``) — so a 20M-event scan streams through
executors without ever being one object list. This backend is the
TPU-host equivalent: events live in append-only JSONL partition files
(rolled every ``part_max_events``), the native C++ codec decodes a whole
partition per call (including the numeric value column, so training
ingest builds zero per-event Python objects), and
``find_columnar_blocks`` streams one bounded columnar block per
partition straight into the padding pipeline.

Layout: ``<path>/app_<appid>_<channel>/part-<n>.jsonl`` with one event
JSON per line (the same wire format as export/import and the REST API —
``EventJson4sSupport.APISerializer`` parity via ``Event.to_json``).

Contracts:
- ``find``/``get``/``delete`` are the compatibility surface (admin and
  LEventStore paths): they parse typed Events and are O(store); the hot
  path is ``find_columnar_blocks``.
- ``delete`` rewrites the partition containing the event (append-only
  otherwise).
- Only the event DAOs exist — configure this source for EVENTDATA and
  keep METADATA/MODELDATA on sqlite/memory (the registry raises a clear
  error otherwise, mirroring ``Storage.scala``'s per-repository sources).

The port's copy of ``predictionio_tpu/data/storage/jsonlfs.py``: the
same files, line format and ``props_snapshot.json``, so a directory
written by either package reads back equal in the other, with the same
aggregation counters (scope drops and backfills). One difference in
cost, none in result: the snapshot's delta scan looks for the
special-event prefilter's needles in the raw bytes and decodes only
the lines that hold one, instead of decoding every appended line first (a
MovieLens-20M store is 3.5 GB of ``rate`` lines, none of which the fold
reads). The native codec has no silent fallback: without
``PIO_NATIVE_DISABLE=1`` a codec that does not build raises.
"""

from __future__ import annotations

import contextlib
import fcntl
import glob
import json
import logging
import mmap
import os
import shutil
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import (
    AGGREGATOR_EVENT_NAMES,
    EntityState,
    fold_events,
    states_to_property_maps,
)
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import (
    Event,
    new_event_id,
    validate_event,
)
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import UNSET
from predictionio_tpu_torch.data.storage.localfs import atomic_write_bytes
from predictionio_tpu_torch.data.storage.memory import match_event
from predictionio_tpu_torch.utils import metrics

DEFAULT_PART_MAX_EVENTS = 500_000
SNAPSHOT_NAME = "props_snapshot.json"

_log = logging.getLogger(__name__)


def _parse_event_line(raw: str, source: str) -> Optional[Event]:
    """A line that fails to parse is never a committed event — it is a
    torn fragment from a killed append (terminated by ``_repair_tail``)
    or external corruption. Skip it with a warning instead of letting one
    bad line poison every later read of the partition."""
    try:
        return Event.from_json(raw)
    except Exception:
        _log.warning("jsonlfs: skipping unparsable line in %s "
                     "(torn append fragment?)", source)
        return None


def _entity_needle(entity_id: str) -> Optional[bytes]:
    """The bytes every stored line of ``entity_id``'s events holds, in a
    partition with no ``\\u`` escape: its JSON string, quotes included.
    None when the id has another spelling a writer may choose: one with a
    character JSON escapes (a quote, a backslash, a slash, a control
    character), or one a non-string JSON value turns into (``Event``
    takes ``str()`` of the field: a number, a boolean, null, an array or
    an object), or one UTF-8 cannot spell (a lone surrogate)."""
    if not entity_id or entity_id in ("True", "False", "None") or \
            entity_id[0] in "[{" or \
            any(c in '"\\/' or c < " " or c == "\x7f" for c in entity_id):
        return None
    try:
        float(entity_id)
    except ValueError:
        try:
            return b'"' + entity_id.encode("utf-8") + b'"'
        except UnicodeEncodeError:
            return None
    return None


# a special event's JSON spells its name either literally ('"$set"') or
# with the dollar sign escaped as '\\u0024' (raw client lines arrive
# verbatim): a line holding neither needle is never a special event
_SPECIAL_NEEDLES = (b'"$', b"\\u0024")


def _special_candidates(data: bytes, end: int) -> List[str]:
    """The lines of ``data[:end]`` (newline-terminated) that hold one of
    the special-event needles, stripped and decoded, in file order. The
    scan looks for one byte of each needle (``$``, ``\\``), a one-byte
    search, and tests only the lines holding it. The needles are ASCII,
    and UTF-8 decoding (replaced bytes included) keeps every ASCII byte,
    so a line holds a needle in its bytes exactly when its decoded text
    does."""
    starts = set()
    for byte in (b"$", b"\\"):
        i = data.find(byte, 0, end)
        while i >= 0:
            start = data.rfind(b"\n", 0, i) + 1
            stop = data.find(b"\n", i, end)
            line = data[start:stop]
            if any(needle in line for needle in _SPECIAL_NEEDLES):
                starts.add(start)
            i = data.find(byte, stop, end)
    out: List[str] = []
    for start in sorted(starts):
        raw = data[start:data.find(b"\n", start, end)].strip()
        if raw:
            out.append(raw.decode("utf-8", errors="replace"))
    return out


class JsonlFsLEvents(base.LEvents):
    """LEvents over partitioned JSONL files (one dir per app/channel)."""

    metrics_backend = "jsonlfs"

    def __init__(self, config: Optional[dict] = None):
        cfg = config or {}
        self._root = cfg.get("path") or os.path.join(
            os.getcwd(), ".pio_store", "events_jsonl")
        self._part_max = int(cfg.get("part_max_events",
                                     DEFAULT_PART_MAX_EVENTS))
        # dir -> [last_part_index, events_in_last_part, bytes_in_last_part]
        # (byte size validates the cache against other writers' appends)
        self._writers: dict = {}
        # dir -> {"watermark": {part_basename: byte_offset},
        #         "states": {etype: {eid: EntityState record}}} — the
        # entity-props snapshot cache (see materialized_aggregate)
        self._snapshots: dict = {}
        self._lock = threading.RLock()          # guards dicts only
        self._dir_tlocks: dict = {}             # dir -> threading.RLock

    # -- layout -----------------------------------------------------------

    def _dir(self, app_id: int, channel_id: Optional[int]) -> str:
        chan = -1 if channel_id is None else int(channel_id)
        return os.path.join(self._root, f"app_{int(app_id)}_{chan}")

    def _parts(self, d: str) -> List[str]:
        return sorted(glob.glob(os.path.join(d, "part-*.jsonl")))

    @contextlib.contextmanager
    def _dir_lock(self, d: str):
        """Mutual exclusion for one app/channel directory, across
        threads (per-directory RLock) AND processes (advisory flock on
        ``<dir>/.lock``), taken around every append and every partition
        rewrite so a CLI cleanup racing a live eventserver's appends can
        never drop freshly appended lines. The process-global ``_lock``
        is held only for dict access — one directory's long rewrite
        must not stall writes to other apps."""
        with self._lock:
            tlock = self._dir_tlocks.setdefault(d, threading.RLock())
        with tlock:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, ".lock"), "a") as lf:
                fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

    @staticmethod
    def _repair_tail(path: str) -> None:
        """Terminate a torn final line (killed mid-append): without this
        the next append would glue new JSON onto the fragment. Terminated,
        the fragment is its own (unparsable) line, which readers skip."""
        try:
            with open(path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        except FileNotFoundError:
            pass

    def _derive_state(self, d: str) -> list:
        """Last partition's [index, line count, byte size] from disk,
        repairing a torn tail first. Caller holds the directory lock; the
        global ``_lock`` is never taken here, so the (possibly large)
        recount never stalls writes to other apps."""
        parts = self._parts(d)
        if not parts:
            return [0, 0, 0]
        idx = int(os.path.basename(parts[-1])[5:-6])
        self._repair_tail(parts[-1])
        with open(parts[-1], "rb") as f:
            cnt = sum(chunk.count(b"\n") for chunk in
                      iter(lambda: f.read(1 << 20), b""))
        return [idx, cnt, os.path.getsize(parts[-1])]

    def _writer_state(self, d: str) -> list:
        """Caller must hold the DIRECTORY lock. The cached
        [part_idx, count, size] is validated against the partition's
        on-disk byte size on every call, so a second legal writer
        (eventserver + CLI import share the flock) can never leave this
        instance appending with a stale count and overfilling a part."""
        with self._lock:
            st = self._writers.get(d)
        if st is not None:
            path = os.path.join(d, f"part-{st[0]:05d}.jsonl")
            try:
                if os.path.getsize(path) == st[2]:
                    return st
            except OSError:
                pass  # partition vanished or never written: re-derive
        fresh = self._derive_state(d)
        with self._lock:
            st = self._writers.setdefault(d, fresh)
            if st is not fresh:
                st[:] = fresh
        return st

    # -- lifecycle --------------------------------------------------------

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        os.makedirs(self._dir(app_id, channel_id), exist_ok=True)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):
            return False
        with self._dir_lock(d):
            with self._lock:
                self._writers.pop(d, None)
                self._snapshots.pop(d, None)
            # let a failed deletion RAISE (a silent True would report
            # data deleted while partitions remain on disk); the .lock
            # file itself is part of the tree and goes with it
            shutil.rmtree(d)
            # the tail generation lives BESIDE the directory and so
            # survives this: a re-created scope re-issues the same
            # partition names, and enough re-ingest would push part
            # sizes past a pre-remove cursor's offsets — without the
            # bump that cursor would silently skip the re-landed events
            self._bump_tail_gen(d)
        return True

    def close(self) -> None:
        pass

    # -- writes -----------------------------------------------------------

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Iterable[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        evs = list(events)
        for e in evs:
            validate_event(e)
        ids = [e.event_id or new_event_id() for e in evs]
        self.append_raw_lines(
            [e.with_id(i).to_json() for e, i in zip(evs, ids)],
            app_id, channel_id)
        return ids

    def append_raw_lines(self, lines: Sequence[str], app_id: int,
                         channel_id: Optional[int] = None) -> None:
        """Data-plane fast lane (cf. ``SqliteLEvents.insert_raw_batch``):
        pre-validated, pre-serialized event JSON lines appended with
        partition rolling — the bulk-import path."""
        lines = list(lines)
        d = self._dir(app_id, channel_id)
        with self._dir_lock(d):
            st = self._writer_state(d)
            pos = 0
            while pos < len(lines):
                while st[1] >= self._part_max:
                    nxt = os.path.join(d, f"part-{st[0] + 1:05d}.jsonl")
                    # another writer may have rolled past this partition
                    # already — jump to the true last part in that case
                    st[:] = self._derive_state(d) if os.path.exists(nxt) \
                        else [st[0] + 1, 0, 0]
                room = self._part_max - st[1]
                chunk = lines[pos:pos + room]
                path = os.path.join(d, f"part-{st[0]:05d}.jsonl")
                payload = ("\n".join(chunk) + "\n").encode("utf-8")
                with open(path, "ab") as f:
                    f.write(payload)
                st[1] += len(chunk)
                st[2] += len(payload)
                pos += len(chunk)

    # -- reads ------------------------------------------------------------

    def _iter_events(self, d: str) -> Iterable[Event]:
        """All events of one app/channel, storage order, typed. An
        unterminated trailing line (a racing live append's partial flush)
        is not a committed event and is skipped without a lock; streaming
        (never the whole partition in memory)."""
        for part in self._parts(d):
            yield from self._iter_part_events(part)

    @staticmethod
    def _iter_part_events(part: str) -> Iterable[Event]:
        # errors="replace": a fragment torn mid-multibyte character
        # must not poison the whole partition with UnicodeDecodeError
        with open(part, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                if not line.endswith("\n"):
                    break  # in-flight append or torn crash fragment
                line = line.strip()
                if line:
                    e = _parse_event_line(line, part)
                    if e is not None:
                        yield e

    def _iter_entity_candidates(self, d: str,
                                entity_id: str) -> Iterable[Event]:
        """The events of :meth:`_iter_events` that may belong to
        ``entity_id`` (a superset of its events, in storage order): in a
        partition where the id can only be spelled one way, only the
        lines holding that spelling are parsed — one byte search over
        the partition instead of a parse of every line, which an entity
        read (the fold-in gather, a serving-time constraint read) pays
        per call. The search runs over a read-only map of the partition
        (rewrites replace a partition's file, never truncate it), so the
        partition is never copied into memory. A partition with a
        ``\\u`` escape or a bare carriage return anywhere is parsed
        whole."""
        needle = _entity_needle(entity_id)
        if needle is None:
            yield from self._iter_events(d)
            return
        for part in self._parts(d):
            with open(part, "rb") as f:
                if os.fstat(f.fileno()).st_size == 0:
                    continue
                data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            with data:
                end = data.rfind(b"\n") + 1  # the committed lines
                if data.find(b"\\u", 0, end) != -1 or \
                        data.find(b"\r", 0, end) != -1:
                    yield from self._iter_part_events(part)
                    continue
                pos = data.find(needle, 0, end)
                while pos != -1:
                    start = data.rfind(b"\n", 0, pos) + 1
                    stop = data.find(b"\n", pos, end)
                    line = data[start:stop].decode("utf-8",
                                                   errors="replace")
                    line = line.strip()
                    if line:
                        e = _parse_event_line(line, part)
                        if e is not None:
                            yield e
                    pos = data.find(needle, stop + 1, end)

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        for e in self._iter_events(self._dir(app_id, channel_id)):
            if e.event_id == event_id:
                return e
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):  # nothing to delete; don't create dirs
            return False
        needle = f'"{event_id}"'
        with self._dir_lock(d):
            for part in self._parts(d):
                with open(part, "r", encoding="utf-8",
                          errors="replace") as f:
                    lines = f.readlines()

                def _is_target(ln: str) -> bool:
                    if needle not in ln:
                        return False
                    e = _parse_event_line(ln, part)
                    return e is not None and e.event_id == event_id

                kept = [ln for ln in lines if not _is_target(ln)]
                if len(kept) != len(lines):
                    # atomic replace (as delete_until): a crash
                    # mid-rewrite must never lose the surviving events
                    tmp = part + ".tmp"
                    with open(tmp, "w", encoding="utf-8") as f:
                        f.writelines(kept)
                    os.replace(tmp, part)
                    with self._lock:
                        self._writers.pop(d, None)  # recount on append
                    self._invalidate_snapshot(d)  # offsets now meaningless
                    return True
        return False

    def delete_until(self, app_id, until_time, channel_id=None) -> int:
        """Rewrite each partition keeping only post-cutoff lines (the
        native codec supplies per-line times + byte spans, so surviving
        lines are copied verbatim without re-serialization)."""
        from predictionio_tpu_torch.native import codec

        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):  # nothing to clean; don't create dirs
            return 0
        cutoff = until_time.timestamp()
        removed = 0
        with self._dir_lock(d):
            for part in self._parts(d):
                with open(part, "rb") as f:
                    data = f.read()
                parsed = codec.parse_jsonl(data, columns=set())
                if parsed is None:  # PIO_NATIVE_DISABLE=1
                    kept, dropped = self._filter_lines_python(data, cutoff)
                else:
                    times = parsed.event_time.copy()
                    for i in np.nonzero(np.isnan(times))[0]:
                        raw = data[parsed.line_start[i]:
                                   parsed.line_end[i]].decode(
                            "utf-8", errors="replace").strip()
                        e = _parse_event_line(raw, part)
                        # unparsable torn fragments get dropped by the
                        # rewrite along with the pre-cutoff events
                        times[i] = e.event_time.timestamp() \
                            if e is not None else float("-inf")
                    keep = times >= cutoff
                    kept = [data[parsed.line_start[i]:parsed.line_end[i]]
                            for i in np.nonzero(keep)[0]]
                    dropped = int((~keep).sum())
                if dropped:
                    # atomic replace: a crash mid-rewrite must never lose
                    # the surviving (post-cutoff) events
                    tmp = part + ".tmp"
                    with open(tmp, "wb") as f:
                        if kept:
                            f.write(b"\n".join(kept))
                            f.write(b"\n")
                    os.replace(tmp, part)
                    removed += dropped
            with self._lock:
                self._writers.pop(d, None)  # recount on next append
            if removed:
                self._invalidate_snapshot(d)  # offsets now meaningless
        return removed

    def _filter_lines_python(self, data: bytes, cutoff: float):
        kept: List[bytes] = []
        dropped = 0
        for line in data.split(b"\n"):
            if not line.strip():
                continue
            e = _parse_event_line(line.decode("utf-8", errors="replace"),
                                  "delete_until")
            if e is None:
                dropped += 1
            elif e.event_time.timestamp() >= cutoff:
                kept.append(line)
            else:
                dropped += 1
        return kept, dropped

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=UNSET, target_entity_id=UNSET,
             limit=None, reversed=False) -> Iterable[Event]:
        d = self._dir(app_id, channel_id)
        scan = self._iter_events(d) if entity_id is None \
            else self._iter_entity_candidates(d, entity_id)
        out = [e for e in scan
               if match_event(e, start_time, until_time, entity_type,
                              entity_id, event_names, target_entity_type,
                              target_entity_id)]
        out.sort(key=lambda e: e.event_time, reverse=bool(reversed))
        if limit is not None and limit >= 0:
            out = out[:limit]
        return iter(out)

    # -- tail reads (find_since contract, base.py) -------------------------
    # The cursor IS a per-partition byte watermark — the same shape the
    # PR-1 materialized-aggregation snapshot records (``_delta_lines``),
    # reused here as a consumer-owned position: arrival order is file
    # order, unterminated tails are never consumed (their offset stays
    # before them), and a partition rewrite (delete/delete_until) that
    # moved bytes under the offsets resets the cursor to a full replay.
    # Rewrites are detected two ways: a partition now SHORTER than its
    # recorded offset, and a per-directory rewrite generation carried in
    # the cursor — the latter catches a rewrite whose partition has
    # since been appended back past the stale offset (names survive
    # rewrites, so sizes alone cannot prove the bytes under an offset
    # are the ones the cursor consumed).

    @staticmethod
    def _gen_path(d: str) -> str:
        # a SIBLING of the scope directory, not inside it: remove()
        # deletes the whole tree, and the generation must survive a
        # remove + re-init (same partition names come back)
        return d.rstrip(os.sep) + ".tail_gen"

    def _tail_gen(self, d: str) -> int:
        try:
            with open(self._gen_path(d), "r", encoding="ascii") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _bump_tail_gen(self, d: str) -> None:
        """Caller holds the directory lock (rewrite/remove paths only)."""
        try:
            atomic_write_bytes(self._gen_path(d),
                               str(self._tail_gen(d) + 1).encode("ascii"))
        except OSError:
            # a read-only tree cannot be rewritten either, so there is
            # no offset movement to signal
            pass

    @staticmethod
    def _complete_size(path: str) -> int:
        """Byte offset just past the last COMPLETE (newline-terminated)
        line — the tail-cursor boundary: an offset inside a torn or
        in-flight final line would make the next read start mid-line
        and silently lose that event once it completes."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        if size == 0:
            return 0
        with open(path, "rb") as f:
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return size
            end = size - 1
            chunk = 1 << 16
            while end > 0:
                start = max(0, end - chunk)
                f.seek(start)
                data = f.read(end - start)
                cut = data.rfind(b"\n")
                if cut >= 0:
                    return start + cut + 1
                end = start
        return 0

    def find_since(self, app_id, channel_id=None, cursor=None, limit=None):
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):
            return [], {"kind": "jsonlfs", "watermark": {}, "gen": 0}
        wm = dict((cursor or {}).get("watermark", {}) or {})
        events: List[Event] = []
        with self._dir_lock(d):
            gen = self._tail_gen(d)
            parts = self._parts(d)
            names = {os.path.basename(p) for p in parts}
            stale = wm and (
                int((cursor or {}).get("gen", 0)) != gen
                or any(n not in names
                       or os.path.getsize(os.path.join(d, n)) < int(off)
                       for n, off in wm.items()))
            if stale:
                # a rewrite moved bytes under the offsets: replay from
                # the start (replay-tolerant consumer contract)
                wm = {}
            new_wm = dict(wm)
            full = False
            for part in parts:
                name = os.path.basename(part)
                off = int(wm.get(name, 0))
                end = self._complete_size(part)
                if end > off:
                    with open(part, "rb") as f:
                        f.seek(off)
                        data = f.read(end - off)
                    consumed = 0
                    for raw in data.split(b"\n")[:-1]:
                        if limit is not None and len(events) >= int(limit):
                            full = True
                            break
                        consumed += len(raw) + 1
                        raw = raw.strip()
                        if raw:
                            e = _parse_event_line(
                                raw.decode("utf-8", errors="replace"),
                                part)
                            if e is not None:
                                events.append(e)
                    off += consumed
                new_wm[name] = off
                if full:
                    break
        return events, {"kind": "jsonlfs", "watermark": new_wm,
                        "gen": gen}

    def tail_cursor(self, app_id, channel_id=None):
        d = self._dir(app_id, channel_id)
        wm: Dict[str, int] = {}
        gen = 0
        if os.path.isdir(d):
            with self._dir_lock(d):
                gen = self._tail_gen(d)
                for part in self._parts(d):
                    wm[os.path.basename(part)] = self._complete_size(part)
        return {"kind": "jsonlfs", "watermark": wm, "gen": gen}

    def tail_watermark(self, app_id, channel_id=None):
        d = self._dir(app_id, channel_id)
        out = {"cursor": {"kind": "jsonlfs", "watermark": {}, "gen": 0},
               "lastEventId": None, "lastEventTime": None}
        if not os.path.isdir(d):
            return out
        last: Optional[Event] = None
        with self._dir_lock(d):
            out["cursor"]["gen"] = self._tail_gen(d)
            parts = self._parts(d)
            wm = {os.path.basename(p): self._complete_size(p)
                  for p in parts}
            for part in reversed(parts):
                end = wm[os.path.basename(part)]
                if end == 0:
                    continue
                # scan back in doubling windows: a window that starts
                # mid-line truncates its first line into an unparsable
                # fragment, so a single fixed-size window would report
                # a STALE watermark whenever the final event line is
                # bigger than it (large properties payloads)
                window = 1 << 16
                with open(part, "rb") as f:
                    while last is None:
                        start = max(0, end - window)
                        f.seek(start)
                        data = f.read(end - start)
                        lines = [ln for ln in data.split(b"\n")
                                 if ln.strip()]
                        if start > 0:
                            lines = lines[1:]  # possibly torn head
                        for raw in reversed(lines):
                            e = _parse_event_line(
                                raw.decode("utf-8", errors="replace"),
                                part)
                            if e is not None:
                                last = e
                                break
                        if start == 0:
                            break
                        window *= 2
                if last is not None:
                    break
        out["cursor"]["watermark"] = wm
        if last is not None:
            out["lastEventId"] = last.event_id
            out["lastEventTime"] = last.event_time.isoformat()
        return out

    # -- materialized entity-property state (watermark snapshot) ----------

    def _invalidate_snapshot(self, d: str) -> None:
        """A partition rewrite moved bytes under the recorded offsets —
        drop the snapshot so the next read refolds from scratch, and
        bump the tail generation so outstanding tail cursors reset to a
        full replay (partition names survive a rewrite, so a shrink
        followed by enough appends could otherwise push the file back
        past a stale byte offset and silently skip the re-landed
        bytes). Caller holds the directory lock."""
        self._bump_tail_gen(d)
        with self._lock:
            self._snapshots.pop(d, None)
        try:
            os.unlink(os.path.join(d, SNAPSHOT_NAME))
            metrics.AGGREGATE_SCOPE_DROPS.inc(backend=self.metrics_backend)
        except FileNotFoundError:
            pass

    def _load_snapshot(self, d: str) -> dict:
        with self._lock:
            snap = self._snapshots.get(d)
        if snap is not None and os.path.exists(os.path.join(d,
                                                            SNAPSHOT_NAME)):
            # the existence check guards against ANOTHER process having
            # invalidated (unlinked) the snapshot after a partition
            # rewrite — our in-memory cache would otherwise survive a
            # rewrite whose file later grows back past the cached offsets
            return snap
        try:
            with open(os.path.join(d, SNAPSHOT_NAME), "r",
                      encoding="utf-8") as f:
                snap = json.load(f)
            if not isinstance(snap, dict) \
                    or not isinstance(snap.get("watermark"), dict) \
                    or not isinstance(snap.get("states"), dict):
                raise ValueError("malformed snapshot")
        except (FileNotFoundError, ValueError, json.JSONDecodeError):
            snap = {"watermark": {}, "states": {}}
        return snap

    def _delta_lines(self, d: str, parts: List[str],
                     watermark: Dict[str, int]):
        """Complete lines appended past the watermark that may hold a
        special event, in file order, plus the advanced watermark.
        Unterminated tails (in-flight appends) are not consumed — their
        offset stays before them."""
        new_mark: Dict[str, int] = {}
        lines: List[str] = []
        for part in parts:
            name = os.path.basename(part)
            off = int(watermark.get(name, 0))
            size = os.path.getsize(part)
            if size > off:
                with open(part, "rb") as f:
                    f.seek(off)
                    data = f.read(size - off)
                cut = data.rfind(b"\n") + 1
                lines += _special_candidates(data, cut)
                off += cut
            new_mark[name] = off
        return lines, new_mark

    def materialized_aggregate(self, app_id, entity_type, channel_id=None
                               ) -> Optional[Dict[str, PropertyMap]]:
        """Serve ``aggregate_properties`` current-state reads from a
        watermark snapshot: the fold up to the watermark is persisted in
        ``props_snapshot.json`` (atomic write), and a read replays only
        the bytes appended since — O(delta), not O(store). Partition
        rewrites (delete/delete_until) invalidate the snapshot; an
        out-of-order append re-derives just the touched entities."""
        d = self._dir(app_id, channel_id)
        if not os.path.isdir(d):
            return {}
        try:
            with self._dir_lock(d):
                snap = self._load_snapshot(d)
                parts = self._parts(d)
                names = {os.path.basename(p) for p in parts}
                stale = [n for n, off in snap["watermark"].items()
                         if n not in names
                         or os.path.getsize(os.path.join(d, n)) < off]
                if stale:
                    # a rewrite slipped past invalidation (another
                    # process): offsets are meaningless, refold everything
                    snap = {"watermark": {}, "states": {}}
                lines, new_mark = self._delta_lines(d, parts,
                                                    snap["watermark"])
                if lines or new_mark != snap["watermark"]:
                    if not snap["watermark"]:
                        # folding the whole store, not a delta: the
                        # jsonlfs analog of the sqlite scope backfill
                        metrics.AGGREGATE_BACKFILLS.inc(
                            backend=self.metrics_backend)
                    delta: List[Event] = []
                    for ln in lines:
                        e = _parse_event_line(ln, d)
                        if e is not None and \
                                e.event in AGGREGATOR_EVENT_NAMES:
                            delta.append(e)
                    self._fold_delta(d, snap, delta)
                    snap["watermark"] = new_mark
                    atomic_write_bytes(
                        os.path.join(d, SNAPSHOT_NAME),
                        json.dumps(snap, sort_keys=True).encode("utf-8"))
                with self._lock:
                    self._snapshots[d] = snap
                # extract under the dir lock: a concurrent reader's delta
                # fold mutates these dicts in place
                states = {eid: EntityState.from_record(rec)
                          for eid, rec in snap["states"]
                          .get(entity_type, {}).items()}
        except OSError:
            # read-only events directory (snapshot/.lock writes refused)
            # or fs trouble: stay servable via the pure-read replay
            return None
        return states_to_property_maps(states)

    def _fold_delta(self, d: str, snap: dict, delta: List[Event]) -> None:
        by_entity: Dict[tuple, List[Event]] = {}
        for e in delta:
            by_entity.setdefault((e.entity_type, e.entity_id), []).append(e)
        out_of_order: List[tuple] = []
        for (etype, eid), evs in by_entity.items():
            recs = snap["states"].setdefault(etype, {})
            rec = recs.get(eid)
            st = None if rec is None else EntityState.from_record(rec)
            if st is not None and st.last_updated is not None and \
                    min(e.event_time for e in evs) < st.last_updated:
                # replay would sort these before already-folded events
                out_of_order.append((etype, eid))
                continue
            recs[eid] = fold_events(evs, st).to_record()
        if out_of_order:
            # one full pass re-deriving ONLY the out-of-order entities
            wanted = set(out_of_order)
            history: Dict[tuple, List[Event]] = {k: [] for k in wanted}
            for e in self._iter_events(d):
                k = (e.entity_type, e.entity_id)
                if k in history and e.event in AGGREGATOR_EVENT_NAMES:
                    history[k].append(e)
            for (etype, eid), evs in history.items():
                recs = snap["states"].setdefault(etype, {})
                st = fold_events(evs)
                if st is None:
                    recs.pop(eid, None)
                else:
                    recs[eid] = st.to_record()


class JsonlFsPEvents(base.LEventsBackedPEvents):
    """Bulk reads: native-codec partition scans streaming columnar blocks."""

    def __init__(self, config: Optional[dict] = None):
        super().__init__(JsonlFsLEvents(config))

    # -- streaming columnar scan (the scale path) -------------------------

    def find_columnar_blocks(self, app_id, channel_id=None, start_time=None,
                             until_time=None, entity_type=None,
                             event_names=None, target_entity_type=UNSET,
                             value_property=None, default_value=1.0,
                             strict=True, block_size=1_000_000,
                             prefetch=0):
        """One bounded :class:`ColumnarEvents` block per partition file
        (further split at ``block_size``), in storage order. Each
        partition is decoded in one native-codec pass — value column
        included — so peak host memory is one partition's columns, never
        the whole store.

        ``prefetch`` > 0 is the block-prefetch hint: up to that many
        partitions are read AND decoded ahead on a small thread pool
        (the C++ codec releases the GIL, so the decodes genuinely run
        in parallel), while blocks still yield in exact storage order —
        the pipelined-ingest decode stage stops being one partition
        deep. Peak memory rises to ``prefetch`` decoded partitions.
        0 keeps the serial one-partition-at-a-time scan."""
        lev: JsonlFsLEvents = self._l
        d = lev._dir(app_id, channel_id)
        kw = dict(start_time=start_time, until_time=until_time,
                  entity_type=entity_type, event_names=event_names,
                  target_entity_type=target_entity_type,
                  value_property=value_property,
                  default_value=default_value, strict=strict)
        parts = lev._parts(d)
        if prefetch and len(parts) > 1:
            import collections
            from concurrent.futures import ThreadPoolExecutor

            window = max(1, int(prefetch))
            ex = ThreadPoolExecutor(max_workers=window,
                                    thread_name_prefix="pio-part-decode")
            try:
                pending = collections.deque(
                    ex.submit(self._read_decode_part, p, kw)
                    for p in parts[:window])
                nxt = window
                while pending:
                    blocks = pending.popleft().result()  # storage order
                    if nxt < len(parts):
                        pending.append(ex.submit(self._read_decode_part,
                                                 parts[nxt], kw))
                        nxt += 1
                    for block in blocks:
                        for i in range(0, len(block), block_size):
                            yield block.take(slice(i, i + block_size))
            finally:
                # early consumer exit / poisoned-part error: don't
                # block teardown on in-flight whole-partition decodes —
                # cancel the queued ones and let running ones finish in
                # the background (their results are dropped)
                ex.shutdown(wait=False, cancel_futures=True)
            return
        for part in parts:
            for block in self._read_decode_part(part, kw):
                for i in range(0, len(block), block_size):
                    yield block.take(slice(i, i + block_size))

    def _read_decode_part(self, part: str, kw: dict):
        """Read one partition's bytes and decode them to blocks — the
        unit the prefetch pool parallelizes."""
        with open(part, "rb") as f:
            data = f.read()
        if data and not data.endswith(b"\n"):
            # an unterminated tail is a racing live append's partial
            # flush (or a torn crash fragment) — not a committed
            # event; scan only the complete lines
            data = data[:data.rfind(b"\n") + 1]
        # a part may yield TWO blocks: the (encoded) bulk of the
        # file plus a small object-form block of fallback rows — one
        # exotic line must not de-optimize the whole partition
        return self._decode_part(data, source=part, **kw)

    def find_columnar(self, app_id, channel_id=None, start_time=None,
                      until_time=None, entity_type=None, event_names=None,
                      target_entity_type=UNSET, value_property=None,
                      default_value=1.0, strict=True):
        """Full scan = concatenated blocks, stably sorted by event time
        (the non-streaming contract other backends honor)."""
        from predictionio_tpu_torch.data.columnar import ColumnarEvents

        blocks = list(self.find_columnar_blocks(
            app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
            value_property=value_property, default_value=default_value,
            strict=strict))
        batch = ColumnarEvents.concat(blocks)
        order = np.argsort(batch.event_times, kind="stable")
        return batch.take(order)

    def _decode_part(self, data: bytes, *, start_time, until_time,
                     entity_type, event_names, target_entity_type,
                     value_property, default_value, strict, source: str):
        return decode_jsonl_events(
            data, start_time=start_time, until_time=until_time,
            entity_type=entity_type, event_names=event_names,
            target_entity_type=target_entity_type,
            value_property=value_property, default_value=default_value,
            strict=strict, source=source)


def decode_jsonl_events(data: bytes, *, start_time=None, until_time=None,
                        entity_type=None, event_names=None,
                        target_entity_type=UNSET, value_property=None,
                        default_value=1.0, strict=True,
                        source: str = "<bytes>"):
    """Event-JSONL bytes -> list of filtered ColumnarEvents, native codec
    first. The string columns come back DICTIONARY-ENCODED (int32 codes +
    distinct labels), so filtering is pure numpy over codes and no
    per-event Python strings exist — the 10M-row fast lane. Fallback
    rows (lines the codec punted on) come back as a separate small
    object-form block so they never de-optimize the encoded bulk.

    Shared by the jsonlfs partition scan and the resthttp client (which
    ships partition bytes over the wire and decodes them here)."""
    from predictionio_tpu_torch.data.columnar import (
        ColumnarEvents,
        events_to_columnar,
    )
    from predictionio_tpu_torch.native import codec

    enc = {codec.COL_EVENT, codec.COL_ENTITY_ID,
           codec.COL_TARGET_ENTITY_ID}
    # type columns are only worth an O(n) encode pass when their
    # filters are active
    if entity_type is not None:
        enc.add(codec.COL_ENTITY_TYPE)
    if target_entity_type is not UNSET:
        enc.add(codec.COL_TARGET_ENTITY_TYPE)
    parsed = codec.parse_jsonl(
        data, numeric_property=value_property, dict_encode=enc,
        # the only per-row strings materialized: raw eventTime text,
        # needed just for rows whose time the C++ parser punted on
        columns={codec.COL_EVENT_TIME_RAW})
    if parsed is None:  # PIO_NATIVE_DISABLE=1: python oracle on the part
        events = [e for ln in data.decode("utf-8").splitlines()
                  if ln.strip()
                  and (e := _parse_event_line(ln, source)) is not None]
        kept = [e for e in events
                if match_event(e, start_time, until_time, entity_type,
                               None, event_names, target_entity_type,
                               UNSET)]
        return [events_to_columnar(kept, value_property=value_property,
                                   default_value=default_value,
                                   strict=strict)]

    flags = parsed.flags
    keep = (flags & codec.FALLBACK) == 0

    def code_filter(col: int, wanted: set) -> np.ndarray:
        """Rows whose encoded column value is in ``wanted`` — a label
        scan over the (tiny) distinct set + one vector isin."""
        labels = parsed.dict_labels[col]
        codes = parsed.dict_codes[col]
        want = np.asarray([j for j, lab in enumerate(labels)
                           if lab in wanted], dtype=np.int32)
        return np.isin(codes, want)

    if event_names is not None:
        keep &= code_filter(codec.COL_EVENT, set(event_names))
    if entity_type is not None:
        keep &= code_filter(codec.COL_ENTITY_TYPE, {entity_type})
    if target_entity_type is not UNSET:
        tet = parsed.dict_codes[codec.COL_TARGET_ENTITY_TYPE]
        if target_entity_type is None:
            keep &= tet == -1
        else:
            keep &= code_filter(codec.COL_TARGET_ENTITY_TYPE,
                                {target_entity_type})

    times = parsed.event_time.copy()
    # rows the codec parsed but whose eventTime it could not (rare
    # exotic formats): resolve via the python parser so time filters
    # and ordering stay exact
    nan_rows = np.nonzero(keep & np.isnan(times))[0]
    if len(nan_rows):
        from predictionio_tpu_torch.data.event import _now, _parse_time

        now_ts = _now().timestamp()
        for i in nan_rows:
            raw = parsed.event_time_raw[i]
            t = _parse_time(raw) if raw is not None else None
            times[i] = t.timestamp() if t is not None else now_ts
    if start_time is not None:
        keep &= times >= start_time.timestamp()
    if until_time is not None:
        keep &= times < until_time.timestamp()

    idx = np.nonzero(keep)[0]
    vals = np.full(len(idx), float(default_value), dtype=np.float32)
    if value_property is not None and len(idx):
        status = parsed.prop_status[idx]
        if strict and (status == 2).any():
            bad = idx[int(np.nonzero(status == 2)[0][0])]
            raise ValueError(
                f"property {value_property!r} of event at "
                f"{source}:{int(parsed.lineno[bad])} is non-numeric")
        numeric = status == 1
        vals[numeric] = parsed.prop_value[idx][numeric].astype(
            np.float32)
    block = ColumnarEvents(
        entity_ids=None,
        target_ids=None,
        values=vals,
        event_times=times[idx],
        entity_codes=parsed.dict_codes[codec.COL_ENTITY_ID][idx],
        entity_labels=parsed.dict_labels[codec.COL_ENTITY_ID],
        target_codes=parsed.dict_codes[
            codec.COL_TARGET_ENTITY_ID][idx],
        target_labels=parsed.dict_labels[codec.COL_TARGET_ENTITY_ID],
        event_codes=parsed.dict_codes[codec.COL_EVENT][idx],
        event_labels=parsed.dict_labels[codec.COL_EVENT],
    )

    out = [block]
    # fallback rows: the python oracle re-parses those exact lines
    # into their own small block
    fb_rows = np.nonzero((flags & codec.FALLBACK) != 0)[0]
    if len(fb_rows):
        events = []
        for i in fb_rows:
            raw = data[parsed.line_start[i]:parsed.line_end[i]] \
                .decode("utf-8", errors="replace").strip()
            e = _parse_event_line(raw, source)
            if e is None:
                continue
            if match_event(e, start_time, until_time, entity_type,
                           None, event_names, target_entity_type,
                           UNSET):
                events.append(e)
        if events:
            out.append(events_to_columnar(
                events, value_property=value_property,
                default_value=default_value, strict=strict))
    return out
