"""ctypes wrappers of the port's native host kernels.

The port's copy of ``predictionio_tpu/native/codec.py``:

- the JSON lines event codec (``src/jsonl_codec.cpp``): ``parse_jsonl``
  returns a :class:`ParsedEvents` batch (per-field string lists or
  dictionary codes, epoch-second times, per-row validation facts, the
  numeric value column). Rows the codec cannot express one for one with
  the Python semantics carry ``FALLBACK``, and the caller re-parses just
  those lines with ``Event.from_json``;
- the ingest kernels (``src/ingest_kernels.cpp``): ``merge_sorted_runs``,
  ``segment_starts``, ``bucket_fill``.

Each wrapper returns None (``bucket_fill``: False) only when
``PIO_NATIVE_DISABLE=1``, and the caller then takes its Python or numpy
path, which gives the same result; a library that does not build
raises. Each counts the calls it runs natively (``parse_calls``,
``merge_calls``, ``segment_calls``, ``fill_calls``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np

from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops._build import LaunchCounter

parse_calls = LaunchCounter()
merge_calls = LaunchCounter()
segment_calls = LaunchCounter()
fill_calls = LaunchCounter()

_i64p_t = ctypes.POINTER(ctypes.c_int64)
_i32p_t = ctypes.POINTER(ctypes.c_int32)
_f32p_t = ctypes.POINTER(ctypes.c_float)


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_i64p_t)


# column ids: keep in sync with src/jsonl_codec.cpp
COL_EVENT = 0
COL_ENTITY_TYPE = 1
COL_ENTITY_ID = 2
COL_TARGET_ENTITY_TYPE = 3
COL_TARGET_ENTITY_ID = 4
COL_PROPERTIES = 5
COL_TAGS = 6
COL_PR_ID = 7
COL_EVENT_ID = 8
COL_EVENT_TIME_RAW = 9
COL_CREATION_TIME_RAW = 10
COL_BAD_PROP_KEY = 11

FALLBACK = 1
PROPS_EMPTY = 2
BAD_PROP_KEY = 4


@dataclasses.dataclass
class ParsedEvents:
    """One parsed buffer: aligned per-row columns."""

    event: List[Optional[str]]
    entity_type: List[Optional[str]]
    entity_id: List[Optional[str]]
    target_entity_type: List[Optional[str]]
    target_entity_id: List[Optional[str]]
    properties_json: List[Optional[str]]   # raw JSON object text
    tags_json: List[Optional[str]]         # raw JSON array text
    pr_id: List[Optional[str]]
    event_id: List[Optional[str]]
    event_time_raw: List[Optional[str]]
    creation_time_raw: List[Optional[str]]
    bad_prop_key: List[Optional[str]]
    event_time: np.ndarray       # float64 epoch sec; NaN = absent/unparsed
    creation_time: np.ndarray
    flags: np.ndarray            # uint8 bitmask per row
    lineno: np.ndarray           # int64 1-based source line numbers
    line_start: np.ndarray       # raw-buffer byte spans (fallback re-parse)
    line_end: np.ndarray
    # the numeric property column, when requested: status 0 = absent or
    # null, 1 = numeric (value in prop_value), 2 = present, not numeric
    prop_value: Optional[np.ndarray] = None   # float64
    prop_status: Optional[np.ndarray] = None  # uint8
    # dictionary encodings, when requested: col id -> (int32 codes [n],
    # first-seen distinct labels); a code of -1 means absent on that row
    dict_codes: Optional[dict] = None
    dict_labels: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.lineno)


_u8p_t = ctypes.POINTER(ctypes.c_uint8)
_f64p_t = ctypes.POINTER(ctypes.c_double)


def _codec_lib() -> Optional[ctypes.CDLL]:
    lib = native.load("jsonl_codec")
    # signatures are set on each CDLL instance: a fresh handle left with
    # the default c_int restype would cut 64-bit pointers
    if lib is not None and not getattr(lib, "_pio_sigs", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        sigs = {
            "pio_jsonl_parse": (vp, [ctypes.c_char_p, i64]),
            "pio_jsonl_count": (i64, [vp]),
            "pio_jsonl_col_bytes": (i64, [vp, i32]),
            "pio_jsonl_col_fill": (None, [vp, i32, ctypes.c_char_p, _i64p_t,
                                          _u8p_t]),
            "pio_jsonl_times": (None, [vp, _f64p_t, _f64p_t]),
            "pio_jsonl_flags": (None, [vp, _u8p_t]),
            "pio_jsonl_lines": (None, [vp, _i64p_t, _i64p_t, _i64p_t]),
            "pio_jsonl_free": (None, [vp]),
            "pio_jsonl_extract_numeric": (None, [vp, ctypes.c_char_p, i64,
                                                 _f64p_t, _u8p_t]),
            "pio_jsonl_dict_encode": (vp, [vp, i32]),
            "pio_dict_n_labels": (i64, [vp]),
            "pio_dict_blob_bytes": (i64, [vp]),
            "pio_dict_fill": (None, [vp, _i32p_t, ctypes.c_char_p,
                                     _i64p_t]),
            "pio_dict_free": (None, [vp]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        lib._pio_sigs = True
    return lib


def _col(lib, handle, col: int, n: int) -> List[Optional[str]]:
    """One string column as a per-row list (None where absent)."""
    nbytes = lib.pio_jsonl_col_bytes(handle, col)
    data = ctypes.create_string_buffer(max(1, nbytes))
    offsets = np.empty(n + 1, dtype=np.int64)
    present = np.empty(n, dtype=np.uint8)
    lib.pio_jsonl_col_fill(handle, col, data, _i64p(offsets),
                           present.ctypes.data_as(_u8p_t))
    out: List[Optional[str]] = [None] * n
    idx = np.nonzero(present)[0]
    if len(idx) == 0:
        return out
    blob = data.raw[:nbytes].decode("utf-8")
    # offsets are byte offsets: slice the decoded str only when it is
    # pure ASCII (byte offsets == char offsets)
    if len(blob) == nbytes:
        for i in idx:
            out[i] = blob[offsets[i]:offsets[i + 1]]
    else:
        raw = data.raw
        for i in idx:
            out[i] = raw[offsets[i]:offsets[i + 1]].decode("utf-8")
    return out


def _dict_encode(lib, handle, col: int, n: int):
    """One string column dictionary-encoded in C++: int32 codes per row
    and the distinct labels (only distinct values become Python
    strings)."""
    d = lib.pio_jsonl_dict_encode(handle, col)
    try:
        k = lib.pio_dict_n_labels(d)
        nbytes = lib.pio_dict_blob_bytes(d)
        codes = np.empty(n, dtype=np.int32)
        blob = ctypes.create_string_buffer(max(1, nbytes))
        offsets = np.empty(k + 1, dtype=np.int64)
        lib.pio_dict_fill(d, codes.ctypes.data_as(_i32p_t), blob,
                          _i64p(offsets))
        raw = blob.raw[:nbytes]
        labels = np.empty(k, dtype=object)
        for i in range(k):
            labels[i] = raw[offsets[i]:offsets[i + 1]].decode("utf-8")
        return codes, labels
    finally:
        lib.pio_dict_free(d)


def parse_jsonl(data: bytes,
                numeric_property: Optional[str] = None,
                columns: Optional[set] = None,
                dict_encode: Optional[set] = None
                ) -> Optional[ParsedEvents]:
    """Parse a JSON lines event buffer natively (the GIL is released for
    the parse).

    ``numeric_property`` also extracts that top-level property as a
    numeric column (``prop_value`` / ``prop_status``). ``columns`` (COL_*
    ids) restricts which string columns become per-row lists (the rest
    are None); ``dict_encode`` (COL_* ids) returns those columns as
    int32 codes and distinct labels instead (``dict_codes`` /
    ``dict_labels``). With ``columns=None`` every column not encoded
    becomes a list; an encoded column becomes one too only when
    ``columns`` lists it."""
    lib = _codec_lib()
    if lib is None:
        return None
    handle = lib.pio_jsonl_parse(data, len(data))
    try:
        n = lib.pio_jsonl_count(handle)
        enc = dict_encode or set()
        cols = [_col(lib, handle, c, n)
                if (c in columns if columns is not None else c not in enc)
                else None
                for c in range(12)]
        et = np.empty(n, dtype=np.float64)
        ct = np.empty(n, dtype=np.float64)
        lib.pio_jsonl_times(handle, et.ctypes.data_as(_f64p_t),
                            ct.ctypes.data_as(_f64p_t))
        flags = np.empty(n, dtype=np.uint8)
        lib.pio_jsonl_flags(handle, flags.ctypes.data_as(_u8p_t))
        starts = np.empty(n, dtype=np.int64)
        ends = np.empty(n, dtype=np.int64)
        lineno = np.empty(n, dtype=np.int64)
        lib.pio_jsonl_lines(handle, _i64p(starts), _i64p(ends),
                            _i64p(lineno))
        parsed = ParsedEvents(
            event=cols[COL_EVENT],
            entity_type=cols[COL_ENTITY_TYPE],
            entity_id=cols[COL_ENTITY_ID],
            target_entity_type=cols[COL_TARGET_ENTITY_TYPE],
            target_entity_id=cols[COL_TARGET_ENTITY_ID],
            properties_json=cols[COL_PROPERTIES],
            tags_json=cols[COL_TAGS],
            pr_id=cols[COL_PR_ID],
            event_id=cols[COL_EVENT_ID],
            event_time_raw=cols[COL_EVENT_TIME_RAW],
            creation_time_raw=cols[COL_CREATION_TIME_RAW],
            bad_prop_key=cols[COL_BAD_PROP_KEY],
            event_time=et, creation_time=ct, flags=flags, lineno=lineno,
            line_start=starts, line_end=ends)
        if numeric_property is not None:
            pv = np.empty(n, dtype=np.float64)
            ps = np.empty(n, dtype=np.uint8)
            kb = numeric_property.encode("utf-8")
            lib.pio_jsonl_extract_numeric(handle, kb, len(kb),
                                          pv.ctypes.data_as(_f64p_t),
                                          ps.ctypes.data_as(_u8p_t))
            parsed.prop_value = pv
            parsed.prop_status = ps
        if enc:
            parsed.dict_codes, parsed.dict_labels = {}, {}
            for c in enc:
                codes, labels = _dict_encode(lib, handle, c, n)
                parsed.dict_codes[c] = codes
                parsed.dict_labels[c] = labels
        parse_calls.add()
        return parsed
    finally:
        lib.pio_jsonl_free(handle)


def _ingest_lib() -> Optional[ctypes.CDLL]:
    lib = native.load("ingest_kernels")
    if lib is not None and not getattr(lib, "_pio_sigs", False):
        lib.pio_merge_runs_i64.restype = None
        lib.pio_merge_runs_i64.argtypes = [
            _i64p_t, _i64p_t, ctypes.c_int32, ctypes.c_int64, _i64p_t]
        lib.pio_bucket_fill.restype = None
        lib.pio_bucket_fill.argtypes = [
            ctypes.c_int64, _i64p_t, _i64p_t, _f32p_t, _i64p_t, _i32p_t,
            _i64p_t, ctypes.c_int32, _i64p_t, ctypes.POINTER(_i32p_t),
            ctypes.POINTER(_f32p_t), ctypes.POINTER(_f32p_t)]
        lib.pio_segment_starts_i64.restype = ctypes.c_int64
        lib.pio_segment_starts_i64.argtypes = [_i64p_t, ctypes.c_int64,
                                               _i64p_t]
        lib._pio_sigs = True
    return lib


def merge_sorted_runs(keys: np.ndarray,
                      offsets: np.ndarray) -> Optional[np.ndarray]:
    """Stable k-way merge permutation over contiguous sorted int64 runs
    (run r = ``keys[offsets[r]:offsets[r+1]]``, each ascending), equal
    to ``np.argsort(keys, kind="stable")``; the GIL is released for the
    whole merge."""
    lib = _ingest_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = int(keys.shape[0])
    perm = np.empty(n, dtype=np.int64)
    lib.pio_merge_runs_i64(_i64p(keys), _i64p(offsets), len(offsets) - 1, n,
                           _i64p(perm))
    merge_calls.add()
    return perm


def segment_starts(sorted_keys: np.ndarray) -> Optional[np.ndarray]:
    """Start index of each equal-key segment of a sorted int64 array,
    equal to ``np.flatnonzero(np.r_[True, k[1:] != k[:-1]])``."""
    lib = _ingest_lib()
    if lib is None:
        return None
    sorted_keys = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    n = int(sorted_keys.shape[0])
    out = np.empty(max(1, n), dtype=np.int64)
    m = lib.pio_segment_starts_i64(_i64p(sorted_keys), n, _i64p(out))
    segment_calls.add()
    return out[:m]


def bucket_fill(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                pos: np.ndarray, b_of_row: np.ndarray, rank: np.ndarray,
                tables) -> bool:
    """One-pass scatter of row-sorted deduplicated triples into
    per-bucket padded tables (``tables``: one ``(cols int32, weights
    float32, mask float32)`` triple of zeroed C-contiguous ``[Bp, L_b]``
    arrays per bucket): byte-identical to the per-bucket numpy scatter,
    in one pass over the entries instead of one per bucket."""
    lib = _ingest_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    b_of_row = np.ascontiguousarray(b_of_row, dtype=np.int32)
    rank = np.ascontiguousarray(rank, dtype=np.int64)
    for t in tables:
        if not all(a.flags.c_contiguous for a in t):
            raise ValueError("bucket_fill needs C-contiguous tables")
    nb = len(tables)
    L = np.asarray([t[0].shape[1] for t in tables], dtype=np.int64)
    c_pp = (_i32p_t * nb)(*[t[0].ctypes.data_as(_i32p_t) for t in tables])
    w_pp = (_f32p_t * nb)(*[t[1].ctypes.data_as(_f32p_t) for t in tables])
    m_pp = (_f32p_t * nb)(*[t[2].ctypes.data_as(_f32p_t) for t in tables])
    lib.pio_bucket_fill(
        len(rows), _i64p(rows), _i64p(cols), vals.ctypes.data_as(_f32p_t),
        _i64p(pos), b_of_row.ctypes.data_as(_i32p_t), _i64p(rank), nb,
        _i64p(L), c_pp, w_pp, m_pp)
    fill_calls.add()
    return True
