"""ctypes wrappers of the native ingest kernels (``src/ingest_kernels.cpp``).

The port's copy of the ingest half of ``predictionio_tpu/native/codec.py``
(``merge_sorted_runs``, ``segment_starts``, ``bucket_fill``); the JSON
lines codec comes with the MovieLens-20M ingest path (ROADMAP queue A
item 2). Each wrapper returns None (``bucket_fill``: False) only when
``PIO_NATIVE_DISABLE=1``, and the caller then takes its byte-identical
numpy path; a library that does not build raises. Each counts the calls
it runs natively (``merge_calls``, ``segment_calls``, ``fill_calls``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops._build import LaunchCounter

merge_calls = LaunchCounter()
segment_calls = LaunchCounter()
fill_calls = LaunchCounter()

_i64p_t = ctypes.POINTER(ctypes.c_int64)
_i32p_t = ctypes.POINTER(ctypes.c_int32)
_f32p_t = ctypes.POINTER(ctypes.c_float)


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


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_i64p_t)


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
