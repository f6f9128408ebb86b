"""The port's native ingest kernels against numpy and the JAX codec.

``merge_sorted_runs``, ``segment_starts`` and ``bucket_fill``
(``predictionio_tpu_torch/native``, g++-built host C++) must give
byte-for-byte what the port's numpy paths give (``PIO_NATIVE_DISABLE=1``)
and what the JAX package's ``native.codec`` gives. Then both layouts
of the preparator (``pad_ratings`` and ``bucket_ratings_pair``) must be
byte-equal with and without the native fill, and to the JAX package's
layouts, over duplicate pairs, ``max_len`` cuts, empty rows, a single
bucket and ratings that arrive as sorted runs (the streaming read's
blocks, joined by the native merge). Each native entry point counts the
calls it runs.
"""

import numpy as np
import pytest

from predictionio_tpu.native import codec as jcodec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch import native
from predictionio_tpu_torch.native import codec
from predictionio_tpu_torch.ops import als as tals

from jax_native_ready import require_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """The JAX package's native libraries loaded before any comparison
    (``jax_native_ready``): a build raced by another worker is waited
    out, never compared against as the Python fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)


def runs_of(n, rng, k):
    cuts = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False))
    return np.r_[0, cuts, n].astype(np.int64)


def sorted_runs(rng, n, k, hi):
    """Keys in ``k`` ascending runs with ties inside and across runs."""
    runs = runs_of(n, rng, k)
    keys = rng.integers(0, hi, n).astype(np.int64)
    for a, b in zip(runs[:-1], runs[1:]):
        keys[a:b] = np.sort(keys[a:b])
    return keys, runs


@pytest.mark.parametrize("n, k, hi", [(1, 1, 5), (50, 1, 5), (2000, 2, 30),
                                      (5000, 7, 10_000), (4096, 33, 3)])
def test_merge_sorted_runs(monkeypatch, n, k, hi):
    rng = np.random.default_rng(n + k)
    keys, runs = sorted_runs(rng, n, k, hi)
    before = codec.merge_calls.value
    got = codec.merge_sorted_runs(keys, runs)
    assert codec.merge_calls.value == before + 1
    want = np.argsort(keys, kind="stable")
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jcodec.merge_sorted_runs(keys, runs))
    monkeypatch.setenv("PIO_NATIVE_DISABLE", "1")
    assert codec.merge_sorted_runs(keys, runs) is None
    assert codec.merge_calls.value == before + 1


@pytest.mark.parametrize("keys", [[], [4], [1, 1, 1], [0, 1, 2, 3],
                                  [1, 1, 2, 5, 5, 5, 9], "random"])
def test_segment_starts(monkeypatch, keys):
    if keys == "random":
        keys = np.sort(np.random.default_rng(3).integers(0, 400, 10_000))
    keys = np.asarray(keys, dtype=np.int64)
    got = codec.segment_starts(keys)
    want = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) if len(keys) \
        else np.empty(0, np.int64)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jcodec.segment_starts(keys))
    monkeypatch.setenv("PIO_NATIVE_DISABLE", "1")
    assert codec.segment_starts(keys) is None


def test_bucket_fill_tables_equal_the_jax_codec():
    rng = np.random.default_rng(5)
    rows, cols, vals = tals.dedup_sum_ratings(
        rng.integers(0, 40, 900), rng.integers(0, 60, 900),
        rng.normal(size=900).astype(np.float32), 60)
    counts = np.bincount(rows, minlength=40)
    pos = np.arange(len(rows)) - np.r_[0, np.cumsum(counts)][rows]
    b_of_row = (counts > counts.mean()).astype(np.int32)
    rank = np.zeros(40, dtype=np.int64)
    for b in (0, 1):
        members = np.flatnonzero(b_of_row == b)
        rank[members] = np.arange(len(members))

    def tables():
        return [tuple(np.zeros((int((b_of_row == b).sum()), L), dt)
                      for dt in (np.int32, np.float32, np.float32))
                for b, L in ((0, int(counts.max())), (1, int(counts.max())))]

    got, want = tables(), tables()
    before = codec.fill_calls.value
    assert codec.bucket_fill(rows, cols, vals, pos, b_of_row, rank, got)
    assert codec.fill_calls.value == before + 1
    assert jcodec.bucket_fill(rows, cols, vals, pos, b_of_row, rank, want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.tobytes() == b.tobytes()
    assert got[0][2].sum() + got[1][2].sum() == len(rows)


def triples(seed, n_rows=37, n_cols=23, n=700, empty=(3, 11)):
    """Ratings with many duplicate pairs, some empty rows and columns,
    and values of both signs (the implicit path's negative feedback)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n)
    rows[np.isin(rows, empty)] = 0
    cols = rng.integers(0, n_cols - 2, n)
    vals = (rng.integers(-4, 11, n) * 0.5).astype(np.float32)
    return rows.astype(np.int64), cols.astype(np.int64), vals, n_rows, n_cols


def side_bytes(side):
    if isinstance(side, (tals.PaddedRatings, jals.PaddedRatings)):
        return [side.cols.tobytes(), side.weights.tobytes(),
                side.mask.tobytes(), side.n_rows, side.n_cols]
    return [(b.row_ids.tobytes(), b.cols.tobytes(), b.weights.tobytes(),
             b.mask.tobytes()) for b in side.buckets] + [side.n_rows,
                                                         side.n_cols]


CASES = {
    "plain": {},
    "max_len cut": {"max_len": 9},
    "single bucket": {"bucket_lengths": [1000]},
    "given ladder": {"bucket_lengths": [4, 8, 16]},
    "runs": {"runs": 5},
    "runs and max_len": {"runs": 3, "max_len": 6},
}


@pytest.mark.parametrize("layout, case", [
    (layout, case) for layout in ("uniform", "bucketed")
    for case in sorted(CASES)
    if layout == "bucketed" or "bucket_lengths" not in CASES[case]])
def test_layouts_equal_with_and_without_native_and_the_jax_layout(
        monkeypatch, layout, case):
    rows, cols, vals, n_r, n_c = triples(sorted(CASES).index(case))
    kw = dict(CASES[case])
    runs = kw.pop("runs", None)
    if runs is not None:
        runs = runs_of(len(rows), np.random.default_rng(1), runs)
    if layout == "uniform":
        def build(m, **extra):
            return [m.pad_ratings(rows, cols, vals, n_r, n_c, **kw, **extra),
                    m.pad_ratings(cols, rows, vals, n_c, n_r, **kw, **extra)]
    else:
        def build(m, **extra):
            return list(m.bucket_ratings_pair(rows, cols, vals, n_r, n_c,
                                              **kw, **extra))

    counts = (codec.fill_calls.value, codec.segment_calls.value,
              codec.merge_calls.value)
    native_sides = build(tals, runs=runs)
    assert codec.fill_calls.value > counts[0]
    assert codec.segment_calls.value > counts[1]
    assert (codec.merge_calls.value > counts[2]) == (runs is not None)
    jax_sides = build(jals)
    monkeypatch.setenv("PIO_NATIVE_DISABLE", "1")
    numpy_sides = build(tals, runs=runs)
    assert codec.fill_calls.value == counts[0] + 2
    for got, plain, want in zip(native_sides, numpy_sides, jax_sides):
        assert side_bytes(got) == side_bytes(plain) == side_bytes(want)
    if layout == "bucketed" and case == "single bucket":
        assert len(native_sides[0].buckets) == 1


@pytest.mark.parametrize("n_runs", [1, 2, 9])
def test_stable_key_order_over_runs(n_runs):
    rng = np.random.default_rng(n_runs)
    key = rng.integers(0, 50, 3000).astype(np.int64)
    runs = runs_of(len(key), rng, n_runs) if n_runs > 1 else None
    assert np.array_equal(tals.stable_key_order(key, runs),
                          np.argsort(key, kind="stable"))
    with pytest.raises(ValueError, match="span"):
        tals.stable_key_order(key, np.asarray([0, 10, 20]))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a source that does not compile raises."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native build of broken failed"):
        native.load("broken")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load("broken")
