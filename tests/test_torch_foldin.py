"""Online fold-in's solve, live store and consumer: the port against the
JAX package, on the CPU.

Every case makes its inputs with numpy from a seed and hands the same
arrays to ``predictionio_tpu`` and ``predictionio_tpu_torch``. On CPU
tensors the port's kernel wrappers run their plain versions (the CUDA
kernels are held against those on the card by ``chip_smoke.py``).

Tolerances, and why:

- ``pad_fold_in_batch`` is the same numpy data movement in both
  packages: its three tables are compared byte for byte.
- ``fold_in_users`` is one training half-step. It agrees with JAX
  ``fold_in_users`` to 1e-4 of the largest entry, the bound
  ``tests/test_torch_als_train.py`` holds one half-step to: the port
  folds ``lam * I`` into the assembly's Gram term and solves with its
  own Cholesky, where JAX adds it after the sum and calls LAPACK. The
  port's fold and the port's own bucketed half-step run the same
  functions on tables that differ only by zero-weight padding: 1e-5.
- ``patch_users`` writes the same rows into the same stores: the stored
  rows are equal (bf16 and int8 rows come from the same fp32 rows by the
  same rounding rule), and ``users_topk`` over every user gives equal
  ids and scores within rtol 1e-5 (R products summed in another order).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import serving as jserving
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.memory import MemLEvents
from predictionio_tpu_torch.data.storage.sqlite import SqliteLEvents
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.ops.quantize import dequantize_rows
from predictionio_tpu_torch.online import foldin as tfoldin
from predictionio_tpu_torch.utils import device_telemetry as ttel
from predictionio_tpu_torch.utils import tracing as ttracing

HALF_STEP_TOL = 1e-4


def near(got, want, tol):
    """Largest |got - want| within ``tol`` times the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0)) / scale
    assert err <= tol, f"max error {err!r} of the largest entry > {tol}"


def ragged(rng, n_users, n_items, lo=1, hi=30, dup=False):
    """Per-user item index and value arrays (multiples of 0.5)."""
    cols, vals = [], []
    for _ in range(n_users):
        n = int(rng.integers(lo, hi))
        c = rng.integers(0, n_items, n) if dup else \
            rng.choice(n_items, size=min(n, n_items), replace=False)
        cols.append(c.astype(np.int64))
        vals.append((rng.integers(1, 11, len(c)) * 0.5).astype(np.float32))
    return cols, vals


def params_pair(**kw):
    return jals.ALSParams(**kw), tals.ALSParams(**kw)


# -- the solve --------------------------------------------------------------

class TestPadFoldInBatch:
    @pytest.mark.parametrize("k,max_len,dup", [
        (1, None, False), (5, None, True), (9, None, True), (3, 10, True),
        (20, 16, False), (64, 5, True)])
    def test_tables_equal_jax_byte_for_byte(self, k, max_len, dup):
        rng = np.random.default_rng(k)
        cols, vals = ragged(rng, k, 40, 0, 45, dup)
        got = tals.pad_fold_in_batch(cols, vals, max_len=max_len)
        want = jals.pad_fold_in_batch(cols, vals, max_len=max_len)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()

    def test_buckets_and_effective_cap(self):
        rng = np.random.default_rng(0)
        cols, vals = ragged(rng, 9, 60, 20, 21)
        c, _, m = tals.pad_fold_in_batch(cols, vals, max_len=10)
        # B = bucket(9, 8) = 16; training's cap 10 rounds up to 16
        assert c.shape == (16, 16)
        assert m.sum(axis=1).tolist() == [16.0] * 9 + [0.0] * 7


class TestFoldInUsers:
    @pytest.mark.parametrize("implicit", [True, False])
    @pytest.mark.parametrize("ydtype", ["fp32", "bf16"])
    def test_equals_jax(self, implicit, ydtype):
        import jax.numpy as jnp

        rng = np.random.default_rng(11)
        Y = rng.normal(size=(25, 8)).astype(np.float32) * 0.5
        cols, vals = ragged(rng, 9, 25)
        jp, tp = params_pair(rank=8, lambda_=0.05, implicit_prefs=implicit)
        if ydtype == "bf16":
            jY = jnp.asarray(Y, dtype=jnp.bfloat16)
            tY = torch.from_numpy(Y).to(torch.bfloat16)
        else:
            jY, tY = Y, torch.from_numpy(Y)
        want = jals.fold_in_users(jY, cols, vals, jp)
        got = tals.fold_in_users(tY, cols, vals, tp)
        assert got.dtype == np.float32 and got.shape == (9, 8)
        near(got, want, HALF_STEP_TOL)

    def test_duplicates_are_summed(self):
        rng = np.random.default_rng(3)
        Y = rng.normal(size=(12, 4)).astype(np.float32)
        jp, tp = params_pair(rank=4)
        cols, vals = ragged(rng, 6, 12, 5, 20, dup=True)
        near(tals.fold_in_users(Y, cols, vals, tp, device="cpu"),
             jals.fold_in_users(Y, cols, vals, jp), HALF_STEP_TOL)
        dup = tals.fold_in_users(Y, [np.array([2, 2, 3])],
                                 [np.array([1.5, 2.5, 1.0], np.float32)],
                                 tp, device="cpu")
        summed = tals.fold_in_users(Y, [np.array([2, 3])],
                                    [np.array([4.0, 1.0], np.float32)], tp,
                                    device="cpu")
        np.testing.assert_array_equal(dup, summed)

    def test_max_len_truncation_in_the_rounding_gap(self):
        """max_len=10 rounds up to training's effective cap of 16: users
        with 11-16 distinct ratings keep them all, longer ones keep their
        16 largest. Both packages cut the same way, and the cut matters."""
        rng = np.random.default_rng(17)
        Y = rng.normal(size=(30, 6)).astype(np.float32)
        cols, vals = ragged(rng, 8, 30, 11, 30)
        jp, tp = params_pair(rank=6)
        got = tals.fold_in_users(Y, cols, vals, tp, max_len=10, device="cpu")
        near(got, jals.fold_in_users(Y, cols, vals, jp, max_len=10),
             HALF_STEP_TOL)
        uncut = tals.fold_in_users(Y, cols, vals, tp, device="cpu")
        long_rows = [i for i, c in enumerate(cols) if len(c) > 16]
        assert long_rows
        assert np.abs(uncut[long_rows] - got[long_rows]).max() > 1e-3
        gap = [i for i, c in enumerate(cols) if 10 < len(c) <= 16]
        np.testing.assert_array_equal(uncut[gap], got[gap])

    def test_empty_and_unknown_only_users_are_zero(self):
        rng = np.random.default_rng(1)
        Y = rng.normal(size=(6, 4)).astype(np.float32)
        jp, tp = params_pair(rank=4)
        cols = [np.array([], np.int64), np.array([1, 4]),
                np.array([], np.int64)]
        vals = [np.array([], np.float32), np.array([2.0, 3.0], np.float32),
                np.array([], np.float32)]
        got = tals.fold_in_users(Y, cols, vals, tp, device="cpu")
        near(got, jals.fold_in_users(Y, cols, vals, jp), HALF_STEP_TOL)
        np.testing.assert_array_equal(got[[0, 2]], 0.0)
        assert tals.fold_in_users(Y, [], [], tp, device="cpu").shape == (0, 4)

    @pytest.mark.parametrize("implicit", [True, False])
    def test_equals_the_ports_training_half_step(self, implicit):
        """The fold of a user's ratings against fixed Y is the row the
        bucketed training half-step solves for that user."""
        rng = np.random.default_rng(5)
        n_u, n_i, nnz = 40, 30, 700
        rows = rng.integers(0, n_u, nnz)
        cols = rng.integers(0, n_i, nnz)
        vals = (rng.integers(1, 11, nnz) * 0.5).astype(np.float32)
        Y = torch.from_numpy(rng.normal(size=(n_i, 8)).astype(np.float32))
        us, _ = tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i)
        tables = [tuple(torch.as_tensor(a) for a in
                        (b.row_ids, b.cols, b.weights, b.mask))
                  for b in us.buckets]
        X = tals._solve_side_bucketed(Y, tables, n_u, 0.05, 1.0, implicit,
                                      None).numpy()
        touched = rng.choice(n_u, size=11, replace=False)
        sets = [(cols[rows == u], vals[rows == u]) for u in touched]
        _, tp = params_pair(rank=8, lambda_=0.05, implicit_prefs=implicit)
        got = tals.fold_in_users(Y, [c for c, _ in sets],
                                 [v for _, v in sets], tp)
        near(got, X[touched], 1e-5)

    def test_records_a_foldin_dispatch_and_span(self):
        rng = np.random.default_rng(2)
        Y = rng.normal(size=(20, 4)).astype(np.float32)
        cols, vals = ragged(rng, 3, 20, 9, 12)
        _, tp = params_pair(rank=4)
        ttel.recorder().reset()
        with ttracing.trace_scope("foldin.test") as root:
            tals.fold_in_users(Y, cols, vals, tp, device="cpu")
        rec = ttel.last_record()
        assert (rec["lane"], rec["kBucket"], rec["bucket"], rec["batch"]) \
            == ("foldin", 16, 8, 3)
        assert rec["deviceUs"] is None  # no CUDA events on the CPU
        tree = ttracing.trace_buffer().get(root.trace_id)
        ex = [s for s in tree["spans"] if s["name"] == "device.execute"]
        assert len(ex) == 1 and ex[0]["attributes"]["lane"] == "foldin"
        assert "deviceTiming" in ex[0]["attributes"]


# -- the live store -----------------------------------------------------------

PRECISIONS = ["fp32", "bf16", "int8"]


def patch_case(rng, precision):
    X = rng.normal(size=(10, 6)).astype(np.float32)
    Y = rng.normal(size=(40, 6)).astype(np.float32)
    seen = {u: rng.choice(40, size=3, replace=False) for u in range(10)}
    return X, Y, seen


def stores(monkeypatch, precision, X, Y, seen):
    monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
    monkeypatch.setenv("PIO_SERVE_KERNEL", "xla")
    jsrv = jserving.DeviceTopK(X, Y, seen, microbatch=False)
    tsrv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    assert tsrv.precision == precision
    return jsrv, tsrv


def stored_rows(srv):
    X = srv._X
    if hasattr(X, "scale"):
        return (np.asarray(X.data, np.int8) if not torch.is_tensor(X.data)
                else X.data.numpy(),
                np.asarray(X.scale) if not torch.is_tensor(X.scale)
                else X.scale.numpy())
    if torch.is_tensor(X):
        return (X.float().numpy(),)
    return (np.asarray(X, np.float32),)


def assert_same_store(jsrv, tsrv):
    assert tsrv.user_capacity == jsrv.user_capacity
    assert tsrv.n_users == jsrv.n_users
    for t, j in zip(stored_rows(tsrv), stored_rows(jsrv)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tsrv._seen_cols.numpy(),
                                  np.asarray(jsrv._seen_cols))
    np.testing.assert_array_equal(tsrv._seen_mask.numpy(),
                                  np.asarray(jsrv._seen_mask))
    uids = np.arange(tsrv.n_users)
    ti, ts = tsrv.users_topk(uids, 12)
    ji, js = jsrv.users_topk(uids, 12)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-5, atol=1e-5)


class TestPatchUsers:
    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_known_rows_and_seen(self, monkeypatch, precision):
        rng = np.random.default_rng(0)
        X, Y, seen = patch_case(rng, precision)
        jsrv, tsrv = stores(monkeypatch, precision, X, Y, seen)
        rows = rng.normal(size=(3, 6)).astype(np.float32)
        upd = {2: np.array([0, 1, 5]), 7: np.array([9])}
        for srv in (jsrv, tsrv):
            srv.patch_users(np.array([2, 7, 9]), rows, seen_items=upd)
        assert tsrv.user_capacity == 10 and not tsrv.growths
        assert_same_store(jsrv, tsrv)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_growth_past_capacity_in_rows_and_width(self, monkeypatch,
                                                    precision):
        rng = np.random.default_rng(1)
        X, Y, seen = patch_case(rng, precision)
        jsrv, tsrv = stores(monkeypatch, precision, X, Y, seen)
        rows = rng.normal(size=(2, 6)).astype(np.float32)
        # user 21 grows 10 -> 32 rows; 12 seen items grow 8 -> 16 wide
        upd = {21: rng.choice(40, 12, replace=False), 4: np.array([3])}
        for srv in (jsrv, tsrv):
            srv.patch_users(np.array([21, 4]), rows, seen_items=upd)
        assert tsrv.user_capacity == 32 and tsrv.n_users == 22
        assert tsrv._seen_cols.shape == (32, 16)
        assert [g["rows"] for g in tsrv.growths] == [[10, 32]]
        assert tsrv.growths[0]["seenShape"] == [(10, 8), (32, 16)]
        assert_same_store(jsrv, tsrv)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_seenless_growth_grows_the_seen_tables(self, monkeypatch,
                                                   precision):
        rng = np.random.default_rng(4)
        X, Y, seen = patch_case(rng, precision)
        jsrv, tsrv = stores(monkeypatch, precision, X, Y, seen)
        rows = rng.normal(size=(1, 6)).astype(np.float32)
        for srv in (jsrv, tsrv):
            srv.patch_users(np.array([15]), rows)
        assert tsrv._seen_cols.shape[0] == tsrv.user_capacity == 16
        assert not tsrv._seen_mask[10:].any()
        assert_same_store(jsrv, tsrv)

    def test_store_without_seen_tables_grows(self, monkeypatch):
        rng = np.random.default_rng(6)
        X, Y, _ = patch_case(rng, "fp32")
        jsrv, tsrv = stores(monkeypatch, "fp32", X, Y, None)
        rows = rng.normal(size=(1, 6)).astype(np.float32)
        for srv in (jsrv, tsrv):
            srv.patch_users(np.array([40]), rows)
        assert tsrv.user_capacity == jsrv.user_capacity == 64
        ti, ts = tsrv.users_topk(np.array([0, 40]), 5)
        ji, js = jsrv.users_topk(np.array([0, 40]), 5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_item_factors_are_the_served_items_in_fp32(self, monkeypatch,
                                                       precision):
        rng = np.random.default_rng(8)
        X, Y, seen = patch_case(rng, precision)
        jsrv, tsrv = stores(monkeypatch, precision, X, Y, seen)
        got = tsrv.item_factors
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert tuple(got.shape) == (40, 6)  # the kernel's padding cut off
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsrv.item_factors, np.float32))
        assert tsrv.item_factors is not got  # built per access
        if precision == "int8":
            np.testing.assert_array_equal(
                got.numpy(), dequantize_rows(tsrv._Y).numpy()[:40])

    def test_bad_arguments_raise(self):
        tsrv = tserving.DeviceTopK(np.ones((2, 2), np.float32),
                                   np.ones((3, 2), np.float32),
                                   microbatch=False, device="cpu")
        with pytest.raises(ValueError, match="uids vs factors"):
            tsrv.patch_users(np.array([0, 1]), np.ones((1, 2), np.float32))
        with pytest.raises(ValueError, match="negative"):
            tsrv.patch_users(np.array([-1]), np.ones((1, 2), np.float32))
        tsrv.patch_users(np.array([], np.int64), np.ones((0, 2), np.float32))
        assert tsrv.growable and tsrv.user_capacity == 2

    def test_foldin_enabled_reads_the_env(self, monkeypatch):
        for raw, want in (("1", True), ("on", True), ("0", False),
                          ("", False)):
            monkeypatch.setenv("PIO_FOLDIN", raw)
            assert tserving.foldin_enabled() is want
            assert jserving.foldin_enabled() is want


def test_queries_during_alternating_patches_are_never_torn():
    """Eight threads send ``users_topk`` queries (one through the
    micro-batcher, the rest directly, batched) while the main thread
    alternates the rows and seen lists of four users between sets A and
    B, once growing the store, with a short switch interval: every
    answer is set A's answer or set B's, never a mix."""
    rng = np.random.default_rng(2)
    Y = rng.normal(size=(64, 8)).astype(np.float32)
    A = rng.normal(size=(4, 8)).astype(np.float32)
    B = rng.normal(size=(4, 8)).astype(np.float32)
    X = rng.normal(size=(6, 8)).astype(np.float32)
    seen = {u: rng.choice(64, size=4, replace=False) for u in range(6)}
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=True, device="cpu")
    users = np.array([1, 2, 3, 5])
    sa = {int(u): rng.choice(64, 5, replace=False) for u in users}
    sb = {int(u): rng.choice(64, 7, replace=False) for u in users}
    srv.patch_users(users, A, seen_items=sa)
    want_a = srv.users_topk(users, 8)
    srv.patch_users(users, B, seen_items=sb)
    want_b = srv.users_topk(users, 8)
    legal = [(w[0].tobytes(), w[1].tobytes()) for w in (want_a, want_b)]
    assert legal[0] != legal[1]
    answers, errors = [], []
    stop = threading.Event()

    def hammer(single):
        while not stop.is_set():
            try:
                if single:
                    got = [srv.user_topk(int(u), 8) for u in users[:1]]
                    answers.append(("single", got[0][0].tobytes()))
                else:
                    i, s = srv.users_topk(users, 8)
                    answers.append(("batch", (i.tobytes(), s.tobytes())))
            except Exception as e:  # reported below
                errors.append(repr(e))

    threads = [threading.Thread(target=hammer, args=(j == 0,))
               for j in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    for th in threads:
        th.start()
    try:
        for j in range(60):
            grow = np.array([6 + 40]) if j == 30 else np.array([], np.int64)
            rows = (A, B)[j % 2]
            srv.patch_users(np.concatenate([users, grow]),
                            np.concatenate([rows, np.ones((len(grow), 8),
                                                          np.float32)]),
                            seen_items=(sa, sb)[j % 2])
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        sys.setswitchinterval(interval)
        srv.close()
    assert not any(th.is_alive() for th in threads)
    assert not errors and answers
    assert srv.user_capacity == 64 and len(srv.growths) == 1
    singles = {want_a[0][0][want_a[1][0] > -np.inf].tobytes(),
               want_b[0][0][want_b[1][0] > -np.inf].tobytes()}
    for kind, got in answers:
        if kind == "batch":
            assert got in legal
        else:
            assert got in singles


# -- the consumer ----------------------------------------------------------------

def rate(u, i, val, j):
    import datetime as dt

    return TEvent(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties={"rating": float(val)},
                  event_time=dt.datetime(2022, 5, 1, tzinfo=dt.timezone.utc)
                  + dt.timedelta(seconds=j))


@pytest.fixture
def tmem():
    tstorage.reset(tstorage.StorageConfig(
        {"M": {"type": "memory"}},
        {r: "M" for r in tstorage.REPOSITORIES}))
    yield tstorage
    tstorage.reset()


@pytest.mark.parametrize("backend", ["sqlite", "memory"])
def test_gather_takes_the_indexed_path_on_sqlite_and_the_scan_on_memory(
        backend, tmp_path):
    """More than four touched users: sqlite (indexed_entity_reads) reads
    each user's rows from its index; memory reads the store once and
    buckets it. Both give the rows per-user reads give."""
    assert SqliteLEvents.indexed_entity_reads is True
    assert not getattr(MemLEvents, "indexed_entity_reads", False)
    src = {"type": "memory"} if backend == "memory" else {
        "type": "sqlite", "path": str(tmp_path / "g.db")}
    tstorage.reset(tstorage.StorageConfig(
        {"S": src}, {r: "S" for r in tstorage.REPOSITORIES}))
    try:
        aid = tstorage.get_metadata_apps().insert(App(0, "gatherapp"))
        le = tstorage.get_levents()
        le.init(aid)
        rng = np.random.default_rng(5)
        le.insert_batch([rate(f"u{j % 7}", f"i{int(rng.integers(0, 9))}",
                              rng.integers(1, 6), j) for j in range(60)]
                        + [rate("u1", "unknown-item", 3, 61),
                           rate("ghost", "unknown-item", 3, 62)], aid)

        class Stub:
            item_map = {f"i{j}": j for j in range(9)}

        c = tfoldin.FoldInConsumer(Stub(), tfoldin.FoldInConfig(
            app_name="gatherapp"), tals.ALSParams(rank=4))
        c._scope = (aid, None)
        finds = []
        real_find = type(le).find

        def spy(self, app_id, *args, **kwargs):
            finds.append(kwargs.get("entity_id"))
            return real_find(self, app_id, *args, **kwargs)

        uids = [f"u{i}" for i in range(7)] + ["nobody", "ghost"]
        type(le).find = spy
        try:
            kept, cols, vals = c._gather(list(uids))
        finally:
            type(le).find = real_find
        if backend == "sqlite":
            assert finds == uids        # one indexed read per user
        else:
            assert finds == [None]      # one shared scan
        # "nobody" has no rows; "ghost" rated only an unknown item
        assert kept == uids[:7]
        one = tfoldin.FoldInConsumer(Stub(), tfoldin.FoldInConfig(
            app_name="gatherapp"), tals.ALSParams(rank=4))
        one._scope = (aid, None)
        for uid, cc, vv in zip(kept, cols, vals):
            k1, (c1,), (v1,) = one._gather([uid])   # the per-user path
            assert k1 == [uid]
            np.testing.assert_array_equal(np.sort(cc), np.sort(c1))
            np.testing.assert_array_equal(vv[np.argsort(cc, kind="stable")],
                                          v1[np.argsort(c1, kind="stable")])
    finally:
        tstorage.reset()


def test_failed_fold_is_re_merged_then_dropped_after_three(tmem):
    c = tfoldin.FoldInConsumer(None, tfoldin.FoldInConfig(app_name="x"),
                               tals.ALSParams(rank=4))
    c._pending = {"u1": 2, "u2": 1}
    c._pending_events = 3
    c._fresh_ts = [1.0, 2.0]

    def boom(uids):
        raise RuntimeError("transient gather failure")

    c._gather = boom
    c._fold()
    assert c.fold_errors == 1
    assert c._pending == {"u1": 2, "u2": 1}
    assert c._pending_events == 3 and c._fresh_ts == [1.0, 2.0]
    c._fold()
    assert c._pending
    c._fold()
    assert c._pending == {} and c.fold_errors == 3
    assert c.stats()["foldErrors"] == 3


class _Dep:
    def __init__(self, models, dsp, *aparams):
        from predictionio_tpu_torch.controller.engine import EngineParams

        self.models = models
        self.engine_params = EngineParams(
            data_source_params=("", dsp),
            algorithm_params_list=[(f"algo{i}", a)
                                   for i, a in enumerate(aparams)])


def test_attach_refusals():
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
    )

    class ALSLike:
        user_map = item_map = {}

        def device_server(self):
            return None

    with pytest.raises(ValueError, match="no deployed algorithm"):
        tfoldin.attach_foldin(_Dep([object()], DataSourceParams("a"),
                                   tals.ALSParams()))
    with pytest.raises(ValueError, match="not ALSParams"):
        tfoldin.attach_foldin(_Dep([ALSLike()], DataSourceParams("a"),
                                   object()))
    with pytest.raises(ValueError, match="no app_name"):
        tfoldin.attach_foldin(_Dep([ALSLike()], DataSourceParams(""),
                                   tals.ALSParams()))
    consumer = tfoldin.attach_foldin(
        _Dep([ALSLike()], DataSourceParams("a", event_names=("rate", "buy")),
             tals.ALSParams()), interval=0.3, count_threshold=5)
    assert consumer._cfg.event_names == ("rate", "buy")
    assert (consumer._cfg.interval, consumer._cfg.count_threshold) == (0.3, 5)
    with pytest.raises(ValueError, match="ALSParams"):
        tfoldin.FoldInConsumer(ALSLike(), consumer._cfg, None)


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("PIO_FOLDIN_INTERVAL", "0.75")
    monkeypatch.setenv("PIO_FOLDIN_COUNT", "9")
    cfg = tfoldin.FoldInConfig.from_env(app_name="a")
    assert (cfg.interval, cfg.count_threshold) == (0.75, 9)
    monkeypatch.setenv("PIO_FOLDIN_INTERVAL", "soon")
    assert tfoldin.FoldInConfig.from_env(app_name="a").interval == 2.0


def test_consumer_stats_equal_jax_shape(tmem):
    from predictionio_tpu.online import foldin as jfoldin

    jc = jfoldin.FoldInConsumer(None, jfoldin.FoldInConfig(app_name="x"),
                                jals.ALSParams(rank=4))
    tc = tfoldin.FoldInConsumer(None, tfoldin.FoldInConfig(app_name="x"),
                                tals.ALSParams(rank=4))
    assert tc.stats() == jc.stats()


class _Target:
    """A fold-in target over a CPU ``DeviceTopK``; ``hook`` makes it a
    model-encoder target (its own ``fold_in_rows`` solve)."""

    def __init__(self, user_map, item_map, Y, hook=None, patchable=True):
        self.user_map, self.item_map = user_map, item_map
        X = np.zeros((len(user_map), Y.shape[1]), np.float32)
        self._srv = tserving.DeviceTopK(X, Y, {}, microbatch=False,
                                        device="cpu") if patchable \
            else object()
        if hook is not None:
            self.fold_in_rows = hook

    def device_server(self):
        return self._srv


def test_composite_folds_an_als_and_a_hook_target_over_one_vocabulary(
        tmem, monkeypatch):
    """Two targets share one ``user_map``: ``attach_foldin`` gives a
    composite whose consumers share one patch lock; the ALS target's
    rows are the half-step's, the hook target's the hook's, and the new
    user is appended once, then found by the second consumer."""
    from predictionio_tpu_torch.data.bimap import StringIndexBiMap
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
    )

    monkeypatch.setenv("PIO_SERVE_PRECISION", "fp32")
    aid = tstorage.get_metadata_apps().insert(App(0, "compapp"))
    le = tstorage.get_levents()
    le.init(aid)
    rng = np.random.default_rng(11)
    le.insert_batch([rate(u, f"i{int(rng.integers(0, 9))}",
                          rng.integers(1, 6), j)
                     for j, u in enumerate(["u0", "n0", "u1", "n0"] * 5)],
                    aid)
    Y = rng.normal(size=(9, 4)).astype(np.float32)
    user_map = StringIndexBiMap(["u0", "u1"])
    item_map = {f"i{j}": j for j in range(9)}
    hooked = []

    def hook(cols_list, vals_list):
        hooked.append([len(c) for c in cols_list])
        return np.stack([np.full(4, float(v.sum()), np.float32)
                         for v in vals_list])

    als_model = _Target(user_map, item_map, Y)
    hook_model = _Target(user_map, item_map, Y, hook=hook)
    params = tals.ALSParams(rank=4, lambda_=0.1)
    comp = tfoldin.attach_foldin(_Dep([als_model, hook_model],
                                      DataSourceParams("compapp"),
                                      params, object()))
    assert isinstance(comp, tfoldin.CompositeFoldInConsumer)
    first, second = comp.consumers
    assert first._patch_lock is second._patch_lock
    for c in (first, second):
        c._scope = (aid, None)
        c._pending, c._pending_events = {"u0": 1, "n0": 2}, 3
        c._fold()
    assert c.fold_errors == 0 and first.fold_errors == 0
    assert list(user_map.labels) == ["u0", "u1", "n0"]
    kept, cols, vals = first._gather(["u0", "n0"])
    want = tals.fold_in_users(Y, cols, vals, params, device="cpu")
    got = als_model.device_server()._X[[0, 2]].numpy()
    np.testing.assert_array_equal(got, want)
    assert hooked == [[len(c) for c in cols]]
    np.testing.assert_array_equal(
        hook_model.device_server()._X[[0, 2]].numpy(),
        hook(cols, vals))
    st = comp.stats()
    assert (st["folds"], st["usersPatched"], st["newUsers"]) == (2, 4, 1)
    assert [t["newUsers"] for t in st["targets"]] == [1, 0]
    assert not comp.stale


def test_composite_start_stops_the_started_when_one_refuses(tmem):
    from predictionio_tpu_torch.data.bimap import StringIndexBiMap

    tstorage.get_metadata_apps().insert(App(0, "compapp"))
    Y = np.ones((3, 2), np.float32)
    user_map = StringIndexBiMap(["u0"])
    cfg = tfoldin.FoldInConfig(app_name="compapp")
    good = tfoldin.FoldInConsumer(_Target(user_map, {}, Y), cfg,
                                  tals.ALSParams(rank=2))
    bad = tfoldin.FoldInConsumer(_Target(user_map, {}, Y, patchable=False),
                                 cfg, tals.ALSParams(rank=2))
    with pytest.raises(ValueError, match="patch_users"):
        tfoldin.CompositeFoldInConsumer([good, bad]).start()
    assert good._thread is None
    with pytest.raises(ValueError, match="at least one"):
        tfoldin.CompositeFoldInConsumer([])
