"""The port's two-stage serving against the JAX package's.

``TwoStageTopK`` at N = the catalog on fp32, bf16 and int8 stores
answers as JAX's store does on the same tables (integer-valued tables:
ids and scores equal; float tables without near-ties: ids equal, scores
1e-5) and as a brute-force re-rank of the whole catalog; the seen mask
applies once; ``patch_seq_users`` patches and grows both stages; a
hammer of queries over alternating patches never reads a torn store;
``build_two_stage_store`` refuses what JAX's refuses (the host backend
through the port's A8 refusal); ``TwoStageServing`` composes on the host
or serves the bound route; the composite fold-in attaches both stages
under one patch lock; and the ``twostage`` engine, trained by the JAX
package and carried into the port, answers through ``serve_query`` as
JAX's deployment does, while the port's own training deploys, serves
over HTTP and folds in both stages on the CPU."""

import datetime as dt
import http.client
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.ops import twostage as jtwo
from predictionio_tpu.ops.quantize import QuantFactors as JQuant
from predictionio_tpu_torch.controller import TwoStageServing
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.storage.base import App as TApp
from predictionio_tpu_torch.ops import twostage as ttwo
from predictionio_tpu_torch.ops.als import ALSParams
from predictionio_tpu_torch.ops.quantize import QuantFactors as TQuant
from predictionio_tpu_torch.templates.recommendation.engine import (
    ItemScore,
    PredictedResult,
)
from predictionio_tpu_torch.weights import (
    als_model_from_numpy,
    seqrec_model_from_numpy,
)
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

UTC = dt.timezone.utc
CPU = ComputeContext(device="cpu")
FACTORY = "predictionio_tpu_torch.templates.twostage:engine_factory"


def int_problem(seed=0, n=12, m=19, r1=6, r2=5):
    """Integer-valued tables: every score is an exact integer in fp32,
    bf16 and int8 with unit scales, so equality is independent of the
    order of the sums."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, r1)).astype(np.float32)
    Y = rng.integers(-3, 4, size=(m, r1)).astype(np.float32)
    U = rng.integers(-3, 4, size=(n, r2)).astype(np.float32)
    E = rng.integers(-3, 4, size=(m, r2)).astype(np.float32)
    seen = {u: np.unique(rng.choice(m, size=4, replace=False))
            for u in range(0, n, 2)}
    return X, Y, U, E, seen


def float_problem(seed=0, n=14, m=57, r1=6, r2=5):
    rng = np.random.default_rng(seed)
    X, Y, U, E = (rng.standard_normal(s).astype(np.float32) for s in
                  ((n, r1), (m, r1), (n, r2), (m, r2)))
    seen = {u: np.unique(rng.choice(m, size=6, replace=False))
            for u in range(0, n, 3)}
    return X, Y, U, E, seen


def oracle(E, U, seen, uids, k):
    """Brute-force re-rank of the whole catalog: stage-2 scores of every
    item, seen masked, a stable descending sort (ties to the lowest
    id)."""
    s2 = U.astype(np.float64) @ E.astype(np.float64).T
    for u, items in (seen or {}).items():
        if u < len(s2):
            s2[int(u), np.asarray(items)] = -np.inf
    s2 = s2[np.asarray(uids)]
    order = np.argsort(-s2, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(s2, order, axis=1).astype(np.float32)


def port_store(X, Y, U, E, seen, **kw):
    kw.setdefault("candidates", Y.shape[0])
    return ttwo.TwoStageTopK(X, Y, U, E, seen=seen, microbatch=kw.pop(
        "microbatch", False), device="cpu", **kw)


def assert_oracle(store, E, U, seen, k=7):
    uids = np.arange(U.shape[0])
    want_idx, want_vals = oracle(E, U, seen, uids, k)
    got_idx, got_vals = store.twos_topk(uids, k)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_vals, want_vals)
    idx1, vals1 = store.two_topk(3, k)
    keep = np.isfinite(want_vals[3])
    np.testing.assert_array_equal(idx1, want_idx[3][keep])


@pytest.fixture
def precision(monkeypatch):
    monkeypatch.delenv("PIO_SERVING_BACKEND", raising=False)
    monkeypatch.delenv("PIO_TWOSTAGE_N", raising=False)
    monkeypatch.delenv("PIO_FOLDIN", raising=False)

    def set_(mode):
        if mode == "int8":
            monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
        else:
            monkeypatch.setenv("PIO_SERVE_PRECISION", mode)
    return set_


# int8 compares on integer tables only (unit scales)
@pytest.mark.parametrize("mode,tables", [
    ("fp32", "int"), ("fp32", "float"), ("bf16", "int"), ("bf16", "float"),
    ("int8", "int")])
def test_catalog_wide_equals_jax(precision, mode, tables):
    precision(mode)
    X, Y, U, E, seen = (int_problem(seed=1) if tables == "int"
                        else float_problem(seed=2))
    if mode == "int8":
        jargs = [JQuant(a.astype(np.int8), np.ones(len(a), np.float32))
                 for a in (X, Y, U, E)]
        targs = [TQuant(a.astype(np.int8), np.ones(len(a), np.float32))
                 for a in (X, Y, U, E)]
    else:
        jargs = targs = [X, Y, U, E]
    if mode == "bf16" and tables == "float":
        # the store rounds every table to bf16: the oracle reads them so
        r = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa
        X, Y, U, E = (r(a) for a in (X, Y, U, E))
    jst = jtwo.TwoStageTopK(*jargs, seen=seen, candidates=Y.shape[0],
                            microbatch=False, n_users=len(X),
                            n_items=len(Y))
    tst = port_store(*targs, seen=seen, n_users=len(X), n_items=len(Y))
    try:
        assert tst.precision == mode
        uids = np.arange(len(X))
        for k in (1, 5, 16, len(Y)):
            ji, jv = jst.twos_topk(uids, k)
            ti, tv = tst.twos_topk(uids, k)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5,
                                       rtol=1e-5)
            oi, ov = oracle(E, U, seen, uids, k)
            np.testing.assert_array_equal(ti, oi)
        for u in (0, 3, 7):
            a, b = tst.two_topk(u, 6), jst.two_topk(u, 6)
            np.testing.assert_array_equal(a[0], np.asarray(b[0]))
    finally:
        jst.close()
        tst.close()


def test_small_candidate_run_equals_jax(precision):
    """N below the catalog: the re-rank sees only stage 1's top N."""
    precision("fp32")
    X, Y, U, E, seen = float_problem(seed=5, m=200)
    jst = jtwo.TwoStageTopK(X, Y, U, E, seen=seen, candidates=20,
                            microbatch=False)
    tst = port_store(X, Y, U, E, seen, candidates=20)
    try:
        assert tst._n_bucket == jst._n_bucket == 32
        uids = np.arange(len(X))
        for k in (4, 16, 40):
            ji, jv = jst.twos_topk(uids, k)
            ti, tv = tst.twos_topk(uids, k)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5,
                                       rtol=1e-5)
        assert tst.memory_report()["twoStage"] == {"candidates": 20,
                                                   "nBucket": 32}
    finally:
        jst.close()
        tst.close()


def test_mask_applied_exactly_once(precision):
    precision("fp32")
    X, Y, U, E, _ = int_problem(seed=4)
    seen = {5: np.arange(Y.shape[0])}          # user 5 has seen all
    store = port_store(X, Y, U, E, seen)
    try:
        idx, vals = store.two_topk(5, 7)
        assert len(idx) == 0 and len(vals) == 0
        assert_oracle(store, E, U, seen)
    finally:
        store.close()


def test_rerank_seen_lookup_equals_the_pairwise_test():
    """The seen lookup answers as the JAX package's [B, N, L] test."""
    rng = np.random.default_rng(3)
    B, N, L, M = 6, 9, 5, 30
    pos = torch.from_numpy(np.stack([rng.permutation(M)[:N]
                                     for _ in range(B)]).astype(np.int32))
    scq = torch.from_numpy(rng.integers(0, M, (B, L)).astype(np.int32))
    smq = torch.from_numpy((rng.random((B, L)) < 0.6).astype(np.float32))
    E = torch.from_numpy(rng.standard_normal((M, 4)).astype(np.float32))
    S = torch.from_numpy(rng.standard_normal((B, 4)).astype(np.float32))
    vals1 = torch.zeros((B, N))
    v, i = ttwo.twostage_rerank(E, S, vals1, pos, scq, smq, kb=N,
                                mask_seen=True)
    hit = ((pos.numpy()[:, :, None] == scq.numpy()[:, None, :])
           & (smq.numpy()[:, None, :] > 0)).any(-1)
    want_masked = {(b, int(p)) for b in range(B) for n, p in
                   enumerate(pos.numpy()[b]) if hit[b, n]}
    got_masked = {(b, int(i[b, j])) for b in range(B) for j in range(N)
                  if not np.isfinite(float(v[b, j]))}
    assert got_masked == want_masked


def test_patch_seq_users_and_growth(precision):
    precision("fp32")
    X, Y, U, E, seen = int_problem(seed=10)
    store = port_store(X, Y, U, E, seen)
    try:
        U2 = U.copy()
        U2[4] = np.arange(U.shape[1]) - 2
        store.patch_seq_users([4], U2[4:5])
        assert_oracle(store, E, U2, seen)
        cap0 = store.user_capacity
        new_uid = cap0 + 5
        row = np.arange(U.shape[1], dtype=np.float32)[None, :]
        store.patch_seq_users([new_uid], row)
        assert store.user_capacity > cap0 and store.n_users == new_uid + 1
        assert int(store._U.shape[0]) == store.user_capacity
        U3 = np.zeros((new_uid + 1, U.shape[1]), np.float32)
        U3[:len(U2)] = U2
        U3[new_uid] = row[0]
        wi, wv = oracle(E, U3, seen, [new_uid], 5)
        gi, gv = store.twos_topk([new_uid], 5)
        np.testing.assert_array_equal(gi, wi)
        # the stage-1 fold of the same user rides the normal path
        store.patch_users([new_uid], np.ones((1, X.shape[1]), np.float32))
        np.testing.assert_array_equal(store.twos_topk([new_uid], 5)[0], wi)
        # a seen update through the stage-2 patch
        idx0, _ = store.two_topk(1, 3)
        store.patch_seq_users([1], U2[1:2],
                              seen_items={1: np.asarray([int(idx0[0])])})
        seen2 = dict(seen)
        seen2[1] = np.asarray([int(idx0[0])])
        assert_oracle(store, E, U3[:len(U2)], seen2)
        # the stage-1 growth keeps the stage-2 table as wide
        store.patch_users([store.user_capacity + 3],
                          np.ones((1, X.shape[1]), np.float32))
        assert int(store._U.shape[0]) == store.user_capacity
        with pytest.raises(ValueError, match="rank"):
            store.patch_seq_users([0], np.zeros((1, 9), np.float32))
    finally:
        store.close()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_patch_seq_users_in_narrow_stores_equals_jax(precision, mode):
    precision(mode)
    X, Y, U, E, seen = int_problem(seed=14)
    if mode == "int8":
        mk = lambda Q: [Q(a.astype(np.int8), np.ones(len(a), np.float32))  # noqa
                        for a in (X, Y, U, E)]
        jargs, targs = mk(JQuant), mk(TQuant)
    else:
        jargs = targs = [X, Y, U, E]
    jst = jtwo.TwoStageTopK(*jargs, seen=seen, candidates=len(Y),
                            microbatch=False, n_users=len(X),
                            n_items=len(Y))
    tst = port_store(*targs, seen=seen, n_users=len(X), n_items=len(Y))
    try:
        rng = np.random.default_rng(2)
        rows = rng.standard_normal((3, U.shape[1])).astype(np.float32)
        for st in (jst, tst):
            st.patch_seq_users([2, 5, 30], rows,
                               seen_items={30: np.asarray([1, 2])})
        uids = np.asarray([0, 2, 5, 7, 30])
        ji, jv = jst.twos_topk(uids, 8)
        ti, tv = tst.twos_topk(uids, 8)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            tst.seq_item_factors.numpy(), np.asarray(jst.seq_item_factors),
            atol=0, rtol=0)
    finally:
        jst.close()
        tst.close()


def test_hammer_queries_during_patches(precision):
    precision("fp32")
    X, Y, U, E, seen = int_problem(seed=18, n=16, m=23)
    store = port_store(X, Y, U, E, seen, microbatch=True)
    errors = []
    stop = threading.Event()

    def query_loop(tid):
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                if rng.integers(2):
                    _, vals = store.two_topk(int(rng.integers(0, 16)), 5)
                    assert np.isfinite(vals).all()
                else:
                    idx, _ = store.twos_topk(rng.integers(0, 16, size=4), 5)
                    assert idx.shape == (4, 5)
        except Exception as e:  # pragma: no cover - the failure path
            errors.append(e)

    threads = [threading.Thread(target=query_loop, args=(t,))
               for t in range(4)]
    try:
        store.warmup()
        for t in threads:
            t.start()
        rng = np.random.default_rng(99)
        U_final = U.copy()
        for step in range(30):
            uid = int(rng.integers(0, 16))
            if step % 2:
                row = rng.integers(-3, 4, size=(1, U.shape[1])).astype(
                    np.float32)
                store.patch_seq_users([uid], row)
                U_final[uid] = row[0]
            else:
                store.patch_users([uid], rng.integers(
                    -3, 4, size=(1, X.shape[1])).astype(np.float32))
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[:3]
        assert_oracle(store, E, U_final, seen, k=5)
        assert store.stats()["two"]["dispatches"] > 0
    finally:
        stop.set()
        store.close()


# -- build_two_stage_store ---------------------------------------------------------

def fake_models(n=6, m=9, r1=4, r2=3):
    rng = np.random.default_rng(3)
    retrieval = types.SimpleNamespace(
        user_factors=rng.normal(size=(n, r1)).astype(np.float32),
        item_factors=rng.normal(size=(m, r1)).astype(np.float32),
        user_map=list(range(n)), item_map=list(range(m)), seen=None,
        device="cpu")
    rerank = types.SimpleNamespace(
        user_vectors=rng.normal(size=(n, r2)).astype(np.float32),
        item_vectors=rng.normal(size=(m, r2)).astype(np.float32),
        user_map=list(range(n)), item_map=list(range(m)))
    return retrieval, rerank


def test_build_store_checks(precision, monkeypatch):
    precision("fp32")
    retrieval, rerank = fake_models()
    store = ttwo.build_two_stage_store(retrieval, rerank, candidates=9)
    try:
        assert store.device.type == "cpu"
        assert store.twos_topk([0, 1], 4)[0].shape == (2, 4)
    finally:
        store.close()
    monkeypatch.setenv("PIO_TWOSTAGE_N", "7")
    assert ttwo.build_two_stage_store(retrieval, rerank)._candidates == 7
    monkeypatch.setenv("PIO_TWOSTAGE_N", "x")
    with pytest.raises(ValueError, match="not an integer"):
        ttwo.build_two_stage_store(retrieval, rerank)
    monkeypatch.delenv("PIO_TWOSTAGE_N")
    assert ttwo.build_two_stage_store(retrieval, rerank)._candidates == \
        ttwo.DEFAULT_CANDIDATES == jtwo.DEFAULT_CANDIDATES
    with pytest.raises(ValueError, match="FIRST algorithm"):
        ttwo.build_two_stage_store(rerank, rerank)
    with pytest.raises(ValueError, match="LAST algorithm"):
        ttwo.build_two_stage_store(retrieval, retrieval)
    short = types.SimpleNamespace(**{**vars(rerank),
                                     "item_map": list(range(5))})
    with pytest.raises(ValueError, match="one shared item map"):
        ttwo.build_two_stage_store(retrieval, short)
    short = types.SimpleNamespace(**{**vars(rerank),
                                     "user_map": list(range(5))})
    with pytest.raises(ValueError, match="one shared user map"):
        ttwo.build_two_stage_store(retrieval, short)
    monkeypatch.setenv("PIO_SERVING_BACKEND", "host")
    with pytest.raises(ValueError, match="two-stage serving conflicts "
                                         "with PIO_SERVING_BACKEND=host"):
        ttwo.build_two_stage_store(retrieval, rerank)
    monkeypatch.delenv("PIO_SERVING_BACKEND")
    monkeypatch.setenv("PIO_FOLDIN", "on")
    with pytest.raises(ValueError, match="fold_in_rows"):
        ttwo.build_two_stage_store(retrieval, rerank)
    rerank.fold_in_rows = lambda *a, **kw: None
    ttwo.build_two_stage_store(retrieval, rerank).close()
    with pytest.raises(ValueError, match=">= 1"):
        port_store(*int_problem()[:4], None, candidates=0)


def test_stage2_tables_must_cover_the_catalog(precision):
    precision("fp32")
    X, Y, U, E, seen = int_problem()
    with pytest.raises(ValueError, match="shared item map"):
        port_store(X, Y, U, E[:5], seen)
    with pytest.raises(ValueError, match="shared user map"):
        port_store(X, Y, U[:3], E, seen)


# -- TwoStageServing -----------------------------------------------------------

def pred(pairs):
    return PredictedResult(tuple(ItemScore(item=i, score=s)
                                 for i, s in pairs))


def test_serving_composes_on_the_host_and_binds_a_route():
    from predictionio_tpu.controller.controllers import (
        TwoStageServing as JServing,
    )
    from predictionio_tpu.templates.recommendation.engine import (
        ItemScore as JItem,
        PredictedResult as JPred,
    )

    head = [("a", 3.0), ("b", 2.0), ("c", 1.0), ("d", 0.5)]
    tail = [("b", 10.0), ("c", 5.0), ("d", 5.0)]
    out = TwoStageServing().serve(None, [pred(head), pred(tail)])
    jout = JServing().serve(None, [
        JPred(tuple(JItem(i, s) for i, s in head)),
        JPred(tuple(JItem(i, s) for i, s in tail))])
    assert [(s.item, s.score) for s in out.item_scores] == \
        [(s.item, s.score) for s in jout.item_scores] == \
        [("b", 10.0), ("c", 5.0), ("d", 5.0), ("a", 3.0)]
    single = pred(head)
    assert TwoStageServing().serve(None, [single]) is single
    serving = TwoStageServing()
    assert not serving.fused_bound
    calls = []
    serving.bind_fused(lambda q: calls.append(q) or "fused")
    assert serving.fused_bound and serving.serve_fused("q") == "fused"
    assert calls == ["q"]


# -- the composite fold-in ----------------------------------------------------------

def test_composite_fold_in_attaches_both_stages_under_one_lock(precision):
    from predictionio_tpu_torch.online.foldin import (
        CompositeFoldInConsumer,
        attach_foldin,
    )

    class Map:
        def __init__(self):
            self._m = {"u0": 0}

        def __len__(self):
            return len(self._m)

        def get(self, k):
            return self._m.get(k)

        def append(self, labels):
            for k in labels:
                if k in self._m:
                    raise ValueError(f"label {k!r} already mapped")
                self._m[k] = len(self._m)

    shared = Map()
    m1 = types.SimpleNamespace(user_map=shared, item_map=Map(),
                               device_server=lambda: None)
    m2 = types.SimpleNamespace(user_map=shared, item_map=Map(),
                               device_server=lambda: None,
                               fold_in_rows=lambda *a: None)
    dep = types.SimpleNamespace(models=[m1, m2], engine_params=(
        types.SimpleNamespace(
            algorithm_params_list=[("als", ALSParams()), ("seq", object())],
            data_source_params=("", types.SimpleNamespace(
                app_name="app", channel_name=None, event_names=("view",))),
            preparator_params=("", types.SimpleNamespace(max_len=None)))))
    c = attach_foldin(dep)
    assert isinstance(c, CompositeFoldInConsumer) and len(c.consumers) == 2
    c1, c2 = c.consumers
    assert c1._patch_lock is c2._patch_lock
    calls = []
    server = types.SimpleNamespace(
        patch_users=lambda idx, rows, seen_items=None:
            calls.append(np.asarray(idx).tolist()))
    rows = np.zeros((1, 2), dtype=np.float32)
    cols = [np.asarray([1, 2], dtype=np.int64)]
    assert c1._patch(server, ["u9"], cols, rows) == (0, 1)
    assert c2._patch(server, ["u9"], cols, rows) == (1, 0)
    assert calls == [[1], [1]] and len(shared) == 2


# -- the twostage engine -------------------------------------------------------------

APP = "twoapp"
N_ITEMS = 30
T0 = dt.datetime(2024, 1, 1, tzinfo=UTC)


def walk_events(Event, n_users=30, seed=0):
    rng = np.random.default_rng(seed)
    evs = []
    for u in range(n_users):
        start, stride = int(rng.integers(0, N_ITEMS)), int(rng.integers(1, 4))
        for j in range(int(rng.integers(4, 14))):
            evs.append(Event(
                event="view", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"i{(start + stride * j) % N_ITEMS}",
                event_time=T0 + dt.timedelta(minutes=j + 100 * u)))
    return evs


@pytest.fixture
def engine_stores(precision):
    precision("fp32")
    for st, App, Event in ((jstorage, JApp, JEvent),
                           (tstorage, TApp, TEvent)):
        st.reset(st.StorageConfig(
            sources={"S": {"type": "memory"}},
            repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                           "MODELDATA")}))
        aid = st.get_metadata_apps().insert(App(0, APP))
        st.get_levents().init(aid)
        st.get_levents().insert_batch(walk_events(Event), aid)
    yield
    jstorage.reset()
    tstorage.reset()


def variant(factory, steps=40):
    return {"id": "default", "engineFactory": factory,
            "datasource": {"params": {"appName": APP}},
            "preparator": {"params": {"maxSeqLen": 16}},
            "algorithms": [
                {"name": "als", "params": {"rank": 6, "numIterations": 4,
                                           "seed": 3}},
                {"name": "seqrec", "params": {
                    "rank": 8, "nLayers": 1, "nHeads": 2, "numSteps": steps,
                    "batchSize": 16, "nNegatives": 8, "maxSeqLen": 16,
                    "learningRate": 0.01, "seed": 7}}]}


QUERIES = [{"user": f"u{u}", "num": n} for u, n in
           ((0, 5), (4, 10), (9, 3), (17, 30), (29, 6))] + [
    {"user": "u3", "num": 4, "blacklist": ["i1", "i2"]},
    {"user": "nobody", "num": 4}]


def test_engine_carried_from_jax_answers_as_jax(engine_stores):
    from predictionio_tpu.templates import twostage as jts
    from predictionio_tpu.templates.recommendation.engine import (
        Query as JQuery,
    )
    import importlib

    from predictionio_tpu_torch.templates import twostage as tts

    jserver = importlib.import_module(
        "predictionio_tpu.workflow.create_server")
    jcw = importlib.import_module("predictionio_tpu.workflow.create_workflow")

    jf = "predictionio_tpu.templates.twostage:engine_factory"
    iid = jcw.create_workflow(jcw.WorkflowConfig(engine_factory=jf),
                              variant(jf))
    jdep = jserver.build_deployment(jserver.resolve_engine_instance(iid),
                                    None)
    jals, jseqm = jdep.models
    assert jdep.serving.fused_bound
    als = als_model_from_numpy(
        jals.user_factors, jals.item_factors, list(jals.user_map.labels),
        list(jals.item_map.labels), jals.seen, device="cpu")
    seq = seqrec_model_from_numpy(
        jseqm.theta, jseqm.user_vectors, list(jseqm.user_map.labels),
        list(jseqm.item_map.labels), jseqm.seen, jseqm.enc_params,
        device="cpu")
    engine = tts.engine_factory()
    dep = tserver.deployment_from_models(
        engine, engine.engine_params_from_variant(variant(FACTORY)),
        [als, seq])
    assert dep.serving.fused_bound
    assert isinstance(als._server, ttwo._TwoStageFacet)
    assert isinstance(seq._server, ttwo._SeqStoreFacet)
    assert als.serve_positive_scores_only is False
    tserver.warm_up(dep)
    for q in QUERIES:
        got = tserver.serve_query(dep, tserver.query_from_json(
            q, dep.algorithms[0].query_class))
        want = jserver.serve_query(jdep, JQuery(
            user=q["user"], num=q["num"],
            blacklist=tuple(q.get("blacklist", ()))))
        assert [s.item for s in got.item_scores] == \
            [s.item for s in want.item_scores]
        np.testing.assert_allclose([s.score for s in got.item_scores],
                                   [s.score for s in want.item_scores],
                                   atol=1e-5, rtol=1e-5)
    st = als._server.stats()
    assert st["two"]["dispatches"] >= len(QUERIES) - 1
    als._server.close()


def post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def test_engine_trains_deploys_and_folds_in_both_stages(engine_stores,
                                                        monkeypatch):
    from predictionio_tpu_torch.ops.serving import QueryRejectedError  # noqa

    monkeypatch.setenv("PIO_FOLDIN_INTERVAL", "0.2")
    iid = tcw.create_workflow(tcw.WorkflowConfig(engine_factory=FACTORY),
                              variant(FACTORY), ctx=CPU)
    dep = tserver.build_deployment(tserver.resolve_engine_instance(iid), CPU)
    als, seq = dep.models
    assert als.user_map is seq.user_map and als.item_map is seq.item_map
    assert dep.serving.fused_bound
    srv = tserver.QueryServer(tserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True), dep).start()
    try:
        status, before = post(srv.address, "/queries.json",
                              {"user": "u2", "num": 5})
        assert status == 200 and len(before["itemScores"]) == 5
        store = als._server.store
        le = tstorage.get_levents()
        aid = tstorage.get_metadata_apps().get_by_name(APP).id
        new = ["i20", "i21", "i22"]
        le.insert_batch([TEvent(
            event="view", entity_type="user", entity_id=who,
            target_entity_type="item", target_entity_id=it,
            event_time=T0 + dt.timedelta(days=30, minutes=j))
            for who in ("u2", "fresh") for j, it in enumerate(new)], aid)
        deadline = time.time() + 30
        while time.time() < deadline:
            st = srv._foldin.stats()
            if all(t["usersPatched"] >= 2 and t["pendingEvents"] == 0
                   for t in st["targets"]):
                break
            time.sleep(0.05)
        assert len(srv._foldin.consumers) == 2
        fresh = als.user_map["fresh"]
        # both stages hold the new user's rows
        assert store.n_users >= fresh + 1
        assert np.abs(store._X[fresh].numpy()).sum() > 0
        want = seq.fold_in_rows(
            [np.asarray([als.item_map[i] for i in new])], [None])[0]
        np.testing.assert_allclose(store._U[fresh].numpy(), want, atol=1e-6)
        status, ans = post(srv.address, "/queries.json",
                           {"user": "fresh", "num": 5})
        assert status == 200 and len(ans["itemScores"]) == 5
        assert {s["item"] for s in ans["itemScores"]}.isdisjoint(new)
        status, stats = 200, srv.stats_json()
        assert any(b["batcher"] == "pio-microbatch-two"
                   for b in stats["batchers"])
    finally:
        srv.stop()
