"""The port's two-stage serving over shards against the JAX package's,
on the CPU: the port on four logical shards of one device
(``["cpu"] * 4``), JAX on four devices of its forced host platform
(conftest), both over one density-aware item layout.

Mirrors JAX ``tests/test_twostage.py``'s sharded cases: at N = the
catalog the sharded store equals a brute-force re-rank of the whole
catalog and JAX's sharded store on fp32, bf16 and int8 tables; below
the catalog the candidate run crosses shards and equals the single
store's and JAX's; a composite fold grows and reshards both stages;
stage 1 launches B1 once per shard, unmasked, at k = the N bucket;
``memory_report`` covers the shards; a ``ShardedALSModel`` retrieval
model builds the store; the ``twostage`` template deployed over a
four-device context with ``PIO_SERVE_SHARDS=4`` answers as the
one-device deployment does.

Tolerances: integer-valued tables make every score exact (ids, ties
included, and scores EQUAL); continuous tables ids equal, scores 1e-5.
"""

import types

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import twostage as jtwo
from predictionio_tpu.ops.quantize import QuantFactors as JQuant
from predictionio_tpu.parallel import als_sharding as jshard
from predictionio_tpu_torch.core.context import ComputeContext, workflow_context
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.storage.base import App as TApp
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.ops import twostage as ttwo
from predictionio_tpu_torch.ops.quantize import QuantFactors as TQuant
from predictionio_tpu_torch.parallel import als_sharding as tshard
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw
from test_torch_twostage import (
    APP,
    FACTORY,
    float_problem,
    int_problem,
    oracle,
    variant,
    walk_events,
)

pytestmark = pytest.mark.multichip

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("PIO_SERVING_BACKEND", "PIO_SERVE_PRECISION", "PIO_FOLDIN",
                 "PIO_SERVE_SHARDS", "PIO_TWOSTAGE_N"):
        monkeypatch.delenv(name, raising=False)


def layouts(seen, m, shards=4):
    counts = np.zeros(m, np.int64)
    for v in seen.values():
        np.add.at(counts, np.asarray(v), 1)
    return (tshard.density_aware_item_layout(counts, shards),
            jshard.density_aware_item_layout(counts, shards))


def pair(X, Y, U, E, seen, candidates=None, quant=False, **kw):
    """The port's store on ``CPU4`` and JAX's on its four devices, over
    one layout; ``quant``: int8 tables with unit scales."""
    tl, jl = layouts(seen, len(Y))
    tabs = [X, Y, U, E]
    if quant:
        jt = [JQuant(a.astype(np.int8), np.ones(len(a), np.float32))
              for a in tabs]
        tt = [TQuant(a.astype(np.int8), np.ones(len(a), np.float32))
              for a in tabs]
        kw.update(n_users=len(X), n_items=len(Y))
    else:
        jt = tt = tabs
    cand = candidates or len(Y)
    tst = ttwo.TwoStageTopK(*tt, seen=seen, candidates=cand,
                            microbatch=False, device=CPU4, item_layout=tl,
                            **kw)
    jst = jtwo.TwoStageTopK(*jt, seen=seen, candidates=cand,
                            microbatch=False, item_layout=jl, **kw)
    return tst, jst


@pytest.mark.parametrize("mode,tables", [
    ("fp32", "int"), ("fp32", "float"), ("bf16", "int"), ("bf16", "float"),
    ("int8", "int")])
def test_sharded_store_equals_jax_and_the_brute_force_re_rank(
        multichip_devices, monkeypatch, mode, tables):
    if mode != "int8":
        monkeypatch.setenv("PIO_SERVE_PRECISION", mode)
    X, Y, U, E, seen = (int_problem(seed=5) if tables == "int"
                        else float_problem(seed=6))
    tst, jst = pair(X, Y, U, E, seen, quant=mode == "int8")
    if mode == "bf16" and tables == "float":
        # the store rounds every table to bf16: the oracle reads them so
        r = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa
        U, E = r(U), r(E)
    try:
        assert tst.shard_count == 4 and tst.precision == mode
        assert not np.array_equal(tst.item_layout.perm[:len(Y)],
                                  np.arange(len(Y)))   # a permuted store
        uids = np.arange(len(X))
        exact = tables == "int"
        for k in (1, 5, 16, len(Y)):
            ti, tv = tst.twos_topk(uids, k)
            ji, jv = jst.twos_topk(uids, k)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            if exact:
                np.testing.assert_array_equal(tv, np.asarray(jv))
            else:
                np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5,
                                           rtol=1e-5)
            oi, ov = oracle(E, U, seen, uids, k)
            np.testing.assert_array_equal(ti, oi)
        for u in (0, 3, 7):
            a, b = tst.two_topk(u, 6), jst.two_topk(u, 6)
            np.testing.assert_array_equal(a[0], np.asarray(b[0]))
        np.testing.assert_array_equal(tst.seq_item_factors.numpy(),
                                      np.asarray(jst.seq_item_factors))
    finally:
        tst.close()
        jst.close()


def test_candidate_run_crosses_shards(multichip_devices):
    """N = 8 of 41 items: the stage-1 run gathers candidates from every
    shard; the answers equal the single store's and JAX's sharded
    store's."""
    X, Y, U, E, seen = float_problem(seed=7, n=16, m=41)
    tst, jst = pair(X, Y, U, E, seen, candidates=8)
    single = ttwo.TwoStageTopK(X, Y, U, E, seen=seen, candidates=8,
                               microbatch=False, device="cpu")
    try:
        uids = np.arange(len(X))
        for k in (3, 6, 8):
            ti, tv = tst.twos_topk(uids, k)
            si, sv = single.twos_topk(uids, k)
            ji, jv = jst.twos_topk(uids, k)
            np.testing.assert_array_equal(ti, si)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_allclose(tv, sv, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5,
                                       rtol=1e-5)
        layout = tst.item_layout
        winners = np.unique(ti[np.isfinite(tv)])
        assert len({int(layout.inv[it]) // layout.cap for it in winners}) > 1
    finally:
        for st in (tst, jst, single):
            st.close()


def test_stage_one_launches_b1_once_per_shard_unmasked_at_n(
        multichip_devices, monkeypatch):
    X, Y, U, E, seen = float_problem(seed=8, m=200)
    tst, jst = pair(X, Y, U, E, seen, candidates=20)
    jst.close()
    calls = []
    b1 = tserving.fused_gather_score_topk

    def counted(*a, **kw):
        calls.append((kw["k"], kw["mask_seen"], kw["n_items"]))
        return b1(*a, **kw)

    monkeypatch.setattr(tserving, "fused_gather_score_topk", counted)
    try:
        tst.twos_topk(np.arange(5), 10)
        # the N bucket: 20 candidates round up to 32
        assert calls == [(32, False, tst.item_layout.cap)] * 4
        assert not tst.stage_times      # no CUDA events on the CPU
    finally:
        tst.close()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_composite_fold_grows_and_reshards_both_stages(multichip_devices,
                                                       quant):
    X, Y, U, E, seen = int_problem(seed=9)
    tst, jst = pair(X, Y, U, E, seen, quant=quant)
    try:
        cap0 = tst.user_capacity
        assert cap0 == jst.user_capacity
        new = cap0 + 3                # past the capacity: both stages grow
        rng = np.random.default_rng(11)
        x_rows = rng.integers(-3, 4, (2, X.shape[1])).astype(np.float32)
        u_rows = rng.integers(-3, 4, (2, U.shape[1])).astype(np.float32)
        uids = np.asarray([2, new])
        fold_seen = {2: np.asarray([0, 5]), new: np.asarray([1, 2, 3])}
        for st in (tst, jst):
            st.patch_users(uids, x_rows, seen_items=fold_seen)
            st.patch_seq_users(uids, u_rows, seen_items=fold_seen)
        assert tst.user_capacity == jst.user_capacity > cap0
        assert tst.user_capacity % 4 == 0       # resharded rows
        assert int((tst._U.data if quant else tst._U).shape[0]) \
            == tst.user_capacity
        q = np.arange(new + 1)
        for k in (4, len(Y)):
            ti, tv = tst.twos_topk(q, k)
            ji, jv = jst.twos_topk(q, k)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            np.testing.assert_array_equal(tv, np.asarray(jv))
        if quant:   # the patched rows requantize with their own scales
            return
        U2 = np.zeros((new + 1, U.shape[1]), np.float32)
        U2[:len(U)] = U
        U2[uids] = u_rows
        seen2 = {**seen, **fold_seen}
        oi, _ = oracle(E, U2, seen2, q, len(Y))
        np.testing.assert_array_equal(tst.twos_topk(q, len(Y))[0], oi)
    finally:
        tst.close()
        jst.close()


def test_memory_report_covers_the_shards(multichip_devices):
    X, Y, U, E, seen = int_problem(seed=12)
    tst, jst = pair(X, Y, U, E, seen)
    try:
        rep, jrep = tst.memory_report(), jst.memory_report()
        assert rep["nShards"] == 4 and len(rep["shards"]) == 4
        assert {"stage2ItemVectors", "stage2UserVectors"} <= set(
            rep["components"])
        assert rep.pop("kernel") == "fused"
        jrep.pop("kernel")
        assert rep == jrep
    finally:
        tst.close()
        jst.close()


def test_sharded_retrieval_model_builds_the_store():
    """A ``ShardedALSModel`` (factor tables on a mesh) as the retrieval
    model: its tables are gathered on the mesh's first device and the
    store spans the mesh with the model's layout."""
    from predictionio_tpu_torch.data.bimap import StringIndexBiMap
    from predictionio_tpu_torch.parallel import P, data_parallel_mesh
    from predictionio_tpu_torch.parallel.distributed import make_global_array
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ShardedALSModel,
    )

    X, Y, U, E, seen = int_problem(seed=13, n=12, m=20)
    mesh = data_parallel_mesh(devices=CPU4)
    tl, _ = layouts(seen, len(Y))
    users = StringIndexBiMap.from_distinct(
        np.asarray([f"u{i:02d}" for i in range(len(X))]))
    items = StringIndexBiMap.from_distinct(
        np.asarray([f"i{i:02d}" for i in range(len(Y))]))
    model = ShardedALSModel(
        make_global_array(mesh, P("data", None), X),
        make_global_array(mesh, P("data", None), Y), len(X), len(Y), users,
        items, seen, item_layout=tl)
    rerank = types.SimpleNamespace(user_vectors=U, item_vectors=E,
                                   user_map=users, item_map=items)
    store = ttwo.build_two_stage_store(model, rerank, candidates=len(Y))
    try:
        assert store.shard_count == 4 and store.item_layout is tl
        assert store.n_users == len(X) and store.n_items == len(Y)
        uids = np.arange(len(X))
        oi, ov = oracle(E, U, seen, uids, 7)
        gi, gv = store.twos_topk(uids, 7)
        np.testing.assert_array_equal(gi, oi)
        np.testing.assert_array_equal(gv, ov)
    finally:
        store.close()


@pytest.fixture
def engine_store(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PRECISION", "fp32")
    tstorage.reset(tstorage.StorageConfig(
        sources={"S": {"type": "memory"}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}))
    aid = tstorage.get_metadata_apps().insert(TApp(0, APP))
    tstorage.get_levents().init(aid)
    tstorage.get_levents().insert_batch(walk_events(TEvent), aid)
    yield
    tstorage.reset()


def test_template_on_four_shards_answers_as_one_device(engine_store,
                                                       monkeypatch):
    iid = tcw.create_workflow(tcw.WorkflowConfig(engine_factory=FACTORY),
                              variant(FACTORY),
                              ctx=ComputeContext(device="cpu"))
    inst = tserver.resolve_engine_instance(iid)
    one = tserver.build_deployment(inst, ComputeContext(device="cpu"))
    monkeypatch.setenv("PIO_SERVE_SHARDS", "4")
    four = tserver.build_deployment(inst, workflow_context(
        mode="serving", device="cpu", devices=CPU4))
    try:
        stores = [dep.models[0].device_server().store for dep in (one, four)]
        assert [s.shard_count for s in stores] == [1, 4]
        assert all(dep.serving.fused_bound for dep in (one, four))
        queries = [{"user": f"u{u}", "num": n}
                   for u, n in ((0, 5), (4, 10), (9, 3), (17, 30), (29, 6))]
        queries += [{"user": "u3", "num": 4, "blacklist": ["i1", "i2"]},
                    {"user": "nobody", "num": 4}]
        for q in queries:
            got, want = (tserver.to_jsonable(tserver.serve_query(dep, q))
                         ["itemScores"] for dep in (four, one))
            assert [g["item"] for g in got] == [w["item"] for w in want], q
            np.testing.assert_allclose([g["score"] for g in got],
                                       [w["score"] for w in want],
                                       rtol=1e-5, atol=1e-6)
    finally:
        for dep in (one, four):
            dep.models[0].device_server().close()
