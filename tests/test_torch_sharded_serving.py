"""The port's sharded serving store against the JAX package's, on the
CPU: the port on four logical shards of one device (``["cpu"] * 4``),
JAX on four devices of its forced host platform (conftest).

Mirrors JAX ``tests/test_sharded_serving.py``: ``TestItemShardLayout``
(the layouts byte-equal to JAX's), ``TestShardedServingDifferential``
(its AOT-ladder case is ``tests/test_torch_aot_ladder.py``), ``TestShardedFoldIn``
and ``TestShardMemoryReport``. Every lane is held to the port's own
single store and to JAX's sharded store. A deployment serves over the
plane of the ``ComputeContext`` it is given.

Tolerances: integer-valued factors (an int8 row scale pinned to 1 by a
column of +-127) make every score exact, so positions, ids and scores
must be EQUAL, ties included: a tie goes to the lower store position in
both packages (the lower shard, then the lower local row). Continuous
factors agree to 1e-5 relative. The per-shard scorer
(``_sharded_score_topk``) is compared on store positions directly, on
JAX's XLA chain and on its Pallas kernel in interpret mode.
"""

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import serving as jserving
from predictionio_tpu.parallel import als_sharding as jshard
from predictionio_tpu_torch.core.context import workflow_context
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.parallel import als_sharding as tshard
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw
from test_torch_lifecycle import (  # noqa: F401
    CPU,
    FACTORIES,
    stores,
    variant,
)

pytestmark = pytest.mark.multichip

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("PIO_SERVING_BACKEND", "PIO_SERVE_PRECISION", "PIO_FOLDIN",
                 "PIO_SERVE_SHARDS", "PIO_SERVE_KERNEL"):
        monkeypatch.delenv(name, raising=False)


def _power_law_counts(n_items, nnz, seed=0, exp=0.8):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_items + 1) ** exp
    p /= p.sum()
    return np.bincount(rng.choice(n_items, size=nnz, p=p),
                       minlength=n_items).astype(np.int64)


def _same_layout(t, j):
    for name in ("perm", "inv", "counts_per_shard"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (t.n_shards, t.n_items, t.n_positions, t.cap) == \
        (j.n_shards, j.n_items, j.n_positions, j.cap)
    assert t.valid_mask().tobytes() == j.valid_mask().tobytes()
    assert t.balance_report() == j.balance_report()
    assert t.to_json() == j.to_json()


# ---------------------------------------------------------------------------
# The layout itself
# ---------------------------------------------------------------------------

class TestItemShardLayout:
    @pytest.mark.parametrize("n_items,nnz,shards", [
        (37, 5000, 4), (50, 4000, 4), (400, 100_000, 4), (23, 900, 3),
        (10, 100, 4), (1, 5, 2), (26_744, 200_000, 4)])
    def test_density_layout_byte_equal_to_jax(self, n_items, nnz, shards):
        counts = _power_law_counts(n_items, nnz)
        _same_layout(tshard.density_aware_item_layout(counts, shards),
                     jshard.density_aware_item_layout(counts, shards))

    @pytest.mark.parametrize("n_items,shards,with_counts", [
        (37, 4, True), (400, 4, False), (9, 2, True), (26_744, 4, True)])
    def test_contiguous_layout_byte_equal_to_jax(self, n_items, shards,
                                                 with_counts):
        counts = _power_law_counts(n_items, 10 * n_items) \
            if with_counts else None
        _same_layout(tshard.contiguous_item_layout(n_items, shards, counts),
                     jshard.contiguous_item_layout(n_items, shards, counts))

    def test_permutation_is_a_bijection_over_items(self):
        counts = _power_law_counts(37, 5000)
        lay = tshard.density_aware_item_layout(counts, 4)
        real = lay.perm[lay.perm >= 0]
        assert sorted(real.tolist()) == list(range(37))
        assert (lay.perm[lay.inv] == np.arange(37)).all()
        assert lay.n_positions % lay.n_shards == 0

    def test_capacity_bound_holds(self):
        counts = _power_law_counts(50, 4000)
        lay = tshard.density_aware_item_layout(counts, 4)
        assert (lay.items_per_shard <= lay.cap).all()
        assert int(lay.items_per_shard.sum()) == 50

    def test_beats_contiguous_on_power_law(self):
        counts = _power_law_counts(400, 100_000)
        d = tshard.density_aware_item_layout(counts, 4).balance_report()
        c = tshard.contiguous_item_layout(400, 4, counts=counts) \
            .balance_report()
        assert c["maxOverMeanInteractions"] > 1.5
        assert d["maxOverMeanInteractions"] < 1.05

    def test_zero_counts_degenerate(self):
        lay = tshard.density_aware_item_layout(np.zeros(10, np.int64), 4)
        assert int(lay.items_per_shard.sum()) == 10
        assert lay.balance_report()["maxOverMeanInteractions"] is None

    def test_json_round_trip_reads_jax_json(self):
        counts = _power_law_counts(23, 900)
        jlay = jshard.density_aware_item_layout(counts, 4)
        back = tshard.ItemShardLayout.from_json(
            json.loads(json.dumps(jlay.to_json())))
        _same_layout(back, jlay)

    def test_valid_mask_marks_pad_slots(self):
        lay = tshard.density_aware_item_layout(_power_law_counts(10, 100), 4)
        v = lay.valid_mask()
        assert v.sum() == 10
        assert ((lay.perm >= 0) == (v > 0)).all()


@pytest.mark.parametrize("bucketed", [False, True])
def test_item_interaction_counts_equal_jax(bucketed):
    from predictionio_tpu.ops import als as jals
    from predictionio_tpu_torch.ops import als as tals

    rng = np.random.default_rng(3)
    rows = rng.integers(0, 30, 400)
    cols = rng.integers(0, 50, 400)
    vals = rng.integers(1, 6, 400).astype(np.float32)
    if bucketed:
        t = tals.bucket_ratings(cols, rows, vals, 50, 30)
        j = jals.bucket_ratings(cols, rows, vals, 50, 30)
    else:
        t = tals.pad_ratings(cols, rows, vals, 50, 30)
        j = jals.pad_ratings(cols, rows, vals, 50, 30)
    got = tals.item_interaction_counts(t)
    np.testing.assert_array_equal(got, jals.item_interaction_counts(j))
    if bucketed:  # tables on a device count the same
        np.testing.assert_array_equal(
            tals.item_interaction_counts(t.to_device("cpu")), got)


# ---------------------------------------------------------------------------
# The per-shard scorer, on store positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mask_seen", [True, False])
def test_sharded_scorer_positions_equal_jax(multichip_devices, fused,
                                            mask_seen):
    import jax.numpy as jnp

    from predictionio_tpu.parallel.mesh import data_parallel_mesh

    rng = np.random.default_rng(4)
    cap, R, B, L, k = 24, 8, 5, 6, 10
    n_pos = 4 * cap
    Y = rng.normal(size=(n_pos, R)).astype(np.float32)
    valid = (rng.random(n_pos) > 0.15).astype(np.float32)
    Q = rng.normal(size=(B, R)).astype(np.float32)
    sc = rng.integers(0, n_pos, (B, L)).astype(np.int32)
    sm = (rng.random((B, L)) > 0.3).astype(np.float32)
    jv, jp = jserving._sharded_score_topk(
        jnp.asarray(Y), jnp.asarray(valid), jnp.asarray(Q), jnp.asarray(sc),
        jnp.asarray(sm), k=k, mask_seen=mask_seen, mode="fp32",
        mesh=data_parallel_mesh(4), axis="data", fused=fused,
        interpret=True)
    shards = [tserving._ItemShard(torch.from_numpy(Y[s * cap:(s + 1) * cap]),
                                  torch.from_numpy(valid[s * cap:
                                                         (s + 1) * cap]),
                                  s * cap, torch.device("cpu"))
              for s in range(4)]
    tv, tp = tserving._sharded_score_topk(
        shards, torch.from_numpy(Q), torch.from_numpy(sc),
        torch.from_numpy(sm), k=k, mask_seen=mask_seen)
    jv, jp, tv, tp = (np.asarray(a) for a in (jv, jp, tv, tp))
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_array_equal(tp[fin], jp[fin])
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5)
    assert (valid[tp[fin]] > 0).all()


def test_tree_merge_prefers_the_lower_shard_on_ties():
    vals = [torch.tensor([[3.0, 1.0]]), torch.tensor([[3.0, 2.0]]),
            torch.tensor([[2.0, 1.0]])]
    idx = [torch.tensor([[4, 0]], dtype=torch.int32),
           torch.tensor([[10, 12]], dtype=torch.int32),
           torch.tensor([[20, 21]], dtype=torch.int32)]
    v, i = tserving._tree_merge_topk(vals, idx, 4)
    assert v.tolist() == [[3.0, 3.0, 2.0, 2.0]]
    assert i.tolist() == [[4, 10, 12, 20]]


# ---------------------------------------------------------------------------
# Sharded serving differentials
# ---------------------------------------------------------------------------

def _make_problem(seed=1, n=24, m=41, r=8, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        X = rng.integers(-4, 5, (n, r)).astype(np.float32)
        Y = rng.integers(-4, 5, (m, r)).astype(np.float32)
        X[:, 0] = 127.0
        Y[:, 0] = rng.choice([-127.0, 127.0], m)
    else:
        X = rng.normal(size=(n, r)).astype(np.float32)
        Y = rng.normal(size=(m, r)).astype(np.float32)
    seen = {u: rng.choice(m, size=5, replace=False) for u in range(n)}
    return X, Y, seen


def _layout_from_seen(seen, m, shards=4, pkg=tshard):
    counts = np.zeros(m, np.int64)
    for v in seen.values():
        np.add.at(counts, v, 1)
    return pkg.density_aware_item_layout(counts, shards)


def _stores(X, Y, seen, **kw):
    """(port single, port sharded, JAX sharded) over the same problem."""
    copy = lambda: {u: v.copy() for u, v in seen.items()}  # noqa: E731
    single = tserving.DeviceTopK(X, Y, copy(), device="cpu",
                                 microbatch=False, **kw)
    sharded = tserving.DeviceTopK(
        X, Y, copy(), device=CPU4, microbatch=False,
        item_layout=_layout_from_seen(seen, Y.shape[0]), **kw)
    jsharded = jserving.DeviceTopK(
        X, Y, copy(), microbatch=False,
        item_layout=_layout_from_seen(seen, Y.shape[0], pkg=jshard), **kw)
    assert sharded.shard_count == jsharded.shard_count == 4
    return single, sharded, jsharded


def _equal(got, want, exact=True):
    gi, gs = (np.asarray(a) for a in got)
    wi, ws = (np.asarray(a) for a in want)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    if exact:
        np.testing.assert_array_equal(gs[fin], ws[fin])
    else:
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=1e-5, atol=1e-6)


def _equal_up_to_ties(got, want):
    """The same scores; the same ids within each run of tied scores but
    the last (the k-th result cuts that run at a place the tie order
    decides). A sharded store orders a tie by store position, the single
    store by item id."""
    gi, gs = (np.asarray(a) for a in got)
    wi, ws = (np.asarray(a) for a in want)
    for gi_row, gs_row, wi_row, ws_row in zip(np.atleast_2d(gi),
                                              np.atleast_2d(gs),
                                              np.atleast_2d(wi),
                                              np.atleast_2d(ws)):
        fin = np.isfinite(ws_row)
        np.testing.assert_array_equal(np.isfinite(gs_row), fin)
        np.testing.assert_array_equal(gs_row[fin], ws_row[fin])
        vals = ws_row[fin]
        for v in np.unique(vals):
            if v == vals[-1]:
                continue
            assert set(gi_row[fin][gs_row[fin] == v]) == \
                set(wi_row[fin][vals == v])


PRECISIONS = ["fp32", "bf16", "int8"]


class TestShardedServingDifferential:
    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_user_lane_matches(self, multichip_devices, monkeypatch,
                               precision):
        monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
        X, Y, seen = _make_problem()
        single, sharded, jsharded = _stores(X, Y, seen)
        assert sharded.precision == precision
        for uid in range(X.shape[0]):
            got = sharded.user_topk(uid, 7)
            _equal(got, jsharded.user_topk(uid, 7))
            _equal_up_to_ties(got, single.user_topk(uid, 7))

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_users_lane_matches(self, multichip_devices, monkeypatch,
                                precision):
        monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
        X, Y, seen = _make_problem(seed=2)
        single, sharded, jsharded = _stores(X, Y, seen)
        uids = np.arange(X.shape[0])
        for k in (9, 41):
            got = sharded.users_topk(uids, k)
            _equal(got, jsharded.users_topk(uids, k))
            _equal_up_to_ties(got, single.users_topk(uids, k))

    @pytest.mark.parametrize("integer", [True, False])
    def test_items_lane_matches(self, multichip_devices, integer):
        X, Y, seen = _make_problem(seed=3, integer=integer)
        single, sharded, jsharded = _stores(X, Y, seen)
        for q in ([0], [3, 17], [1, 2, 5, 8]):
            got = sharded.items_topk(q, 6)
            _equal(got, jsharded.items_topk(q, 6), exact=False)
            _equal(got, single.items_topk(q, 6), exact=False)

    def test_continuous_factors_match(self, multichip_devices):
        X, Y, seen = _make_problem(seed=4, integer=False)
        single, sharded, jsharded = _stores(X, Y, seen)
        for uid in (0, 11, 23):
            got = sharded.user_topk(uid, 6)
            _equal(got, jsharded.user_topk(uid, 6), exact=False)
            _equal(got, single.user_topk(uid, 6), exact=False)

    def test_out_of_range_query_item_drops(self, multichip_devices):
        X, Y, seen = _make_problem(seed=16)
        single, sharded, _ = _stores(X, Y, seen)
        m = Y.shape[0]
        for srv in (single, sharded):
            i_mixed, s_mixed = srv.items_topk([2, m + 5], 6)
            i_ref, s_ref = srv.items_topk([2], 6)
            assert (i_mixed == i_ref).all()
            np.testing.assert_allclose(s_mixed, s_ref, atol=1e-5)
            srv.items_topk([m], 3)  # all out of range: answers

    def test_micro_batched_lanes_match(self, multichip_devices):
        """Concurrent queries through the dispatcher share sharded
        dispatches and answer as the direct calls."""
        import concurrent.futures

        X, Y, seen = _make_problem(seed=5)
        sharded = tserving.DeviceTopK(X, Y, seen, device=CPU4, shards=4)
        direct = tserving.DeviceTopK(X, Y, seen, device=CPU4, shards=4,
                                     microbatch=False)
        jobs = [("u", uid) for uid in range(24)] + [("i", (1, 2)),
                                                    ("i", (7,))]

        def run(job):
            kind, arg = job
            return (sharded.user_topk(arg, 5) if kind == "u"
                    else sharded.items_topk(arg, 5))

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(run, jobs))
        for (kind, arg), got in zip(jobs, outs):
            want = (direct.user_topk(arg, 5) if kind == "u"
                    else direct.items_topk(arg, 5))
            _equal(got, want)
        sharded.close()

    def test_env_shards_and_clamp(self, multichip_devices, monkeypatch,
                                  caplog):
        X, Y, seen = _make_problem(seed=6)
        monkeypatch.setenv("PIO_SERVE_SHARDS", "4")
        srv = tserving.DeviceTopK(X, Y, seen, device=CPU4, microbatch=False)
        assert srv.shard_count == 4
        assert srv.item_layout is not None
        monkeypatch.setenv("PIO_SERVE_SHARDS", "32")
        with caplog.at_level("WARNING", logger="pio.serving"):
            clamped = tserving.DeviceTopK(X, Y, seen, device=CPU4,
                                          microbatch=False)
        assert clamped.shard_count == 4
        assert "clamping" in caplog.text
        # one device: the store stays whole
        one = tserving.DeviceTopK(X, Y, seen, device="cpu", microbatch=False)
        assert one.shard_count == 1 and one.item_layout is None
        monkeypatch.setenv("PIO_SERVE_SHARDS", "many")
        with pytest.raises(ValueError, match="PIO_SERVE_SHARDS"):
            tserving.DeviceTopK(X, Y, seen, device=CPU4)

    def test_a_deployment_spans_its_contexts_plane(self, stores,
                                                    monkeypatch, caplog):
        """``build_deployment`` hands a context given its devices to the
        served store as its plane: ``PIO_SERVE_SHARDS=4`` under
        ``workflow_context(devices=["cpu"] * 4)`` shards the store four
        ways; under a one-device context the request clamps to one shard
        with the warning, as on a one-card host. Both answer alike."""
        stores("memory")
        assert tcw.create_workflow(tcw.WorkflowConfig(
            engine_factory=FACTORIES[1]), variant(3, True), ctx=CPU)
        monkeypatch.setenv("PIO_SERVE_SHARDS", "4")
        inst = tserver.resolve_engine_instance(None)
        one = tserver.build_deployment(inst, CPU)
        with caplog.at_level("WARNING", logger="pio.serving"):
            assert one.models[0].device_server().shard_count == 1
        assert "clamping" in caplog.text
        four = tserver.build_deployment(inst, workflow_context(
            mode="serving", device="cpu", devices=CPU4))
        model = four.models[0]
        assert model.device_server().shard_count == 4
        assert model.__getstate__().get("serve_plane") is None
        for user in ("u0", "u3", "u7", "u12"):
            q = {"user": user, "num": 8}
            got = tserver.to_jsonable(tserver.serve_query(four, q))
            want = tserver.to_jsonable(tserver.serve_query(one, q))
            got, want = got["itemScores"], want["itemScores"]
            assert [g["item"] for g in got] == [w["item"] for w in want]
            np.testing.assert_allclose([g["score"] for g in got],
                                       [w["score"] for w in want],
                                       rtol=1e-5, atol=1e-6)

    def test_two_stage_serves_two_shards_as_one(self, monkeypatch):
        from predictionio_tpu_torch.ops.twostage import TwoStageTopK

        X, Y, seen = _make_problem(seed=7)
        one = TwoStageTopK(X, Y, X, Y, seen, candidates=Y.shape[0],
                           microbatch=False, device="cpu")
        monkeypatch.setenv("PIO_SERVE_SHARDS", "2")
        two = TwoStageTopK(X, Y, X, Y, seen, candidates=Y.shape[0],
                           microbatch=False, device=CPU4)
        # one device: the request clamps to one shard
        clamped = TwoStageTopK(X, Y, X, Y, seen, microbatch=False,
                               device="cpu")
        try:
            assert (one.shard_count, two.shard_count,
                    clamped.shard_count) == (1, 2, 1)
            uids = np.arange(X.shape[0])
            for k in (1, 10, Y.shape[0]):
                wi, wv = one.twos_topk(uids, k)
                gi, gv = two.twos_topk(uids, k)
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gv, wv)
        finally:
            for st in (one, two, clamped):
                st.close()


# ---------------------------------------------------------------------------
# Sharded fold-in: patch, growth by resharding, the item_factors view
# ---------------------------------------------------------------------------

class TestShardedFoldIn:
    def test_patch_matches_single(self, multichip_devices):
        X, Y, seen = _make_problem(seed=8)
        single, sharded, jsharded = _stores(X, Y, seen)
        rows = np.random.default_rng(0).integers(
            -4, 5, (3, X.shape[1])).astype(np.float32)
        uids = np.asarray([2, 9, 17])
        upd = {int(u): np.asarray([0, 5, 6]) for u in uids}
        for srv in (single, sharded, jsharded):
            srv.patch_users(uids, rows, seen_items=dict(upd))
        for uid in (2, 9, 17, 0):
            got = sharded.user_topk(uid, 8)
            _equal_up_to_ties(got, single.user_topk(uid, 8))
            _equal(got, jsharded.user_topk(uid, 8))

    @pytest.mark.parametrize("precision", ["fp32", "int8"])
    def test_growth_reshards_instead_of_refusing(self, multichip_devices,
                                                 monkeypatch, precision):
        monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
        X, Y, seen = _make_problem(seed=9)
        single, sharded, jsharded = _stores(X, Y, seen)
        assert sharded.growable
        n = X.shape[0]
        rows = np.random.default_rng(1).integers(
            -4, 5, (2, X.shape[1])).astype(np.float32)
        rows[:, 0] = 127.0
        uids = np.asarray([n + 1, n + 7])
        for srv in (single, sharded, jsharded):
            srv.patch_users(uids, rows,
                            seen_items={int(u): np.asarray([1, 30])
                                        for u in uids})
        assert sharded.user_capacity >= n + 8
        assert sharded.user_capacity % sharded.shard_count == 0
        assert sharded.user_capacity == jsharded.user_capacity
        assert sharded.growths[-1]["rows"][1] == sharded.user_capacity
        for uid in (int(n + 1), int(n + 7), 0, n - 1):
            got = sharded.user_topk(uid, 8)
            _equal_up_to_ties(got, single.user_topk(uid, 8))
            _equal(got, jsharded.user_topk(uid, 8))

    def test_item_factors_view_is_item_ordered(self, multichip_devices):
        X, Y, seen = _make_problem(seed=11, integer=False)
        _, sharded, jsharded = _stores(X, Y, seen)
        np.testing.assert_array_equal(sharded.item_factors.numpy(), Y)
        np.testing.assert_array_equal(sharded.item_factors.numpy(),
                                      np.asarray(jsharded.item_factors))

    def test_fold_solve_differential_on_sharded_store(self,
                                                      multichip_devices):
        from predictionio_tpu.ops.als import ALSParams as JParams
        from predictionio_tpu.ops.als import fold_in_users as jfold
        from predictionio_tpu_torch.ops.als import ALSParams, fold_in_users

        X, Y, seen = _make_problem(seed=12, integer=False)
        _, sharded, jsharded = _stores(X, Y, seen)
        cols = [np.asarray([1, 4, 9]), np.asarray([2, 30])]
        vals = [np.asarray([5.0, 3.0, 4.0], np.float32),
                np.asarray([4.0, 5.0], np.float32)]
        params = ALSParams(rank=X.shape[1], num_iterations=1, seed=0)
        got = fold_in_users(sharded.item_factors, cols, vals, params,
                            device="cpu")
        np.testing.assert_allclose(
            got, fold_in_users(Y, cols, vals, params, device="cpu"),
            atol=1e-6)
        want = jfold(jsharded.item_factors, cols, vals,
                     JParams(rank=X.shape[1], num_iterations=1, seed=0))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The per-shard memory report
# ---------------------------------------------------------------------------

class TestShardMemoryReport:
    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_per_shard_breakdown_equals_jax(self, multichip_devices,
                                            monkeypatch, precision):
        monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
        X, Y, seen = _make_problem(seed=13)
        _, sharded, jsharded = _stores(X, Y, seen)
        for srv in (sharded, jsharded):
            srv.items_topk([1], 3)  # builds the normalized table
        rep, jrep = sharded.memory_report(), jsharded.memory_report()
        assert rep["nShards"] == 4 and len(rep["shards"]) == 4
        assert sum(e["items"] for e in rep["shards"]) == Y.shape[0]
        assert all(e["factorBytes"] > 0 for e in rep["shards"])
        assert sum(e["interactions"] for e in rep["shards"]) == \
            sum(len(v) for v in seen.values())
        assert rep["shardBalance"]["nShards"] == 4
        assert rep.pop("kernel") == "fused"
        jrep.pop("kernel")
        assert rep == jrep

    def test_report_follows_growth(self, multichip_devices):
        X, Y, seen = _make_problem(seed=13)
        _, sharded, jsharded = _stores(X, Y, seen)
        rows = np.ones((1, X.shape[1]), np.float32)
        for srv in (sharded, jsharded):
            srv.patch_users([40], rows, seen_items={40: np.arange(12)})
        rep, jrep = sharded.memory_report(), jsharded.memory_report()
        rep.pop("kernel")
        jrep.pop("kernel")
        assert rep == jrep

    def test_single_store_has_no_shard_block(self):
        X, Y, seen = _make_problem(seed=14)
        srv = tserving.DeviceTopK(X, Y, seen, device="cpu",
                                  microbatch=False)
        assert "shards" not in srv.memory_report()
        assert srv.shard_count == 1

    def test_pio_top_renders_shard_lines_as_jax(self, multichip_devices):
        from predictionio_tpu.tools.top_command import render as jrender
        from predictionio_tpu_torch.tools.top_command import render

        X, Y, seen = _make_problem(seed=15)
        _, sharded, _ = _stores(X, Y, seen)
        stats = {"device": {"stores": [
            {"store": sharded.memory_report(),
             "aotLadder": sharded.ladder_report()}]}}
        text = render(stats, {})
        assert "shard    #0" in text and "interactions" in text
        assert text == jrender(stats, {})
