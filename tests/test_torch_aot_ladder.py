"""The port's serving ladder (``predictionio_tpu_torch.ops.aot`` and the
``aot_plan`` / ``precompile`` / ``warmup`` / ``ladder_report`` of
``DeviceTopK`` and ``TwoStageTopK``) on the CPU, held to the JAX
package's AOT ladder.

On the CPU a ladder program is the entry's function bound to static
buffers (the CUDA graph waits for a card), so every cache path runs
here: the plan entry for entry, coverage and lookup counts, FIFO
eviction, padding to the bucket, growth invalidation, the switch, and
the deploy's warm-up. Answers: continuous factors, ids equal and
scores within rtol 1e-5 of JAX's (the products sum R terms in
different orders); integer factors where the two-stage store is held
to JAX's bit for bit.
"""

import importlib
import sys
import types

import numpy as np
import pytest

from predictionio_tpu.ops import aot as jaot
from predictionio_tpu.ops import serving as jserving
from predictionio_tpu.ops import twostage as jtwo
from predictionio_tpu.parallel.als_sharding import (
    density_aware_item_layout as jlayout,
)
from predictionio_tpu.utils import device_telemetry as jdtel
from predictionio_tpu_torch.ops import aot as taot
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.ops import twostage as ttwo
from predictionio_tpu_torch.parallel.als_sharding import (
    density_aware_item_layout as tlayout,
)
from predictionio_tpu_torch.utils import device_telemetry as tdtel
from predictionio_tpu_torch.utils import metrics as tmetrics

# the modules (each package's workflow exports a function of that name)
jserver = importlib.import_module("predictionio_tpu.workflow.create_server")
tserver = importlib.import_module(
    "predictionio_tpu_torch.workflow.create_server")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("PIO_SERVING_BACKEND", "PIO_SERVE_PRECISION", "PIO_FOLDIN",
                 "PIO_SERVE_SHARDS", "PIO_SERVE_KERNEL", "PIO_SERVE_AOT",
                 "PIO_SERVING_MICROBATCH", "PIO_BATCH_WINDOW"):
        monkeypatch.delenv(name, raising=False)


def problem(seed=3, n=40, m=33, r=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, r)).astype(np.float32)
    Y = rng.normal(size=(m, r)).astype(np.float32)
    seen = {u: rng.choice(m, size=4, replace=False) for u in range(0, n, 3)}
    return X, Y, seen


def pair(X, Y, seen, microbatch=False, **kw):
    """(JAX DeviceTopK, port DeviceTopK on the CPU) over one problem."""
    return (jserving.DeviceTopK(X, Y, seen, microbatch=microbatch, **kw),
            tserving.DeviceTopK(X, Y, seen, microbatch=microbatch,
                                device="cpu", **kw))


def same_answers(got, want):
    (gi, gs), (wi, ws) = got, want
    assert np.asarray(gi).tolist() == np.asarray(wi).tolist()
    np.testing.assert_allclose(gs, ws, rtol=1e-5)


def key_tree(obj):
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return None


# -- AOTCache ------------------------------------------------------------------

def test_cache_evicts_and_counts_as_jax():
    """One put/get sequence through both caches: the same FIFO order,
    the same stats and eviction count; the port's evictions feed
    pio_aot_cache_evictions_total."""
    caches = (jaot.AOTCache(max_entries=3, name="j"),
              taot.AOTCache(max_entries=3, name="t"))
    before = tmetrics.AOT_CACHE_EVICTIONS.value()
    trace = []
    for c in caches:
        seen = []
        for key in ("a", "b", "c", "a", "d", "e", "b", "f"):
            c.put(key, object())
            seen.append((tuple(c.keys()), len(c), c.get("a") is not None,
                         "b" in c))
        seen.append(c.stats())
        seen.append(c.evictions)
        trace.append(seen)
    assert trace[0] == trace[1]
    assert caches[1].stats() == {"entries": 3, "maxEntries": 3,
                                 "evictions": 4}
    assert tmetrics.AOT_CACHE_EVICTIONS.value() - before == 4
    caches[1].clear()
    assert len(caches[1]) == 0 and caches[1].evictions == 4


def test_memory_report_sums_the_programs():
    cache = taot.AOTCache(max_entries=4)
    sizes = (100, None, 28)
    for i, size in enumerate(sizes):
        cache.put(i, types.SimpleNamespace(memory_bytes=lambda s=size: s))
    assert cache.memory_report() == {"entries": 3, "entriesAnalyzed": 2,
                                     "totalBytes": 128}


def test_cpu_program_binds_its_static_buffers():
    import torch

    buf = torch.zeros(4, dtype=torch.int64)
    prog = taot.capture(lambda u: u * 2, (buf,))
    assert prog.graph is None
    out = prog(np.arange(4, dtype=np.int64))
    assert out.tolist() == [0, 2, 4, 6] and buf.tolist() == [0, 1, 2, 3]
    assert prog.memory_bytes() == buf.nbytes


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("n_items", [5, 16, 33, 200])
@pytest.mark.parametrize("max_k", [16, 64, 128, 512])
@pytest.mark.parametrize("batch_sizes", [(), (16,), (300, 3)])
@pytest.mark.parametrize("microbatch", [False, True])
def test_aot_plan_equals_jax(n_items, max_k, batch_sizes, microbatch):
    X, Y, seen = problem(m=n_items)
    jsrv, tsrv = pair(X, Y, seen, microbatch=microbatch)
    try:
        assert tsrv.aot_plan(max_k=max_k, batch_sizes=batch_sizes) == \
            jsrv.aot_plan(max_k=max_k, batch_sizes=batch_sizes)
    finally:
        jsrv.close()
        tsrv.close()


@pytest.mark.parametrize("candidates", [None, 20, 300])
@pytest.mark.parametrize("max_k", [16, 32, 128])
def test_two_stage_plan_equals_jax(candidates, max_k):
    X, Y, seen = problem(m=40)
    rng = np.random.default_rng(5)
    U = rng.normal(size=(X.shape[0], 5)).astype(np.float32)
    E = rng.normal(size=(Y.shape[0], 5)).astype(np.float32)
    jsrv = jtwo.TwoStageTopK(X, Y, U, E, seen=seen, candidates=candidates,
                             microbatch=False)
    tsrv = ttwo.TwoStageTopK(X, Y, U, E, seen=seen, candidates=candidates,
                             microbatch=False, device="cpu")
    try:
        plan = tsrv.aot_plan(max_k=max_k, batch_sizes=(16,))
        assert plan == jsrv.aot_plan(max_k=max_k, batch_sizes=(16,))
        # JAX tests/test_twostage.py:368: every k bucket has a two entry
        # whose N bucket covers it
        twos = [e for e in plan if e[0] == "two"]
        assert {e[0] for e in plan} == {"user", "users", "items", "two"}
        assert sorted({e[1] for e in twos}) == sorted(
            {e[1] for e in plan if e[0] == "user"})
        assert all(e[2] >= e[1] for e in twos)
    finally:
        jsrv.close()
        tsrv.close()


# -- warm-up, coverage, lookups ------------------------------------------------

def test_warmup_leaves_no_gaps_and_reports_as_jax():
    X, Y, seen = problem()
    jsrv, tsrv = pair(X, Y, seen)
    try:
        stats = [s.warmup(max_k=32, batch_sizes=(16,)) for s in (jsrv, tsrv)]
        assert stats[1] == stats[0]
        plan = tsrv.aot_plan(max_k=32, batch_sizes=(16,))
        with tsrv._store_lock:
            assert not [e for e in plan if tsrv._aot_get_locked(e) is None]
        for s in (jsrv, tsrv):
            s.user_topk(3, 5)
            s.users_topk(np.arange(11), 20)
            s.items_topk([1, 4], 7)
        want, got = jsrv.ladder_report(), tsrv.ladder_report()
        assert key_tree(got) == key_tree(want)
        for part in ("coverage", "requests", "cache"):
            assert got[part] == want[part], part
        assert got["memory"]["entries"] == want["memory"]["entries"]
        assert got["memory"]["entriesAnalyzed"] == got["memory"]["entries"]
        assert got["memory"]["totalBytes"] > 0
        assert got["coverage"]["planned"] == got["coverage"]["compiled"] \
            == len(plan)
    finally:
        jsrv.close()
        tsrv.close()


def test_serve_aot_switch_sends_every_entry_to_fallback(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_AOT", "0")
    X, Y, seen = problem(seed=4)
    jsrv, tsrv = pair(X, Y, seen)
    try:
        stats = [s.warmup(max_k=16) for s in (jsrv, tsrv)]
        assert stats[1] == stats[0]
        plan = tsrv.aot_plan(max_k=16)
        assert stats[1] == {"compiled": 0, "fallback": len(plan)}
        cov = tsrv.ladder_report()["coverage"]
        assert cov == jsrv.ladder_report()["coverage"]
        assert cov == {"planned": len(plan), "compiled": 0,
                       "fallback": len(plan), "warmed": len(plan)}
        assert len(tsrv._aot_programs) == 0
        same_answers(tsrv.user_topk(1, 5), jsrv.user_topk(1, 5))
        assert tsrv.ladder_report()["requests"]["hit"] == 0
    finally:
        jsrv.close()
        tsrv.close()


def test_requests_count_in_the_metric():
    X, Y, seen = problem(seed=6)
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    hit0 = tmetrics.AOT_CACHE_REQUESTS.value(result="hit")
    miss0 = tmetrics.AOT_CACHE_REQUESTS.value(result="miss_jit")
    srv.user_topk(0, 5)                       # before the warm-up: a miss
    srv.warmup(max_k=16)
    srv.users_topk(np.arange(3), 4)
    assert tmetrics.AOT_CACHE_REQUESTS.value(result="miss_jit") - miss0 \
        == srv.ladder_report()["requests"]["missJit"]
    assert tmetrics.AOT_CACHE_REQUESTS.value(result="hit") - hit0 \
        == srv.ladder_report()["requests"]["hit"]
    assert tserving.device_report()["aotLadderBytes"] >= \
        srv.ladder_report()["memory"]["totalBytes"] > 0
    srv.close()


# -- padding to the bucket ------------------------------------------------------

def test_a_group_of_21_is_one_dispatch_at_bucket_32():
    """JAX tests/test_serving_device.py:257: 21 concurrent queries share
    one dispatch, padded to the warmed uid bucket 32, answering as JAX
    does."""
    X, Y, seen = problem(seed=7)
    jsrv, tsrv = pair(X, Y, seen, microbatch=True)
    try:
        for s in (jsrv, tsrv):
            s.warmup(max_k=16)
        tdtel.recorder().reset()
        lane, d = tsrv._batcher, tsrv._dispatcher
        d.window = 0.5
        d0, hits0 = lane.dispatches, tsrv.ladder_report()["requests"]["hit"]
        futs = [d.enqueue(lane, u % X.shape[0], 3) for u in range(21)]
        got = [f.result(timeout=10) for f in futs]
        assert lane.dispatches == d0 + 1
        assert tsrv.ladder_report()["requests"]["hit"] == hits0 + 1
        rec = tdtel.recorder().snapshot(1)[0]
        assert (rec["lane"], rec["batch"], rec["bucket"], rec["aot"]) == \
            ("users", 21, 32, "hit")
        jfuts = [jsrv._batcher.submit_async(u % X.shape[0], 3, window=0.5)
                 for u in range(21)]
        for (res, row), jf in zip(got, jfuts):
            jres, jrow = jf.result(timeout=10)
            same_answers(res.render(row, 3), jres.render(jrow, 3))
    finally:
        jsrv.close()
        tsrv.close()


def test_a_group_of_13_item_queries_is_one_dispatch_at_16():
    """JAX tests/test_serving_device.py:320: 13 item queries share one
    dispatch padded to the warmed row bucket 16."""
    X, Y, seen = problem(seed=8)
    jsrv, tsrv = pair(X, Y, seen, microbatch=True)
    try:
        for s in (jsrv, tsrv):
            s.warmup(max_k=16)
        tdtel.recorder().reset()
        lane, d = tsrv._item_batcher, tsrv._dispatcher
        d.window = 0.5
        d0, hits0 = lane.dispatches, tsrv.ladder_report()["requests"]["hit"]
        futs = [d.enqueue(lane, (u % Y.shape[0],), 3) for u in range(13)]
        got = [f.result(timeout=10) for f in futs]
        assert lane.dispatches == d0 + 1
        assert tsrv.ladder_report()["requests"]["hit"] == hits0 + 1
        rec = tdtel.recorder().snapshot(1)[0]
        assert (rec["lane"], rec["batch"], rec["bucket"], rec["aot"]) == \
            ("items", 13, 16, "hit")
        jfuts = [jsrv._item_batcher.submit_async((u % Y.shape[0],), 3,
                                                 window=0.5)
                 for u in range(13)]
        for (res, row), jf in zip(got, jfuts):
            jres, jrow = jf.result(timeout=10)
            same_answers(res.render(row, 3), jres.render(jrow, 3))
    finally:
        jsrv.close()
        tsrv.close()


def test_users_topk_pads_and_cuts_the_bucket():
    X, Y, seen = problem(seed=9)
    jsrv, tsrv = pair(X, Y, seen)
    try:
        tsrv.warmup(max_k=16)
        uids = np.asarray([5, 0, 39])
        tdtel.recorder().reset()
        got = tsrv.users_topk(uids, 9)
        assert got[0].shape == (3, 9)
        rec = tdtel.recorder().snapshot(1)[0]
        assert (rec["batch"], rec["bucket"], rec["aot"]) == (3, 8, "hit")
        (gi, gs), (wi, ws) = got, jsrv.users_topk(uids, 9)
        assert gi.tolist() == wi.tolist()
        np.testing.assert_allclose(gs, ws, rtol=1e-5)
    finally:
        jsrv.close()
        tsrv.close()


# -- growth ---------------------------------------------------------------------

def test_growth_clears_the_ladder_and_answers_as_jax():
    """JAX tests/test_serving_load.py:307: a growing patch empties the
    cache; the grown store answers as JAX's; a warm-up restores it. An
    in-place patch keeps the ladder, whose programs read the new rows."""
    rng = np.random.default_rng(1)
    X, Y, seen = problem(seed=10, n=8, m=20, r=4)
    jsrv, tsrv = pair(X, Y, seen)
    try:
        for s in (jsrv, tsrv):
            s.warmup(max_k=16)
        n_programs = len(tsrv._aot_programs)
        row = rng.normal(size=(1, 4)).astype(np.float32)
        for s in (jsrv, tsrv):
            s.patch_users([3], row)           # in place: kept
        assert len(tsrv._aot_programs) == n_programs
        hits = tsrv.ladder_report()["requests"]["hit"]
        same_answers(tsrv.user_topk(3, 5), jsrv.user_topk(3, 5))
        assert tsrv.ladder_report()["requests"]["hit"] == hits + 1
        for s in (jsrv, tsrv):
            s.patch_users([12], row)          # grows: cleared
        assert len(jsrv._aot_programs) == len(tsrv._aot_programs) == 0
        misses = tsrv.ladder_report()["requests"]["missJit"]
        same_answers(tsrv.user_topk(12, 5), jsrv.user_topk(12, 5))
        assert tsrv.ladder_report()["requests"]["missJit"] == misses + 1
        tsrv.warmup(max_k=16)
        cov = tsrv.ladder_report()["coverage"]
        assert cov["planned"] == cov["compiled"] and cov["warmed"] == 0
        same_answers(tsrv.users_topk(np.asarray([12, 2]), 5),
                     jsrv.users_topk(np.asarray([12, 2]), 5))
    finally:
        jsrv.close()
        tsrv.close()


def test_concurrent_dispatches_and_patches_share_the_programs():
    """Threads (more than cores) dispatching through the same ladder
    programs, whose static buffers they share, while a patcher rewrites
    rows in place with their own values: every answer equals the one a
    lone thread got (a torn static buffer would answer another uid)."""
    import os
    import threading

    X, Y, seen = problem(seed=15, n=64, m=40)
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    srv.warmup(max_k=16)
    batches = [np.asarray([u, (u * 7) % 64, (u * 13) % 64]) for u in range(64)]
    want = [srv.users_topk(b, 5) for b in batches]
    misses = srv.ladder_report()["requests"]["missJit"]
    errors, stop = [], threading.Event()

    def dispatcher(offset):
        try:
            for i in range(60):
                j = (offset + i) % len(batches)
                got = srv.users_topk(batches[j], 5)
                if got[0].tolist() != want[j][0].tolist():
                    errors.append((j, got[0].tolist()))
        except Exception as e:  # reported below
            errors.append(e)

    def patcher():
        while not stop.is_set():
            srv.patch_users(np.arange(8), X[:8])

    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=dispatcher, args=(t * 5,))
                   for t in range(2 * (os.cpu_count() or 4))]
        side = threading.Thread(target=patcher)
        side.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        side.join(timeout=60)
    finally:
        sys.setswitchinterval(prior)
    assert not any(t.is_alive() for t in threads) and not side.is_alive()
    assert not errors, errors[:3]
    assert srv.ladder_report()["requests"]["missJit"] == misses
    srv.close()


def test_a_growing_seen_patch_clears_the_ladder():
    X, Y, seen = problem(seed=11)
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    srv.warmup(max_k=16)
    assert len(srv._aot_programs)
    # a longer seen list than the table holds widens it: a new table
    srv.patch_users([0], X[:1], seen_items={0: np.arange(20)})
    assert len(srv._aot_programs) == 0
    idx, _ = srv.user_topk(0, 5)
    assert not set(idx.tolist()) & set(range(20))
    srv.close()


# -- telemetry ------------------------------------------------------------------

def test_telemetry_reads_hit_after_warmup():
    """JAX tests/test_device_telemetry.py:182."""
    X, Y, seen = problem(seed=12, m=16)
    jsrv, tsrv = pair(X, Y, seen)
    try:
        recs = {}
        for name, s, mod in (("jax", jsrv, jdtel), ("port", tsrv, tdtel)):
            s.warmup(max_k=16)
            mod.recorder().reset()
            s.user_topk(0, 5)
            s.users_topk(np.arange(4), 5)
            recs[name] = mod.recorder().snapshot(10)
        for r in recs["port"]:
            assert r["aot"] == "hit" and r["kernel"] == "plain"
        assert sorted((r["lane"], r["aot"], r["bucket"], r["batch"])
                      for r in recs["port"]) == sorted(
            (r["lane"], r["aot"], r["bucket"], r["batch"])
            for r in recs["jax"])
        rep = tsrv.ladder_report()
        assert rep["requests"]["hit"] >= 2
        assert rep["coverage"]["planned"] == (
            rep["coverage"]["compiled"] + rep["coverage"]["fallback"])
    finally:
        jsrv.close()
        tsrv.close()


# -- two-stage --------------------------------------------------------------------

def int_problem(seed=14, n=24, m=33, r1=6, r2=5):
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, r1)).astype(np.float32)
    Y = rng.integers(-3, 4, size=(m, r1)).astype(np.float32)
    U = rng.integers(-3, 4, size=(n, r2)).astype(np.float32)
    E = rng.integers(-3, 4, size=(m, r2)).astype(np.float32)
    seen = {u: np.unique(rng.choice(m, size=4, replace=False))
            for u in range(0, n, 2)}
    return X, Y, U, E, seen


def test_two_stage_ladder_serves_every_query_as_a_hit():
    """JAX tests/test_twostage.py:348: after warmup, steady two-stage
    traffic never misses the ladder, answering as JAX's store does."""
    X, Y, U, E, seen = int_problem()
    jsrv = jtwo.TwoStageTopK(X, Y, U, E, seen=seen, microbatch=False)
    tsrv = ttwo.TwoStageTopK(X, Y, U, E, seen=seen, microbatch=False,
                             device="cpu")
    try:
        stats = [s.warmup(max_k=16, batch_sizes=(16,)) for s in (jsrv, tsrv)]
        assert stats[1] == stats[0] and stats[1]["compiled"] > 0
        assert tsrv.ladder_report()["coverage"] == \
            jsrv.ladder_report()["coverage"]
        miss0 = tsrv.ladder_report()["requests"]["missJit"]
        rng = np.random.default_rng(15)
        for uid in range(12):
            k = 3 + (uid % 12)
            gi, gs = tsrv.two_topk(uid, k)
            wi, ws = jsrv.two_topk(uid, k)
            assert gi.tolist() == wi.tolist() and gs.tolist() == ws.tolist()
        for n in (3, 9, 16):
            uids = rng.integers(0, 24, size=n)
            (gi, gs), (wi, ws) = tsrv.twos_topk(uids, 10), \
                jsrv.twos_topk(uids, 10)
            assert gi.tolist() == wi.tolist()
            assert gs.tolist() == ws.tolist()
        assert tsrv.ladder_report()["requests"]["missJit"] == miss0
        # a growth of the stage-2 table clears the ladder
        tsrv.patch_seq_users([40], np.ones((1, 5), np.float32))
        assert len(tsrv._aot_programs) == 0
    finally:
        jsrv.close()
        tsrv.close()


def test_two_stage_facet_passes_the_report_through():
    X, Y, U, E, seen = int_problem(seed=16)
    store = ttwo.TwoStageTopK(X, Y, U, E, seen=seen, microbatch=False,
                              device="cpu")
    try:
        facet = store.two_facet()
        stats = facet.warmup(max_k=16)
        assert stats["compiled"] == len(store.aot_plan(max_k=16))
        assert facet.ladder_report() == store.ladder_report()
        assert store.seq_facet().warmup() is None
    finally:
        store.close()


# -- sharded ----------------------------------------------------------------------

def layout_counts(seen, m):
    counts = np.zeros(m, np.int64)
    for v in seen.values():
        np.add.at(counts, v, 1)
    return counts


def test_sharded_store_rides_the_ladder(multichip_devices):
    """JAX tests/test_sharded_serving.py:231: the sharded store (here 4
    logical shards of the CPU) warms its whole ladder and dispatches hit
    it, answering as JAX's 4-device store."""
    X, Y, seen = problem(seed=7, n=24, m=41, r=8)
    counts = layout_counts(seen, Y.shape[0])
    jsrv = jserving.DeviceTopK(X, Y, seen, microbatch=False,
                               item_layout=jlayout(counts, 4))
    tsrv = tserving.DeviceTopK(X, Y, seen, microbatch=False,
                               device=["cpu"] * 4,
                               item_layout=tlayout(counts, 4))
    try:
        assert tsrv.shard_count == 4
        stats = [s.warmup(max_k=16) for s in (jsrv, tsrv)]
        assert stats[1] == stats[0] and stats[1]["compiled"] > 0
        assert tsrv.ladder_report()["coverage"] == \
            jsrv.ladder_report()["coverage"]
        before = tsrv.ladder_report()["requests"]
        same_answers(tsrv.user_topk(3, 10), jsrv.user_topk(3, 10))
        same_answers(tsrv.users_topk(np.arange(6), 10),
                     jsrv.users_topk(np.arange(6), 10))
        after = tsrv.ladder_report()["requests"]
        assert after["hit"] - before["hit"] == 2
        assert after["missJit"] == before["missJit"]
    finally:
        jsrv.close()
        tsrv.close()


def test_a_plane_of_several_devices_falls_back(monkeypatch):
    """A store whose shards sit on different devices cannot be one
    graph: every entry counts as fallback and runs once eagerly."""
    X, Y, seen = problem(seed=5)
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=False,
                              device=["cpu"] * 4, shards=4)
    monkeypatch.setattr(srv, "_graphable", lambda: False)
    plan = srv.aot_plan(max_k=16)
    assert srv.warmup(max_k=16) == {"compiled": 0, "fallback": len(plan)}
    assert srv.ladder_report()["coverage"]["warmed"] == len(plan)
    assert len(srv._aot_programs) == 0
    srv.close()


# -- the deploy's warm-up -----------------------------------------------------------

class HooklessModel:
    """A device-served model whose algorithm has no ``warmup_base``."""

    def __init__(self, store):
        self.store = store

    def device_server(self):
        return self.store


def test_hookless_models_get_the_ladder_as_in_jax():
    """JAX workflow/create_server.py:400-411: a model without a
    ``warmup_base`` hook but with a ``device_server()`` is warmed."""
    X, Y, seen = problem(seed=13)
    jsrv, tsrv = pair(X, Y, seen)
    try:
        for mod, srv in ((jserver, jsrv), (tserver, tsrv)):
            dep = types.SimpleNamespace(algorithms=[object()],
                                        models=[HooklessModel(srv)])
            mod.warm_up(dep)
        cov = tsrv.ladder_report()["coverage"]
        assert cov == jsrv.ladder_report()["coverage"]
        assert cov["planned"] == cov["compiled"] == len(tsrv.aot_plan())
    finally:
        jsrv.close()
        tsrv.close()


def test_a_failed_warmup_raises():
    class Broken:
        def device_server(self):
            raise RuntimeError("no card")

    dep = types.SimpleNamespace(algorithms=[object()], models=[Broken()])
    with pytest.raises(RuntimeError, match="no card"):
        tserver.warm_up(dep)
