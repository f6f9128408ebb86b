"""The port's device flight recorder
(``predictionio_tpu_torch.utils.device_telemetry``) against the JAX
package's, and its wiring through the port's ``DeviceTopK`` on the CPU.

- The same ``record_dispatch`` calls, in and out of a
  ``dispatch_scope``, give the same records, counts, summaries and
  histogram series in both packages; the kill switch records nothing and
  returns before taking a lock.
- The port's ``DeviceTopK`` and the JAX package's record one dispatch
  per launch with the same lanes, k buckets and batch sizes for the same
  queries, micro-batched or not.
- Each launch lands as one ``device.execute`` span under the query's own
  ``device.*`` span, also when the dispatcher thread launched it; the
  span carries the flight record, and on the CPU it says that there are
  no CUDA events and records no device time.
"""

import threading

import numpy as np
import pytest

from predictionio_tpu.ops import serving as jserving
from predictionio_tpu.utils import device_telemetry as jdtel
from predictionio_tpu.utils import metrics as jmetrics
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.utils import device_telemetry as tdtel
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import tracing as ttracing

CALLS = [
    dict(lane="users", kernel="fused", precision="bf16", aot="jit",
         k_bucket=16, batch=3, bucket=8, host_us=120.25, device_us=31.0),
    dict(lane="items", kernel="fused", precision="bf16", aot="jit",
         k_bucket=32, batch=1, bucket=1, host_us=95.5, device_us=12.75),
    dict(lane="user", kernel="xla", precision="fp32", aot="jit",
         k_bucket=16, batch=1, bucket=1, host_us=80.0, device_us=60.5),
]


@pytest.fixture
def recorders():
    for mod in (tdtel, jdtel):
        mod.recorder().reset()
        mod.set_enabled(True)
    yield
    for mod in (tdtel, jdtel):
        mod.recorder().reset()
        mod.set_enabled(True)


def replay(mod):
    for i, call in enumerate(CALLS):
        with mod.dispatch_scope(queue_wait_us=1500.0 * i, group=i + 1):
            mod.record_dispatch(started_epoch=1000.0 + i, **call)
    mod.record_dispatch(started_epoch=2000.0, **CALLS[0])
    return mod.recorder().report(limit=100)


def test_records_and_summary_match_jax(recorders):
    assert replay(tdtel) == replay(jdtel)
    report = tdtel.recorder().report(limit=2)
    assert report["recorded"] == 4 and len(report["dispatches"]) == 2
    assert report["dispatches"][0]["queueWaitUs"] is None
    assert report["summary"]["users"]["dispatches"] == 2


def test_histogram_series_match_jax(recorders):
    def series(mod, metrics):
        before = metrics.DISPATCH_DEVICE_SECONDS.child(
            lane="users", kernel="fused", precision="bf16").snapshot()
        replay(mod)
        after = metrics.DISPATCH_DEVICE_SECONDS.child(
            lane="users", kernel="fused", precision="bf16").snapshot()
        return [a - b for a, b in zip(after[0], before[0])], after[1] - before[1]

    assert series(tdtel, tmetrics) == series(jdtel, jmetrics)


def test_capacity_and_evictions_match_jax(monkeypatch):
    monkeypatch.setenv("PIO_DEVICE_TELEMETRY_RING", "16")
    out = []
    for mod in (tdtel, jdtel):
        rec = mod.FlightRecorder()
        for i in range(40):
            rec.record({"lane": "users", "i": i})
        out.append(rec.counts())
    assert out[0] == out[1] == {"recorded": 40, "retained": 16,
                                "evicted": 24, "capacity": 16}


def test_kill_switch_returns_before_taking_a_lock(recorders, monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError("telemetry off took a lock")

        def __exit__(self, *exc):
            return False

    tdtel.set_enabled(False)
    monkeypatch.setattr(tdtel.recorder(), "_lock", NoLock())
    assert tdtel.record_dispatch(**CALLS[0]) is None
    assert tdtel.recorder()._recorded == 0


def test_no_device_time_without_cuda_events(recorders):
    call = dict(CALLS[0], device_us=None)
    before = tmetrics.DISPATCH_DEVICE_SECONDS.child(
        lane="users", kernel="fused", precision="bf16").snapshot()[1]
    rec = tdtel.record_dispatch(**call)
    assert rec["deviceUs"] is None and rec["hostUs"] == 120.2
    assert tmetrics.DISPATCH_DEVICE_SECONDS.child(
        lane="users", kernel="fused", precision="bf16").snapshot()[1] == before
    assert tdtel.recorder().summary()["users"]["deviceUsP50"] is None


@pytest.fixture
def factors():
    rng = np.random.default_rng(8)
    X = rng.integers(-4, 5, (12, 6)).astype(np.float32)
    Y = rng.integers(-4, 5, (90, 6)).astype(np.float32)
    seen = {u: rng.choice(90, 4, replace=False) for u in range(0, 12, 3)}
    return X, Y, seen


def lanes_of(records):
    return sorted((r["lane"], r["kBucket"], r["batch"]) for r in records)


@pytest.mark.parametrize("microbatch", [False, True])
def test_dispatch_records_match_jax(recorders, factors, monkeypatch,
                                    microbatch):
    monkeypatch.setenv("PIO_SERVE_PRECISION", "fp32")
    X, Y, seen = factors
    jsrv = jserving.DeviceTopK(X, Y, seen, microbatch=microbatch)
    tsrv = tserving.DeviceTopK(X, Y, seen, microbatch=microbatch,
                               device="cpu")
    try:
        got = {}
        for name, srv, mod in (("jax", jsrv, jdtel), ("port", tsrv, tdtel)):
            mod.recorder().reset()
            for uid, k in ((0, 5), (4, 10), (7, 3)):
                srv.user_topk(uid, k)
            srv.items_topk([1, 2], 4)
            srv.users_topk(np.arange(5), 8)
            got[name] = mod.recorder().snapshot(100)
        assert lanes_of(got["port"]) == lanes_of(got["jax"])
        assert all(r["kernel"] == "plain" and r["aot"] == "jit"
                   and r["deviceUs"] is None for r in got["port"])
        if microbatch:
            assert {r["queueWaitUs"] is not None for r in got["port"]
                    if r["lane"] != "users" or r["batch"] != 5} == {True}
    finally:
        jsrv.close()
        tsrv.close()


def one_trace(srv, query):
    with ttracing.trace_scope("query POST /queries.json") as root:
        query(srv)
    rec = ttracing.TRACES.get(root.trace_id)
    by_id = {s["spanId"]: s for s in rec["spans"]}
    return {s["name"]: (by_id[s["parentId"]]["name"]
                        if s["parentId"] in by_id else None, s)
            for s in rec["spans"]}


@pytest.mark.parametrize("microbatch", [False, True])
@pytest.mark.parametrize("lane", ["user", "items"])
def test_device_execute_lands_under_the_querys_span(recorders, factors,
                                                    microbatch, lane):
    X, Y, seen = factors
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=microbatch,
                              device="cpu")
    ttracing.TRACES.reset()
    try:
        if lane == "user":
            spans = one_trace(srv, lambda s: s.user_topk(3, 5))
            outer = "device.user_topk"
        else:
            spans = one_trace(srv, lambda s: s.items_topk([1, 5], 5))
            outer = "device.items_topk"
    finally:
        srv.close()
        ttracing.TRACES.reset()
    assert spans[outer][0] == "query POST /queries.json"
    parent, execute = spans["device.execute"]
    assert parent == outer
    attrs = execute["attributes"]
    assert attrs["deviceUs"] is None and "no CUDA events" in \
        attrs["deviceTiming"]
    assert attrs["kernel"] == "plain" and attrs["hostUs"] >= 0
    if microbatch:
        assert attrs["queueWaitUs"] is not None
        assert spans[outer][1]["attributes"]["dispatch"]["lane"] == \
            attrs["lane"]
    assert set(spans) == {"query POST /queries.json", outer,
                          "device.execute"}


def test_concurrent_queries_keep_their_own_traces(recorders, factors):
    """Queries from 6 threads through the batcher: every
    ``device.execute`` sits under a ``device.user_topk`` of its own
    trace, and each trace holds at most one."""
    X, Y, seen = factors
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=True, device="cpu")
    ttracing.TRACES.reset()
    roots, lock = [], threading.Lock()

    def client(uid):
        for _ in range(5):
            with ttracing.trace_scope("query") as root:
                srv.user_topk(uid, 4)
            with lock:
                roots.append(root.trace_id)

    threads = [threading.Thread(target=client, args=(u,)) for u in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        executes = 0
        for tid in roots:
            rec = ttracing.TRACES.get(tid)
            by_id = {s["spanId"]: s for s in rec["spans"]}
            mine = [s for s in rec["spans"] if s["name"] == "device.execute"]
            assert len(mine) <= 1
            for s in mine:
                assert by_id[s["parentId"]]["name"] == "device.user_topk"
            executes += len(mine)
        assert executes == srv.stats()["users"]["dispatches"]
    finally:
        srv.close()
        ttracing.TRACES.reset()


def test_killed_telemetry_serves_the_same_answers(recorders, factors):
    X, Y, seen = factors
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    want = srv.user_topk(2, 7)
    tdtel.set_enabled(False)
    tdtel.recorder().reset()
    got = srv.user_topk(2, 7)
    assert tdtel.recorder().counts()["recorded"] == 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_store_bytes_feed_the_pull_gauge(factors):
    X, Y, seen = factors
    srv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    srv.items_topk([1], 3)   # builds the normalized item table
    want = sum(t.nbytes for t in (srv._X, srv._Y, srv._seen_cols,
                                  srv._seen_mask, srv._Yn))
    assert srv.store_bytes() == want
    assert tmetrics.DEVICE_STORE_BYTES.value() >= want
    stores = tserving.device_report()["stores"]
    assert {"precision": "fp32", "nUsers": 12, "nItems": 90,
            "totalBytes": want} in stores
