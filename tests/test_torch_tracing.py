"""The port's span tracing (``predictionio_tpu_torch.utils.tracing``)
against the JAX package's, on the CPU.

- ``parse_traceparent`` / ``format_traceparent`` agree on the same
  vectors (valid, upper case, padded, flags off, reserved version,
  all-zero ids, malformed).
- Head sampling and the slow lane keep and drop the same traces for the
  same seeded sequence of roots.
- ``trace_to_chrome`` and ``render_trace_html`` render one record
  identically, and a record built by live spans in each package exports
  the same events once ids and times are normalised.
- A trace directory written through ``PIO_TRACE_DIR`` by one package
  loads in the other, fragments of one trace merged the same way.
- The tracing kill switch returns before taking a lock; ``StageTimeline``
  spans land under the caller's trace after a pipelined read, and a
  deadline-bounded event-store read runs in the caller's trace.
"""

import json
import os
import time

import numpy as np
import pytest

from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch.data import columnar as tcol
from predictionio_tpu_torch.data import store as tstore
from predictionio_tpu_torch.utils import tracing as ttracing

PACKAGES = [jtracing, ttracing]

VECTORS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    "  00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-03  ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "not a header", "", None,
]


def ctx_tuple(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.sampled)


@pytest.mark.parametrize("value", VECTORS)
def test_traceparent_vectors_match_jax(value):
    got = ttracing.parse_traceparent(value)
    want = jtracing.parse_traceparent(value)
    assert ctx_tuple(got) == ctx_tuple(want)
    if got is not None:
        assert ttracing.format_traceparent(got) == \
            jtracing.format_traceparent(want)
        assert ctx_tuple(ttracing.parse_traceparent(
            ttracing.format_traceparent(got))) == ctx_tuple(got)


def test_minted_ids_round_trip_in_the_other_package():
    for _ in range(20):
        ctx = ttracing.SpanContext(ttracing.new_trace_id(),
                                   ttracing.new_span_id(), sampled=False)
        back = jtracing.parse_traceparent(ttracing.format_traceparent(ctx))
        assert ctx_tuple(back) == ctx_tuple(ctx)


def sample_sequence(mod, seed, rate, slow_sec):
    """Flush 200 roots of seeded durations and error flags through a
    fresh seeded buffer; (kept ids in order, slow-log ids)."""
    buf = mod.TraceBuffer(sample_rate=rate, slow_threshold_sec=slow_sec,
                          enabled=True, seed=seed)
    rng = np.random.default_rng(seed)
    for i in range(200):
        tid = f"{i:032x}"
        root = mod.Span(tid, f"{i:016x}", None, f"root{i}")
        root.start = 1000.0 + i
        root.end = root.start + float(rng.exponential(0.2))
        root.error = bool(rng.random() < 0.05)
        if rng.random() < 0.1:
            root.attributes["slowExempt"] = True
        buf.root_started(tid)
        child = mod.Span(tid, f"{i + 1000:016x}", root.span_id, "child")
        child.start, child.end = root.start, root.start + 0.001
        buf.add_span(child)
        buf.flush(root, buf.sample())
    kept = [t["traceId"] for t in buf.index(limit=1000)]
    slow = [(e["traceId"], e["error"]) for e in buf.slow_log(limit=1000)]
    return kept, slow


@pytest.mark.parametrize("seed,rate,slow_sec", [(1, 0.3, 0.4), (2, 0.0, 0.25),
                                                (3, 1.0, 0.1), (4, 0.5, 1.0)])
def test_sampling_and_slow_lane_match_jax(seed, rate, slow_sec):
    port = sample_sequence(ttracing, seed, rate, slow_sec)
    assert port == sample_sequence(jtracing, seed, rate, slow_sec)
    assert port[1] or rate == 1.0


def test_overflowing_spans_counted_like_jax():
    out = []
    for mod in PACKAGES:
        buf = mod.TraceBuffer(max_spans_per_trace=3, enabled=True, seed=0)
        root = mod.Span("a" * 32, "b" * 16, None, "root")
        buf.root_started(root.trace_id)
        for i in range(5):
            sp = mod.Span(root.trace_id, f"{i:016x}", root.span_id, "s")
            sp.end = sp.start
            buf.add_span(sp)
        root.end = root.start
        buf.flush(root, True)
        rec = buf.get(root.trace_id)
        out.append((rec["droppedSpans"], len(rec["spans"])))
    assert out[0] == out[1] == (2, 4)


RECORD = {
    "traceId": "ab" * 16, "root": "query POST /queries.json",
    "durationSec": 0.0042, "slow": True, "error": False, "sampled": True,
    "droppedSpans": 0, "process": {"pid": 4242},
    "startTime": "2026-01-01T00:00:00+00:00",
    "spans": [
        {"spanId": "1" * 16, "parentId": None,
         "name": "query POST /queries.json", "start": 1700000000.0001,
         "end": 1700000000.0043, "durationSec": 0.0042,
         "attributes": {"status": 200, "path": "/queries.json"},
         "error": False, "thread": 11, "pid": 4242},
        {"spanId": "2" * 16, "parentId": "1" * 16, "name": "serve.predict",
         "start": 1700000000.0005, "end": 1700000000.0040,
         "durationSec": 0.0035, "attributes": {"algorithm": "ALS<&>"},
         "error": True, "thread": 11, "pid": 4242},
        {"spanId": "3" * 16, "parentId": "2" * 16, "name": "device.execute",
         "start": 1700000000.0006, "end": 1700000000.0039,
         "durationSec": 0.0033, "attributes": {"deviceUs": 41.5},
         "error": False, "thread": 12},
    ],
}


def test_chrome_and_html_export_of_one_record_match_jax():
    assert ttracing.trace_to_chrome(RECORD) == jtracing.trace_to_chrome(RECORD)
    assert ttracing.render_trace_html(RECORD) == \
        jtracing.render_trace_html(RECORD)


def live_record(mod):
    """One trace built by live spans: a root, a child span with a
    grandchild span, and an already-finished span."""
    mod.TRACES.reset()
    parent = mod.SpanContext("cd" * 16, "ef" * 8, True)
    with mod.trace_scope("query POST /queries.json", parent=parent,
                         attributes={"method": "POST"}) as root:
        with mod.span("serve.predict", attributes={"algorithm": "ALS"}):
            with mod.span("device.user_topk", attributes={"k": 16}):
                t0 = mod.span_now()
                mod.record_completed_span("device.execute", t0,
                                          mod.span_now(),
                                          attributes={"deviceUs": 12.5})
        root.attributes["status"] = 200
    rec = mod.TRACES.get("cd" * 16)
    mod.TRACES.reset()
    return rec


def normalised(chrome):
    ids = {}
    events = []
    for e in chrome["traceEvents"]:
        args = dict(e["args"])
        args["spanId"] = ids.setdefault(args["spanId"], len(ids))
        if "parentId" in args:
            args["parentId"] = ids.setdefault(args["parentId"], len(ids))
        events.append((e["name"], e["cat"], e["ph"], tuple(sorted(
            (k, json.dumps(v)) for k, v in args.items()))))
    return chrome["otherData"], sorted(events)


def test_live_trace_exports_the_same_events_as_jax():
    trec, jrec = live_record(ttracing), live_record(jtracing)
    for rec in (trec, jrec):
        root = next(s for s in rec["spans"] if s["parentId"] == "ef" * 8)
        for s in rec["spans"]:   # children inside their parents' windows
            if s is not root:
                assert root["start"] <= s["start"] <= s["end"] <= root["end"]
    assert normalised(ttracing.trace_to_chrome(trec)) == \
        normalised(jtracing.trace_to_chrome(jrec))
    keys = {k for k in trec if k not in ("startTime", "durationSec",
                                         "process")}
    assert {k: trec[k] for k in keys if k != "spans"} == \
        {k: jrec[k] for k in keys if k != "spans"}


def spill(mod, directory, n=4):
    """Retain ``n`` traces through a buffer exporting to ``directory``;
    a second fragment of trace 0 (a child root) goes to another file."""
    buf = mod.TraceBuffer(enabled=True, seed=0, slow_threshold_sec=0.0)
    buf.set_export_dir(str(directory))
    for i in range(n):
        root = mod.Span(f"{i:032x}", f"{i:016x}", None, f"root{i}")
        root.end = root.start + 0.01 * (i + 1)
        buf.root_started(root.trace_id)
        buf.flush(root, True)
    frag = mod.Span(f"{0:032x}", "9" * 16, f"{0:016x}", "downstream")
    frag.end = frag.start + 1.0
    buf.root_started(frag.trace_id)
    buf.flush(frag, True)
    # the fragment as another process would write it
    path = os.path.join(str(directory), f"traces-{os.getpid()}.jsonl")
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    with open(os.path.join(str(directory), "traces-0.jsonl"), "w") as f:
        f.write(lines[-1] + "\n")


@pytest.mark.parametrize("writer", [0, 1], ids=["jax_writes", "port_writes"])
def test_trace_dir_written_by_one_loads_in_the_other(tmp_path, writer):
    spill(PACKAGES[writer], tmp_path)
    loaded = [mod.load_traces_from_dir(str(tmp_path)) for mod in PACKAGES]
    assert loaded[0] == loaded[1]
    merged = {r["traceId"]: r for r in loaded[1]}
    assert len(merged) == 4
    first = merged[f"{0:032x}"]
    assert first["root"] == "root0" and len(first["spans"]) == 2
    assert first["durationSec"] == 1.0
    one = [mod.load_traces_from_dir(str(tmp_path), trace_id=f"{2:032x}")
           for mod in PACKAGES]
    assert one[0] == one[1] and len(one[1]) == 1
    slow = [mod.load_slow_log_from_dir(str(tmp_path)) for mod in PACKAGES]
    assert slow[0] == slow[1] and len(slow[1]) == 5


def test_kill_switch_returns_before_taking_a_lock(monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError("tracing off took a lock")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(ttracing.TRACES, "enabled", False)
    monkeypatch.setattr(ttracing.TRACES, "_lock", NoLock())
    with ttracing.trace_scope("root") as root:
        assert root is None
        with ttracing.span("child") as sp:
            assert sp is None
        assert ttracing.record_completed_span("x", 0.0, 1.0) is None
        with ttracing.detached_span("y", ttracing.SpanContext(
                "a" * 32, "b" * 16)) as sp:
            assert sp is None
    assert ttracing.current_trace_context() is None


def test_stage_spans_land_under_the_callers_trace():
    from test_torch_ingest_pipeline import blocks_of, power_law_stream

    ttracing.TRACES.reset()
    with ttracing.trace_scope("pio.train", slow_exempt=True) as root:
        res = tcol.ingest_ratings_pipelined(
            blocks_of(tcol, power_law_stream(600, 40, 20, seed=5), 100))
        res.wait()
    rec = ttracing.TRACES.get(root.trace_id)
    ttracing.TRACES.reset()
    stages = {s["name"] for s in rec["spans"]
              if s["parentId"] == root.span_id}
    assert {"ingest.decode", "ingest.index", "ingest.merge",
            "ingest.bucket.user", "ingest.bucket.item"} <= stages
    spans = res.timeline.spans()
    assert len([s for s in rec["spans"] if s["name"].startswith("ingest.")]
               ) == len(spans)


@pytest.mark.parametrize("timeout", [None, 5.0])
def test_bounded_read_runs_in_the_callers_trace(timeout):
    def read():
        return (ttracing.current_trace_id(), ttracing.current_request_id())

    with ttracing.request_scope("rid-7"):
        with ttracing.trace_scope("query") as root:
            got = tstore._bounded(read, timeout)
    assert got == (root.trace_id, "rid-7")


@pytest.fixture
def metrics_on(monkeypatch):
    from predictionio_tpu_torch.utils import metrics as tmetrics

    monkeypatch.setattr(tmetrics.REGISTRY, "enabled", True)
    return tmetrics


def test_profile_trace_writes_a_chrome_trace(tmp_path, metrics_on):
    import torch

    n0 = metrics_on.PROFILE_TRACES.value()
    with ttracing.profile_trace(str(tmp_path / "capture")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None and len(prof.events()) > 0
    doc = json.loads((tmp_path / "capture" / ttracing.TRACE_FILE).read_text())
    assert doc["traceEvents"]
    assert metrics_on.PROFILE_TRACES.value() == n0 + 1
    with ttracing.profile_trace(None) as prof:
        assert prof is None
    assert metrics_on.PROFILE_TRACES.value() == n0 + 1


def test_profiler_capture_is_single_flight(tmp_path, metrics_on):
    cap = ttracing.ProfilerCapture()
    with pytest.raises(ttracing.ProfilerNotRunningError):
        cap.stop()
    path = cap.start(str(tmp_path))
    assert cap.active_dir == path and path.startswith(str(tmp_path))
    assert metrics_on.PROFILE_CAPTURES_ACTIVE.value() == 1
    with pytest.raises(ttracing.ProfilerBusyError):
        cap.start(str(tmp_path))
    out = cap.stop()
    assert out["profileDir"] == path and cap.active_dir is None
    assert metrics_on.PROFILE_CAPTURES_ACTIVE.value() == 0
    assert os.path.exists(os.path.join(path, ttracing.TRACE_FILE))


def test_query_server_exports_to_pio_trace_dir(tmp_path, monkeypatch):
    from predictionio_tpu_torch.templates.recommendation.engine import (
        engine_factory,
    )
    from predictionio_tpu_torch.weights import als_model_from_numpy
    from predictionio_tpu_torch.workflow import create_server as tserver

    rng = np.random.default_rng(2)
    model = als_model_from_numpy(
        rng.normal(size=(6, 4)), rng.normal(size=(30, 4)),
        [f"u{i}" for i in range(6)], [f"i{i}" for i in range(30)],
        {0: [1, 2]}, device="cpu")
    engine = engine_factory()
    dep = tserver.deployment_from_models(
        engine, engine.engine_params_from_variant({}), [model])
    monkeypatch.setenv("PIO_TRACE_DIR", str(tmp_path))
    srv = tserver.QueryServer(tserver.ServerConfig(ip="127.0.0.1", port=0),
                              dep).start()
    trace_id = "5a" * 16
    try:
        import urllib.request

        req = urllib.request.Request(
            "http://%s:%d/queries.json" % srv.address, method="POST",
            data=b'{"user": "u0", "num": 3}',
            headers={"traceparent": f"00-{trace_id}-{'1' * 16}-01"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
        # the trace is exported just after the response went out: poll
        # for it (a busy host can take a while)
        deadline = time.monotonic() + 10.0
        while True:
            got = jtracing.load_traces_from_dir(str(tmp_path), trace_id)
            if got or time.monotonic() > deadline:
                break
            time.sleep(0.005)
    finally:
        srv.stop()
        ttracing.set_trace_dir(None)
    names = {s["name"] for s in got[0]["spans"]}
    assert {"query POST /queries.json", "device.user_topk",
            "device.execute"} <= names
