"""The port's query server with the observability base, on the CPU.

Request trace differential: one small model per package (seeded rating
events, ``create_workflow``, one shared init, as
``tests/test_torch_lifecycle.py`` trains them) is served by the JAX
package's ``QueryServer`` (``JAX_PLATFORMS=cpu``, device serving) and by
the port's (``device="cpu"``, the kernel's plain version). The same
queries, sent with the same ``traceparent``, give ``/traces/<id>``
trees of the same shape (span names, parent links, error flags, the
server span's status), and ``/metrics`` and ``/stats.json`` count the
query routes the same way.

Port-only: every observability route answers under the JAX package's
route labels (``/``, ``/healthz``, ``/metrics``, ``/stats.json``,
``/dispatches.json``, ``/traces.json``, ``/traces/<id>`` plain,
perfetto and html); ``X-Request-ID`` and ``traceparent`` are echoed; a
5xx lands in the slow lane; training opens the ``dase.*`` stage spans
and feeds ``pio_train_stage_seconds``; the storage backends count
their aggregation reads as the JAX package's do.
"""

import datetime as dt
import http.client
import importlib
import json

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.sqlite import (
    SqliteClient as JSqliteClient,
    SqliteLEvents as JSqliteLEvents,
)
from predictionio_tpu.utils import metrics as jmetrics
from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.storage.jsonlfs import JsonlFsLEvents
from predictionio_tpu_torch.data.storage.memory import MemLEvents
from predictionio_tpu_torch.data.storage.sqlite import (
    SqliteClient as TSqliteClient,
    SqliteLEvents as TSqliteLEvents,
)
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import tracing as ttracing
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

from test_torch_lifecycle import (  # noqa: F401
    CPU,
    FACTORIES,
    jcw,
    stores,
    train_both,
    variant,
)

jserver = importlib.import_module("predictionio_tpu.workflow.create_server")
UTC = dt.timezone.utc

QUERIES = [{"user": "u3", "num": 5},
           {"user": "u2", "num": 6, "blacklist": ["i1", "i4"]},
           {"items": ["i3", "i7"], "num": 4},
           {"user": "u5", "num": 4, "categories": ["g1", "g2"]},
           {"user": "nobody", "num": 3},
           {"user": "u1", "num": 2, "bogus": 1}]


def request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    payload = None if body is None else json.dumps(body)
    conn.request(method, path, body=payload, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, data, dict(resp.getheaders()))
    conn.close()
    return out


@pytest.fixture
def both_servers(stores, monkeypatch):  # noqa: F811
    """(JAX server address, port server address, port server) over one
    trained instance each."""
    stores("memory")
    monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
    train_both(11, bucketed=True)
    jsrv = jserver.QueryServer(jserver.ServerConfig(
        ip="127.0.0.1", port=0)).start(undeploy_stale=False)
    tsrv = tserver.QueryServer(
        tserver.ServerConfig(ip="127.0.0.1", port=0),
        tserver.build_deployment(tserver.resolve_engine_instance(None),
                                 CPU)).start()
    yield jsrv.address, tsrv.address, tsrv
    jsrv.stop()
    tsrv.stop()


def tree(record):
    """A trace's shape: (name, parent's name, error) per span, and the
    server span's status."""
    by_id = {s["spanId"]: s for s in record["spans"]}
    shape = sorted((s["name"], by_id[s["parentId"]]["name"]
                    if s["parentId"] in by_id else None, s["error"])
                   for s in record["spans"])
    root = next(s for s in record["spans"] if s["parentId"] not in by_id)
    return shape, root["attributes"]["status"]


def fetch_trace(addr, trace_id):
    """The server retires a trace just after its response went out."""
    for _ in range(500):
        status, data, _ = request(addr, "GET", f"/traces/{trace_id}")
        if status == 200:
            return json.loads(data)
    raise AssertionError(f"trace {trace_id} not retained")


def query_counts(addr, parse):
    """The query routes' counts in a scrape and in /stats.json."""
    fams = parse(request(addr, "GET", "/metrics")[1].decode())
    stats = json.loads(request(addr, "GET", "/stats.json")[1])["metrics"]

    def value(fams, name, part, **labels):
        return sum(s[part] for s in fams.get(name, {}).get("series", ())
                   if all(s["labels"].get(k) == v
                          for k, v in labels.items()))

    out = {}
    for where, f in (("metrics", fams), ("stats", stats)):
        for status in ("200", "400"):
            out[(where, "requests", status)] = value(
                f, "pio_http_requests_total", "value",
                route="/queries.json", method="POST", status=status)
        out[(where, "request_seconds")] = value(
            f, "pio_http_request_seconds", "count", route="/queries.json")
        out[(where, "query_seconds")] = value(
            f, "pio_query_seconds", "count", variant="engine.json")
        for lane in ("pio-microbatch", "pio-microbatch-items"):
            out[(where, "batched", lane)] = value(
                f, "pio_microbatch_queries_total", "value", batcher=lane)
    return out


def test_request_traces_and_counts_match_jax(both_servers):
    jaddr, taddr, _ = both_servers
    before = {"jax": query_counts(jaddr, jmetrics.parse_prometheus),
              "port": query_counts(taddr, tmetrics.parse_prometheus)}
    rng = np.random.default_rng(4)
    for q in QUERIES:
        trace_id = "".join(f"{b:02x}" for b in rng.bytes(16))
        header = {"traceparent": f"00-{trace_id}-{'7' * 16}-01"}
        shapes = []
        for addr in (jaddr, taddr):
            status, data, headers = request(addr, "POST", "/queries.json",
                                            q, header)
            assert headers["traceparent"].split("-")[1] == trace_id
            shapes.append((status, tree(fetch_trace(addr, trace_id))))
        assert shapes[0] == shapes[1], q
    assert shapes[0][0] == 400
    after = {"jax": query_counts(jaddr, jmetrics.parse_prometheus),
             "port": query_counts(taddr, tmetrics.parse_prometheus)}
    deltas = {name: {k: after[name][k] - before[name][k] for k in after[name]}
              for name in after}
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][("metrics", "requests", "200")] == len(QUERIES) - 1
    assert deltas["port"][("stats", "query_seconds")] == len(QUERIES) - 1


def test_user_trace_tree(both_servers):
    _, taddr, _ = both_servers
    trace_id = "12" * 16
    request(taddr, "POST", "/queries.json", QUERIES[0],
            {"traceparent": f"00-{trace_id}-{'3' * 16}-01"})
    shape, status = tree(fetch_trace(taddr, trace_id))
    assert status == 200
    assert shape == sorted([
        ("query POST /queries.json", None, False),
        ("query.extract", "query POST /queries.json", False),
        ("serve.supplement", "query POST /queries.json", False),
        ("serve.predict", "query POST /queries.json", False),
        ("device.user_topk", "serve.predict", False),
        ("device.execute", "device.user_topk", False),
        ("serve.serve", "query POST /queries.json", False)])


def test_observability_routes(both_servers):
    _, taddr, tsrv = both_servers
    status, _, headers = request(taddr, "POST", "/queries.json", QUERIES[2],
                                 {"X-Request-ID": "rid-42"})
    assert status == 200 and headers["X-Request-ID"] == "rid-42"
    tid = headers["traceparent"].split("-")[1]
    status, data, headers = request(taddr, "GET", "/")
    body = json.loads(data)
    assert status == 200 and body["status"] == "alive"
    assert body["requestCount"] >= 1 and body["engineInstanceId"]
    assert len(headers["X-Request-ID"]) == 16
    status, data, headers = request(taddr, "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    assert "pio_http_requests_total" in data.decode()
    stats = json.loads(request(taddr, "GET", "/stats.json")[1])
    assert {b["batcher"] for b in stats["batchers"]} >= {
        "pio-microbatch", "pio-microbatch-items"}
    assert stats["device"]["storeBytes"] > 0
    assert stats["device"]["dispatch"]
    disp = json.loads(request(taddr, "GET", "/dispatches.json?limit=3")[1])
    assert disp["enabled"] and 1 <= len(disp["dispatches"]) <= 3
    index = json.loads(request(taddr, "GET", "/traces.json")[1])
    assert tid in [t["traceId"] for t in index["traces"]]
    chrome = json.loads(request(taddr, "GET",
                                f"/traces/{tid}?format=perfetto")[1])
    assert {e["name"] for e in chrome["traceEvents"]} >= {
        "device.items_topk", "device.execute"}
    status, html, headers = request(taddr, "GET", f"/traces/{tid}?format=html")
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    assert b"device.execute" in html
    assert request(taddr, "GET", "/traces/" + "0" * 32)[0] == 404
    assert request(taddr, "GET", "/nope")[0] == 404
    fams = tmetrics.parse_prometheus(
        request(taddr, "GET", "/metrics")[1].decode())
    routes = {s["labels"]["route"]
              for s in fams["pio_http_requests_total"]["series"]}
    assert {"/", "/metrics", "/stats.json", "/dispatches.json",
            "/traces.json", "/traces/<id>", "<other>",
            "/queries.json"} <= routes
    assert not any(r.startswith("/traces/0") for r in routes)


def test_5xx_lands_in_the_slow_lane(both_servers, monkeypatch):
    _, taddr, tsrv = both_servers
    algo = tsrv._deployment.algorithms[0]

    def broken(model, query):
        raise RuntimeError("engine failure")

    monkeypatch.setattr(algo, "predict", broken)
    status, _, headers = request(taddr, "POST", "/queries.json", QUERIES[0])
    assert status == 500
    tid = headers["traceparent"].split("-")[1]
    slow = json.loads(request(taddr, "GET", "/traces.json")[1])["slowLog"]
    entry = next(e for e in slow if e["traceId"] == tid)
    assert entry["error"] is True
    record = fetch_trace(taddr, tid)
    assert record["error"] is True
    predict = next(s for s in record["spans"] if s["name"] == "serve.predict")
    assert predict["error"] and predict["attributes"]["exception"] == \
        "RuntimeError"


def test_training_opens_stage_spans_like_jax(stores):  # noqa: F811
    stores("memory")
    counts = {}
    for mod, metrics in ((ttracing, tmetrics), (jtracing, jmetrics)):
        counts[mod] = {stage: metrics.TRAIN_STAGE_LATENCY.child(
            stage=stage).snapshot()[1] for stage in ("read", "prepare",
                                                     "train")}
    ttracing.TRACES.reset()
    jtracing.TRACES.reset()
    names = []
    for mod, train in ((ttracing, lambda: tcw.create_workflow(
            tcw.WorkflowConfig(engine_factory=FACTORIES[1]),
            variant(3, True), ctx=CPU)),
            (jtracing, lambda: jcw.create_workflow(
                jcw.WorkflowConfig(engine_factory=FACTORIES[0]),
                variant(3, True)))):
        with mod.trace_scope("pio.train", slow_exempt=True) as root:
            train()
        rec = mod.TRACES.get(root.trace_id)
        names.append(sorted(s["name"] for s in rec["spans"]
                            if s["name"].startswith("dase.")))
        mod.TRACES.reset()
    assert names[0] == names[1] == ["dase.prepare", "dase.read", "dase.train"]
    for mod, metrics in ((ttracing, tmetrics), (jtracing, jmetrics)):
        for stage, n0 in counts[mod].items():
            assert metrics.TRAIN_STAGE_LATENCY.child(
                stage=stage).snapshot()[1] == n0 + 1


def aggregation_sequence(event_cls, levents, metrics, backend):
    """Hits, backfills, replays and scope drops of one read sequence."""
    def counts():
        return (metrics.AGGREGATE_HITS.value(backend=backend),
                metrics.AGGREGATE_BACKFILLS.value(backend=backend),
                metrics.AGGREGATE_REPLAYS.value(backend=backend,
                                                reason="bounded"),
                metrics.AGGREGATE_SCOPE_DROPS.value(backend=backend))

    levents.init(1)
    levents.insert(event_cls(event="$set", entity_type="user",
                             entity_id="e1", properties={"a": 1},
                             event_time=dt.datetime(2021, 1, 1, tzinfo=UTC)),
                   1)
    c0 = counts()
    levents.aggregate_properties(1, "user")
    levents.aggregate_properties(1, "user")
    levents.aggregate_properties(
        1, "user", until_time=dt.datetime(2022, 1, 1, tzinfo=UTC))
    levents.remove(1)
    return tuple(b - a for a, b in zip(c0, counts()))


def test_sqlite_aggregation_counters_match_jax(tmp_path):
    try:
        got = aggregation_sequence(
            TEvent, TSqliteLEvents({"path": str(tmp_path / "t.db")}),
            tmetrics, "sqlite")
        want = aggregation_sequence(
            JEvent, JSqliteLEvents({"path": str(tmp_path / "j.db")}),
            jmetrics, "sqlite")
    finally:
        TSqliteClient.shutdown_all()
        JSqliteClient.shutdown_all()
    assert got == want == (2, 1, 1, 1)


@pytest.mark.parametrize("backend", ["memory", "jsonlfs"])
def test_aggregation_counters_of_the_other_backends(tmp_path, backend):
    from predictionio_tpu.data.storage import jsonlfs as jjsonlfs
    from predictionio_tpu.data.storage import memory as jmemory

    if backend == "memory":
        pair = (MemLEvents(), jmemory.MemLEvents())
    else:
        pair = (JsonlFsLEvents({"path": str(tmp_path / "t")}),
                jjsonlfs.JsonlFsLEvents({"path": str(tmp_path / "j")}))
    got = aggregation_sequence(TEvent, pair[0], tmetrics, backend)
    want = aggregation_sequence(JEvent, pair[1], jmetrics, backend)
    assert got == want
    assert got[0] == 2 and got[2] == 1
