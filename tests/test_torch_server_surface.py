"""The rest of the port's query server against the JAX package's, on
the CPU: the feedback loop, the plugins, the status wire, ``pio top``
and the serving-backend switch.

- Feedback: a JAX and a port ``QueryServer(feedback=True)`` (one
  trained instance each, as ``tests/test_torch_lifecycle.py`` trains
  them) post to one port event server over sqlite (port 0). The stored
  ``predict`` events agree once ``eventId``, the times and the minted
  ``prId`` are normalised (scores within the training tolerance of
  1e-5 relative). A 4xx is dropped at once and counted; an unreachable
  event server is dropped after one retry and never delays the answer.
- ``/plugins.json`` is equal across the two servers, and a blocker and a
  sniffer see the same query and prediction; ``GET /`` carries
  ``feedback`` with the JAX server's keys.
- ``DeviceTopK.memory_report``'s components equal the JAX store's for
  fp32, bf16 and int8 stores (the JAX store under its fused kernel,
  which pads the item table to the same tile), also after a growing
  ``patch_users``; ``device_report``'s key tree equals JAX's.
- ``pio top``'s ``render`` gives the JAX text on the same dicts, fleet
  and alert blocks included; ``pio-torch top --once`` reads a port
  deploy.
- ``PIO_SERVING_BACKEND=host`` serves from ``HostTopK`` and raises
  naming its policy row where a row forbids it; ``auto``, ``device``
  and an unknown value serve from the device store above the host
  lane's limit.
"""

import copy
import importlib
import json
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.ops import serving as jserving
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu.tools import top_command as jtop
from predictionio_tpu.workflow import server_plugins as jplugins
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.tools import top_command as ttop
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import server_plugins as tplugins

from test_torch_lifecycle import CPU, stores, train_both  # noqa: F401

jserver = importlib.import_module("predictionio_tpu.workflow.create_server")
QUERIES = [{"user": "u3", "num": 5},
           {"user": "u2", "num": 6, "blacklist": ["i1", "i4"]},
           {"items": ["i3", "i7"], "num": 4},
           {"user": "nobody", "num": 3},
           {"user": "u7", "num": 2}]
SCORE_RTOL = 1e-5


def post(base, path, body, timeout=30):
    req = urllib.request.Request(base + path, method="POST",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return json.loads(resp.read())


def url(srv):
    host, port = srv.address
    return f"http://{host}:{port}"


class Recorder:
    """A plugin of either package's registry (duck-typed): records what
    it sees; the blocker also adds a key to the answer."""

    plugin_description = "records what it sees"

    def __init__(self, name, kind):
        self.plugin_name, self.plugin_type = name, kind
        self.seen = []

    def process(self, engine_instance, query, prediction, context):
        self.seen.append((copy.deepcopy(query), copy.deepcopy(prediction)))
        if self.plugin_type == "outputblocker":
            return dict(prediction, blockedBy=self.plugin_name)
        return None


def plugins(pkg_mod):
    return pkg_mod.EngineServerPluginContext([
        Recorder("audit", pkg_mod.OUTPUT_BLOCKER),
        Recorder("tap", pkg_mod.OUTPUT_SNIFFER)])


@pytest.fixture
def served(stores, monkeypatch):  # noqa: F811
    """Trained instances in both packages (the port's in sqlite), a port
    event server on that store, and the app's access key."""
    port_db = stores("sqlite")
    monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
    train_both(11, bucketed=True)
    app = tstorage.get_metadata_apps().get_by_name("MyApp")
    key = tstorage.get_metadata_access_keys().get_by_appid(app.id)[0].key
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0)).start()
    servers = []

    def start(pkg, feedback=True, access_key=key, es_port=None, ctx=None):
        es_port = es_port or es.address[1]
        if pkg == "jax":
            srv = jserver.QueryServer(jserver.ServerConfig(
                ip="127.0.0.1", port=0, feedback=feedback,
                event_server_ip="127.0.0.1", event_server_port=es_port,
                access_key=access_key), plugin_context=ctx)
            srv.start(undeploy_stale=False)
        else:
            srv = tserver.QueryServer(
                tserver.ServerConfig(
                    ip="127.0.0.1", port=0, feedback=feedback,
                    event_server_ip="127.0.0.1", event_server_port=es_port,
                    access_key=access_key),
                tserver.build_deployment(
                    tserver.resolve_engine_instance(None), CPU),
                plugin_context=ctx).start()
        servers.append(srv)
        return srv

    yield {"start": start, "app": app.id, "key": key, "db": port_db}
    for srv in servers:
        srv.stop()
    es.stop()


def predict_events(app_id, n, timeout=20.0):
    """The ``pio_pr`` predict events of the store, waiting for ``n``."""
    deadline = time.monotonic() + timeout
    while True:
        evs = [e for e in tstorage.get_levents().find(
            app_id, entity_type="pio_pr", event_names=["predict"])]
        if len(evs) >= n or time.monotonic() > deadline:
            return evs
        time.sleep(0.05)


def normalised_event(ev):
    out = ev.to_json() if hasattr(ev, "to_json") else dict(ev)
    if isinstance(out, str):
        out = json.loads(out)
    for k in ("eventId", "eventTime", "creationTime"):
        out.pop(k, None)
    assert len(out["entityId"]) == 64   # a minted prId
    out["entityId"] = "<minted>"
    out["properties"]["engineInstanceId"] = "<instance>"
    return out


def split_scores(obj):
    """(the object with every score replaced, the scores in order)."""
    scores = []

    def walk(o):
        if isinstance(o, dict):
            return {k: (scores.append(v) or "<score>") if k == "score"
                    else walk(v) for k, v in o.items()}
        if isinstance(o, list):
            return [walk(v) for v in o]
        return o
    return walk(obj), np.asarray(scores, dtype=np.float64)


def assert_agree(mine, want):
    m, ms = split_scores(mine)
    w, ws = split_scores(want)
    assert m == w
    np.testing.assert_allclose(ms, ws, rtol=SCORE_RTOL, atol=0)


def test_feedback_events_agree_with_jax(served):
    jsrv = served["start"]("jax")
    jbase = url(jsrv)
    janswers = [post(jbase, "/queries.json", q) for q in QUERIES]
    jevents = predict_events(served["app"], len(QUERIES))
    assert len(jevents) == len(QUERIES)
    tsrv = served["start"]("port")
    tbase = url(tsrv)
    tanswers = [post(tbase, "/queries.json", q) for q in QUERIES]
    events = predict_events(served["app"], 2 * len(QUERIES))
    assert len(events) == 2 * len(QUERIES)
    jids = {e.event_id for e in jevents}
    tevents = [e for e in events if e.event_id not in jids]
    for (ts, tb), (js, jb) in zip(tanswers, janswers):
        assert ts == js == 200
        assert_agree(tb, jb)
        # the template's prediction has no pr_id: no prId in the answer
        assert "prId" not in tb and "prId" not in jb
    key = lambda e: json.dumps(e["properties"]["query"], sort_keys=True)
    want = sorted((normalised_event(e) for e in jevents), key=key)
    mine = sorted((normalised_event(e) for e in tevents), key=key)
    for m, w in zip(mine, want):
        assert_agree(m, w)
    # each answer minted its own prId
    assert len({e.entity_id for e in tevents}) == len(QUERIES)
    # the status page says feedback is on, with the JAX server's keys
    jstatus, tstatus = get(jbase, "/"), get(tbase, "/")
    assert list(tstatus) == list(jstatus)
    assert tstatus["feedback"] is jstatus["feedback"] is True


def counter_rises(before, timeout=10.0):
    deadline = time.monotonic() + timeout
    while tmetrics.FEEDBACK_DROPPED.value() < before + 1:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def test_a_refused_feedback_event_is_dropped_and_counted(served):
    srv = served["start"]("port", access_key="not-a-key")
    before = tmetrics.FEEDBACK_DROPPED.value()
    status, _ = post(url(srv), "/queries.json", QUERIES[0])
    assert status == 200
    assert counter_rises(before)
    time.sleep(0.5)   # no retry follows a 4xx
    assert tmetrics.FEEDBACK_DROPPED.value() == before + 1
    assert predict_events(served["app"], 1, timeout=0.3) == []


def test_an_unreachable_event_server_does_not_delay_the_answer(served):
    import socket

    # an event server that takes the connection and never answers: a
    # response that waited on the feedback POST would take its two
    # 5 s read timeouts
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(8)
    srv = served["start"]("port", es_port=silent.getsockname()[1])
    before = tmetrics.FEEDBACK_DROPPED.value()
    t0 = time.perf_counter()
    status, _ = post(url(srv), "/queries.json", QUERIES[0])
    answered = time.perf_counter() - t0
    assert status == 200
    assert answered < 5.0
    assert tmetrics.FEEDBACK_DROPPED.value() == before   # still posting
    # closing the listener resets the pending POST; the retry, 0.2 s
    # later, finds no server, and the event is dropped
    t1 = time.perf_counter()
    silent.close()
    assert counter_rises(before)
    assert time.perf_counter() - t1 >= 0.2


def test_feedback_needs_an_access_key_as_in_jax(capsys):
    argv = ["deploy", "--feedback"]
    assert jcli.main(argv) == 1
    want = capsys.readouterr().err
    assert tcli.main(argv + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err == want


def test_plugins_see_what_the_jax_plugins_see(served):
    jctx, tctx = plugins(jplugins), plugins(tplugins)
    jsrv = served["start"]("jax", feedback=False, ctx=jctx)
    tsrv = served["start"]("port", feedback=False, ctx=tctx)
    assert get(url(tsrv), "/plugins.json") == get(url(jsrv), "/plugins.json")
    for q in QUERIES[:3]:
        _, jb = post(url(jsrv), "/queries.json", q)
        _, tb = post(url(tsrv), "/queries.json", q)
        assert tb["blockedBy"] == jb["blockedBy"] == "audit"
        assert_agree(tb, jb)
    for name, kind in (("audit", "output_blockers"),
                       ("tap", "output_sniffers")):
        jseen = getattr(jctx, kind)[name].seen
        tseen = getattr(tctx, kind)[name].seen
        assert [q for q, _ in tseen] == [q for q, _ in jseen] == QUERIES[:3]
        for (_, tp), (_, jp) in zip(tseen, jseen):
            assert_agree(tp, jp)
    status = get(url(tsrv), "/")
    assert status["feedback"] is False


# -- the status wire -----------------------------------------------------------

def stores_for(monkeypatch, precision, n_items=90, seed=3):
    """A JAX store (fused kernel: the item table padded to its tile) and
    a port store over the same factors and seen lists."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(12, 8)).astype(np.float32)
    Y = rng.normal(size=(n_items, 8)).astype(np.float32)
    seen = {u: np.asarray(rng.choice(n_items, 3 + u % 4, replace=False))
            for u in range(12)}
    monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
    monkeypatch.setenv("PIO_SERVE_KERNEL", "fused")
    jsrv = jserving.DeviceTopK(X, Y, seen, microbatch=False)
    tsrv = tserving.DeviceTopK(X, Y, seen, microbatch=False, device="cpu")
    return jsrv, tsrv


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_memory_report_equals_jax(monkeypatch, precision):
    jsrv, tsrv = stores_for(monkeypatch, precision)
    assert tsrv.memory_report() == jsrv.memory_report()
    # the normalized item table once an item query built it
    jsrv.items_topk([1, 2], 3)
    tsrv.items_topk([1, 2], 3)
    assert tsrv.memory_report() == jsrv.memory_report()
    assert tsrv.store_bytes() == tsrv.memory_report()["totalBytes"]
    # a growing patch: new rows and longer seen lists
    rng = np.random.default_rng(9)
    uids = np.asarray([3, 40])
    rows = rng.normal(size=(2, 8)).astype(np.float32)
    seen = {3: np.arange(20), 40: np.arange(5)}
    jsrv.patch_users(uids, rows, seen)
    tsrv.patch_users(uids, rows, seen)
    got, want = tsrv.memory_report(), jsrv.memory_report()
    assert got == want and got["userCapacity"] > 12
    tsrv.close()


def key_tree(obj):
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [key_tree(obj[0])] if obj else []
    return None


def test_device_report_key_tree_equals_jax(monkeypatch):
    jsrv, tsrv = stores_for(monkeypatch, "fp32")
    jsrv.user_topk(1, 4)
    tsrv.user_topk(1, 4)
    jrep, trep = jserving.device_report(), tserving.device_report()
    assert list(trep) == list(jrep)
    assert key_tree(trep["telemetry"]) == key_tree(jrep["telemetry"])
    mine = next(e for e in trep["stores"] if e["store"]["nUsers"] == 12)
    want = next(e for e in jrep["stores"] if e["store"]["nUsers"] == 12)
    assert key_tree(mine) == key_tree(want)
    # this store was never warmed: its ladder holds nothing, and the
    # report's total is its stores' (other live stores may hold ladders)
    assert mine["aotLadder"]["memory"]["totalBytes"] == 0
    assert trep["aotLadderBytes"] == sum(
        e["aotLadder"]["memory"]["totalBytes"] for e in trep["stores"])
    lane = set(trep["dispatch"]) & set(jrep["dispatch"])
    assert lane
    for name in lane:
        # "aot" counts dispatches by outcome, "hit" or "miss_jit" as in
        # the JAX store
        mine, want = (dict(key_tree(rep["dispatch"][name]), aot={})
                      for rep in (trep, jrep))
        assert mine == want
    tsrv.close()


# -- pio top -----------------------------------------------------------------

FLEET = {"readyReplicas": 2, "replicas": [{}, {}],
         "members": [{"member": "r0", "url": "http://127.0.0.1:9001",
                      "ok": True},
                     {"member": "r1", "url": None, "ok": False,
                      "reason": "member_down", "inProcess": True}],
         "scrape": {"durationSec": 0.0123, "problems": ["r1"]}}
ALERTS = {"firing": ["latency"], "burnThreshold": 14.4,
          "objectives": {"latency": {"burn": {"fast": 20.5, "slow": 3.25},
                                     "budgetRemaining": 0.42,
                                     "firing": True, "since": "t0"},
                         "errors": {"burn": {"fast": 0, "slow": 0}}}}


@pytest.mark.parametrize("extra", [{}, {"fleet": FLEET},
                                   {"fleet": FLEET, "alerts": ALERTS}],
                         ids=["plain", "fleet", "fleet+alerts"])
def test_top_renders_the_jax_text(served, extra):
    srv = served["start"]("port", feedback=False)
    base = url(srv)
    for q in QUERIES:
        post(base, "/queries.json", q)
    stats = dict(get(base, "/stats.json"), **extra)
    stats["foldin"] = {"folds": 3, "foldErrors": 0, "usersPatched": 7,
                       "newUsers": 2, "pendingEvents": 1, "stale": False,
                       "lastSolveDeviceUs": 1234.5}
    dispatches = get(base, "/dispatches.json?limit=0")
    for prev in (None, (10.0, 2)):
        got = ttop.render(stats, dispatches, prev=prev, now=12.5)
        assert got == jtop.render(stats, dispatches, prev=prev, now=12.5)
    # the deploy warmed its store's ladder: every entry bound, none warmed
    cov = srv._deployment.models[0].device_server().ladder_report()[
        "coverage"]
    assert cov["planned"] > 0 and cov["compiled"] == cov["planned"]
    assert (f"ladder {cov['planned']}/{cov['planned']} compiled (+0 warmed)"
            in got)


def test_top_once_reads_a_port_deploy(served, capsys):
    srv = served["start"]("port", feedback=False)
    base = url(srv)
    for q in QUERIES:
        post(base, "/queries.json", q)
    assert tcli.main(["top", "--once", "--url", base]) == 0
    text = capsys.readouterr().out
    store = next(ln for ln in text.splitlines() if ln.startswith("store "))
    assert store.startswith("store    fp32/fused · ")
    assert "u × " in store and "i · " in store
    lanes = [ln for ln in text.splitlines() if ln.startswith("lane ")]
    assert lanes and all(int(ln.split()[2]) > 0 for ln in lanes)
    # --fleet against a single server: the frame says it is no balancer
    assert tcli.main(["top", "--once", "--fleet", "--url", base]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last == (f"fleet    --fleet requested but {base} has no "
                    "federated fleet block (not a balancer?)")


def test_top_once_reports_an_unreachable_server(capsys):
    assert tcli.main(["top", "--once", "--url", "http://127.0.0.1:9"]) == 1
    assert capsys.readouterr().out.startswith("[ERROR] http://127.0.0.1:9 "
                                              "unreachable")


# -- the serving backend -------------------------------------------------------

@pytest.mark.parametrize("backend", ["host", "HOST", " host "])
def test_host_backend_raises_naming_its_item(monkeypatch, backend):
    """The host backend serves from HostTopK, and raises with the policy
    row's message (the JAX package's) where a row forbids it: here an
    explicit bf16 store."""
    monkeypatch.setenv("PIO_SERVING_BACKEND", backend)
    X = np.ones((3, 4), np.float32)
    assert isinstance(tserving.choose_server(X, X, device="cpu"),
                      tserving.HostTopK)
    monkeypatch.setenv("PIO_SERVE_PRECISION", "bf16")
    with pytest.raises(ValueError, match="PIO_SERVE_PRECISION=bf16 "
                                         "conflicts with PIO_SERVING_BACKEND"):
        tserving.choose_server(X, X, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "device", "bogus", ""])
def test_other_backends_serve_on_the_device_store(monkeypatch, backend):
    """Above the host lane's limit (set to 0 here) every backend but
    ``host`` serves from the device store."""
    monkeypatch.setenv("PIO_SERVING_BACKEND", backend)
    monkeypatch.setattr(tserving, "HOST_SERVE_MAX_ELEMS", 0)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3, 4)).astype(np.float32)
    Y = rng.normal(size=(20, 4)).astype(np.float32)
    srv = tserving.choose_server(X, Y, device="cpu")
    assert isinstance(srv, tserving.DeviceTopK)
    idx, _ = srv.user_topk(1, 5)
    assert len(idx) == 5
    srv.close()


def test_deploy_with_the_host_backend_fails(served, monkeypatch):
    """A refusal of the host backend (here under an explicit int8
    store) reaches the operator at deploy, not at a query: the warm-up
    builds the store."""
    monkeypatch.setenv("PIO_SERVING_BACKEND", "host")
    monkeypatch.setenv("PIO_SERVE_PRECISION", "int8")
    with pytest.raises(ValueError, match="PIO_SERVE_PRECISION=int8"):
        served["start"]("port", feedback=False)
