"""The query fleet (``pio deploy --fleet N``): the port's ``QueryFleet``
against the JAX package's, on the CPU.

Each package trains the recommendation template on a memory store of
its own holding the same events; the port's stored model blob is then
replaced by the JAX model's factors, maps and seen lists (carried over
with ``weights.als_model_from_numpy``), so both stores hold the same
factors under instances of the same coordinates. A JAX and a port
``QueryFleet`` of 3 replicas (the port's on ``device="cpu"``, each
replica with its own deployment and device store) take one request
sequence through their balancers:

- the answers are equal (ids equal, scores within 1e-5), and each
  user's queries land on the same replica index in both: the ring's
  first preference;
- ``/``, ``/healthz`` and ``/stats.json`` have equal key trees (with
  addresses, pids and times normalised) and equal replica states;
- a traced query's ``/traces/<id>`` assembles spans of the same names,
  the balancer's span at the root; the federated ``/metrics`` holds the
  same families;
- ``pio status --fleet`` and ``pio top --fleet --once`` print the same
  fleet lines for each package's balancer;
- a rolling ``/reload`` under queries answers the same body (no query
  fails), the answers then equal the second instance's in both, and
  both 409 bodies of a refused roll (one mid-roll, one a downgrade) are
  equal;
- a stopped replica's users are answered by their next replica, marked
  ``degradedReasons: ["replica_down"]``, equal in both;
- a balancer bind failure (``EADDRINUSE``) leaves no replica running.

Also: ``/stats.json`` of a JAX and a port ``QueryServer`` over one
``fleet`` event source carries ``storageFleet`` of the same shape and
shard states; the CLI parsers' ``--fleet`` / ``--slo-config`` equal
JAX's and ``--slo-config`` reaches ``ServerConfig.slo_config``; and a
``pio-torch deploy --device cpu --fleet 2`` child answers through its
balancer until ``pio-torch undeploy``.
"""

import contextlib
import http.client
import importlib
import io
import json
import os
import re
import secrets
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu.workflow import core_workflow as jcore
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.storage.base import Model
from predictionio_tpu_torch.fleet import balancer as tbalancer
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import resilience as tres
from predictionio_tpu_torch.weights import als_model_from_numpy
from predictionio_tpu_torch.workflow import core_workflow as tcore
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

from test_torch_cli import _env, _post
from test_torch_lifecycle import (
    CPU,
    FACTORIES,
    N_USERS,
    configure,
    fill,
    jcw,
    jserver,
    variant,
)

jbalancer = importlib.import_module("predictionio_tpu.fleet.balancer")
REPLICAS = 3
QUERIES = ([{"user": f"u{u}", "num": 5} for u in range(N_USERS)]
           + [{"items": ["i3", "i7"], "num": 4},
              {"user": "u2", "num": 6, "blacklist": ["i1", "i4"]},
              {"user": "u5", "num": 4, "categories": ["g1", "g2"]},
              {"items": ["i11"], "num": 3},
              {"user": "nobody", "num": 3}])


def same_factors(tid, jid):
    """Replace the port instance ``tid``'s model blob with the JAX
    instance ``jid``'s model, carried into the port on the CPU."""
    jm, = jcore.deserialize_models(
        jstorage.get_model_data_models().get(jid).models)
    tm = als_model_from_numpy(
        np.asarray(jm.user_factors), np.asarray(jm.item_factors),
        list(jm.user_map.labels), list(jm.item_map.labels), jm.seen,
        jm.item_categories, device="cpu")
    tstorage.get_model_data_models().insert(
        Model(id=tid, models=tcore.serialize_models([tm])))


def train_both(seed):
    jid = jcw.create_workflow(
        jcw.WorkflowConfig(engine_factory=FACTORIES[0]), variant(seed, False))
    tid = tcw.create_workflow(
        tcw.WorkflowConfig(engine_factory=FACTORIES[1]),
        variant(seed, False), ctx=CPU)
    same_factors(tid, jid)
    return jid, tid


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port fleet of 3 replicas over memory stores holding
    the same factors."""
    saved = {k: os.environ.get(k) for k in ("PIO_SLO_POLL_SEC",
                                            "PIO_SERVE_PRECISION",
                                            "PIO_SERVING_BACKEND")}
    os.environ["PIO_SLO_POLL_SEC"] = "0"
    # the JAX package's device store, as the port's (its auto policy
    # serves a model this small from the host)
    os.environ["PIO_SERVING_BACKEND"] = "device"
    os.environ.pop("PIO_SERVE_PRECISION", None)
    tmp = tmp_path_factory.mktemp("fleet")
    configure(jstorage, "memory", tmp / "jax.db")
    configure(tstorage, "memory", tmp / "port.db")
    fill(jstorage, "predictionio_tpu")
    fill(tstorage, "predictionio_tpu_torch")
    ids = {"first": train_both(3)}
    jf = jbalancer.QueryFleet(jserver.ServerConfig(ip="127.0.0.1", port=0),
                              replicas=REPLICAS).start(undeploy_stale=False)
    tf = tbalancer.QueryFleet(tserver.ServerConfig(ip="127.0.0.1", port=0),
                              replicas=REPLICAS, ctx=CPU).start()
    yield {"jax": jf, "port": tf, "ids": ids, "tmp": tmp}
    tf.stop()
    jf.stop()
    jstorage.reset()
    tstorage.reset()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def base(fleet):
    return "http://%s:%d" % fleet.address


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def request_counts(fleet):
    return [r.server.latency.summary().get("count", 0)
            for r in fleet.replicas]


def assert_same_answer(got, want, q=None):
    assert got.keys() == want.keys(), q
    g, w = got["itemScores"], want["itemScores"]
    assert [s["item"] for s in g] == [s["item"] for s in w], q
    np.testing.assert_allclose([s["score"] for s in g],
                               [s["score"] for s in w], rtol=0, atol=1e-5)
    for k in set(got) - {"itemScores"}:
        assert got[k] == want[k], (q, k)


def key_tree(doc):
    if isinstance(doc, dict):
        return {k: key_tree(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [key_tree(v) for v in doc]
    return type(doc).__name__ if doc is not None else None


def test_answers_and_sticky_routing_equal_the_jax_package(pair):
    jf, tf = pair["jax"], pair["port"]
    before = {pkg: request_counts(pair[pkg]) for pkg in ("jax", "port")}
    for q in QUERIES:
        owner = {}
        for pkg, fleet in (("jax", jf), ("port", tf)):
            counts = request_counts(fleet)
            status, body = _post(base(fleet) + "/queries.json", q)
            assert status == 200, (pkg, q, body)
            owner[pkg] = [b - a for a, b in zip(
                counts, request_counts(fleet))].index(1)
            pair.setdefault(pkg + "_answers", []).append(body)
        assert owner["jax"] == owner["port"], q
        key = q.get("user")
        if key is not None:
            assert owner["port"] == tf.ring.preference(key)[0] \
                == jf.ring.preference(key)[0]
    for got, want, q in zip(pair["port_answers"], pair["jax_answers"],
                            QUERIES):
        assert_same_answer(got, want, q)
    # every replica served, and its own device store answered
    after = request_counts(tf)
    assert all(b > a for a, b in zip(before["port"], after))
    stores = [r.server._deployment.models[0]._server for r in tf.replicas]
    assert len({id(s) for s in stores}) == REPLICAS and all(stores)


def normalise(doc):
    text = json.dumps(doc)
    text = re.sub(r"127\.0\.0\.1:\d+", "<addr>", text)
    text = re.sub(r'"pid": \d+', '"pid": 0', text)
    text = re.sub(r'"(at|since)": "[^"]*"', r'"\1": "<t>"', text)
    return json.loads(text)


def test_status_health_and_stats_key_trees_equal(pair):
    jf, tf = pair["jax"], pair["port"]
    for path in ("/", "/healthz", "/stats.json"):
        (js, jdoc), (ts, tdoc) = (get(base(f) + path) for f in (jf, tf))
        assert js == ts == 200, path
        jdoc, tdoc = normalise(jdoc), normalise(tdoc)
        if path == "/stats.json":
            # the merged registries hold each package's own families
            jdoc.pop("metrics")
            tdoc.pop("metrics")
            assert tdoc["fleet"]["members"] == jdoc["fleet"]["members"]
            for doc in (jdoc, tdoc):
                doc["fleet"]["scrape"]["durationSec"] = 0.0
        fleets = [d.get("fleet") for d in (jdoc, tdoc)]
        if fleets[0]:
            for fl in fleets:
                for rep in fl["replicas"]:
                    rep["engineInstanceId"] = "<id>"
            assert fleets[0]["replicas"] == fleets[1]["replicas"]
            assert fleets[1]["readyReplicas"] == REPLICAS
        assert key_tree(tdoc) == key_tree(jdoc), path
        assert tdoc == jdoc or path == "/stats.json", path


def trace_names(record):
    return sorted(s["name"] for s in record["spans"])


def test_traces_and_federated_metrics_equal(pair):
    jf, tf = pair["jax"], pair["port"]
    records = {}
    for pkg, fleet in (("jax", jf), ("port", tf)):
        tid = secrets.token_hex(16)
        tp = f"00-{tid}-{secrets.token_hex(8)}-01"
        host, port = fleet.address
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": "u4", "num": 3}).encode(),
                     headers={"Content-Type": "application/json",
                              "traceparent": tp})
        resp = conn.getresponse()
        resp.read()
        conn.close()
        assert resp.status == 200
        for _ in range(500):
            status, rec = get(f"{base(fleet)}/traces/{tid}")
            if status == 200 and any(s["name"].startswith("query ")
                                     for s in rec["spans"]):
                break
            time.sleep(0.01)
        assert status == 200, rec
        records[pkg] = rec
        status, index = get(base(fleet) + "/traces.json?limit=5")
        assert status == 200 and "slowLog" in index
        status, missing = get(f"{base(fleet)}/traces/{'0' * 32}")
        assert status == 404
    assert trace_names(records["port"]) == trace_names(records["jax"]), \
        (trace_names(records["port"]), trace_names(records["jax"]))
    spans = {s["name"]: s for s in records["port"]["spans"]}
    root = spans["balancer POST /queries.json"]
    assert root["parentId"] == tp.split("-")[2]  # the client's span
    assert spans["query POST /queries.json"]["parentId"] == root["spanId"]
    families = {}
    for pkg, fleet in (("jax", jf), ("port", tf)):
        with urllib.request.urlopen(base(fleet) + "/metrics",
                                    timeout=30) as resp:
            families[pkg] = tmetrics.parse_prometheus(resp.read().decode())
    fleet_families = {
        pkg: {name for name, fam in fams.items()
              if any(e["labels"].get("server") == "balancer"
                     or name.startswith("pio_slo_")
                     for e in fam["series"])}
        for pkg, fams in families.items()}
    assert fleet_families["port"] == fleet_families["jax"]
    assert {"pio_http_requests_total", "pio_http_request_seconds",
            "pio_slo_burn_rate"} <= fleet_families["port"]


def fleet_lines(text):
    lines = [ln for ln in text.splitlines()
             if re.match(r"(\[\w+\] +)?(Query fleet|member|fleet|slo|SLO)",
                         ln.split("]", 1)[-1].strip()
                         if ln.startswith("[") else ln)]
    out = "\n".join(lines)
    out = re.sub(r"127\.0\.0\.1:\d+", "<addr>", out)
    out = re.sub(r"scrape [\d.]+ms", "scrape <t>ms", out)
    out = re.sub(r"burn fast [\d.]+ / slow [\d.]+", "burn <b>", out)
    out = re.sub(r"budget left [\d.]+%", "budget left <b>", out)
    return out


@pytest.mark.parametrize("verb", ["status", "top"])
def test_status_and_top_fleet_text_equal(pair, verb):
    texts = {}
    for pkg, cli, fleet in (("jax", jcli, pair["jax"]),
                            ("port", tcli, pair["port"])):
        argv = ["status", "--fleet", base(fleet)] if verb == "status" \
            else ["top", "--once", "--fleet", "--url", base(fleet)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert cli.main(argv) == 0
        texts[pkg] = out.getvalue()
    assert fleet_lines(texts["port"]) == fleet_lines(texts["jax"])
    if verb == "status":
        assert "[INFO] Query fleet: 3/3 replicas ready" in texts["port"]
        assert "[INFO] SLO alerts: none firing" in texts["port"]
    else:
        assert "member   balancer" in texts["port"]
        assert "has no federated fleet block" not in texts["port"]


def test_cli_fleet_options_parse_as_the_jax_options(tmp_path):
    slo = '{"burnThreshold": 3}'
    for argv in (["deploy", "--fleet", "3", "--slo-config", slo],
                 ["status", "--fleet", "http://h:1"],
                 ["top", "--fleet", "--once", "--url", "http://h:1"]):
        want = vars(jcli.build_parser().parse_args(argv))
        got = vars(tcli.build_parser().parse_args(argv))
        got.pop("device", None)
        assert got.pop("func").__name__ == want.pop("func").__name__
        assert got == want
    seen = {}

    class Fleet:
        def __init__(self, config, replicas, instance=None, ctx=None):
            seen.update(config=config, replicas=replicas, ctx=ctx)
            raise RuntimeError("stop here")

    args = tcli.build_parser().parse_args(
        ["deploy", "--device", "cpu", "--fleet", "3", "--slo-config", slo,
         "--engine-variant", str(tmp_path / "engine.json")])
    from predictionio_tpu_torch.tools import run_commands

    saved = tbalancer.QueryFleet, tserver.resolve_engine_instance
    tbalancer.QueryFleet = Fleet
    tserver.resolve_engine_instance = lambda *a: None
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert run_commands.cmd_deploy(args) == 1
    finally:
        tbalancer.QueryFleet, tserver.resolve_engine_instance = saved
    assert "stop here" in err.getvalue()
    assert seen["config"].slo_config == slo and seen["replicas"] == 3
    assert str(seen["ctx"].device) == "cpu"


def test_rolling_reload_and_refusals_equal_the_jax_package(pair):
    jf, tf = pair["jax"], pair["port"]
    ids = pair["ids"]
    ids["second"] = train_both(4)
    names = {ids["first"][0]: "<first>", ids["second"][0]: "<second>",
             ids["first"][1]: "<first>", ids["second"][1]: "<second>"}

    def named(doc):
        # the port's refusal says "older" where the JAX package's says
        # "OLDER"
        text = json.dumps(doc).replace(" is OLDER than ", " is older than ")
        for iid, name in names.items():
            text = text.replace(iid, name)
        return json.loads(re.sub(r"\d{4}-\d\d-\d\dT[\d:.+]+", "<t>", text))

    bodies, failures = {}, []
    for pkg, fleet in (("jax", jf), ("port", tf)):
        stop = threading.Event()
        answers = []

        def hammer():
            while not stop.is_set():
                status, body = _post(base(fleet) + "/queries.json",
                                     {"user": "u3", "num": 2})
                if status != 200:
                    failures.append((pkg, status, body))
                answers.append(body)
                time.sleep(0.002)  # queries all through the roll, not a spin

        th = threading.Thread(target=hammer, daemon=True)
        th.start()
        try:
            status, bodies[pkg] = _post(base(fleet) + "/reload", {})
        finally:
            stop.set()
            th.join(timeout=30)
        assert status == 200 and answers
    assert not failures
    assert named(bodies["port"]) == named(bodies["jax"])
    assert [r["replica"] for r in bodies["port"]["replicas"]] == [0, 1, 2]
    for q in QUERIES:
        (js, jb), (ts, tb) = (_post(base(f) + "/queries.json", q)
                              for f in (jf, tf))
        assert js == ts == 200
        assert_same_answer(tb, jb, q)

    # a refusal mid-roll: replica 1 refuses, replica 0 was swapped
    refused = {}
    for pkg, fleet, mod in (("jax", jf, jserver), ("port", tf, tserver)):
        rep1 = fleet.replicas[1]

        def refuse():
            raise mod.ReloadDowngradeError("refusing to reload: downgrade")

        rep1.server.reload = refuse
        try:
            refused[pkg] = _post(base(fleet) + "/reload", {})
        finally:
            del rep1.server.reload
        assert all(not r.draining for r in fleet.replicas)
    assert refused["port"][0] == refused["jax"][0] == 409
    assert named(refused["port"][1]) == named(refused["jax"][1])
    assert [r["replica"] for r in refused["port"][1]["replicas"]] == [0]

    # a downgrade: the newer instance is gone, the roll stops at once
    jstorage.get_metadata_engine_instances().delete(ids["second"][0])
    tstorage.get_metadata_engine_instances().delete(ids["second"][1])
    (js, jb), (ts, tb) = (_post(base(f) + "/reload", {}) for f in (jf, tf))
    assert js == ts == 409
    assert named(tb) == named(jb) and tb["replicas"] == []
    for pkg in ("jax", "port"):
        status, health = get(base(pair[pkg]) + "/healthz")
        assert status == 200 and health["ready"] is True


def test_replica_down_fails_over_like_the_jax_package(pair):
    jf, tf = pair["jax"], pair["port"]
    users = [f"u{u}" for u in range(N_USERS)]
    owner = tf.ring.preference("u5")[0]
    for fleet in (jf, tf):
        fleet.replicas[owner].server.stop()
    moved = [u for u in users if tf.ring.preference(u)[0] == owner]
    for u in moved[:4] + ["u0"]:
        q = {"user": u, "num": 3}
        answer = {}
        for pkg, fleet in (("jax", jf), ("port", tf)):
            counts = request_counts(fleet)
            status, answer[pkg] = _post(base(fleet) + "/queries.json", q)
            assert status == 200
            served = [b - a for a, b in zip(counts, request_counts(fleet))]
            want = next(i for i in fleet.ring.preference(u)
                        if i != owner)
            assert served.index(1) == want
        assert_same_answer(answer["port"], answer["jax"], q)
        if u in moved:
            assert answer["port"]["degraded"] is True
            assert answer["port"]["degradedReasons"] == ["replica_down"]
        else:
            assert "degraded" not in answer["port"]
    tops = []
    for fleet in (jf, tf):
        status, health = get(base(fleet) + "/healthz")
        assert status == 200 and health["ready"] is True
        status, top = get(base(fleet) + "/")
        tops.append(normalise(top)["fleet"])
        # a stopped replica has no address; its failed forwards count
        assert top["fleet"]["replicas"][owner]["address"] is None
        assert top["fleet"]["replicas"][owner]["forwardErrors"] >= 1
    for fl in tops:
        for rep in fl["replicas"]:
            rep["engineInstanceId"] = "<id>"
    assert tops[1] == tops[0]


def test_balancer_bind_failure_leaves_no_replica_running(pair):
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        for mod, fleet_mod, kw in (
                (jserver, jbalancer, {}), (tserver, tbalancer, {"ctx": CPU})):
            qf = fleet_mod.QueryFleet(
                mod.ServerConfig(ip="127.0.0.1", port=port), replicas=2,
                **kw)
            with pytest.raises(OSError):
                qf.start(undeploy_stale=False)
            assert all(rep.server._httpd is None for rep in qf.replicas)
    finally:
        blocker.close()
    srv = tbalancer.QueryFleet.__init__
    with pytest.raises(ValueError, match="at least 1 replica"):
        srv(object.__new__(tbalancer.QueryFleet),
            tserver.ServerConfig(), replicas=0)


def test_stats_json_carries_the_storage_fleet_like_jax(pair, tmp_path,
                                                        monkeypatch):
    """A JAX and a port ``QueryServer`` over one ``fleet`` event source
    (two port event servers as its shards): both ``/stats.json`` carry
    ``storageFleet``, with equal key trees and shard states, and a dead
    shard reads the same in both. Runs last: it re-points both storage
    registries."""
    from test_torch_fleet import KEY, ShardCluster, entity_on, rate

    monkeypatch.setenv("PIO_STORAGE_RETRY_BASE", "0.005")
    monkeypatch.setenv("PIO_STORAGE_RETRY_MAX", "0.02")
    monkeypatch.setenv("PIO_STORAGE_CONNECT_TIMEOUT", "1.0")
    jid, tid = pair["ids"]["first"]
    saved = {"jax": (jstorage.get_metadata_engine_instances().get(jid),
                     jstorage.get_model_data_models().get(jid)),
             "port": (tstorage.get_metadata_engine_instances().get(tid),
                      tstorage.get_model_data_models().get(tid))}
    cluster = ShardCluster("port", "memory", tmp_path, n=2)
    servers = []
    try:
        for st, pkg in ((jstorage, "jax"), (tstorage, "port")):
            st.reset(st.StorageConfig(
                sources={"F": {"type": "fleet", "urls": cluster.cfg["urls"],
                               "service_key": KEY},
                         "M": {"type": "memory"}},
                repositories={"EVENTDATA": "F", "METADATA": "M",
                              "MODELDATA": "M"}))
            inst, blob = saved[pkg]
            st.get_metadata_engine_instances().insert(inst)
            st.get_model_data_models().insert(blob)
        jsrv = jserver.QueryServer(jserver.ServerConfig(
            ip="127.0.0.1", port=0)).start(undeploy_stale=False)
        servers.append(jsrv)
        tsrv = tserver.QueryServer(
            tserver.ServerConfig(ip="127.0.0.1", port=0),
            tserver.build_deployment(tserver.resolve_engine_instance(None),
                                     CPU)).start()
        servers.append(tsrv)

        def topologies():
            out = []
            for srv in (jsrv, tsrv):
                status, stats = get("http://%s:%d/stats.json" % srv.address)
                assert status == 200
                out.append(stats["storageFleet"])
            return out

        jt, tt = topologies()
        assert key_tree(tt) == key_tree(jt)
        assert tt == jt and tt["healthyShards"] == 2
        cluster.kill_shard(1)
        dead = entity_on(cluster.fleet, 1)
        for st, pkg in ((jstorage, "jax"), (tstorage, "port")):
            with pytest.raises(Exception, match="shard|refused|failed"):
                st.get_levents().insert(rate(dead, "i1", 1, pkg), 1)
        jt, tt = topologies()
        assert [s["breakerState"] for s in tt["shards"]] == \
            [s["breakerState"] for s in jt["shards"]]
        assert [s["index"] for s in tt["shards"]] == [0, 1]
    finally:
        for srv in servers:
            srv.stop()
        cluster.close()
        jres.reset_breakers()
        tres.reset_breakers()


def test_deploy_fleet_child_answers_until_undeploy(tmp_path, capsys):
    """``pio-torch deploy --device cpu --fleet 2`` over a sqlite store (a
    child process): the balancer answers as the instance loaded in this
    process, ``/stats.json`` reads 2/2 replicas, and ``pio-torch
    undeploy`` stops the balancer and both replicas."""
    configure(tstorage, "sqlite", tmp_path / "port.db")
    try:
        fill(tstorage, "predictionio_tpu_torch")
        tcw.create_workflow(tcw.WorkflowConfig(engine_factory=FACTORIES[1]),
                            variant(5, False), ctx=CPU)
        dep = tserver.build_deployment(tserver.resolve_engine_instance(None),
                                       CPU)
        want = [tserver.to_jsonable(tserver.serve_query(
            dep, tserver.query_from_json(q, dep.algorithms[0].query_class)))
            for q in QUERIES[:8]]
    finally:
        tstorage.reset()
    env = dict(_env(tmp_path / "port.db"), PIO_SLO_POLL_SEC="0")
    child = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console",
         "deploy", "--device", "cpu", "--ip", "127.0.0.1", "--port", "0",
         "--fleet", "2", "--engine-variant", "engine.json"],
        env=env, stdout=subprocess.PIPE, text=True, cwd=tmp_path)
    try:
        line = child.stdout.readline()
        assert "2-replica fleet" in line, line
        port = int(re.search(r"live at http://127\.0\.0\.1:(\d+)",
                             line).group(1))
        url = f"http://127.0.0.1:{port}"
        got = [_post(url + "/queries.json", q) for q in QUERIES[:8]]
        for (status, body), w in zip(got, want):
            assert status == 200
            assert_same_answer(body, w)
        status, stats = get(url + "/stats.json")
        assert stats["fleet"]["readyReplicas"] == 2
        addresses = [r["address"] for r in stats["fleet"]["replicas"]]
        assert tcli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                          str(port)]) == 0
        assert child.wait(timeout=60) == 0
        assert '"fused_gather_score_topk": 0' in child.stdout.read()
        for address in [url] + [f"http://{a}" for a in addresses]:
            with pytest.raises(urllib.error.URLError):
                urllib.request.urlopen(address + "/", timeout=5)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
