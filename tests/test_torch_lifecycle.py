"""Train from the event store, deploy from the stored instance, reload:
the port against the JAX package, on the CPU.

Each package gets a store of its own (``memory`` or ``sqlite``) holding
the same rating events and category ``$set`` events. Each trains with
``create_workflow`` (the port's factory resolved by name, one shared
init injected as in ``tests/test_torch_train_e2e.py``), resolves the
latest completed instance and builds a deployment from it. The port's
deployment answers over HTTP; every answer must agree with the JAX
deployment's ``serve_query`` to the tolerance of the train test. A
second instance (the next seed) is trained and ``POST /reload`` swaps
to it under queries; the answers then agree with the JAX package's
second deployment, and a reload to an older instance answers 409. A
second interpreter, with ``jax`` and ``predictionio_tpu`` unimportable,
deploys the same sqlite file and answers exactly as the first. A blob
pickled with a class of the JAX package is refused without importing
it.
"""

import datetime as dt
import importlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.core.context import workflow_context
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.storage.base import StorageError
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

# the JAX package's workflow/__init__ exports functions of these names
jcw = importlib.import_module("predictionio_tpu.workflow.create_workflow")
jserver = importlib.import_module("predictionio_tpu.workflow.create_server")
ROOT = pathlib.Path(__file__).resolve().parents[1]
FACTORIES = ("predictionio_tpu.templates.recommendation.engine:"
             "engine_factory",
             "predictionio_tpu_torch.templates.recommendation.engine:"
             "engine_factory")
N_USERS, N_ITEMS, N_RATINGS, RANK, TOL = 30, 50, 600, 6, 1e-3
UTC = dt.timezone.utc
CPU = ComputeContext(device="cpu")


def variant(seed, bucketed):
    return {"id": "default",
            "datasource": {"params": {"appName": "MyApp",
                                      "eventNames": ["rate", "view"],
                                      "readItemCategories": True,
                                      "streamingBlockSize": 97}},
            "preparator": {"params": {"bucketed": bucketed}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": 5, "lambda": 0.05,
                "seed": seed}}]}


def jax_init(n_rows, n_cols, rank, seed, device=None):
    X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
    return (torch.from_numpy(np.array(X)).to(device),
            torch.from_numpy(np.array(Y)).to(device))


def fill(st, pkg):
    """``MyApp`` with seeded rate / view events and item categories."""
    base = importlib.import_module(f"{pkg}.data.storage.base")
    Event = importlib.import_module(f"{pkg}.data.event").Event
    aid = st.get_metadata_apps().insert(base.App(0, "MyApp"))
    st.get_metadata_access_keys().insert(base.AccessKey("", aid, ()))
    rng = np.random.default_rng(21)
    t0 = dt.datetime(2023, 5, 1, tzinfo=UTC)
    evs = [Event(event="rate" if j % 5 else "view", entity_type="user",
                 entity_id=f"u{rng.integers(0, N_USERS)}",
                 target_entity_type="item",
                 target_entity_id=f"i{rng.integers(0, N_ITEMS)}",
                 properties={"rating": float(rng.integers(1, 11) * 0.5)}
                 if j % 5 else {},
                 event_time=t0 + dt.timedelta(seconds=j))
           for j in range(N_RATINGS)]
    evs += [Event(event="$set", entity_type="item", entity_id=f"i{i}",
                  properties={"categories": [f"g{i % 4}"]}, event_time=t0)
            for i in range(N_ITEMS)]
    st.get_levents().init(aid)
    st.get_levents().insert_batch(evs, aid)


def configure(st, backend, path):
    src = {"type": "memory"} if backend == "memory" else {
        "type": "sqlite", "path": str(path)}
    st.reset(st.StorageConfig(
        sources={"S": src},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}))


@pytest.fixture
def stores(tmp_path, monkeypatch):
    monkeypatch.setattr(tals, "init_factors", jax_init)
    monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)

    def setup(backend):
        configure(jstorage, backend, tmp_path / "jax.db")
        configure(tstorage, backend, tmp_path / "port.db")
        fill(jstorage, "predictionio_tpu")
        fill(tstorage, "predictionio_tpu_torch")
        return tmp_path / "port.db"

    yield setup
    jstorage.reset()
    tstorage.reset()


def train_both(seed, bucketed):
    jid = jcw.create_workflow(
        jcw.WorkflowConfig(engine_factory=FACTORIES[0]),
        variant(seed, bucketed))
    tid = tcw.create_workflow(
        tcw.WorkflowConfig(engine_factory=FACTORIES[1]),
        variant(seed, bucketed), ctx=CPU)
    assert jid and tid
    return jid, tid


def jax_deployment():
    inst = jserver.resolve_engine_instance(None)
    return jserver.build_deployment(inst, workflow_context(mode="serving"))


QUERIES = ([{"user": f"u{u}", "num": 5} for u in range(N_USERS)]
           + [{"items": ["i3", "i7"], "num": 4},
              {"user": "u2", "num": 6, "blacklist": ["i1", "i4"]},
              {"user": "u5", "num": 4, "categories": ["g1", "g2"]},
              {"user": "nobody", "num": 3}])


def post(url, payload=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode()
                                 if payload is not None else b"",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def assert_same_answers(answers, jdep):
    """Per the train test: scores within TOL of the query's largest,
    items equal wherever the JAX scores are separated."""
    ranks = 0
    for q, got in zip(QUERIES, answers):
        want = jserver.serve_query(jdep, jserver.query_from_json(
            q, jdep.algorithms[0].query_class))
        g_items = [s["item"] for s in got["itemScores"]]
        w_items = [s.item for s in want.item_scores]
        assert len(g_items) == len(w_items), q
        if not w_items:
            continue
        w_scores = np.asarray([s.score for s in want.item_scores])
        tol = TOL * float(np.abs(w_scores).max())
        np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                                   w_scores, rtol=0, atol=tol)
        gaps = np.abs(np.diff(w_scores))
        for j, (a, b) in enumerate(zip(g_items, w_items)):
            if (j == 0 or gaps[j - 1] > 2 * tol) and (
                    j == len(w_items) - 1 or gaps[j] > 2 * tol):
                assert a == b, (q, g_items, w_items)
                ranks += 1
    assert ranks >= 0.8 * 5 * N_USERS


@pytest.mark.parametrize("backend, bucketed", [("memory", False),
                                               ("sqlite", True)])
def test_train_deploy_reload_answer_like_the_jax_package(stores, backend,
                                                         bucketed):
    db = stores(backend)
    jid, tid = train_both(3, bucketed)
    inst = tserver.resolve_engine_instance(None)
    assert inst.id == tid and inst.status == "COMPLETED"
    assert json.loads(inst.data_source_params)["params"][
        "streaming_block_size"] == 97
    assert tstorage.get_model_data_models().get(tid) is not None
    dep = tserver.build_deployment(inst, CPU)
    assert dep.models[0].device == "cpu" and dep.instance.id == tid
    server = tserver.QueryServer(
        tserver.ServerConfig(ip="127.0.0.1", port=0), dep).start()
    try:
        host, port = server.address
        base = f"http://{host}:{port}"
        first = [post(base + "/queries.json", q)[1] for q in QUERIES]
        assert_same_answers(first, jax_deployment())

        if backend == "sqlite":
            child = deploy_in_another_interpreter(db)
            assert child["instance"] == tid
            assert child["answers"] == first

        jid2, tid2 = train_both(4, bucketed)
        statuses, stop = [], threading.Event()

        def hammer():
            while not stop.is_set():
                statuses.append(post(base + "/queries.json", QUERIES[0])[0])

        clients = [threading.Thread(target=hammer) for _ in range(4)]
        for c in clients:
            c.start()
        try:
            status, body = post(base + "/reload")
        finally:
            stop.set()
            for c in clients:
                c.join()
        assert status == 200, body
        assert (body["swappedFrom"], body["swappedTo"]) == (tid, tid2)
        assert statuses and set(statuses) == {200}
        second = [post(base + "/queries.json", q)[1] for q in QUERIES]
        assert second != first
        assert_same_answers(second, jax_deployment())

        # the newer instance gone, the latest completed is the older one
        assert tstorage.get_metadata_engine_instances().delete(tid2)
        status, body = post(base + "/reload")
        assert status == 409 and "older" in body["message"], body
        assert [post(base + "/queries.json", q)[1] for q in QUERIES] \
            == second
    finally:
        server.stop()


CHILD = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["predictionio_tpu"] = None
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.workflow.create_server import (
    build_deployment, resolve_engine_instance, serve_query, to_jsonable,
    query_from_json)
queries = json.loads(sys.argv[1])
inst = resolve_engine_instance(None)
dep = build_deployment(inst, ComputeContext(device="cpu"))
qc = dep.algorithms[0].query_class
answers = [to_jsonable(serve_query(dep, query_from_json(q, qc)))
           for q in queries]
assert not any(m == "jax" or m.startswith(("jax.", "predictionio_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print(json.dumps({"instance": inst.id, "answers": answers}))
"""


def deploy_in_another_interpreter(db):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env.update(PYTHONPATH=str(ROOT), PIO_STORAGE_SOURCES_S_TYPE="sqlite",
               PIO_STORAGE_SOURCES_S_PATH=str(db))
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(QUERIES)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


REFUSE = r"""
import sys
sys.modules["predictionio_tpu"] = None
from predictionio_tpu_torch.data.storage.base import StorageError
from predictionio_tpu_torch.workflow.core_workflow import deserialize_models
try:
    deserialize_models(open(sys.argv[1], "rb").read())
except StorageError as e:
    print("refused:", e)
"""


def test_a_jax_stored_model_is_refused_without_importing_it(tmp_path):
    from predictionio_tpu.data.storage.base import App
    from predictionio_tpu.workflow import core_workflow as jcore

    blob = jcore.serialize_models([App(1, "jax-made")])
    (tmp_path / "blob").write_bytes(blob)
    proc = subprocess.run([sys.executable, "-c", REFUSE,
                           str(tmp_path / "blob")],
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("refused:")
    assert "predictionio_tpu.data.storage.base.App" in proc.stdout
    with pytest.raises(StorageError, match="JAX package"):
        core_workflow.deserialize_models(blob)
    # a blob without the envelope is refused the same way
    with pytest.raises(StorageError, match="JAX package"):
        core_workflow.deserialize_models(pickle.dumps([App(2, "x")]))
    torn = bytearray(core_workflow.serialize_models([1, 2]))
    torn[-1] ^= 1
    with pytest.raises(core_workflow.ModelIntegrityError):
        core_workflow.deserialize_models(bytes(torn))
    with pytest.raises(ValueError, match="JAX package"):
        core_workflow.load_engine_factory(FACTORIES[0])


def test_workflow_edges(stores):
    """A stop-after flag returns None and leaves no model; a failing
    training marks its instance FAILED; fold-in on deploy starts a
    consumer tailing the data source's app, stopped with the server."""
    stores("memory")
    config = tcw.WorkflowConfig(engine_factory=FACTORIES[1],
                                stop_after_prepare=True)
    assert tcw.create_workflow(config, variant(3, True), ctx=CPU) is None
    bad = variant(3, True)
    bad["datasource"]["params"]["appName"] = "NoSuchApp"
    with pytest.raises(ValueError, match="NoSuchApp"):
        tcw.create_workflow(tcw.WorkflowConfig(engine_factory=FACTORIES[1]),
                            bad, ctx=CPU)
    statuses = sorted(i.status for i in
                      tstorage.get_metadata_engine_instances().get_all())
    assert statuses == ["FAILED", "INIT"]
    with pytest.raises(StorageError, match="Try running train first"):
        tserver.resolve_engine_instance(None)
    from predictionio_tpu_torch.templates.recommendation.engine import (
        engine_factory,
    )
    from predictionio_tpu_torch.weights import als_model_from_numpy

    rng = np.random.default_rng(0)
    model = als_model_from_numpy(
        rng.normal(size=(3, RANK)), rng.normal(size=(N_ITEMS, RANK)),
        ["u0", "u1", "u2"], [f"i{i}" for i in range(N_ITEMS)], {0: [1]},
        device="cpu")
    engine = engine_factory()
    dep = tserver.deployment_from_models(
        engine, engine.engine_params_from_variant(variant(3, True)), [model])
    srv = tserver.QueryServer(tserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True), dep).start()
    try:
        consumer = srv._foldin
        assert consumer is not None and consumer._thread.is_alive()
        assert consumer._scope == (tstorage.get_metadata_apps().get_by_name(
            "MyApp").id, None)
        assert consumer._cfg.event_names == ("rate", "view")
    finally:
        srv.stop()
    assert srv._foldin is None and consumer._thread is None
