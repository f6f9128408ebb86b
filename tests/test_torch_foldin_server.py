"""Online fold-in in the deployed server: the port's slice against the
JAX package's, on the CPU.

The slice differential: the JAX package trains the recommendation
template on a store (``memory`` or ``sqlite``) and deploys it with
``ServerConfig(foldin=True)``; its model's factors, maps and seen lists
are carried into the port with ``weights.als_model_from_numpy``, and the
port deploys them with ``ServerConfig(foldin=True)`` over a store of its
own holding the same events. Both take the same post-deploy events (new
users, known users' new ratings, and events the consumer must ignore).
After the folds both ``user_map``s are equal, the store rows are equal
(the untouched ones exactly, the patched ones to 1e-4 of the largest
entry, the half-step bound of ``tests/test_torch_foldin.py``), and every
``handle_query`` answer is equal: the same items, the scores within
rtol 1e-4.

Port-only: a stale tail stamps ``degradedReasons: ["foldin_stale"]`` and
counts ``pio_degraded_queries_total`` until the tail recovers;
``/reload`` starts the candidate's consumer before the swap (a refusal
keeps the deployed engine and its consumer); ``PIO_FOLDIN`` is set while
the server runs and restored at stop; ``pio deploy --device cpu --foldin
on`` (a child process) serves a new user once its events reach the
port's event server.
"""

import datetime as dt
import importlib
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.online import foldin as tfoldin
from predictionio_tpu_torch.templates.recommendation.engine import (
    engine_factory,
)
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.weights import als_model_from_numpy
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

from test_torch_lifecycle import (  # noqa: F401
    CPU,
    FACTORIES,
    jcw,
    stores,
    variant,
)

jserver = importlib.import_module("predictionio_tpu.workflow.create_server")
UTC = dt.timezone.utc
TOL = 1e-4


@pytest.fixture
def foldin_env(monkeypatch):
    monkeypatch.setenv("PIO_FOLDIN_INTERVAL", "0.2")
    monkeypatch.delenv("PIO_FOLDIN", raising=False)


def post_deploy_events(Event):
    """New users, known users' new ratings, and what the consumer must
    ignore: an event outside the data source's names, an item ``$set``,
    and a user whose only rating names an item the model does not know."""
    t0 = dt.datetime(2023, 6, 1, tzinfo=UTC)

    def ev(j, user, item, name="rate", rating=4.0):
        return Event(event=name, entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id=item,
                     properties={"rating": rating} if name == "rate" else {},
                     event_time=t0 + dt.timedelta(seconds=j))

    evs = [ev(0, "n1", "i3", rating=5.0), ev(1, "n1", "i7"),
           ev(2, "n2", "i1", rating=2.5), ev(3, "n2", "i4"),
           ev(4, "n2", "i9", "view"), ev(5, "u1", "i11", rating=5.0),
           ev(6, "u2", "i2", rating=1.0), ev(7, "u2", "i2", rating=3.0),
           ev(8, "n3", "i40"), ev(9, "n4", "no-such-item"),
           ev(10, "n1", "i5", "buy"), ev(11, "u3", "i6", "buy")]
    evs.append(Event(event="$set", entity_type="item", entity_id="i8",
                     properties={"categories": ["g9"]}, event_time=t0))
    return evs


def wait_folded(consumer, users, deadline=60.0):
    t0 = time.time()
    while time.time() - t0 < deadline:
        st = consumer.stats()
        if st["usersPatched"] >= users and st["pendingEvents"] == 0:
            return st
        time.sleep(0.05)
    raise AssertionError(f"not folded in time: {consumer.stats()}")


def store_rows(srv):
    X = srv._X
    return X.float().numpy() if hasattr(X, "float") else \
        np.asarray(X, np.float32)


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_the_slice_against_the_jax_package(stores, foldin_env, backend):
    stores(backend)
    jid = jcw.create_workflow(jcw.WorkflowConfig(
        engine_factory=FACTORIES[0]), variant(3, True))
    assert jid
    jsrv = jserver.QueryServer(jserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True)).start(undeploy_stale=False)
    tsrv = None
    try:
        jm = jsrv._deployment.models[0]
        tm = als_model_from_numpy(
            np.asarray(jm.user_factors), np.asarray(jm.item_factors),
            list(jm.user_map.labels), list(jm.item_map.labels), jm.seen,
            jm.item_categories, device="cpu")
        engine = engine_factory()
        dep = tserver.deployment_from_models(
            engine, engine.engine_params_from_variant(variant(3, True)),
            [tm])
        tsrv = tserver.QueryServer(tserver.ServerConfig(
            ip="127.0.0.1", port=0, foldin=True), dep).start()
        assert os.environ["PIO_FOLDIN"] == "1"
        n_known = len(tm.user_map)
        before = store_rows(tm.device_server())[:n_known].copy()
        jaid = jstorage.get_metadata_apps().get_by_name("MyApp").id
        taid = tstorage.get_metadata_apps().get_by_name("MyApp").id
        jstorage.get_levents().insert_batch(post_deploy_events(JEvent), jaid)
        tstorage.get_levents().insert_batch(post_deploy_events(TEvent), taid)
        # n1, n2, n3 new; u1, u2 known; n4 rated only an unknown item
        jst = wait_folded(jsrv._foldin, 5)
        tst = wait_folded(tsrv._foldin, 5)
        assert tst["newUsers"] == jst["newUsers"] == 3
        assert list(tm.user_map.labels) == list(jm.user_map.labels)
        assert "n4" not in tm.user_map
        n = len(tm.user_map)
        trows = store_rows(tm.device_server())[:n]
        jrows = np.asarray(jm.device_server()._X, np.float32)[:n]
        touched = [tm.user_map[u] for u in ("u1", "u2", "n1", "n2", "n3")]
        untouched = np.setdiff1d(np.arange(n_known), touched)
        np.testing.assert_array_equal(trows[untouched], before[untouched])
        scale = max(1.0, float(np.abs(jrows).max()))
        assert np.abs(trows[touched] - jrows[touched]).max() <= TOL * scale
        for u in ("u1", "u2", "n1", "n2", "n3"):
            np.testing.assert_array_equal(
                np.sort(tm.seen[tm.user_map[u]]),
                np.sort(np.asarray(jm.seen[jm.user_map[u]])))
        users = list(tm.user_map.labels) + ["n4", "nobody"]
        for u in users:
            body = json.dumps({"user": u, "num": 6}).encode()
            ts, tans = tsrv.handle_query(body)
            js, jans = jsrv.handle_query(body)
            assert ts == js == 200
            assert [s["item"] for s in tans["itemScores"]] == \
                [s["item"] for s in jans["itemScores"]], u
            np.testing.assert_allclose(
                [s["score"] for s in tans["itemScores"]],
                [s["score"] for s in jans["itemScores"]], rtol=TOL,
                atol=TOL)
        ans = tsrv.handle_query(b'{"user": "n1", "num": 50}')[1]
        assert {"i3", "i7"}.isdisjoint(s["item"] for s in ans["itemScores"])
        status = tsrv.status()["foldin"]
        assert status["folds"] >= 1 and status["stale"] is False
        assert tsrv.stats_json()["foldin"]["newUsers"] == 3
    finally:
        if tsrv is not None:
            tsrv.stop()
        jsrv.stop()
    assert "PIO_FOLDIN" not in os.environ


def trained_port_deployment(stores):
    stores("memory")
    assert tcw.create_workflow(tcw.WorkflowConfig(
        engine_factory=FACTORIES[1]), variant(3, True), ctx=CPU)
    return tserver.build_deployment(tserver.resolve_engine_instance(None),
                                    CPU)


def test_stale_tail_degrades_then_recovers(stores, foldin_env,
                                           monkeypatch):
    dep = trained_port_deployment(stores)
    srv = tserver.QueryServer(tserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True), dep).start()
    le = type(tstorage.get_levents())
    real = le.find_since

    def failing(self, *args, **kwargs):
        raise OSError("event store unreachable")

    def count():
        return tmetrics.DEGRADED_QUERIES.value(reason="foldin_stale")

    try:
        ok = srv.handle_query(b'{"user": "u1", "num": 3}')[1]
        assert "degraded" not in ok
        monkeypatch.setattr(le, "find_since", failing)
        deadline = time.time() + 10
        while time.time() < deadline and not srv._foldin.stale:
            time.sleep(0.05)
        assert srv._foldin.stale and srv.status()["foldin"]["stale"]
        n0 = count()
        status, ans = srv.handle_query(b'{"user": "u1", "num": 3}')
        assert status == 200 and ans["itemScores"] == ok["itemScores"]
        assert ans["degraded"] is True
        assert ans["degradedReasons"] == ["foldin_stale"]
        assert count() == n0 + 1
        assert tmetrics.FOLDIN_STALE.value() == 1
        monkeypatch.setattr(le, "find_since", real)
        deadline = time.time() + 10
        while time.time() < deadline and srv._foldin.stale:
            time.sleep(0.05)
        assert not srv._foldin.stale
        assert srv.status()["foldin"]["tailErrors"] >= 1
        again = srv.handle_query(b'{"user": "u1", "num": 3}')[1]
        assert "degraded" not in again and count() == n0 + 1
    finally:
        srv.stop()


def test_reload_starts_the_candidates_consumer_before_the_swap(
        stores, foldin_env, monkeypatch):
    dep = trained_port_deployment(stores)
    srv = tserver.QueryServer(tserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True), dep).start()
    try:
        first = srv._foldin
        assert first._thread.is_alive()
        assert tcw.create_workflow(tcw.WorkflowConfig(
            engine_factory=FACTORIES[1]), variant(4, True), ctx=CPU)
        real = tfoldin.attach_foldin

        def refuse(deployment, **kwargs):
            raise ValueError("--foldin on: refused for the test")

        monkeypatch.setattr(tfoldin, "attach_foldin", refuse)
        with pytest.raises(ValueError, match="refused"):
            srv.reload()
        assert srv._deployment is dep and srv._foldin is first
        assert first._thread.is_alive()
        monkeypatch.setattr(tfoldin, "attach_foldin", real)
        info = srv.reload()
        assert srv._deployment is not dep
        assert srv._deployment.instance.id == info["swappedTo"]
        assert srv._foldin is not first and first._thread is None
        assert srv._foldin._model is srv._deployment.models[0]
    finally:
        srv.stop()
    assert srv._foldin is None and "PIO_FOLDIN" not in os.environ


def test_a_refused_start_restores_pio_foldin(
        stores, foldin_env, monkeypatch):
    dep = trained_port_deployment(stores)
    monkeypatch.setenv("PIO_FOLDIN", "off")
    dep.engine_params = dataclasses_replace_app(dep.engine_params, "")
    srv = tserver.QueryServer(tserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True), dep)
    with pytest.raises(ValueError, match="no app_name"):
        srv.start()
    assert os.environ["PIO_FOLDIN"] == "off" and srv._foldin is None
    srv.stop()


def dataclasses_replace_app(engine_params, app_name):
    import dataclasses

    name, dsp = engine_params.data_source_params
    return dataclasses.replace(
        engine_params, data_source_params=(
            name, dataclasses.replace(dsp, app_name=app_name)))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_pio_deploy_foldin_on_serves_a_new_user(tmp_path, capsys):
    from test_torch_cli import _engine_dir, _env
    from test_torch_lifecycle import configure, fill
    from predictionio_tpu_torch.tools import cli as tcli

    configure(tstorage, "sqlite", tmp_path / "port.db")
    try:
        fill(tstorage, "predictionio_tpu_torch")
        path = _engine_dir(tmp_path, capsys)
        assert tcli.main(["train", "--device", "cpu", "--engine-variant",
                          str(path)]) == 0
        aid = tstorage.get_metadata_apps().get_by_name("MyApp").id
        key = tstorage.get_metadata_access_keys().get_by_appid(aid)[0].key
        env = dict(_env(tmp_path / "port.db"), PIO_FOLDIN_INTERVAL="0.2")
        env.pop("PIO_FOLDIN", None)
        child = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.console",
             "deploy", "--device", "cpu", "--ip", "127.0.0.1", "--port",
             "0", "--foldin", "on", "--engine-variant", str(path)],
            env=env, stdout=subprocess.PIPE, text=True, cwd=str(tmp_path))
        events = EventServer(EventServerConfig(ip="127.0.0.1",
                                               port=0)).start()
        try:
            line = child.stdout.readline()
            port = int(re.search(r"live at http://127\.0\.0\.1:(\d+)",
                                 line).group(1))
            base = f"http://127.0.0.1:{port}"
            assert _post(base + "/queries.json",
                         {"user": "walk-in", "num": 4}) == \
                (200, {"itemScores": []})
            url = "http://{}:{}/batch/events.json?accessKey={}".format(
                *events.address, key)
            status, items = _post(url, [
                {"event": "rate", "entityType": "user",
                 "entityId": "walk-in", "targetEntityType": "item",
                 "targetEntityId": f"i{i}", "properties": {"rating": 5.0}}
                for i in (2, 5, 8)])
            assert status == 200 and {x["status"] for x in items} == {201}
            deadline = time.time() + 30
            while time.time() < deadline:
                _, ans = _post(base + "/queries.json",
                               {"user": "walk-in", "num": 4})
                if ans["itemScores"]:
                    break
                time.sleep(0.05)
            got = [s["item"] for s in ans["itemScores"]]
            assert len(got) == 4 and {"i2", "i5", "i8"}.isdisjoint(got)
            with urllib.request.urlopen(base + "/", timeout=30) as resp:
                page = json.loads(resp.read())
            assert page["foldin"]["newUsers"] == 1
            assert tcli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                              str(port)]) == 0
            assert child.wait(timeout=60) == 0
        finally:
            events.stop()
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    finally:
        tstorage.reset()
