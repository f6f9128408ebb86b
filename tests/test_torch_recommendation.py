"""The port's recommendation query path end to end on CPU, against the
JAX package: a JAX ``ALSModel`` is carried across with
``als_model_from_numpy``, the port's ``QueryServer`` serves it on a free
port, and each ``POST /queries.json`` body is compared with the JAX
``ALSAlgorithm().predict`` result serialized by the JAX package's
``to_jsonable``. The JAX side runs under ``PIO_SERVING_BACKEND=device``,
so both packages serve from their device stores (the port always does).

Tolerances: the factors are integer-valued, so user-lane scores are
exact and those bodies must be IDENTICAL. Item-similarity scores go
through row normalization (non-integer values summed over R=6 terms in
different orders), so those agree to rtol 1e-5 with equal items wherever
the scores are separated.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.bimap import StringIndexBiMap
from predictionio_tpu.templates.recommendation import engine as jeng
from predictionio_tpu.workflow.create_server import to_jsonable as j_to_jsonable
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.ops.als import ALSParams
from predictionio_tpu_torch.templates.recommendation import engine as teng
from predictionio_tpu_torch.weights import als_model_from_numpy
from predictionio_tpu_torch.workflow.create_server import (
    QueryServer,
    ServerConfig,
    deployment_from_models,
)

N_USERS, N_ITEMS, RANK = 30, 200, 6
VARIANT = {
    "id": "default",
    "engineFactory": "predictionio_tpu.templates.recommendation.engine:"
                     "engine_factory",
    "datasource": {"params": {"appName": "MyApp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": RANK, "numIterations": 5, "lambda": 0.05, "seed": 3}}],
}


@pytest.fixture()
def jax_model():
    rng = np.random.default_rng(0)
    X = rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32)
    Y = rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32)
    users = StringIndexBiMap.from_distinct([f"u{i}" for i in range(N_USERS)])
    items = StringIndexBiMap.from_distinct([f"i{i}" for i in range(N_ITEMS)])
    seen = {u: rng.choice(N_ITEMS, size=rng.integers(0, 12), replace=False)
            for u in range(N_USERS)}
    cats = {i: tuple(f"g{c}" for c in rng.choice(6, rng.integers(1, 3),
                                                  replace=False))
            for i in range(N_ITEMS)}
    return jeng.ALSModel(X, Y, users, items, seen, item_categories=cats)


@pytest.fixture()
def port_server(jax_model, monkeypatch):
    monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
    monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
    m = jax_model
    model = als_model_from_numpy(
        m.user_factors, m.item_factors, m.user_map.labels, m.item_map.labels,
        m.seen, item_categories=m.item_categories, device="cpu")
    engine = teng.engine_factory()
    dep = deployment_from_models(
        engine, engine.engine_params_from_variant(VARIANT), [model])
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
    host, port = server.address
    yield f"http://{host}:{port}", model
    server.stop()


def call(url, method="POST", payload=None, raw=None):
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


USER_QUERIES = [
    {"user": "u1", "num": 4},
    {"user": "u2"},
    {"user": "u7", "num": 25},
    {"user": "u3", "num": 5, "blacklist": ["i10", "i11", "nope"]},
    {"user": "u4", "num": 6, "categories": ["g2"]},
    {"user": "u5", "num": 3, "categories": ["g0", "g5"],
     "blacklist": ["i1"]},
    {"user": "nobody"},
    {"num": 3},
]


class TestQueriesAgainstJax:
    def test_user_query_bodies_identical(self, port_server, jax_model,
                                         monkeypatch):
        base, _ = port_server
        monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
        algo = jeng.ALSAlgorithm()
        for q in USER_QUERIES:
            status, body = call(base + "/queries.json", payload=q)
            assert status == 200, body
            want = j_to_jsonable(algo.predict(jax_model, dict(q)))
            assert body == json.loads(json.dumps(want)), q
        assert body == {"itemScores": []}

    def test_item_query_bodies_agree(self, port_server, jax_model,
                                     monkeypatch):
        base, _ = port_server
        monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
        algo = jeng.ALSAlgorithm()
        for q in ({"items": ["i3"], "num": 8},
                  {"items": ["i5", "i6"], "num": 10, "blacklist": ["i7"]},
                  {"items": ["i9", "unknown"], "num": 4}):
            status, body = call(base + "/queries.json", payload=q)
            assert status == 200, body
            want = j_to_jsonable(algo.predict(jax_model, dict(q)))
            got_s = np.asarray([s["score"] for s in body["itemScores"]])
            want_s = np.asarray([s["score"] for s in want["itemScores"]])
            np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
            sep = np.ones(len(want_s), dtype=bool)
            gap = np.abs(np.diff(want_s)) > 1e-4
            sep[1:] &= gap
            sep[:-1] &= gap
            got_i = [s["item"] for s in body["itemScores"]]
            want_i = [s["item"] for s in want["itemScores"]]
            assert [g for g, s in zip(got_i, sep) if s] == \
                [w for w, s in zip(want_i, sep) if s]

    def test_concurrent_clients(self, port_server, jax_model, monkeypatch):
        base, _ = port_server
        monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
        algo = jeng.ALSAlgorithm()
        queries = [{"user": f"u{u}", "num": 5} for u in range(N_USERS)]
        bodies = {}

        def client(chunk):
            for i in chunk:
                bodies[i] = call(base + "/queries.json", payload=queries[i])

        threads = [threading.Thread(target=client,
                                    args=(range(c, len(queries), 6),))
                   for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, q in enumerate(queries):
            want = json.loads(json.dumps(
                j_to_jsonable(algo.predict(jax_model, dict(q)))))
            assert bodies[i] == (200, want)

    def test_batch_predict(self, port_server, jax_model, monkeypatch):
        _, model = port_server
        monkeypatch.setenv("PIO_SERVING_BACKEND", "device")
        qs = [(i, jeng.Query(user=f"u{i}", num=4 + i % 3)) for i in range(8)]
        qs.append((8, jeng.Query(items=("i2",), num=3)))
        want = jeng.ALSAlgorithm().batch_predict(None, jax_model, qs)
        got = teng.ALSAlgorithm().batch_predict(
            None, model, [(i, teng.Query(**dataclasses.asdict(q)))
                          for i, q in qs])
        assert [qx for qx, _ in got] == [qx for qx, _ in want]
        for (_, g), (_, w) in zip(got[:8], want[:8]):
            assert j_to_jsonable(g) == j_to_jsonable(w)


class TestServerSurface:
    def test_healthz_and_errors(self, port_server):
        base, _ = port_server
        # the JAX package's /healthz shape: the server label and pid too
        assert call(base + "/healthz", method="GET") == (200, {
            "alive": True, "ready": True,
            "checks": {"deployment": True, "device": True},
            "server": "query", "pid": os.getpid()})
        status, body = call(base + "/queries.json", raw=b"{not json")
        assert status == 400
        status, body = call(base + "/queries.json", payload=[1, 2])
        assert status == 400
        status, body = call(base + "/queries.json",
                            payload={"user": "u1", "bogus": 1})
        assert status == 400 and "bogus" in body["message"]
        assert call(base + "/nope", payload={})[0] == 404
        assert call(base + "/nope", method="GET")[0] == 404

    def test_stop(self, port_server):
        base, _ = port_server
        assert call(base + "/stop", raw=b"") == (
            200, {"message": "Shutting down."})


class TestEngineParams:
    def test_variant_params_match_jax(self):
        got = teng.engine_factory().engine_params_from_variant(VARIANT)
        want = jeng.engine_factory().engine_params_from_variant(VARIANT)
        (gname, gp), = got.algorithm_params_list
        (wname, wp), = want.algorithm_params_list
        assert gname == wname == "als"
        assert dataclasses.asdict(gp) == dataclasses.asdict(wp)

    def test_train_is_not_ported_yet(self):
        """The template's training takes the training options: under the
        bf16 precision it trains host fp32 factors equal to the trainer's
        on the same tables, and an unknown precision raises naming its
        source."""
        from predictionio_tpu_torch.parallel.als_sharding import (
            train_als_auto,
        )

        td = teng.TrainingData([teng.Rating("u0", "i0", 4.0),
                                teng.Rating("u1", "i1", 2.0),
                                teng.Rating("u1", "i0", 3.0)])
        pd = teng.RatingsPreparator().prepare(None, td)
        params = ALSParams(rank=2, seed=1, precision="bf16")
        model = teng.ALSAlgorithm(params).train(ComputeContext(device="cpu"),
                                                pd)
        X, Y = train_als_auto(pd.user_side, pd.item_side, params, "cpu")
        assert model.user_factors.dtype == np.float32
        np.testing.assert_array_equal(model.user_factors, X)
        np.testing.assert_array_equal(model.item_factors, Y)
        algo = teng.ALSAlgorithm(ALSParams(rank=2, precision="fp16"))
        with pytest.raises(ValueError, match="ALSParams.precision"):
            algo.train(ComputeContext(device="cpu"), pd)
