"""Train -> deploy -> query on the port, on the CPU, against the JAX
template.

The port's ``Engine.train`` reads a data source registered here, runs
``RatingsPreparator`` (uniform and bucketed layouts) and
``ALSAlgorithm.train`` on ``device="cpu"``, and the trained model is
deployed with ``deployment_from_models`` behind the port's
``QueryServer``.
Each ``POST /queries.json`` answer is held against the JAX template's
``ALSAlgorithm().train`` + ``predict`` on the same ratings. The port's
``init_factors`` is replaced by the JAX package's, so both trainers start
from the same factors.

Tolerance: the two trainers sum and solve in different orders (and the
JAX trainer runs sharded over the test mesh), so after 5 iterations the
scores agree to 1e-3 of the query's largest score; items must be equal
at every rank whose JAX score is separated from its neighbours by more
than twice that (only a near tie can swap).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.templates.recommendation import engine as jeng
from predictionio_tpu_torch.controller import Engine, PDataSource
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.templates.recommendation import engine as teng
from predictionio_tpu_torch.workflow.create_server import (
    QueryServer,
    ServerConfig,
    deployment_from_models,
)

N_USERS, N_ITEMS, N_RATINGS, RANK, TOL = 30, 50, 600, 6, 1e-3
ALGO = {"rank": RANK, "numIterations": 5, "lambda": 0.05, "seed": 3}


def rating_columns():
    rng = np.random.default_rng(21)
    users = np.asarray([f"u{u}" for u in rng.integers(0, N_USERS,
                                                      N_RATINGS)], object)
    items = np.asarray([f"i{i}" for i in rng.integers(0, N_ITEMS,
                                                      N_RATINGS)], object)
    return users, items, (rng.integers(1, 11, N_RATINGS) * 0.5).astype(
        np.float32)


class RatingsSource(PDataSource):
    def read_training(self, ctx):
        users, items, values = rating_columns()
        return teng.TrainingData(users=users, items=items, values=values)


def jax_init(n_rows, n_cols, rank, seed, device=None):
    X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
    return (torch.from_numpy(np.array(X)).to(device),
            torch.from_numpy(np.array(Y)).to(device))


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def assert_same_ranking(got, want):
    """Port answer body vs JAX PredictedResult, per the module note."""
    g_items = [s["item"] for s in got["itemScores"]]
    assert_same_ranking.ranks += len(g_items)
    g_scores = np.asarray([s["score"] for s in got["itemScores"]])
    w_items = [s.item for s in want.item_scores]
    w_scores = np.asarray([s.score for s in want.item_scores])
    assert len(g_items) == len(w_items)
    if not len(w_items):
        return
    tol = TOL * float(np.abs(w_scores).max())
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=tol)
    gaps = np.abs(np.diff(w_scores))
    for j, (a, b) in enumerate(zip(g_items, w_items)):
        sep_prev = j == 0 or gaps[j - 1] > 2 * tol
        sep_next = j == len(w_items) - 1 or gaps[j] > 2 * tol
        if sep_prev and sep_next:
            assert a == b, (j, g_items, w_items)


@pytest.mark.parametrize("bucketed", [False, True])
def test_trained_model_serves_like_the_jax_template(monkeypatch, bucketed):
    monkeypatch.setattr(tals, "init_factors", jax_init)
    monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
    factory = teng.engine_factory()
    engine = Engine(RatingsSource, factory.preparator_class_map,
                    factory.algorithm_class_map, factory.serving_class_map)
    variant = {"preparator": {"params": {"bucketed": bucketed}},
               "algorithms": [{"name": "als", "params": ALGO}]}
    params = engine.engine_params_from_variant(variant)
    model, = engine.train(ComputeContext(device="cpu"), params)
    assert model.device == "cpu"
    assert model.user_factors.shape == (N_USERS, RANK)

    users, items, values = rating_columns()
    jpd = jeng.RatingsPreparator(
        jeng.PreparatorParams(bucketed=bucketed)).prepare(
        None, jeng.TrainingData(users=users, items=items, values=values))
    jalgo = jeng.ALSAlgorithm(jals.ALSParams(
        rank=RANK, num_iterations=5, lambda_=0.05, seed=3))
    jmodel = jalgo.train(None, jpd)

    dep = deployment_from_models(engine, params, [model])
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
    try:
        host, port = server.address
        url = f"http://{host}:{port}/queries.json"
        queries = [{"user": f"u{u}", "num": 5} for u in range(N_USERS)]
        queries += [{"items": ["i3", "i7"], "num": 4},
                    {"user": "u2", "num": 6, "blacklist": ["i1", "i4"]},
                    {"user": "nobody", "num": 3}]
        assert_same_ranking.ranks = 0
        for q in queries:
            want = jalgo.predict(jmodel, jeng.Query(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in q.items()}))
            assert_same_ranking(post(url, q), want)
        assert assert_same_ranking.ranks >= 5 * N_USERS * 0.9
    finally:
        server.stop()


def test_unregistered_data_source_raises():
    """A data source the engine does not register is refused by name:
    an engine built without one trains into an error naming the
    datasource, and a variant naming an unknown one does not parse."""
    from predictionio_tpu_torch.controller import EngineConfigError

    factory = teng.engine_factory()
    bare = Engine({}, factory.preparator_class_map,
                  factory.algorithm_class_map, factory.serving_class_map)
    params = bare.engine_params_from_variant(
        {"algorithms": [{"name": "als", "params": ALGO}]})
    with pytest.raises(EngineConfigError, match="datasource"):
        bare.train(ComputeContext(device="cpu"), params)
    with pytest.raises(EngineConfigError, match="datasource"):
        factory.engine_params_from_variant(
            {"datasource": {"name": "jdbc", "params": {"appName": "MyApp"}}})


def test_stop_after_prepare_and_sanity():
    from predictionio_tpu_torch.core.base import (
        StopAfterPrepareInterruption,
        StopAfterReadInterruption,
        WorkflowParams,
    )

    factory = teng.engine_factory()
    engine = Engine(RatingsSource, factory.preparator_class_map,
                    factory.algorithm_class_map, factory.serving_class_map)
    params = engine.engine_params_from_variant(
        {"algorithms": [{"name": "als", "params": ALGO}]})
    ctx = ComputeContext(device="cpu")
    with pytest.raises(StopAfterReadInterruption):
        engine.train(ctx, params, WorkflowParams(stop_after_read=True))
    with pytest.raises(StopAfterPrepareInterruption):
        engine.train(ctx, params, WorkflowParams(stop_after_prepare=True))

    class Empty(PDataSource):
        def read_training(self, ctx):
            return teng.TrainingData([])

    empty = Engine(Empty, factory.preparator_class_map,
                   factory.algorithm_class_map, factory.serving_class_map)
    with pytest.raises(AssertionError, match="cannot be empty"):
        empty.train(ctx, params)
