"""The port's host top-k lane and serving policy against the JAX
package's, on the CPU.

- ``HostTopK`` (port ``ops/serving.py``) is numpy, a copy of JAX's
  arithmetic: on fp32, bf16 and int8 inputs its user, users and items
  lanes give JAX's ids and bitwise its fp32 scores. A torch tensor input
  (the port's one extra case) answers as the same numpy array.
- ``validate_serving_policy`` gives JAX's decision and message for every
  combination of the five flags and the backends host / device / auto /
  an unknown one (one parametrised test).
- ``choose_server`` on both sides of the port's ``HOST_SERVE_MAX_ELEMS``,
  and the policy rows that force the device store below it. An explicit
  ``host`` raises JAX's message under an explicit bf16 / int8 store,
  fold-in, ``PIO_SERVE_SHARDS`` > 1 and two-stage serving, and a host
  model deployed with it answers as JAX's.
- ``top_k_items``, ``transpose_ratings`` and
  ``quantization_error_bound`` against JAX's.

The host lane's ties follow ``argpartition`` then a stable sort, as in
the JAX package, not the lowest id: it is held against the device store
only on normal draws, which have no exact ties.
"""

import itertools

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import quantize as jquant
from predictionio_tpu.ops import serving as jserving
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import quantize as tquant
from predictionio_tpu_torch.ops import serving as tserving


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("PIO_SERVING_BACKEND", "PIO_SERVE_PRECISION", "PIO_FOLDIN",
                 "PIO_SERVE_SHARDS"):
        monkeypatch.delenv(name, raising=False)


def problem(seed=0, n=12, m=60, r=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, r)).astype(np.float32)
    Y = rng.normal(size=(m, r)).astype(np.float32)
    seen = {u: rng.choice(m, size=rng.integers(1, 9), replace=False)
            for u in range(0, n, 2)}
    return X, Y, seen


def bf16(a):
    """A numpy bfloat16 array (the JAX package's ml_dtypes)."""
    import ml_dtypes

    return np.asarray(a).astype(ml_dtypes.bfloat16)


def host_pair(kind, X, Y, seen):
    """(JAX HostTopK, port HostTopK) over ``kind`` inputs."""
    if kind == "fp32":
        jx, jy, tx, ty = X, Y, X, Y
    elif kind == "bf16":
        jx, jy = bf16(X), bf16(Y)
        tx, ty = jx, jy
    elif kind == "bf16_tensor":
        jx, jy = bf16(X), bf16(Y)
        tx = torch.from_numpy(X).to(torch.bfloat16)
        ty = torch.from_numpy(Y).to(torch.bfloat16)
    elif kind == "int8":
        jx, jy = jquant.quantize_rows_int8_np(X), jquant.quantize_rows_int8_np(Y)
        tx, ty = tquant.quantize_rows_int8_np(X), tquant.quantize_rows_int8_np(Y)
    else:  # int8 tables as tensors
        jx, jy = jquant.quantize_rows_int8_np(X), jquant.quantize_rows_int8_np(Y)
        tx, ty = (tquant.QuantFactors(torch.from_numpy(q.data),
                                      torch.from_numpy(q.scale))
                  for q in (tquant.quantize_rows_int8_np(X),
                            tquant.quantize_rows_int8_np(Y)))
    return jserving.HostTopK(jx, jy, seen), tserving.HostTopK(tx, ty, seen)


HOST_KINDS = ["fp32", "bf16", "bf16_tensor", "int8", "int8_tensor"]


@pytest.mark.parametrize("kind", HOST_KINDS)
class TestHostTopK:
    def test_user_lane_equals_jax(self, kind):
        X, Y, seen = problem(1)
        j, t = host_pair(kind, X, Y, seen)
        for uid in range(X.shape[0]):
            for k in (1, 5, 60, 100):
                ji, js = j.user_topk(uid, k)
                ti, ts = t.user_topk(uid, k)
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(ts, js)
                assert ts.dtype == np.float32

    def test_users_lane_equals_jax(self, kind):
        X, Y, seen = problem(2)
        j, t = host_pair(kind, X, Y, seen)
        uids = np.arange(X.shape[0])
        for k in (3, 60, 64):
            ji, js = j.users_topk(uids, k)
            ti, ts = t.users_topk(uids, k)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ts, js)

    def test_items_lane_equals_jax(self, kind):
        X, Y, seen = problem(3)
        j, t = host_pair(kind, X, Y, seen)
        for q in ([0], [3, 17], [1, 2, 5, 8, 40]):
            for k in (4, 60):
                ji, js = j.items_topk(q, k)
                ti, ts = t.items_topk(q, k)
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(ts, js)


def test_host_lane_pads_rows_past_n_items():
    X, Y, seen = problem(4)
    j = jserving.HostTopK(X, Y, seen, n_items=40)
    t = tserving.HostTopK(X, Y, seen, n_items=40)
    ti, ts = t.user_topk(1, 45)
    ji, js = j.user_topk(1, 45)
    assert ti.max() < 40
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert t.stats() == {} and t.warmup() is None and t.close() is None


def test_host_lane_equals_the_device_store_on_tie_free_data():
    """Normal draws have no exact ties: the host lane's ids equal the
    device store's (ties to the lowest id), scores within 1e-5."""
    X, Y, seen = problem(5, n=10, m=300, r=16)
    host = tserving.HostTopK(X, Y, seen)
    dev = tserving.DeviceTopK(X, Y, seen, device="cpu", microbatch=False)
    for uid in range(10):
        hi, hs = host.user_topk(uid, 10)
        di, ds = dev.user_topk(uid, 10)
        np.testing.assert_array_equal(hi, di)
        np.testing.assert_allclose(hs, ds, rtol=1e-5)
    hi, hs = host.items_topk([4, 9], 10)
    di, ds = dev.items_topk([4, 9], 10)
    np.testing.assert_array_equal(hi, di)
    np.testing.assert_allclose(hs, ds, rtol=1e-5, atol=1e-6)


# -- the serving-policy table --------------------------------------------------

BACKENDS = ["host", "device", "auto", "sideways"]
POLICY_CASES = list(itertools.product(
    BACKENDS, [True, False], [None, "fp32", "bf16", "int8"], [False, True],
    [False, True], [False, True]))


@pytest.mark.parametrize(
    "backend,host_capable,precision,foldin,sharded,two_stage", POLICY_CASES)
def test_policy_decision_and_message_equal_jax(backend, host_capable,
                                               precision, foldin, sharded,
                                               two_stage):
    kw = dict(host_capable=host_capable, explicit_precision=precision,
              foldin=foldin, sharded=sharded, two_stage=two_stage)
    outcomes = []
    for fn in (jserving.validate_serving_policy,
               tserving.validate_serving_policy):
        try:
            outcomes.append(("ok", fn(backend, **kw)))
        except ValueError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[1] == outcomes[0]


def test_policy_rows_are_jax_rows():
    assert [(name, msg) for name, _, msg in tserving._SERVING_POLICY_ROWS] \
        == [(name, msg) for name, _, msg in jserving._SERVING_POLICY_ROWS]


# -- choose_server's auto rule -------------------------------------------------

def at_elems(elems, r=64, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(5, r)).astype(np.float32)
    Y = rng.normal(size=(elems // r, r)).astype(np.float32)
    return X, Y, {0: np.asarray([1, 2])}


@pytest.mark.parametrize("backend", ["auto", "", "sideways"])
def test_auto_serves_on_the_host_up_to_the_limit(monkeypatch, backend):
    monkeypatch.setenv("PIO_SERVING_BACKEND", backend)
    limit = tserving.HOST_SERVE_MAX_ELEMS
    X, Y, seen = at_elems(limit)
    srv = tserving.choose_server(X, Y, seen, device="cpu")
    assert isinstance(srv, tserving.HostTopK)
    assert srv.n_items * 64 == limit
    X, Y, seen = at_elems(limit + 64)
    srv = tserving.choose_server(X, Y, seen, device="cpu")
    assert isinstance(srv, tserving.DeviceTopK)
    srv.close()


@pytest.mark.parametrize("env", [
    {"PIO_SERVE_PRECISION": "bf16"}, {"PIO_SERVE_PRECISION": "int8"},
    {"PIO_FOLDIN": "on"}, {"PIO_SERVE_SHARDS": "2"},
    {"PIO_SERVING_BACKEND": "device"}])
def test_policy_rows_force_the_device_store(monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    X, Y, seen = problem(7)
    srv = tserving.choose_server(X, Y, seen, device="cpu")
    assert isinstance(srv, tserving.DeviceTopK)
    assert srv.shard_count == 1  # one CPU device: shards clamp to 1
    srv.close()


def test_fp32_precision_keeps_the_host_lane(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PRECISION", "fp32")
    X, Y, seen = problem(8)
    assert isinstance(tserving.choose_server(X, Y, seen, device="cpu"),
                      tserving.HostTopK)


def test_explicit_host_serves_above_the_limit(monkeypatch):
    monkeypatch.setenv("PIO_SERVING_BACKEND", "host")
    X, Y, seen = at_elems(tserving.HOST_SERVE_MAX_ELEMS + 64)
    srv = tserving.choose_server(X, Y, seen, device="cpu")
    assert isinstance(srv, tserving.HostTopK)


@pytest.mark.parametrize("env", [
    {"PIO_SERVE_PRECISION": "bf16"}, {"PIO_SERVE_PRECISION": "int8"},
    {"PIO_FOLDIN": "1"}, {"PIO_SERVE_SHARDS": "4"}])
def test_explicit_host_raises_the_jax_message(monkeypatch, env):
    monkeypatch.setenv("PIO_SERVING_BACKEND", "host")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    X, Y, seen = problem(9)
    with pytest.raises(ValueError) as jerr:
        jserving.choose_server(X, Y, seen)
    with pytest.raises(ValueError) as terr:
        tserving.choose_server(X, Y, seen, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_explicit_host_refuses_two_stage_as_jax(monkeypatch):
    import types

    from predictionio_tpu.ops import twostage as jtwo
    from predictionio_tpu_torch.ops import twostage as ttwo

    monkeypatch.setenv("PIO_SERVING_BACKEND", "host")
    X, Y, seen = problem(10)
    retrieval = types.SimpleNamespace(
        user_factors=X, item_factors=Y, user_map=list(range(12)),
        item_map=list(range(60)), seen=seen)
    rerank = types.SimpleNamespace(
        user_vectors=X, item_vectors=Y, user_map=list(range(12)),
        item_map=list(range(60)))
    with pytest.raises(ValueError) as jerr:
        jtwo.build_two_stage_store(retrieval, rerank)
    with pytest.raises(ValueError) as terr:
        ttwo.build_two_stage_store(retrieval, rerank, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "two-stage serving conflicts" in str(terr.value)


def test_host_backend_deploys_through_the_host_lane(monkeypatch):
    """``PIO_SERVING_BACKEND=host``: a host model's deployment serves
    from HostTopK and answers as the JAX package's."""
    from predictionio_tpu.templates.recommendation import engine as jengine
    from predictionio_tpu_torch.templates.recommendation import (
        engine as tengine,
    )
    from predictionio_tpu_torch.weights import als_model_from_numpy
    from predictionio_tpu_torch.workflow.create_server import (
        deployment_from_models,
        serve_query,
        to_jsonable,
    )

    monkeypatch.setenv("PIO_SERVING_BACKEND", "host")
    X, Y, seen = problem(11)
    users = [f"u{i}" for i in range(12)]
    items = [f"i{i}" for i in range(60)]
    model = als_model_from_numpy(X, Y, users, items, seen, device="cpu")
    engine = tengine.engine_factory()
    dep = deployment_from_models(engine, engine.engine_params_from_variant(
        {}), [model])
    from predictionio_tpu.data.bimap import StringIndexBiMap

    jmodel = jengine.ALSModel(X, Y, StringIndexBiMap(users),
                              StringIndexBiMap(items), seen)
    jalgo = jengine.ALSAlgorithm(jengine.ALSParams(rank=8))
    for q in ({"user": "u0", "num": 5}, {"user": "u3", "num": 60},
              {"items": ["i4", "i7"], "num": 6},
              {"user": "u2", "num": 4, "blacklist": ["i1", "i2"]}):
        got = to_jsonable(serve_query(dep, q))["itemScores"]
        want = jalgo.predict(jmodel, jengine.Query(
            user=q.get("user"), items=tuple(q.get("items", ())),
            num=q["num"], blacklist=tuple(q.get("blacklist", ()))))
        assert [g["item"] for g in got] == [s.item for s in want.item_scores]
        np.testing.assert_array_equal(
            np.float32([g["score"] for g in got]),
            np.float32([s.score for s in want.item_scores]))
    assert isinstance(model.device_server(), tserving.HostTopK)


# -- the host helpers ----------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((40,), 5), ((7, 40), 3), ((3, 5, 9), 9),
                                     ((6, 4), 10)])
def test_top_k_items_equals_jax(shape, k):
    rng = np.random.default_rng(12)
    s = rng.normal(size=shape).astype(np.float32)
    for got, want in zip(tals.top_k_items(s, k), jals.top_k_items(s, k)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_len", [None, 2])
def test_transpose_ratings_equals_jax(max_len):
    rng = np.random.default_rng(13)
    rows = rng.integers(0, 9, 60)
    cols = rng.integers(0, 14, 60)
    vals = rng.integers(1, 6, 60).astype(np.float32)
    tp = tals.pad_ratings(rows, cols, vals, 9, 14)
    jp = jals.pad_ratings(rows, cols, vals, 9, 14)
    got = tals.transpose_ratings(tp, rows, cols, vals, max_len=max_len)
    want = jals.transpose_ratings(jp, rows, cols, vals, max_len=max_len)
    for name in ("cols", "weights", "mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols) == (14, 9)


def test_quantization_error_bound_equals_jax():
    rng = np.random.default_rng(14)
    F = rng.normal(size=(30, 8)).astype(np.float32) * 3
    F[4] = 0.0
    tq, jq = tquant.quantize_rows_int8_np(F), jquant.quantize_rows_int8_np(F)
    got = tquant.quantization_error_bound(tq)
    np.testing.assert_array_equal(got, jquant.quantization_error_bound(jq))
    err = np.abs(tquant.dequantize_rows_np(tq) - F).max(axis=1)
    assert (err <= got + 1e-7).all()
