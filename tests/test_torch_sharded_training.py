"""The port's sharded trainers against the JAX package's, on the CPU: the
port on logical shards of one device (``["cpu"] * n``), JAX on the
devices of its forced host platform (conftest), both from JAX's init.

- ``train_als_sharded`` (8 shards), ``train_als_bucketed_sharded``,
  ``train_als_sharded_2d`` on (2, 4) and (4, 2), ``train_als_device``
  (uniform and bucketed, JAX's uneven 21 x 13 case) and
  ``sharded_train_step`` agree with the JAX package's on its fixtures
  (``tests/test_parallel.py``) within JAX's own sharded-vs-single
  tolerance, ``rtol=1e-4, atol=1e-5``; bf16 within JAX's band.
- Against the port's single-device trainers from the same init the
  factors are EQUAL: each row's sums and solve depend on that row
  alone, and the merges add only zeros. Measured: a largest difference
  of 0.0 on every fixture here, held as ``== 0``.
- ``train_als_auto`` dispatches a plane of several devices to the
  sharded trainers; a bucketed side given to a uniform flavor raises.
- Checkpoints: chunked sharded runs (uniform and bucketed) are bitwise
  equal to straight ones, a preempted run resumes bitwise, the objective
  sample is recorded, and a run across processes warns and writes none.
- A 2-process gloo world (children, no card visible): ``run_train`` and
  ``pio train --num-hosts 2`` train one collective run whose factors on
  both ranks equal the single-process run bitwise and JAX's within
  1e-4; rank 1 persists nothing.
"""

import dataclasses
import json
import logging
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel import als_sharding as jshard
from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.parallel import als_sharding as tshard
from predictionio_tpu_torch.parallel import distributed as tdist
from predictionio_tpu_torch.parallel import mesh as tmesh
from predictionio_tpu_torch.workflow import checkpoint, runlog
from test_als import synthetic_ratings

pytestmark = pytest.mark.multichip

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-5)
EPS_BF16 = 2.0 ** -8


def jax_init(n_rows, n_cols, rank, seed, device=None):
    X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
    return (torch.from_numpy(np.array(X)).to(device),
            torch.from_numpy(np.array(Y)).to(device))


@pytest.fixture(autouse=True)
def shared_init(monkeypatch):
    """Both packages start from JAX's init; no checkpoint lane unless a
    test asks for one."""
    monkeypatch.setattr(tals, "init_factors", jax_init)
    for var in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY", "PIO_RESUME",
                "PIO_ALS_PRECISION", "PIO_ALS_SOLVER"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def jmesh8(multichip_devices):
    return jmesh.data_parallel_mesh(8)


def plane(n=8):
    return tmesh.data_parallel_mesh(devices=[CPU] * n)


# the JAX package's fixtures (tests/test_parallel.py)
FIXTURES = {
    "50x30": (dict(n_users=50, n_items=30, rank=4, density=0.3, seed=0),
              dict(rank=6, num_iterations=4, lambda_=0.05, seed=5)),
    "13x9": (dict(n_users=13, n_items=9, rank=2, density=0.5, seed=2),
             dict(rank=4, num_iterations=2, seed=1)),
}


def triples(name):
    data, params = FIXTURES[name]
    rows, cols, vals = synthetic_ratings(**data)
    return rows, cols, vals, data["n_users"], data["n_items"], params


def uniform(pkg, rows, cols, vals, n_u, n_i):
    return (pkg.pad_ratings(rows, cols, vals, n_u, n_i),
            pkg.pad_ratings(cols, rows, vals, n_i, n_u))


def bucketed(pkg, rows, cols, vals, n_u, n_i):
    return pkg.bucket_ratings_pair(rows, cols, vals, n_u, n_i)


def equal(got, want):
    """The factors EQUAL (the measured largest difference is 0.0)."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        assert float(np.abs(g - w).max()) == 0.0


def close(got, want):
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def gathered(t: tmesh.ShardedTensor) -> np.ndarray:
    return tdist.process_allgather(t).float().numpy()


# -- the trainers against JAX and the port's single-device trainers --------

class TestShardedALS:
    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_against_jax_and_single_device(self, jmesh8, name):
        rows, cols, vals, n_u, n_i, p = triples(name)
        got = tshard.train_als_sharded(
            *uniform(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            plane())
        close(got, jshard.train_als_sharded(
            *uniform(jals, rows, cols, vals, n_u, n_i), jals.ALSParams(**p),
            jmesh8))
        equal(got, tals.train_als(*uniform(tals, rows, cols, vals, n_u, n_i),
                                  tals.ALSParams(**p), CPU))

    @pytest.mark.parametrize("implicit", [True, False])
    def test_explicit_and_refine_equal_single_device(self, implicit):
        rows, cols, vals, n_u, n_i, p = triples("50x30")
        params = tals.ALSParams(**p, implicit_prefs=implicit,
                                solve_refine=True)
        sides = uniform(tals, rows, cols, vals, n_u, n_i)
        equal(tshard.train_als_sharded(*sides, params, plane(3)),
              tals.train_als(*sides, params, CPU))

    def test_uniform_flavors_reject_bucketed_sides(self):
        rows, cols, vals = synthetic_ratings(10, 8, 2, 0.4, seed=4)
        ub, ib = bucketed(tals, rows, cols, vals, 10, 8)
        for fn in (tshard.train_als_sharded, tshard.train_als_sharded_2d):
            mesh = plane(4) if fn is tshard.train_als_sharded \
                else tmesh.mesh_2d(2, 2, devices=[CPU] * 4)
            with pytest.raises(TypeError, match="bucketed"):
                fn(ub, ib, tals.ALSParams(rank=4), mesh)

    def test_bf16_within_the_jax_band(self, jmesh8):
        rng = np.random.default_rng(2)
        rows, cols = rng.integers(0, 64, 900), rng.integers(0, 40, 900)
        vals = rng.integers(1, 6, 900).astype(np.float32)
        sides = uniform(tals, rows, cols, vals, 64, 40)
        params = tals.ALSParams(rank=8, num_iterations=2, seed=2)
        X32, _ = tals.train_als(*sides, params, CPU)
        bf = dataclasses.replace(params, precision="bf16")
        Xs, Ys = tshard.train_als_sharded(*sides, bf, plane())
        assert Xs.dtype == np.float32
        err = np.linalg.norm(Xs - X32) / np.linalg.norm(X32)
        assert err < 4 * params.num_iterations * EPS_BF16
        jXs, _ = jshard.train_als_sharded(
            *uniform(jals, rows, cols, vals, 64, 40),
            jals.ALSParams(rank=8, num_iterations=2, seed=2,
                           precision="bf16"), jmesh8)
        err_jax = np.linalg.norm(Xs - jXs) / np.linalg.norm(jXs)
        assert err_jax < 4 * params.num_iterations * EPS_BF16
        equal((Xs, Ys), tals.train_als(*sides, bf, CPU))


class TestShardedBucketedALS:
    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_against_jax_and_single_device(self, jmesh8, name):
        rows, cols, vals, n_u, n_i, p = triples(name)
        got = tshard.train_als_bucketed_sharded(
            *bucketed(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            plane())
        close(got, jshard.train_als_bucketed_sharded(
            *bucketed(jals, rows, cols, vals, n_u, n_i), jals.ALSParams(**p),
            jmesh8))
        equal(got, tals.train_als_bucketed(
            *bucketed(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            CPU))

    @pytest.mark.parametrize("budget", [None, 64])
    def test_slot_budget_and_2d_factors(self, budget):
        rows, cols, vals, n_u, n_i, p = triples("50x30")
        params = tals.ALSParams(**p, bucket_slot_budget=budget)
        sides = bucketed(tals, rows, cols, vals, n_u, n_i)
        want = tals.train_als_bucketed(*sides, params, CPU)
        equal(tshard.train_als_bucketed_sharded(*sides, params, plane(4)),
              want)
        equal(tshard.train_als_bucketed_sharded(
            *sides, params, tmesh.mesh_2d(2, 2, devices=[CPU] * 4),
            factor_spec=tmesh.P("model", None)), want)

    def test_pad_bucket_rows_byte_equal_to_jax(self):
        rows, cols, vals, n_u, n_i, _ = triples("50x30")
        for tb, jb in zip(bucketed(tals, rows, cols, vals, n_u, n_i)[0]
                          .buckets,
                          bucketed(jals, rows, cols, vals, n_u, n_i)[0]
                          .buckets):
            for multiple in (8, 64, 24):
                t = tshard._pad_bucket_rows(tb, multiple, n_u)
                j = jshard._pad_bucket_rows(jb, multiple, n_u)
                for f in ("row_ids", "cols", "weights", "mask"):
                    a, b = getattr(t, f), np.asarray(getattr(j, f))
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
                assert len(t.row_ids) % multiple == 0
                pt = tshard._pad_bucket_rows(
                    tals.RatingsBucket(*(torch.from_numpy(np.asarray(a))
                                         for a in (tb.row_ids, tb.cols,
                                                   tb.weights, tb.mask))),
                    multiple, n_u)
                assert pt.row_ids.numpy().tobytes() == t.row_ids.tobytes()

    def test_pad_rows_to_byte_equal_to_jax(self):
        a = np.arange(15, dtype=np.float32).reshape(5, 3)
        assert tshard._pad_rows_to(a, 8).tobytes() == \
            jshard._pad_rows_to(a, 8).tobytes()
        assert tshard._pad_rows_to(a, 5) is a
        assert torch.equal(tshard._pad_rows_to(torch.from_numpy(a), 8),
                           torch.from_numpy(jshard._pad_rows_to(a, 8)))

    def test_launches_once_per_shard_that_holds_rows(self, monkeypatch):
        """B3 and B2 each run once per (bucket, shard with a real row) a
        half-step; a shard whose block is all sentinel rows launches
        nothing."""
        rows, cols, vals, n_u, n_i, p = triples("50x30")
        us, is_ = bucketed(tals, rows, cols, vals, n_u, n_i)
        calls = []
        solve = tals._solve_rows

        def counted(Y, cols, *a, **kw):
            calls.append(int(cols.shape[0]))
            return solve(Y, cols, *a, **kw)

        monkeypatch.setattr(tals, "_solve_rows", counted)
        params = tals.ALSParams(**dict(p, num_iterations=1))
        tshard.train_als_bucketed_sharded(us, is_, params, plane(8))
        want = 0
        for side in (us, is_):
            for b in side.buckets:
                b = tshard._pad_bucket_rows(b, 64, side.n_rows)
                real = np.asarray(b.row_ids) < side.n_rows
                want += sum(bool(x.any()) for x in np.split(real, 8))
        # some blocks are sentinel rows only, and launch nothing
        assert len(calls) == want < 8 * (len(us.buckets) + len(is_.buckets))


class TestSharded2D:
    @pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
    def test_against_jax_and_factor_rows_per_device(self, multichip_devices,
                                                    shape):
        rows, cols, vals, n_u, n_i, p = triples("50x30")
        mesh = tmesh.mesh_2d(*shape, devices=[CPU] * 8)
        got = tshard.train_als_sharded_2d(
            *uniform(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            mesh)
        close(got, jshard.train_als_sharded_2d(
            *uniform(jals, rows, cols, vals, n_u, n_i), jals.ALSParams(**p),
            jmesh.mesh_2d(*shape)))
        equal(got, tals.train_als(*uniform(tals, rows, cols, vals, n_u, n_i),
                                  tals.ALSParams(**p), CPU))
        # on the mesh: every device holds padded / model rows of each table
        X, Y = tshard._train_sharded(
            *uniform(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            mesh, row_divisor=8, factor_spec=tmesh.P("model", None),
            gather=False)
        for t, n in ((X, n_u), (Y, n_i)):
            assert t.shape == (-(-n // 8) * 8, 6)
            assert all(b.shape == (t.shape[0] // shape[1], 6)
                       for b in t.blocks)
            assert gathered(t)[n:].any() == 0


class TestTrainAlsDevice:
    @pytest.mark.parametrize("layout", ["uniform", "bucketed"])
    def test_against_jax_on_its_default_mesh(self, multichip_devices,
                                             layout):
        """JAX lays 8 devices out as ``host_aware_mesh(model=2)``; the port
        on the same 4 x 2 plane. Padded tables, on the mesh."""
        rows, cols, vals, n_u, n_i, p = triples("50x30")
        make = uniform if layout == "uniform" else bucketed
        jX, jY = jshard.train_als_device(*make(jals, rows, cols, vals,
                                               n_u, n_i),
                                         jals.ALSParams(**p))
        mesh = tdist.host_aware_mesh(model=2, devices=[CPU] * 8)
        X, Y = tshard.train_als_device(*make(tals, rows, cols, vals, n_u,
                                             n_i), tals.ALSParams(**p), mesh)
        assert isinstance(X, tmesh.ShardedTensor)
        assert X.spec == tmesh.P("model", None)
        assert X.shape == tuple(jX.shape) and Y.shape == tuple(jY.shape)
        close((gathered(X)[:n_u], gathered(Y)[:n_i]),
              (np.asarray(jX)[:n_u], np.asarray(jY)[:n_i]))

    def test_uneven_rows_regression(self, multichip_devices):
        """JAX's regression: counts not divisible by the model axis still
        train, and the padded store serves only real items."""
        from predictionio_tpu_torch.ops.serving import DeviceTopK

        rng = np.random.default_rng(4)
        n_u, n_i = 21, 13
        rows, cols = rng.integers(0, n_u, 300), rng.integers(0, n_i, 300)
        vals = rng.random(300).astype(np.float32) + 0.5
        p = dict(rank=4, num_iterations=2, seed=0)
        mesh = tdist.host_aware_mesh(model=2, devices=[CPU] * 8)
        X, Y = tshard.train_als_device(
            *bucketed(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            mesh)
        jX, jY = jshard.train_als_device(
            *bucketed(jals, rows, cols, vals, n_u, n_i), jals.ALSParams(**p))
        assert X.shape[0] >= n_u and Y.shape[0] >= n_i
        close((gathered(X)[:n_u], gathered(Y)[:n_i]),
              (np.asarray(jX)[:n_u], np.asarray(jY)[:n_i]))
        srv = DeviceTopK(X.gathered(), Y.gathered(), None, n_users=n_u,
                         n_items=n_i, device=CPU, microbatch=False)
        idx, scores = srv.user_topk(3, 5)
        assert (idx < n_i).all() and np.isfinite(scores).all()

    def test_one_device_mesh_is_replicated(self):
        rows, cols, vals, n_u, n_i, p = triples("13x9")
        X, Y = tshard.train_als_device(
            *uniform(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            tmesh.data_parallel_mesh(devices=[CPU]))
        assert X.spec == tmesh.P(None, None) and X.mesh.size == 1
        equal((gathered(X), gathered(Y)), tals.train_als(
            *uniform(tals, rows, cols, vals, n_u, n_i), tals.ALSParams(**p),
            CPU))


def test_sharded_train_step_one_iteration(jmesh8):
    rows, cols, vals = synthetic_ratings(32, 16, 3, 0.4, seed=4)
    us, is_ = uniform(tals, rows, cols, vals, 32, 16)
    rng = np.random.default_rng(9)
    X = rng.normal(size=(32, 4)).astype(np.float32)
    Y = rng.normal(size=(16, 4)).astype(np.float32)
    args = (X, Y, us.cols, us.weights, us.mask, is_.cols, is_.weights,
            is_.mask)
    step, specs = tshard.sharded_train_step(plane(), rank=4)
    assert specs == {"rows": tmesh.P(("data",), None),
                     "factors": tmesh.P(None, None)}
    Xs, Ys = step(*args)
    jstep, _ = jshard.sharded_train_step(jmesh8, rank=4)
    jX, jY = jstep(*args)
    close((gathered(Xs), gathered(Ys)), (np.asarray(jX), np.asarray(jY)))
    want = tals.als_iterations(*(torch.from_numpy(a) for a in args),
                               lam=0.01, alpha=1.0, implicit=True,
                               num_iterations=1)
    equal((gathered(Xs), gathered(Ys)), [t.numpy() for t in want])


# -- the sharded tensor and the merges -------------------------------------

class TestShardedTensor:
    def test_make_global_array_and_gather(self):
        mesh = tmesh.mesh_2d(2, 2, devices=[CPU] * 4)
        a = np.arange(24, dtype=np.float32).reshape(8, 3)
        rows = tdist.make_global_array(mesh, tmesh.P(("data", "model"),
                                                     None), a)
        assert [tuple(b[:, 0].tolist()) for b in rows.blocks] == \
            [(0.0, 3.0), (6.0, 9.0), (12.0, 15.0), (18.0, 21.0)]
        model = tdist.make_global_array(mesh, tmesh.P("model", None),
                                        torch.from_numpy(a))
        assert model.blocks[0] is model.blocks[2]  # one copy a device
        assert model.block_bytes() == [48] * 4
        data = tdist.make_global_array(mesh, tmesh.P("data", None), a)
        for t in (rows, model, data):
            assert t.shape == (8, 3)
            assert np.array_equal(gathered(t), a)
            assert all(np.array_equal(t.gathered(k).numpy(), a)
                       for k in range(4))
        assert rows.all_finite()
        a[0, 0] = np.nan
        assert not tdist.make_global_array(mesh, tmesh.P(None, None),
                                           a).all_finite()
        with pytest.raises(ValueError, match="equal blocks"):
            tdist.make_global_array(mesh, tmesh.P("model", None), a[:7])


# -- train_als_auto ----------------------------------------------------------

class TestTrainAlsAuto:
    @pytest.mark.parametrize("layout", ["uniform", "bucketed"])
    def test_a_plane_dispatches_to_the_sharded_trainers(self, monkeypatch,
                                                        layout):
        rows, cols, vals, n_u, n_i, p = triples("50x30")
        make = uniform if layout == "uniform" else bucketed
        sides = make(tals, rows, cols, vals, n_u, n_i)
        params = tals.ALSParams(**p)
        want = tals.train_als(*uniform(tals, rows, cols, vals, n_u, n_i),
                              params, CPU)
        called = []
        for name in ("train_als_sharded", "train_als_bucketed_sharded"):
            fn = getattr(tshard, name)
            monkeypatch.setattr(tshard, name, lambda *a, _f=fn, _n=name,
                                **kw: called.append((_n, a[3].size))
                                or _f(*a, **kw))
        for plane_ in ([CPU] * 4, plane(3)):
            equal(tshard.train_als_auto(*sides, params, plane_), want)
        # one device: the single-device trainer
        equal(tshard.train_als_auto(*sides, params, [CPU]), want)
        name = "train_als_sharded" if layout == "uniform" \
            else "train_als_bucketed_sharded"
        assert called == [(name, 4), (name, 3)]

    def test_a_process_group_takes_the_host_aware_mesh(self, monkeypatch):
        calls = []
        monkeypatch.setattr(tdist, "group_initialized", lambda: True)
        monkeypatch.setattr(tshard, "train_als_sharded",
                            lambda *a, **kw: calls.append(a[3]) or "ok")
        rows, cols, vals, n_u, n_i, p = triples("13x9")
        out = tshard.train_als_auto(*uniform(tals, rows, cols, vals, n_u,
                                             n_i), tals.ALSParams(**p), CPU)
        assert out == "ok" and calls[0].axis_names == ("data",)
        assert calls[0].device_list() == [torch.device(CPU)]


# -- checkpoints ----------------------------------------------------------------

@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    d = tmp_path / "ckpts"
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(d))
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "2")
    monkeypatch.delenv("PIO_TRAIN_TELEMETRY", raising=False)
    checkpoint.clear_stop()
    yield d
    checkpoint.clear_stop()


def ckpt_triples():
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 48, 400), rng.integers(0, 32, 400)
    vals = rng.random(400).astype(np.float32) + 0.5
    return rows, cols, vals, 48, 32


CKPT_PARAMS = tals.ALSParams(rank=4, num_iterations=6, seed=3)


def sharded_train(layout):
    make = uniform if layout == "uniform" else bucketed
    fn = tshard.train_als_sharded if layout == "uniform" \
        else tshard.train_als_bucketed_sharded
    return fn(*make(tals, *ckpt_triples()), CKPT_PARAMS, plane(4))


class TestCheckpoints:
    @pytest.mark.parametrize("layout", ["uniform", "bucketed"])
    def test_chunked_equals_straight_and_resumes(self, ckpt_env,
                                                 monkeypatch, layout):
        monkeypatch.delenv("PIO_CHECKPOINT_DIR")
        straight = sharded_train(layout)
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(ckpt_env))
        equal(sharded_train(layout), straight)
        assert list(ckpt_env.glob("*.json"))
        # a preempted run resumes bitwise from its checkpoint
        resumed = ckpt_env.parent / "resumed"
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(resumed))
        checkpoint.request_stop()
        with pytest.raises(checkpoint.TrainingPreempted):
            sharded_train(layout)
        checkpoint.clear_stop()
        monkeypatch.setenv("PIO_RESUME", "1")
        equal(sharded_train(layout), straight)

    def test_objective_sample_recorded(self, ckpt_env, monkeypatch):
        monkeypatch.setenv("PIO_TRAIN_TELEMETRY", "1")
        X, Y = sharded_train("bucketed")
        runs = runlog.list_runs(str(ckpt_env))
        assert len(runs) == 1
        samples = runlog.read_run(runs[0]["path"])["samples"]
        assert [s["step"] for s in samples] == [2, 4, 6]
        want = tals.training_objective(X, Y, bucketed(tals, *ckpt_triples())[0],
                                       CKPT_PARAMS, CPU)
        last = samples[-1]["loss"]
        assert last["fit"] == pytest.approx(want["fit"], rel=1e-5)
        assert last["l2"] == pytest.approx(want["l2"], rel=1e-5)

    def test_across_processes_warns_and_writes_nothing(self, ckpt_env,
                                                       caplog):
        layout = tals.checkpoint_layout_uniform(
            *uniform(tals, *ckpt_triples()))
        with caplog.at_level(logging.WARNING, "pio.torch.als_sharding"):
            got = tshard._multihost_checkpointer(layout, CKPT_PARAMS,
                                                 "plain", "fp32", True)
        assert got is None and not ckpt_env.exists()
        assert "writes NO checkpoints" in caplog.text
        assert tshard._multihost_checkpointer(
            layout, CKPT_PARAMS, "plain", "fp32", False) is not None


# -- a 2-process gloo world -------------------------------------------------------

ENGINE = r'''
import os
import numpy as np
from predictionio_tpu_torch.controller import Engine
from predictionio_tpu_torch.templates.recommendation import engine as rec


class Recording(rec.ALSAlgorithm):
    """The template's ALS, its factors saved per rank."""

    def train(self, ctx, pd):
        model = super().train(ctx, pd)
        from predictionio_tpu_torch.parallel import distributed
        np.savez(os.path.join(os.environ["OUT_DIR"],
                              f"rank{distributed.process_index()}.npz"),
                 X=model.user_factors, Y=model.item_factors)
        return model


def factory():
    return Engine(rec.EventDataSource, rec.RatingsPreparator,
                  {"als": Recording}, rec.RecommendationServing)
'''

CHILD = r'''
import sys
import numpy as np
import torch
from predictionio_tpu_torch.ops import als as tals
init = np.load(sys.argv[1])
tals.init_factors = lambda n, m, r, s, device=None: (
    torch.from_numpy(init["X"]).to(device),
    torch.from_numpy(init["Y"]).to(device))
from predictionio_tpu_torch.tools import cli
sys.exit(cli.main(sys.argv[2:]))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def world(tmp_path):
    """A sqlite store of ``MyApp``'s events, an engine variant whose
    factory saves each rank's factors, JAX's init for its tables."""
    from predictionio_tpu_torch.data import storage as tstorage
    from predictionio_tpu_torch.templates.recommendation import engine as rec
    from test_torch_lifecycle import configure, fill

    configure(tstorage, "sqlite", tmp_path / "port.db")
    fill(tstorage, "predictionio_tpu_torch")
    ds = rec.EventDataSource(rec.DataSourceParams(app_name="MyApp"))
    (tmp_path / "shardtrain_engine.py").write_text(ENGINE)
    env = dict(os.environ, PIO_STORAGE_SOURCES_S_TYPE="sqlite",
               PIO_STORAGE_SOURCES_S_PATH=str(tmp_path / "port.db"),
               PYTHONPATH=os.pathsep.join([str(ROOT), str(tmp_path)]),
               CUDA_VISIBLE_DEVICES="", OUT_DIR=str(tmp_path))
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "S"
    for var in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY", "PIO_RESUME",
                "PIO_ALS_PRECISION", "PIO_NUM_HOSTS", "PIO_COORDINATOR",
                "PIO_PROCESS_ID"):
        env.pop(var, None)
    td = ds.read_training(None)
    yield {"tmp": tmp_path, "env": env, "td": td, "storage": tstorage}
    tstorage.reset()


def _variant(tmp_path, bucketed_):
    path = tmp_path / f"engine-{bucketed_}.json"
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "shardtrain_engine:factory",
        "datasource": {"params": {"appName": "MyApp"}},
        "preparator": {"params": {"bucketed": bucketed_}},
        "algorithms": [{"name": "als", "params": {
            "rank": 6, "numIterations": 3, "lambda": 0.05, "seed": 1}}]}))
    return str(path)


def _run_children(world, argvs, timeout=120):
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(world["tmp"] / "init.npz"), *argv],
        env=world["env"], cwd=world["tmp"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, out + err
    return outs


@pytest.mark.parametrize("bucketed_", [False, True],
                         ids=["uniform-allgather", "bucketed-allreduce"])
def test_two_process_gloo_training(world, bucketed_):
    """``pio train --num-hosts 2`` on two gloo ranks (no card visible):
    each joins the world, both train one collective run on the CPU, rank
    0 stores the instance and rank 1 nothing; both ranks' factors equal
    the single-process run bitwise and JAX's ``train_als`` within
    1e-4 of the largest factor. ``--checkpoint-dir`` warns and writes
    nothing across processes."""
    from predictionio_tpu_torch.templates.recommendation import engine as rec

    tmp = world["tmp"]
    pd = rec.RatingsPreparator(rec.PreparatorParams()).prepare(
        None, world["td"])
    n_u, n_i = pd.user_side.n_rows, pd.item_side.n_rows
    X0, Y0 = (np.asarray(a) for a in jals.init_factors(n_u, n_i, 6, 1))
    np.savez(tmp / "init.npz", X=X0, Y=Y0)
    variant = _variant(tmp, bucketed_)
    train = ["train", "--device", "cpu", "--engine-variant", variant]
    [(_, single_out, _)] = _run_children(world, [train])
    single = np.load(tmp / "rank0.npz")
    single = (single["X"], single["Y"])
    (tmp / "rank0.npz").unlink()
    port = _free_port()
    outs = _run_children(world, [
        train + ["--num-hosts", "2", "--coordinator", f"127.0.0.1:{port}",
                 "--process-id", str(r), "--checkpoint-dir",
                 str(tmp / "ck")] for r in (0, 1)])
    assert "Joined distributed runtime: host 0/2" in outs[0][1]
    assert "Joined distributed runtime: host 1/2" in outs[1][1]
    assert "Engine instance ID" in outs[0][1]
    assert "Secondary host: training complete" in outs[1][1]
    assert "Engine instance ID" not in outs[1][1]
    assert all("writes NO checkpoints" in err for _, _, err in outs)
    assert not (tmp / "ck").exists()
    for r in (0, 1):
        got = np.load(tmp / f"rank{r}.npz")
        equal((got["X"], got["Y"]), single)
    want = jals.train_als(
        jals.PaddedRatings(pd.user_side.cols, pd.user_side.weights,
                           pd.user_side.mask, n_u, pd.user_side.n_cols),
        jals.PaddedRatings(pd.item_side.cols, pd.item_side.weights,
                           pd.item_side.mask, n_i, pd.item_side.n_cols),
        jals.ALSParams(rank=6, num_iterations=3, lambda_=0.05, seed=1))
    for g, w in zip(single, want):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    # only rank 0 recorded an instance: the single run's and the world's
    st = world["storage"]
    st.reset()
    from test_torch_lifecycle import configure

    configure(st, "sqlite", tmp / "port.db")
    instances = st.get_metadata_engine_instances().get_all()
    assert len(instances) == 2
    assert all(i.status == "COMPLETED" for i in instances)
    assert "Engine instance ID" in single_out
