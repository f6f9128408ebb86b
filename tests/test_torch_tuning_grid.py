"""The port's config grid (ops/tuning.py, workflow/tuning.py, the grid
half-step of ops/als.py and ``run_chunked_grid``) against the JAX
package's, on the CPU (the JAX grid as its own suite runs it here).

Factor init cannot match ``jax.random``, so every differential against
JAX injects one shared ``[k, N, R_max]`` init, made with numpy, into both
packages' ``init_grid_factors``. Tolerances, stated per test:

- fp32 grids: ``RTOL`` 1e-4 / ``ATOL`` 1e-5 against the JAX grid (the
  JAX suite's grid-vs-serial gate: the same sums in other orders);
  against the port's own serial ``train_als_bucketed`` runs: bitwise;
- bf16 grids: relative Frobenius error under ``4 * iters * 2^-8``;
- rank-padded columns: exactly zero;
- spec errors, manifest keys, the memory plan and the leaderboard on the
  same factors: equal.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import tuning as jt
from predictionio_tpu.utils import metrics as jmetrics
from predictionio_tpu.workflow import checkpoint as jckpt
from predictionio_tpu.workflow import tuning as jwt
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import tuning as tt
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.workflow import checkpoint as tckpt
from predictionio_tpu_torch.workflow import tuning as twt
from predictionio_tpu_torch.workflow.checkpoint import TrainingDivergedError

RTOL, ATOL = 1e-4, 1e-5
EPS_BF16 = 2.0 ** -8
DEAD_ALPHA = 1e38    # overflows the fp32 confidence weights to inf
CPU = "cpu"


def triples(seed=0, n_u=60, n_i=40, nnz=500):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u, nnz)
    cols = rng.integers(0, n_i, nnz)
    vals = (rng.random(nnz).astype(np.float32) + 0.5)
    return rows, cols, vals, n_u, n_i


def sides(pkg, seed=0, **kw):
    rows, cols, vals, n_u, n_i = triples(seed, **kw)
    return pkg.bucket_ratings_pair(rows, cols, vals, n_u, n_i)


def grids(base_kw, overrides):
    """The same grid in both packages."""
    return (jt.make_grid(jals.ALSParams(**base_kw), overrides),
            tt.make_grid(tals.ALSParams(**base_kw), overrides))


def shared_init(tgrid, n_u, n_i, seed=11):
    """One ``[k, N, R_max]`` / ``[k, M, R_max]`` fp32 init: each config
    drawn at its rank (scale ``1/sqrt(rank)``), its pad columns zero."""
    rng = np.random.default_rng(seed)
    r_max = tgrid.max_rank
    X = np.zeros((tgrid.k, n_u, r_max), np.float32)
    Y = np.zeros((tgrid.k, n_i, r_max), np.float32)
    for z, r in enumerate(tgrid.ranks):
        X[z, :, :r] = rng.standard_normal((n_u, r)) / np.sqrt(r)
        Y[z, :, :r] = rng.standard_normal((n_i, r)) / np.sqrt(r)
    return X, Y


@pytest.fixture
def inject(monkeypatch):
    """Make both packages' grid trainers start from ``shared_init``."""
    def install(X, Y):
        monkeypatch.setattr(
            jt, "init_grid_factors",
            lambda n_u, n_i, grid, dtype, precision: (
                jnp.asarray(X).astype(jals.factor_dtype(precision)),
                jnp.asarray(Y).astype(jals.factor_dtype(precision))))
        monkeypatch.setattr(
            tt, "init_grid_factors",
            lambda n_u, n_i, grid, precision, device=None: (
                torch.from_numpy(X.copy()).to(tals.factor_dtype(precision)),
                torch.from_numpy(Y.copy()).to(tals.factor_dtype(precision))))
    return install


def train_both(inject, base_kw, overrides, seed=0, **size):
    jgrid, tgrid = grids(base_kw, overrides)
    ju, ji = sides(jals, seed, **size)
    tu, ti = sides(tals, seed, **size)
    X0, Y0 = shared_init(tgrid, tu.n_rows, ti.n_rows)
    inject(X0, Y0)
    return (jt.train_als_grid_bucketed(ju, ji, jgrid),
            tt.train_als_grid_bucketed(tu, ti, tgrid, device=CPU))


# -- the spec: the same errors, line for line ----------------------------------

BAD_SPECS = {
    "unknown field": {"base": {"rank": 4},
                      "configs": [{"lambda": 0.1}, {"lambada": 0.2}]},
    "not sweepable": {"base": {"rank": 4},
                      "configs": [{"num_iterations": 9}, {"seed": 7}]},
    "every problem": {"base": {}, "configs": [
        {"bogus": 1, "precision": "bf16"}, {"rank": 0}, 5]},
    "bad value": {"base": {}, "configs": [{"alpha": "x"}]},
    "unknown section": {"bsae": {}, "configs": [{}]},
    "base field": {"base": {"frobnicate": 1}, "configs": [{}]},
    "empty configs": {"base": {}, "configs": []},
    "base not an object": {"base": [1], "configs": [{}]},
    "base keyword": {"base": {"lambda": 0.1, "rank": 3, "ranks": 4},
                     "configs": [{}]},
    "spec not an object": [1, 2],
}


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_spec_errors_equal_the_jax_ones(name):
    spec = BAD_SPECS[name]
    with pytest.raises(jt.GridConfigError) as je:
        jt.grid_from_spec(spec)
    with pytest.raises(tt.GridConfigError) as te:
        tt.grid_from_spec(spec)
    assert str(te.value).splitlines() == str(je.value).splitlines()


def test_grid_shape_and_the_shared_fields_rule():
    spec = {"base": {"rank": 4, "numIterations": 3, "seed": 1,
                     "lambda": 0.2},
            "configs": [{"rank": 2}, {"lambda_": 0.7}, {"alpha": 2}]}
    jg, tg = jt.grid_from_spec(spec), tt.grid_from_spec(spec)
    assert tg.describe() == jg.describe()
    assert (tg.k, tg.max_rank, tg.ranks) == (jg.k, jg.max_rank, jg.ranks)
    assert tg.subset([2, 0]).describe() == jg.subset([2, 0]).describe()
    assert dataclasses.asdict(tg.base) == dataclasses.asdict(jg.base)
    for pkg, als in ((jt, jals), (tt, tals)):
        base = als.ALSParams(rank=4)
        with pytest.raises(pkg.GridConfigError, match="num_iterations"):
            pkg.ConfigGrid((base, dataclasses.replace(base,
                                                      num_iterations=9)))
    with pytest.raises(tt.GridConfigError, match="at least 1"):
        tt.ConfigGrid(())


# -- training against the JAX grid ------------------------------------------------

def test_fp32_lambda_alpha_sweep_matches_jax(inject):
    jres, tres = train_both(
        inject, dict(rank=4, num_iterations=4, seed=3),
        [{"lambda": 0.01}, {"lambda": 0.3}, {"alpha": 5.0},
         {"lambda": 1.0, "alpha": 20.0}])
    assert tres.alive.tolist() == jres.alive.tolist() == [True] * 4
    np.testing.assert_allclose(tres.user_factors, jres.user_factors,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tres.item_factors, jres.item_factors,
                               rtol=RTOL, atol=ATOL)


def test_rank_sweep_matches_jax_with_exact_zero_pads(inject):
    jres, tres = train_both(
        inject, dict(rank=4, num_iterations=4, seed=3),
        [{"rank": 2}, {"rank": 4}, {"rank": 3, "lambda": 0.5}], seed=1)
    for i, r in enumerate(tres.grid.ranks):
        assert not tres.user_factors[i, :, r:].any()
        assert not tres.item_factors[i, :, r:].any()
        for got, want in zip(tres.factors_for(i), jres.factors_for(i)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_grid_matches_jax(inject):
    iters = 3
    jres, tres = train_both(
        inject, dict(rank=4, num_iterations=iters, seed=3,
                     precision="bf16"),
        [{"lambda": 0.05}, {"lambda": 0.4}], seed=2)
    for got, want in ((tres.user_factors, jres.user_factors),
                      (tres.item_factors, jres.item_factors)):
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < 4 * iters * EPS_BF16


def test_single_config_grid_matches_jax(inject):
    jres, tres = train_both(inject, dict(rank=4, num_iterations=4, seed=3),
                            [{"lambda": 0.2}], seed=4)
    assert tres.alive.tolist() == [True]
    np.testing.assert_allclose(tres.user_factors, jres.user_factors,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_grid_is_bitwise_its_serial_runs(precision):
    """Each config of the port's grid, from the port's own init, equals
    its serial ``train_als_bucketed`` run bit for bit, rank-padded
    configs included (the pad columns exactly zero)."""
    tu, ti = sides(tals, 6)
    grid = tt.make_grid(
        tals.ALSParams(rank=4, num_iterations=3, seed=3,
                       precision=precision),
        [{"lambda": 0.05}, {"rank": 2}, {"lambda": 0.5, "alpha": 4.0}])
    res = tt.train_als_grid_bucketed(tu, ti, grid, device=CPU)
    for i, cfg in enumerate(grid.configs):
        Xs, Ys = tals.train_als_bucketed(tu, ti, cfg, device=CPU)
        Xg, Yg = res.factors_for(i)
        assert np.array_equal(Xg, Xs) and np.array_equal(Yg, Ys)
        assert not res.user_factors[i, :, cfg.rank:].any()


# -- divergence ---------------------------------------------------------------------

def test_dead_lane_is_masked_as_in_jax(inject):
    tdead0 = tmetrics.TRAIN_DIVERGED.value()
    jdead0 = jmetrics.TRAIN_DIVERGED.value()
    jres, tres = train_both(
        inject, dict(rank=4, num_iterations=4, seed=3),
        [{"lambda": 0.1}, {"alpha": DEAD_ALPHA}, {"lambda": 0.7}], seed=5)
    assert tres.alive.tolist() == jres.alive.tolist() == [True, False, True]
    # TRAIN_DIVERGED counts each dead config once, in both packages
    assert tmetrics.TRAIN_DIVERGED.value() - tdead0 == 1
    assert jmetrics.TRAIN_DIVERGED.value() - jdead0 == 1
    assert not tres.user_factors[1].any() and not tres.item_factors[1].any()
    assert np.isfinite(tres.user_factors).all()
    np.testing.assert_allclose(tres.user_factors, jres.user_factors,
                               rtol=RTOL, atol=ATOL)


def test_all_dead_raises_in_both():
    for pkg, als, kw in ((jt, jals, {}), (tt, tals, {"device": CPU})):
        grid = pkg.make_grid(als.ALSParams(rank=4, num_iterations=4, seed=3),
                             [{"alpha": DEAD_ALPHA}, {"alpha": 2e38}])
        with pytest.raises(TrainingDivergedError
                           if pkg is tt else jckpt.TrainingDivergedError,
                           match="every grid config diverged"):
            pkg.train_als_grid_bucketed(*sides(als, 6), grid, **kw)


# -- checkpointed grid: resume and the manifest -------------------------------------

@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "2")
    tckpt.clear_stop()
    jckpt.clear_stop()
    yield tmp_path
    tckpt.clear_stop()
    jckpt.clear_stop()


def preempt_then_resume(pkg, ckpt_mod, grid, u, i, directory, monkeypatch,
                        **kw):
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(directory))
    monkeypatch.delenv("PIO_RESUME", raising=False)
    ckpt_mod.request_stop()
    with pytest.raises(ckpt_mod.TrainingPreempted):
        pkg.train_als_grid_bucketed(u, i, grid, **kw)
    ckpt_mod.clear_stop()
    manifest = json.loads(sorted(directory.glob("ckpt-*.json"))[-1]
                          .read_text())
    monkeypatch.setenv("PIO_RESUME", "1")
    out = pkg.train_als_grid_bucketed(u, i, grid, **kw)
    monkeypatch.delenv("PIO_RESUME")
    monkeypatch.delenv("PIO_CHECKPOINT_DIR")
    return manifest, out


def test_mid_grid_resume_is_bitwise_and_the_manifest_is_jax_shaped(
        ckpt_env, monkeypatch):
    base = dict(rank=4, num_iterations=6, seed=3)
    overrides = [{"lambda": 0.1}, {"alpha": DEAD_ALPHA}, {"rank": 2}]
    jgrid, tgrid = grids(base, overrides)
    tu, ti = sides(tals, 9)
    ref = tt.train_als_grid_bucketed(tu, ti, tgrid, device=CPU)
    assert ref.alive.tolist() == [True, False, True]
    tdead0 = tmetrics.TRAIN_DIVERGED.value()
    tman, got = preempt_then_resume(tt, tckpt, tgrid, tu, ti,
                                    ckpt_env / "port", monkeypatch,
                                    device=CPU)
    assert np.array_equal(got.user_factors, ref.user_factors)
    assert np.array_equal(got.item_factors, ref.item_factors)
    assert got.alive.tolist() == ref.alive.tolist()
    # the dead lane died before the preemption: its mask rode the
    # manifest, and the resume counted no second divergence
    assert tman["step"] == 2 and tman["extra"]["aliveConfigs"] == [
        True, False, True]
    assert tmetrics.TRAIN_DIVERGED.value() - tdead0 == 1
    jman, _ = preempt_then_resume(jt, jckpt, jgrid, *sides(jals, 9),
                                  ckpt_env / "jax", monkeypatch)
    assert sorted(tman) == sorted(jman)
    assert sorted(tman["extra"]) == sorted(jman["extra"])
    assert tman["extra"]["gridK"] == jman["extra"]["gridK"] == 3
    assert tman["extra"]["aliveConfigs"] == jman["extra"]["aliveConfigs"]
    assert tman["shapes"] == jman["shapes"]


# -- the memory plan and sub-batches ------------------------------------------------

def test_budget_env_override_and_reserved_reports(monkeypatch):
    monkeypatch.setenv("PIO_TUNING_HBM_BUDGET", "1000000")
    reports = [{"totalBytes": 300_000}, {"memory": {"totalBytes": 200_000}}]
    assert twt.hbm_budget_bytes() == jwt.hbm_budget_bytes() == 1_000_000
    assert twt.hbm_budget_bytes(reports) == jwt.hbm_budget_bytes(reports) \
        == 500_000
    monkeypatch.delenv("PIO_TUNING_HBM_BUDGET")
    assert twt.hbm_budget_bytes(device=CPU) is None


def test_plan_equals_the_jax_plan():
    overrides = [{"lambda": v} for v in (0.1, 0.2, 0.3, 0.4, 0.5)]
    for precision in ("fp32", "bf16"):
        jgrid, tgrid = grids(dict(rank=4, precision=precision,
                                  bucket_slot_budget=64), overrides)
        ju, ji = sides(jals, 11)
        tu, ti = sides(tals, 11)
        per = twt.grid_bytes_per_config(60, 40, tgrid, tu, ti)
        assert per == jwt.grid_bytes_per_config(60, 40, jgrid, ju, ji) > 0
        for budget in (None, 1, per, 2 * per, 3 * per + 1, 10 * per):
            want = jwt.plan_grid_batches(jgrid, 60, 40, ju, ji,
                                         budget_bytes=budget)
            got = twt.plan_grid_batches(tgrid, 60, 40, tu, ti,
                                        budget_bytes=budget, device=CPU)
            assert got == want


def test_sub_batched_run_equals_the_full_grid(monkeypatch):
    """Forced into 2-config sub-batches (through the env budget), the
    factors and the leaderboard equal the one-batch run's."""
    tu, ti = sides(tals, 12, n_u=40, n_i=30, nnz=350)
    grid = tt.make_grid(tals.ALSParams(rank=4, num_iterations=4, seed=3),
                        [{"lambda": 0.05}, {"lambda": 0.2}, {"rank": 2},
                         {"lambda": 0.8}])
    rng = np.random.default_rng(3)
    tr, tc = rng.integers(0, 40, 250), rng.integers(0, 30, 250)
    held = {u: {int(rng.integers(0, 30))} for u in range(15)}
    kw = dict(train_rows=tr, train_cols=tc, held=held, warmup=False,
              device=CPU)
    full = twt.run_grid(tu, ti, grid, **kw)
    per = twt.grid_bytes_per_config(40, 30, grid, tu, ti)
    monkeypatch.setenv("PIO_TUNING_HBM_BUDGET", str(2 * per))
    split = twt.run_grid(tu, ti, grid, **kw)
    assert full["batches"] == [4] and split["batches"] == [2, 2]
    assert split["hbmBudgetBytes"] == 2 * per
    assert full["rows"] == split["rows"]
    assert full["winner"] == split["winner"]


# -- evaluation on the same factors ------------------------------------------------

def result_pair(seed=7, k=3, n_u=30, n_i=20, r=4, dead=(1,)):
    """The same trained-looking factors as a GridTrainResult of each
    package (config ``dead`` zeroed and not alive)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((k, n_u, r)).astype(np.float32)
    Y = rng.standard_normal((k, n_i, r)).astype(np.float32)
    alive = np.ones(k, bool)
    for d in dead:
        X[d] = 0.0
        Y[d] = 0.0
        alive[d] = False
    overrides = [{"lambda": 0.1 * (z + 1)} for z in range(k)]
    jgrid, tgrid = grids(dict(rank=r), overrides)
    history = [{"step": 2, "fit": [1.0, None, 2.0], "l2": [0.5, None, 0.25],
                "total": [1.5, None, 2.25]}]
    return (jt.GridTrainResult(X, Y, jgrid, alive, history),
            tt.GridTrainResult(X, Y, tgrid, alive, history))


def test_grid_topk_and_leaderboard_equal_the_jax_ones():
    jres, tres = result_pair()
    rng = np.random.default_rng(0)
    tr, tc = rng.integers(0, 30, 200), rng.integers(0, 20, 200)
    held = {u: {int(rng.integers(0, 20))} for u in range(12)}
    users = sorted(held)
    jidx = jt.grid_topk(jres, users, tr, tc, 5, chunk=4)
    tidx, tvals = tt.grid_topk(tres, users, tr, tc, 5, chunk=4, device=CPU,
                               with_scores=True)
    # indices compared where the score is finite: past a user's unseen
    # items B1 leaves the -inf slots' ids unspecified (the plain version
    # on the CPU gives lax.top_k's lowest ids, so they agree here too)
    fin = np.isfinite(tvals)
    assert np.array_equal(tidx[fin], jidx[fin])
    assert np.array_equal(tidx, jidx)
    jboard = jt.grid_leaderboard(jres, tr, tc, held, topk=5)
    tboard = tt.grid_leaderboard(tres, tr, tc, held, topk=5, device=CPU)
    assert tboard == jboard
    assert tboard["rows"][-1]["diverged"] is True
    assert tboard["winner"]["config"] in (0, 2)


def test_solve_rows_extra_ridge_matches_jax():
    """The grid half-step's ``_solve_rows(extra_ridge=...)``: a rank-2
    config padded to 4 (zero factor columns, unit ridge on their
    diagonal) against JAX's, implicit and explicit, fp32 (1e-5); the pad
    coordinates solve to exact zeros."""
    rng = np.random.default_rng(18)
    M, R, r, B, L = 30, 4, 2, 10, 8
    Y = np.zeros((M, R), np.float32)
    Y[:, :r] = rng.standard_normal((M, r))
    cols = rng.integers(0, M, (B, L)).astype(np.int32)
    w = (rng.random((B, L)) + 0.5).astype(np.float32)
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    ridge = (np.arange(R) >= r).astype(np.float32)
    for implicit in (True, False):
        want = np.asarray(jals._solve_rows(
            jnp.asarray(Y), jnp.asarray(cols), jnp.asarray(w),
            jnp.asarray(mask), 0.1, 2.0, implicit,
            extra_ridge=jnp.asarray(ridge)))
        got = tals._solve_rows(
            torch.from_numpy(Y), torch.from_numpy(cols), torch.from_numpy(w),
            torch.from_numpy(mask), 0.1, 2.0, implicit,
            extra_ridge=torch.from_numpy(ridge)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not got[:, r:].any()


def test_grid_warmup_returns_true_on_the_cpu():
    tu, ti = sides(tals, 10)
    grid = tt.make_grid(tals.ALSParams(rank=4), [{"lambda": 0.1},
                                                 {"lambda": 0.9}])
    assert tals.warmup_train_als_bucketed(tu, ti, grid, device=CPU) is True
