"""The port's bf16 training precision against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. On
CPU tensors the port's kernel wrappers run their plain versions (B3's
bf16 route, the CUDA kernel, is held against its plain version on the
card by ``chip_smoke.py`` phase 2b); JAX runs ``_solve_rows`` with its
LAPACK solver, as its own precision suite does on the CPU.

Tolerances, and why (``EPS_BF16 = 2^-8``, one bf16 rounding, as in
``tests/test_als_precision.py``):

- One bf16 half-step: relative Frobenius error at most ``EPS_BF16 / 8``.
  Both packages round the weights to bf16 before the products, sum in
  fp32 and round the new factors to bf16; measured 0.0 on these
  fixtures (the outputs are bitwise equal). A port that skipped the
  weight rounding lands ~2e-3 away (about ``EPS_BF16 / 2``), so the
  bound sees it: the fixtures use non-integer ratings and ``alpha != 1``.
- Training: within ``4 * iterations * EPS_BF16`` relative, the JAX
  suite's own bound for bf16 against fp32, here for bf16 against JAX's
  bf16 from one shared init.
- bf16 against fp32, and uniform against bucketed tables under bf16:
  the same ``4 * iterations * EPS_BF16``.
- The plain assembly on a bf16 ``Y`` equals it on ``Y.float()``: widening
  bf16 to fp32 is exact, so the two are the same arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.ops import serving as tserving
from predictionio_tpu_torch.parallel.als_sharding import train_als_auto

CPU = "cpu"
EPS_BF16 = 2.0 ** -8
ITERS = 3


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def ratings(seed, n_users=40, n_items=60, n=700):
    """Rating triples with continuous (non-integer, some negative)
    values, duplicate pairs and empty rows/columns at the top."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_users - 3, n)
    cols = rng.integers(0, n_items - 4, n)
    rows[: n // 10] = rows[n // 10: n // 5]
    cols[: n // 10] = cols[n // 10: n // 5]
    vals = (rng.normal(size=n) * 2.3 + 1.1).astype(np.float32)
    return rows, cols, vals, n_users, n_items


def t(a):
    return torch.from_numpy(np.array(a))


def jax_init(n_rows, n_cols, rank, seed, device=None):
    """The JAX package's fp32 init as torch tensors: both packages'
    trainers then cast the same numbers to bf16."""
    X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
    return (torch.from_numpy(np.array(X)).to(device),
            torch.from_numpy(np.array(Y)).to(device))


class TestPolicy:
    @pytest.mark.parametrize("env,param,want", [
        ("", "fp32", "fp32"), ("", "bf16", "bf16"), ("", "bfloat16", "bf16"),
        ("", "float32", "fp32"), ("bf16", "fp32", "bf16"),
        ("fp32", "bf16", "fp32"), (" BFloat16 ", "fp32", "bf16"),
        ("", None, "fp32")])
    def test_env_over_params_and_aliases_match_jax(self, monkeypatch, env,
                                                   param, want):
        monkeypatch.setenv("PIO_ALS_PRECISION", env)
        got = tals._als_precision_mode(tals.ALSParams(precision=param))
        assert got == want == jals._als_precision_mode(
            jals.ALSParams(precision=param))
        assert tals.factor_dtype(got) == (
            torch.bfloat16 if want == "bf16" else torch.float32)

    @pytest.mark.parametrize("env,param,source", [
        ("fp8", "fp32", "PIO_ALS_PRECISION"),
        ("", "fp16", "ALSParams.precision"),
        ("int8", "fp32", "PIO_ALS_PRECISION")])
    def test_unknown_raises_naming_its_source(self, monkeypatch, env, param,
                                              source):
        monkeypatch.setenv("PIO_ALS_PRECISION", env)
        with pytest.raises(ValueError, match=source) as got:
            tals._als_precision_mode(tals.ALSParams(precision=param))
        with pytest.raises(ValueError) as want:
            jals._als_precision_mode(jals.ALSParams(precision=param))
        assert str(got.value) == str(want.value)

    def test_unknown_raises_at_train(self, monkeypatch):
        monkeypatch.delenv("PIO_ALS_PRECISION", raising=False)
        rows, cols, vals, n_u, n_i = ratings(1, n=100)
        with pytest.raises(ValueError, match="precision"):
            tals.train_als(tals.pad_ratings(rows, cols, vals, n_u, n_i),
                           tals.pad_ratings(cols, rows, vals, n_i, n_u),
                           tals.ALSParams(rank=4, precision="turbo"), CPU)

    def test_env_change_between_trainings_takes_effect(self, monkeypatch):
        rows, cols, vals, n_u, n_i = ratings(2, n=400)
        us = tals.pad_ratings(rows, cols, vals, n_u, n_i)
        its = tals.pad_ratings(cols, rows, vals, n_i, n_u)
        params = tals.ALSParams(rank=8, num_iterations=ITERS, seed=2)
        monkeypatch.delenv("PIO_ALS_PRECISION", raising=False)
        X32, _ = tals.train_als(us, its, params, CPU)
        monkeypatch.setenv("PIO_ALS_PRECISION", "bf16")
        Xenv, _ = tals.train_als(us, its, params, CPU)
        monkeypatch.delenv("PIO_ALS_PRECISION")
        Xpar, _ = tals.train_als(us, its,
                                 dataclasses.replace(params, precision="bf16"),
                                 CPU)
        np.testing.assert_array_equal(Xenv, Xpar)
        assert not np.array_equal(Xenv, X32)
        X32b, _ = tals.train_als(us, its, params, CPU)
        np.testing.assert_array_equal(X32, X32b)

    def test_init_draws_fp32_then_casts(self):
        X32, Y32 = tals.init_factors(9, 7, 5, 3, CPU)
        Xb, Yb = tals.init_policy_factors(9, 7, 5, 3, "bf16", CPU)
        assert Xb.dtype == Yb.dtype == torch.bfloat16
        assert torch.equal(Xb, X32.to(torch.bfloat16))
        assert torch.equal(Yb, Y32.to(torch.bfloat16))
        Xf, _ = tals.init_policy_factors(9, 7, 5, 3, "fp32", CPU)
        assert torch.equal(Xf, X32)


class TestHalfStep:
    @pytest.mark.parametrize("implicit,refine", [
        (True, False), (True, True), (False, False), (False, True)])
    def test_solve_rows_bf16_against_jax(self, implicit, refine):
        rows, cols, vals, n_u, n_i = ratings(3)
        rng = np.random.default_rng(30)
        Y = (rng.normal(size=(n_i, 8)) / np.sqrt(8)).astype(np.float32)
        side = jals.pad_ratings(rows, cols, vals, n_u, n_i)
        args = (side.cols, side.weights, side.mask)
        want = jals._solve_rows(
            jnp.asarray(Y).astype(jnp.bfloat16), *map(jnp.asarray, args),
            0.05, 0.7, implicit, solver="cho", precision="bf16",
            refine=refine)
        got = tals._solve_rows(t(Y).to(torch.bfloat16), *map(t, args), 0.05,
                               0.7, implicit, refine=refine)
        assert got.dtype == torch.bfloat16
        assert rel_err(got.float(), np.asarray(want, np.float32)) \
            <= EPS_BF16 / 8
        assert not got[-3:].any()               # rows with no ratings

    def test_plain_assembly_of_bf16_equals_its_fp32_widening(self):
        rng = np.random.default_rng(4)
        Y = t(rng.normal(size=(30, 7)).astype(np.float32)).to(torch.bfloat16)
        cols = t(rng.integers(0, 30, (5, 11)).astype(np.int32))
        aw = t(rng.normal(size=(5, 11)).astype(np.float32))
        bw = t(rng.normal(size=(5, 11)).astype(np.float32))
        gram = t(rng.normal(size=(7, 7)).astype(np.float32))
        A, b = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        A2, b2 = als_cuda.assemble_normal_equations_plain(Y.float(), cols, aw,
                                                          bw, gram)
        assert A.dtype == b.dtype == torch.float32
        assert torch.equal(A, A2) and torch.equal(b, b2)
        # the CPU wrapper takes the bf16 store as it is
        A3, b3 = als_cuda.assemble_normal_equations(Y, cols, aw, bw, gram)
        assert torch.equal(A3, A) and torch.equal(b3, b)

    def test_assembly_arguments_are_dtype_aware(self):
        Y = torch.zeros((6, 4), dtype=torch.bfloat16)
        cols = torch.zeros((2, 3), dtype=torch.int32)
        w = torch.zeros((2, 3))
        gram = torch.zeros((4, 4))
        assert als_cuda.check_assembly_args(Y, cols, w, w, gram, 208) == \
            (6, 4, 2, 3)
        assert als_cuda.assembly_route(64, 208, torch.bfloat16) == "tiles"
        assert als_cuda.assembly_route(209, 208, torch.bfloat16) == \
            "tile_groups"
        for dtype in (torch.float16, torch.float64, torch.int8):
            with pytest.raises(TypeError, match="fp32 or bf16"):
                als_cuda.check_assembly_args(Y.to(dtype), cols, w, w, gram,
                                             208)
            with pytest.raises(TypeError, match="fp32 or bf16"):
                als_cuda.assembly_route(64, 208, dtype)


def bf16_tables(seed, n=900):
    rows, cols, vals, n_u, n_i = ratings(seed, n=n)
    rng = np.random.default_rng(seed + 100)
    X = (rng.normal(size=(n_u, 6)) / np.sqrt(6)).astype(np.float32)
    Y = (rng.normal(size=(n_i, 6)) / np.sqrt(6)).astype(np.float32)
    return rows, cols, vals, n_u, n_i, X, Y


def loop_kw(implicit):
    return dict(lam=0.05 if implicit else 0.1, alpha=0.7, implicit=implicit,
                num_iterations=ITERS)


class TestTraining:
    @pytest.mark.parametrize("implicit", [True, False])
    def test_als_iterations_bf16_against_jax(self, implicit):
        rows, cols, vals, n_u, n_i, X, Y = bf16_tables(5)
        u = tals.pad_ratings(rows, cols, vals, n_u, n_i)
        i = tals.pad_ratings(cols, rows, vals, n_i, n_u)
        tabs = (u.cols, u.weights, u.mask, i.cols, i.weights, i.mask)
        bf = jnp.bfloat16
        jX, jY = jals._als_iterations(
            jnp.asarray(X).astype(bf), jnp.asarray(Y).astype(bf),
            *map(jnp.asarray, tabs), solver="cho", precision="bf16",
            **loop_kw(implicit))
        tX, tY = tals.als_iterations(
            t(X).to(torch.bfloat16), t(Y).to(torch.bfloat16), *map(t, tabs),
            **loop_kw(implicit))
        assert tX.dtype == tY.dtype == torch.bfloat16
        bound = 4 * ITERS * EPS_BF16
        assert rel_err(tX.float(), np.asarray(jX, np.float32)) < bound
        assert rel_err(tY.float(), np.asarray(jY, np.float32)) < bound

    @pytest.mark.parametrize("implicit", [True, False])
    def test_als_iterations_bucketed_bf16_against_jax(self, implicit):
        rows, cols, vals, n_u, n_i, X, Y = bf16_tables(6)
        us, is_ = tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i)

        def tuples(side, put):
            return tuple((put(b.row_ids), put(b.cols), put(b.weights),
                          put(b.mask)) for b in side.buckets)

        bf = jnp.bfloat16
        jX, jY = jals._als_iterations_bucketed(
            jnp.asarray(X).astype(bf), jnp.asarray(Y).astype(bf),
            tuples(us, jnp.asarray), tuples(is_, jnp.asarray),
            slot_budget=None, solver="cho", precision="bf16",
            **loop_kw(implicit))
        tX, tY = tals.als_iterations_bucketed(
            t(X).to(torch.bfloat16), t(Y).to(torch.bfloat16),
            tuples(us, t), tuples(is_, t), slot_budget=None,
            **loop_kw(implicit))
        assert tX.dtype == tY.dtype == torch.bfloat16
        bound = 4 * ITERS * EPS_BF16
        assert rel_err(tX.float(), np.asarray(jX, np.float32)) < bound
        assert rel_err(tY.float(), np.asarray(jY, np.float32)) < bound

    @pytest.mark.parametrize("layout", ["uniform", "bucketed"])
    def test_trainers_bf16_against_jax(self, monkeypatch, layout):
        monkeypatch.setattr(tals, "init_factors", jax_init)
        monkeypatch.delenv("PIO_ALS_PRECISION", raising=False)
        rows, cols, vals, n_u, n_i = ratings(7, n=900)
        params = dict(rank=6, num_iterations=ITERS, lambda_=0.05, alpha=0.7,
                      seed=5, precision="bf16")
        if layout == "uniform":
            want = jals.train_als(
                jals.pad_ratings(rows, cols, vals, n_u, n_i),
                jals.pad_ratings(cols, rows, vals, n_i, n_u),
                jals.ALSParams(**params))
            got = tals.train_als(
                tals.pad_ratings(rows, cols, vals, n_u, n_i),
                tals.pad_ratings(cols, rows, vals, n_i, n_u),
                tals.ALSParams(**params), CPU)
        else:
            want = jals.train_als_bucketed(
                *jals.bucket_ratings_pair(rows, cols, vals, n_u, n_i),
                jals.ALSParams(**params))
            got = tals.train_als_bucketed(
                *tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i),
                tals.ALSParams(**params), CPU)
        for g, w in zip(got, want):
            # host factors always land fp32
            assert g.dtype == np.float32 and g.shape == w.shape
            assert rel_err(g, w) < 4 * ITERS * EPS_BF16

    @pytest.mark.parametrize("implicit", [True, False])
    def test_bf16_close_to_fp32_and_bucketed_to_uniform(self, implicit):
        rows, cols, vals, n_u, n_i = ratings(8, n=900)
        params = tals.ALSParams(rank=6, num_iterations=ITERS, lambda_=0.1,
                                alpha=0.7, seed=6, implicit_prefs=implicit)
        bf16 = dataclasses.replace(params, precision="bf16")
        uniform = (tals.pad_ratings(rows, cols, vals, n_u, n_i),
                   tals.pad_ratings(cols, rows, vals, n_i, n_u))
        bucketed = tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i)
        X32, Y32 = train_als_auto(*uniform, params, CPU)
        Xu, Yu = train_als_auto(*uniform, bf16, CPU)
        Xb, Yb = train_als_auto(*bucketed, bf16, CPU)
        bound = 4 * ITERS * EPS_BF16
        for got in (Xu, Yu, Xb, Yb):
            assert got.dtype == np.float32
        assert rel_err(Xu, X32) < bound and rel_err(Yu, Y32) < bound
        assert rel_err(Xb, Xu) < bound and rel_err(Yb, Yu) < bound
        assert not np.array_equal(Xu, X32)     # the other lane ran


class TestFoldIn:
    @pytest.mark.parametrize("implicit", [True, False])
    def test_fold_in_users_bf16_against_jax(self, monkeypatch, implicit):
        monkeypatch.delenv("PIO_ALS_PRECISION", raising=False)
        rng = np.random.default_rng(9)
        Y = (rng.normal(size=(50, 8)) / np.sqrt(8)).astype(np.float32)
        cols_list = [rng.choice(50, size=int(n), replace=False)
                     for n in (1, 7, 30, 12, 3)]
        vals_list = [(rng.normal(size=len(c)) * 2 + 1).astype(np.float32)
                     for c in cols_list]
        kw = dict(rank=8, lambda_=0.05, alpha=0.7, implicit_prefs=implicit,
                  precision="bf16")
        want = jals.fold_in_users(Y, cols_list, vals_list,
                                  jals.ALSParams(**kw))
        got = tals.fold_in_users(Y, cols_list, vals_list,
                                 tals.ALSParams(**kw), device=CPU)
        assert got.dtype == np.float32 and got.shape == (5, 8)
        assert rel_err(got, want) <= EPS_BF16 / 8
        # the env policy folds the same way
        monkeypatch.setenv("PIO_ALS_PRECISION", "bf16")
        env = tals.fold_in_users(
            Y, cols_list, vals_list,
            tals.ALSParams(**dict(kw, precision="fp32")), device=CPU)
        np.testing.assert_array_equal(env, got)

    def test_store_rows_in_the_fold_dtype(self, monkeypatch):
        rng = np.random.default_rng(10)
        X = rng.normal(size=(5, 4)).astype(np.float32)
        Y = rng.normal(size=(13, 4)).astype(np.float32)
        for store, want in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            monkeypatch.setenv("PIO_SERVE_PRECISION", store)
            srv = tserving.DeviceTopK(X, Y, None, microbatch=False,
                                      device=CPU)
            own = srv.item_factors_as(want)
            assert own.dtype == want and tuple(own.shape) == (13, 4)
            # a store of the fold's dtype hands over its own rows
            assert own.data_ptr() == srv._Y.data_ptr()
            other = torch.float32 if want == torch.bfloat16 else \
                torch.bfloat16
            cast = srv.item_factors_as(other)
            assert cast.dtype == other
            assert torch.equal(cast, own.float().to(other))
