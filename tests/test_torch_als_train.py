"""The port's ALS training slice against the JAX package, on the CPU.

Every case makes its inputs with numpy from a seed and hands the same
arrays to ``predictionio_tpu`` and ``predictionio_tpu_torch``. On CPU
tensors the port's kernel wrappers run their plain PyTorch versions (the
CUDA kernels themselves are held against those on the GPU by
``chip_smoke.py``); the JAX Pallas kernels run in interpret mode.

Tolerances, and why:

- Host layouts are the same numpy data movement in both packages, so
  every table is compared bit for bit.
- The assembly sums products in another order than the Pallas kernel.
  Integer-valued factors and weights (multiples of 0.5) keep every
  partial sum an exact fp32 value, so those fixtures must be EQUAL;
  continuous ones agree to 1e-5 of the largest entry (at most L=24
  products per entry, each order within 24 * 2^-24 of the sum of
  magnitudes).
- The solve: the port runs the Pallas kernel's algorithm (non-pivoted
  Cholesky, pivot ``max(d, 1e-30)``) with its own substitution order;
  against the Pallas kernel and against LAPACK the solutions of
  well-conditioned systems agree to 1e-4 of the largest entry, and the
  ill-scaled family (condition numbers up to ~1e8) is held to a relative
  residual below 1e-2, the JAX package's own bound for it.
- One half-step agrees with JAX ``_solve_rows`` / ``solve_side_pallas``
  to rtol 1e-4 of the largest factor: the port folds ``lam * I`` into the
  Gram term where the XLA path adds it after the sum, and solves with its
  own Cholesky where JAX calls LAPACK.
- Three ALS iterations agree to 1e-3 of the largest factor (implicit)
  and 5e-3 (explicit, where the per-row ``lam * n`` scaling leaves
  lightly-rated rows less well conditioned): the last-bit differences
  above pass through three rounds of solves.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import als_pallas
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.parallel.als_sharding import train_als_auto

CPU = "cpu"


def ratings(seed, n_users=40, n_items=60, n=500, dup=True):
    """Rating triples with duplicate pairs, empty rows and columns at the
    top of each range, and 0.5-step star values."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_users - 3, n)
    cols = rng.integers(0, n_items - 4, n)
    if dup:
        rows[: n // 10] = rows[n // 10: n // 5]
        cols[: n // 10] = cols[n // 10: n // 5]
    vals = (rng.integers(1, 11, n) * 0.5).astype(np.float32)
    return rows, cols, vals, n_users, n_items


def near(got, want, tol):
    """Largest |got - want| within ``tol`` times the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max error {err!r} of the largest entry > {tol}"


def t(a):
    return torch.from_numpy(np.array(a))


class TestLayouts:
    @pytest.mark.parametrize("max_len", [None, 5])
    @pytest.mark.parametrize("side", ["user", "item"])
    def test_pad_ratings_bitwise(self, max_len, side):
        rows, cols, vals, n_u, n_i = ratings(1)
        if side == "item":
            rows, cols, n_u, n_i = cols, rows, n_i, n_u
        want = jals.pad_ratings(rows, cols, vals, n_u, n_i, max_len=max_len)
        got = tals.pad_ratings(rows, cols, vals, n_u, n_i, max_len=max_len)
        for f in ("cols", "weights", "mask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
        assert not got.mask[-3:].any()          # empty rows stay empty

    def test_dedup_sums_duplicates(self):
        rows, cols, vals, _, n_i = ratings(2)
        for a, b in zip(tals.dedup_sum_ratings(rows, cols, vals, n_i),
                        jals.dedup_sum_ratings(rows, cols, vals, n_i)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("block", [8, 16, 7])
    def test_pad_rows_to_block_bitwise(self, block):
        rows, cols, vals, n_u, n_i = ratings(3)
        want = jals.pad_rows_to_block(
            jals.pad_ratings(rows, cols, vals, n_u, n_i), block)
        got = tals.pad_rows_to_block(
            tals.pad_ratings(rows, cols, vals, n_u, n_i), block)
        for f in ("cols", "weights", "mask"):
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
        assert (got.n_rows, got.valid_rows) == (want.n_rows, want.valid_rows)

    @pytest.mark.parametrize("kw", [{}, {"max_len": 20},
                                    {"bucket_lengths": (4, 9, 12)}])
    def test_bucket_ratings_pair_bitwise(self, kw):
        rows, cols, vals, n_u, n_i = ratings(4, n=900)
        got = tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i, **kw)
        want = jals.bucket_ratings_pair(rows, cols, vals, n_u, n_i, **kw)
        for g, w in zip(got, want):
            assert (g.n_rows, g.n_cols) == (w.n_rows, w.n_cols)
            assert len(g.buckets) == len(w.buckets) > 1
            for gb, wb in zip(g.buckets, w.buckets):
                for f in ("row_ids", "cols", "weights", "mask"):
                    a, b = getattr(gb, f), getattr(wb, f)
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert a.tobytes() == b.tobytes(), f
            assert g.padded_slots == w.padded_slots
            assert g.nnz == w.nnz and g.occupancy == w.occupancy

    def test_to_device_stages_torch_tensors(self):
        rows, cols, vals, n_u, n_i = ratings(5)
        side = tals.bucket_ratings(rows, cols, vals, n_u, n_i)
        on = side.to_device(CPU)
        b0, h0 = on.buckets[0], side.buckets[0]
        assert isinstance(b0.cols, torch.Tensor)
        assert isinstance(h0.cols, np.ndarray)   # the original stays
        assert b0.cols.dtype == torch.int32 and b0.mask.dtype == torch.float32
        np.testing.assert_array_equal(b0.cols.numpy(), h0.cols)
        assert on.nnz == side.nnz


def assembly_case(seed, B=5, L=24, M=20, R=6, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        Y = rng.integers(-3, 4, (M, R)).astype(np.float32)
        gram = rng.integers(-4, 5, (R, R)).astype(np.float32)
        w = (rng.integers(-4, 11, (B, L)) * 0.5).astype(np.float32)
    else:
        Y = rng.normal(size=(M, R)).astype(np.float32)
        gram = rng.normal(size=(R, R)).astype(np.float32)
        w = rng.normal(size=(B, L)).astype(np.float32)
    cols = rng.integers(0, M, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    for b in range(B):                          # ragged rows, zero-padded
        mask[b, rng.integers(0, L + 1):] = 0.0
    mask[0] = 0.0                               # one empty row
    cols[mask == 0] = 0
    w = w * mask
    return Y, cols, w, mask, gram


class TestAssembly:
    @pytest.mark.parametrize("integer", [True, False])
    @pytest.mark.parametrize("weights", ["implicit", "explicit"])
    def test_against_pallas_interpret(self, integer, weights):
        Y, cols, w, mask, gram = assembly_case(7, integer=integer)
        if weights == "implicit":
            aw, bw = (np.asarray(a) for a in jals.implicit_weights(
                jnp.asarray(w), 1.0))
        else:
            aw, bw = mask, w
        jA, jb = als_pallas.assemble_normal_equations(
            jnp.asarray(Y), jnp.asarray(cols), jnp.asarray(aw),
            jnp.asarray(bw), jnp.asarray(gram), interpret=True)
        tA, tb = als_cuda.assemble_normal_equations(
            t(Y), t(cols), t(aw), t(bw), t(gram))
        assert tA.dtype == torch.float32 and tA.shape == (5, 6, 6)
        if integer:
            np.testing.assert_array_equal(tA.numpy(), np.asarray(jA))
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        else:
            near(tA.numpy(), jA, 1e-5)
            near(tb.numpy(), jb, 1e-5)
        # the empty row is gram alone, its b zero
        np.testing.assert_array_equal(tA[0].numpy(), gram)
        assert not tb[0].any()


def spd_systems(B, R, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, R, R)).astype(np.float32)
    A = G @ G.transpose(0, 2, 1) + R * np.eye(R, dtype=np.float32)
    return A, rng.normal(size=(B, R)).astype(np.float32)


class TestSolve:
    @pytest.mark.parametrize("B,R", [(1, 4), (9, 8), (130, 16), (3, 10)])
    def test_against_pallas_and_lapack(self, B, R):
        A, b = spd_systems(B, R, seed=B)
        x = als_cuda.spd_solve(t(A), t(b)).numpy()
        jx = np.asarray(als_pallas.spd_solve(jnp.asarray(A), jnp.asarray(b),
                                             interpret=True))
        lx = np.stack([scipy.linalg.cho_solve(
            scipy.linalg.cho_factor(A[i].astype(np.float64)), b[i])
            for i in range(B)])
        near(x, jx, 1e-4)
        near(x, lx, 1e-4)

    def test_ill_scaled_systems(self):
        # the JAX package's family: a wide spread of confidence weights
        rng = np.random.default_rng(3)
        B, R = 20, 32
        G = rng.normal(size=(B, R, R)).astype(np.float32)
        scales = 10.0 ** rng.uniform(-2, 2, size=(B, 1, 1))
        A = ((G @ G.transpose(0, 2, 1)) * scales
             + 0.01 * np.eye(R, dtype=np.float32)).astype(np.float32)
        b = rng.normal(size=(B, R)).astype(np.float32)
        x = als_cuda.spd_solve(t(A), t(b)).numpy()
        res = np.einsum("brs,bs->br", A.astype(np.float64), x) - b
        rel = np.linalg.norm(res, axis=1) / np.linalg.norm(b, axis=1)
        assert rel.max() < 1e-2
        jx = np.asarray(als_pallas.spd_solve(jnp.asarray(A), jnp.asarray(b),
                                             interpret=True))
        jres = np.einsum("brs,bs->br", A.astype(np.float64), jx) - b
        assert rel.max() <= 10 * max(
            (np.linalg.norm(jres, axis=1) / np.linalg.norm(b, axis=1)).max(),
            1e-6)

    def test_reads_the_upper_triangle(self):
        A, b = spd_systems(4, 8, seed=11)
        garbage = np.triu(A) + np.tril(np.full_like(A, 123.0), -1)
        np.testing.assert_array_equal(
            als_cuda.spd_solve(t(A), t(b)).numpy(),
            als_cuda.spd_solve(t(garbage), t(b)).numpy())


def factor_case(seed, n_users=40, n_items=60, R=6, n=500):
    rows, cols, vals, n_u, n_i = ratings(seed, n_users, n_items, n)
    rng = np.random.default_rng(seed + 100)
    X = (rng.normal(size=(n_u, R)) / np.sqrt(R)).astype(np.float32)
    Y = (rng.normal(size=(n_i, R)) / np.sqrt(R)).astype(np.float32)
    return rows, cols, vals, n_u, n_i, X, Y


class TestOneSolve:
    @pytest.mark.parametrize("implicit,refine", [(True, False), (False, False),
                                                 (True, True)])
    def test_solve_rows_against_jax(self, implicit, refine):
        rows, cols, vals, n_u, n_i, _, Y = factor_case(8)
        side = jals.pad_ratings(rows, cols, vals, n_u, n_i)
        args = (side.cols, side.weights, side.mask)
        want = jals._solve_rows(jnp.asarray(Y), *map(jnp.asarray, args),
                                0.05, 1.0, implicit, solver="cho",
                                refine=refine)
        got = tals._solve_rows(t(Y), *map(t, args), 0.05, 1.0, implicit,
                               refine=refine)
        near(got.numpy(), want, 1e-4)
        assert not got[-3:].any()               # rows with no ratings

    @pytest.mark.parametrize("implicit", [True, False])
    def test_solve_side_against_solve_side_pallas(self, implicit):
        rows, cols, vals, n_u, n_i, _, Y = factor_case(9, n=300)
        side = jals.pad_ratings(rows, cols, vals, n_u, n_i)
        args = (side.cols, side.weights, side.mask)
        want = als_pallas.solve_side_pallas(
            jnp.asarray(Y), *map(jnp.asarray, args), 0.05, 1.0, implicit,
            interpret=True)
        got = tals._solve_rows(t(Y), *map(t, args), 0.05, 1.0, implicit)
        near(got.numpy(), want, 1e-4)


def loop_kw(implicit):
    return dict(lam=0.05 if implicit else 0.1, alpha=1.0, implicit=implicit,
                num_iterations=3)


class TestTrainingLoops:
    @pytest.mark.parametrize("implicit,block", [(True, None), (False, None),
                                                (True, 8)])
    def test_als_iterations_against_jax(self, implicit, block):
        rows, cols, vals, n_u, n_i, X, Y = factor_case(12)
        u = tals.pad_rows_to_block(tals.pad_ratings(rows, cols, vals, n_u,
                                                    n_i), block or 1)
        i = tals.pad_rows_to_block(tals.pad_ratings(cols, rows, vals, n_i,
                                                    n_u), block or 1)
        X = np.concatenate([X, np.zeros((u.n_rows - n_u, X.shape[1]),
                                        np.float32)])
        Y = np.concatenate([Y, np.zeros((i.n_rows - n_i, Y.shape[1]),
                                        np.float32)])
        tabs = (u.cols, u.weights, u.mask, i.cols, i.weights, i.mask)
        # the JAX loop donates X and Y: hand it copies
        jX, jY = jals._als_iterations(
            jnp.array(X), jnp.array(Y), *map(jnp.asarray, tabs), block=block,
            solver="cho", precision="fp32", **loop_kw(implicit))
        tX, tY = tals.als_iterations(t(X), t(Y), *map(t, tabs), block=block,
                                     **loop_kw(implicit))
        tol = 1e-3 if implicit else 5e-3
        near(tX.numpy(), jX, tol)
        near(tY.numpy(), jY, tol)

    @pytest.mark.parametrize("implicit,budget", [(True, None), (False, None),
                                                 (True, 64)])
    def test_als_iterations_bucketed_against_jax(self, implicit, budget):
        rows, cols, vals, n_u, n_i, X, Y = factor_case(13, n=900)
        us, is_ = tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i)

        def tuples(side, put):
            return tuple((put(b.row_ids), put(b.cols), put(b.weights),
                          put(b.mask)) for b in side.buckets)

        jX, jY = jals._als_iterations_bucketed(
            jnp.array(X), jnp.array(Y), tuples(us, jnp.asarray),
            tuples(is_, jnp.asarray), slot_budget=budget, solver="cho",
            precision="fp32", **loop_kw(implicit))
        tX, tY = tals.als_iterations_bucketed(
            t(X), t(Y), tuples(us, t), tuples(is_, t), slot_budget=budget,
            **loop_kw(implicit))
        tol = 1e-3 if implicit else 5e-3
        near(tX.numpy(), jX, tol)
        near(tY.numpy(), jY, tol)


def jax_init(n_rows, n_cols, rank, seed, device=None):
    """The JAX package's init as torch tensors, so both trainers start
    from the same factors."""
    X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
    return (torch.from_numpy(np.array(X)).to(device),
            torch.from_numpy(np.array(Y)).to(device))


class TestTrainers:
    @pytest.mark.parametrize("block", [None, 16])
    def test_train_als_against_jax(self, monkeypatch, block):
        monkeypatch.setattr(tals, "init_factors", jax_init)
        rows, cols, vals, n_u, n_i = ratings(14)
        params = dict(rank=6, num_iterations=3, lambda_=0.05, seed=4,
                      solve_block_rows=block)
        want = jals.train_als(jals.pad_ratings(rows, cols, vals, n_u, n_i),
                              jals.pad_ratings(cols, rows, vals, n_i, n_u),
                              jals.ALSParams(**params))
        got = tals.train_als(tals.pad_ratings(rows, cols, vals, n_u, n_i),
                             tals.pad_ratings(cols, rows, vals, n_i, n_u),
                             tals.ALSParams(**params), device=CPU)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            near(g, w, 1e-3)

    def test_train_als_bucketed_against_jax(self, monkeypatch):
        monkeypatch.setattr(tals, "init_factors", jax_init)
        rows, cols, vals, n_u, n_i = ratings(15, n=900)
        params = dict(rank=6, num_iterations=3, lambda_=0.05, seed=5)
        want = jals.train_als_bucketed(
            *jals.bucket_ratings_pair(rows, cols, vals, n_u, n_i),
            jals.ALSParams(**params))
        got = tals.train_als_bucketed(
            *tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i),
            tals.ALSParams(**params), device=CPU)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            near(g, w, 1e-3)

    @pytest.mark.parametrize("implicit", [True, False])
    def test_uniform_equals_bucketed(self, implicit):
        """The two layouts hold the same per-row normal equations, so the
        port's two trainers agree from the port's own init (rtol 1e-4 of
        the largest factor: only the einsum blocking over each row's
        padded length differs)."""
        rows, cols, vals, n_u, n_i = ratings(16, n=900)
        params = tals.ALSParams(rank=6, num_iterations=3, lambda_=0.1,
                                seed=6, implicit_prefs=implicit)
        uniform = train_als_auto(
            tals.pad_ratings(rows, cols, vals, n_u, n_i),
            tals.pad_ratings(cols, rows, vals, n_i, n_u), params, CPU)
        bucketed = train_als_auto(
            *tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i), params,
            [CPU])
        for a, b in zip(uniform, bucketed):
            near(a, b, 1e-4)

    def test_seeded_init_is_deterministic(self):
        a = tals.init_factors(7, 5, 4, 3, CPU)
        b = tals.init_factors(7, 5, 4, 3, CPU)
        c = tals.init_factors(7, 5, 4, 4, CPU)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])
        assert a[0].dtype == torch.float32 and a[0].shape == (7, 4)


class TestNotImplemented:
    @pytest.fixture()
    def sides(self):
        rows, cols, vals, n_u, n_i = ratings(17, n=200)
        return tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i)

    def test_unknown_precision_raises(self, sides):
        with pytest.raises(ValueError, match="precision"):
            train_als_auto(*sides, tals.ALSParams(precision="fp64"), CPU)

    def test_extra_ridge_raises(self):
        """Once a refusal, now the config grid's rank padding: a rank-3
        factor table padded to 6 (zero columns, unit ridge on their
        diagonal) solves like JAX's ``_solve_rows(extra_ridge=...)`` to
        1e-4 of the largest entry, implicit and explicit, and the pad
        coordinates come out exactly zero."""
        Y, cols, w, mask, _ = assembly_case(18, integer=False)
        Y[:, 3:] = 0.0
        ridge = (np.arange(6) >= 3).astype(np.float32)
        for implicit in (True, False):
            want = np.asarray(jals._solve_rows(
                jnp.asarray(Y), jnp.asarray(cols), jnp.asarray(np.abs(w)),
                jnp.asarray(mask), 0.1, 1.0, implicit,
                extra_ridge=jnp.asarray(ridge)))
            got = tals._solve_rows(t(Y), t(cols), t(np.abs(w)), t(mask), 0.1,
                                   1.0, implicit,
                                   extra_ridge=t(ridge)).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
            assert not got[:, 3:].any()

    def test_several_devices_train_sharded(self, sides):
        """Once a refusal: two devices now train sharded over them, and
        the factors equal one device's (the largest difference measured
        is 0.0)."""
        params = tals.ALSParams(rank=4, num_iterations=2, seed=1)
        for got, want in zip(train_als_auto(*sides, params, [CPU, CPU]),
                             train_als_auto(*sides, params, CPU)):
            assert got.shape == want.shape
            assert float(np.abs(got - want).max()) == 0.0

    def test_no_gpu_raises(self, sides):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_als_auto(*sides, tals.ALSParams(rank=4))
