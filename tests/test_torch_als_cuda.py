"""The port's fused score -> mask -> top-k against the JAX package's.

``predictionio_tpu_torch.ops.als_cuda.fused_gather_score_topk`` on CPU
tensors runs its plain PyTorch version (the CUDA kernel itself is held
against that plain version on the GPU by ``chip_smoke.py``); here it is
held against ``predictionio_tpu.ops.als_pallas.fused_gather_score_topk``
run in Pallas interpret mode, on the same numpy inputs.

Tolerances: integer-valued factors make every score an exact small
integer in fp32 whatever the summation order, so ids and values must be
EQUAL (ties included: lowest item id first). Continuous factors agree to
rtol 1e-5: the two products sum R=8 terms in different orders, an error
of at most 8 * 2^-24 of sum|q*y|, far inside 1e-5 for top-k scores.
Slots whose score is -inf carry no defined id in either implementation
and are compared only on being -inf.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als_pallas
from predictionio_tpu.ops import quantize as jquant
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.ops import quantize as tquant


def int_factors(rng, shape, lo=-6, hi=7):
    return rng.integers(lo, hi, shape).astype(np.float32)


def run_pair(Q, Y, sc, sm, *, k, n_items, mask_seen=True, row_valid=None,
             store="fp32"):
    """(jax vals, jax idx, port vals, port idx) as numpy, both packages
    given the same numpy inputs in the same store precision."""
    if store == "int8":
        jY = jquant.quantize_rows_int8(Y)
        tY = tquant.quantize_rows_int8(torch.from_numpy(Y))
    elif store == "bf16":
        jY = jnp.asarray(Y).astype(jnp.bfloat16)
        tY = torch.from_numpy(Y).to(torch.bfloat16)
    else:
        jY, tY = jnp.asarray(Y), torch.from_numpy(Y)
    jv, ji = als_pallas.fused_gather_score_topk(
        jnp.asarray(Q), jY, sc, sm, k=k, n_items=n_items,
        mask_seen=mask_seen, row_valid=row_valid, interpret=True)
    tv, ti = als_cuda.fused_gather_score_topk(
        torch.from_numpy(Q), tY,
        None if sc is None else torch.from_numpy(sc),
        None if sm is None else torch.from_numpy(sm), k=k, n_items=n_items,
        mask_seen=mask_seen,
        row_valid=None if row_valid is None else torch.from_numpy(row_valid))
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def assert_exact(jv, ji, tv, ti):
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    np.testing.assert_array_equal(tv[fin], jv[fin])


class TestIntegerExact:
    @pytest.mark.parametrize("store", ["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("mask_seen", [True, False])
    @pytest.mark.parametrize("B,M,R,L,k", [
        (1, 17, 4, 1, 5),        # single query, sub-tile catalog
        (5, 33, 6, 4, 7),        # odd everything
        (3, 300, 8, 6, 16),      # multi-tile with partial pad
    ])
    def test_masked_and_unmasked(self, store, mask_seen, B, M, R, L, k):
        rng = np.random.default_rng(B * M + k)
        Q = int_factors(rng, (B, R))
        Y = int_factors(rng, (M, R))
        if store == "int8":
            Y[:, 0] = 127.0  # scale 1.0 per row: dequantization is exact
        sc = rng.integers(0, M, (L, B)).astype(np.int32)
        sm = (rng.random((L, B)) < 0.7).astype(np.float32)
        assert_exact(*run_pair(Q, Y, sc, sm, k=k, n_items=M - 2,
                               mask_seen=mask_seen, store=store))

    def test_ties_across_the_128_row_tile(self):
        """Rows 120..139 tie at the top score: the lowest ids win, across
        the tile boundary, with two of them masked as seen."""
        rng = np.random.default_rng(3)
        Q = np.ones((2, 4), dtype=np.float32)
        Y = int_factors(rng, (260, 4), -2, 3)
        Y[120:140] = 5.0
        sc = np.asarray([[125, 130], [128, 121]], dtype=np.int32)
        sm = np.ones((2, 2), dtype=np.float32)
        jv, ji, tv, ti = run_pair(Q, Y, sc, sm, k=16, n_items=260)
        assert_exact(jv, ji, tv, ti)
        assert ti[0].tolist()[:4] == [120, 121, 122, 123]
        assert 128 not in ti[0].tolist() and 125 not in ti[0].tolist()

    def test_row_valid(self):
        rng = np.random.default_rng(4)
        Q = int_factors(rng, (4, 6))
        Y = int_factors(rng, (150, 6))
        rv = (rng.random(150) < 0.6).astype(np.float32)
        sc = rng.integers(0, 150, (3, 4)).astype(np.int32)
        sm = np.ones((3, 4), dtype=np.float32)
        jv, ji, tv, ti = run_pair(Q, Y, sc, sm, k=12, n_items=150,
                                  row_valid=rv)
        assert_exact(jv, ji, tv, ti)
        assert (rv[ti[np.isfinite(tv)]] > 0).all()

    def test_all_items_masked(self):
        Q = np.ones((2, 3), dtype=np.float32)
        Y = np.ones((10, 3), dtype=np.float32)
        sc = np.tile(np.arange(10, dtype=np.int32)[:, None], (1, 2))
        sm = np.ones((10, 2), dtype=np.float32)
        jv, _, tv, _ = run_pair(Q, Y, sc, sm, k=4, n_items=10)
        assert (jv == -np.inf).all() and (tv == -np.inf).all()

    def test_k_equals_n_items(self):
        """The whole catalog ranked: every finite slot agrees, padding
        rows past n_items never appear among them."""
        rng = np.random.default_rng(5)
        Q = int_factors(rng, (3, 5))
        Y = int_factors(rng, (60, 5))
        sc = rng.integers(0, 60, (4, 3)).astype(np.int32)
        sm = np.ones((4, 3), dtype=np.float32)
        jv, ji, tv, ti = run_pair(Q, Y, sc, sm, k=57, n_items=57)
        assert_exact(jv, ji, tv, ti)
        assert (ti[np.isfinite(tv)] < 57).all()


class TestContinuous:
    @pytest.mark.parametrize("store", ["fp32", "bf16", "int8"])
    def test_random_factors_rtol(self, store):
        rng = np.random.default_rng(7)
        Q = rng.normal(size=(6, 8)).astype(np.float32)
        Y = (rng.normal(size=(200, 8)) * 2).astype(np.float32)
        sc = rng.integers(0, 200, (5, 6)).astype(np.int32)
        sm = (rng.random((5, 6)) < 0.8).astype(np.float32)
        jv, ji, tv, ti = run_pair(Q, Y, sc, sm, k=20, n_items=197,
                                  store=store)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        # ids agree wherever the neighbouring scores are separated
        gap = np.diff(jv, axis=1)
        sep = np.ones_like(jv, dtype=bool)
        sep[:, 1:] &= np.abs(gap) > 1e-4 * np.abs(jv[:, 1:])
        sep[:, :-1] &= np.abs(gap) > 1e-4 * np.abs(jv[:, :-1])
        np.testing.assert_array_equal(ti[sep], ji[sep])


class TestWrapper:
    def test_cpu_tensors_run_the_plain_version(self):
        rng = np.random.default_rng(8)
        Q = torch.from_numpy(int_factors(rng, (2, 4)))
        Y = torch.from_numpy(int_factors(rng, (40, 4)))
        before = als_cuda.launches.value
        got = als_cuda.fused_gather_score_topk(Q, Y, None, None, k=5,
                                               n_items=40, mask_seen=False)
        want = als_cuda.fused_gather_score_topk_plain(
            Q, Y, None, None, k=5, n_items=40, mask_seen=False)
        assert als_cuda.launches.value == before
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("k", [0, 41])
    def test_k_out_of_range_raises(self, k):
        Q, Y = torch.ones((1, 3)), torch.ones((40, 3))
        with pytest.raises(ValueError, match="k="):
            als_cuda.fused_gather_score_topk(Q, Y, None, None, k=k,
                                             n_items=40, mask_seen=False)
