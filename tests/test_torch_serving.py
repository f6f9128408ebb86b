"""The port's serving store (``predictionio_tpu_torch.ops.serving``) on
CPU against the JAX package's ``DeviceTopK``, under both of its program
families (``PIO_SERVE_KERNEL=xla`` and ``fused``, the Pallas kernel in
interpret mode), in every store precision.

Tolerances: integer-valued factors (and +-unit one-hot item rows for the
similarity lane, whose normalization is then exact) make every score an
exact fp32 value whatever the summation order, so ids and scores must be
EQUAL. Continuous factors agree to rtol 1e-5: the products sum R=8 terms
in different orders (at most 8 * 2^-24 of sum|q*y|), and the norms of
the similarity lane add one rounding each.
"""

import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import quantize as jquant
from predictionio_tpu.ops import serving as jserving
from predictionio_tpu_torch.ops import quantize as tquant
from predictionio_tpu_torch.ops import serving as tserving

KERNELS = ["xla", "fused"]
PRECISIONS = ["fp32", "bf16", "int8"]


def int_factors(rng, shape, lo=-6, hi=7):
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.fixture()
def factor_pair():
    rng = np.random.default_rng(21)
    X = int_factors(rng, (20, 6))
    Y = int_factors(rng, (150, 6))
    # column 0 at 127 pins every int8 row scale to 1.0 (exact dequant)
    X[:, 0] = 127.0
    Y[:, 0] = rng.choice([-127.0, 127.0], 150)
    seen = {u: rng.choice(150, size=rng.integers(1, 9), replace=False)
            for u in range(0, 20, 2)}
    return X, Y, seen


def servers(monkeypatch, kernel, precision, X, Y, seen=None, **kw):
    """(JAX DeviceTopK, port DeviceTopK on CPU) over the same factors."""
    monkeypatch.setenv("PIO_SERVE_KERNEL", kernel)
    monkeypatch.setenv("PIO_SERVE_PRECISION", precision)
    jsrv = jserving.DeviceTopK(X, Y, seen, microbatch=False)
    tsrv = tserving.DeviceTopK(X, Y, seen, device="cpu", **kw)
    assert tsrv.precision == precision
    return jsrv, tsrv


def unit_item_rows(m, r):
    Y = np.zeros((m, r), dtype=np.float32)
    for i in range(m):  # +-unit one-hots: unit rows, exact norms
        Y[i, i % r] = 1.0 if i % 3 else -1.0
    return Y


class TestDeviceTopKAgainstJax:
    @pytest.mark.parametrize("precision", PRECISIONS)
    @pytest.mark.parametrize("kernel", KERNELS)
    def test_user_topk(self, monkeypatch, factor_pair, kernel, precision):
        X, Y, seen = factor_pair
        jsrv, tsrv = servers(monkeypatch, kernel, precision, X, Y, seen,
                             microbatch=False)
        for uid, k in ((0, 5), (1, 10), (7, 3), (19, 40)):
            ji, js = jsrv.user_topk(uid, k)
            ti, ts = tsrv.user_topk(uid, k)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ts, js)

    @pytest.mark.parametrize("kernel", KERNELS)
    def test_user_topk_without_seen_lists(self, monkeypatch, factor_pair,
                                          kernel):
        X, Y, _ = factor_pair
        jsrv, tsrv = servers(monkeypatch, kernel, "fp32", X, Y,
                             microbatch=False)
        for got, want in zip(tsrv.users_topk([3, 0, 19], 7),
                             jsrv.users_topk(np.asarray([3, 0, 19]), 7)):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("precision", PRECISIONS)
    @pytest.mark.parametrize("kernel", KERNELS)
    def test_users_topk(self, monkeypatch, factor_pair, kernel, precision):
        X, Y, seen = factor_pair
        jsrv, tsrv = servers(monkeypatch, kernel, precision, X, Y, seen,
                             microbatch=False)
        uids = np.asarray([0, 3, 7, 12, 19])
        ji, js = jsrv.users_topk(uids, 20)
        ti, ts = tsrv.users_topk(uids, 20)
        assert ti.shape == ji.shape == (5, 20)
        fin = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(ts), fin)
        np.testing.assert_array_equal(ti[fin], ji[fin])
        np.testing.assert_array_equal(ts[fin], js[fin])

    @pytest.mark.parametrize("precision", PRECISIONS)
    @pytest.mark.parametrize("kernel", KERNELS)
    def test_items_topk(self, monkeypatch, kernel, precision):
        rng = np.random.default_rng(5)
        X = int_factors(rng, (6, 4))
        Y = unit_item_rows(140, 4)
        jsrv, tsrv = servers(monkeypatch, kernel, precision, X, Y,
                             microbatch=False)
        for idxs, k in (([2, 5], 6), ([7], 10), ([1, 130, 3], 20)):
            ji, js = jsrv.items_topk(idxs, k)
            ti, ts = tsrv.items_topk(idxs, k)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(ts, js)

    def test_items_topk_continuous(self, monkeypatch):
        rng = np.random.default_rng(6)
        X = rng.normal(size=(10, 8)).astype(np.float32)
        Y = rng.normal(size=(90, 8)).astype(np.float32)
        jsrv, tsrv = servers(monkeypatch, "xla", "fp32", X, Y,
                             microbatch=False)
        for idxs in ([4], [1, 2, 3]):
            ji, js = jsrv.items_topk(idxs, 12)
            ti, ts = tsrv.items_topk(idxs, 12)
            np.testing.assert_allclose(ts, js, rtol=1e-5)
            sep = np.ones(len(js), dtype=bool)
            gap = np.abs(np.diff(js)) > 1e-4
            sep[1:] &= gap
            sep[:-1] &= gap
            np.testing.assert_array_equal(ti[sep], ji[sep])

    def test_concurrent_submits_share_dispatches(self, monkeypatch,
                                                 factor_pair):
        """Concurrent user and item queries through the port's
        BatchDispatcher: each answer equals the JAX store's direct one,
        and the user lane answers several queries per dispatch."""
        X, Y, seen = factor_pair
        monkeypatch.setenv("PIO_BATCH_WINDOW", "0.05")
        jsrv, tsrv = servers(monkeypatch, "xla", "fp32", X, Y, seen)
        jobs = [("u", uid, 4 + uid % 5) for uid in range(16)]
        jobs += [("i", (i, i + 1), 6) for i in range(0, 12, 2)]
        got = {}
        barrier = threading.Barrier(len(jobs))

        def run(job):
            kind, payload, k = job
            barrier.wait(timeout=30)
            got[job] = (tsrv.user_topk(payload, k) if kind == "u"
                        else tsrv.items_topk(list(payload), k))

        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        try:
            for job in jobs:
                kind, payload, k = job
                want = (jsrv.user_topk(payload, k) if kind == "u"
                        else jsrv.items_topk(list(payload), k))
                np.testing.assert_array_equal(got[job][0], want[0])
                np.testing.assert_allclose(got[job][1], want[1], rtol=1e-5)
            users = tsrv.stats()["users"]
            assert users["batchedQueries"] == 16
            assert users["dispatches"] < 16
        finally:
            tsrv.close()

    def test_batch_splits_by_k_bucket(self, monkeypatch, factor_pair):
        """A wide query (k near n_items, as a category query asks) batched
        with narrow ones: the narrow rows dispatch at their own k bucket,
        and every answer equals the JAX store's direct one."""
        X, Y, seen = factor_pair
        monkeypatch.setenv("PIO_BATCH_WINDOW", "0.2")
        jsrv, tsrv = servers(monkeypatch, "xla", "fp32", X, Y, seen)
        dispatched_k = []
        users_topk = tsrv.users_topk

        def recording(uids, k):
            dispatched_k.append((len(uids), k))
            return users_topk(uids, k)

        tsrv.users_topk = recording
        jobs = [(uid, 140 if uid == 3 else 5) for uid in range(8)]
        got = {}
        barrier = threading.Barrier(len(jobs))

        def run(job):
            barrier.wait(timeout=30)
            got[job] = tsrv.user_topk(*job)

        threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        try:
            for job in jobs:
                for g, w in zip(got[job], jsrv.user_topk(*job)):
                    np.testing.assert_array_equal(g, w)
            # every row dispatched once; only the wide row at the wide k
            assert sum(n for n, _ in dispatched_k) == len(jobs)
            assert [n for n, k in dispatched_k if k == 140] == [1]
            assert {k for _, k in dispatched_k} == {5, 140}
        finally:
            tsrv.close()


class TestQuantizer:
    def test_int8_bitwise_with_the_jax_numpy_twin(self):
        rng = np.random.default_rng(9)
        F = (rng.normal(size=(64, 12)) * rng.lognormal(size=(64, 1))
             ).astype(np.float32)
        F[3] = 0.0                               # all-zero row: scale 1
        F[4, 2] = 127.5 * F[4].max() / 127.0     # a .5 boundary nearby
        want = jquant.quantize_rows_int8_np(F)
        for got in (tquant.quantize_rows_int8(torch.from_numpy(F)),
                    tquant.quantize_rows_int8_np(F)):
            data, scale = (np.asarray(a) for a in got)
            np.testing.assert_array_equal(data, want.data)
            np.testing.assert_array_equal(scale.view(np.int32),
                                          want.scale.view(np.int32))
        assert np.asarray(got.scale)[3] == 1.0
        np.testing.assert_array_equal(
            tquant.dequantize_rows(tquant.quantize_rows_int8(
                torch.from_numpy(F))).numpy(),
            jquant.dequantize_rows_np(want))

    def test_bf16_input_matches_jax(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(10)
        F = rng.normal(size=(16, 8)).astype(np.float32)
        want = jquant.quantize_rows_int8(jnp.asarray(F).astype(jnp.bfloat16))
        got = tquant.quantize_rows_int8(torch.from_numpy(F).to(torch.bfloat16))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


class TestHostSideHelpers:
    def test_seen_tables_and_buckets(self, factor_pair):
        _, _, seen = factor_pair
        for got, want in zip(tserving.seen_tables(seen, 20),
                             jserving.seen_tables(seen, 20)):
            np.testing.assert_array_equal(got, want)
        for n in (0, 1, 15, 16, 17, 300):
            assert tserving.bucket_size(n) == jserving.bucket_size(n)
            assert tserving.bucket_size(n, lo=8) == \
                jserving.bucket_size(n, lo=8)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_normalize_rows(self, precision):
        import jax.numpy as jnp

        rng = np.random.default_rng(11)
        Y = rng.normal(size=(40, 8)).astype(np.float32)
        Y[5] = 0.0
        if precision == "int8":
            jY = jquant.quantize_rows_int8(Y)
            tY = tquant.quantize_rows_int8(torch.from_numpy(Y))
            want = jquant.dequantize_rows_np(jserving._normalize_rows(jY))
            got = tquant.dequantize_rows(tserving._normalize_rows(tY))
            atol = 1.0 / 127  # one int8 step of a unit row, at most
        else:
            dt = jnp.bfloat16 if precision == "bf16" else jnp.float32
            want = np.asarray(jserving._normalize_rows(
                jnp.asarray(Y).astype(dt)).astype(jnp.float32))
            tdt = torch.bfloat16 if precision == "bf16" else torch.float32
            got = tserving._normalize_rows(
                torch.from_numpy(Y).to(tdt)).float()
            atol = 1e-6 if precision == "fp32" else 2 ** -8
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


class TestServingPolicy:
    @pytest.mark.parametrize("n_items", [150, 70_000])
    def test_device_store_at_every_size(self, monkeypatch, n_items):
        """No size rule and no host lane: models on either side of the
        JAX package's host threshold (1 << 22 item-factor elements) serve
        from the device store on the device asked for under the auto
        backend (an explicit ``host`` raises:
        tests/test_torch_server_surface.py)."""
        rng = np.random.default_rng(4)
        X = rng.normal(size=(4, 64)).astype(np.float32)
        Y = rng.normal(size=(n_items, 64)).astype(np.float32)
        monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
        monkeypatch.setenv("PIO_SERVING_BACKEND", "auto")
        srv = tserving.choose_server(X, Y, device="cpu")
        assert isinstance(srv, tserving.DeviceTopK)
        assert srv.precision == "fp32"  # the CPU default, as in JAX
        assert srv.n_items == n_items
        srv.close()

    def test_explicit_precision_sets_the_store(self, monkeypatch,
                                               factor_pair):
        X, Y, seen = factor_pair
        monkeypatch.setenv("PIO_SERVE_PRECISION", "int8")
        srv = tserving.choose_server(X, Y, seen, device="cpu")
        assert isinstance(srv, tserving.DeviceTopK)
        assert srv.precision == "int8"
        srv.close()

    def test_tensor_factors_serve_from_the_store(self, monkeypatch,
                                                 factor_pair):
        X, Y, seen = factor_pair
        monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
        srv = tserving.choose_server(torch.from_numpy(X), torch.from_numpy(Y),
                                     seen, device="cpu")
        ref = tserving.choose_server(X, Y, seen, device="cpu")
        for got, want in zip(srv.users_topk([0, 5], 6),
                             ref.users_topk([0, 5], 6)):
            np.testing.assert_array_equal(got, want)
        srv.close()
        ref.close()

    def test_unknown_precision_raises(self, monkeypatch, factor_pair):
        X, Y, _ = factor_pair
        monkeypatch.setenv("PIO_SERVE_PRECISION", "fp8")
        with pytest.raises(ValueError, match="PIO_SERVE_PRECISION"):
            tserving.DeviceTopK(X, Y, device="cpu")

    def test_no_cpu_fallback(self, monkeypatch, factor_pair):
        """``device=None`` means CUDA: without a GPU the store raises
        instead of quietly serving from the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a GPU is present; the fallback cannot be probed")
        X, Y, _ = factor_pair
        monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserving.DeviceTopK(X, Y)
