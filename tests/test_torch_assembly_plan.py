"""The host-side plans of the port's redesigned kernels.

``assemble_kernel`` splits a long row into spans of ``ASSEMBLY_SPAN``
slots, one block each, and a second pass adds ``gram`` and the spans'
partial sums in span order; the serving kernel's selection takes a
sort route and a device-memory scratch from ``k`` and the row width.
Both choices are made on the host, once, by plain functions of
``ops/als_cuda.py``, and the kernels carry them out. Here the split is emulated in plain PyTorch (the
plain version per span, partials added in the plan's order) and held
against the unsplit plain version and against the JAX package's Pallas
kernel in interpret mode.

Tolerances: integer factors and half-integer weights keep every partial
sum an exact integer below 2^24, so any order of summation gives the
same fp32 bits. Otherwise two orders of the same L + 1 terms differ by
at most 2 * (L + 3) * 2^-24 of the sum of their magnitudes (each sum is
within (L + 1) * 2^-24 of exact, plus the products' own roundings).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als_pallas
from predictionio_tpu_torch.ops import als_cuda


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tasks(plan, rows, L):
    """(row, first slot, end slot) of each block of a split launch, in
    the kernel's order: block x sums span x % n_spans of row x // n_spans."""
    for x in range(rows * plan.n_spans):
        row, sp = divmod(x, plan.n_spans)
        yield row, sp * plan.span, min(L, (sp + 1) * plan.span)


def split_assembly(Y, cols, aw, bw, gram, span):
    """The kernel's split-then-reduce order in plain PyTorch."""
    B, L = cols.shape
    plan = als_cuda.assembly_plan(L, span)
    zero = torch.zeros_like(gram)
    S = s = None
    for k in range(plan.n_spans):
        cut = slice(k * span, min(L, (k + 1) * span))
        P, p = als_cuda.assemble_normal_equations_plain(
            Y, cols[:, cut], aw[:, cut], bw[:, cut], zero)
        S, s = (P, p) if S is None else (S + P, s + p)
    return gram + S, s


def ragged_case(seed, B, L, R, M=50, integer=True):
    """Rows of real lengths from 0 to L (padding last, weight 0)."""
    rng = np.random.default_rng(seed)
    if integer:
        Y = rng.integers(-3, 4, (M, R)).astype(np.float32)
        gram = rng.integers(-4, 5, (R, R)).astype(np.float32)
        w = (rng.integers(1, 11, (B, L)) * 0.5).astype(np.float32)
    else:
        Y = rng.normal(size=(M, R)).astype(np.float32)
        gram = rng.normal(size=(R, R)).astype(np.float32)
        w = rng.exponential(size=(B, L)).astype(np.float32)
    lens = rng.integers(0, L + 1, B)
    lens[-1] = L                                # one full row
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    cols = np.where(mask > 0, rng.integers(0, M, (B, L)), 0).astype(np.int32)
    return Y, cols, ((1.0 + w) * mask).astype(np.float32), w * mask, gram


class TestAssemblyPlan:
    @pytest.mark.parametrize("span", [64, 128, als_cuda.ASSEMBLY_SPAN])
    @pytest.mark.parametrize("L", [0, 1, 63, 64, 65, 127, 128, 129, 2047,
                                   2048, 2049, 4096, 52_776])
    def test_every_slot_once(self, L, span):
        B = 3
        plan = als_cuda.assembly_plan(L, span)
        assert plan.n_spans == (1 if L <= span else -(-L // span))
        hits = np.zeros((B, L), dtype=np.int64)
        blocks = list(tasks(plan, B, L))
        for row, lo, hi in blocks:
            assert 0 <= lo <= hi <= L and hi - lo <= span
            hits[row, lo:hi] += 1
        assert (hits == 1).all()
        # no span past the row's end: the last one holds its last slot
        assert all(lo < L for row, lo, hi in blocks if L)

    @pytest.mark.parametrize("L,span,R,want", [
        (2048, 2048, 64, 0),                     # one span: no scratch
        (8192, 2048, 64, 344 * 4 * (64 * 64 + 64)),
        (52_776, 2048, 64, 344 * 26 * (64 * 64 + 64)),
    ])
    def test_scratch(self, L, span, R, want):
        assert als_cuda.assembly_plan(L, span).scratch_floats(344, R) == want

    @pytest.mark.parametrize("L,grouped", [(0, True), (16, True), (512, True),
                                           (513, False), (2048, False),
                                           (4096, False)])
    def test_short_rows_are_grouped(self, L, grouped):
        """Rows of at most ASSEMBLY_GROUPED_MAX slots share a block, one
        per group of its threads; split rows never do."""
        plan = als_cuda.assembly_plan(L)
        assert plan.grouped is grouped
        assert not (plan.grouped and plan.n_spans > 1)

    @pytest.mark.parametrize("span", [0, -64, 100, 4096])
    def test_bad_span_raises(self, span):
        with pytest.raises(ValueError, match="span"):
            als_cuda.assembly_plan(10, span)


class TestSplitEmulation:
    @pytest.mark.parametrize("L,span", [(50, 64), (64, 64), (200, 64),
                                        (301, 128), (1000, 64)])
    def test_integer_exact(self, L, span):
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(L, 6, L, 8))
        A, b = split_assembly(Y, cols, aw, bw, gram, span)
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        assert torch.equal(A, Ap) and torch.equal(b, bp)

    @pytest.mark.parametrize("L,span", [(200, 64), (1000, 128)])
    def test_continuous_within_reordering_bound(self, L, span):
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(
            L + 1, 5, L, 16, integer=False))
        A, b = split_assembly(Y, cols, aw, bw, gram, span)
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        Aa, ba = als_cuda.assemble_normal_equations_plain(
            Y.abs(), cols, aw.abs(), bw.abs(), gram.abs())
        u = 2.0 * (L + 3) * 2.0 ** -24
        assert ((A - Ap).abs() <= u * Aa).all()
        assert ((b - bp).abs() <= u * ba).all()

    def test_against_pallas_interpret_longer_than_the_span(self):
        L, span = 300, 64
        Y, cols, aw, bw, gram = ragged_case(9, 4, L, 12, integer=False)
        jA, jb = als_pallas.assemble_normal_equations(
            *(jnp.asarray(a) for a in (Y, cols, aw, bw, gram)),
            interpret=True)
        A, b = split_assembly(*(t(a) for a in (Y, cols, aw, bw, gram)), span)
        np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jA).max()))
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jb).max()))


class TestAssemblyArgs:
    def args(self, R=8, B=3, L=5, M=20):
        return (torch.zeros((M, R)), torch.zeros((B, L), dtype=torch.int32),
                torch.zeros((B, L)), torch.zeros((B, L)), torch.zeros((R, R)))

    def test_good_args(self):
        assert als_cuda.check_assembly_args(*self.args(), max_rank=8) == \
            (20, 8, 3, 5)

    def test_rank_above_the_limit_raises(self):
        with pytest.raises(ValueError, match="rank <= 7"):
            als_cuda.check_assembly_args(*self.args(), max_rank=7)

    @pytest.mark.parametrize("which,bad,err", [
        (0, torch.zeros(20), ValueError),                     # Y not 2-D
        (1, torch.zeros((3, 5)), TypeError),                  # cols float
        (2, torch.zeros((3, 4)), ValueError),                 # aw shape
        (3, torch.zeros((3, 5), dtype=torch.float64), TypeError),
        (4, torch.zeros((8, 7)), ValueError),                 # gram shape
        (4, torch.zeros((8, 16))[:, ::2], ValueError),        # not contiguous
    ])
    def test_bad_args_raise(self, which, bad, err):
        args = list(self.args())
        args[which] = bad
        with pytest.raises(err):
            als_cuda.check_assembly_args(*args, max_rank=64)


class TestLargeRankRoute:
    """Above ``assemble_kernel``'s rank limit (208 on an H100) the wrapper
    launches ``assemble_large_rank_kernel``: one block per (row, 32x32
    tile of A's upper triangle), slots summed in order as ``w * y_i``
    then an fp32 FMA with ``y_j``, the tile mirrored into the lower
    triangle. ``check_assembly_args`` guards the main route only."""

    @pytest.mark.parametrize("R,route", [(1, "tiles"), (64, "tiles"),
                                         (208, "tiles"), (209, "large_rank"),
                                         (256, "large_rank"),
                                         (320, "large_rank")])
    def test_route(self, R, route):
        assert als_cuda.assembly_route(R, 208) == route

    @staticmethod
    def tile_order(Y, cols, aw, bw, gram, tile=32):
        """The kernel's order in plain PyTorch (the FMA's single rounding
        through fp64, whose product of two fp32 values is exact)."""
        B, L = cols.shape
        R = Y.shape[1]
        A = torch.empty((B, R, R))
        b = torch.zeros((B, R))
        y_all = Y[cols.long()]                                  # [B, L, R]
        for l in range(L):
            b = torch.where(bw[:, l:l + 1] != 0, (
                bw[:, l:l + 1].double() * y_all[:, l].double()
                + b.double()).float(), b)
        for i0 in range(0, R, tile):
            for j0 in range(i0, R, tile):
                i1, j1 = min(i0 + tile, R), min(j0 + tile, R)
                acc = torch.zeros((B, i1 - i0, j1 - j0))
                for l in range(L):
                    y = y_all[:, l]
                    yi = aw[:, l:l + 1] * y[:, i0:i1]           # rounded
                    acc = (yi[:, :, None].double()
                           * y[:, None, j0:j1].double() + acc.double()).float()
                for i in range(i0, i1):
                    for j in range(max(i, j0), j1):
                        A[:, i, j] = gram[i, j] + acc[:, i - i0, j - j0]
                        A[:, j, i] = gram[j, i] + acc[:, i - i0, j - j0]
        return A, b

    @pytest.mark.parametrize("R,L", [(33, 20), (70, 9)])
    def test_integer_exact(self, R, L):
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(R, 4, L, R))
        A, b = self.tile_order(Y, cols, aw, bw, gram)
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        assert torch.equal(A, Ap) and torch.equal(b, bp)

    def test_continuous_within_reordering_bound(self):
        L = 15
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(
            5, 3, L, 40, integer=False))
        gram = gram + gram.T                    # symmetric, as in training
        A, b = self.tile_order(Y, cols, aw, bw, gram)
        assert torch.equal(A, A.transpose(1, 2))
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        Aa, ba = als_cuda.assemble_normal_equations_plain(
            Y.abs(), cols, aw.abs(), bw.abs(), gram.abs())
        u = 2.0 * (L + 3) * 2.0 ** -24
        assert ((A - Ap).abs() <= u * Aa).all()
        assert ((b - bp).abs() <= u * ba).all()

    def test_args_of_the_large_route_pass(self):
        """The wrapper checks the large route's arguments with
        ``max_rank=R``: every shape check still applies."""
        args = TestAssemblyArgs().args(R=300)
        assert als_cuda.check_assembly_args(*args, max_rank=300) == \
            (20, 300, 3, 5)


class TestTopkSortPlan:
    CLUSTER_MAX = 108_720   # the widest row the cluster sort takes on an H100

    @pytest.mark.parametrize("k,m,route,scratch", [
        (1, 10, "bitonic", 0),
        (16, 26_744, "chunked", 224),               # 13 chunks x 16 + 16
        (128, 26_744, "chunked", 1784),             # 13 x 128 + 120
        (129, 26_744, "bitonic", 0),                # past the chunked k
        (128, 2048, "bitonic", 0),                  # one chunk: no split
        (16, 2048, "bitonic", 0),
        (128, 2049, "chunked", 129),                # a last chunk of 1
        (16, 2049, "chunked", 17),
        (100, 2048 * 13 + 100, "chunked", 1400),    # last chunk of 100 = k
        (128, 2048 * 13 + 100, "chunked", 1764),    # last chunk shorter than k
        (16, 200_000, "chunked", 1568),             # 98 chunks
        (128, 108_721, "chunked", 6912),            # too wide for the cluster
        (1025, 26_744, "bitonic", 0),               # sort width 2,048
        (2048, 26_744, "bitonic", 0),               # the widest bitonic sort
        (2048, 200_000, "bitonic", 0),              # whatever the row width
        (2049, 26_744, "cluster_row", 0),           # the whole row from here
        (2049, 2049, "cluster_row", 0),
        (6000, 26_744, "cluster_row", 0),
        (20_000, 26_744, "cluster_row", 0),
        (26_744, 26_744, "cluster_row", 0),         # category queries
        (26_744, 26_752, "cluster_row", 0),         # a padded store
        (30_000, 60_000, "cluster_row", 0),
        (108_720, 108_720, "cluster_row", 0),       # 8 shares of 13,590
        (3000, 108_721, "radix_row", 217_442),      # too wide, any k
        (108_721, 108_721, "radix_row", 217_442),
    ])
    def test_route_and_scratch(self, k, m, route, scratch):
        assert als_cuda.topk_sort_plan(k, m, 1, self.CLUSTER_MAX) == \
            als_cuda.TopkSortPlan(route, scratch)

    def test_every_k_has_one_route(self):
        m = 3000
        routes = [als_cuda.topk_sort_plan(k, m, 1, 4096).route
                  for k in range(1, m + 1)]
        first = {r: routes.index(r) + 1 for r in set(routes)}
        assert first == {"chunked": 1,
                         "bitonic": als_cuda.CHUNK_K_MAX + 1,
                         "cluster_row": als_cuda.BITONIC_MAX + 1}
        # each route holds a contiguous range of k
        assert routes == sorted(routes, key=["chunked", "bitonic",
                                             "cluster_row"].index)

    @pytest.mark.parametrize("k,batch,route,scratch", [
        (16, 8, "chunked", 224),                    # the main path's batches
        (128, 8, "chunked", 1784),
        (16, als_cuda.CHUNKED_MAX_B - 1, "chunked", 224),
        (16, als_cuda.CHUNKED_MAX_B, "bitonic", 0),  # one block a query fills the card
        (128, 256, "bitonic", 0),
    ])
    def test_large_batches_keep_one_block_per_query(self, k, batch, route,
                                                    scratch):
        assert als_cuda.topk_sort_plan(k, 26_744, batch, self.CLUSTER_MAX) \
            == als_cuda.TopkSortPlan(route, scratch)

    @pytest.mark.parametrize("k", [0, 129, -1])
    def test_chunked_k_out_of_range_raises(self, k):
        with pytest.raises(ValueError, match="chunked route takes k"):
            als_cuda.chunk_candidates(k, 5000)

    def test_a_row_too_wide_for_the_cluster_takes_one_block(self):
        m = 4097
        plan = als_cuda.topk_sort_plan(m, m, 1, 4096)
        assert plan == als_cuda.TopkSortPlan("radix_row", 2 * m)
        assert als_cuda.topk_sort_plan(m, m, 1, 4097).route == "cluster_row"
