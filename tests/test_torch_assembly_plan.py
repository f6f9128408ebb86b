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
    """Above the tiles route's rank limit (208 on an H100) the wrapper
    launches ``assemble_kernel``'s tile-group route: A's 8x8 tiles fall
    into bands of at most 20 tiles, and each diagonal band and each pair
    of bands (cut into two halves of its rows above 256 tiles) is a block
    of its own (a part) for each (row, span), with its upper tiles and,
    on the diagonal, its rows' stripes of b. A part sums its live slots (a weight not 0) in slot
    order, each as ``w * y_i`` rounded, then an fp32 FMA with ``y_j``;
    rows longer than a span are cut into spans whose partials
    ``assemble_reduce_kernel`` adds in span order before ``gram``.
    ``check_assembly_args`` guards the tiles route only."""

    @pytest.mark.parametrize("R,route", [(1, "tiles"), (64, "tiles"),
                                         (208, "tiles"), (209, "tile_groups"),
                                         (256, "tile_groups"),
                                         (320, "tile_groups")])
    def test_route(self, R, route):
        assert als_cuda.assembly_route(R, 208) == route

    BAND_MAX = 20        # most tiles of 8 a band (the kernel's BAND_MAX)
    PART_THREADS = 256   # most items of a part (the kernel's PART_THREADS)

    @classmethod
    def parts(cls, R, band_max=BAND_MAX, threads=PART_THREADS):
        """The kernel's parts at rank R, in its order: (r0, r1, c0, c1,
        diagonal), tile rows [r0, r1) x tile columns [c0, c1) of nb bands
        of nt tiles; an off-diagonal pair of bands cut into two halves
        of its rows when its nt * nt tiles exceed ``threads``."""
        rt = -(-R // 8)
        nb = -(-rt // band_max)
        nt = -(-rt // nb)
        sp = 2 if nt * nt > threads else 1
        out = []
        for I in range(nb):
            a0, a1 = I * nt, min(rt, (I + 1) * nt)
            out.append((a0, a1, a0, a1, True))
            hr = -(-(a1 - a0) // sp)
            for J in range(I + 1, nb):
                for h in range(sp):
                    out.append((a0 + h * hr, min(a1, a0 + (h + 1) * hr),
                                J * nt, min(rt, (J + 1) * nt), False))
        return out

    @staticmethod
    def fma(a, b, c):
        """fp32 a * b + c rounded once (through fp64, whose product of
        two fp32 values is exact)."""
        return (a.double() * b.double() + c.double()).float()

    @classmethod
    def tile_order(cls, Y, cols, aw, bw, gram, span=als_cuda.ASSEMBLY_SPAN,
                   band_max=BAND_MAX, threads=PART_THREADS):
        """The tile-group route's order in plain PyTorch: each part of
        each span sums its slots in slot order, skipping slots whose
        weights are both 0; one span writes gram + its sums, several
        their partials, added in span order, then to gram. Every entry
        of A is written by the one part that holds its upper tile
        (mirrored below the diagonal); b by the diagonal parts."""
        B, L = cols.shape
        R = Y.shape[1]
        y_all = Y.float()[cols.long()]                          # [B, L, R]
        live = (aw != 0) | (bw != 0)
        written = torch.zeros((R, R), dtype=torch.int64)
        b_written = torch.zeros(R, dtype=torch.int64)
        S = torch.zeros((B, R, R))
        s = torch.zeros((B, R))
        n_spans = -(-L // span) if L > span else 1
        for k in range(n_spans):
            P = torch.zeros((B, R, R))
            p = torch.zeros((B, R))
            for r0, r1, c0, c1, diag in cls.parts(R, band_max, threads):
                ci = slice(8 * r0, min(R, 8 * r1))
                cj = slice(8 * c0, min(R, 8 * c1))
                acc = torch.zeros((B, ci.stop - ci.start, cj.stop - cj.start))
                accb = torch.zeros((B, ci.stop - ci.start))
                for l in range(k * span, min(L, (k + 1) * span)):
                    y, on = y_all[:, l], live[:, l, None]
                    yi = aw[:, l:l + 1] * y[:, ci]              # rounded
                    acc = torch.where(on[:, :, None], cls.fma(
                        yi[:, :, None], y[:, None, cj], acc), acc)
                    if diag:
                        accb = torch.where(on, cls.fma(
                            bw[:, l:l + 1], y[:, ci], accb), accb)
                for a in range(ci.start, ci.stop):
                    for c in range(max(a, cj.start), cj.stop):
                        v = acc[:, a - ci.start, c - cj.start]
                        P[:, a, c] = P[:, c, a] = v
                        written[a, c] += k == 0
                if diag:
                    p[:, ci] = accb
                    b_written[ci] += k == 0
            S, s = (P, p) if k == 0 else (S + P, s + p)
        assert (torch.triu(written) == torch.triu(torch.ones_like(written))).all()
        assert (b_written == 1).all()
        return gram + S, s

    @pytest.mark.parametrize("R,L,band_max,threads", [
        (33, 20, 20, 256), (70, 9, 20, 256), (70, 9, 2, 256),
        (41, 12, 1, 256), (41, 12, 2, 3), (57, 6, 3, 5)])
    def test_integer_exact(self, R, L, band_max, threads):
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(R, 4, L, R))
        A, b = self.tile_order(Y, cols, aw, bw, gram, band_max=band_max,
                               threads=threads)
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        assert torch.equal(A, Ap) and torch.equal(b, bp)

    def test_integer_exact_split_into_spans(self):
        L = 200
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(6, 3, L, 24))
        A, b = self.tile_order(Y, cols, aw, bw, gram, span=64, band_max=1)
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        assert torch.equal(A, Ap) and torch.equal(b, bp)

    @pytest.mark.parametrize("L,span,band_max,threads", [
        (15, 2048, 20, 256), (150, 64, 2, 256), (40, 2048, 2, 3)])
    def test_continuous_within_reordering_bound(self, L, span, band_max,
                                                threads):
        Y, cols, aw, bw, gram = (t(a) for a in ragged_case(
            5, 3, L, 40, integer=False))
        gram = gram + gram.T                    # symmetric, as in training
        A, b = self.tile_order(Y, cols, aw, bw, gram, span=span,
                               band_max=band_max, threads=threads)
        assert torch.equal(A, A.transpose(1, 2))
        Ap, bp = als_cuda.assemble_normal_equations_plain(Y, cols, aw, bw, gram)
        Aa, ba = als_cuda.assemble_normal_equations_plain(
            Y.abs(), cols, aw.abs(), bw.abs(), gram.abs())
        u = 2.0 * (L + 3) * 2.0 ** -24
        assert ((A - Ap).abs() <= u * Aa).all()
        assert ((b - bp).abs() <= u * ba).all()

    @staticmethod
    def items(part):
        r0, r1, c0, c1, diag = part
        n = r1 - r0
        return n * (n + 1) // 2 + n if diag else n * (c1 - c0)

    def test_parts_at_rank_256_320_and_385(self):
        """R = 256: two bands of 16 tiles, three parts (two diagonal of
        136 tiles and 16 stripes, one of 256 tiles); R = 320: two bands
        of 20, the pair cut in halves of 200 tiles; R = 385 (49 tiles):
        three bands of 17, three diagonal parts and three pairs in
        halves. No part holds more than 256 items."""
        assert self.parts(256) == [(0, 16, 0, 16, True),
                                   (0, 16, 16, 32, False),
                                   (16, 32, 16, 32, True)]
        assert [self.items(p) for p in self.parts(256)] == [152, 256, 152]
        assert [self.items(p) for p in self.parts(320)] == [230, 200, 200,
                                                            230]
        assert len(self.parts(385)) == 9
        for R in range(209, 700):
            assert max(self.items(p) for p in self.parts(R)) <= 256

    def test_against_pallas_interpret_at_rank_209(self):
        """The first rank of the tile-group route, two bands (128 + 81
        columns), against the JAX package's Pallas kernel in interpret
        mode: both fp32 sums of the same L + 1 terms in other orders."""
        L = 7
        Y, cols, aw, bw, gram = ragged_case(209, 2, L, 209, integer=False)
        jA, jb = als_pallas.assemble_normal_equations(
            *(jnp.asarray(a) for a in (Y, cols, aw, bw, gram)),
            interpret=True)
        A, b = self.tile_order(*(t(a) for a in (Y, cols, aw, bw, gram)))
        np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jA).max()))
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jb).max()))

    def test_args_of_the_large_route_pass(self):
        """The wrapper checks the tile-group route's arguments with
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
        (16, als_cuda.CHUNKED_MAX_B, "tiled", 432),  # 26 chunks x 16 + 16
        (128, 256, "tiled", 3448),                  # 26 x 128 + 120
        (32, als_cuda.CHUNKED_MAX_B, "tiled", 864),
        (64, als_cuda.CHUNKED_MAX_B, "tiled", 1728),
        (128, als_cuda.CHUNKED_MAX_B - 1, "chunked", 1784),
        (128, als_cuda.CHUNKED_MAX_B, "tiled", 3448),
    ])
    def test_large_batches_keep_one_block_per_query(self, k, batch, route,
                                                    scratch):
        """Large batches at k <= 128 take the tiled route (blocks of 16
        queries x 1,024 items), whose candidate rows hold each chunk's
        min(k, n_c)."""
        assert als_cuda.topk_sort_plan(k, 26_744, batch, self.CLUSTER_MAX) \
            == als_cuda.TopkSortPlan(route, scratch)

    @pytest.mark.parametrize("k,m,batch,route,scratch", [
        (1, 26_744, 96, "tiled", 27),
        (16, 26_744, 16, "chunked", 224),           # below CHUNKED_MAX_B
        (10, 26_744, 512, "tiled", 270),            # grid_topk's shape
        (16, 26_752, 256, "tiled", 432),            # the serving store, padded
        (100, 26_744, 256, "tiled", 2700),          # last chunk of 120 = k + 20
        (128, 1024 * 26 + 1, 256, "tiled", 3329),   # a last chunk of 1
        (128, 2049, 256, "tiled", 257),             # the narrowest row: 3 chunks
        (16, 2048, 256, "bitonic", 0),              # one chunked-route chunk: no split
        (129, 26_744, 256, "bitonic", 0),           # past the tiled k
        (2049, 26_744, 256, "cluster_row", 0),
        (16, 6_688, 256, "tiled", 112),             # a shard of 4 at ML-20M width
        (16, 26_744, 6_040, "tiled", 432),          # pio eval's batch_predict
    ])
    def test_tiled_route_and_scratch(self, k, m, batch, route, scratch):
        assert als_cuda.topk_sort_plan(k, m, batch, self.CLUSTER_MAX) == \
            als_cuda.TopkSortPlan(route, scratch)

    @pytest.mark.parametrize("k,m,want", [
        (16, 26_744, 26 * 16 + 16), (128, 26_744, 26 * 128 + 120),
        (128, 1024, 128), (5, 1025, 6), (128, 1024 * 3, 3 * 128)])
    def test_tiled_candidates(self, k, m, want):
        assert als_cuda.chunk_candidates(k, m, als_cuda.TILED_CHUNK) == want

    @pytest.mark.parametrize("m,words", [(1, 1), (32, 1), (33, 2),
                                         (26_744, 836), (26_752, 836)])
    def test_seen_bitmap_words(self, m, words):
        assert als_cuda.seen_words(m) == words

    @pytest.mark.parametrize("k", [1, 16, 32, 33, 128])
    def test_each_batch_has_one_route_at_small_k(self, k):
        """At k <= 128 on a wide row the chunked route takes every batch
        below CHUNKED_MAX_B and the tiled route every batch from it."""
        routes = [als_cuda.topk_sort_plan(k, 26_744, b, self.CLUSTER_MAX)
                  .route for b in range(1, 1025)]
        first = routes.index("tiled") + 1
        assert first == als_cuda.CHUNKED_MAX_B
        assert set(routes[:first - 1]) == {"chunked"}
        assert set(routes[first - 1:]) == {"tiled"}

    @pytest.mark.parametrize("k", [0, 129, -1])
    def test_chunked_k_out_of_range_raises(self, k):
        with pytest.raises(ValueError, match="chunked route takes k"):
            als_cuda.chunk_candidates(k, 5000)

    def test_a_row_too_wide_for_the_cluster_takes_one_block(self):
        m = 4097
        plan = als_cuda.topk_sort_plan(m, m, 1, 4096)
        assert plan == als_cuda.TopkSortPlan("radix_row", 2 * m)
        assert als_cuda.topk_sort_plan(m, m, 1, 4097).route == "cluster_row"
