"""The serving kernel's tiled route, emulated on the CPU.

For ``k <= CHUNK_K_MAX`` over a row wider than ``TOPK_CHUNK`` items in a
batch of ``CHUNKED_MAX_B`` queries or more, ``csrc/fused_topk.cu`` scores
and selects in one block per (``TILED_QUERIES`` queries x
``TILED_CHUNK`` items) (``score_select_tile_kernel``): each score's key
is masked there by the padding rows, ``row_valid`` and a seen bitmap of
``seen_words(M)`` words per query (``seen_bits_kernel``); each thread
keeps the top 16 bits of the largest key of each 4 of its items; a warp
per query takes a 16-bit ``t`` with at least ``kc = min(k, n_c)`` of
those maxima >= ``t`` (for ``kc <= 32`` the kc-th largest of its lanes'
largest maxima, else the largest such ``t``), compacts the chunk's keys
>= ``t << 16`` in
item order, and selects the ``kc`` winners among them by counting ranks
(up to 64), by a radix select (up to 256) or, past that, by a radix
select over the whole chunk; the winners go, in item order, to the
chunk's slots of a candidate row, which the chunked route's merge
(``select_bitonic_kernel``) reduces to the k winners.

Here that dataflow runs in numpy on the kernel's order-preserving 32-bit
keys (``float_key`` / ``key_float``, -0.0 keyed as +0.0) and is held
EQUAL, value bits and ids on every finite slot, to
``fused_gather_score_topk_plain`` and, on integer data, to the JAX
package's Pallas kernel in interpret mode. Slots whose score is -inf
carry no defined id in the contract and are compared only on being
-inf. The kernel itself is held against the plain version and the
chunked and bitonic routes on the card by ``chip_smoke.py`` (phases 2
and 4c).
"""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als_pallas
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.ops.quantize import quantize_rows_int8

CHUNK = als_cuda.TILED_CHUNK
TILE_Q = als_cuda.TILED_QUERIES
# a chunk is scored in two halves; item h * HALF + ig + IG * jj (jj < 4)
# is one of the four whose largest key is maximum ig * 2 + h (the
# kernel's TILE_IG * 4 == TILE_HALF)
HALF = CHUNK // 2
IG = HALF // 4
GROUPS = 2 * IG            # maxima a query
RANK_MAX, CAND = 64, 256   # the rank-count select's and the buffer's limits
NEG_INF_KEY = 0x007FFFFF   # float_key(-inf)


def float_key(scores: np.ndarray) -> np.ndarray:
    """The kernel's key as int64: a > b as floats <=> key(a) > key(b);
    -0.0 gets the key of +0.0."""
    u = np.ascontiguousarray(scores, np.float32).view(np.uint32).astype(np.int64)
    u = np.where(scores == 0, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def key_float(key: np.ndarray) -> np.ndarray:
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def seen_bitmap(cols: np.ndarray, mask: np.ndarray, B: int, M: int):
    """``seen_bits_kernel``: bit m % 32 of word [b, m / 32] for each slot
    (l, b) with mask > 0 and 0 <= m < M."""
    bits = np.zeros((B, als_cuda.seen_words(M)), np.uint32)
    for l, b in zip(*np.nonzero(mask > 0)):
        m = int(cols[l, b])
        if 0 <= m < M:
            bits[b, m // 32] |= np.uint32(1 << (m % 32))
    return bits


def tile_keys(raw: np.ndarray, bits, n_items: int, row_valid) -> np.ndarray:
    """The keys a block writes: float_key of the score, or -inf's key for
    padding rows, row_valid <= 0 and seen bits."""
    B, M = raw.shape
    m = np.arange(M)
    ok = np.broadcast_to(m < n_items, (B, M)).copy()
    if row_valid is not None:
        ok &= row_valid[None, :] > 0
    if bits is not None:
        ok &= ((bits[:, m // 32] >> (m % 32).astype(np.uint32)) & 1) == 0
    return np.where(ok, float_key(raw), NEG_INF_KEY)


def maxima(keys: np.ndarray) -> np.ndarray:
    """[B, GROUPS] top 16 bits of each thread's 4-item maxima; items past
    the chunk count as 0. Item h * HALF + ig + IG * jj goes to group ig *
    2 + h."""
    B, n = keys.shape
    full = np.zeros((B, CHUNK), np.int64)
    full[:, :n] = keys
    g = full.reshape(B, 2, 4, IG).max(axis=2)           # [B, h, ig]
    return g.transpose(0, 2, 1).reshape(B, GROUPS) >> 16


def threshold(g: np.ndarray, kc: int) -> int:
    """The select's threshold (``t << 16``) from a query's GROUPS maxima,
    lane l of the warp holding maxima l + 32 e. For kc <= 32: the kc-th
    largest of the lanes' largest maxima (each lane counts the lanes
    above it; the least of those with fewer than kc above); else the
    largest t with at least kc maxima >= t, bit by bit."""
    if kc <= 32:
        lmax = g.reshape(GROUPS // 32, 32).max(axis=0)
        above = (lmax[None, :] > lmax[:, None]).sum(axis=1)
        return int(lmax[above < kc].min()) << 16
    t = 0
    for bit in range(15, -1, -1):
        if (g >= (t | 1 << bit)).sum() >= kc:
            t |= 1 << bit
    return t << 16


def radix_select(keys: np.ndarray, rank: int):
    """``warp_radix_select`` with four digits: (T, need, eq)."""
    prefix, pmask, remaining, eq = 0, 0, rank, 0
    for shift in (24, 16, 8, 0):
        cand = keys[(keys & pmask) == prefix]
        hist = np.bincount((cand >> shift) & 255, minlength=256)
        cum = 0
        for d in range(255, -1, -1):
            if cum + hist[d] >= remaining:
                break
            cum += hist[d]
        prefix |= d << shift
        pmask |= 255 << shift
        remaining, eq = remaining - cum, int(hist[d])
        if eq == remaining:
            break
    return prefix, remaining, eq


def chunk_winners(keys: np.ndarray, g: np.ndarray, kc: int, paths):
    """One warp's select over a chunk's keys: the winners' positions in
    item order, and the path it took."""
    tau = threshold(g, kc)
    pos = np.flatnonzero(keys >= tau)
    assert len(pos) >= kc
    if len(pos) <= RANK_MAX:
        paths["rank"] += 1
        order = np.argsort(-keys[pos], kind="stable")    # (key desc, pos asc)
        return np.sort(pos[order[:kc]])
    if len(pos) > CAND:
        paths["row"] += 1
        pos = np.arange(len(keys))
    else:
        paths["radix"] += 1
    arr = keys[pos]
    T, need, _ = radix_select(arr, kc)
    tie_rank = np.cumsum(arr == T) - 1
    win = (arr > T) | ((arr == T) & (tie_rank < need))
    return pos[win]


def tiled_topk(raw: np.ndarray, k: int, *, bits=None, n_items=None,
               row_valid=None, paths=None):
    """The tiled route on a ``[B, M]`` unmasked score matrix: (vals, ids)
    as the kernel writes them."""
    B, M = raw.shape
    n_items = M if n_items is None else n_items
    paths = collections.Counter() if paths is None else paths
    keys = tile_keys(raw, bits, n_items, row_valid)
    pairs = als_cuda.chunk_candidates(k, M, CHUNK)
    cand_k = np.zeros((B, pairs), np.int64)
    cand_i = np.full((B, pairs), -1, np.int64)
    for c, lo in enumerate(range(0, M, CHUNK)):
        kk = keys[:, lo:lo + CHUNK]
        kc = min(k, kk.shape[1])
        g = maxima(kk)
        for b0 in range(0, B, TILE_Q):                 # the query tiles
            for b in range(b0, min(b0 + TILE_Q, B)):
                win = chunk_winners(kk[b], g[b], kc, paths)
                assert len(win) == kc
                # the candidate slots hold key_float(key), keyed again
                cand_k[b, c * k:c * k + kc] = float_key(key_float(kk[b, win]))
                cand_i[b, c * k:c * k + kc] = lo + win
    assert (cand_i >= 0).all()                          # no gaps
    # the merge: (key desc, position asc); positions ascend with ids
    assert (np.diff(cand_i, axis=1) > 0).all()
    order = np.argsort(-cand_k, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(cand_k, order, axis=1)
    return (torch.from_numpy(key_float(top).copy()),
            torch.from_numpy(np.take_along_axis(cand_i, order, axis=1)
                             .astype(np.int32)))


def assert_equal_finite(v, i, pv, pi):
    """Equal value bits and ids on every finite slot; -inf slots agree."""
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(v), fin)
    assert torch.equal(v[fin].view(torch.int32), pv[fin].view(torch.int32))
    assert torch.equal(i[fin], pi[fin])


def int_case(seed, B, M, R=6, L=16):
    rng = np.random.default_rng(seed)
    Q = rng.integers(1, 3, (B, R)).astype(np.float32)
    Y = rng.integers(-2, 3, (M, R)).astype(np.float32)
    cols = rng.integers(0, M, (L, B)).astype(np.int32)
    mask = (rng.random((L, B)) < 0.7).astype(np.float32)
    return Q, Y, cols, mask


def both(Q, Y, cols, mask, *, k, n_items, mask_seen=True, row_valid=None,
         paths=None):
    """The emulated route and the plain version on the same inputs."""
    Qt, Yt = torch.from_numpy(Q), (Y if not isinstance(Y, np.ndarray)
                                   else torch.from_numpy(Y))
    ct, mt = torch.from_numpy(cols), torch.from_numpy(mask)
    rv = None if row_valid is None else torch.from_numpy(row_valid)
    B = Q.shape[0]
    M = (Yt.data if hasattr(Yt, "scale") else Yt).shape[0]
    raw = als_cuda.masked_scores_plain(Qt, Yt, None, None, n_items=M,
                                       mask_seen=False).numpy()
    bits = seen_bitmap(cols, mask, B, M) if mask_seen else None
    v, i = tiled_topk(raw, k, bits=bits, n_items=n_items, row_valid=row_valid,
                      paths=paths)
    pv, pi = als_cuda.fused_gather_score_topk_plain(
        Qt, Yt, ct, mt, k=k, n_items=n_items, mask_seen=mask_seen,
        row_valid=rv)
    return v, i, pv, pi


class TestTiledEqualsPlain:
    @pytest.mark.parametrize("k", [1, 16, 128])
    @pytest.mark.parametrize("M", [2049, 4096, 5000, 26_744,
                                   CHUNK * 26 + 1])
    def test_integer_ties_across_chunks(self, k, M):
        """Small integer scores tie by the thousand; rows 1,000..1,099
        (across the first chunk edge) and the last 300 rows share the top
        score, so the winners straddle chunks. 17 queries: the second
        query tile holds one."""
        Q, Y, cols, mask = int_case(M + k, 17, M)
        Y[1000:1100] = 4.0
        Y[-300:] = 4.0
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M)
        assert_equal_finite(v, i, pv, pi)

    @pytest.mark.parametrize("k", [16, 100, 128])
    def test_last_chunk_shorter_than_k(self, k):
        """26,744 rows: the last chunk gives 120 candidates, fewer than k
        = 128; it holds the top scores."""
        M = 26_744
        Q, Y, cols, mask = int_case(k, 3, M)
        Y[-120:] = 5.0
        assert als_cuda.chunk_candidates(k, M, CHUNK) == 26 * k + min(k, 120)
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M)
        assert_equal_finite(v, i, pv, pi)
        assert (i[:, :min(k, 120 - 16)] >= M - 120).all()

    @pytest.mark.parametrize("k", [1, 16, 128])
    def test_one_item_in_the_last_chunk(self, k):
        M = CHUNK * 4 + 1
        Q, Y, cols, mask = int_case(7, 4, M)
        Y[-1] = 9.0
        cols[cols == M - 1] = 0
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M)
        assert_equal_finite(v, i, pv, pi)
        assert (i[:, 0] == M - 1).all()

    @pytest.mark.parametrize("n_items", [3000, 4097, 4999])
    @pytest.mark.parametrize("k", [16, 128])
    def test_n_items_cut_inside_a_chunk(self, n_items, k):
        Q, Y, cols, mask = int_case(n_items, 3, 5000)
        Y[n_items:] = 9.0          # padding rows would win if not masked
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=n_items)
        assert_equal_finite(v, i, pv, pi)
        assert (i[torch.isfinite(v)] < n_items).all()

    @pytest.mark.parametrize("k", [16, 128])
    def test_row_valid(self, k):
        rng = np.random.default_rng(k)
        Q, Y, cols, mask = int_case(11, 4, 6000)
        rv = (rng.random(6000) < 0.5).astype(np.float32)
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=6000,
                            row_valid=rv)
        assert_equal_finite(v, i, pv, pi)
        assert (rv[i[torch.isfinite(v)].numpy()] > 0).all()

    @pytest.mark.parametrize("k", [16, 128])
    @pytest.mark.parametrize("left", [0, 5, 20, 300])
    def test_seen_mask_over_most_of_the_row(self, k, left):
        """All but ``left`` items of each query seen: whole chunks are
        -inf, their maxima too, and (with fewer than k finite items a
        chunk) the select runs over the whole chunk; fewer than k finite
        winners may remain."""
        M, B = 5000, 3
        rng = np.random.default_rng(left + k)
        Q, Y, _, _ = int_case(13, B, M)
        cols = np.stack([rng.permutation(M)[:M - left] for _ in range(B)],
                        axis=1).astype(np.int32)
        mask = np.ones(cols.shape, np.float32)
        paths = collections.Counter()
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M, paths=paths)
        assert_equal_finite(v, i, pv, pi)
        assert int(torch.isfinite(v).sum()) == B * min(k, left)
        if left <= 20:
            assert paths["row"] > 0

    @pytest.mark.parametrize("mask_seen", [True, False])
    @pytest.mark.parametrize("k", [16, 128])
    def test_random_scores_take_each_select(self, mask_seen, k):
        """Distinct random scores: at k = 16 a chunk's candidates above
        the threshold are few (the rank-count select), at k = 128 a few
        hundred (the radix select over them)."""
        rng = np.random.default_rng(5)
        Q = rng.normal(size=(20, 16)).astype(np.float32)
        Y = rng.normal(size=(26_744, 16)).astype(np.float32)
        cols = rng.integers(0, 26_744, (64, 20)).astype(np.int32)
        mask = np.ones((64, 20), np.float32)
        paths = collections.Counter()
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=26_741,
                            mask_seen=mask_seen, paths=paths)
        assert_equal_finite(v, i, pv, pi)
        assert paths[{16: "rank", 128: "radix"}[k]] > paths.total() // 2

    @pytest.mark.parametrize("k", [16, 128])
    def test_int8_store_scales_each_row(self, k):
        """An int8 store: each row dequantized by its own scale before
        the product; ties across a chunk edge."""
        rng = np.random.default_rng(k + 3)
        Y = rng.normal(size=(5000, 8)).astype(np.float32)
        Y[1020:1030] = Y[1020]
        store = quantize_rows_int8(torch.from_numpy(Y))
        Q = rng.normal(size=(18, 8)).astype(np.float32)
        cols = rng.integers(0, 5000, (32, 18)).astype(np.int32)
        mask = np.ones((32, 18), np.float32)
        v, i, pv, pi = both(Q, store, cols, mask, k=k, n_items=4990)
        assert_equal_finite(v, i, pv, pi)


class TestPieces:
    def test_negative_zero_ties_with_positive_zero(self):
        """-0.0 and +0.0 share a key, so they tie and break by id, across
        a chunk edge, and the candidate (key_float) is +0.0, as the plain
        version's + 0.0 gives."""
        M = 3000
        raw = np.full((2, M), -1.0, np.float32)
        raw[0, 1000:1100:2] = -0.0
        raw[0, 1001:1100:2] = 0.0
        raw[1, 2100:2500:3] = -0.0
        raw[1, 1500] = 0.0
        v, i = tiled_topk(raw, 16)
        pv, pi = torch.sort(torch.from_numpy(raw) + 0.0, dim=1,
                            descending=True, stable=True)
        assert_equal_finite(v, i, pv[:, :16], pi[:, :16].int())
        assert i[0].tolist() == list(range(1000, 1016))
        assert i[1].tolist()[:2] == [1500, 2100]
        assert (v.view(torch.int32) == 0).all()     # +0.0 bits

    def test_seen_bitmap_takes_only_masked_ids_in_range(self):
        cols = np.array([[0, 31], [32, -1], [99, 100], [5, 5]], np.int32)
        mask = np.array([[1, 1], [1, 1], [1, 0], [0, 1]], np.float32)
        bits = seen_bitmap(cols, mask, 2, 100)
        assert bits.shape == (2, 4)
        assert bits[0].tolist() == [1, 1, 0, 1 << 3]
        assert bits[1].tolist() == [(1 << 31) | (1 << 5), 0, 0, 0]

    @pytest.mark.parametrize("kind", ["normal", "few", "same", "masked"])
    @pytest.mark.parametrize("n,k", [(1024, 1), (1024, 16), (1024, 128),
                                     (120, 16), (120, 120), (1, 1)])
    def test_threshold_keeps_the_winners(self, kind, n, k):
        """At least kc keys of the chunk lie at or above the threshold,
        so the chunk's winners are among the candidates; the lanes' way
        (kc <= 32) never lies above the bitwise search's."""
        rng = np.random.default_rng(n * 7 + k)
        scores = {"normal": rng.normal(size=n),
                  "few": rng.integers(0, 3, n),
                  "same": np.zeros(n),
                  "masked": np.where(rng.random(n) < 0.9, -np.inf,
                                     rng.integers(-3, 3, n))}[kind]
        keys = float_key(scores.astype(np.float32))[None]
        g, kc = maxima(keys)[0], min(k, n)
        tau = threshold(g, kc)
        top = np.sort(np.argsort(-keys[0], kind="stable")[:kc])
        assert (keys[0, top] >= tau).all()
        assert (keys[0] >= tau).sum() >= kc
        exact = max(t for t in range(1 << 16) if (g >= t).sum() >= kc) \
            if kind == "few" else None
        if exact is not None:
            assert tau <= exact << 16
        assert np.array_equal(
            chunk_winners(keys[0], maxima(keys)[0], min(k, n),
                          collections.Counter()), top)


class TestLayout:
    """The emulation's constants and maxima, against the kernel's."""

    def test_constants_follow_the_kernel_source(self):
        """TILE_IG = TILE_THREADS / (TILE_Q / TILE_QT) item groups of
        four, two halves: the maxima a query and the items each covers."""
        import pathlib
        import re

        src = (pathlib.Path(als_cuda.__file__).parent / "csrc"
               / "fused_topk.cu").read_text()

        def const(name):
            return int(re.search(rf"constexpr int {name} = (\d+);",
                                 src).group(1))

        tile_ig = const("TILE_THREADS") // (const("TILE_Q") // const("TILE_QT"))
        assert (const("TILE_CHUNK"), const("TILE_Q")) == (CHUNK, TILE_Q)
        assert (IG, GROUPS, HALF) == (tile_ig, 2 * tile_ig, CHUNK // 2)
        assert tile_ig * 4 == HALF

    @pytest.mark.parametrize("n", [1, 700, CHUNK])
    def test_maxima_follow_the_kernels_groups(self, n):
        """Maximum ig * 2 + h is the largest key of items h * HALF + ig +
        IG * jj (jj < 4), as ``score_select_tile_kernel`` writes ``gmax``;
        items past the chunk's n count as 0."""
        rng = np.random.default_rng(n)
        keys = rng.integers(0, 1 << 32, (2, n))
        full = np.zeros((2, CHUNK), np.int64)
        full[:, :n] = keys
        want = np.zeros((2, GROUPS), np.int64)
        for h in range(2):
            for ig in range(IG):
                items = [h * HALF + ig + IG * jj for jj in range(4)]
                want[:, ig * 2 + h] = full[:, items].max(axis=1) >> 16
        assert np.array_equal(maxima(keys), want)


class TestAgainstJax:
    """The emulated route against the JAX package's Pallas kernel in
    interpret mode, on integer factors (exact scores)."""

    @pytest.mark.parametrize("k", [16, 128])
    def test_interpret_mode(self, k):
        M, R, B = 5000, 8, 17
        rng = np.random.default_rng(k)
        Q = rng.integers(1, 4, (B, R)).astype(np.float32)
        Y = rng.integers(-3, 4, (M, R)).astype(np.float32)
        Y[1015:1035] = 4.0                         # ties across a chunk edge
        cols = rng.integers(0, M, (6, B)).astype(np.int32)
        cols[0] = 1020
        mask = np.ones((6, B), np.float32)
        jv, ji = als_pallas.fused_gather_score_topk(
            jnp.asarray(Q), jnp.asarray(Y), cols, mask, k=k, n_items=M - 7,
            interpret=True)
        raw = als_cuda.masked_scores_plain(
            torch.from_numpy(Q), torch.from_numpy(Y), None, None, n_items=M,
            mask_seen=False).numpy()
        v, i = tiled_topk(raw, k, bits=seen_bitmap(cols, mask, B, M),
                          n_items=M - 7)
        assert_equal_finite(v, i, torch.from_numpy(np.array(jv)),
                            torch.from_numpy(np.array(ji)).int())
        assert 1020 not in i.tolist()[0] and i[0, 0] == 1015
