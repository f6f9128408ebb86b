"""The serving kernel's chunked selection route, emulated on the CPU.

For ``k <= CHUNK_K_MAX`` over a row wider than ``TOPK_CHUNK`` items,
``csrc/fused_topk.cu`` selects in two steps: each chunk of the row picks
its own top ``min(k, n_c)`` by (score desc, id asc) and writes them,
ordered by id, to its slots of a candidate row (``select_chunk_kernel``);
then one block per query selects and sorts the k winners of that row by
(score desc, position asc) and maps positions to ids
(``select_bitonic_kernel``). Positions along the candidate row ascend
with item ids, so that order is (score desc, id asc), and the global
top k lies in the union of the chunks' top k: the route returns what a
stable sort of the whole row returns.

Here the two steps are emulated in plain PyTorch on the kernel's
order-preserving 32-bit keys (``float_key`` / ``key_float``, -0.0 keyed
as +0.0) and held EQUAL, value bits and ids on every finite slot, to
``fused_gather_score_topk_plain`` and, on integer data, to the JAX
package's Pallas kernel in interpret mode. Slots whose score is -inf
carry no defined id in the contract and are compared only on being
-inf. The kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als_pallas
from predictionio_tpu_torch.ops import als_cuda

CHUNK = als_cuda.TOPK_CHUNK


def float_key(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's key as int64: a > b as floats <=> key(a) > key(b);
    -0.0 gets the key of +0.0."""
    u = scores.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(scores == 0, torch.zeros_like(u), u)
    neg = (u & 0x80000000) != 0
    return torch.where(neg, ~u & 0xFFFFFFFF, u | 0x80000000)


def key_float(key: torch.Tensor) -> torch.Tensor:
    neg = (key & 0x80000000) == 0
    u = torch.where(neg, ~key & 0xFFFFFFFF, key & 0x7FFFFFFF)
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


def chunked_topk(scores: torch.Tensor, k: int):
    """The chunked route on a ``[B, M]`` score matrix: (vals, ids) as
    the kernel writes them."""
    B, M = scores.shape
    keys = float_key(scores)
    cand_k, cand_i = [], []
    for lo in range(0, M, CHUNK):
        kk = keys[:, lo:lo + CHUNK]
        kc = min(k, kk.shape[1])
        # the chunk's top kc by (key desc, position asc) ...
        top_k, top_pos = torch.sort(kk, dim=1, descending=True, stable=True)
        top_k, top_pos = top_k[:, :kc], top_pos[:, :kc]
        # ... written in id order
        pos, perm = torch.sort(top_pos, dim=1)
        cand_k.append(torch.gather(top_k, 1, perm))
        cand_i.append(pos + lo)
    ck, ci = torch.cat(cand_k, dim=1), torch.cat(cand_i, dim=1)
    assert ck.shape[1] == als_cuda.chunk_candidates(k, M)
    # the candidate row holds key_float(key); the merge keys it again
    ck = float_key(key_float(ck))
    # the merge: (key desc, position asc), positions mapped to ids
    top, order = torch.sort(ck, dim=1, descending=True, stable=True)
    return key_float(top[:, :k]), torch.gather(ci, 1, order[:, :k]).int()


def assert_equal_finite(v, i, pv, pi):
    """Equal value bits and ids on every finite slot; -inf slots agree."""
    fin = torch.isfinite(pv)
    assert torch.equal(torch.isfinite(v), fin)
    assert torch.equal(v[fin].view(torch.int32), pv[fin].view(torch.int32))
    assert torch.equal(i[fin], pi[fin])


def int_case(seed, B, M, R=6, L=16, lo=-2, hi=3):
    rng = np.random.default_rng(seed)
    Q = rng.integers(1, 3, (B, R)).astype(np.float32)
    Y = rng.integers(lo, hi, (M, R)).astype(np.float32)
    cols = rng.integers(0, M, (L, B)).astype(np.int32)
    mask = (rng.random((L, B)) < 0.7).astype(np.float32)
    return Q, Y, cols, mask


def both(Q, Y, cols, mask, *, k, n_items, mask_seen=True, row_valid=None):
    """The emulated route and the plain version on the same inputs."""
    Qt, Yt = torch.from_numpy(Q), torch.from_numpy(Y)
    ct, mt = torch.from_numpy(cols), torch.from_numpy(mask)
    rv = None if row_valid is None else torch.from_numpy(row_valid)
    kw = dict(n_items=n_items, mask_seen=mask_seen, row_valid=rv)
    scores = als_cuda.masked_scores_plain(Qt, Yt, ct, mt, **kw)
    v, i = chunked_topk(scores, k)
    pv, pi = als_cuda.fused_gather_score_topk_plain(Qt, Yt, ct, mt, k=k, **kw)
    return v, i, pv, pi


class TestChunkedEqualsPlain:
    @pytest.mark.parametrize("k", [1, 16, 128])
    @pytest.mark.parametrize("M", [2049, 4096, 5000, 26_744,
                                   2048 * 13 + 100])
    def test_integer_ties_across_chunks(self, k, M):
        """Small integer scores tie by the thousand; rows 2,000..2,299
        (across the first chunk boundary) and the last 300 rows share the
        top score, so the winners straddle chunks."""
        Q, Y, cols, mask = int_case(M + k, 3, M)
        Y[2000:2300] = 4.0
        Y[-300:] = 4.0
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M)
        assert_equal_finite(v, i, pv, pi)
        if M >= 5000:
            assert (i[:, 0] >= 2000).all() and (i[:, :k] < 2300).all()

    @pytest.mark.parametrize("k", [16, 100, 128])
    def test_last_chunk_shorter_than_k(self, k):
        """2,048 * 13 + 100 rows: the last chunk gives 100 candidates,
        and at k = 128 fewer than k; it holds the top scores."""
        M = 2048 * 13 + 100
        Q, Y, cols, mask = int_case(k, 2, M)
        Y[-100:] = 5.0
        assert als_cuda.chunk_candidates(k, M) == 13 * k + min(k, 100)
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M)
        assert_equal_finite(v, i, pv, pi)
        assert (i[:, :min(k, 100 - 16)] >= M - 100).all()

    @pytest.mark.parametrize("k", [1, 16, 128])
    def test_one_item_in_the_last_chunk(self, k):
        Q, Y, cols, mask = int_case(7, 4, 2049)
        Y[2048] = 9.0
        cols[cols == 2048] = 0
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=2049)
        assert_equal_finite(v, i, pv, pi)
        assert (i[:, 0] == 2048).all()

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
        -inf, and fewer than k finite winners may remain."""
        M, B = 5000, 3
        rng = np.random.default_rng(left + k)
        Q, Y, _, _ = int_case(13, B, M)
        cols = np.stack([rng.permutation(M)[:M - left] for _ in range(B)],
                        axis=1).astype(np.int32)
        mask = np.ones(cols.shape, np.float32)
        v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=M)
        assert_equal_finite(v, i, pv, pi)
        assert int(torch.isfinite(v).sum()) == B * min(k, left)

    @pytest.mark.parametrize("mask_seen", [True, False])
    def test_unmasked_random_scores(self, mask_seen):
        rng = np.random.default_rng(5)
        Q = rng.normal(size=(8, 16)).astype(np.float32)
        Y = rng.normal(size=(26_744, 16)).astype(np.float32)
        cols = rng.integers(0, 26_744, (64, 8)).astype(np.int32)
        mask = np.ones((64, 8), np.float32)
        for k in (16, 128):
            v, i, pv, pi = both(Q, Y, cols, mask, k=k, n_items=26_741,
                                mask_seen=mask_seen)
            assert_equal_finite(v, i, pv, pi)



class TestKeys:
    def test_negative_zero_ties_with_positive_zero(self):
        """-0.0 and +0.0 share a key, so they tie and break by id, and the
        candidate (key_float) is +0.0, as the plain version's + 0.0 gives."""
        M = 5000
        scores = torch.full((2, M), -1.0)
        scores[0, 100:200:2] = -0.0
        scores[0, 101:200:2] = 0.0
        scores[1, 3000:4500:3] = -0.0
        scores[1, 2100] = 0.0
        v, i = chunked_topk(scores, 16)
        pv, pi = torch.sort(scores + 0.0, dim=1, descending=True, stable=True)
        assert_equal_finite(v, i, pv[:, :16], pi[:, :16].int())
        assert i[0].tolist() == list(range(100, 116))
        assert i[1].tolist()[:2] == [2100, 3000]
        assert (v.view(torch.int32) == 0).all()     # +0.0 bits

    def test_keys_order_like_floats(self):
        x = torch.tensor([float("-inf"), -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0,
                          float("inf")])
        k = float_key(x)
        assert (k[1:] >= k[:-1]).all() and k[3] == k[4]
        assert torch.equal(key_float(k).view(torch.int32),
                           (x + 0.0).view(torch.int32))


def radix_select(keys: np.ndarray, rank: int):
    """``radix_select`` of ``csrc/fused_topk.cu`` on 32-bit ``keys`` (held
    in int64): 8-bit
    digits from the top, the digit found from the highest bin down, and
    the early end once a digit's keys all win. Returns (T, need, eq)."""
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


def select_winners(keys: np.ndarray, k: int) -> np.ndarray:
    """The positions ``select_winners`` keeps: keys > T, and keys == T at
    positions <= the cut from a select over ~position."""
    T, need, eq = radix_select(keys, k)
    cut = 0xFFFFFFFF
    if need < eq:
        tied = np.flatnonzero(keys == T)
        cut = ~radix_select(~tied & 0xFFFFFFFF, need)[0] & 0xFFFFFFFF
    pos = np.arange(len(keys))
    return np.flatnonzero((keys > T) | ((keys == T) & (pos <= cut)))


class TestRadixSelect:
    """The select's winners are the top k by (key desc, position asc),
    whether its passes run to the last digit or end early, and whether
    or not ties at the threshold need the select over positions."""

    @pytest.mark.parametrize("kind", ["normal", "integer", "few", "same",
                                      "masked"])
    @pytest.mark.parametrize("n,k", [(2048, 1), (2048, 16), (2048, 128),
                                     (120, 16), (120, 120), (224, 16),
                                     (1784, 128), (26_744, 16)])
    def test_winners_are_the_stable_top_k(self, kind, n, k):
        rng = np.random.default_rng(n * 7 + k)
        scores = {"normal": rng.normal(size=n),
                  "integer": rng.integers(-20, 20, n),
                  "few": rng.integers(0, 3, n),
                  "same": np.zeros(n),
                  "masked": np.where(rng.random(n) < 0.9, -np.inf,
                                     rng.integers(-3, 3, n))}[kind]
        keys = float_key(torch.from_numpy(scores.astype(np.float32))[None])
        keys = keys[0].numpy()
        top = np.sort(np.argsort(-keys, kind="stable")[:k])
        assert np.array_equal(select_winners(keys, k), top)


class TestAgainstJax:
    """The emulated route on the port's scores against the JAX package's
    Pallas kernel in interpret mode, on integer factors (exact scores)."""

    @pytest.mark.parametrize("k", [16, 128])
    def test_interpret_mode(self, k):
        M, R, B = 5000, 8, 4
        rng = np.random.default_rng(k)
        Q = rng.integers(1, 4, (B, R)).astype(np.float32)
        Y = rng.integers(-3, 4, (M, R)).astype(np.float32)
        Y[2040:2060] = 4.0                         # ties across a chunk edge
        cols = rng.integers(0, M, (6, B)).astype(np.int32)
        cols[0] = 2045
        mask = np.ones((6, B), np.float32)
        jv, ji = als_pallas.fused_gather_score_topk(
            jnp.asarray(Q), jnp.asarray(Y), cols, mask, k=k, n_items=M - 7,
            interpret=True)
        scores = als_cuda.masked_scores_plain(
            torch.from_numpy(Q), torch.from_numpy(Y), torch.from_numpy(cols),
            torch.from_numpy(mask), n_items=M - 7)
        v, i = chunked_topk(scores, k)
        assert_equal_finite(v, i, torch.from_numpy(np.array(jv)),
                            torch.from_numpy(np.array(ji)).int())
        assert 2045 not in i.tolist()[0] and i[0, 0] == 2040
