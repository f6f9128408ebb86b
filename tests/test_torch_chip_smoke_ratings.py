"""``chip_smoke.power_law_pairs`` and ``chip_smoke.rate_lines`` against
the ways they replace.

Phase 5 of ``chip_smoke.py`` draws its ML-20M-width ratings with
``power_law_pairs``: a table of 2^20 equal buckets in place of
``rng.choice``'s binary search, and a scan of first draws in place of two
sorts. It must give the very pairs that ``rng.choice`` and the sorts give
from the same seed, and leave the generator in the same state (the stars
and genres are drawn next), so the store's bytes do not change. Here both
ways run on small row lengths. The phase builds its lines with
``rate_lines`` (numpy, no Python call a line), which must give
``RATE_LINE.format``'s lines byte for byte."""

import numpy as np
import pytest

import chip_smoke


def pairs_by_choice(rng, lens, n_items: int) -> tuple:
    """Each user's ``lens[u]`` distinct items by ``rng.choice`` over the
    power-law popularity, twice over, first occurrences kept in draw
    order and cut to length."""
    n_users = len(lens)
    pop = 1.0 / (np.arange(n_items) + 10.0) ** 0.8
    draws = rng.choice(n_items, size=int(2 * lens.sum()), p=pop / pop.sum())
    user_of = np.repeat(np.arange(n_users), 2 * lens)
    key = user_of * n_items + draws
    order = np.argsort(key, kind="stable")
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[order][1:] != key[order][:-1]
    kept = np.sort(order[first])
    users = user_of[kept]
    rank = np.arange(len(kept)) - np.searchsorted(users, users)
    sel = rank < lens[users]
    return users[sel], draws[kept][sel]


def lognormal_lens(rng, n_users: int, cap: int) -> np.ndarray:
    lens = np.clip(rng.lognormal(3.0, 1.2, n_users).astype(np.int64), 1, cap)
    lens[np.argmax(lens)] = cap
    return lens


@pytest.mark.parametrize("seed,n_users,n_items,cap", [
    (0, 500, 26_744, 2_048),     # the phase's catalog
    (1, 300, 3_706, 1_000),
    (2, 200, 100, 60),           # rows near the catalog's width
    (3, 50, 7, 7),               # few items: wide buckets of the table
    (4, 40, 1, 1),
])
def test_pairs_equal_rng_choice(seed, n_users, n_items, cap):
    lens = lognormal_lens(np.random.default_rng(seed + 100), n_users, cap)
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    want = pairs_by_choice(a, lens, n_items)
    got = chip_smoke.power_law_pairs(b, lens, n_items)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
        assert w.dtype == g.dtype
    # the generator moved as far either way: what it draws next agrees
    assert np.array_equal(a.random(8), b.random(8))


@pytest.mark.parametrize("seed", [0, 5])
def test_draws_equal_rng_choice_many(seed):
    n_items = 26_744
    pop = 1.0 / (np.arange(n_items) + 10.0) ** 0.8
    want = np.random.default_rng(seed).choice(n_items, size=400_000,
                                              p=pop / pop.sum())
    got = chip_smoke.power_law_draws(np.random.default_rng(seed), n_items,
                                     400_000)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("n_users,n_items,n", [
    (138_493, 26_744, 5_000),    # the phase's widths
    (1, 1, 3),                   # one digit each
    (10, 100, 50),               # the widths' edges: 9 / 10, 99 / 100
    (1_000_001, 7, 2_000),
])
def test_rate_lines_equal_format(n_users, n_items, n):
    rng = np.random.default_rng(n)
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    users[:2], items[:2] = (0, n_users - 1), (0, n_items - 1)
    stars = rng.integers(0, 11, n)
    stars[:2] = (0, 10)
    tables = (chip_smoke.decimal_table(int(users.max()) + 1),
              chip_smoke.decimal_table(int(items.max()) + 1),
              np.array([list(t.encode()) for t in chip_smoke.STAR_TEXT],
                       np.uint8))
    want = [chip_smoke.RATE_LINE.format(u, i, chip_smoke.STAR_TEXT[s])
            for u, i, s in zip(users.tolist(), items.tolist(),
                               stars.tolist())]
    assert chip_smoke.rate_lines(users, items, stars, tables) == want
