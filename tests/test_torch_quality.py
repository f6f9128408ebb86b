"""Model quality of the port's trainer against the JAX trainer, on the
CPU, on ``bench_quality``'s protocol at a smaller shape.

``chip_smoke.py`` keeps its own copies of ``bench_quality``'s numpy
helpers (the originals import the JAX package lazily); here each copy
must give what the original gives. Then the port's ``train_als``
(``device="cpu"``, the kernels' plain versions) and the JAX package's
``train_als`` train the same leave-last-2-out split from one shared
init: their Precision@10 must agree within 1e-3, and both must beat the
popularity recommender. The card's run of the same protocol at
MovieLens-100K's shape is phase 7 of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import bench_quality
import chip_smoke
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.ops import als as tals

SHAPE = (120, 200, 4_000)
RANK, ITERATIONS = 8, 6


@pytest.fixture(scope="module")
def split():
    return chip_smoke.build_split(*SHAPE, seed=7)


def test_copies_equal_bench_quality(split):
    rows, cols, vals, held = split
    want = bench_quality.build_split(*SHAPE, seed=7)
    for a, b in zip((rows, cols, vals), want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert held == want[3]
    rng = np.random.default_rng(0)
    X = rng.normal(size=(SHAPE[0], 4)).astype(np.float32)
    Y = rng.normal(size=(SHAPE[1], 4)).astype(np.float32)
    scores = chip_smoke.masked_scores(X, Y, rows, cols)
    assert chip_smoke.precision_at_k(scores, held) == \
        bench_quality.precision_at_k(X, Y, rows, cols, held)
    assert chip_smoke.ndcg_at_k(scores, held) == pytest.approx(
        bench_quality.ndcg_at_k_factors(X, Y, rows, cols, held), abs=1e-12)
    assert chip_smoke.popularity_precision(rows, cols, held, SHAPE[1]) == \
        bench_quality.popularity_precision(rows, cols, held, SHAPE[1])


def test_precision_equals_the_jax_trainer(split, monkeypatch):
    def jax_init(n_rows, n_cols, rank, seed, device=None):
        X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
        return (torch.from_numpy(np.array(X)).to(device),
                torch.from_numpy(np.array(Y)).to(device))

    monkeypatch.setattr(tals, "init_factors", jax_init)
    rows, cols, vals, held = split
    n_users, n_items, _ = SHAPE
    out = {}
    for name, m in (("jax", jals), ("port", tals)):
        user_side = m.pad_ratings(rows, cols, vals, n_users, n_items)
        item_side = m.pad_ratings(cols, rows, vals, n_items, n_users)
        params = m.ALSParams(rank=RANK, num_iterations=ITERATIONS,
                             lambda_=0.01, alpha=1.0, seed=3)
        X, Y = (m.train_als(user_side, item_side, params, "cpu")
                if m is tals else m.train_als(user_side, item_side, params))
        scores = chip_smoke.masked_scores(np.asarray(X), np.asarray(Y),
                                          rows, cols)
        out[name] = (chip_smoke.precision_at_k(scores, held),
                     chip_smoke.ndcg_at_k(scores, held))
    assert abs(out["port"][0] - out["jax"][0]) <= 1e-3, out
    assert abs(out["port"][1] - out["jax"][1]) <= 1e-3, out
    pop = chip_smoke.popularity_precision(rows, cols, held, n_items)
    assert out["port"][0] > pop, (out, pop)
