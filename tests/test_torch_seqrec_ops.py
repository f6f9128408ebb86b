"""The port's ``ops/seqrec.py`` against the JAX package's on the same
seeded inputs: bucketing and the step plan byte for byte; the encoder on
a θ carried from JAX (1e-5); padded against unpadded encodes (1e-5, not
bitwise: the JAX encoder is no bit-level oracle there); chunked against
whole encodes (1e-6); one step's loss and every gradient against
``jax.value_and_grad`` (1e-5); the Adam update on given gradients
(1e-6); 20 training steps replaying JAX's own row and negative draws
(loss trace 1e-5 relative, θ 1e-4); ``sp_mode`` ring / ulysses train
and encode without a mesh as JAX does (densely; the same tolerances)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import seqrec as jseq
from predictionio_tpu_torch.ops import seqrec as tseq

N_ITEMS = 40
PARAMS = dict(rank=16, n_layers=2, n_heads=4, max_seq_len=16,
              num_steps=20, batch_size=8, n_negatives=12,
              learning_rate=0.01, seed=5)


def chain_sequences(n_users=30, n_items=N_ITEMS, min_len=1, max_len=20,
                    seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start = int(rng.integers(0, n_items))
        stride = int(rng.integers(1, 4))
        n = int(rng.integers(min_len, max_len))
        seqs.append(((start + stride * np.arange(n)) % n_items)
                    .astype(np.int64))
    return seqs


def params_pair(**over):
    kw = {**PARAMS, **over}
    return jseq.SeqRecParams(**kw), tseq.SeqRecParams(**kw)


def jax_theta(params):
    return jseq.init_theta(N_ITEMS, params)


def t_theta(theta):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in theta.items()}


def test_params_fields_and_defaults_match():
    import dataclasses

    j = {f.name: f.default for f in dataclasses.fields(jseq.SeqRecParams)}
    t = {f.name: f.default for f in dataclasses.fields(tseq.SeqRecParams)}
    assert j == t


@pytest.mark.parametrize("max_len", [None, 8, 16])
def test_bucket_sequences_byte_equal(max_len):
    seqs = chain_sequences(seed=1) + [np.arange(0), np.arange(100) % 7]
    want = jseq.bucket_sequences(seqs, max_len=max_len)
    got = tseq.bucket_sequences(seqs, max_len=max_len)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("rows", "ids", "mask"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [1, 7, 8, 9, 33, 64, 65, 1000])
def test_length_bucket_matches(n):
    assert tseq.length_bucket(n) == jseq.length_bucket(n)


@pytest.mark.parametrize("steps,bs", [(20, 8), (1000, 256), (3, 64)])
def test_plan_steps_and_tokens_match(steps, bs):
    seqs = chain_sequences(n_users=80, seed=2)
    jp, tp = params_pair(num_steps=steps, batch_size=bs)
    buckets = tseq.bucket_sequences(seqs, max_len=16)
    assert tseq.plan_steps(buckets, tp) == jseq.plan_steps(
        jseq.bucket_sequences(seqs, max_len=16), jp)
    assert tseq.training_tokens(buckets, tp) == sum(
        s * b * bk.seq_len for bk, (s, b) in zip(buckets,
                                                  tseq.plan_steps(buckets, tp)))
    with pytest.raises(ValueError, match="no non-empty"):
        tseq.plan_steps([], tp)


def test_init_theta_names_shapes_and_scales():
    jp, tp = params_pair(rank=32, n_layers=3, max_seq_len=20)
    want = jseq.init_theta(300, jp)
    got = tseq.init_theta(300, tp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        if k.endswith(("_g", "_b", "_b1", "_b2")):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            # same scale: std within 15% of JAX's draw's
            assert abs(got[k].std() / want[k].std() - 1) < 0.15, k
    again = tseq.init_theta(300, tp)
    assert all(np.array_equal(again[k], got[k]) for k in got)
    with pytest.raises(ValueError, match="not divisible"):
        tseq.init_theta(10, tseq.SeqRecParams(rank=10, n_heads=4))


def test_encoder_forward_matches_jax_on_carried_theta():
    jp, tp = params_pair()
    theta = jax_theta(jp)
    (b8, b16, *rest) = tseq.bucket_sequences(chain_sequences(seed=3),
                                             max_len=16)
    for b in (b8, b16):
        want = np.asarray(jseq.encoder_forward(
            {k: jnp.asarray(v) for k, v in theta.items()},
            jnp.asarray(b.ids), jnp.asarray(b.mask), n_layers=2, n_heads=4))
        got = tseq.encoder_forward(t_theta(theta), torch.from_numpy(b.ids),
                                   torch.from_numpy(b.mask), n_layers=2,
                                   n_heads=4).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        # pad positions exactly zero
        assert (got[b.mask == 0] == 0).all()
        want_u = jseq.encode_bucket(theta, jseq.SequenceBucket(
            b.rows, b.ids, b.mask), jp)
        got_u = tseq.encode_bucket(theta, b, tp, device="cpu")
        np.testing.assert_allclose(got_u, want_u, atol=1e-5, rtol=1e-5)


def test_module_form_equals_functional_form():
    jp, tp = params_pair()
    theta = jax_theta(jp)
    enc = tseq.SeqRecEncoder(theta, 2, 4, device="cpu")
    assert sorted(n for n, _ in enc.named_parameters()) == sorted(theta)
    b = tseq.bucket_sequences(chain_sequences(seed=4), max_len=16)[-1]
    ids, mask = torch.from_numpy(b.ids), torch.from_numpy(b.mask)
    with torch.no_grad():
        got = enc.user_vectors(ids, mask).numpy()
    np.testing.assert_array_equal(
        got, tseq.encode_bucket(theta, b, tp, device="cpu"))


def test_padded_equals_unpadded_within_tolerance():
    jp, tp = params_pair()
    theta = jax_theta(jp)
    seqs = [np.array([3, 9, 1]), np.array([5] * 7), np.arange(12) % N_ITEMS,
            np.array([2])]
    users = np.zeros((len(seqs), 16), dtype=np.float32)
    for i, s in enumerate(seqs):
        b = tseq.SequenceBucket(np.array([0]), s[None].astype(np.int32),
                                np.ones((1, len(s)), dtype=np.float32))
        users[i] = tseq.encode_bucket(theta, b, tp, device="cpu")[0]
    buckets = tseq.bucket_sequences(seqs)
    enc = tseq.encode_users(theta, buckets, len(seqs), tp, device="cpu")
    np.testing.assert_allclose(enc, users, atol=1e-5, rtol=1e-5)
    # a batch padded to more rows and the longest class
    ids = np.zeros((8, 16), dtype=np.int32)
    mask = np.zeros((8, 16), dtype=np.float32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1
    wide = tseq.encode_bucket(theta, tseq.SequenceBucket(
        np.arange(8), ids, mask), tp, device="cpu")
    np.testing.assert_allclose(wide[:4], users, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(wide[4:], 0.0)   # empty rows stay zero


def test_chunked_encode_equals_whole():
    jp, tp = params_pair()
    theta = jax_theta(jp)
    b = tseq.bucket_sequences(chain_sequences(n_users=60, seed=6),
                              max_len=16)[-1]
    whole = tseq.encode_bucket(theta, b, tp, device="cpu", budget=1 << 40)
    per_row = tseq.encode_chunk_rows(b.seq_len, 16, 4)
    assert per_row > len(b)
    budget = (1 << 28) * 3 // per_row      # a few rows a chunk
    assert tseq.encode_chunk_rows(b.seq_len, 16, 4, budget=budget) < len(b)
    chunked = tseq.encode_bucket(theta, b, tp, device="cpu", budget=budget)
    np.testing.assert_allclose(chunked, whole, atol=1e-6, rtol=1e-6)


def _batch(seed=7):
    b = tseq.bucket_sequences(chain_sequences(n_users=40, min_len=2,
                                              seed=seed), max_len=16)[-1]
    negs = np.random.default_rng(seed).integers(0, N_ITEMS, 12).astype(
        np.int32)
    return b, negs


@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_loss_and_gradients_match_jax(l2):
    jp, tp = params_pair()
    theta = jax_theta(jp)
    b, negs = _batch()
    jl, jg = jax.value_and_grad(functools.partial(
        jseq._sampled_softmax_loss, n_layers=2, n_heads=4, l2=l2))(
        {k: jnp.asarray(v) for k, v in theta.items()}, jnp.asarray(b.ids),
        jnp.asarray(b.mask), jnp.asarray(negs))
    tl, tg = tseq.loss_and_grads(t_theta(theta), torch.from_numpy(b.ids),
                                 torch.from_numpy(b.mask),
                                 torch.from_numpy(negs), n_layers=2,
                                 n_heads=4, l2=l2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_adam_update_matches_jax_form():
    rng = np.random.default_rng(11)
    shapes = [(5, 4), (7,), (3, 3)]
    theta = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    v = [np.abs(rng.standard_normal(s)).astype(np.float32) * 0.01
         for s in shapes]
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    lr, t0 = 0.003, 4.0
    b1, b2, eps = 0.9, 0.999, 1e-8

    # the JAX package's step (seqrec.py:_train_bucket_jit), in jnp
    jt = jnp.asarray(t0, jnp.float32) + 1
    jm = [b1 * jnp.asarray(mi) + (1 - b1) * jnp.asarray(gi)
          for mi, gi in zip(m, g)]
    jv = [b2 * jnp.asarray(vi) + (1 - b2) * jnp.asarray(gi) * jnp.asarray(gi)
          for vi, gi in zip(v, g)]
    scale = lr * jnp.sqrt(1 - b2 ** jt) / (1 - b1 ** jt)
    want = [jnp.asarray(ti) - scale * mi / (jnp.sqrt(vi) + eps)
            for ti, mi, vi in zip(theta, jm, jv)]

    tt = lambda xs: [torch.from_numpy(x.copy()) for x in xs]  # noqa: E731
    got, gm, gv = tt(theta), tt(m), tt(v)
    gt = torch.tensor(t0, dtype=torch.float32)
    tseq.adam_update_(got, gm, gv, gt, tt(g), lr)
    assert float(gt) == float(jt)
    for a, b in zip(gm + gv + got, jm + jv + want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def jax_draws(buckets, plan, params, n_items):
    """The row and negative draws of JAX's ``train_seqrec``: the key
    ``PRNGKey(seed + 1)`` split per bucket, ``split(sub, steps)`` per
    step, each step's key split into the rows' and the negatives'
    ``randint`` (seqrec.py:408-426, reproduced outside jit)."""
    key = jax.random.PRNGKey(int(params.seed) + 1)
    out = []
    for bucket, (steps, bs) in zip(buckets, plan):
        key, sub = jax.random.split(key)
        sels, negss = [], []
        for k in jax.random.split(sub, steps):
            k_rows, k_negs = jax.random.split(k)
            sels.append(np.asarray(jax.random.randint(
                k_rows, (bs,), 0, len(bucket))))
            negss.append(np.asarray(jax.random.randint(
                k_negs, (int(params.n_negatives),), 0, n_items)))
        out.append((np.stack(sels), np.stack(negss)))
    return out


def test_twenty_steps_replaying_jax_draws():
    jp, tp = params_pair()
    seqs = chain_sequences(n_users=40, min_len=2, seed=8)
    buckets = tseq.bucket_sequences(seqs, max_len=16)
    theta0 = jax_theta(jp)
    want_theta, want_loss = jseq.train_seqrec(
        jseq.bucket_sequences(seqs, max_len=16), N_ITEMS, jp, theta=theta0)
    draws = jax_draws(buckets, tseq.plan_steps(buckets, tp), jp, N_ITEMS)
    got_theta, got_loss = tseq.train_seqrec(buckets, N_ITEMS, tp,
                                            theta=theta0, device="cpu",
                                            draws=draws)
    assert got_loss.shape == want_loss.shape == (20,)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert set(got_theta) == set(want_theta)
    for k in want_theta:
        np.testing.assert_allclose(got_theta[k], want_theta[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_own_draws_train_deterministically_and_loss_falls():
    _, tp = params_pair(num_steps=120, learning_rate=0.01)
    buckets = tseq.bucket_sequences(chain_sequences(n_users=60, seed=9),
                                    max_len=16)
    a, la = tseq.train_seqrec(buckets, N_ITEMS, tp, device="cpu")
    b, lb = tseq.train_seqrec(buckets, N_ITEMS, tp, device="cpu")
    np.testing.assert_array_equal(la, lb)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert all(np.isfinite(v).all() for v in a.values())
    assert la[-20:].mean() < la[:20].mean()


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_parallel_modes_train_and_encode_without_a_mesh(mode):
    """JAX's trainer never reads ``sp_mode`` and its encode without a
    mesh is dense whatever the mode: the port trains and encodes so
    too, from the same θ and JAX's own draws."""
    jp, tp = params_pair(sp_mode=mode)
    # the fixture of test_twenty_steps_replaying_jax_draws
    seqs = chain_sequences(n_users=40, min_len=2, seed=8)
    buckets = tseq.bucket_sequences(seqs, max_len=16)
    theta0 = jax_theta(jp)
    want_theta, want_loss = jseq.train_seqrec(
        jseq.bucket_sequences(seqs, max_len=16), N_ITEMS, jp, theta=theta0)
    draws = jax_draws(buckets, tseq.plan_steps(buckets, tp), jp, N_ITEMS)
    got_theta, got_loss = tseq.train_seqrec(buckets, N_ITEMS, tp,
                                            theta=theta0, device="cpu",
                                            draws=draws)
    # the mode is not read: bitwise the default mode's training
    _, auto = params_pair()
    auto_theta, auto_loss = tseq.train_seqrec(buckets, N_ITEMS, auto,
                                              theta=theta0, device="cpu",
                                              draws=draws)
    np.testing.assert_array_equal(got_loss, auto_loss)
    assert all(np.array_equal(got_theta[k], auto_theta[k]) for k in got_theta)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for k in want_theta:
        np.testing.assert_allclose(got_theta[k], want_theta[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    want = jseq.encode_users(want_theta, jseq.bucket_sequences(
        seqs, max_len=16), len(seqs) + 1, jp)
    got = tseq.encode_users(want_theta, buckets, len(seqs) + 1, tp,
                            device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_dense_modes_encode(mode):
    _, tp = params_pair(sp_mode=mode)
    buckets = tseq.bucket_sequences(chain_sequences(seed=10), max_len=16)
    U = tseq.encode_users(tseq.init_theta(N_ITEMS, tp), buckets, 31, tp,
                          device="cpu")
    assert U.shape == (31, 16) and (U[30] == 0).all()


def test_entry_points_default_to_cuda():
    _, tp = params_pair()
    buckets = tseq.bucket_sequences(chain_sequences(seed=12))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseq.train_seqrec(buckets, N_ITEMS, tp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tseq.encode_bucket(tseq.init_theta(N_ITEMS, tp), buckets[0], tp)
