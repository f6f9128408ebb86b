"""The port's ``mha_reference`` against the JAX package's on the same
seeded inputs: causal or not, with no mask, a float mask and a bool
mask; fully-masked query rows are exact zeros in both (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.attention import mha_reference as jax_mha
from predictionio_tpu_torch.ops.attention import mha_reference

TOL = 1e-5


def qkv(seed=0, B=2, H=3, L=9, D=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32)
            for _ in range(3)]


def ragged_mask(B=2, L=9, lens=(9, 4)):
    m = np.zeros((B, L), dtype=np.float32)
    for b, n in enumerate(lens):
        m[b, :n] = 1.0
    return m


def both(q, k, v, **kw):
    mask = kw.pop("key_padding_mask", None)
    got = mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                        key_padding_mask=None if mask is None
                        else torch.from_numpy(mask), **kw).numpy()
    want = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                              key_padding_mask=None if mask is None
                              else jnp.asarray(mask), **kw))
    return got, want


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask", ["none", "float", "bool"])
def test_matches_jax(causal, mask):
    q, k, v = qkv(seed=3)
    m = None
    if mask != "none":
        m = ragged_mask()
        if mask == "bool":
            m = m.astype(bool)
    got, want = both(q, k, v, causal=causal, key_padding_mask=m)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_explicit_scale_matches_jax():
    q, k, v = qkv(seed=5, L=6)
    got, want = both(q, k, v, causal=True, scale=0.3,
                     key_padding_mask=ragged_mask(L=6, lens=(6, 2)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_fully_masked_query_rows_are_zero():
    q, k, v = qkv(seed=7)
    # row 1 has no real key at all: every query of it sees nothing
    m = ragged_mask(lens=(5, 0))
    got, want = both(q, k, v, causal=False, key_padding_mask=m)
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # causal with the first key masked: query 0 sees only a masked key
    m2 = np.ones((2, 9), dtype=np.float32)
    m2[:, 0] = 0.0
    got, want = both(q, k, v, causal=True, key_padding_mask=m2)
    np.testing.assert_array_equal(got[:, :, 0], 0.0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mask_of_ones_matches_maskless():
    q, k, v = qkv(seed=9)
    ones = np.ones((2, 9), dtype=np.float32)
    a, _ = both(q, k, v, causal=True, key_padding_mask=ones)
    b, _ = both(q, k, v, causal=True)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def test_fully_masked_rows_have_finite_gradients():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in qkv(seed=2))
    m = torch.from_numpy(ragged_mask(lens=(3, 0)))
    out = mha_reference(q, k, v, causal=True, key_padding_mask=m)
    out.sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
