"""The sequentialrec mesh lane against the JAX package's, on the CPU:
``encode_bucket_mesh`` / ``encode_users(mesh=)`` on logical shards of
one device (``["cpu"] * n``) against JAX's on ``n`` devices of its
forced host platform (conftest), and ``SeqRecAlgorithm.train`` over a
context of four devices against JAX's mesh encode of the same θ.
Tolerance: rtol 2e-4 / atol 1e-5 (JAX ``TestMeshLane.TOL``).
"""

import numpy as np
import pytest

from predictionio_tpu.ops import seqrec as jseq
from predictionio_tpu.parallel.mesh import data_parallel_mesh as jmesh
from predictionio_tpu_torch.core.context import workflow_context
from predictionio_tpu_torch.ops import attention as tatt
from predictionio_tpu_torch.ops import seqrec as tseq
from predictionio_tpu_torch.parallel.mesh import data_parallel_mesh

pytestmark = pytest.mark.multichip

MESH_TOL = dict(rtol=2e-4, atol=1e-5)


def tmesh(n):
    return data_parallel_mesh(devices=["cpu"] * n)


def mesh_setup(n_heads, seed=4, lengths=(16, 16, 12, 9)):
    """JAX ``TestMeshLane._setup``: four users over 24 items."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 24, size=n).astype(np.int32) for n in lengths]
    kw = dict(rank=16, n_layers=2, n_heads=n_heads, max_seq_len=16, seed=5)
    jp = jseq.SeqRecParams(**kw)
    return seqs, jp, jseq.init_theta(24, jp)


@pytest.mark.parametrize("mode,heads", [("ring", 2), ("ulysses", 4),
                                        ("auto", 4), ("auto", 2)])
def test_encode_bucket_mesh_equals_jax(multichip_devices, mode, heads):
    seqs, jp, theta = mesh_setup(heads)
    jp = jseq.SeqRecParams(**{**jp.__dict__, "sp_mode": mode})
    tp = tseq.SeqRecParams(**jp.__dict__)
    (bucket,) = tseq.bucket_sequences(seqs, max_len=16)
    jb = jseq.SequenceBucket(bucket.rows, bucket.ids, bucket.mask)
    want = jseq.encode_bucket_mesh(theta, jb, jp, jmesh(4))
    got = tseq.encode_bucket_mesh(theta, bucket, tp, tmesh(4))
    np.testing.assert_allclose(got, want, **MESH_TOL)
    dense_u = tseq.encode_bucket(theta, bucket, tp, device="cpu")
    np.testing.assert_allclose(got, dense_u, **MESH_TOL)
    # a few rows a chunk: the chunked mesh encode equals the whole one
    per_row = tseq.encode_chunk_rows(16, 16, heads)
    chunked = tseq.encode_bucket_mesh(theta, bucket, tp, tmesh(4),
                                      budget=per_row * 4 // len(seqs) + 1)
    np.testing.assert_allclose(chunked, got, rtol=1e-6, atol=1e-6)


def test_encode_users_on_a_mesh_equals_jax(multichip_devices, monkeypatch):
    """Buckets of 8 and 16 on an 8-way axis: the 8-long class cannot
    shard (2 positions a shard at least) and encodes densely, the 16-long
    one runs Ulysses, in both packages."""
    seqs, jp, theta = mesh_setup(8, seed=6, lengths=(16, 13, 5, 7, 3))
    tp = tseq.SeqRecParams(**jp.__dict__)
    buckets = tseq.bucket_sequences(seqs, max_len=16)
    assert [b.seq_len for b in buckets] == [8, 16]
    calls = []
    uly = tatt.ulysses_attention
    monkeypatch.setattr(tseq, "ulysses_attention",
                        lambda *a, **kw: calls.append(a[0].shape[2])
                        or uly(*a, **kw))
    got = tseq.encode_users(theta, buckets, len(seqs) + 1, tp,
                            mesh=tmesh(8))
    want = jseq.encode_users(theta, jseq.bucket_sequences(seqs, max_len=16),
                             len(seqs) + 1, jp, mesh=jmesh(8))
    np.testing.assert_allclose(got, np.asarray(want), **MESH_TOL)
    assert set(calls) == {16} and len(calls) == 2      # one per layer
    assert (got[-1] == 0).all()
    off = tseq.SeqRecParams(**{**tp.__dict__, "sp_mode": "off"})
    calls.clear()
    dense_u = tseq.encode_users(theta, buckets, len(seqs) + 1, off,
                                device="cpu", mesh=tmesh(8))
    assert not calls
    np.testing.assert_allclose(got, dense_u, **MESH_TOL)


def _seq_events(n_users=16, n_items=20, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, n = int(rng.integers(0, n_items)), int(rng.integers(4, 16))
        seqs.append((start + np.arange(n)) % n_items)
    return seqs


@pytest.mark.parametrize("mode", ["ring", "ulysses", "off"])
def test_template_encodes_over_a_four_device_context(multichip_devices,
                                                     monkeypatch, mode):
    """``SeqRecAlgorithm.train`` with a context of four devices trains on
    the first and encodes over the context's mesh: the user vectors
    equal JAX's mesh encode of the same θ on a four-device mesh (``off``:
    densely, equal to the port's dense encode)."""
    from predictionio_tpu_torch.templates.sequentialrec import engine as seng

    seqs = _seq_events()
    buckets = tseq.bucket_sequences(seqs, max_len=16)
    pd = seng.PreparedSequences(
        seng.StringIndexBiMap.from_distinct(
            np.asarray([f"u{i:02d}" for i in range(len(seqs))])),
        seng.StringIndexBiMap.from_distinct(
            np.asarray([f"i{i:02d}" for i in range(20)])),
        buckets, {u: np.unique(s) for u, s in enumerate(seqs)}, 16)
    params = tseq.SeqRecParams(rank=8, n_layers=1, n_heads=4,
                               max_seq_len=16, num_steps=6, batch_size=4,
                               n_negatives=4, seed=3, sp_mode=mode)
    meshes = []
    encode = seng.encode_users
    monkeypatch.setattr(seng, "encode_users", lambda *a, **kw: (
        meshes.append(kw.get("mesh")), encode(*a, **kw))[1])
    ctx = workflow_context(devices=["cpu"] * 4, device="cpu")
    model = seng.SeqRecAlgorithm(params).train(ctx, pd)
    assert model.device == "cpu"
    if mode == "off":
        assert meshes == [None]
    else:
        assert meshes[0].size == 4
    if mode == "off":
        want = tseq.encode_users(model.theta, buckets, len(seqs), params,
                                 device="cpu")
    else:
        want = jseq.encode_users(
            model.theta, jseq.bucket_sequences(seqs, max_len=16), len(seqs),
            jseq.SeqRecParams(**params.__dict__), mesh=jmesh(4))
    np.testing.assert_allclose(model.user_vectors, np.asarray(want),
                               **MESH_TOL)
