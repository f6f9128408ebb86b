"""The port's sequence-parallel attention against the JAX package's, on
the CPU: the port over logical shards of one device (``["cpu"] * n``),
JAX over ``n`` devices of its forced host platform (conftest).

``ring_attention`` / ``ulysses_attention`` against JAX's and against the
dense ``mha_reference`` (causal on and off, key-padding masks with a
fully masked row, bf16 inputs, the divisibility errors, the ring's
largest score block); ``select_sp_kernel`` over a grid of axis sizes,
heads, lengths and modes; both schemes, and the sequentialrec mesh
encode, over a process group of two gloo processes with two logical
shards each. The mesh encode against JAX's is
``tests/test_torch_seqrec_mesh.py``.

Tolerances: fp32 rtol 2e-4 / atol 2e-5 against the dense oracle and
JAX's schemes (JAX ``tests/test_attention.py``), the mesh encode 1e-5
(JAX ``TestMeshLane.TOL``'s atol); bf16 inputs one bf16 rounding (2^-7
relative) between the ring's two packages and 5e-2 against the fp32
oracle (JAX's bf16 tolerance).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import attention as jatt
from predictionio_tpu.ops import seqrec as jseq
from predictionio_tpu.parallel.mesh import data_parallel_mesh as jmesh
from predictionio_tpu_torch.ops import attention as tatt
from predictionio_tpu_torch.ops import seqrec as tseq
from predictionio_tpu_torch.parallel.mesh import data_parallel_mesh

pytestmark = pytest.mark.multichip

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-5)


def tmesh(n):
    return data_parallel_mesh(devices=["cpu"] * n)


def qkv(b=2, h=4, l=32, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, l, d)).astype(np.float32)
                 for _ in range(3))


def ragged_mask(b, l, seed=0, dead_row=True):
    """Per-row lengths in [1, l]; row 0 whole, the last row fully masked
    (every query of it outputs 0)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, l + 1, size=b)
    lens[0] = l
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.float32)
    if dead_row:
        mask[-1] = 0.0
    return mask


def port(fn, q, k, v, mesh, mask=None, **kw):
    t = (torch.from_numpy(x) for x in (q, k, v))
    return fn(*t, mesh, key_padding_mask=None if mask is None
              else torch.from_numpy(mask), **kw).float().numpy()


def jax_run(fn, q, k, v, mesh, mask=None, **kw):
    return np.asarray(fn(q, k, v, mesh, key_padding_mask=mask, **kw),
                      dtype=np.float32)


def dense(q, k, v, mask=None, causal=False):
    return tatt.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, key_padding_mask=None
                              if mask is None else torch.from_numpy(mask)
                              ).numpy()


SCHEMES = [("ring", tatt.ring_attention, jatt.ring_attention),
           ("ulysses", tatt.ulysses_attention, jatt.ulysses_attention)]


@pytest.mark.parametrize("name,tfn,jfn", SCHEMES, ids=["ring", "ulysses"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_scheme_equals_jax_and_the_dense_oracle(multichip_devices, name, tfn,
                                                jfn, n, causal, masked):
    q, k, v = qkv(b=3, h=8, l=32, seed=n + 2 * causal)
    mask = ragged_mask(3, 32, seed=n) if masked else None
    got = port(tfn, q, k, v, tmesh(n), mask, causal=causal)
    want = jax_run(jfn, q, k, v, jmesh(n), mask, causal=causal)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense(q, k, v, mask, causal), **TOL)
    if masked:
        # the fully masked row: exact zeros, in both packages
        assert (got[-1] == 0).all() and (want[-1] == 0).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_with_three_heads_and_a_scale(multichip_devices, n):
    """Head counts below the mesh size run on the ring (JAX's test
    shapes: 3 heads), with an explicit scale; one device is a ring of
    one."""
    q, k, v = qkv(b=2, h=3, l=24, d=16, seed=3)
    mask = ragged_mask(2, 24, seed=10, dead_row=False)
    got = port(tatt.ring_attention, q, k, v, tmesh(n), mask, causal=True,
               scale=0.3)
    want = jax_run(jatt.ring_attention, q, k, v, jmesh(n), mask,
                   causal=True, scale=0.3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, tatt.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=True, scale=0.3,
                                key_padding_mask=torch.from_numpy(mask))
        .numpy(), **TOL)


@pytest.mark.parametrize("name,tfn,jfn", SCHEMES, ids=["ring", "ulysses"])
def test_bfloat16_inputs(multichip_devices, name, tfn, jfn):
    q, k, v = qkv(b=2, h=4, l=32, d=16, seed=7)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = tfn(qb, kb, vb, tmesh(4), causal=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jfn(*(jnp.asarray(x, dtype=jnp.bfloat16)
                            for x in (q, k, v)), jmesh(4), causal=True),
                      dtype=np.float32)
    if name == "ring":
        # fp32 folds rounded once to bf16 in both packages
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    wide = [torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v)]
    np.testing.assert_allclose(got, dense(*wide, causal=True), rtol=5e-2,
                               atol=5e-2)


def _message(fn, *a, **kw):
    with pytest.raises(ValueError) as err:
        fn(*a, **kw)
    return str(err.value)


def test_divisibility_errors_equal_jax(multichip_devices):
    q, k, v = qkv(b=1, h=4, l=30, d=8)
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    assert _message(tatt.ring_attention, *tq, tmesh(4)) == _message(
        jatt.ring_attention, q, k, v, jmesh(4))
    q6, k6, v6 = qkv(b=1, h=6, l=32, d=8)
    assert _message(tatt.ulysses_attention,
                    *(torch.from_numpy(x) for x in (q6, k6, v6)),
                    tmesh(4)) == _message(jatt.ulysses_attention, q6, k6,
                                          v6, jmesh(4))
    q8, k8, v8 = qkv(b=1, h=8, l=30, d=8)
    assert _message(tatt.ulysses_attention,
                    *(torch.from_numpy(x) for x in (q8, k8, v8)),
                    tmesh(4)) == _message(jatt.ulysses_attention, q8, k8,
                                          v8, jmesh(4))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_forms_no_score_block_wider_than_a_shard(monkeypatch, n):
    shapes = []
    scores = tatt._scores

    def recorded(q, k, scale):
        out = scores(q, k, scale)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(tatt, "_scores", recorded)
    q, k, v = qkv(b=2, h=4, l=32)
    mask = ragged_mask(2, 32)
    tatt.ring_attention(*(torch.from_numpy(x) for x in (q, k, v)), tmesh(n),
                        causal=True, key_padding_mask=torch.from_numpy(mask))
    # n folds on each of n shards, each [B, H, L/n, L/n]
    assert len(shapes) == n * n
    assert {s[2:] for s in shapes} == {(32 // n, 32 // n)}
    shapes.clear()
    tatt.ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                           tmesh(4), causal=True)
    # Ulysses: a head group over the whole sequence
    assert shapes == [(2, 1, 32, 32)] * 4


def test_output_lands_on_the_first_device_in_the_input_dtype():
    q, k, v = (torch.from_numpy(x).double() for x in qkv(l=16))
    out = tatt.ring_attention(q, k, v, tmesh(4))
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    out = tatt.ulysses_attention(q, k, v, tmesh(4))
    assert out.dtype == torch.float64 and out.shape == q.shape


def test_parallel_package_exports_both_schemes():
    from predictionio_tpu_torch import parallel

    assert parallel.ring_attention is tatt.ring_attention
    assert parallel.ulysses_attention is tatt.ulysses_attention
    assert {"ring_attention", "ulysses_attention"} <= set(parallel.__all__)


# -- select_sp_kernel ------------------------------------------------------------

def _select(mod, mesh, heads, length, mode):
    try:
        return ("ok", mod.select_sp_kernel(mesh, "data", heads, length, mode))
    except ValueError as err:
        return ("raise", str(err))


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_select_sp_kernel_equals_jax(multichip_devices, size):
    cases = 0
    for heads in (1, 2, 3, 4, 8):
        for length in (1, 4, 6, 8, 16, 24, 32):
            for mode in ("auto", "ring", "ulysses", "off"):
                got = _select(tseq, tmesh(size), heads, length, mode)
                want = _select(jseq, jmesh(size), heads, length, mode)
                assert got == want, (size, heads, length, mode)
                cases += 1
    assert cases == 140


# -- two gloo processes, two logical shards each ------------------------------------

CHILD = r"""
import json, sys
import numpy as np
import torch
from predictionio_tpu_torch.parallel import distributed as d
from predictionio_tpu_torch.parallel.mesh import data_parallel_mesh
from predictionio_tpu_torch.ops import attention as att, seqrec
rank, port = int(sys.argv[1]), int(sys.argv[2])
d.initialize(d.DistributedConfig(coordinator=f"127.0.0.1:{port}",
                                 num_hosts=2, process_id=rank))
mesh = data_parallel_mesh(devices=["cpu"] * 2)
rng = np.random.default_rng(0)        # the same inputs in both processes
q, k, v = (torch.from_numpy(rng.standard_normal((3, 8, 32, 8))
                            .astype(np.float32)) for _ in range(3))
mask = (np.arange(32)[None] < np.array([[32], [9], [0]])).astype(np.float32)
mask = torch.from_numpy(mask)
out = {"axis": att.sp_axis_size(mesh)}
hops = []
batch = torch.distributed.batch_isend_irecv
def counted(ops):
    hops.append(len(ops))
    return batch(ops)
torch.distributed.batch_isend_irecv = counted
for causal in (False, True):
    want = att.mha_reference(q, k, v, causal=causal, key_padding_mask=mask)
    for name, fn in (("ring", att.ring_attention),
                     ("ulysses", att.ulysses_attention)):
        got = fn(q, k, v, mesh, causal=causal, key_padding_mask=mask)
        out[f"{name}_{causal}"] = float((got - want).abs().max())
        out[f"{name}_{causal}_dead_row"] = float(got[2].abs().max())
out["hops"] = list(hops)
seqs = [rng.integers(0, 24, size=n) for n in (16, 16, 12, 9, 7)]
buckets = seqrec.bucket_sequences(seqs, max_len=16)
for mode in ("ring", "ulysses"):
    p = seqrec.SeqRecParams(rank=16, n_layers=2, n_heads=4, max_seq_len=16,
                            seed=5, sp_mode=mode)
    theta = seqrec.init_theta(24, p)
    got = seqrec.encode_users(theta, buckets, 5, p, mesh=mesh)
    want = seqrec.encode_users(theta, buckets, 5, p, device="cpu")
    out[f"encode_{mode}"] = float(np.abs(got - want).max())
d.shutdown()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_with_two_shards_each(tmp_path):
    """Four shards over two processes: the ring's hop between processes
    through ``batch_isend_irecv`` (K, V and the mask: 6 operations a hop,
    3 hops a call), Ulysses through ``all_to_all_single`` and
    ``all_gather``; both equal the dense oracle, the fully masked row 0,
    and the mesh encode equals the dense one."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(rank), str(port)], env=env,
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for o in outs:
        assert o["axis"] == 4
        assert o["hops"] == [6] * 6        # 3 hops a call, 2 ring calls
        for name in ("ring", "ulysses"):
            for causal in (False, True):
                assert o[f"{name}_{causal}"] <= 2e-5, (name, causal, o)
                assert o[f"{name}_{causal}_dead_row"] == 0.0
            assert o[f"encode_{name}"] <= 1e-5, o
