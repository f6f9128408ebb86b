"""The port's mesh, process group, compute context and ``PAlgorithm``
against the JAX package's, on the CPU.

- ``data_parallel_mesh`` / ``mesh_2d`` over an explicit device list
  (which may repeat a device: the port's logical shards) give JAX's
  shapes and axis names, and refuse too few devices with JAX's message;
  ``shard_spans`` and ``process_row_block`` equal JAX's.
- The single-host cases of JAX's ``tests/test_distributed.py``:
  ``initialize`` does nothing, counts are 1 / 0, the config reads the
  env, the missing coordinator / process id raise.
- ``ComputeContext``'s mesh half and ``workflow_context``.
- A ``PAlgorithm``'s model that is not a ``PersistentModel`` is stored
  as ``RETRAIN`` and trained again at deploy; ``batch_predict`` raises.
- A 2-process gloo world on localhost (children): ranks, world size,
  the primary host, and row blocks that cover every row once.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import distributed as jdist
from predictionio_tpu.parallel import mesh as jmesh
from predictionio_tpu_torch.core.context import (
    ComputeContext,
    workflow_context,
)
from predictionio_tpu_torch.parallel import distributed as tdist
from predictionio_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * 4


def test_data_parallel_mesh_equals_jax_shape(multichip_devices):
    import jax

    t = tmesh.data_parallel_mesh(devices=CPU4)
    j = jmesh.data_parallel_mesh(4)
    assert t.axis_names == j.axis_names == ("data",)
    assert t.shape == dict(j.shape) == {"data": 4}
    assert t.device_list() == [torch.device("cpu")] * 4
    assert tmesh.data_parallel_mesh(2, devices=CPU4).shape == {"data": 2}
    with pytest.raises(ValueError) as terr:
        tmesh.data_parallel_mesh(5, devices=CPU4)
    with pytest.raises(ValueError) as jerr:
        jmesh.data_parallel_mesh(5, devices=jax.devices()[:4])
    assert str(terr.value) == str(jerr.value) == "need 5 devices, have 4"


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1), (1, 4), (3, 1)])
def test_mesh_2d_equals_jax_shape(multichip_devices, data, model):
    import jax

    t = tmesh.mesh_2d(data, model, devices=CPU4)
    j = jmesh.mesh_2d(data, model, devices=jax.devices()[:4])
    assert t.axis_names == j.axis_names == ("data", "model")
    assert t.shape == dict(j.shape)
    assert t.devices.shape == j.devices.shape
    assert t.size == data * model


def test_mesh_2d_refuses_too_few_devices(multichip_devices):
    import jax

    with pytest.raises(ValueError) as terr:
        tmesh.mesh_2d(3, 2, devices=CPU4)
    with pytest.raises(ValueError) as jerr:
        jmesh.mesh_2d(3, 2, devices=jax.devices()[:4])
    assert str(terr.value) == str(jerr.value)


def test_default_plane_is_every_card():
    want = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    assert tmesh.default_devices() == want


@pytest.mark.parametrize("n,parts", [(10, 3), (8, 8), (7, 2), (5, 1), (0, 2),
                                     (3, 7), (100, 6)])
def test_shard_spans_equal_jax(n, parts):
    assert tmesh.shard_spans(n, parts) == jmesh.shard_spans(n, parts)


@pytest.mark.parametrize("n,count", [(10, 3), (8, 8), (7, 2), (5, 1), (0, 2),
                                     (138_493, 4), (3, 5)])
def test_process_row_block_equals_jax(n, count):
    blocks = [tdist.process_row_block(n, i, count) for i in range(count)]
    assert blocks == [jdist.process_row_block(n, i, count)
                      for i in range(count)]
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    for (a, b), (c, d) in zip(blocks, blocks[1:]):
        assert b == c
    sizes = [b - a for a, b in blocks]
    assert max(sizes) - min(sizes) <= 1


class TestDegenerateSingleHost:
    def test_initialize_noop_on_one_host(self):
        cfg = tdist.DistributedConfig()
        assert not cfg.is_multi_host
        assert tdist.initialize(cfg) is False
        assert tdist.process_count() == 1
        assert tdist.process_index() == 0
        assert tdist.is_primary_host()
        assert tdist.process_row_block(9) == (0, 9)

    def test_multi_host_requires_coordinator_and_id(self):
        with pytest.raises(ValueError, match="coordinator"):
            tdist.initialize(tdist.DistributedConfig(num_hosts=2))
        with pytest.raises(ValueError, match="process-id"):
            tdist.initialize(tdist.DistributedConfig(
                num_hosts=2, coordinator="127.0.0.1:1"))

    def test_config_from_env(self, monkeypatch):
        monkeypatch.setenv("PIO_COORDINATOR", "h0:8476")
        monkeypatch.setenv("PIO_NUM_HOSTS", "4")
        monkeypatch.setenv("PIO_PROCESS_ID", "2")
        monkeypatch.setenv("PIO_LOCAL_DEVICE_IDS", "0,1")
        t = tdist.DistributedConfig.from_env()
        j = jdist.DistributedConfig.from_env()
        assert (t.coordinator, t.num_hosts, t.process_id,
                t.local_device_ids) == (j.coordinator, j.num_hosts,
                                        j.process_id, j.local_device_ids) \
            == ("h0:8476", 4, 2, (0, 1))
        assert t.is_multi_host

    def test_config_from_args_falls_back_to_env(self, monkeypatch):
        import argparse

        monkeypatch.setenv("PIO_COORDINATOR", "h0:1")
        args = argparse.Namespace(coordinator=None, num_hosts=3,
                                  process_id=0)
        t, j = (m.DistributedConfig.from_args(args) for m in (tdist, jdist))
        assert (t.coordinator, t.num_hosts, t.process_id) == \
            (j.coordinator, j.num_hosts, j.process_id) == ("h0:1", 3, 0)

    def test_host_aware_mesh_local(self):
        mesh = tdist.host_aware_mesh(devices=CPU4)
        assert mesh.axis_names == ("data",)
        assert mesh.shape == {"data": 4}
        mesh2 = tdist.host_aware_mesh(model=2, devices=CPU4)
        assert mesh2.axis_names == ("data", "model")
        assert mesh2.shape == {"data": 2, "model": 2}
        with pytest.raises(ValueError, match="must divide"):
            tdist.host_aware_mesh(model=3, devices=CPU4)

    def test_row_block_index_validation(self):
        with pytest.raises(ValueError) as terr:
            tdist.process_row_block(10, 3, 3)
        with pytest.raises(ValueError) as jerr:
            jdist.process_row_block(10, 3, 3)
        assert str(terr.value) == str(jerr.value)

    def test_shutdown_without_a_group(self):
        tdist.shutdown()
        assert tdist.process_count() == 1


# -- the compute context -----------------------------------------------------------

def test_context_mesh_over_explicit_devices():
    ctx = workflow_context(mode="serving", devices=CPU4, mesh_shape=(2, 2),
                           axis_names=("data", "model"))
    assert ctx.device_count == 4
    mesh = ctx.mesh
    assert mesh.shape == {"data": 2, "model": 2}
    assert ctx.mesh is mesh  # built once
    flat = ctx.replace(mesh_shape=None, axis_names=("data",))
    assert flat.mesh.shape == {"data": 4} and flat.mode == "serving"
    odd = ctx.replace(mesh_shape=(4,), axis_names=("data", "model"))
    assert odd.mesh.axis_names == ("axis0",)
    ctx.stop()
    assert ctx.mesh is not mesh


def test_context_device_keeps_working():
    ctx = ComputeContext(device="cpu")
    assert ctx.devices == (torch.device("cpu"),)
    assert ctx.mesh.shape == {"data": 1}
    assert ctx.mode == "train" and ctx.axis_names == ("data",)
    assert ComputeContext(device="cpu") == ComputeContext(device="cpu")


def test_store_learns_its_devices_from_the_context_mesh():
    from predictionio_tpu_torch.ops.serving import DeviceTopK

    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 4)).astype(np.float32)
    Y = rng.normal(size=(30, 4)).astype(np.float32)
    ctx = workflow_context(devices=CPU4)
    srv = DeviceTopK(X, Y, {0: [1]}, device=ctx.mesh, shards=4,
                     microbatch=False)
    assert srv.shard_count == 4
    ref = DeviceTopK(X, Y, {0: [1]}, device="cpu", microbatch=False)
    for got, want in zip(srv.user_topk(0, 5), ref.user_topk(0, 5)):
        np.testing.assert_allclose(got, want, rtol=1e-5)


# -- PAlgorithm --------------------------------------------------------------------

def _p_engine(calls):
    from predictionio_tpu_torch.controller import (
        Engine,
        LFirstServing,
        PAlgorithm,
        PDataSource,
        PIdentityPreparator,
    )

    class Source(PDataSource):
        def read_training(self, ctx):
            calls.append("read")
            return np.arange(6.0)

    class MeanModel:
        def __init__(self, mean):
            self.mean = mean

    class MeanAlgorithm(PAlgorithm):
        def train(self, ctx, pd):
            calls.append("train")
            return MeanModel(float(np.mean(pd)))

        def predict(self, model, query):
            return model.mean + query

    return Engine(Source, PIdentityPreparator, {"mean": MeanAlgorithm},
                  LFirstServing)


def test_palgorithm_model_persists_as_retrain_and_retrains_at_deploy():
    from predictionio_tpu_torch.core.base import RETRAIN

    calls = []
    engine = _p_engine(calls)
    params = engine.engine_params_from_variant(
        {"algorithms": [{"name": "mean", "params": {}}]})
    ctx = ComputeContext(device="cpu")
    stored = engine.train(ctx, params)
    assert stored == [RETRAIN]
    assert calls == ["read", "train"]
    models = engine.prepare_deploy(ctx, params, "iid", stored)
    assert calls == ["read", "train", "read", "train"]
    assert models[0].mean == 2.5
    algo = engine._algorithms(params)[0]
    assert algo.predict_base(models[0], 1.0) == 3.5
    with pytest.raises(NotImplementedError, match="batch_predict"):
        algo.batch_predict_base(ctx, models[0], [(0, 1.0)])


def test_palgorithm_persistent_model_saves_itself(tmp_path):
    from predictionio_tpu_torch.controller import PAlgorithm, PersistentModel
    from predictionio_tpu_torch.core.base import PersistentModelManifest

    saved = []

    class Saved(PersistentModel):
        def save(self, model_id, params, ctx):
            saved.append(model_id)
            return True

        @classmethod
        def load(cls, model_id, params, ctx):
            return cls()

    class Algo(PAlgorithm):
        def train(self, ctx, pd):
            return Saved()

        def predict(self, model, query):
            return query

    out = Algo().make_persistent_model(None, "m1", None, Saved())
    assert isinstance(out, PersistentModelManifest) and saved == ["m1"]


# -- a 2-process gloo world ----------------------------------------------------------

CHILD = r"""
import json, sys
from predictionio_tpu_torch.parallel import distributed as d
rank, port, n_rows = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
joined = d.initialize(d.DistributedConfig(
    coordinator=f"127.0.0.1:{port}", num_hosts=2, process_id=rank))
import torch
import torch.distributed as dist
block = d.process_row_block(n_rows)
t = torch.tensor([block[1] - block[0]], dtype=torch.int64)
dist.all_reduce(t)
out = {"joined": joined, "count": d.process_count(),
       "index": d.process_index(), "primary": d.is_primary_host(),
       "block": list(block), "rows_total": int(t.item()),
       "backend": dist.get_backend()}
d.shutdown()
out["after"] = [d.process_count(), d.process_index()]
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world(tmp_path):
    port, n_rows = _free_port(), 1_001
    # no card visible: initialize picks gloo by itself
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(rank), str(port), str(n_rows)],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [o["index"] for o in outs] == [0, 1]
    assert all(o["joined"] and o["count"] == 2 and o["backend"] == "gloo"
               and o["after"] == [1, 0] for o in outs)
    assert [o["primary"] for o in outs] == [True, False]
    blocks = [tuple(o["block"]) for o in outs]
    assert blocks == [(0, 501), (501, 1_001)]
    covered = np.zeros(n_rows, dtype=int)
    for a, b in blocks:
        covered[a:b] += 1
    assert (covered == 1).all()
    assert all(o["rows_total"] == n_rows for o in outs)
